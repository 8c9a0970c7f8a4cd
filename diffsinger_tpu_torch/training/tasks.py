"""Task layer, inference subset (counterpart of
diffsinger_tpu/training/tasks.py: ``build_modules`` and
``DiffSingerTask.inference``).

``DiffSingerTask`` is an ``nn.Module`` holding ``fs2`` and ``denoise_fn`` (the
upstream ``model.fs2.*`` / ``model.denoise_fn.*`` key prefixes). Training
waits for a later slice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from diffsinger_tpu_torch.models.diffnet import DiffNet
from diffsinger_tpu_torch.models.diffusion import DiffusionConfig, GaussianDiffusion
from diffsinger_tpu_torch.models.fs2 import FS2Config, FastSpeech2
from diffsinger_tpu_torch.ops.diffnet_stack import (diffnet_forward, pack_sampling_ctx,
                                                    precompute_cond_packed)
from diffsinger_tpu_torch.utils.device import resolve_device


def _compute_dtype(hp: Dict[str, Any]) -> Optional[torch.dtype]:
    return torch.bfloat16 if str(hp.get("compute_dtype", "float32")) == "bfloat16" \
        else None


def build_modules(hp: Dict[str, Any], vocab_size: int):
    """(fs2, denoiser) for a DiffSpeech/DiffSinger config with a WaveNet
    denoiser."""
    if hp.get("task_type", "diff") != "diff" or hp.get("use_midi"):
        raise NotImplementedError("the torch port covers the 'diff' task so far")
    if hp.get("diff_decoder_type", "wavenet") != "wavenet":
        raise NotImplementedError("the torch port covers the wavenet denoiser")
    fs2 = FastSpeech2(FS2Config.from_hparams(hp, vocab_size))
    denoiser = DiffNet(
        in_dims=int(hp.get("audio_num_mel_bins", 80)),
        encoder_hidden=int(hp["hidden_size"]),
        residual_layers=int(hp.get("residual_layers", 20)),
        residual_channels=int(hp.get("residual_channels", 256)),
        dilation_cycle_length=int(hp.get("dilation_cycle_length", 1)))
    return fs2, denoiser


def _as_tensor(v, dtype, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)


class DiffSingerTask(nn.Module):
    """Diffusion text-to-mel task (DiffSpeech on LJSpeech in this slice)."""

    def __init__(self, hp: Dict[str, Any], vocab_size: int, device="cuda"):
        super().__init__()
        self.device = resolve_device(device)
        self.hp = dict(hp)
        self.fs2, self.denoise_fn = build_modules(self.hp, vocab_size)
        self.compute_dtype = _compute_dtype(self.hp)
        self.gd = GaussianDiffusion(DiffusionConfig.from_hparams(self.hp), self._denoise)
        self.to(self.device)

    def _denoise(self, x: torch.Tensor, t: torch.Tensor, ctx: dict) -> torch.Tensor:
        # ctx: a pack_sampling_ctx dict, weights and cond hoisted out of the
        # reverse loop; the stack runs in the kernel on the card
        return diffnet_forward(self.denoise_fn, x, t, ctx,
                               compute_dtype=self.compute_dtype)

    @torch.no_grad()
    def inference(self, batch: Dict[str, Any], t_mel: Optional[int] = None,
                  use_gt_dur: bool = True, use_gt_f0: bool = False,
                  noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """FS2 forward -> shallow boost from the FS2 mel -> DDPM reverse loop
        -> denormalized mel masked by mel2ph. ``noise`` [K+1, B, T, M] fixes
        the draws; otherwise ``generator`` supplies them."""
        hp, dev = self.hp, self.device
        txt_tokens = _as_tensor(batch["txt_tokens"], torch.long, dev)
        mel2ph = (_as_tensor(batch["mel2ph"], torch.long, dev)
                  if use_gt_dur and batch.get("mel2ph") is not None else None)
        f0 = _as_tensor(batch["f0"], torch.float32, dev) if use_gt_f0 else None
        uv = _as_tensor(batch["uv"], torch.float32, dev) if use_gt_f0 else None
        if t_mel is None:
            t_mel = int(batch["mels"].shape[1]) if batch.get("mels") is not None \
                else int(hp["max_frames"])
        ret = self.fs2(txt_tokens, mel2ph=mel2ph, f0=f0, uv=uv, t_mel=t_mel)
        cond = ret["decoder_inp"]
        ret["fs2_mel"] = fs2_mel = ret["mel_out"]
        tgt_nonpadding = (ret["mel2ph"] > 0).to(torch.float32)
        # the stack always runs through the kernel wrapper, so the cond cast
        # follows compute_dtype (JAX's rule for its use_pallas_diffnet path)
        cdt = self.compute_dtype
        cond_ctx = pack_sampling_ctx(
            self.denoise_fn, precompute_cond_packed(self.denoise_fn, cond, compute_dtype=cdt),
            compute_dtype=cdt)
        ret["mel_out"] = self.gd.sample(cond, fs2_mel=fs2_mel,
                                        tgt_nonpadding=tgt_nonpadding,
                                        cond_ctx=cond_ctx, noise=noise,
                                        generator=generator)
        return ret
