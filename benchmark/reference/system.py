"""The serving path in plain PyTorch: FS2 conditioner (MIDI for singing) ->
shallow-diffusion reverse loop (DDPM or PLMS) over the plain DiffNet ->
optional PitchExtractor -> HiFiGAN (NSF for singing), each stage a call of
its own so that a check can hold the program to it stage by stage.

Float32 with TF32 off (``precision``); ``tf32=True`` gives the control, the
same math with cuBLAS and cuDNN allowed TF32."""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from .diffnet import DiffNet
from .diffusion import DiffusionConfig, GaussianDiffusion
from .fs2 import FS2Config, FastSpeech2
from .hifigan import HifiGanConfig, HifiGanGenerator
from .pe import PEConfig, PitchExtractor


@contextlib.contextmanager
def precision(tf32: bool):
    """cuBLAS and cuDNN float32 products in TF32 (``tf32``) or in float32."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def vocoder_hparams(hp: Dict[str, Any]) -> Dict[str, Any]:
    """The vocoder's hparams when no checkpoint directory is given: NSF with
    ``use_nsf`` or, beside an explicit geometry, ``use_pitch_embed``."""
    gen_hp = dict(hp)
    gen_hp["use_pitch_embed"] = bool(hp.get("use_nsf", False) or hp.get("use_pitch_embed", False))
    return gen_hp


class System(nn.Module):
    """Parameter names as the program's: ``fs2.*``, ``denoise_fn.*`` (the
    task), ``voc.*`` (the generator), ``pe.*``."""

    def __init__(self, hp: Dict[str, Any], vocab_size: int, with_pe: bool):
        super().__init__()
        self.hp = dict(hp)
        self.hp.setdefault("task_type", "midi" if hp.get("use_midi") else "diff")
        self.fs2 = FastSpeech2(FS2Config.from_hparams(self.hp, vocab_size))
        self.denoise_fn = DiffNet(
            in_dims=int(hp.get("audio_num_mel_bins", 80)), encoder_hidden=int(hp["hidden_size"]),
            residual_layers=int(hp.get("residual_layers", 20)),
            residual_channels=int(hp.get("residual_channels", 256)),
            dilation_cycle_length=int(hp.get("dilation_cycle_length", 1)))
        self.gd = GaussianDiffusion(DiffusionConfig.from_hparams(self.hp),
                                    lambda x, t, cond: self.denoise_fn(x, t, cond))
        self.voc = HifiGanGenerator(HifiGanConfig.from_hparams(vocoder_hparams(hp)))
        self.pe = PitchExtractor(PEConfig.from_hparams(hp)) if with_pe else None
        self.eval()

    @property
    def hop(self) -> int:
        return self.voc.cfg.total_upsample

    @torch.no_grad()
    def mel(self, batch: Dict[str, np.ndarray], t_mel: int,
            noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """(sampler mel [B, T, M] zero on padding frames, mel2ph [B, T], the
        FS2's own F0 in Hz or None): durations, pitch and conditioner
        predicted, then the reverse loop from the FS2 mel's shallow boost."""
        dev = next(self.parameters()).device

        def as_t(k, dtype):
            return torch.as_tensor(batch[k], dtype=dtype, device=dev)

        kw = {}
        if self.hp.get("use_midi"):
            kw = {"pitch_midi": as_t("pitch_midi", torch.long),
                  "midi_dur": as_t("midi_dur", torch.float32),
                  "is_slur": as_t("is_slur", torch.long)}
        ret = self.fs2(as_t("txt_tokens", torch.long), t_mel=t_mel, **kw)
        nonpad = (ret["mel2ph"] > 0).to(torch.float32)
        mel = self.gd.sample(ret["decoder_inp"], fs2_mel=ret["mel_out"], tgt_nonpadding=nonpad,
                             noise=noise.to(dev, torch.float32))
        return mel, ret["mel2ph"], ret.get("f0_denorm")

    @torch.no_grad()
    def f0(self, mel: torch.Tensor) -> torch.Tensor:
        """The PitchExtractor's F0 [B, T] in Hz of a sampler mel."""
        return self.pe(mel)["f0_denorm_pred"]

    @staticmethod
    def floor(mel: torch.Tensor, mel2ph: torch.Tensor) -> torch.Tensor:
        """Bucket padding set to the batch's silence floor, its one minimum."""
        return torch.where((mel2ph > 0)[..., None], mel, mel.min())

    @torch.no_grad()
    def wav(self, mel: torch.Tensor, f0: Optional[torch.Tensor],
            source: Optional[Tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
        """Waveform [B, T * hop] of a floored mel (and, for NSF, its F0 and
        the source draws)."""
        if self.voc.cfg.use_pitch_embed and f0 is not None:
            return self.voc(mel, f0, *source)
        return self.voc(mel)
