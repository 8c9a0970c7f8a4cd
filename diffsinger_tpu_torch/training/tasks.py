"""Task layer (counterpart of diffsinger_tpu/training/tasks.py): the tasks
the shipped configs name through ``task_cls``, built by ``build_task``.

* ``DiffSingerTask`` (``diff``): the diffusion task, for DiffSpeech (frame,
  ph or cwt pitch, energy, speakers, ``offline_boost``) and the MIDI
  singing task (``task_type: midi``: word-boundary duration losses and the
  ``use_gt_f0`` switch of ``switch_midi2f0_step``), with the ``fs2_ckpt``
  freezing rule. An ``nn.Module`` holding ``fs2`` and ``denoise_fn`` (the
  upstream ``model.fs2.*`` / ``model.denoise_fn.*`` key prefixes). The
  WaveNet denoiser always runs through a fused stack: ``inference`` through
  the sampling kernel, ``train_loss`` through the training kernels. The FFT
  denoiser (``diff_decoder_type: fft``) is plain PyTorch and takes the raw
  conditioner in both.
* ``FastSpeech2Task`` (``fs2``): FastSpeech2 with its mel decoder, the
  ``mel_loss`` terms (l1, ssim) plus the duration, pitch and energy losses.
  Its checkpoints hold the FS2 itself under ``model.`` (upstream's
  FastSpeech2Task), which ``fs2_ckpt`` warm starts read.
* ``PitchExtractionTask`` (``pe``): the PitchExtractor, f0 loss only, with
  flax's BatchNorm statistics (``update_state`` after each mini-step).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from diffsinger_tpu_torch.models.diffnet import DiffNet
from diffsinger_tpu_torch.models.diffusion import DiffusionConfig, GaussianDiffusion
from diffsinger_tpu_torch.models.fft_denoiser import FFTDenoiser
from diffsinger_tpu_torch.models.fs2 import FS2Config, FastSpeech2
from diffsinger_tpu_torch.models.pe import PEConfig, PitchExtractor
from diffsinger_tpu_torch.ops.diffnet_stack import (diffnet_forward, pack_sampling_ctx,
                                                    precompute_cond_packed)
from diffsinger_tpu_torch.ops.diffnet_train import diffnet_train_forward
from diffsinger_tpu_torch.parallel.mesh import draw
from diffsinger_tpu_torch.training import losses as L
from diffsinger_tpu_torch.utils.device import resolve_device


def _compute_dtype(hp: Dict[str, Any]) -> Optional[torch.dtype]:
    return torch.bfloat16 if str(hp.get("compute_dtype", "float32")) == "bfloat16" \
        else None


def build_modules(hp: Dict[str, Any], vocab_size: int):
    """(fs2, denoiser): for ``task_type: fs2`` no denoiser; for a
    DiffSpeech/DiffSinger config the WaveNet denoiser, or the FFT one with
    ``diff_decoder_type: fft``."""
    task_type = hp.get("task_type", "diff")
    if task_type not in ("diff", "midi", "fs2"):
        raise NotImplementedError(f"task_type={task_type}")
    fs2 = FastSpeech2(FS2Config.from_hparams(hp, vocab_size))
    if task_type == "fs2":
        return fs2, None
    decoder_type = hp.get("diff_decoder_type", "wavenet")
    if decoder_type == "fft":
        return fs2, FFTDenoiser(
            in_dims=int(hp.get("audio_num_mel_bins", 80)),
            hidden_size=int(hp["hidden_size"]),
            residual_channels=int(hp.get("residual_channels", 256)),
            num_layers=int(hp.get("dec_layers", 4)),
            ffn_kernel_size=int(hp.get("dec_ffn_kernel_size", 9)),
            num_heads=int(hp.get("num_heads", 2)))
    if decoder_type != "wavenet":
        raise NotImplementedError(f"diff_decoder_type={decoder_type}")
    denoiser = DiffNet(
        in_dims=int(hp.get("audio_num_mel_bins", 80)),
        encoder_hidden=int(hp["hidden_size"]),
        residual_layers=int(hp.get("residual_layers", 20)),
        residual_channels=int(hp.get("residual_channels", 256)),
        dilation_cycle_length=int(hp.get("dilation_cycle_length", 1)))
    return fs2, denoiser


def make_is_sil(txt_tokens: torch.Tensor, sil_ids: Sequence[int]) -> torch.Tensor:
    """[B, T_txt] 1.0 where the token is one of ``sil_ids``."""
    if not sil_ids:
        return torch.zeros_like(txt_tokens, dtype=torch.float32)
    sil = torch.as_tensor(list(sil_ids), dtype=txt_tokens.dtype, device=txt_tokens.device)
    return (txt_tokens[:, :, None] == sil).any(-1).to(torch.float32)


def _spk_input(hp: Dict[str, Any], batch: Dict[str, Any]):
    """The batch's speaker input: ``spk_ids`` with ``use_spk_id``, else
    ``spk_embed`` (None when absent)."""
    return batch.get("spk_ids") if hp.get("use_spk_id") else batch.get("spk_embed")


def _as_tensor(v, dtype, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)


class _Task(nn.Module):
    """The trainer's side of a task: which parameters train and which module
    a checkpoint holds."""

    def checkpoint_module(self) -> nn.Module:
        """The module a checkpoint holds under ``model.``."""
        return self

    def trainable_rule(self) -> Callable[[str], bool]:
        return lambda name: True

    def set_trainable(self) -> List[Tuple[str, nn.Parameter]]:
        """Apply :meth:`trainable_rule` as ``requires_grad`` and return the
        trainable (name, parameter) pairs."""
        rule = self.trainable_rule()
        out = []
        for name, p in self.named_parameters():
            p.requires_grad_(rule(name))
            if p.requires_grad:
                out.append((name, p))
        return out


class _FS2Task(_Task):
    """What the FS2-based tasks share: the batch's FS2 inputs, the training
    forward and the duration, pitch and energy losses."""

    def _setup(self, hp: Dict[str, Any], device, sil_ids: Sequence[int]) -> None:
        self.device = resolve_device(device)
        self.hp = hp
        self.use_midi = bool(hp.get("use_midi", False))
        self.sil_ids = tuple(sil_ids)

    def _fs2_kwargs(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The MIDI encoder inputs and the speaker input of a batch."""
        dev = self.device
        kw = {}
        if self.use_midi:
            kw["pitch_midi"] = _as_tensor(batch["pitch_midi"], torch.long, dev)
            if batch.get("midi_dur") is not None:
                kw["midi_dur"] = _as_tensor(batch["midi_dur"], torch.float32, dev)
            if batch.get("is_slur") is not None:
                kw["is_slur"] = _as_tensor(batch["is_slur"], torch.long, dev)
        spk = _spk_input(self.hp, batch)
        if spk is not None:
            kw["spk_embed"] = _as_tensor(
                spk, torch.long if self.hp.get("use_spk_id") else torch.float32, dev)
        return kw

    def _fs2_train(self, batch: Dict[str, Any], drop_gen: Optional[torch.Generator],
                   use_gt_f0: bool = True, skip_decoder: bool = True) -> Dict[str, Any]:
        """Training-mode FS2 forward: ground-truth durations and energy, and
        with ``use_gt_f0`` the batch's f0 and uv (else both None: the
        predicted pitch is embedded). With cwt pitch the f0 it embeds is the
        one the batch's CWT spectrogram and log-F0 statistics give, as in the
        JAX package whatever ``use_gt_f0``."""
        hp, dev = self.hp, self.device
        f0 = _as_tensor(batch["f0"], torch.float32, dev) if use_gt_f0 else None
        uv = _as_tensor(batch["uv"], torch.float32, dev) if use_gt_f0 else None
        if hp.get("pitch_type") == "cwt":
            f0 = self.fs2.cwt2f0_norm(_as_tensor(batch["cwt_spec"], torch.float32, dev),
                                      _as_tensor(batch["f0_mean"], torch.float32, dev),
                                      _as_tensor(batch["f0_std"], torch.float32, dev))
        energy = (_as_tensor(batch["energy"], torch.float32, dev)
                  if hp.get("use_energy_embed") else None)
        return self.fs2(_as_tensor(batch["txt_tokens"], torch.long, dev),
                        mel2ph=_as_tensor(batch["mel2ph"], torch.long, dev),
                        f0=f0, uv=uv, energy=energy, skip_decoder=skip_decoder,
                        drop_gen=drop_gen, **self._fs2_kwargs(batch))

    def _aux_losses(self, losses: Dict[str, torch.Tensor], ret: Dict[str, Any],
                    batch: Dict[str, Any]) -> None:
        """Duration losses (MIDI: words from ``word_boundary``); with a pitch
        embedding the cwt, phone-level (``f0`` of the batch is then [B, T_txt])
        or frame pitch losses; with an energy embedding the energy loss."""
        hp, dev = self.hp, self.device
        txt_tokens = _as_tensor(batch["txt_tokens"], torch.long, dev)
        mel2ph = _as_tensor(batch["mel2ph"], torch.long, dev)
        lambdas = dict(lambda_ph_dur=hp.get("lambda_ph_dur", 1.0),
                       lambda_word_dur=hp.get("lambda_word_dur", 1.0),
                       lambda_sent_dur=hp.get("lambda_sent_dur", 1.0))
        if self.use_midi:
            L.midi_duration_loss(losses, ret["dur"], mel2ph, txt_tokens,
                                 _as_tensor(batch["word_boundary"], torch.long, dev),
                                 **lambdas)
        else:
            L.duration_losses(losses, ret["dur"], mel2ph, txt_tokens,
                              make_is_sil(txt_tokens, self.sil_ids),
                              dur_loss=hp.get("dur_loss", "mse"),
                              crf=getattr(self.fs2.dur_predictor, "crf", None), **lambdas)
        if hp.get("use_pitch_embed"):
            f0 = _as_tensor(batch["f0"], torch.float32, dev)
            uv = _as_tensor(batch["uv"], torch.float32, dev)
            nonpadding = (mel2ph != 0).to(torch.float32)
            pitch = dict(lambda_f0=hp.get("lambda_f0", 1.0))
            if hp.get("pitch_type") == "cwt":
                L.cwt_pitch_loss(losses, ret, _as_tensor(batch["cwt_spec"], torch.float32, dev),
                                 _as_tensor(batch["f0_mean"], torch.float32, dev),
                                 _as_tensor(batch["f0_std"], torch.float32, dev), uv,
                                 nonpadding, use_uv=hp.get("use_uv", True),
                                 cwt_loss=hp.get("cwt_loss", "l1"),
                                 lambda_uv=hp.get("lambda_uv", 1.0), **pitch)
            elif hp.get("pitch_type") == "ph":
                L.ph_pitch_loss(losses, ret["pitch_pred"], f0, txt_tokens,
                                pitch_loss=hp.get("pitch_loss", "l1"), **pitch)
            else:
                L.f0_loss(losses, ret["pitch_pred"], f0, uv, nonpadding,
                          use_uv=hp.get("use_uv", True),
                          pitch_loss=hp.get("pitch_loss", "l1"),
                          lambda_uv=hp.get("lambda_uv", 1.0), **pitch)
        if hp.get("use_energy_embed"):
            L.energy_loss(losses, ret["energy_pred"],
                          _as_tensor(batch["energy"], torch.float32, dev),
                          lambda_energy=hp.get("lambda_energy", 0.1))


class DiffSingerTask(_FS2Task):
    """Diffusion text- or MIDI-to-mel task (DiffSpeech, DiffSinger)."""

    def __init__(self, hp: Dict[str, Any], vocab_size: int, device="cuda",
                 sil_ids: Sequence[int] = ()):
        super().__init__()
        hp = dict(hp)
        hp.setdefault("task_type", "midi" if hp.get("use_midi") else "diff")
        self._setup(hp, device, sil_ids)
        self.fs2, self.denoise_fn = build_modules(self.hp, vocab_size)
        self.wavenet = isinstance(self.denoise_fn, DiffNet)
        self.compute_dtype = _compute_dtype(self.hp)
        self.gd = GaussianDiffusion(DiffusionConfig.from_hparams(self.hp),
                                    self._denoise_sample)
        self.to(self.device)

    def _denoise_sample(self, x: torch.Tensor, t: torch.Tensor,
                        cond_ctx: Dict[str, Any]) -> torch.Tensor:
        """Sampling kernel; ``cond_ctx`` is a ``pack_sampling_ctx`` dict, the
        weights and cond projections hoisted out of the reverse loop (the raw
        cond for the FFT denoiser)."""
        if not self.wavenet:
            return self.denoise_fn(x, t, cond_ctx)
        return diffnet_forward(self.denoise_fn, x, t, cond_ctx,
                               compute_dtype=self.compute_dtype)

    def _denoise_train(self, x: torch.Tensor, t: torch.Tensor,
                       cond: torch.Tensor) -> torch.Tensor:
        """Training kernels, differentiable; ``cond`` is the raw [B, T, H]."""
        if not self.wavenet:
            return self.denoise_fn(x, t, cond)
        return diffnet_train_forward(self.denoise_fn, x, t, cond,
                                     compute_dtype=self.compute_dtype)

    @torch.no_grad()
    def inference(self, batch: Dict[str, Any], t_mel: Optional[int] = None,
                  use_gt_dur: bool = True, use_gt_f0: bool = False,
                  noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """FS2 forward -> shallow boost from the FS2 mel (or, with
        ``offline_boost`` and a batch carrying ``fs2_mels``, from that mel,
        the FS2 decoder skipped; or a Gaussian start) -> DDPM or PLMS reverse
        loop -> denormalized mel masked by mel2ph. ``noise`` ([K+1, B, T, M]
        for DDPM, [1, B, T, M] for PLMS) fixes the draws; otherwise
        ``generator`` supplies them."""
        hp, dev = self.hp, self.device
        txt_tokens = _as_tensor(batch["txt_tokens"], torch.long, dev)
        mel2ph = (_as_tensor(batch["mel2ph"], torch.long, dev)
                  if use_gt_dur and batch.get("mel2ph") is not None else None)
        f0 = _as_tensor(batch["f0"], torch.float32, dev) if use_gt_f0 else None
        uv = _as_tensor(batch["uv"], torch.float32, dev) if use_gt_f0 else None
        if t_mel is None:
            t_mel = int(batch["mels"].shape[1]) if batch.get("mels") is not None \
                else int(hp["max_frames"])
        offline = bool(hp.get("offline_boost")) and batch.get("fs2_mels") is not None
        ret = self.fs2(txt_tokens, mel2ph=mel2ph, f0=f0, uv=uv, t_mel=t_mel,
                       skip_decoder=offline, **self._fs2_kwargs(batch))
        cond = ret["decoder_inp"]
        # offline boost: the mel of a separately trained FS2 (upstream's
        # OfflineGaussianDiffusion)
        fs2_mel = (_as_tensor(batch["fs2_mels"], torch.float32, dev) if offline
                   else ret["mel_out"])
        ret["fs2_mel"] = fs2_mel
        tgt_nonpadding = (ret["mel2ph"] > 0).to(torch.float32)
        cond_ctx = None
        if self.wavenet:
            # the stack always runs through the kernel wrapper, so the cond
            # cast follows compute_dtype (JAX's rule for its use_pallas_diffnet
            # path)
            cdt = self.compute_dtype
            cond_ctx = pack_sampling_ctx(
                self.denoise_fn,
                precompute_cond_packed(self.denoise_fn, cond, compute_dtype=cdt),
                compute_dtype=cdt)
        ret["mel_out"] = self.gd.sample(cond, fs2_mel=fs2_mel,
                                        tgt_nonpadding=tgt_nonpadding,
                                        cond_ctx=cond_ctx, noise=noise,
                                        generator=generator)
        return ret

    # ------------------------------------------------------------------ train
    def train_loss(self, batch: Dict[str, Any], t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   deterministic: bool = False,
                   use_gt_f0: bool = True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total_loss, loss terms): the diffusion mel loss plus the duration
        and pitch losses. ``t`` [B] and ``noise`` [B, T, M] fix the diffusion
        draws; ``generator`` supplies whatever is not given, and the dropout
        masks unless ``deterministic``. ``use_gt_f0`` False conditions on the
        predicted pitch (the ``switch_midi2f0_step`` curriculum)."""
        dev = self.device
        target = _as_tensor(batch["mels"], torch.float32, dev)
        if generator is None and (t is None or noise is None or not deterministic):
            raise ValueError("train_loss needs a torch.Generator for its random draws "
                             "(or t, noise and deterministic=True)")
        ret = self._fs2_train(batch, None if deterministic else generator, use_gt_f0)
        b = target.shape[0]
        # under a data mesh both are drawn for the global batch and sliced
        if t is None:
            t = draw(torch.randint, (b,), 0, self.gd.cfg.k_step, generator=generator,
                     device=dev)
        if noise is None:
            noise = draw(torch.randn, target.shape, generator=generator, device=dev)
        losses: Dict[str, torch.Tensor] = {
            "mel": self.gd.training_loss(self._denoise_train, target,
                                         _as_tensor(t, torch.long, dev),
                                         ret["decoder_inp"],
                                         _as_tensor(noise, torch.float32, dev))}
        self._aux_losses(losses, ret, batch)
        return sum(losses.values()), losses

    # ------------------------------------------------------------------ freeze
    def fs2_fully_frozen(self) -> bool:
        """True when the whole FS2 is frozen (DiffSinger semantics); DiffSpeech
        (``freeze_fs2_all: false``) keeps its predictors trainable."""
        hp = self.hp
        return bool(hp.get("fs2_ckpt")) and bool(
            hp.get("freeze_fs2_all", hp.get("task_cls", "").find("DiffSpeech") < 0))

    def trainable_rule(self) -> Callable[[str], bool]:
        """Parameter name -> trainable. Active only when warm-started from
        ``fs2_ckpt``: then FS2 is frozen, all of it or all but its predictors."""
        if not self.hp.get("fs2_ckpt"):
            return lambda name: True
        freeze_all_fs2 = self.fs2_fully_frozen()

        def rule(name: str) -> bool:
            parts = name.split(".")
            if parts[0] != "fs2":
                return True
            if parts[1:3] == ["cwt_predictor", "0"]:
                # the CWT input projection: cwt_in_proj in the JAX tree, which
                # freezes it with the rest of FS2
                return False
            return not freeze_all_fs2 and any("predictor" in p for p in parts)

        return rule


class FastSpeech2Task(_FS2Task):
    """FastSpeech2 text- or MIDI-to-mel task (upstream's FastSpeech2Task and
    AuxDecoderMIDITask): the mel decoder trained with the ``mel_loss`` terms
    and the duration, pitch and energy losses; every parameter trains."""

    def __init__(self, hp: Dict[str, Any], vocab_size: int, device="cuda",
                 sil_ids: Sequence[int] = ()):
        super().__init__()
        self._setup({**hp, "task_type": "fs2"}, device, sil_ids)
        self.fs2, _ = build_modules(self.hp, vocab_size)
        self.to(self.device)

    def train_loss(self, batch: Dict[str, Any], t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   deterministic: bool = False, use_gt_f0: bool = True
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total_loss, loss terms): the mel terms of ``mel_loss`` on the
        decoder's mel, the duration and pitch (and energy) losses. Dropout
        draws from ``generator`` unless ``deterministic``. The signature is
        every task's; ``t``, ``noise`` and ``use_gt_f0`` are ignored, as
        JAX's FastSpeech2Task takes none of them."""
        if generator is None and not deterministic:
            raise ValueError("train_loss needs a torch.Generator for dropout "
                             "(or deterministic=True)")
        ret = self._fs2_train(batch, None if deterministic else generator,
                              skip_decoder=False)
        losses: Dict[str, torch.Tensor] = {}
        L.add_mel_losses(losses, ret["mel_out"],
                         _as_tensor(batch["mels"], torch.float32, self.device),
                         self.hp.get("mel_loss", "l1"))
        self._aux_losses(losses, ret, batch)
        return sum(losses.values()), losses

    @torch.no_grad()
    def inference(self, batch: Dict[str, Any], t_mel: Optional[int] = None,
                  use_gt_dur: bool = True, use_gt_f0: bool = False,
                  **_draws) -> Dict[str, Any]:
        """The FS2 forward with its decoder; ``mel_out`` is its mel, masked by
        mel2ph. Takes (and ignores) the diffusion task's draws."""
        hp, dev = self.hp, self.device
        mel2ph = (_as_tensor(batch["mel2ph"], torch.long, dev)
                  if use_gt_dur and batch.get("mel2ph") is not None else None)
        f0 = _as_tensor(batch["f0"], torch.float32, dev) if use_gt_f0 else None
        uv = _as_tensor(batch["uv"], torch.float32, dev) if use_gt_f0 else None
        if t_mel is None:
            t_mel = int(batch["mels"].shape[1]) if batch.get("mels") is not None \
                else int(hp["max_frames"])
        return self.fs2(_as_tensor(batch["txt_tokens"], torch.long, dev), mel2ph=mel2ph,
                        f0=f0, uv=uv, t_mel=t_mel, **self._fs2_kwargs(batch))

    def checkpoint_module(self) -> nn.Module:
        return self.fs2


class PitchExtractionTask(_Task):
    """PitchExtractor training (upstream's PitchExtractionTask): mel -> F0,
    the frame f0/uv loss only. As in the JAX package the training forward
    always runs in training mode (batch statistics and dropout), validation
    included; the new running statistics come back under ``_new_state`` and
    the trainer writes them with ``update_state`` after the gradient."""

    def __init__(self, hp: Dict[str, Any], vocab_size: int = 0, device="cuda",
                 sil_ids: Sequence[int] = ()):
        super().__init__()
        self.device = resolve_device(device)
        self.hp = dict(hp)
        self.pe = PitchExtractor(PEConfig.from_hparams(self.hp))
        self.to(self.device)

    def train_loss(self, batch: Dict[str, Any], t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   deterministic: bool = False, use_gt_f0: bool = True
                   ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """(total_loss, {"f0", "uv", "_new_state"}). ``deterministic`` is
        ignored, as JAX's task ignores it; dropout draws from ``generator``
        (None: no dropout). ``t``, ``noise`` and ``use_gt_f0`` (every task's
        signature) are ignored too."""
        hp, dev = self.hp, self.device
        ret = self.pe(_as_tensor(batch["mels"], torch.float32, dev), train=True,
                      drop_gen=generator)
        mel2ph = _as_tensor(batch["mel2ph"], torch.long, dev)
        losses: Dict[str, Any] = {}
        L.f0_loss(losses, ret["pitch_pred"], _as_tensor(batch["f0"], torch.float32, dev),
                  _as_tensor(batch["uv"], torch.float32, dev),
                  (mel2ph != 0).to(torch.float32), use_uv=hp.get("use_uv", True),
                  pitch_loss=hp.get("pitch_loss", "l1"), lambda_f0=hp.get("lambda_f0", 1.0),
                  lambda_uv=hp.get("lambda_uv", 1.0))
        total = sum(losses.values())
        losses["_new_state"] = ret["new_stats"]
        return total, losses

    @torch.no_grad()
    def update_state(self, new_state: Dict[str, torch.Tensor]) -> None:
        """Write the running statistics a training forward returned."""
        for name, value in new_state.items():
            self.pe.get_buffer(name).copy_(value)

    def inference(self, batch: Dict[str, Any], **_kw) -> Dict[str, Any]:
        """The PitchExtractor on the batch's mels, running statistics."""
        return self.pe(_as_tensor(batch["mels"], torch.float32, self.device))

    def checkpoint_module(self) -> nn.Module:
        return self.pe


TASK_REGISTRY = {
    # upstream task_cls dotted paths -> the port's task classes
    "tasks.tts.fs2.FastSpeech2Task": FastSpeech2Task,
    "usr.diffsinger_task.AuxDecoderMIDITask": FastSpeech2Task,
    "usr.task.DiffFsTask": DiffSingerTask,
    "usr.diffspeech_task.DiffSpeechTask": DiffSingerTask,
    "usr.diffsinger_task.DiffSingerTask": DiffSingerTask,
    "usr.diffsinger_task.DiffSingerOfflineTask": DiffSingerTask,
    "usr.diffsinger_task.DiffSingerMIDITask": DiffSingerTask,
    "tasks.tts.pe.PitchExtractionTask": PitchExtractionTask,
    # short names
    "fs2": FastSpeech2Task,
    "diff": DiffSingerTask,
    "pe": PitchExtractionTask,
}


def build_task(hp: Dict[str, Any], vocab_size: int, device="cuda",
               sil_ids: Sequence[int] = ()):
    """The task ``hp["task_cls"]`` names (default ``diff``); an unknown name
    raises ``KeyError``."""
    cls = TASK_REGISTRY.get(hp.get("task_cls", "diff"))
    if cls is None:
        raise KeyError(f"unknown task_cls {hp.get('task_cls')}")
    return cls(hp, vocab_size, device=device, sil_ids=tuple(sil_ids))
