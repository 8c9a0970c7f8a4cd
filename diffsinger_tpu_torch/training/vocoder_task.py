"""HiFi-GAN vocoder training (counterpart of
diffsinger_tpu/training/vocoder_task.py): the generator
(``models/hifigan.py``) against the multi-period and the multi-scale
discriminators (``models/hifigan_disc.py``); LSGAN losses, feature matching
and 45 x the mel L1; alternating AdamW steps, the discriminators' first.

A step: the generator's output ``y_hat`` from the current weights; the
discriminators' loss on (wav, ``y_hat`` detached) and their update; then the
generator's loss against the UPDATED discriminators and its update. The JAX
step runs the generator forward twice (once under ``stop_gradient``); this
one runs it once and keeps its graph for the generator's loss, which gives
the same numbers, since the generator's weights do not change in between.

The optimizers are ``optax.adamw(lr, b1, b2)``'s: decoupled weight decay
1e-4 on every parameter (biases too), eps 1e-8, a constant rate and no
clipping; one AdamW covers both discriminators. Like the JAX task this is
not a registered ``Task``: it has two optimizers and its own step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from diffsinger_tpu_torch.models.hifigan import HifiGanConfig, HifiGanGenerator
from diffsinger_tpu_torch.models.hifigan_disc import (MultiPeriodDiscriminator,
                                                      MultiScaleDiscriminator,
                                                      discriminator_loss, feature_loss,
                                                      generator_loss)
from diffsinger_tpu_torch.ops.mel import MelConfig, mel_spectrogram_torch
from diffsinger_tpu_torch.training.losses import l1
from diffsinger_tpu_torch.utils.device import resolve_device

MEL_LOSS_WEIGHT = 45.0
WEIGHT_DECAY = 1e-4   # optax.adamw's default


def _init_(module: nn.Module, generator: torch.Generator, kernel_std=None) -> None:
    """Every conv kernel drawn from ``generator`` and every bias zero: the
    JAX package's inits, normal(0, ``kernel_std``) for the generator's
    kernels, flax's lecun normal (truncated at two deviations) elsewhere."""
    for m in module.modules():
        if not isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d)):
            continue
        with torch.no_grad():
            if kernel_std is not None:
                nn.init.normal_(m.weight, 0.0, kernel_std, generator=generator)
            else:
                std = (1.0 / m.weight[0].numel()) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
            nn.init.zeros_(m.bias)


def generator_config(hp: Dict[str, Any]) -> HifiGanConfig:
    """The JAX task's choice: the hparams' geometry when they give
    ``upsample_rates`` (no NSF: the step feeds no F0), else HiFiGAN v1 at the
    hparams' sample rate, in float32 with 80 mel bins."""
    if "upsample_rates" in hp:
        return dataclasses.replace(HifiGanConfig.from_hparams(hp), use_pitch_embed=False)
    return HifiGanConfig(audio_sample_rate=int(hp["audio_sample_rate"]))


class HifiGanTask:
    """The generator, the MPD, the MSD and their two optimizers on one device
    (the card unless the caller names another). Parameters are drawn from
    ``generator`` (a CPU generator; seeded 0 when None)."""

    def __init__(self, hp: Dict[str, Any], device=None,
                 generator: Optional[torch.Generator] = None):
        self.device = resolve_device(device)
        self.hp = hp
        self.gen_cfg = generator_config(hp)
        self.mel_cfg = MelConfig.from_hparams(hp)
        with torch.device("meta"):
            self.gen = HifiGanGenerator(self.gen_cfg)
            self.mpd = MultiPeriodDiscriminator()
            self.msd = MultiScaleDiscriminator()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        for module, std in ((self.gen, 0.01), (self.mpd, None), (self.msd, None)):
            module.to_empty(device="cpu")
            _init_(module, g, std)
            module.to(self.device).train()
        lr = float(hp.get("lr", 2e-4))
        betas = (float(hp.get("optimizer_adam_beta1", 0.8)),
                 float(hp.get("optimizer_adam_beta2", 0.99)))
        self.g_params = list(self.gen.parameters())
        self.d_params = list(self.mpd.parameters()) + list(self.msd.parameters())
        self.g_opt, self.d_opt = (
            torch.optim.AdamW(params, lr=lr, betas=betas, eps=1e-8, weight_decay=WEIGHT_DECAY)
            for params in (self.g_params, self.d_params))

    def to(self, dtype: torch.dtype) -> "HifiGanTask":
        """The weights, and the inputs of later steps, in ``dtype`` (float64:
        the reference evaluation of a check); before the first step."""
        for module in (self.gen, self.mpd, self.msd):
            module.to(dtype)
        return self

    def _tensor(self, a) -> torch.Tensor:
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
        return t.to(self.device, self.g_params[0].dtype)

    def d_loss(self, wav: torch.Tensor, y_hat: torch.Tensor) -> torch.Tensor:
        """The discriminators' LSGAN loss on real ``wav`` and generated
        ``y_hat`` [B, T]."""
        p_rs, p_gs, _, _ = self.mpd(wav, y_hat)
        s_rs, s_gs, _, _ = self.msd(wav, y_hat)
        pr, pg = discriminator_loss(p_rs, p_gs)
        sr, sg = discriminator_loss(s_rs, s_gs)
        return pr + pg + sr + sg

    def g_loss(self, mel: torch.Tensor, wav: torch.Tensor,
               y_hat: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(adv + fm + 45 x mel L1, {"mel", "fm", "adv"}). ``y_hat``'s mel
        has T + 1 frames; the first T meet the target's."""
        mel_hat = mel_spectrogram_torch(y_hat, self.mel_cfg)[:, : mel.shape[1]]
        mel_loss = l1(mel_hat - mel).mean()
        _, p_gs, p_fr, p_fg = self.mpd(wav, y_hat)
        _, s_gs, s_fr, s_fg = self.msd(wav, y_hat)
        fm = feature_loss(p_fr, p_fg) + feature_loss(s_fr, s_fg)
        adv = generator_loss(p_gs) + generator_loss(s_gs)
        total = adv + fm + MEL_LOSS_WEIGHT * mel_loss
        return total, {"mel": mel_loss, "fm": fm, "adv": adv}

    @staticmethod
    def _grads(loss: torch.Tensor, params: List[nn.Parameter]) -> List[torch.Tensor]:
        return list(torch.autograd.grad(loss, params))

    @staticmethod
    def _update(opt: torch.optim.Optimizer, params: List[nn.Parameter],
                grads: List[torch.Tensor]) -> None:
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)

    def train_step(self, mel, wav) -> Dict[str, torch.Tensor]:
        """One D and one G update on mel [B, T, M] and wav [B, T * hop];
        returns the JAX task's logs ``d_loss``, ``g_loss``, ``mel``, ``fm``,
        ``adv`` as detached scalars on the device."""
        mel, wav = self._tensor(mel), self._tensor(wav)
        y_hat = self.gen(mel)
        d_loss = self.d_loss(wav, y_hat.detach())
        self._update(self.d_opt, self.d_params, self._grads(d_loss, self.d_params))
        g_loss, logs = self.g_loss(mel, wav, y_hat)
        self._update(self.g_opt, self.g_params, self._grads(g_loss, self.g_params))
        return {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(),
                **{k: v.detach() for k, v in logs.items()}}

    def losses_and_grads(self, mel, wav):
        """The step's two losses and gradients without an update: the
        discriminators' at the current weights and the generator's against
        the same (not updated) discriminators. Returns (logs, D gradients
        in ``d_params`` order, G gradients in ``g_params`` order)."""
        mel, wav = self._tensor(mel), self._tensor(wav)
        y_hat = self.gen(mel)
        d_loss = self.d_loss(wav, y_hat.detach())
        d_grads = self._grads(d_loss, self.d_params)
        g_loss, logs = self.g_loss(mel, wav, y_hat)
        g_grads = self._grads(g_loss, self.g_params)
        logs = {"d_loss": d_loss, "g_loss": g_loss, **logs}
        return {k: v.detach() for k, v in logs.items()}, d_grads, g_grads

    def named_parameters(self):
        """(name, parameter) of the discriminators (``mpd.`` / ``msd.``) and
        the generator (``gen.``), in ``d_params`` then ``g_params`` order."""
        for prefix, module in (("mpd.", self.mpd), ("msd.", self.msd), ("gen.", self.gen)):
            for n, p in module.named_parameters():
                yield prefix + n, p

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach() for n, p in self.named_parameters()}

    def load_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        """Weights under ``gen.`` / ``mpd.`` / ``msd.`` (every one required);
        the optimizers start over."""
        for prefix, module in (("gen.", self.gen), ("mpd.", self.mpd), ("msd.", self.msd)):
            module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()
                                    if k.startswith(prefix)})
        for opt in (self.g_opt, self.d_opt):
            opt.state.clear()


def sample_segments(mel: np.ndarray, wav: np.ndarray, hop: int, segment_frames: int,
                    rng: np.random.RandomState):
    """A random aligned (mel, wav) crop of ``segment_frames`` frames; shorter
    utterances are zero-padded and start at 0."""
    t = mel.shape[0]
    if t <= segment_frames:
        pad = segment_frames - t
        mel = np.pad(mel, ((0, pad), (0, 0)))
        wav = np.pad(wav, (0, pad * hop))
        start = 0
    else:
        start = rng.randint(0, t - segment_frames)
    return (mel[start: start + segment_frames],
            wav[start * hop: (start + segment_frames) * hop])
