"""HiFiGAN vocoder wrapper (counterpart of diffsinger_tpu/inference/vocoder.py,
``HifiGAN`` only, with NSF).

``apply`` runs the serving forward, ``ops/hifigan_mrf.py:hifigan_mrf_apply``:
the MRF scales of at most 128 channels go through the hand-written kernel.
NSF is on with ``use_nsf`` (or ``use_pitch_embed`` beside an explicit
geometry), as the JAX wrapper keys it; an NSF call given F0 draws its source
from ``source`` (rand_ini, noise) or a ``torch.Generator``.
Their weights are packed into the kernel layout at the first ``apply`` and
kept; ``load_state_dict`` and ``to`` repack. Checkpoint loading, Griffin-Lim
and the other vocoders wait for later slices; weights come from the caller
(seeded init or ``convert/from_jax.py``), and a ``vocoder_ckpt`` that names an
existing file or a non-empty directory raises rather than being ignored.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from diffsinger_tpu_torch.models.hifigan import HifiGanConfig, HifiGanGenerator, draw_source
from diffsinger_tpu_torch.ops.hifigan_mrf import hifigan_mrf_apply, pack_mrf_scales
from diffsinger_tpu_torch.utils.device import resolve_device


class HifiGAN:
    def __init__(self, hp: Dict[str, Any], device="cuda"):
        ckpt = hp.get("vocoder_ckpt") or ""
        if ckpt and (os.path.isfile(ckpt) or (os.path.isdir(ckpt) and os.listdir(ckpt))):
            raise NotImplementedError(f"vocoder_ckpt={ckpt}: loading a vocoder checkpoint "
                                      "into the torch port is not ported yet")
        self.device = resolve_device(device)
        self.cfg = HifiGanConfig.from_hparams(hp)
        self.model = HifiGanGenerator(self.cfg).to(self.device).eval()
        self._packed = None

    def load_state_dict(self, state_dict, strict: bool = True):
        out = self.model.load_state_dict(state_dict, strict=strict)
        self._packed = None
        return out

    def to(self, device) -> "HifiGAN":
        self.device = torch.device(device)
        self.model.to(self.device)
        self._packed = None
        return self

    @torch.no_grad()
    def apply(self, mel: torch.Tensor, f0: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              source: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        """mel [B, T, M] (log10 domain) -> wav [B, T * hop]. With NSF and
        ``f0`` [B, T] (Hz), the source draws are ``source`` = (rand_ini
        [B, 1, 9], noise [B, T * hop, 9]) when given, else drawn from
        ``generator`` (a generator seeded 0 when that is None too)."""
        if self._packed is None:
            self._packed = pack_mrf_scales(self.model)
        mel = mel.to(self.device, torch.float32)
        if not (self.cfg.use_pitch_embed and f0 is not None):
            return hifigan_mrf_apply(self.model, mel, self._packed)
        b, t = mel.shape[:2]
        if source is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            source = draw_source(b, t * self.cfg.total_upsample, self.device, generator)
        rand_ini, noise = (a.to(self.device, torch.float32) if isinstance(a, torch.Tensor)
                           else torch.from_numpy(np.array(a, np.float32)).to(self.device)
                           for a in source)
        return hifigan_mrf_apply(self.model, mel, self._packed,
                                 f0=f0.to(self.device, torch.float32),
                                 rand_ini=rand_ini, noise=noise)

    def spec2wav_batch(self, mels, lengths: Sequence[int]) -> List[np.ndarray]:
        """Batched vocoding of padded mels [B, T, M]; returns the waveforms
        trimmed to ``lengths[i] * hop`` samples."""
        if not isinstance(mels, torch.Tensor):
            mels = torch.as_tensor(np.asarray(mels))
        wav = self.apply(mels).cpu().numpy()
        hop = self.cfg.total_upsample
        return [wav[i, : int(n) * hop] for i, n in enumerate(lengths)]
