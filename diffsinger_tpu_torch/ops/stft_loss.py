"""Multi-resolution STFT loss (counterpart of diffsinger_tpu/ops/stft_loss.py):
spectral-convergence and log-STFT-magnitude terms over several (fft, hop,
win) resolutions, on [B, T] waveforms through the differentiable
``ops/mel.py:stft_magnitude_torch``.

The log-magnitude L1 takes ``training.losses.l1`` (derivative +1 at 0, as
``jnp.abs``). The spectral convergence's norm differs from JAX's where its
argument is all zero (``stft_loss(x, x)``): ``jnp.linalg.norm``'s gradient
is NaN there, torch's ``vector_norm``'s is 0. No training step reaches it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from diffsinger_tpu_torch.ops.mel import stft_magnitude_torch
from diffsinger_tpu_torch.training.losses import l1

DEFAULT_RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))


def spectral_convergence_loss(x_mag: torch.Tensor, y_mag: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.vector_norm
    return norm(y_mag - x_mag) / torch.clamp(norm(y_mag), min=1e-8)


def log_stft_magnitude_loss(x_mag: torch.Tensor, y_mag: torch.Tensor) -> torch.Tensor:
    log = lambda m: torch.log(torch.clamp(m, min=1e-7))
    return l1(log(y_mag) - log(x_mag)).mean()


def stft_loss(x: torch.Tensor, y: torch.Tensor, fft_size: int, hop: int,
              win: int) -> Tuple[torch.Tensor, torch.Tensor]:
    x_mag = stft_magnitude_torch(x, n_fft=fft_size, hop_size=hop, win_length=win)
    y_mag = stft_magnitude_torch(y, n_fft=fft_size, hop_size=hop, win_length=win)
    return spectral_convergence_loss(x_mag, y_mag), log_stft_magnitude_loss(x_mag, y_mag)


def multi_resolution_stft_loss(
        x: torch.Tensor, y: torch.Tensor,
        resolutions: Sequence[Tuple[int, int, int]] = DEFAULT_RESOLUTIONS):
    """(spectral convergence, log magnitude), each averaged over resolutions."""
    sc_total = mag_total = 0.0
    for fft_size, hop, win in resolutions:
        sc, mag = stft_loss(x, y, fft_size, hop, win)
        sc_total = sc_total + sc
        mag_total = mag_total + mag
    n = len(resolutions)
    return sc_total / n, mag_total / n
