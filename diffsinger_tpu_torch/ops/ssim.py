"""SSIM of mel "images" (counterpart of diffsinger_tpu/ops/ssim.py): an
11-tap Gaussian window (sigma 1.5) applied as two separable passes with zero
"SAME" padding, C1 = 0.01^2, C2 = 0.03^2. The FS2 task's ``ssim`` mel loss
is ``1 - ssim(mel + 6, target + 6)`` per element, weighted by the
non-padding frames. Plain PyTorch (``F.conv1d`` over each axis).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

C1 = 0.01 ** 2
C2 = 0.03 ** 2


@functools.lru_cache()
def _gaussian_kernel(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur(x: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Separable Gaussian blur of [B, H, W] with zero SAME padding: along H,
    then along W."""
    g = torch.from_numpy(_gaussian_kernel(window_size)).to(x.device, x.dtype)
    g = g.view(1, 1, window_size)
    pad = window_size // 2
    b, h, w = x.shape
    # along H: rows of length H
    y = F.conv1d(x.transpose(1, 2).reshape(b * w, 1, h), g, padding=pad)
    y = y.view(b, w, h).transpose(1, 2)
    # along W
    y = F.conv1d(y.reshape(b * h, 1, w), g, padding=pad)
    return y.view(b, h, w)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         reduce_mean: bool = True) -> torch.Tensor:
    """SSIM between [B, T, M] mel images: the per-element map, or its mean."""
    mu1, mu2 = _blur(img1, window_size), _blur(img2, window_size)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _blur(img1 * img1, window_size) - mu1_sq
    sigma2_sq = _blur(img2 * img2, window_size) - mu2_sq
    sigma12 = _blur(img1 * img2, window_size) - mu12
    ssim_map = ((2 * mu12 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return ssim_map.mean() if reduce_mean else ssim_map
