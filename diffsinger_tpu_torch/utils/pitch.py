"""F0 codecs (counterpart of diffsinger_tpu/utils/pitch.py).

Same float32 arithmetic as the JAX functions: mel-scale coarse quantization
into 256 bins, log2 normalization and its inverse with uv / padding zeroing;
and the numpy helpers of the data pipeline (coarse bins, normalized and
interpolated F0).
"""

from __future__ import annotations

import numpy as np
import torch

F0_BIN = 256
F0_MAX = 1100.0
F0_MIN = 50.0
F0_MEL_MIN = float(1127 * np.log(1 + F0_MIN / 700))
F0_MEL_MAX = float(1127 * np.log(1 + F0_MAX / 700))


def f0_to_coarse(f0: torch.Tensor) -> torch.Tensor:
    """Quantize F0 (Hz) to 256 mel-spaced bins; 0 Hz maps to bin 1."""
    f0_mel = 1127 * torch.log(1 + f0 / 700)
    f0_mel = torch.where(
        f0_mel > 0,
        (f0_mel - F0_MEL_MIN) * (F0_BIN - 2) / (F0_MEL_MAX - F0_MEL_MIN) + 1,
        f0_mel)
    f0_mel = torch.clamp(f0_mel, 1, F0_BIN - 1)
    return torch.floor(f0_mel + 0.5).to(torch.long)


def norm_f0(f0: torch.Tensor, uv, *, pitch_norm: str = "log",
            f0_mean: float = 0.0, f0_std: float = 1.0, use_uv: bool = True):
    """Normalize F0; ``uv`` is 1 where unvoiced."""
    if pitch_norm == "standard":
        f0 = (f0 - f0_mean) / f0_std
    elif pitch_norm == "log":
        f0 = torch.log2(torch.clamp(f0, min=1e-8))
    if uv is not None and use_uv:
        f0 = torch.where(uv > 0, torch.zeros_like(f0), f0)
    return f0


def denorm_f0(f0: torch.Tensor, uv, *, pitch_norm: str = "log",
              f0_mean: float = 0.0, f0_std: float = 1.0, use_uv: bool = True,
              pitch_padding=None):
    """Invert :func:`norm_f0`; frames flagged by ``uv`` or ``pitch_padding``
    become 0 Hz."""
    if pitch_norm == "standard":
        f0 = f0 * f0_std + f0_mean
    elif pitch_norm == "log":
        f0 = torch.pow(2.0, f0)
    if uv is not None and use_uv:
        f0 = torch.where(uv > 0, torch.zeros_like(f0), f0)
    if pitch_padding is not None:
        f0 = torch.where(pitch_padding, torch.zeros_like(f0), f0)
    return f0


def f0_to_coarse_np(f0: np.ndarray) -> np.ndarray:
    """NumPy twin of :func:`f0_to_coarse` for the data pipeline (``rint``
    like the reference numpy path); ``f0`` is modified in place."""
    f0_mel = 1127 * np.log(1 + f0 / 700)
    pos = f0_mel > 0
    f0_mel[pos] = (f0_mel[pos] - F0_MEL_MIN) * (F0_BIN - 2) / (F0_MEL_MAX - F0_MEL_MIN) + 1
    f0_mel = np.clip(f0_mel, 1, F0_BIN - 1)
    coarse = np.rint(f0_mel).astype(np.int64)
    assert coarse.max() <= 255 and coarse.min() >= 1, (coarse.max(), coarse.min())
    return coarse


def norm_interp_f0_np(f0: np.ndarray, *, pitch_norm: str = "log", f0_mean: float = 0.0,
                      f0_std: float = 1.0, use_uv: bool = True):
    """Host-side: mark unvoiced frames, normalize, and linearly interpolate
    across unvoiced gaps. Returns (f0_norm, uv), both float32."""
    f0 = np.asarray(f0, dtype=np.float32).copy()
    uv = f0 == 0
    if pitch_norm == "standard":
        f0 = (f0 - f0_mean) / f0_std
    elif pitch_norm == "log":
        with np.errstate(divide="ignore"):
            f0 = np.log2(np.maximum(f0, 1e-8))
    if use_uv:
        f0[uv] = 0
    if uv.all():
        f0[uv] = 0
    elif uv.any():
        f0[uv] = np.interp(np.where(uv)[0], np.where(~uv)[0], f0[~uv])
    return f0.astype(np.float32), uv.astype(np.float32)
