"""Pseudo-QMF filterbank for multi-band vocoders (counterpart of
diffsinger_tpu/ops/pqmf.py): N-band analysis and synthesis with a
Kaiser-windowed prototype lowpass (cosine modulation, near-perfect
reconstruction)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy.signal.windows import kaiser


def design_prototype_filter(taps: int = 62, cutoff_ratio: float = 0.142,
                            beta: float = 9.0) -> np.ndarray:
    if taps % 2:
        raise ValueError(f"taps={taps} must be even")
    omega_c = np.pi * cutoff_ratio
    n = np.arange(taps + 1) - 0.5 * taps
    with np.errstate(invalid="ignore"):
        h_i = np.sin(omega_c * n) / (np.pi * n)
    h_i[taps // 2] = omega_c / np.pi
    return h_i * kaiser(taps + 1, beta)


class PQMF:
    """The filters are float32 tensors on ``device`` (the CPU unless named)."""

    def __init__(self, subbands: int = 4, taps: int = 62, cutoff_ratio: float = 0.142,
                 beta: float = 9.0, device=None):
        self.subbands = subbands
        self.taps = taps
        h_proto = design_prototype_filter(taps, cutoff_ratio, beta)
        k = np.arange(subbands)[:, None]
        phase = (2 * k + 1) * (np.pi / (2 * subbands)) * (np.arange(taps + 1) - taps / 2)
        theta = (-1.0) ** k * np.pi / 4
        as_tensor = lambda h: torch.as_tensor(h, dtype=torch.float32, device=device)
        self.analysis_filter = as_tensor(2 * h_proto * np.cos(phase + theta))   # [n, taps+1]
        self.synthesis_filter = as_tensor(2 * h_proto * np.cos(phase - theta))

    def analysis(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T] -> [B, T // subbands, subbands]."""
        y = F.conv1d(x[:, None], self.analysis_filter[:, None], stride=self.subbands,
                     padding=self.taps // 2)
        return y.transpose(1, 2)

    def synthesis(self, y: torch.Tensor) -> torch.Tensor:
        """[B, T // subbands, subbands] -> [B, T]: each band zero-stuffed to
        the full rate (times ``subbands``), then the synthesis bank."""
        n = self.subbands
        b, t, _ = y.shape
        up = F.pad(y.transpose(1, 2)[..., None], (0, n - 1)).reshape(b, n, t * n) * n
        return F.conv1d(up, self.synthesis_filter[None], padding=self.taps // 2)[:, 0]
