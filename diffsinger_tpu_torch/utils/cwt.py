"""Continuous wavelet transform of log-F0 contours (the port's own copy of
diffsinger_tpu/utils/cwt.py).

The decomposition runs on the host in numpy, as the binarizer does: an
FFT-domain CWT with the Mexican-hat (DOG m=2) mother wavelet, scales
s_j = s0 * 2^(j * dj) with dt = 0.005, dj = 1, s0 = 2 * dt, J = 9 (10
scales, the 10-channel CWT spectrogram the models train on).

The approximate inverse and the F0 reconstruction (``inverse_cwt``,
``cwt2f0``) run on torch tensors, inside the model. As in the JAX package,
the inverse z-normalizes over the whole time axis of its input, the padding
frames of a static bucket included, with the population standard deviation.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import gamma as _gamma

DT = 0.005
DJ = 1.0
S0 = DT * 2
J = 9  # 10 scales total


def _mexican_hat_ft(f: np.ndarray) -> np.ndarray:
    """Fourier transform of the DOG(m=2) wavelet: f^2 exp(-f^2/2)/sqrt(gamma(2.5))."""
    return (f ** 2) * np.exp(-(f ** 2) / 2) / np.sqrt(_gamma(2.5))


def cwt_scales(dt: float = DT, dj: float = DJ, s0: float = S0, j: int = J) -> np.ndarray:
    return s0 * 2.0 ** (np.arange(j + 1) * dj)


def cwt(signal: np.ndarray, dt: float = DT, dj: float = DJ, s0: float = S0,
        j: int = J):
    """CWT of a 1-D signal. Returns (W [T, J+1] real, scales [J+1])."""
    signal = np.asarray(signal, dtype=np.float64)
    n0 = signal.shape[0]
    n = int(2 ** np.ceil(np.log2(n0)))  # zero-pad to the next power of two
    sj = cwt_scales(dt, dj, s0, j)
    x_ft = np.fft.fft(signal, n)
    w_k = 2 * np.pi * np.fft.fftfreq(n, dt)
    # energy normalization sqrt(s * dw * N) with dw = w_k[1]
    norm = np.sqrt(sj[:, None] * w_k[1] * n)
    psi_ft_bar = norm * np.conjugate(_mexican_hat_ft(sj[:, None] * w_k[None, :]))
    w = np.fft.ifft(x_ft[None, :] * psi_ft_bar, axis=1)[:, :n0]
    return np.real(w).T.astype(np.float32), sj


def get_lf0_cwt(lf0: np.ndarray):
    """10-scale CWT of a (normalized) log-F0 contour."""
    return cwt(np.squeeze(lf0))


def convert_continuous_f0(f0: np.ndarray):
    """Fill unvoiced gaps by edge extension and linear interpolation.
    Returns (uv, cont_f0); uv is 1.0 where voiced."""
    f0 = np.copy(f0)
    uv = np.float32(f0 != 0)
    if (f0 == 0).all():
        return uv, f0
    nz = np.where(f0 != 0)[0]
    f0[: nz[0]] = f0[nz[0]]
    f0[nz[-1]:] = f0[nz[-1]]
    nz = np.where(f0 != 0)[0]
    cont_f0 = np.interp(np.arange(len(f0)), nz, f0[nz])
    return uv, cont_f0


def get_cont_lf0(f0: np.ndarray):
    uv, cont_f0 = convert_continuous_f0(f0)
    return uv, np.log(np.maximum(cont_f0, 1e-8))


def norm_scale(w: np.ndarray):
    """Per-scale z-normalization of the CWT image."""
    mean = w.mean(0, keepdims=True)
    std = w.std(0, keepdims=True)
    return (w - mean) / np.maximum(std, 1e-8), mean, std


def cwt_to_f0_features(f0: np.ndarray, lf0_mean: float, lf0_std: float):
    """The decomposition of one utterance with given log-F0 statistics: the
    normalized CWT spectrogram, per-scale mean/std, scales and uv."""
    uv, cont_lf0 = get_cont_lf0(f0)
    cont_lf0_norm = (cont_lf0 - lf0_mean) / lf0_std
    w, scales = get_lf0_cwt(cont_lf0_norm)
    w_norm, scale_mean, scale_std = norm_scale(w)
    return {
        "cwt_spec": w_norm.astype(np.float32),
        "cwt_scales": scales.astype(np.float32),
        "cwt_mean": scale_mean[0].astype(np.float32),
        "cwt_std": scale_std[0].astype(np.float32),
        "uv": uv,
    }


def inverse_cwt(w: torch.Tensor, num_scales: int = J + 1) -> torch.Tensor:
    """Approximate inverse CWT: w [B, T, n_scales] -> [B, T], the sum over
    scales weighted (i + 1 + 2.5)^(-2.5), z-normalized over all T frames
    (population std; a constant row divides by 1)."""
    b = (torch.arange(num_scales, dtype=torch.float32, device=w.device) + 3.5) ** -2.5
    rec = (w * b).sum(-1)
    mean = rec.mean(-1, keepdim=True)
    std = rec.std(-1, correction=0, keepdim=True)
    return (rec - mean) / torch.where(std == 0, torch.ones_like(std), std)


def cwt2f0(cwt_spec: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
           num_scales: int = J + 1) -> torch.Tensor:
    """F0 (Hz) [B, T] from a normalized CWT spectrogram and per-utterance
    log-F0 ``mean`` / ``std`` [B]."""
    lf0 = inverse_cwt(cwt_spec, num_scales)
    return torch.exp(lf0 * std[:, None] + mean[:, None])
