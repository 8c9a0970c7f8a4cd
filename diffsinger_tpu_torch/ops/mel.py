"""STFT + mel-spectrogram feature extraction on the host (counterpart of
diffsinger_tpu/ops/mel.py).

numpy and scipy only: the binarizer calls it in its worker processes, which
never touch CUDA. The same framing as the JAX function: the signal is zero-padded
by ``n_fft // 2`` on the left and ``n_fft // 2 + hop`` on the right and cut
into ``n_samples // hop + 1`` frames (not ``torch.stft``'s reflect padding);
a periodic Hann window shorter than ``n_fft`` sits in the middle of the FFT
buffer; the Slaney mel filterbank (librosa ``filters.mel`` with
``norm='slaney'``) maps the magnitude, and the result is
``log10(max(eps, mel))``.

``frame_signal_torch``, ``stft_magnitude_torch`` and ``mel_spectrogram_torch``
compute the same on torch tensors [..., n_samples] and are differentiable:
the vocoder-training mel loss and the STFT losses run them on the generator's
output. They import torch when called, so the binarizer's workers never load
it; the window and the filterbank are built once per (config, device).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import scipy.fft


def hann_window(win_length: int) -> np.ndarray:
    """Periodic (fftbins=True) Hann window, as scipy and librosa give it."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2 * np.pi * n / win_length)).astype(np.float32)


def _slaney_consts():
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    return f_sp, min_log_hz, min_log_hz / f_sp, np.log(6.4) / 27.0


def hz_to_mel_slaney(f):
    f_sp, min_log_hz, min_log_mel, logstep = _slaney_consts()
    f = np.asarray(f, dtype=np.float64)
    return np.where(f >= min_log_hz, min_log_mel + np.log(f / min_log_hz) / logstep,
                    f / f_sp)


def mel_to_hz_slaney(m):
    f_sp, min_log_hz, min_log_mel, logstep = _slaney_consts()
    m = np.asarray(m, dtype=np.float64)
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f_sp * m)


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: float) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank [n_mels, n_fft//2+1]."""
    if fmax is None or fmax <= 0:
        fmax = sample_rate / 2
    fftfreqs = np.linspace(0, sample_rate / 2, n_fft // 2 + 1)
    mel_pts = mel_to_hz_slaney(np.linspace(hz_to_mel_slaney(fmin), hz_to_mel_slaney(fmax),
                                           n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_pts[2: n_mels + 2] - mel_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


def frame_signal(y: np.ndarray, n_fft: int, hop_size: int) -> np.ndarray:
    """[n_samples] -> [n_samples // hop + 1, n_fft] frames of the zero-padded
    signal (``n_fft // 2`` zeros before, ``n_fft // 2 + hop`` after)."""
    n_frames = y.shape[-1] // hop_size + 1
    y = np.pad(y, (n_fft // 2, n_fft // 2 + hop_size))
    idx = np.arange(n_frames)[:, None] * hop_size + np.arange(n_fft)[None, :]
    return y[idx]


def stft_magnitude(y: np.ndarray, *, n_fft: int, hop_size: int,
                   win_length: int) -> np.ndarray:
    """|STFT| [T, n_fft // 2 + 1] with the centred Hann window."""
    win = _centred_window(win_length, n_fft)
    frames = frame_signal(np.asarray(y, np.float32), n_fft, hop_size) * win
    # scipy's pocketfft in float32: the arithmetic of the JAX package's CPU
    # FFT, so the near-silent bins (float32 rounding noise) agree too
    return np.abs(scipy.fft.rfft(frames, axis=-1))


class MelConfig:
    """Mel-extraction parameters, as ``MelConfig.from_hparams`` reads them."""

    def __init__(self, sample_rate=22050, n_fft=1024, hop_size=256, win_length=1024,
                 n_mels=80, fmin=80, fmax=7600, eps=1e-6):
        self.sample_rate = sample_rate
        self.n_fft = n_fft
        self.hop_size = hop_size
        self.win_length = win_length
        self.n_mels = n_mels
        self.fmin = 0 if fmin == -1 else fmin
        self.fmax = sample_rate / 2 if fmax in (-1, None) else fmax
        self.eps = eps

    @classmethod
    def from_hparams(cls, hp) -> "MelConfig":
        return cls(sample_rate=hp["audio_sample_rate"], n_fft=hp["fft_size"],
                   hop_size=hp["hop_size"], win_length=hp["win_size"],
                   n_mels=hp["audio_num_mel_bins"], fmin=hp["fmin"], fmax=hp["fmax"])


def mel_spectrogram(y: np.ndarray, cfg: MelConfig) -> np.ndarray:
    """log10-mel spectrogram [T, n_mels] of a waveform [n_samples]."""
    spc = stft_magnitude(y, n_fft=cfg.n_fft, hop_size=cfg.hop_size,
                         win_length=cfg.win_length)
    basis = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)
    mel = spc @ basis.T
    return np.log10(np.maximum(np.float32(cfg.eps), mel)).astype(np.float32)


def _centred_window(win_length: int, n_fft: int) -> np.ndarray:
    """The Hann window in the middle of an ``n_fft`` buffer."""
    win = hann_window(win_length)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        win = np.pad(win, (lpad, n_fft - win_length - lpad))
    return win


@functools.lru_cache(maxsize=32)
def _device_array(kind: str, args: tuple, device):
    """The window (``kind`` 'window', args (win, n_fft)) or the filterbank
    ('basis', args (sr, n_fft, n_mels, fmin, fmax)) as a float32 tensor on
    ``device``."""
    import torch

    arr = _centred_window(*args) if kind == "window" else mel_filterbank(*args)
    return torch.from_numpy(arr).to(device)


def frame_signal_torch(y, n_fft: int, hop_size: int):
    """torch [..., n_samples] -> [..., n_samples // hop + 1, n_fft], the
    framing of :func:`frame_signal`."""
    import torch.nn.functional as F

    n_frames = y.shape[-1] // hop_size + 1
    y = F.pad(y, (n_fft // 2, n_fft // 2 + hop_size))
    return y.unfold(-1, n_fft, hop_size)[..., :n_frames, :]


def stft_magnitude_torch(y, *, n_fft: int, hop_size: int, win_length: int):
    """|STFT| [..., T, n_fft // 2 + 1] of torch [..., n_samples]."""
    import torch

    win = _device_array("window", (win_length, n_fft), y.device).to(y.dtype)
    return torch.fft.rfft(frame_signal_torch(y, n_fft, hop_size) * win, dim=-1).abs()


def mel_spectrogram_torch(y, cfg: MelConfig):
    """log10-mel spectrogram [..., T, n_mels] of torch [..., n_samples]."""
    import torch

    spc = stft_magnitude_torch(y, n_fft=cfg.n_fft, hop_size=cfg.hop_size,
                               win_length=cfg.win_length)
    basis = _device_array("basis", (cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin,
                                    cfg.fmax), y.device).to(spc.dtype)
    return torch.log10(torch.clamp(spc @ basis.T, min=cfg.eps))


def wav2spec(wav: np.ndarray, cfg: MelConfig) -> Tuple[np.ndarray, np.ndarray]:
    """(the wav zero-padded and cut to ``T * hop`` samples, mel [T, n_mels])."""
    mel = mel_spectrogram(np.asarray(wav, np.float32), cfg)
    pad = (len(wav) // cfg.hop_size + 1) * cfg.hop_size - len(wav)
    wav_out = np.pad(wav, (0, pad), mode="constant")[: mel.shape[0] * cfg.hop_size]
    return wav_out, mel
