"""Host-side waveform conditioning: BS.1770 loudness normalization and
long-silence trimming (the port's own copy of diffsinger_tpu/data/audio_norm.py).

Mirrors the reference's pre-mel waveform hooks (data_gen/tts/data_gen_utils.py:
``process_utterance`` loud_norm branch at :114-120 and ``trim_long_silences``
at :27-90) with native implementations — the reference depends on ``pyloudnorm``
and ``webrtcvad``; neither is available here, and both reduce to small,
well-specified DSP that we implement directly:

- Loudness follows ITU-R BS.1770-4: K-weighting (RBJ high-shelf +4 dB @1.5 kHz,
  Q=1/sqrt(2), then RBJ high-pass @38 Hz, Q=0.5 — the same parametric design
  pyloudnorm uses, so coefficients agree at any sample rate), 400 ms blocks with
  75 % overlap, -70 LUFS absolute gate then -10 LU relative gate.
- Silence trimming keeps the reference's exact mask pipeline (30 ms windows,
  width-8 moving average, binary dilation by ``vad_max_silence_length+1``
  windows, mask resized to the raw length) but swaps webrtcvad's GMM voicer
  for an adaptive-threshold energy detector computed at the native sample rate
  (no 16 kHz resample needed since we never call webrtcvad).

Everything here is offline/host-side NumPy — it runs in the binarizer worker
pool, never on the device.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "integrated_loudness",
    "normalize_loudness",
    "trim_long_silences",
]


# ---------------------------------------------------------------------------
# BS.1770-4 loudness
# ---------------------------------------------------------------------------

def _rbj_high_shelf(fs: float, fc: float = 1500.0, q: float = 1.0 / np.sqrt(2.0),
                    gain_db: float = 4.0):
    """RBJ audio-EQ-cookbook high shelf (pyloudnorm's 'high_shelf' prototype)."""
    a = 10.0 ** (gain_db / 40.0)
    w0 = 2.0 * np.pi * fc / fs
    alpha = np.sin(w0) / (2.0 * q)
    cw = np.cos(w0)
    b0 = a * ((a + 1) + (a - 1) * cw + 2 * np.sqrt(a) * alpha)
    b1 = -2 * a * ((a - 1) + (a + 1) * cw)
    b2 = a * ((a + 1) + (a - 1) * cw - 2 * np.sqrt(a) * alpha)
    a0 = (a + 1) - (a - 1) * cw + 2 * np.sqrt(a) * alpha
    a1 = 2 * ((a - 1) - (a + 1) * cw)
    a2 = (a + 1) - (a - 1) * cw - 2 * np.sqrt(a) * alpha
    return np.array([b0, b1, b2]) / a0, np.array([1.0, a1 / a0, a2 / a0])


def _rbj_high_pass(fs: float, fc: float = 38.0, q: float = 0.5):
    """RBJ high pass (pyloudnorm's 'high_pass' / RLB-weighting prototype)."""
    w0 = 2.0 * np.pi * fc / fs
    alpha = np.sin(w0) / (2.0 * q)
    cw = np.cos(w0)
    b0 = (1 + cw) / 2
    b1 = -(1 + cw)
    b2 = (1 + cw) / 2
    a0 = 1 + alpha
    a1 = -2 * cw
    a2 = 1 - alpha
    return np.array([b0, b1, b2]) / a0, np.array([1.0, a1 / a0, a2 / a0])


def _biquad(x: np.ndarray, b: np.ndarray, a: np.ndarray) -> np.ndarray:
    """Direct-form-II-transposed biquad, zero initial state (matches
    scipy.signal.lfilter which pyloudnorm calls)."""
    try:  # scipy is in the image; fall back to the explicit recursion if not
        from scipy.signal import lfilter
        return lfilter(b, a, x)
    except Exception:  # pragma: no cover
        y = np.empty_like(x, dtype=np.float64)
        z1 = z2 = 0.0
        for i, xi in enumerate(x.astype(np.float64)):
            yi = b[0] * xi + z1
            z1 = b[1] * xi - a[1] * yi + z2
            z2 = b[2] * xi - a[2] * yi
            y[i] = yi
        return y


def _k_weight(wav: np.ndarray, rate: int) -> np.ndarray:
    b1, a1 = _rbj_high_shelf(rate)
    b2, a2 = _rbj_high_pass(rate)
    return _biquad(_biquad(wav.astype(np.float64), b1, a1), b2, a2)


def integrated_loudness(wav: np.ndarray, rate: int) -> float:
    """Gated integrated loudness (LUFS) of a mono waveform per BS.1770-4.

    Returns -inf for silence / all-gated input (same convention as pyloudnorm).
    """
    wav = np.asarray(wav, dtype=np.float64)
    if wav.ndim != 1:
        wav = wav.mean(axis=-1)
    block = int(round(0.400 * rate))
    step = int(round(0.100 * rate))  # 75 % overlap
    if len(wav) < block:
        return -np.inf
    y = _k_weight(wav, rate)
    n_blocks = 1 + (len(y) - block) // step
    # mean square per gating block, vectorized via cumsum
    sq = np.concatenate([[0.0], np.cumsum(y * y)])
    starts = np.arange(n_blocks) * step
    ms = (sq[starts + block] - sq[starts]) / block
    with np.errstate(divide="ignore"):
        lb = -0.691 + 10.0 * np.log10(ms)
    keep = lb > -70.0  # absolute gate
    if not keep.any():
        return -np.inf
    rel_gate = -0.691 + 10.0 * np.log10(ms[keep].mean()) - 10.0
    keep &= lb > rel_gate
    if not keep.any():
        return -np.inf
    return float(-0.691 + 10.0 * np.log10(ms[keep].mean()))


def normalize_loudness(wav: np.ndarray, rate: int, target_lufs: float = -22.0,
                       peak_protect: bool = True) -> np.ndarray:
    """Gain the waveform to the target integrated loudness; rescale to |x|<=1
    afterwards exactly like the reference loud_norm branch
    (data_gen/tts/data_gen_utils.py:114-120)."""
    loudness = integrated_loudness(wav, rate)
    if not np.isfinite(loudness):
        return np.asarray(wav, dtype=np.float32)
    gain = 10.0 ** ((target_lufs - loudness) / 20.0)
    out = np.asarray(wav, dtype=np.float32) * np.float32(gain)
    peak = np.abs(out).max()
    if peak_protect and peak > 1.0:
        out = out / peak
    return out


# ---------------------------------------------------------------------------
# Long-silence trimming
# ---------------------------------------------------------------------------

def _moving_average(array: np.ndarray, width: int) -> np.ndarray:
    # identical padding/cumsum scheme to the reference (data_gen_utils.py:66-71)
    padded = np.concatenate((np.zeros((width - 1) // 2), array, np.zeros(width // 2)))
    ret = np.cumsum(padded, dtype=float)
    ret[width:] = ret[width:] - ret[:-width]
    return ret[width - 1:] / width


def _binary_dilate(mask: np.ndarray, width: int) -> np.ndarray:
    """1-D binary dilation with an all-ones structuring element of ``width``
    (scipy.ndimage.binary_dilation semantics: origin at the center)."""
    return np.convolve(mask.astype(np.float64), np.ones(width), mode="same") > 0


def _energy_vad(windows: np.ndarray) -> np.ndarray:
    """Adaptive-threshold energy voicer standing in for webrtcvad mode 3.

    A window is voiced when its energy clears both an absolute floor and an
    adaptive threshold placed between the estimated noise floor (10th
    percentile) and the speech level (90th percentile) in dB.
    """
    rms_db = 10.0 * np.log10(np.mean(windows ** 2, axis=-1) + 1e-12)
    noise = np.percentile(rms_db, 10.0)
    speech = np.percentile(rms_db, 90.0)
    if speech - noise < 6.0:  # no usable dynamic range: call everything voiced
        return np.ones(len(rms_db), dtype=bool)
    thresh = max(noise + 0.25 * (speech - noise), -55.0)
    return rms_db > thresh


def trim_long_silences(wav, sample_rate: int | None = None, *,
                       return_raw_wav: bool = False, norm: bool = True,
                       vad_max_silence_length: int = 12):
    """Remove silent stretches longer than the VAD tolerance.

    Same contract as the reference ``trim_long_silences``
    (data_gen/tts/data_gen_utils.py:27-90): returns
    ``(trimmed_wav, audio_mask, sample_rate)`` — or the raw wav plus mask when
    ``return_raw_wav`` — where the mask marks samples to keep. ``wav`` may be a
    path or an array (the reference only accepted a path).
    """
    if isinstance(wav, str):
        from diffsinger_tpu_torch.utils.misc import load_wav
        if sample_rate is None:
            raise ValueError("sample_rate required when passing a path")
        wav_raw = load_wav(wav, sample_rate)
    else:
        wav_raw = np.asarray(wav, dtype=np.float32)
        if sample_rate is None:
            raise ValueError("sample_rate required")

    if norm:
        wav_raw = normalize_loudness(wav_raw, sample_rate, target_lufs=-20.0)

    samples_per_window = (30 * sample_rate) // 1000  # 30 ms windows
    usable = len(wav_raw) - (len(wav_raw) % samples_per_window)
    if usable <= 0:
        mask = np.ones(len(wav_raw), dtype=bool)
        return (wav_raw, mask, sample_rate)
    windows = wav_raw[:usable].reshape(-1, samples_per_window)

    voice_flags = _energy_vad(windows)
    audio_mask = np.round(_moving_average(voice_flags, 8)).astype(bool)
    audio_mask = _binary_dilate(audio_mask, vad_max_silence_length + 1)
    audio_mask = np.repeat(audio_mask, samples_per_window)
    # extend the last window's decision over the trailing remainder
    tail = len(wav_raw) - len(audio_mask)
    if tail > 0:
        audio_mask = np.concatenate([audio_mask, np.full(tail, audio_mask[-1] if len(audio_mask) else True)])
    if return_raw_wav:
        return wav_raw, audio_mask, sample_rate
    return wav_raw[audio_mask], audio_mask, sample_rate
