"""F0 extraction for the offline pipeline (the port's own copy of
diffsinger_tpu/data/pitch_extract.py).

The reference delegates to praat-parselmouth ``to_pitch_ac`` (reference
data_gen/tts/data_gen_utils.py:150-184: time_step = hop/sr, voicing_threshold
0.6, floor 80 Hz, ceiling 750 Hz) and then pads/reconciles the contour to the
mel length. parselmouth is unavailable here, so the extractor is a native
autocorrelation pitch tracker in the same spirit as Boersma (1993):

  * hann-windowed frames, 3 periods of the floor frequency long
  * normalized autocorrelation via FFT, corrected by the window's ACF
  * candidate = highest ACF peak in [1/ceil, 1/floor], parabolic refinement
  * voicing decision on peak strength vs ``voicing_threshold`` and local energy
  * median smoothing to kill octave spikes

The framing/padding contract (lpad = 2*pad_size, length reconciliation |d|<=8)
matches the reference exactly so binarized features stay drop-in compatible.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from diffsinger_tpu_torch.utils.pitch import f0_to_coarse_np


def extract_f0_ac(wav: np.ndarray, sample_rate: int, hop_size: int,
                  f0_min: float = 80.0, f0_max: float = 750.0,
                  voicing_threshold: float = 0.6,
                  silence_threshold: float = 0.01) -> np.ndarray:
    """Frame-synchronous F0 (Hz), 0 where unvoiced. Frames start at t=0 with
    step hop_size (praat-style centered analysis)."""
    wav = np.asarray(wav, dtype=np.float64)
    win = int(3 * sample_rate / f0_min)
    win += win % 2  # even
    half = win // 2
    n_frames = max(1, 1 + (len(wav) - 1) // hop_size)
    padded = np.pad(wav, (half, half + win))
    idx = np.arange(n_frames)[:, None] * hop_size + np.arange(win)[None, :]
    frames = padded[idx]  # [F, win], centered at t = i*hop
    frames = frames - frames.mean(axis=1, keepdims=True)

    window = np.hanning(win)
    peak_amp = np.abs(frames).max(axis=1)
    global_peak = max(np.abs(wav).max(), 1e-12)
    fw = frames * window

    # FFT-based autocorrelation, normalized; divide out the window's own ACF
    nfft = int(2 ** np.ceil(np.log2(2 * win)))
    spec = np.fft.rfft(fw, nfft)
    acf = np.fft.irfft(spec * np.conj(spec), nfft)[:, :win]
    acf0 = np.maximum(acf[:, :1], 1e-12)
    acf = acf / acf0
    wspec = np.fft.rfft(window, nfft)
    wacf = np.fft.irfft(wspec * np.conj(wspec), nfft)[:nfft // 2][:win]
    wacf = wacf / max(wacf[0], 1e-12)
    valid_w = wacf > 0.1
    acf_corr = np.where(valid_w[None, :], acf / np.maximum(wacf[None, :], 0.1), 0.0)

    lag_min = int(sample_rate / f0_max)
    lag_max = min(int(sample_rate / f0_min) + 1, win - 1)
    search = acf_corr[:, lag_min:lag_max]
    best = np.argmax(search, axis=1)
    lags = best + lag_min

    # parabolic interpolation around the peak
    l0 = np.clip(lags - 1, 0, win - 1)
    l2 = np.clip(lags + 1, 0, win - 1)
    y0 = acf_corr[np.arange(n_frames), l0]
    y1 = acf_corr[np.arange(n_frames), lags]
    y2 = acf_corr[np.arange(n_frames), l2]
    denom = (y0 - 2 * y1 + y2)
    safe = np.where(np.abs(denom) > 1e-12, denom, 1.0)
    shift = np.where(np.abs(denom) > 1e-12, 0.5 * (y0 - y2) / safe, 0.0)
    shift = np.clip(shift, -1, 1)
    refined = lags + shift

    f0 = sample_rate / np.maximum(refined, 1e-6)
    strength = y1
    voiced = ((strength > voicing_threshold)
              & (peak_amp > silence_threshold * global_peak)
              & (f0 >= f0_min) & (f0 <= f0_max))
    f0 = np.where(voiced, f0, 0.0)

    # 3-point median smoothing over voiced runs to remove octave spikes
    if n_frames >= 3:
        med = np.copy(f0)
        med[1:-1] = np.median(np.stack([f0[:-2], f0[1:-1], f0[2:]]), axis=0)
        f0 = np.where(f0 > 0, np.where(med > 0, med, f0), 0.0)
    return f0.astype(np.float32)


def get_pitch(wav: np.ndarray, mel: np.ndarray, hp: Dict) -> Tuple[np.ndarray,
                                                                   np.ndarray]:
    """Reference ``get_pitch`` contract (data_gen/tts/data_gen_utils.py:150-184):
    returns (f0 [T_mel], pitch_coarse [T_mel])."""
    hop_size = hp["hop_size"]
    sample_rate = hp["audio_sample_rate"]
    if hop_size == 128:
        pad_size = 4
    elif hop_size == 256:
        pad_size = 2
    else:
        pad_size = max(1, int(512 // hop_size))
    f0 = extract_f0_ac(wav, sample_rate, hop_size)
    # praat drops ~pad_size*2 frames at each end relative to the mel framing;
    # our extractor is frame-synchronous, so trim then re-pad identically to
    # keep the reference's layout contract
    f0 = f0[pad_size * 2: len(f0) - pad_size * 2] if len(f0) > pad_size * 4 else f0
    lpad = pad_size * 2
    rpad = max(len(mel) - len(f0) - lpad, 0)
    f0 = np.pad(f0, (lpad, rpad), mode="constant")
    delta_l = len(mel) - len(f0)
    assert np.abs(delta_l) <= 8, (len(mel), len(f0))
    if delta_l > 0:
        f0 = np.concatenate([f0, [f0[-1]] * delta_l])
    f0 = f0[: len(mel)]
    pitch_coarse = f0_to_coarse_np(f0.copy())
    return f0.astype(np.float32), pitch_coarse
