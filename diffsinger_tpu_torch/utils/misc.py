"""Small host-side helpers: padded collation, meters, timers, wav IO (the
port's own numpy copy of diffsinger_tpu/utils/misc.py).

Capability parity with reference utils/__init__.py (collate_1d:44, collate_2d:62,
AvgrageMeter:28, Timer:222) re-expressed in numpy for the input pipeline; device
code never sees ragged shapes.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np


def collate_1d(values: Sequence[np.ndarray], pad_value: float = 0.0,
               max_len: Optional[int] = None, shift_right: bool = False,
               shift_id: int = 1) -> np.ndarray:
    """Stack 1-D arrays into [B, T_max] with right padding."""
    size = max_len if max_len is not None else max(len(v) for v in values)
    dtype = np.asarray(values[0]).dtype
    out = np.full((len(values), size), pad_value, dtype=dtype)
    for i, v in enumerate(values):
        v = np.asarray(v)
        if shift_right:
            out[i, 1 : len(v)] = v[:-1]
            out[i, 0] = shift_id
        else:
            out[i, : len(v)] = v
    return out


def collate_2d(values: Sequence[np.ndarray], pad_value: float = 0.0,
               max_len: Optional[int] = None) -> np.ndarray:
    """Stack 2-D arrays [T_i, C] into [B, T_max, C] with right padding."""
    size = max_len if max_len is not None else max(len(v) for v in values)
    v0 = np.asarray(values[0])
    out = np.full((len(values), size, v0.shape[1]), pad_value, dtype=v0.dtype)
    for i, v in enumerate(values):
        v = np.asarray(v)
        out[i, : len(v)] = v
    return out


class AvgMeter:
    """Running average of scalar metrics (reference utils/__init__.py:28-41)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.avg, self.sum, self.cnt = 0.0, 0.0, 0

    def update(self, val: float, n: int = 1):
        if val != val:  # skip NaNs like the reference loss meters
            return
        self.sum += float(val) * n
        self.cnt += n
        self.avg = self.sum / max(self.cnt, 1)


class MetricsDict:
    """Dict of AvgMeters keyed by metric name."""

    def __init__(self):
        self.meters: Dict[str, AvgMeter] = defaultdict(AvgMeter)

    def update(self, values: Dict[str, float], n: int = 1):
        for k, v in values.items():
            self.meters[k].update(float(v), n)

    def averages(self) -> Dict[str, float]:
        return {k: m.avg for k, m in self.meters.items()}


class Timer:
    """Named cumulative wall-clock timer context (reference utils/__init__.py:222-237)."""

    totals: Dict[str, float] = defaultdict(float)

    def __init__(self, name: str, print_time: bool = False):
        self.name = name
        self.print_time = print_time

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        Timer.totals[self.name] += time.perf_counter() - self.t0
        if self.print_time:
            print(self.name, round(Timer.totals[self.name], 4))


def save_wav(wav: np.ndarray, path: str, sample_rate: int, norm: bool = False):
    """int16 PCM wav writer (reference utils/audio.py:11-17)."""
    from scipy.io import wavfile

    wav = np.asarray(wav, dtype=np.float32)
    if norm and np.abs(wav).max() > 0:
        wav = wav / np.abs(wav).max()
    wavfile.write(path, sample_rate, (wav * 32767).astype(np.int16))


def load_wav(path: str, sample_rate: int) -> np.ndarray:
    """Load a wav file as float32 mono, resampling if needed (linear interp)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(-1)
    if sr != sample_rate:
        t_src = np.arange(len(data)) / sr
        t_dst = np.arange(int(len(data) * sample_rate / sr)) / sample_rate
        data = np.interp(t_dst, t_src, data).astype(np.float32)
    return data


def batch_by_size(indices: np.ndarray, num_tokens_fn, max_tokens: Optional[int] = None,
                  max_sentences: Optional[int] = None,
                  required_batch_size_multiple: int = 1) -> List[List[int]]:
    """Token-budget bucketing of (size-sorted) indices into batches
    (reference utils/__init__.py:89-142 semantics: each batch holds at most
    ``max_sentences`` items and ``max(len)*bsz <= max_tokens``; batch sizes are
    rounded down to a multiple when possible)."""
    max_tokens = max_tokens if max_tokens is not None else float("inf")
    max_sentences = max_sentences if max_sentences is not None else float("inf")
    bsz_mult = required_batch_size_multiple

    batch: List[int] = []
    batches: List[List[int]] = []
    sample_len = 0

    for idx in map(int, indices):
        this_len = num_tokens_fn(idx)
        assert this_len <= max_tokens, (
            f"sentence at index {idx} of size {this_len} exceeds max_tokens {max_tokens}")
        sample_len = max(sample_len, this_len)
        num_tokens = (len(batch) + 1) * sample_len
        if batch and (num_tokens > max_tokens or len(batch) == max_sentences):
            mod_len = max(bsz_mult * (len(batch) // bsz_mult),
                          len(batch) % bsz_mult)
            batches.append(batch[:mod_len])
            batch = batch[mod_len:]
            sample_len = max([num_tokens_fn(i) for i in batch], default=this_len)
        batch.append(idx)
    if batch:
        batches.append(batch)
    return batches
