"""Matplotlib figures for TensorBoard validation plots (counterpart of
diffsinger_tpu/utils/plot.py): a spectrogram, a spectrogram with F0 curves,
phone durations, F0 curves. Inputs are numpy arrays; the backend is Agg.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

LINE_COLORS = ["w", "r", "y", "cyan", "m", "b", "lime"]


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def spec_to_figure(spec: np.ndarray, vmin: Optional[float] = None,
                   vmax: Optional[float] = None):
    """[T, M] spectrogram, frequency up."""
    plt = _plt()
    fig = plt.figure(figsize=(12, 6))
    plt.pcolor(np.asarray(spec).T, vmin=vmin, vmax=vmax)
    return fig


def spec_f0_to_figure(spec: np.ndarray, f0s: Dict[str, np.ndarray], figsize=None):
    """The spectrogram with each F0 curve (Hz / 10, clipped to the bins) on it."""
    plt = _plt()
    max_y = spec.shape[1]
    fig = plt.figure(figsize=(12, 6) if figsize is None else figsize)
    plt.pcolor(np.asarray(spec).T)
    for i, (k, f0) in enumerate(f0s.items()):
        plt.plot(np.clip(np.asarray(f0) / 10, 0, max_y), label=k,
                 c=LINE_COLORS[i % len(LINE_COLORS)], linewidth=1, alpha=0.8)
    plt.legend()
    return fig


def dur_to_figure(dur_gt: np.ndarray, dur_pred: np.ndarray, txt: Sequence[str]):
    """Phone boundaries: ground truth below (blue), predicted above (red)."""
    plt = _plt()
    dur_gt = np.cumsum(np.asarray(dur_gt, np.int64))
    dur_pred = np.cumsum(np.asarray(dur_pred, np.int64))
    fig = plt.figure(figsize=(12, 6))
    for i in range(len(dur_gt)):
        shift = (i % 8) + 1
        plt.text(dur_gt[i], shift, txt[i])
        plt.text(dur_pred[i], 10 + shift, txt[i])
        plt.vlines(dur_gt[i], 0, 10, colors="b")
        plt.vlines(dur_pred[i], 10, 20, colors="r")
    return fig


def f0_to_figure(f0_gt: np.ndarray, f0_cwt: Optional[np.ndarray] = None,
                 f0_pred: Optional[np.ndarray] = None):
    """Ground-truth F0 (red), with the CWT (blue) and predicted (green) ones."""
    plt = _plt()
    fig = plt.figure()
    plt.plot(np.asarray(f0_gt), color="r", label="gt")
    if f0_cwt is not None:
        plt.plot(np.asarray(f0_cwt), color="b", label="cwt")
    if f0_pred is not None:
        plt.plot(np.asarray(f0_pred), color="green", label="pred")
    plt.legend()
    return fig
