"""Operations and bytes of one call of ``ops/hifigan_mrf.py:mrf_stage``, one
whole HiFiGAN multi-receptive-field scale, from the call's arguments.

The scale runs, for each kernel size k of ``kernel_sizes`` and each dilation
of its set, a dilated k-tap conv and a k-tap conv, C -> C, over all B*T
samples. The packed weights pad every branch to the largest kernel; bytes
count only the taps a branch uses, each input read once and the output
[B, T, C] float32 written once.
"""

from __future__ import annotations

from typing import Sequence, Tuple

OUTPUT_BYTES_PER_ELEMENT = 4  # the scale's output is float32


def counts(shapes: Sequence[Tuple[int, ...]], element_sizes: Sequence[int],
           kernel_sizes: Sequence[int],
           dilation_sets: Sequence[Sequence[int]]) -> Tuple[float, float]:
    """(operations, bytes) of one call. ``shapes`` and ``element_sizes``:
    the call's tensor arguments in order, x [B, T, C], w1 [n_branch,
    n_stage, k_max*C, C], b1 [n_branch, n_stage, C], w2, b2."""
    b, t, c = shapes[0]
    taps = sum(k * len(d) * 2 for k, d in zip(kernel_sizes, dilation_sets))
    flops = 2 * b * t * c * c * taps
    weights = taps * c * c * element_sizes[1]
    biases = sum(len(d) * 2 for d in dilation_sets) * c * element_sizes[2]
    x_in = b * t * c * element_sizes[0]
    return float(flops), float(x_in + weights + biases + b * t * c * OUTPUT_BYTES_PER_ELEMENT)
