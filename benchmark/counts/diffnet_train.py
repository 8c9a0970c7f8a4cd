"""Operations and bytes of one call of ``ops/diffnet_train.py``'s training
kernels, ``diffnet_train_fwd`` and ``diffnet_train_bwd``, from the call's
arguments and results.

Forward, per layer over the rows [B*T]: the dilated conv's three taps and the
conditioner projection (3C + H -> 2C) and the output projection (C -> 2C).
Backward, per layer: the recomputed forward products, the gate's and the
inputs' cotangents, and the weight gradients (the products of
``chip_smoke.py``'s ``train_stack_flops``). Bytes count each input read once
and each result written once.
"""

from __future__ import annotations

from typing import Sequence, Tuple


def _dims(shapes: Sequence[Tuple[int, ...]]) -> Tuple[int, int, int, int]:
    """(rows, C, H, layers) from (x0 or xs, step_proj [L, B, C], cond
    [B, T, H], k_cond, b_cond, w_dil [L, 3, C, 2C], ...)."""
    layers, _, c = shapes[1]
    b, t, h = shapes[2]
    return b * t, c, h, layers


def forward(shapes, input_bytes: int, output_bytes: int) -> Tuple[float, float]:
    rows, c, h, layers = _dims(shapes)
    flops = layers * 2 * rows * ((3 * c + h) * 2 * c + c * 2 * c)
    return float(flops), float(input_bytes + output_bytes)


def backward(shapes, input_bytes: int, output_bytes: int) -> Tuple[float, float]:
    rows, c, h, layers = _dims(shapes)
    flops = layers * 2 * rows * (2 * (3 * c + h) * 2 * c + 2 * (2 * c * c) + 2 * c * h
                                 + 6 * c * c)
    return float(flops), float(input_bytes + output_bytes)
