"""Operations and bytes of one call of ``ops/diffnet_stack.py:diffnet_stack``,
the fused DiffNet residual stack, from the call's arguments.

Per layer the stack multiplies the rows [B*T, C] by the dilated conv's three
taps (3C -> 2C) and by the output projection (C -> 2C); the conditioner
projection arrives precomputed as an input. Bytes count each input read once
and the skip sum [B, T, C] float32 written once.
"""

from __future__ import annotations

from typing import Sequence, Tuple

OUTPUT_BYTES_PER_ELEMENT = 4  # the skip sum is float32


def counts(shapes: Sequence[Tuple[int, ...]], input_bytes: int) -> Tuple[float, float]:
    """(operations, bytes) of one call. ``shapes``: the call's tensor
    arguments in order (x0 [B, T, C], step_proj [L, B, C], cond_proj, w_dil
    [L, 3, C, 2C], ...); ``input_bytes``: their bytes together."""
    b, t, c = shapes[0]
    layers = shapes[3][0]
    flops = layers * 2 * (b * t) * (3 * c + c) * (2 * c)
    return float(flops), float(input_bytes + b * t * c * OUTPUT_BYTES_PER_ELEMENT)
