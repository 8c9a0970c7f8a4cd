"""What the float32 ``diffnet_stack`` tensor-core body's time is made of.

    python3 -m diffsinger_tpu_torch.tools.stack_ablate [B T]   (default 8 1024)

Times the float32 stack (C = 256, L = 20, dilation cycle 1) as built, then
with parts taken out (``-DSTACK_ABLATE_ONE_PASS``: one of the three split
products; ``-DSTACK_ABLATE_NO_SPLIT``: no hi/lo arithmetic;
``-DSTACK_ABLATE_NO_WEIGHTS``: no weight stream from L2 after the first
chunks). The ablated builds compute wrong values; only their times mean
something. Also prints the products the body executes and the time they
would take at the card's measured ``mma.sync`` TF32 rate (3.36 ns per product
and scheduler, ``tools/mma_rate.py``). Runs on the GPU only.
"""

from __future__ import annotations

import json
import sys

VARIANTS = ((), ("-DSTACK_ABLATE_ONE_PASS",), ("-DSTACK_ABLATE_NO_SPLIT",),
            ("-DSTACK_ABLATE_NO_WEIGHTS",),
            ("-DSTACK_ABLATE_ONE_PASS", "-DSTACK_ABLATE_NO_SPLIT"))
MMA_NS = 3.36          # ns per m16n8k8 TF32 mma.sync per scheduler, measured


def main(argv) -> int:
    import torch

    from diffsinger_tpu_torch.ops import _build
    from diffsinger_tpu_torch.ops import diffnet_stack as ds

    if not torch.cuda.is_available():
        print("stack_ablate: no CUDA device", file=sys.stderr)
        return 2
    b, t = (int(argv[0]), int(argv[1])) if len(argv) >= 2 else (8, 1024)
    c, num_layers = 256, 20
    for flags in VARIANTS:
        _build.build(["diffnet_stack"], flags)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    args = (torch.relu(rn(b, t, c)), rn(num_layers, b, c, scale=0.5),
            rn(num_layers, b, t, 2 * c, scale=0.5),
            rn(num_layers, 3, c, 2 * c, scale=(3 * c) ** -0.5), rn(num_layers, 2 * c, scale=0.1),
            rn(num_layers, c, 2 * c, scale=c ** -0.5), rn(num_layers, 2 * c, scale=0.1))
    dil = (1,) * num_layers
    row = {"B": b, "T": t, "C": c}
    for flags in VARIANTS:
        _build.use_variant("diffnet_stack", flags)
        ds._entry.cache_clear()
        run = lambda: ds.diffnet_stack(*args, dilations=dil)
        run()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            run()
        end.record()
        torch.cuda.synchronize()
        row[" ".join(f[len("-DSTACK_ABLATE_"):].lower() for f in flags) or "as built"] = \
            start.elapsed_time(end) / 5
    # a block: 8 warps x 4 row tiles x 2C/64 column tiles x 3 products, per
    # 8-deep step of the 4C-deep contraction (conv 3C, out C); one block an
    # SM, its four schedulers sharing the products
    blocks = b * -(-t // 64)
    per_block = 8 * 4 * (2 * c // 64) * 3 * (4 * c // 8)
    waves = -(-blocks // torch.cuda.get_device_properties(0).multi_processor_count)
    row["executed_gmma"] = num_layers * blocks * per_block / 1e9
    row["ms_at_mma_sync_rate"] = num_layers * waves * per_block / 4 * MMA_NS * 1e-6
    print("stack_ablate", json.dumps(row), flush=True)
    _build.use_variant("diffnet_stack", ())
    ds._entry.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
