"""What the float32 ``mrf_stage`` kernel's time is made of.

    python3 -m diffsinger_tpu_torch.tools.mrf_ablate

Times the kernel on the three serving scales (C = 128 / 64 / 32 at 8 x 1024
mel frames) as built, then with parts taken out (``-DMRF_ABLATE_ONE_PASS``:
one of the three split products; ``-DMRF_ABLATE_NO_SPLIT``: no hi/lo
arithmetic). The ablated builds compute wrong values; only their times mean
something. Also prints the products the plan executes and the time they would
take at the card's measured ``mma.sync`` TF32 rate (3.36 ns per product and
scheduler, ``tools/mma_rate.py``). Runs on the GPU only.
"""

from __future__ import annotations

import json
import sys

VARIANTS = ((), ("-DMRF_ABLATE_ONE_PASS",), ("-DMRF_ABLATE_NO_SPLIT",),
            ("-DMRF_ABLATE_ONE_PASS", "-DMRF_ABLATE_NO_SPLIT"))
KS, DS = (3, 7, 11), ((1, 3, 5),) * 3
MMA_NS = 3.36          # ns per m16n8k8 TF32 mma.sync per scheduler, measured
SCHEDULERS = 132 * 4


def executed_mma(mrf, c: int, b: int, t: int, n_sm: int) -> float:
    """mma.sync products the plan makes the kernel run for x [b, t, c]."""
    total = 0
    for br in mrf.mrf_window_plan(KS, DS, mrf.choose_mrf_tiles(c, b, t, KS, DS, n_sm)):
        per_block = sum(br["kernel_size"] * (c // 8) * -(-(hi - lo) // 16) * (c // 8) * 3
                        for lo, hi in br["ranges"])
        total += b * -(-t // br["tile"]) * per_block
    return float(total)


def main() -> int:
    import torch

    from diffsinger_tpu_torch.ops import _build
    from diffsinger_tpu_torch.ops import hifigan_mrf as mrf

    if not torch.cuda.is_available():
        print("mrf_ablate: no CUDA device", file=sys.stderr)
        return 2
    for flags in VARIANTS:
        _build.build(["mrf_stage"], flags)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(1)
    for c, t in ((128, 65536), (64, 131072), (32, 262144)):
        x = torch.randn(8, t, c, generator=gen, device="cuda") * 0.3
        w1 = torch.randn(3, 3, 11 * c, c, generator=gen, device="cuda") * (7 * c) ** -0.5
        w2 = torch.randn(3, 3, 11 * c, c, generator=gen, device="cuda") * (7 * c) ** -0.5
        b1 = torch.randn(3, 3, c, generator=gen, device="cuda") * 0.05
        b2 = torch.randn(3, 3, c, generator=gen, device="cuda") * 0.05
        row = {"C": c, "B": 8, "T": t}
        for flags in VARIANTS:
            _build.use_variant("mrf_stage", flags)
            mrf._entry.cache_clear()
            run = lambda: mrf.mrf_stage(x, w1, b1, w2, b2, kernel_sizes=KS, dilation_sets=DS)
            run()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                run()
            end.record()
            torch.cuda.synchronize()
            row[" ".join(f[len("-DMRF_ABLATE_"):].lower() for f in flags) or "as built"] = \
                start.elapsed_time(end) / 3
        n_mma = executed_mma(mrf, c, 8, t, n_sm)
        row["executed_gmma"] = n_mma / 1e9
        row["ms_at_mma_sync_rate"] = n_mma / SCHEDULERS * MMA_NS * 1e-6
        print("mrf_ablate", json.dumps(row), flush=True)
    _build.use_variant("mrf_stage", ())
    mrf._entry.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
