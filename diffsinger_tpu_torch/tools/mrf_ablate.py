"""What the ``mrf_stage`` kernel's time is made of.

    python3 -m diffsinger_tpu_torch.tools.mrf_ablate [bfloat16]

float32 (the default): times the ``wgmma`` body on the four scales (C = 128 /
64 / 32 / 16 at 8 x 1024 mel frames) as built, then with one of its three
split products (``-DMRF_ABLATE_ONE_PASS``; wrong values, only the time means
something). Also prints the products the window plan executes (its halo and
64-row rounding included) and their time at the card's TF32 peak (495
TFLOP/s): the share of that peak the body reaches on the work it does.

bfloat16: times the bf16 body on the same scales as built, beside the float32
body, then without its products (``-DMRF_ABLATE_BF16_NO_MMA``) and without
the epilogues of all but the last conv (``-DMRF_ABLATE_BF16_NO_EPILOGUE``),
and prints the m16n8k16 products the bf16 plan executes (its tiles'
recompute included) and their time at the measured bf16 ``mma.sync`` rate
(637.8 TFLOP/s). Runs on the GPU only.
"""

from __future__ import annotations

import json
import sys

VARIANTS = ((), ("-DMRF_ABLATE_ONE_PASS",))
BF16_VARIANTS = ((), ("-DMRF_ABLATE_BF16_NO_MMA",), ("-DMRF_ABLATE_BF16_NO_EPILOGUE",))
KS, DS = (3, 7, 11), ((1, 3, 5),) * 3
TF32_FLOPS = 495e12         # dense TF32 peak of an H100 SXM
MMA_BF16_FLOPS = 637.8e12   # bf16 mma.sync rate, measured (tools/mma_rate.py)


def executed_flops(mrf, c: int, b: int, t: int, n_sm: int) -> float:
    """Tensor-core operations the float32 plan makes the wgmma body run for x
    [b, t, c]: per conv, taps x 8-deep steps x 64-row tiles x three
    m64nCk8 products."""
    total = 0
    for br in mrf.mrf_window_plan(KS, DS, mrf.choose_mrf_tiles(c, b, t, KS, DS, n_sm)):
        per_block = sum(br["kernel_size"] * (c // 8) * -(-(hi - lo) // 64)
                        for lo, hi in br["ranges"])
        total += b * -(-t // br["tile"]) * per_block
    return float(total) * 3 * 2 * 64 * c * 8


def executed_mma_bf16(mrf, torch, c: int, b: int, t: int, n_sm: int) -> float:
    """m16n8k16 bf16 mma.sync products the bf16 plan makes the kernel run for
    x [b, t, c]: per conv, taps x 16-deep steps x 16-row tiles x 8-column
    tiles."""
    total = 0
    tiles = mrf.choose_mrf_tiles(c, b, t, KS, DS, n_sm, torch.bfloat16)
    for br in mrf.mrf_window_plan(KS, DS, tiles):
        per_block = sum(br["kernel_size"] * (c // 16) * -(-(hi - lo) // 16) * (c // 8)
                        for lo, hi in br["ranges"])
        total += b * -(-t // br["tile"]) * per_block
    return float(total)


def _time(torch, run, reps: int = 3) -> float:
    run()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    import torch

    from diffsinger_tpu_torch.ops import _build
    from diffsinger_tpu_torch.ops import hifigan_mrf as mrf

    argv = sys.argv[1:] if argv is None else argv
    bf16 = argv[:1] == ["bfloat16"]
    if not torch.cuda.is_available():
        print("mrf_ablate: no CUDA device", file=sys.stderr)
        return 2
    variants = BF16_VARIANTS if bf16 else VARIANTS
    for flags in variants:
        _build.build(["mrf_stage"], flags)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(1)
    for c, t in ((128, 65536), (64, 131072), (32, 262144)) + (() if bf16 else ((16, 524288),)):
        x = torch.randn(8, t, c, generator=gen, device="cuda") * 0.3
        w1 = torch.randn(3, 3, 11 * c, c, generator=gen, device="cuda") * (7 * c) ** -0.5
        w2 = torch.randn(3, 3, 11 * c, c, generator=gen, device="cuda") * (7 * c) ** -0.5
        b1 = torch.randn(3, 3, c, generator=gen, device="cuda") * 0.05
        b2 = torch.randn(3, 3, c, generator=gen, device="cuda") * 0.05
        row = {"C": c, "B": 8, "T": t}
        kw = dict(kernel_sizes=KS, dilation_sets=DS)
        args = (x, w1, b1, w2, b2)
        if bf16:
            args = (x.bfloat16(), w1.bfloat16(), b1, w2.bfloat16(), b2)
            kw["compute_dtype"] = torch.bfloat16
            row["float32 ms"] = _time(torch, lambda: mrf.mrf_stage(
                x, w1, b1, w2, b2, kernel_sizes=KS, dilation_sets=DS))
        for flags in variants:
            _build.use_variant("mrf_stage", flags)
            mrf._entry.cache_clear()
            name = " ".join(f[2:].lower().replace("mrf_ablate_", "").replace("mrf_", "")
                            for f in flags) or "as built"
            row[name] = _time(torch, lambda: mrf.mrf_stage(*args, **kw))
        if bf16:
            n_mma = executed_mma_bf16(mrf, torch, c, 8, t, n_sm)
            row["executed_gmma"] = n_mma / 1e9
            row["recompute"] = n_mma * 4096 / (252 * c * c * 8 * t)
            row["ms_at_mma_sync_rate"] = n_mma * 4096 / MMA_BF16_FLOPS * 1e3
            row["mma_sync_share"] = row["ms_at_mma_sync_rate"] / row["as built"]
            print("mrf_ablate_bf16", json.dumps(row), flush=True)
            continue
        flops = executed_flops(mrf, c, 8, t, n_sm)
        row["executed_tflop"] = flops / 1e12
        row["recompute"] = flops / 3 / (252 * c * c * 8 * t)
        row["ms_at_tf32_peak"] = flops / TF32_FLOPS * 1e3
        row["tf32_peak_share"] = row["ms_at_tf32_peak"] / row["as built"]
        print("mrf_ablate", json.dumps(row), flush=True)
    _build.use_variant("mrf_stage", ())
    mrf._entry.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
