"""Where the training kernels (``csrc/diffnet_train.cu``) spend a call.

    python3 -m diffsinger_tpu_torch.tools.train_phases [B T] [float32]
        (default 24 1024, bfloat16)

Runs the forward and the backward at C = H = 256, L = 20 on the card, on the
bfloat16 tensor-core kernels or, with ``float32``, on the float32 (3xTF32)
ones the shipped configs train with, and prints two JSON lines:
  * ``train_kernels``: device time of one forward and one backward call by
    kernel (``torch.profiler``), each kernel's products and its TFLOP/s, with
    the source built with ``-DTRAIN_NO_DEPENDENT_LAUNCH``: as shipped a kernel
    is launched to overlap the one before it, starts early and waits, so its
    duration would include that wait. ``fwd_ms`` / ``bwd_ms`` are CUDA-event
    times of whole calls, serial and as shipped;
  * ``train_phases``: the source built with ``-DTRAIN_PHASE_CLOCKS`` (thread 0
    of every row block records ``clock64()`` at up to eight points), the
    median over the blocks of each phase of the last launch of the three
    row-block kernels, in SM cycles and in microseconds at the SM clock
    ``nvidia-smi`` reports after the run.
Runs on the GPU only.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys

# the row-block kernels' phases, in the order of their clock points; the
# index of each kernel's clocks in the library's record is its place here
PHASES = {
    "fwd_layer_tc": ("weight prefetch, wait for the layer before, stage y and cond",
                     "conv + cond GEMM (64 weight chunks)", "gate epilogue (g to shared memory)",
                     "out GEMM (16 chunks)", "residual epilogue (x, skip, xs)"),
    "bwd_gate_tc": ("weight prefetch, wait, stage dout with its column sums",
                    "dg GEMM (16 chunks), park dg", "stage y and cond",
                    "recompute GEMM (64 chunks)", "epilogue (g, dconv, column sums)"),
    "bwd_dx_tc": ("weight prefetch, wait, stage the dconv tile",
                  "dy GEMM (48 chunks)", "dx epilogue (dx, dstep sums)",
                  "dcond GEMM (16 chunks)", "dcond epilogue"),
    "fwd_layer_tc32": ("weight prefetch, stage cond", "cond GEMM (16 chunks)",
                       "wait for the layer before, stage y", "tap GEMM (48 chunks)",
                       "gate epilogue, g over y", "out GEMM (16 chunks)",
                       "residual epilogue (x, skip, xs)"),
    "bwd_gate_tc32": ("weight prefetch, wait, stage the dx half of dout",
                      "column sums, dg GEMM (16 chunks, ds half staged between), park dg",
                      "stage cond", "cond GEMM (16 chunks)", "stage y",
                      "tap GEMM (48 chunks)", "epilogue (g, dconv, column sums)"),
    "bwd_dx_tc32": ("weight prefetch, wait, stage the first dconv half",
                    "dy + dcond GEMMs on it (32 chunks)", "stage the second half",
                    "dy + dcond GEMMs on it (32 chunks)", "dx epilogue (dx, dstep sums)",
                    "dcond epilogue"),
}


def kernel_flops(rows: int, c: int, h: int, suffix: str = "") -> dict:
    """Products of one launch (one layer) of each tensor-core kernel."""
    return {"fwd_layer_tc" + suffix: 2 * rows * ((3 * c + h) * 2 * c + c * 2 * c),
            "bwd_gate_tc" + suffix: 2 * rows * (2 * c * c + (3 * c + h) * 2 * c),
            "bwd_dx_tc" + suffix: 2 * rows * (6 * c * c + 2 * c * h),
            "wgrad_tc" + suffix: 2 * rows * (4 * c + h) * 2 * c}


def main(argv) -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from diffsinger_tpu_torch.ops import _build
    from diffsinger_tpu_torch.ops import diffnet_train as tr

    if not torch.cuda.is_available():
        print("train_phases: no CUDA device", file=sys.stderr)
        return 2
    f32 = "float32" in argv
    argv = [a for a in argv if a != "float32"]
    b, t = (int(argv[0]), int(argv[1])) if len(argv) >= 2 else (24, 1024)
    suffix = "32" if f32 else ""
    c = h = 256
    num_layers = 20
    gen = torch.Generator(device="cuda").manual_seed(2)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    args = (torch.relu(rn(b, t, c)), rn(num_layers, b, c, scale=0.5), rn(b, t, h),
            rn(num_layers, h, 2 * c, scale=h ** -0.5), rn(num_layers, 2 * c, scale=0.1),
            rn(num_layers, 3, c, 2 * c, scale=(3 * c) ** -0.5),
            rn(num_layers, 2 * c, scale=0.1), rn(num_layers, c, 2 * c, scale=c ** -0.5),
            rn(num_layers, 2 * c, scale=0.1))
    ds = rn(b, t, c)
    kw = dict(dilations=(1,) * num_layers, compute_dtype=None if f32 else torch.bfloat16)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()

    def run():
        _, xs = tr.diffnet_train_fwd(*args, **kw)
        tr.diffnet_train_bwd(xs, *args[1:8], ds, **kw)

    def call_ms():
        _, xs = tr.diffnet_train_fwd(*args, **kw)
        out = []
        for fn in (lambda: tr.diffnet_train_fwd(*args, **kw),
                   lambda: tr.diffnet_train_bwd(xs, *args[1:8], ds, **kw)):
            fn()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                fn()
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end) / 5)
        return out

    shipped = call_ms()
    _build.use_variant("diffnet_train", ("-DTRAIN_NO_DEPENDENT_LAUNCH",))
    tr._entries.cache_clear()
    serial = call_ms()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    flops = kernel_flops(b * t, c, h, suffix)
    rows = []
    for e in prof.key_averages():
        if e.device_type.name != "CUDA" or e.self_device_time_total <= 0:
            continue
        # the kernel's own name, whole (fwd_layer_tc is also the start of
        # fwd_layer_tc32): a word before its template or parameter list
        known = list(flops) + ["finish_kernel"]
        name = next((w for w in re.findall(r"(\w+)\s*[<(]", e.key) if w in known), None)
        if name is None:
            continue
        ms = e.self_device_time_total / 1e3
        row = {"kernel": name, "ms": ms, "launches": e.count}
        if name in flops:
            row["tflops"] = flops[name] * e.count / ms / 1e9
        rows.append(row)
    print("train_kernels", json.dumps({"card": card, "B": b, "T": t,
                                       "dtype": "float32" if f32 else "bfloat16",
                                       "fwd_ms": {"shipped": shipped[0], "serial": serial[0]},
                                       "bwd_ms": {"shipped": shipped[1], "serial": serial[1]},
                                       "kernels": sorted(rows, key=lambda r: -r["ms"])}))

    _build.use_variant("diffnet_train", ("-DTRAIN_PHASE_CLOCKS",))
    tr._entries.cache_clear()
    lib = _build.load_library("diffnet_train")
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    clocks = np.zeros((len(PHASES), 1024, 8), np.int64)
    lib.diffnet_train_read_clocks.argtypes = [ctypes.c_void_p]
    _build.check(lib.diffnet_train_read_clocks(clocks.ctypes.data), "diffnet_train_read_clocks")
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, check=True).stdout.split()[0])
    n_blocks = min(b * ((t + 63) // 64), 1024)
    out = {"card": card, "B": b, "T": t, "dtype": "float32" if f32 else "bfloat16",
           "blocks": n_blocks, "sm_mhz": mhz, "kernels": {}}
    for k, (name, phases) in enumerate(PHASES.items()):
        if name.endswith("32") != f32:
            continue
        clk = clocks[k, :n_blocks, :len(phases) + 1]
        spans = np.diff(clk, axis=1)
        out["kernels"][name] = {
            "block_us": float(np.median(clk[:, -1] - clk[:, 0])) / mhz,
            "phases": [{"phase": p, "cycles_median": float(np.median(spans[:, i])),
                        "us": float(np.median(spans[:, i])) / mhz}
                       for i, p in enumerate(phases)]}
    print("train_phases", json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
