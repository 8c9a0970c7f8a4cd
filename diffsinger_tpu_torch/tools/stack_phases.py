"""Where one block of a ``diffnet_stack`` tensor-core body spends a layer.

    python3 -m diffsinger_tpu_torch.tools.stack_phases [B T [DTYPE]]
        (default 8 1024 bfloat16; DTYPE bfloat16 or float32)

Builds ``csrc/diffnet_stack.cu`` with ``-DSTACK_PHASE_CLOCKS`` (thread 0 of
every block records ``clock64()`` at six points), runs the stack at C = 256,
L = 20 on the card and prints, for the last layer, the median over the blocks
of each phase in SM cycles and in microseconds at the SM clock ``nvidia-smi``
reports after the run. A layer is launched to overlap the one before it, so
its first phase includes the wait for that layer to complete (with fewer
blocks than SMs, for all layers before it). Runs on the GPU only.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

PHASES = ("wait for the layer before, stage y (x + step, halo)",
          "conv GEMM (48 weight chunks of 16 rows)", "gate epilogue (cond, sigmoid*tanh, g)",
          "out GEMM (16 weight chunks)", "residual epilogue (x_out, skip)")


def main(argv) -> int:
    import numpy as np
    import torch

    from diffsinger_tpu_torch.ops import _build
    from diffsinger_tpu_torch.ops import diffnet_stack as ds

    if not torch.cuda.is_available():
        print("stack_phases: no CUDA device", file=sys.stderr)
        return 2
    b, t = (int(argv[0]), int(argv[1])) if len(argv) >= 2 else (8, 1024)
    dt_name = argv[2] if len(argv) >= 3 else "bfloat16"
    dt = {"bfloat16": torch.bfloat16, "float32": None}[dt_name]
    c, num_layers = 256, 20
    _build.use_variant("diffnet_stack", ("-DSTACK_PHASE_CLOCKS",))
    ds._entry.cache_clear()
    lib = _build.load_library("diffnet_stack")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    wdt = dt or torch.float32
    args = (torch.relu(rn(b, t, c)), rn(num_layers, b, c, scale=0.5),
            rn(num_layers, b, t, 2 * c, scale=0.5).to(wdt),
            rn(num_layers, 3, c, 2 * c, scale=(3 * c) ** -0.5).to(wdt),
            rn(num_layers, 2 * c, scale=0.1),
            rn(num_layers, c, 2 * c, scale=c ** -0.5).to(wdt),
            rn(num_layers, 2 * c, scale=0.1))
    for _ in range(3):
        ds.diffnet_stack(*args, dilations=(1,) * num_layers, compute_dtype=dt)
    torch.cuda.synchronize()
    if not ds.diffnet_stack.ran_tensor_cores:
        print(f"stack_phases: {dt_name} did not run a tensor-core body", file=sys.stderr)
        return 2
    # the float32 body's split runs each tile on column_split blocks
    n_blocks = min(b * ((t + 63) // 64) * (ds.diffnet_stack.column_split or 1), 4096)
    clocks = np.zeros((n_blocks, 6), np.int64)
    lib.diffnet_stack_read_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    err = lib.diffnet_stack_read_clocks(clocks.ctypes.data, n_blocks)
    _build.check(err, "diffnet_stack_read_clocks")
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, check=True).stdout.split()[0])
    spans = np.diff(clocks, axis=1)
    out = {"dtype": dt_name, "B": b, "T": t, "blocks": n_blocks, "sm_mhz": mhz,
           "block_cycles_median": float(np.median(clocks[:, 5] - clocks[:, 0])),
           "phases": [{"phase": name, "cycles_median": float(np.median(spans[:, i])),
                       "us": float(np.median(spans[:, i])) / mhz}
                      for i, name in enumerate(PHASES)]}
    out["block_us"] = out["block_cycles_median"] / mhz
    print("stack_phases", json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
