"""What the warp-level tensor-core path gives on this card.

    python3 -m diffsinger_tpu_torch.tools.mma_rate

Builds ``csrc/bench/mma_rate.cu`` with ``nvcc`` for ``sm_90a`` into
``build/kernels/`` and runs it: the peak ``mma.sync`` rates (bf16, TF32) and
the stack kernel's GEMM step without its weight stream. The ``mma.sync``
kernels' times in ``PERF.md`` are read against these rates. Runs on a machine with an NVIDIA GPU and the CUDA toolkit only.
"""

from __future__ import annotations

import subprocess
import sys

from diffsinger_tpu_torch.ops import _build


def main() -> int:
    src = _build.CSRC_DIR / "bench" / "mma_rate.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = _build.BUILD_DIR / "mma_rate"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC",
                                                        "-Xptxas", "-v")]
    subprocess.run([_build._nvcc(), *flags, "-o", str(exe), str(src)], check=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print("card:", card, flush=True)
    return subprocess.run([str(exe)]).returncode


if __name__ == "__main__":
    sys.exit(main())
