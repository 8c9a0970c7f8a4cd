"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, loaded with ``ctypes``. Libraries land in
``build/kernels/`` at the repository root, named by a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source or header
rebuilds and an unchanged one is reused. Nothing
here runs at import time: the CPU tests import every module without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
KERNEL_SOURCES = ("diffnet_stack", "mrf_stage", "diffnet_train")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}
_variant: Dict[str, Tuple[str, ...]] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _lib_path(name: str, extra_flags: Tuple[str, ...] = ()) -> Path:
    # every header counts for every source: an edited header rebuilds them all
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        src += header.name.encode() + header.read_bytes()
    flags = " ".join(NVCC_FLAGS + tuple(extra_flags))
    digest = hashlib.sha1(src + flags.encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = KERNEL_SOURCES,
          extra_flags: Tuple[str, ...] = ()) -> List[Tuple[str, float, str]]:
    """Compile every library not built yet, one ``nvcc`` per source, all
    started together. ``extra_flags`` (``-D...``) make a variant with a name
    of its own. Returns (name, seconds, compiler log) per source compiled;
    raises with the log when a compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = _lib_path(name, extra_flags)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs.append((name, out, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    done, failed = [], []
    for name, out, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        done.append((name, secs, log))
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


def load_library(name: str, extra_flags: Optional[Tuple[str, ...]] = None) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed: the
    variant built with ``extra_flags``, or the one :func:`use_variant` chose
    (the plain build unless a diagnostic tool asked for another)."""
    flags = _variant.get(name, ()) if extra_flags is None else tuple(extra_flags)
    lib = _loaded.get((name, flags))
    if lib is None:
        path = _lib_path(name, flags)
        if not path.exists():
            build([name], flags)
        lib = ctypes.CDLL(str(path))
        _loaded[(name, flags)] = lib
    return lib


def use_variant(name: str, extra_flags: Tuple[str, ...] = ()) -> None:
    """Make ``load_library(name)`` return the build with ``extra_flags`` from
    now on (``()`` is the plain one). For the diagnostic tools; a wrapper that
    caches its entry point has to drop that cache as well."""
    _variant[name] = tuple(extra_flags)


def check(err: int, what: str) -> None:
    """Raise when a kernel's C entry point reports a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
