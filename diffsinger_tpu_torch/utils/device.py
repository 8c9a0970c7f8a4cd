"""Device selection and float32 mode for the port's entry points."""

from __future__ import annotations

import os
from typing import Union

import torch
import torch.distributed as dist


def disable_tf32() -> None:
    """Float32 matmuls and cuDNN convolutions compute in float32, as JAX's
    float32 reference and the kernels' plain twins do: torch's default lets
    cuDNN round their inputs to TF32. A user who wants TF32 sets the two
    switches back after building the modules."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """Entry points run on the card unless the caller names another device.

    ``None`` means the default, CUDA. Under a process group a bare ``cuda``
    is this rank's card, ``cuda:{LOCAL_RANK}`` (torchrun's variable). A CUDA
    request without that CUDA device raises: the port never moves to the CPU
    or to another rank's card on its own. A CUDA device turns TF32 off
    (``disable_tf32``); the CPU changes nothing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU by default. "
            "Pass device='cpu' explicitly to run the plain PyTorch path.")
    if dev.index is None and dist.is_initialized():
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if dev.index is not None and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"{dev} is absent: this machine has "
                           f"{torch.cuda.device_count()} CUDA device(s)")
    disable_tf32()
    return dev
