"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """Entry points run on the card unless the caller names another device.

    ``None`` means the default, CUDA. A CUDA request without a CUDA device
    raises: the port never moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU by default. "
            "Pass device='cpu' explicitly to run the plain PyTorch path.")
    return dev
