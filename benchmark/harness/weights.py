"""Seeded weights, made by the benchmark and handed alike to the program and
to the plain reference.

The parameter list (names and shapes) is read from a module tree of the
frozen reference, whose names are the program's. All values come from one
``torch.randn`` on the target device (a ``torch.Generator`` there, seeded
from the run's seed), sliced and scaled leaf by leaf: weights of a
[out, in, ...] matrix or conv at torch's default scale, 1 / sqrt(3 fan_in),
so that every layer passes a signal of about unit size; norm gains around 1;
BatchNorm running statistics around their neutral values. ``overrides``
then apply what the configuration assumes (``assumed`` in its file).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Tuple

import numpy as np
import torch
import torch.nn as nn

NORMS = (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm1d)


def leaves(module: nn.Module) -> Iterable[Tuple[str, torch.Size, str]]:
    """(name, shape, rule) of every parameter and BatchNorm running
    statistic, in a fixed order."""
    for mod_name, mod in module.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        for p_name, p in mod.named_parameters(recurse=False):
            if isinstance(mod, NORMS):
                rule = "gain" if p_name == "weight" else "shift"
            elif p.ndim >= 2:
                rule = "fan"
            elif p_name == "pos_embed_alpha":
                rule = "gain"
            else:
                rule = "bias"
            yield prefix + p_name, p.shape, rule
        if isinstance(mod, nn.BatchNorm1d):
            yield prefix + "running_mean", mod.running_mean.shape, "running_mean"
            yield prefix + "running_var", mod.running_var.shape, "running_var"


def make(module: nn.Module, seed: int, device,
         overrides: Callable[[Dict[str, torch.Tensor]], None] = None) -> Dict[str, torch.Tensor]:
    """The weights of ``module``'s tree as a name -> tensor dict on ``device``."""
    spec = list(leaves(module))
    sizes = [int(np.prod(shape)) for _, shape, _ in spec]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    fan_scale: Dict[str, float] = {}
    offset = 0
    for (name, shape, rule), n in zip(spec, sizes):
        z = flat[offset:offset + n].view(shape)
        offset += n
        if rule == "fan":
            fan_in = n // shape[0]
            fan_scale[name.rsplit(".", 1)[0]] = 1.0 / math.sqrt(3 * fan_in)
            out[name] = z * (1.0 / math.sqrt(3 * fan_in))
        elif rule == "bias":
            out[name] = z * fan_scale.get(name.rsplit(".", 1)[0], 0.02)
        elif rule == "gain":
            out[name] = 1.0 + 0.05 * z
        elif rule == "shift":
            out[name] = 0.05 * z
        elif rule == "running_mean":
            out[name] = 0.2 * z
        else:  # running_var: 0.5 to 2
            out[name] = torch.exp(0.35 * z.clamp(-2.0, 2.0))
    if overrides is not None:
        with torch.no_grad():
            overrides(out)
    return out


def load(module: nn.Module, weights: Dict[str, torch.Tensor], prefix: str = "") -> None:
    """Copy ``weights`` (keys under ``prefix``) into ``module``'s parameters
    and running statistics; every one of them must be given."""
    own = dict(module.named_parameters())
    own.update((k, v) for k, v in module.named_buffers() if k.endswith(("running_mean",
                                                                        "running_var")))
    given = {k[len(prefix):]: v for k, v in weights.items() if k.startswith(prefix)}
    if set(own) != set(given):
        missing, extra = sorted(set(own) - set(given)), sorted(set(given) - set(own))
        raise KeyError(f"weights do not match the module: missing {missing[:5]}, "
                       f"extra {extra[:5]}")
    with torch.no_grad():
        for k, t in own.items():
            if tuple(t.shape) != tuple(given[k].shape):
                raise ValueError(f"{prefix}{k}: shape {tuple(given[k].shape)}, "
                                 f"the module has {tuple(t.shape)}")
            t.copy_(given[k].to(t.device, t.dtype))
