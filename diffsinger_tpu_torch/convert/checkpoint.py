"""Torch checkpoints in the upstream layout (counterpart of
diffsinger_tpu/convert/checkpoint.py and ``fold_weight_norm`` of
diffsinger_tpu/convert/torch_names.py).

The port names its parameters with the upstream keys, so a checkpoint loads
without renaming: ``load_torch_state_dict`` takes the ``state_dict`` /
``model`` nesting, flattens nested dicts to dotted keys, slices the
``model.`` prefix (falling back to the unprefixed dict when nothing carries
it), ``fold_weight_norm`` folds ``weight_g`` / ``weight_v`` pairs, and
``merge_state_dict`` loads what matches, printing each key it skips for a
shape mismatch (upstream's non-strict load). Keys upstream saves that the
port keeps in hparams (the diffusion coefficient buffers, ``spec_min`` /
``spec_max``) and position-table buffers are ignored, as the JAX converter
ignores them.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

# upstream buffers that carry no parameter of the port (GaussianDiffusion's
# schedule and spec range, fairseq's position-table placeholder)
_IGNORED = re.compile(r"(^|\.)(betas|alphas_cumprod\w*|sqrt_\w+|log_one_minus_alphas_cumprod"
                      r"|posterior_\w+|spec_min|spec_max|_float_tensor)$")


def find_latest_ckpt(path: str) -> Optional[str]:
    """``path`` itself when it is a file, else the ``model_ckpt_steps_*.ckpt``
    in that directory with the most steps (None when there is none)."""
    if not path:
        return None
    if os.path.isfile(path):
        return path
    cands = glob.glob(os.path.join(path, "model_ckpt_steps_*.ckpt"))
    if not cands:
        return None
    return max(cands, key=ckpt_step)


def ckpt_step(path: str) -> int:
    return int(re.findall(r"steps_(\d+)\.ckpt", path)[0])


def torch_load(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=False)


def load_torch_state_dict(ckpt, prefix: str = "model.") -> Dict[str, torch.Tensor]:
    """A checkpoint path (or an already loaded checkpoint dict) -> flat
    {key: tensor} of the keys under ``prefix``, with the prefix removed;
    the whole unprefixed dict when no key carries the prefix."""
    raw = ckpt if isinstance(ckpt, dict) else torch_load(ckpt)
    sd = raw.get("state_dict", raw)
    if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
        sd = sd["model"]

    def _flatten(d, base=""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from _flatten(v, f"{base}{k}.")
            else:
                yield f"{base}{k}", v

    flat = {k: (v.detach().cpu() if isinstance(v, torch.Tensor) else torch.as_tensor(v))
            for k, v in _flatten(sd)}
    if prefix:
        sliced = {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
        if sliced:
            return sliced
    return flat


def fold_weight_norm(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fold every ``<name>.weight_g`` / ``<name>.weight_v`` pair into
    ``<name>.weight`` = g * v / ||v||, the norm over all dims but 0 (torch
    ``weight_norm`` with dim=0, ConvTranspose1d included)."""
    out = dict(sd)
    for k in list(sd):
        if not k.endswith(".weight_v"):
            continue
        base = k[: -len(".weight_v")]
        g = sd.get(base + ".weight_g")
        if g is None:
            continue
        v = sd[k].to(torch.float32)
        norm = v.pow(2).sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
        out[base + ".weight"] = g.to(torch.float32) * v / norm.clamp_min(1e-12)
        del out[k], out[base + ".weight_g"]
    return out


def generator_state_dict(raw: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A vocoder checkpoint, already loaded -> the generator's flat state
    dict with weight norm folded: the generator sits under ``model_gen``
    (upstream's ``state_dict``), ``generator`` (the official HiFi-GAN and
    ParallelWaveGAN releases, whose ``model`` dict holds it) or ``model``."""
    sd = load_torch_state_dict(raw, prefix="")
    for key in ("model_gen", "generator", "model"):
        inner = sub_dict(sd, key)
        if inner:
            sd = inner
            break
    return fold_weight_norm(sd)


def convert_pwg(raw: Dict[str, Any]) -> Tuple[Dict[str, torch.Tensor], bool]:
    """A loaded ParallelWaveGAN checkpoint -> (the port's ``ParallelWaveGANGenerator``
    state dict, whether it is an official release). Upstream's layout keeps
    the generator under ``state_dict.model_gen``; the official
    ``checkpoint-*steps.pkl`` under ``model.generator``, with no
    ``state_dict``, and its mels must be standardized by the release's
    statistics. The port's PWG carries upstream's key names, so only the
    weight-norm pairs change."""
    return generator_state_dict(raw), "state_dict" not in raw


def sub_dict(sd: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The entries under ``prefix + '.'``, with that prefix removed."""
    p = prefix + "."
    return {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}


def split_keys(module: nn.Module, sd: Dict[str, torch.Tensor]
               ) -> Tuple[list, list, list, list]:
    """(matched, shape-mismatched, missing, unexpected) keys of ``sd`` against
    ``module.state_dict()``; ignored upstream buffers are neither."""
    own = module.state_dict()
    matched, mismatched, unexpected = [], [], []
    for k, v in sd.items():
        if k in own:
            (matched if tuple(v.shape) == tuple(own[k].shape) else mismatched).append(k)
        elif not _IGNORED.search(k):
            unexpected.append(k)
    missing = [k for k in own if k not in sd]
    return matched, mismatched, missing, unexpected


def merge_state_dict(module: nn.Module, sd: Dict[str, torch.Tensor], path: str = "") -> int:
    """Non-strict load: every key of ``sd`` that ``module`` holds with the same
    shape is copied in; a shape mismatch is skipped with a printed line.
    Returns the number of tensors loaded."""
    matched, mismatched, _, _ = split_keys(module, sd)
    own = module.state_dict()
    for k in mismatched:
        print(f"| skip loading {path}{k}: shape {tuple(sd[k].shape)} != "
              f"{tuple(own[k].shape)}")
    with torch.no_grad():
        for k in matched:
            own[k].copy_(sd[k].to(own[k].dtype))
    return len(matched)


def load_warm_start(hp: Dict[str, Any], task) -> bool:
    """``fs2_ckpt``: the FS2 of a finished run (a file or the newest
    checkpoint of a directory) merged into ``task.fs2`` non-strictly; a
    missing path warns and trains from scratch; a task without an FS2 (the
    PitchExtractor's) takes nothing. Returns whether any tensor was loaded."""
    fs2_ckpt = hp.get("fs2_ckpt") or ""
    if not fs2_ckpt or getattr(task, "fs2", None) is None:
        return False
    path = find_latest_ckpt(fs2_ckpt)
    if path is None:
        print(f"| warning: fs2_ckpt {fs2_ckpt} not found; training from scratch")
        return False
    if not path.endswith(".ckpt"):
        raise NotImplementedError(f"unsupported fs2_ckpt format: {path}")
    sd = load_torch_state_dict(path)
    # an FS2 run saves the FS2 itself; a diffusion run's FS2 sits under fs2.
    n = merge_state_dict(task.fs2, sub_dict(sd, "fs2") or sd, "fs2.")
    print(f"| warm-started fs2 from {path} ({n} tensors)")
    return n > 0
