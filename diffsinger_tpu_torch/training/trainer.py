"""Training runtime (counterpart of diffsinger_tpu/training/trainer.py): the
optimizer and ``Trainer.train_step`` on one device.

One step: the task's loss, gradients of the trainable parameters only
(frozen ones have ``requires_grad=False``, as ``partition_params`` keeps them
out of the JAX optimizer), then the optax chain the JAX package builds:
``MultiSteps(chain(clip_by_global_norm, adamw))``. Gradients are averaged
over ``accumulate_grad_batches`` mini-steps, clipped by
``g * min(1, max_norm / norm)`` and applied by ``torch.optim.AdamW`` at the
schedule's rate for the number of updates made so far.

Not ported: checkpoints and warm starts from an existing ``fs2_ckpt``,
validation and ``fit``, a per-epoch ``accumulate_grad_batches`` dict, the
flat-vector optimizer and the ``lax.scan`` multi-step (both worked around TPU
dispatch) and the device mesh.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from diffsinger_tpu_torch.training.schedules import Schedule, build_lr_schedule
from diffsinger_tpu_torch.utils.device import resolve_device

ARRAY_KEYS_EXCLUDE = ("item_name", "text", "nsamples", "id")


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (``optax.global_norm``),
    with one multi-tensor norm over the list."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


class Optimizer:
    """AdamW behind gradient averaging and global-norm clipping."""

    def __init__(self, params: List[torch.nn.Parameter], adamw: torch.optim.AdamW,
                 schedule: Schedule, clip: float, accumulate: int):
        self.params, self.adamw, self.schedule = params, adamw, schedule
        self.clip, self.accumulate = clip, accumulate
        self.num_updates = 0
        self.mini_step = 0

    def step(self, grads: Sequence[torch.Tensor], grad_norm: torch.Tensor) -> None:
        """Add one mini-step's gradients (``grad_norm`` is their global norm);
        every ``accumulate`` of them, clip their mean and update."""
        k = self.accumulate
        for p, g in zip(self.params, grads):
            g = g if k == 1 else g / k
            p.grad = g if p.grad is None else p.grad + g
        self.mini_step += 1
        if self.mini_step < k:
            return
        self.mini_step = 0
        if self.clip > 0:
            grads = [p.grad for p in self.params]
            # with one mini-step the mean is these gradients: reuse their norm
            norm = grad_norm if k == 1 else global_norm(grads)
            torch._foreach_mul_(grads, torch.clamp(self.clip / norm, max=1.0))
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.num_updates)
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self.num_updates += 1


def build_optimizer(hp: Dict[str, Any], params: List[torch.nn.Parameter]) -> Optimizer:
    """Optimizer over the TRAINABLE parameters only."""
    if str(hp.get("optimizer", "adamw")).lower() != "adamw":
        raise NotImplementedError(f"optimizer={hp.get('optimizer')} is not ported yet")
    accum = hp.get("accumulate_grad_batches", 1)
    if isinstance(accum, dict):
        raise NotImplementedError("a per-epoch accumulate_grad_batches schedule is not "
                                  "ported yet")
    schedule = build_lr_schedule(hp)
    adamw = torch.optim.AdamW(
        params, lr=schedule(0),
        betas=(float(hp.get("optimizer_adam_beta1", 0.9)),
               float(hp.get("optimizer_adam_beta2", 0.98))),
        eps=1e-8, weight_decay=float(hp.get("weight_decay", 0.0)))
    return Optimizer(params, adamw, schedule, float(hp.get("clip_grad_norm", 0) or 0),
                     int(accum))


class Trainer:
    """Optimizer steps of a task on one device (the card unless the caller
    names another)."""

    def __init__(self, hp: Dict[str, Any], task, device="cuda"):
        self.device = resolve_device(device)
        if task.device != self.device:
            raise ValueError(f"the task is on {task.device}, the trainer on {self.device}")
        self.hp = dict(hp)
        self.task = task
        self.global_step = 0
        self.params: List[torch.nn.Parameter] = []
        self.optimizer: Optional[Optimizer] = None
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(self.hp.get("seed", 1234)))

    def initialize(self) -> None:
        self.load_warm_start()
        self.params = [p for _, p in self.task.set_trainable()]
        self.optimizer = build_optimizer(self.hp, self.params)
        for top in ("fs2", "denoise_fn"):
            n = sum(p.numel() for p in getattr(self.task, top).parameters())
            print(f"| {top} params: {n / 1e6:.3f}M")

    def load_warm_start(self) -> None:
        """``fs2_ckpt`` warm start: a missing checkpoint trains from scratch
        with a warning, as the JAX package does."""
        fs2_ckpt = self.hp.get("fs2_ckpt") or ""
        if not fs2_ckpt:
            return
        if not (os.path.isfile(fs2_ckpt)
                or glob.glob(os.path.join(fs2_ckpt, "model_ckpt_steps_*.ckpt"))):
            print(f"| warning: fs2_ckpt {fs2_ckpt} not found; training from scratch")
            return
        raise NotImplementedError(f"warm start from {fs2_ckpt}: loading a torch "
                                  "checkpoint is not ported yet")

    def prepare_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Array entries to the device: pinned host memory and a non-blocking
        copy when the device is the card."""
        out = {}
        for k, v in batch.items():
            if k in ARRAY_KEYS_EXCLUDE or not isinstance(v, (np.ndarray, torch.Tensor)):
                continue
            t = torch.as_tensor(v)
            if self.device.type == "cuda" and t.device.type == "cpu":
                t = t.pin_memory()
            out[k] = t.to(self.device, non_blocking=True)
        return out

    def loss_and_grads(self, batch: Dict[str, Any], t: Optional[torch.Tensor] = None,
                       noise: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       deterministic: bool = False
                       ) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
        """The loss terms (plus ``total_loss`` and ``grad_norm``) and the
        gradients of the trainable parameters, which are left unchanged. A
        trainable parameter the loss does not reach gets a zero gradient."""
        total, losses = self.task.train_loss(batch, t=t, noise=noise,
                                             generator=generator or self.generator,
                                             deterministic=deterministic)
        grads = torch.autograd.grad(total, self.params, allow_unused=True)
        # contiguous, as the parameters are: the DiffNet's per-layer weight
        # gradients arrive as strided views of its stacked gradients, and one
        # such view sends the multi-tensor norm, clip and AdamW down their
        # per-tensor paths (~190 launches each instead of a few)
        grads = [torch.zeros_like(p) if g is None else g.contiguous()
                 for p, g in zip(self.params, grads)]
        out = {k: v.detach() for k, v in losses.items()}
        out["total_loss"] = total.detach()
        out["grad_norm"] = global_norm(grads)
        return out, grads

    def train_step(self, batch: Dict[str, Any], t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   deterministic: bool = False) -> Dict[str, torch.Tensor]:
        """One mini-step: loss, gradients and (every ``accumulate_grad_batches``
        mini-steps) an update. Returns the losses as device scalars."""
        if self.optimizer is None:
            raise RuntimeError("call Trainer.initialize() first")
        if not all(isinstance(v, torch.Tensor) and v.device.type == self.device.type
                   for k, v in batch.items() if isinstance(v, (np.ndarray, torch.Tensor))):
            batch = self.prepare_batch(batch)
        losses, grads = self.loss_and_grads(batch, t=t, noise=noise, generator=generator,
                                            deterministic=deterministic)
        self.optimizer.step(grads, losses["grad_norm"])
        self.global_step += 1
        return losses
