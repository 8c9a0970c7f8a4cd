"""Training runtime (counterpart of diffsinger_tpu/training/trainer.py): the
optimizer, ``Trainer.train_step``, validation, checkpoints and the ``fit``
loop on one device.

One step: the task's loss, gradients of the trainable parameters only
(frozen ones have ``requires_grad=False``, as ``partition_params`` keeps them
out of the JAX optimizer), then the optax chain the JAX package builds:
``MultiSteps(chain(clip_by_global_norm, adamw))``. Gradients are averaged
over ``accumulate_grad_batches`` mini-steps (an int, or a per-epoch dict
through ``grad_accum_schedule``), clipped by ``g * min(1, max_norm / norm)``
and applied by ``torch.optim.AdamW`` at the schedule's rate for the number
of updates made so far. A task's BatchNorm statistics (``_new_state`` of its
loss) are written after every mini-step's gradient. ``switch_midi2f0_step``
picks the F0 the conditioner embeds at each step: ground truth while
``global_step <= switch``, then the predicted one.

Checkpoints use upstream DiffSinger's own layout (the JAX package saves its
runs with Orbax; this is the torch counterpart):
``work_dir/model_ckpt_steps_{step}.ckpt`` holds ``state_dict: {"model":
<the state_dict of the task's checkpoint_module: the diffusion task, the FS2
of an FS2 task or the PitchExtractor with its statistics>}``,
``optimizer_states``, ``global_step`` and here also ``num_updates``, the
trainer generator's state and ``best_val_loss``. The newest
``num_ckpt_keep`` are kept. One loader reads the port's own runs (a full
resume) and released checkpoints (params and step, fresh moments).

``fit`` runs one optimizer step per call. The JAX package's
``train_steps_per_call`` (a ``lax.scan`` over steps), ``cond_precompute``,
``flat_optimizer`` and ``use_pallas_*`` switches work around TPU dispatch and
are not read here: the updates are the same.

Parallelism (``parallel/``): under a process group the trainer runs on a
``data`` x ``model`` mesh (``num_model_shards`` model ranks). Every rank is
handed the same global batch, pads it to a multiple of the data axis and
keeps its rows; the losses are means over the global batch (each rank's
terms add up to them), the gradients are summed over the data group in one
all-reduce of a flat buffer before clipping, and the diffusion step, noise
and dropout masks are drawn at the global batch's shape from the one
seeded generator and sliced, so a step equals the one-process step on the
padded global batch. Rank 0's weights are broadcast at ``initialize``.
With model ranks the parameters ``param_shardings`` picks are held as
shards, with shard-sized AdamW moments, and gathered whole for each step
(``TensorParallel``). Rank 0 alone writes TensorBoard, checkpoints (the
whole parameters and moments, as a one-process run writes them) and the
code snapshot. Unlike the JAX package, which seeds ``fit`` with ``seed +
process_index()``, every rank is seeded alike: the global draws are sliced,
not drawn per rank.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import time
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch
import torch.distributed as dist

from diffsinger_tpu_torch.convert.checkpoint import (ckpt_step, find_latest_ckpt,
                                                     load_torch_state_dict, load_warm_start,
                                                     merge_state_dict, split_keys,
                                                     torch_load)
from diffsinger_tpu_torch.parallel.mesh import (Mesh, make_mesh, pad_batch_for_sharding,
                                                shard_batch)
from diffsinger_tpu_torch.parallel.tensor_parallel import TensorParallel
from diffsinger_tpu_torch.training.schedules import (Schedule, build_lr_schedule,
                                                     grad_accum_schedule)
from diffsinger_tpu_torch.utils import trace
from diffsinger_tpu_torch.utils.device import resolve_device
from diffsinger_tpu_torch.utils.misc import MetricsDict

ARRAY_KEYS_EXCLUDE = ("item_name", "text", "nsamples", "id")


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (``optax.global_norm``),
    with one multi-tensor norm over the list."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


class Optimizer:
    """AdamW behind gradient averaging and global-norm clipping.
    ``accumulate`` is the number of mini-steps an update averages, or a
    function of the updates made so far that gives it."""

    def __init__(self, params: List[torch.nn.Parameter], adamw: torch.optim.AdamW,
                 schedule: Schedule, clip: float,
                 accumulate: Union[int, Callable[[int], int]],
                 norm: Callable[[Sequence[torch.Tensor]], torch.Tensor] = global_norm):
        self.params, self.adamw, self.schedule = params, adamw, schedule
        self.clip, self.accumulate, self.norm = clip, accumulate, norm
        self.num_updates = 0
        self.mini_step = 0

    def step(self, grads: Sequence[torch.Tensor], grad_norm: torch.Tensor) -> None:
        """Add one mini-step's gradients (``grad_norm`` is their global norm);
        every ``accumulate`` of them, clip their mean and update."""
        k = self.accumulate
        if callable(k):
            k = k(self.num_updates)
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
            norm = grad_norm if k == 1 else self.norm(grads)
            torch._foreach_mul_(grads, torch.clamp(self.clip / norm, max=1.0))
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.num_updates)
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self.num_updates += 1


def build_optimizer(hp: Dict[str, Any], params: List[torch.nn.Parameter],
                    batches_per_epoch: Optional[int] = None,
                    norm: Callable[[Sequence[torch.Tensor]], torch.Tensor] = global_norm
                    ) -> Optimizer:
    """Optimizer over the TRAINABLE parameters only (their shards under
    tensor parallelism, with ``norm`` the global norm of the whole
    gradients). A per-epoch ``accumulate_grad_batches`` dict needs
    ``batches_per_epoch``."""
    if str(hp.get("optimizer", "adamw")).lower() != "adamw":
        raise NotImplementedError(f"optimizer={hp.get('optimizer')} is not ported yet")
    accum = hp.get("accumulate_grad_batches", 1)
    if isinstance(accum, dict):
        if batches_per_epoch is None:
            raise ValueError(
                "accumulate_grad_batches as a per-epoch dict needs batches_per_epoch "
                "(Trainer.fit derives it; set trainer.batches_per_epoch when calling "
                "initialize directly)")
        accum = grad_accum_schedule(accum, batches_per_epoch)
    else:
        accum = int(accum)
    schedule = build_lr_schedule(hp)
    adamw = torch.optim.AdamW(
        params, lr=schedule(0),
        betas=(float(hp.get("optimizer_adam_beta1", 0.9)),
               float(hp.get("optimizer_adam_beta2", 0.98))),
        eps=1e-8, weight_decay=float(hp.get("weight_decay", 0.0)))
    return Optimizer(params, adamw, schedule, float(hp.get("clip_grad_norm", 0) or 0), accum,
                     norm)


def _threshold(v) -> Optional[int]:
    """An eval batching limit: None for absent, 0 or negative."""
    return None if not v or v < 0 else int(v)


class Trainer:
    """Optimizer steps, validation and checkpoints of a task on one device
    (the card unless the caller names another), on ``mesh`` (default: the
    default process group's ranks split into data x ``num_model_shards``; a
    1 x 1 mesh without a group). ``work_dir`` (default ``hp["work_dir"]``)
    holds the checkpoints; without one nothing is restored or saved."""

    def __init__(self, hp: Dict[str, Any], task, device="cuda",
                 work_dir: Optional[str] = None, mesh: Optional[Mesh] = None):
        self.device = resolve_device(device)
        if task.device != self.device:
            raise ValueError(f"the task is on {task.device}, the trainer on {self.device}")
        self.hp = dict(hp)
        self.task = task
        self.mesh = mesh if mesh is not None else make_mesh(
            num_model=int(self.hp.get("num_model_shards", 1) or 1))
        self.tp: Optional[TensorParallel] = None
        self.work_dir = work_dir or self.hp.get("work_dir") or None
        self.global_step = 0
        self.params: List[torch.nn.Parameter] = []
        self.param_names: List[str] = []
        self.optimizer: Optional[Optimizer] = None
        self.batches_per_epoch: Optional[int] = None  # for a per-epoch accumulation dict
        # (global_step, use_gt_f0) where the F0 the conditioner embeds began:
        # one entry, or two once switch_midi2f0_step is crossed
        self.gt_f0_log: List[Tuple[int, bool]] = []
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(self.hp.get("seed", 1234)))
        self.best_val_loss = float("inf")
        self.plotter: Optional[Callable] = None  # plotter(trainer, batch, batch_idx)
        self._writer = None
        self._writer_tried = False
        # (step, "train" or "val", scalars) of every log line and validation of fit
        self.history: List[Tuple[int, str, Dict[str, float]]] = []

    @property
    def is_main(self) -> bool:
        """Rank 0 (or no process group): the rank that writes files and logs."""
        return self.mesh.rank == 0

    def initialize(self) -> None:
        """Warm start, rank 0's weights on every rank, the model axis's
        shards, the optimizer over the trainable parameters (or their
        shards), then the newest checkpoint in ``work_dir``."""
        self.load_warm_start()
        if self.mesh.distributed:  # every rank starts from rank 0's weights, as DDP
            for t in self.task.state_dict().values():
                dist.broadcast(t, src=0)
        if self.is_main:
            for top, module in self.task.named_children():
                n = sum(p.numel() for p in module.parameters())
                print(f"| {top} params: {n / 1e6:.3f}M")
        named = self.task.set_trainable()
        self.param_names = [n for n, _ in named]
        self.params = [p for _, p in named]
        opt_params, norm = self.params, global_norm
        if self.mesh.num_model > 1:
            self.tp = TensorParallel(self.task, self.mesh, int(self.hp.get(
                "tp_min_param_size", 1 << 16)))
            opt_params = self.tp.optimizer_params(named)
            names = self.param_names
            norm = lambda grads: self.tp.global_norm(names, grads)  # noqa: E731
        self.optimizer = build_optimizer(self.hp, opt_params, self.batches_per_epoch, norm)
        self.restore()

    @contextlib.contextmanager
    def gathered(self) -> Iterator[None]:
        """The task's whole parameters inside the block: under tensor
        parallelism the sharded ones are gathered from the model group on
        entry and released on exit (every model rank must enter)."""
        if self.tp is None or self.tp.gathered:
            yield
            return
        self.tp.gather()
        try:
            yield
        finally:
            self.tp.release()

    def load_warm_start(self) -> None:
        """``fs2_ckpt`` into the task's FS2 (``convert/checkpoint.py``); a
        missing checkpoint trains from scratch with a warning."""
        load_warm_start(self.hp, self.task)

    def prepare_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """This rank's rows of a global batch (padded with zero rows to a
        multiple of the data axis) to the device: pinned host memory and a
        non-blocking copy when the device is the card."""
        if self.mesh.num_data > 1:
            arrays = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
                      for k, v in batch.items() if isinstance(v, (np.ndarray, torch.Tensor))}
            batch = shard_batch(self.mesh, pad_batch_for_sharding(arrays, self.mesh.num_data))
        out = {}
        with trace.span("ds.train.h2d"):
            for k, v in batch.items():
                if k in ARRAY_KEYS_EXCLUDE or not isinstance(v, (np.ndarray, torch.Tensor)):
                    continue
                t = torch.as_tensor(v)
                if self.device.type == "cuda" and t.device.type == "cpu":
                    t = t.pin_memory()
                out[k] = t.to(self.device, non_blocking=True)
        return out

    def prefetch(self, batches: Iterable[Dict[str, Any]], size: int = 2
                 ) -> Iterator[Dict[str, torch.Tensor]]:
        """``size`` batches of device lookahead: batch k+1's copy overlaps step k."""
        queue: List[Dict[str, torch.Tensor]] = []
        for b in batches:
            queue.append(self.prepare_batch(b))
            if len(queue) >= size:
                yield queue.pop(0)
        yield from queue

    def _on_device(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        if all(isinstance(v, torch.Tensor) and v.device.type == self.device.type
               for v in batch.values() if isinstance(v, (np.ndarray, torch.Tensor))):
            return batch
        return self.prepare_batch(batch)

    def _task_loss(self, batch: Dict[str, Any], t=None, noise=None, generator=None,
                   deterministic: bool = False, use_gt_f0: bool = True):
        """The task's ``train_loss`` (every task takes the same arguments and
        ignores those it has no use for) and the state it returns."""
        total, losses = self.task.train_loss(batch, t=t, noise=noise, generator=generator,
                                             deterministic=deterministic, use_gt_f0=use_gt_f0)
        new_state = losses.pop("_new_state", None)
        return total, losses, new_state

    def loss_and_grads(self, batch: Dict[str, Any], t: Optional[torch.Tensor] = None,
                       noise: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       deterministic: bool = False, use_gt_f0: bool = True
                       ) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
        """The loss terms (plus ``total_loss`` and ``grad_norm``) and the
        whole gradients of the trainable parameters, which are left
        unchanged (and so are the task's statistics). A trainable parameter
        the loss does not reach gets a zero gradient. On a data mesh the
        batch is the global one (as ``train_step`` takes it), ``t`` and
        ``noise`` are given for the padded global batch, and the losses and
        gradients are the global batch's."""
        with self.gathered():
            return self._loss_and_grads(self._on_device(batch), t, noise, generator,
                                        deterministic, use_gt_f0)[:2]

    def _local_rows(self, x: Optional[torch.Tensor], rows: int) -> Optional[torch.Tensor]:
        """This rank's rows of a draw given for the padded global batch."""
        if x is None or self.mesh.num_data == 1:
            return x
        if x.shape[0] != rows * self.mesh.num_data:
            raise ValueError(f"t and noise are given for the padded global batch of "
                             f"{rows * self.mesh.num_data} rows, got {x.shape[0]}")
        start, stop = self.mesh.row_span(x.shape[0])
        return x[start:stop]

    def _loss_and_grads(self, batch, t, noise, generator, deterministic, use_gt_f0):
        rows = len(next(v for v in batch.values() if isinstance(v, torch.Tensor)))
        with self.mesh.active(), trace.span("ds.train.forward"):
            total, losses, new_state = self._task_loss(
                batch, t=self._local_rows(t, rows), noise=self._local_rows(noise, rows),
                generator=generator or self.generator, deterministic=deterministic,
                use_gt_f0=use_gt_f0)
        with trace.span("ds.train.backward"):
            grads = torch.autograd.grad(total, self.params, allow_unused=True)
            # contiguous, as the parameters are: the DiffNet's per-layer weight
            # gradients arrive as strided views of its stacked gradients, and one
            # such view sends the multi-tensor norm, clip and AdamW down their
            # per-tensor paths (~190 launches each instead of a few)
            grads = [torch.zeros_like(p) if g is None else g.contiguous()
                     for p, g in zip(self.params, grads)]
            out = {k: v.detach() for k, v in losses.items()}
            out["total_loss"] = total.detach()
            if self.mesh.distributed:
                grads, out = self._sum_over_data(grads, out)
            out["grad_norm"] = global_norm(grads)
        return out, grads, new_state

    def _sum_over_data(self, grads: List[torch.Tensor], losses: Dict[str, torch.Tensor]):
        """The gradients and the loss terms summed over the data group, in one
        all-reduce of a flat buffer."""
        names = list(losses)
        flat = torch.cat([g.reshape(-1) for g in grads]
                         + [torch.stack([losses[k].float() for k in names])])
        flat = self.mesh.data_sum(flat)
        out, at = [], 0
        for g in grads:
            out.append(flat[at:at + g.numel()].view_as(g))
            at += g.numel()
        return out, dict(zip(names, flat[at:]))

    def use_gt_f0(self) -> bool:
        """Ground-truth F0 for the next step: no ``switch_midi2f0_step``, or
        ``global_step <= switch``."""
        switch = self.hp.get("switch_midi2f0_step")
        return switch is None or self.global_step <= int(switch)

    def train_step(self, batch: Dict[str, Any], t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   deterministic: bool = False) -> Dict[str, torch.Tensor]:
        """One mini-step: loss, gradients, the task's new statistics and
        (every ``accumulate_grad_batches`` mini-steps) an update. Returns the
        losses as device scalars (on a data mesh the global batch's: the
        ranks' terms summed). ``batch`` is the global batch, ``t`` and
        ``noise`` (optional) are given for the padded global batch."""
        if self.optimizer is None:
            raise RuntimeError("call Trainer.initialize() first")
        with trace.span("ds.train.step", id=self.global_step):
            gt_f0 = self.use_gt_f0()
            if not self.gt_f0_log or self.gt_f0_log[-1][1] != gt_f0:
                self.gt_f0_log.append((self.global_step, gt_f0))
            with self.gathered():
                losses, grads, new_state = self._loss_and_grads(
                    self._on_device(batch), t, noise, generator, deterministic, gt_f0)
            with trace.span("ds.train.optimizer"):
                if self.tp is not None:
                    grads = self.tp.shard_grads(self.param_names, grads)
                self.optimizer.step(grads, losses["grad_norm"])
                if new_state is not None:
                    self.task.update_state(new_state)
            self.global_step += 1
            return losses

    # ------------------------------------------------------------ validation
    @torch.no_grad()
    def validate(self, batches: Iterable[Dict[str, Any]], max_batches: Optional[int] = None,
                 plotter: Optional[Callable] = None,
                 draws: Optional[Callable[[int, Dict[str, Any]], Tuple[torch.Tensor,
                                                                        torch.Tensor]]] = None
                 ) -> Dict[str, float]:
        """Loss terms averaged over the batches, each weighted by its
        ``nsamples``, with dropout off (a task that ignores ``deterministic``,
        as the PitchExtractor's does, draws its dropout from the same
        generator; the statistics it returns are dropped), ground-truth F0.
        The diffusion step and noise of every
        batch come from a generator seeded 0 (the JAX package's
        ``PRNGKey(0)`` for each batch), or from ``draws(batch_idx, batch)`` ->
        (t, noise). ``plotter(trainer, batch, batch_idx)`` runs for the first
        ``num_valid_plots`` batches (rank 0's writer only: the plotter runs
        on the global batch with no mesh active). On a data mesh the losses
        are the global batch's, as in ``train_step``, and ``draws`` gives
        them for the padded global batch."""
        num_plots = int(self.hp.get("num_valid_plots", 0)) if plotter else 0
        metrics = MetricsDict()
        gen = torch.Generator(device=self.device)
        with self.gathered():
            for i, batch in enumerate(batches):
                if max_batches is not None and i >= max_batches:
                    break
                arrays = self.prepare_batch(batch)
                n = int(batch.get("nsamples", len(next(
                    v for v in batch.values() if isinstance(v, (np.ndarray, torch.Tensor))))))
                rows = len(next(iter(arrays.values())))
                t = noise = None
                if draws is not None:
                    t, noise = draws(i, batch)
                gen.manual_seed(0)
                with self.mesh.active():
                    total, losses, _ = self._task_loss(
                        arrays, t=self._local_rows(t, rows),
                        noise=self._local_rows(noise, rows), generator=gen,
                        deterministic=True)
                losses["total_loss"] = total
                names = list(losses)
                values = torch.stack([losses[k].detach().float() for k in names])
                if self.mesh.distributed:
                    values = self.mesh.data_sum(values)
                metrics.update(dict(zip(names, values.tolist())), n)
                if i < num_plots:
                    try:
                        plotter(self, batch, i)
                    except Exception as e:  # plotting must never fail validation
                        print(f"| validation plot {i} failed: {e}")
        return metrics.averages()

    # ------------------------------------------------------------ checkpoints
    def ckpt_path(self, step: int) -> str:
        return os.path.join(self.work_dir, f"model_ckpt_steps_{step}.ckpt")

    def save_checkpoint(self, val_loss: Optional[float] = None) -> Optional[str]:
        """Write ``model_ckpt_steps_{global_step}.ckpt`` (atomically: a
        temporary file renamed), drop all but the newest ``num_ckpt_keep``
        and, for a new best ``val_loss``, write ``best_valid.npy``. Every
        rank calls it; under tensor parallelism the whole parameters and
        moments are gathered first, and rank 0 alone writes (the layout a
        one-process run writes). Returns the path (None on other ranks)."""
        if not self.work_dir:
            raise ValueError("the trainer has no work_dir to save checkpoints in")
        new_best = val_loss is not None and val_loss < self.best_val_loss
        if new_best:
            self.best_val_loss = val_loss
        opt = self.optimizer
        model = self.task.checkpoint_module()
        with self.gathered():
            weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        opt_state = [] if opt is None else [opt.adamw.state_dict()]
        if opt is not None and self.tp is not None:
            opt_state = [self.tp.gather_moments(self.param_names, opt_state[0])]
        if not self.is_main:
            return None
        os.makedirs(self.work_dir, exist_ok=True)
        if new_best:
            np.save(os.path.join(self.work_dir, "best_valid.npy"), np.asarray([val_loss]))
        ckpt = {"state_dict": {"model": weights},
                "optimizer_states": opt_state,
                "num_updates": opt.num_updates if opt is not None else 0,
                "global_step": self.global_step,
                "generator_state": self.generator.get_state(),
                "best_val_loss": self.best_val_loss}
        path = self.ckpt_path(self.global_step)
        torch.save(ckpt, path + ".tmp")
        os.replace(path + ".tmp", path)
        keep = int(self.hp.get("num_ckpt_keep", 3))
        old = sorted((p for p in os.listdir(self.work_dir)
                      if p.startswith("model_ckpt_steps_") and p.endswith(".ckpt")),
                     key=ckpt_step, reverse=True)[keep:]
        for p in old:
            os.remove(os.path.join(self.work_dir, p))
        return path

    def restore(self) -> bool:
        """Load the newest ``model_ckpt_steps_*.ckpt`` of ``work_dir``: params
        and step, plus the AdamW moments and the generator when the file
        has them (a full resume), else fresh moments. A checkpoint that gives
        this task no parameter is refused and ``global_step`` stays; one
        whose keys or shapes differ from the task's raises. Any mesh reads
        any run's checkpoint: the model axis re-shards the whole parameters
        and moments."""
        path = find_latest_ckpt(self.work_dir) if self.work_dir and os.path.isdir(
            self.work_dir) else None
        if path is None:
            return False
        raw = torch_load(path)
        sd = load_torch_state_dict(raw)
        model = self.task.checkpoint_module()
        if self.tp is not None:
            self.tp.gather()
        try:
            matched, mismatched, missing, unexpected = split_keys(model, sd)
            if not matched:
                print(f"| torch checkpoint {path} contributed no parameters for this task; "
                      "ignoring")
                return False
            if mismatched or missing or unexpected:
                raise RuntimeError(
                    f"checkpoint {path} does not match the model: missing={missing[:5]} "
                    f"unexpected={unexpected[:5]} shape mismatch={mismatched[:5]}")
            merge_state_dict(model, sd)
        finally:
            if self.tp is not None:  # this rank's shards of what is loaded
                self.tp.reshard()
        step = raw.get("global_step")
        self.global_step = int(ckpt_step(path) if step is None else step)
        resumed = False
        if self.optimizer is not None and raw.get("optimizer_states"):
            try:
                state = raw["optimizer_states"][0]
                if self.tp is not None:
                    state = self.tp.shard_moments(self.param_names, state)
                self.optimizer.adamw.load_state_dict(state)
                self.optimizer.num_updates = int(raw.get("num_updates", self.global_step))
                resumed = True
            except (ValueError, KeyError) as e:
                print(f"| WARNING: the optimizer state in {path} does not fit this "
                      f"optimizer ({e}); moments re-initialized")
        if raw.get("generator_state") is not None:
            self.generator.set_state(raw["generator_state"])
        best = raw.get("best_val_loss")
        best_fn = os.path.join(self.work_dir, "best_valid.npy")
        if best is None and os.path.exists(best_fn):
            best = float(np.load(best_fn)[0])
        if best is not None:
            self.best_val_loss = float(best)
        if resumed:
            print(f"| restored checkpoint at step {self.global_step} from {path}")
        else:
            print(f"| loaded torch checkpoint {path} (step {self.global_step}); "
                  "optimizer moments re-initialized")
        return True

    # ------------------------------------------------------------ logging
    @property
    def writer(self):
        """A TensorBoard writer under ``work_dir/tb_logs`` on rank 0, or None
        on other ranks, when ``torch.utils.tensorboard`` does not import
        (scalars are then only printed) or there is no work_dir."""
        if not self._writer_tried and self.work_dir and self.is_main:
            self._writer_tried = True
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._writer = SummaryWriter(os.path.join(self.work_dir, "tb_logs"))
            except Exception as e:
                print(f"| no TensorBoard writer ({type(e).__name__}); scalars are printed")
        return self._writer

    def log_scalars(self, scalars: Dict[str, float], prefix: str = "train") -> None:
        w = self.writer
        if w is None:
            return
        for k, v in scalars.items():
            w.add_scalar(f"{prefix}/{k}", float(v), self.global_step)

    def snapshot_code(self) -> None:
        """Copy the package into ``work_dir/codes/<timestamp>/`` once (rank 0)."""
        if (not self.work_dir or not self.is_main
                or os.path.exists(os.path.join(self.work_dir, "codes"))):
            return
        src = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        dst = os.path.join(self.work_dir, "codes", time.strftime("%Y%m%d%H%M%S"),
                           os.path.basename(src))
        shutil.copytree(src, dst, ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))

    # ------------------------------------------------------------ loop
    def fit(self, train_dataset, valid_dataset=None) -> None:
        """Epochs to ``max_updates``: sanity validation at step 0, a log line
        every ``log_interval`` steps, validation and a checkpoint at every
        ``val_check_interval`` crossing, a final checkpoint. Epoch ``e``
        shuffles its batches with seed ``e``."""
        hp = self.hp
        max_updates = int(hp.get("max_updates", 160000))
        val_interval = int(hp.get("val_check_interval", 2000))
        log_interval = int(hp.get("log_interval", 100))
        sanity_steps = int(hp.get("num_sanity_val_steps", 5))
        if self.batches_per_epoch is None:
            self.batches_per_epoch = len(train_dataset.batches())
        if self.optimizer is None:
            self.initialize()
        self.snapshot_code()
        ev_tokens = _threshold(hp.get("max_eval_tokens", -1))
        ev_sents = _threshold(hp.get("max_eval_sentences", -1))

        def valid_batches():
            return valid_dataset.iter_batches(max_tokens=ev_tokens, max_sentences=ev_sents)

        if valid_dataset is not None and sanity_steps > 0 and self.global_step == 0:
            self.validate(valid_batches(), max_batches=sanity_steps)

        prof = None
        if hp.get("profile_dir"):  # a torch.profiler trace of the first 10 steps
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
            prof = profile(activities=acts)
            prof.start()
        schedule = build_lr_schedule(hp)
        t0, last_log_step = time.time(), self.global_step

        def crossed(prev: int, every: int) -> bool:
            return self.global_step // every > prev // every

        epoch = 0
        while self.global_step < max_updates:
            n_batches = 0
            for batch in self.prefetch(train_dataset.iter_batches(shuffle_batches=True,
                                                                  seed=epoch)):
                n_batches += 1
                prev = self.global_step
                losses = self.train_step(batch)
                if crossed(prev, log_interval):
                    scalars = {k: float(v) for k, v in losses.items()}
                    scalars["lr"] = float(schedule(self.global_step))
                    scalars["steps_per_sec"] = (self.global_step - last_log_step) / max(
                        time.time() - t0, 1e-9)
                    t0, last_log_step = time.time(), self.global_step
                    self.log_scalars(scalars)
                    self.history.append((self.global_step, "train", scalars))
                    if self.is_main:
                        print(f"| step {self.global_step} " + " ".join(
                            f"{k}={v:.4f}" for k, v in scalars.items()), flush=True)
                if crossed(prev, val_interval) and self.global_step > 0:
                    val = None
                    if valid_dataset is not None:
                        val = self.validate(valid_batches(), plotter=self.plotter)
                        self.log_scalars(val, prefix="val")
                        self.history.append((self.global_step, "val", val))
                        if self.is_main:
                            print(f"| validation at step {self.global_step} " + " ".join(
                                f"{k}={v:.4f}" for k, v in val.items()), flush=True)
                    self.save_checkpoint(None if val is None else val.get("total_loss"))
                if prof is not None and self.global_step >= 10:
                    prof.stop()
                    prof.export_chrome_trace(self._trace_path())
                    prof = None
                if self.global_step >= max_updates:
                    break
            if n_batches == 0:
                raise ValueError("empty training set")
            epoch += 1
        if prof is not None:
            prof.stop()
            prof.export_chrome_trace(self._trace_path())
        self.save_checkpoint()

    def _trace_path(self) -> str:
        d = self.hp["profile_dir"]
        os.makedirs(d, exist_ok=True)
        rank = f"_rank{self.mesh.rank}" if self.mesh.distributed else ""
        return os.path.join(d, f"trace_step{self.global_step}{rank}.json")
