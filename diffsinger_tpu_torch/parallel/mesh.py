"""Process mesh, batch and parameter placement, and the collectives of data
and tensor parallelism on ``torch.distributed`` (counterpart of
diffsinger_tpu/parallel/mesh.py).

The JAX package lays its devices out as a ``data`` x ``model`` mesh and lets
GSPMD partition one program over it. Here every rank is one process with one
device, and the mesh is the two families of process subgroups:

* ``data``: ranks that share a model index. Each holds its own rows of the
  global batch; the losses divide by the group's summed denominators and the
  gradients are summed over it, so the update is the one-process update on
  the global batch.
* ``model``: ranks that share a data index (and hold the same rows). The
  parameters that :func:`param_shardings` picks live as ``1/num_model``
  shards on them (``parallel/tensor_parallel.py``).

Rank ``r`` sits at ``(r // num_model, r % num_model)``, as the JAX mesh
reshapes its device list. Without a process group the mesh is 1 x 1 and
every collective is the identity.

Loss helpers (:func:`masked_mean`, :func:`global_mean`,
:func:`batch_means`) and random draws (:func:`draw`) read the mesh that
:meth:`Mesh.active` has entered on this thread of control; outside one they
compute exactly what the single-process code computes.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

_ACTIVE: contextvars.ContextVar[Optional["Mesh"]] = contextvars.ContextVar(
    "diffsinger_tpu_torch_mesh", default=None)


class Mesh:
    """The ``data`` x ``model`` layout of the default process group as seen
    from one rank: its indices on both axes and its two subgroups (None
    without a process group)."""

    def __init__(self, num_data: int, num_model: int, rank: int = 0,
                 data_group=None, model_group=None, backend: Optional[str] = None):
        self.num_data, self.num_model, self.rank = num_data, num_model, rank
        self.data_index, self.model_index = divmod(rank, num_model)
        self.data_group, self.model_group = data_group, model_group
        self.backend = backend

    @property
    def distributed(self) -> bool:
        return self.data_group is not None

    def __repr__(self) -> str:
        return (f"Mesh(data={self.num_data}, model={self.num_model}, rank={self.rank}, "
                f"backend={self.backend})")

    @contextlib.contextmanager
    def active(self) -> Iterator["Mesh"]:
        """Make this mesh the one the loss helpers and draws read."""
        token = _ACTIVE.set(self)
        try:
            yield self
        finally:
            _ACTIVE.reset(token)

    # ---------------------------------------------------------- batch rows
    def row_span(self, global_rows: int) -> Tuple[int, int]:
        """[start, stop) of this rank's rows of a global batch padded to a
        multiple of ``num_data``: contiguous blocks, data index d holding
        ``[d * B / n, (d + 1) * B / n)`` (the span of the JAX package's
        ``_local_row_span``, not upstream's ``x[rank::world]``)."""
        return row_span(global_rows, self.num_data, self.data_index)

    # ---------------------------------------------------------- collectives
    def _staged(self, t: torch.Tensor) -> bool:
        # PyTorch's gloo backend takes CUDA tensors for broadcast and
        # all_reduce only: stage every gloo collective of card tensors
        # through the host and do the arithmetic back on the card
        return self.backend == "gloo" and t.is_cuda

    def _gather_list(self, t: torch.Tensor, group) -> List[torch.Tensor]:
        n = dist.get_world_size(group)
        if self._staged(t):
            host = t.detach().cpu().contiguous()
            parts = [torch.empty_like(host) for _ in range(n)]
            dist.all_gather(parts, host, group=group)
            return [p.to(t.device, non_blocking=True) for p in parts]
        src = t.detach().contiguous()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        return parts

    def _reduce(self, t: torch.Tensor, group, op: str) -> torch.Tensor:
        if group is None:
            return t
        if self._staged(t):
            stacked = torch.stack(self._gather_list(t, group))
            # the ranks' values summed in rank order on the card
            return {"sum": lambda s: s.sum(0), "min": lambda s: s.amin(0),
                    "max": lambda s: s.amax(0)}[op](stacked)
        out = t.detach().clone()
        dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
                                 "max": dist.ReduceOp.MAX}[op], group=group)
        return out

    def data_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the data group (a new tensor, no gradient)."""
        return self._reduce(t, self.data_group, "sum")

    def data_min(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, self.data_group, "min")

    def data_count(self, n: int) -> int:
        """Elements of the global batch for a local count ``n``: the ranks of
        a data group hold equal row counts of the padded batch."""
        return n * self.num_data

    def data_sum_grad(self, t: torch.Tensor) -> torch.Tensor:
        """Differentiable sum over the data group: its backward sums the
        incoming gradients over the group, so each rank's local gradient
        carries every rank's use of the sum (batch statistics)."""
        if self.data_group is None:
            return t
        return _GroupSum.apply(t, self)

    def data_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The data group's tensors concatenated along dim 0, in data order."""
        if self.data_group is None:
            return t
        return torch.cat(self._gather_list(t, self.data_group), 0)

    def model_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The model group's shards concatenated along ``dim``, in model order."""
        if self.model_group is None:
            return t
        return torch.cat(self._gather_list(t, self.model_group), dim)

    def model_sum(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, self.model_group, "sum")


class _GroupSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.mesh = mesh
        return mesh.data_sum(t)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ctx.mesh.data_sum(grad), None


def row_span(global_rows: int, num_data: int, data_index: int) -> Tuple[int, int]:
    if global_rows % num_data:
        raise ValueError(f"{global_rows} rows do not split over {num_data} data ranks; "
                         "pad the batch first (pad_batch_for_sharding)")
    per = global_rows // num_data
    return data_index * per, (data_index + 1) * per


def make_mesh(num_data: Optional[int] = None, num_model: int = 1) -> Mesh:
    """The mesh over the default process group (1 x 1 without one). Every
    rank must call it, in the same order as its other group creations: the
    subgroups are made collectively."""
    if not dist.is_initialized():
        world, rank = 1, 0
    else:
        world, rank = dist.get_world_size(), dist.get_rank()
    if num_data is None:
        num_data = world // num_model
    assert num_data * num_model == world, f"mesh {num_data}x{num_model} != {world} ranks"
    if not dist.is_initialized():
        return Mesh(num_data, num_model)
    data_group = model_group = None
    for m in range(num_model):  # every rank creates every group, in one order
        g = dist.new_group([d * num_model + m for d in range(num_data)])
        if rank % num_model == m:
            data_group = g
    for d in range(num_data):
        g = dist.new_group([d * num_model + m for m in range(num_model)])
        if rank // num_model == d:
            model_group = g
    return Mesh(num_data, num_model, rank, data_group, model_group, dist.get_backend())


# ---------------------------------------------------------------- batches
def pad_batch_for_sharding(batch: Dict[str, Any], multiple: int) -> Dict[str, Any]:
    """Right-pad the batch dimension with zero rows to a multiple of the data
    axis (a row of all-pad tokens is fully masked) and record the true row
    count as ``nsamples``; a batch that already divides is returned as is."""
    first = next(v for v in batch.values() if isinstance(v, np.ndarray))
    b = first.shape[0]
    target = -(-b // multiple) * multiple
    if target == b:
        return batch
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == b:
            out[k] = np.pad(v, [(0, target - b)] + [(0, 0)] * (v.ndim - 1))
        else:
            out[k] = v
    out["nsamples"] = b
    return out


def shard_batch(mesh: Mesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's rows of a GLOBAL numpy batch whose leading axis divides by
    ``num_data`` (every rank passes the same batch); entries that are not
    batch-major arrays pass through."""
    arrays = [v for v in batch.values() if isinstance(v, np.ndarray) and v.ndim >= 1]
    if not arrays or mesh.num_data == 1:
        return batch
    b = arrays[0].shape[0]
    start, stop = mesh.row_span(b)
    return {k: v[start:stop] if isinstance(v, np.ndarray) and v.ndim >= 1
            and v.shape[0] == b else v for k, v in batch.items()}


# ---------------------------------------------------------------- parameters
_KERNEL_MODULES = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d)


def flax_last_axis(module: nn.Module, name: str, p: torch.Tensor) -> int:
    """The torch dim that holds the last axis of the parameter's JAX leaf.
    ``convert/from_jax.py`` transposes every Dense and Conv kernel so that the
    JAX last axis lands on torch dim 0 (Linear [out, in], Conv [out, in, k],
    ConvTranspose [C_in, C_out, k] from JAX's [k, C_out, C_in]); attention
    ``in_proj_weight`` is a Dense kernel too. Everything else (embeddings,
    CRF transitions, norms, biases) is copied unchanged."""
    if (isinstance(module, _KERNEL_MODULES) and name == "weight") or name == "in_proj_weight":
        return 0
    return p.ndim - 1


def param_shardings(module: nn.Module, num_model: int,
                    min_size: int = 1 << 16) -> Dict[str, int]:
    """Tensor-parallel placement: {parameter name: torch dim split over the
    model axis} for every parameter of at least 2 dims and ``min_size``
    elements whose JAX last axis divides by ``num_model`` (the JAX package's
    rule, mapped through the layouts of ``convert/from_jax.py``); the
    parameters not named are replicated."""
    out: Dict[str, int] = {}
    if num_model <= 1:
        return out
    for mod_name, mod in module.named_modules():
        for p_name, p in mod.named_parameters(recurse=False):
            dim = flax_last_axis(mod, p_name, p)
            if p.ndim >= 2 and p.numel() >= min_size and p.shape[dim] % num_model == 0:
                out[f"{mod_name}.{p_name}" if mod_name else p_name] = dim
    return out


# ---------------------------------------------------------------- active mesh
def active_mesh() -> Optional[Mesh]:
    """The mesh entered with :meth:`Mesh.active`, when it spans processes."""
    mesh = _ACTIVE.get()
    return mesh if mesh is not None and mesh.distributed else None


def masked_mean(x: torch.Tensor, w: torch.Tensor, clamp: bool = True) -> torch.Tensor:
    """sum(x * w) / sum(w) (the denominator clamped at 1) with the
    denominator summed over the data group (detached): the ranks' terms add
    up to the global batch's masked mean."""
    den = w.sum()
    mesh = active_mesh()
    if mesh is not None:
        den = mesh.data_sum(den.detach())
    return (x * w).sum() / (torch.clamp(den, min=1.0) if clamp else den)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """x.mean() over the global (padded) batch: the ranks' terms add up to it."""
    mesh = active_mesh()
    if mesh is None or mesh.num_data == 1:
        return x.mean()
    return x.sum() / mesh.data_count(x.numel())


def batch_means(xs: Sequence[torch.Tensor], dims: Tuple[int, ...]) -> List[torch.Tensor]:
    """Each tensor's mean over ``dims`` (the batch dims) over the global
    batch, differentiable: one all-reduce of the stacked sums under a data
    group (synchronised batch statistics)."""
    mesh = active_mesh()
    if mesh is None or mesh.num_data == 1:
        return [x.mean(dims) for x in xs]
    n = mesh.data_count(int(np.prod([xs[0].shape[d] for d in dims])))
    sums = mesh.data_sum_grad(torch.stack([x.sum(dims) for x in xs]))
    return list(sums / n)


def draw(fn: Callable[..., torch.Tensor], shape: Sequence[int], *args,
         **kwargs) -> torch.Tensor:
    """``fn(*args, shape, **kwargs)`` (torch.rand, randn or randint) for the
    local rows [B, ...] of a global batch: the draw is made at the global
    shape from the one seeded generator and this rank's rows are kept, so
    every rank advances its generator alike and the draws equal the
    one-process draws on the global batch."""
    mesh = active_mesh()
    if mesh is None or mesh.num_data == 1:
        return fn(*args, tuple(shape), **kwargs)
    b = shape[0]
    full = fn(*args, (b * mesh.num_data,) + tuple(shape[1:]), **kwargs)
    return full[mesh.data_index * b:(mesh.data_index + 1) * b]
