"""Tensor parallelism over the ``model`` axis: parameters sharded at rest,
gathered at use, compute not partitioned.

Each parameter that :func:`param_shardings` picks is kept as one
``1/num_model`` slice (along the torch dim that holds its JAX last axis) on
each rank of the model group, and so are its AdamW moments; every other
parameter is replicated. :meth:`TensorParallel.gather` all-gathers the
shards into the module's own parameters before a step's forward, so the
hand-written kernels receive whole weights; :meth:`release` frees them
again. The module's full gradients are summed over the data group by the
trainer and each rank keeps its shard's slice.

What this buys is per-device memory for weights and moments at rest. The
JAX package gets the same placement from GSPMD, which also partitions the
matmuls and picks the activation collectives itself; the fused stack
kernels have no torch counterpart of that choice, so every model rank here
computes the whole step on its data rows, and the numbers equal tp=1's.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn as nn

from diffsinger_tpu_torch.parallel.mesh import Mesh, param_shardings


class TensorParallel:
    """The shards of ``module``'s sharded parameters on this rank."""

    def __init__(self, module: nn.Module, mesh: Mesh, min_size: int = 1 << 16):
        self.mesh = mesh
        self.dims: Dict[str, int] = param_shardings(module, mesh.num_model, min_size)
        named = dict(module.named_parameters())
        self.full: Dict[str, nn.Parameter] = {n: named[n] for n in self.dims}
        self.shards: Dict[str, nn.Parameter] = {}
        self._shapes = {n: p.shape for n, p in self.full.items()}
        self.reshard()

    def _slice(self, name: str, full: torch.Tensor) -> torch.Tensor:
        dim, n = self.dims[name], self.mesh.num_model
        return full.chunk(n, dim)[self.mesh.model_index]

    def reshard(self) -> None:
        """Take this rank's shards from the module's (whole) parameters, then
        release the whole ones. Used at set-up and after a checkpoint loads
        whole parameters into the module."""
        for name, p in self.full.items():
            data = self._slice(name, p.detach()).clone()
            if name in self.shards:
                self.shards[name].data = data
            else:
                self.shards[name] = nn.Parameter(data, requires_grad=p.requires_grad)
        self.release()

    def gather(self) -> None:
        """Whole parameters back into the module from the model group's shards."""
        for name, p in self.full.items():
            p.data = self.mesh.model_gather(self.shards[name].detach(), self.dims[name])

    def release(self) -> None:
        for p in self.full.values():
            p.data = p.data.new_empty((0,))

    @property
    def gathered(self) -> bool:
        return all(p.shape == self._shapes[n] for n, p in self.full.items())

    def optimizer_params(self, named: Sequence) -> List[nn.Parameter]:
        """The (name, parameter) list with each sharded parameter swapped for
        its shard: what the optimizer updates."""
        return [self.shards.get(n, p) for n, p in named]

    def shard_grads(self, names: Sequence[str], grads: Sequence[torch.Tensor]
                    ) -> List[torch.Tensor]:
        """Whole gradients (already summed over the data group) -> the slices
        of the sharded parameters, the rest unchanged."""
        return [self._slice(n, g).contiguous() if n in self.dims else g
                for n, g in zip(names, grads)]

    def global_norm(self, names: Sequence[str], grads: Sequence[torch.Tensor]
                    ) -> torch.Tensor:
        """The global norm of the whole gradients from the optimizer's view:
        the shards' squares summed over the model group, the replicated
        gradients once."""
        sharded = [g for n, g in zip(names, grads) if n in self.dims]
        repl = [g for n, g in zip(names, grads) if n not in self.dims]
        sq = torch.zeros((), device=grads[0].device)
        if sharded:
            sq = sq + self.mesh.model_sum(_sq(sharded))
        if repl:
            sq = sq + _sq(repl)
        return torch.sqrt(sq)

    # ---------------------------------------------------- optimizer state
    def gather_moments(self, names: Sequence[str], state: Dict) -> Dict:
        """An AdamW ``state_dict`` over shards -> the one a tp=1 run holds
        (every model rank takes part; the tensors move to the CPU)."""
        out = {"param_groups": state["param_groups"], "state": {}}
        for i, s in state["state"].items():
            name = names[i]
            out["state"][i] = {
                k: (self.mesh.model_gather(v, self.dims[name]).cpu()
                    if name in self.dims and torch.is_tensor(v) and v.ndim > 0 else v)
                for k, v in s.items()}
        return out

    def shard_moments(self, names: Sequence[str], state: Dict) -> Dict:
        """A whole AdamW ``state_dict`` -> this rank's shards of it."""
        out = {"param_groups": state["param_groups"], "state": {}}
        for i, s in state["state"].items():
            name = names[int(i)]
            out["state"][i] = {
                k: (self._slice(name, v).clone()
                    if name in self.dims and torch.is_tensor(v) and v.ndim > 0 else v)
                for k, v in s.items()}
        return out


def _sq(ts: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.stack(torch._foreach_norm(list(ts))).square().sum()
