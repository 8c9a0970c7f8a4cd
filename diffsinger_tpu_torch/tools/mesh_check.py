"""Rank workers that run the port's parallel paths on a process group on one
host: a few training steps of a task on a data x model mesh, and a batch
served by ``FusedSynthesizer`` over the data axis. ``tests/test_torch_parallel.py``
runs them with gloo on the CPU and ``chip_smoke.py``'s ``parallel`` phase on
the card; both hold the results against one process.

:func:`spawn_ranks` starts ``world`` processes (the ``spawn`` start method),
gives each the parent's TF32 switches (a spawned process starts from
torch's defaults, where cuDNN convolutions round to TF32; a rank on the card
turns both off again when an entry point resolves its device, as the parent
did), joins the default
process group in each at ``tcp://localhost:<free port>``, calls ``fn(rank,
world, spec)`` and returns each rank's result (numpy arrays and Python
values). Everything here is module level, so a spawned process can import
it.
"""

from __future__ import annotations

import datetime
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, Dict, List

import numpy as np
import torch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank: int, world: int, port: int, backend: str, fn: Callable, spec: Dict,
           tf32, results) -> None:
    import torch.distributed as dist

    os.environ.setdefault("LOCAL_RANK", str(rank))
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    try:
        torch.set_num_threads(int(spec.get("threads", 1)))
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=float(
                                    spec.get("collective_timeout", 300))))
        try:
            # reported before the group is torn down: a group whose
            # communicator failed may not tear down (the parent then
            # terminates the process)
            results.put((rank, "ok", fn(rank, world, spec)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        results.put((rank, "error", traceback.format_exc()))


def spawn_ranks(fn: Callable, world: int, spec: Dict, backend: str = "gloo",
                timeout: float = 600.0) -> List[Any]:
    """Run ``fn(rank, world, spec)`` on ``world`` fresh processes joined in
    one process group; returns the results in rank order. A rank that
    raises, or does not finish within ``timeout`` seconds, fails the call
    (the remaining processes are terminated)."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    procs = [ctx.Process(target=_entry,
                         args=(r, world, port, backend, fn, spec, tf32, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got: Dict[int, Any] = {}
    errors = []
    try:
        while len(got) + len(errors) < world:
            try:
                rank, status, out = results.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(got))} did not "
                                   f"finish within {timeout} s") from None
            if status == "ok":
                got.setdefault(rank, out)
            else:
                errors.append(f"rank {rank}:\n{out}")
                break
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    if errors:
        raise RuntimeError("a rank failed:\n" + "\n".join(errors))
    return [got[r] for r in range(world)]


def _numpy(sd: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Copies: a CPU tensor's ``numpy()`` shares its memory, and the
    trainer writes buffers in place."""
    return {k: v.detach().float().cpu().numpy().copy() for k, v in sd.items()}


def _state(sd) -> Dict[str, torch.Tensor]:
    """A state_dict given as numpy arrays or as the path of a saved one."""
    if isinstance(sd, (str, os.PathLike)):
        return torch.load(sd, map_location="cpu")
    return {k: torch.as_tensor(v) for k, v in sd.items()}


def build_task(spec: Dict, device):
    """The spec's task (``hp``, ``vocab``, ``sil_ids``) on ``device`` with
    the spec's ``state_dict`` (numpy arrays or a file) loaded."""
    from diffsinger_tpu_torch.training.tasks import build_task as build

    task = build(spec["hp"], spec.get("vocab", 10), device=device,
                 sil_ids=tuple(spec.get("sil_ids", ())))
    if spec.get("state_dict") is not None:
        task.load_state_dict(_state(spec["state_dict"]), strict=True)
    return task


def _launches() -> Dict[str, int]:
    from diffsinger_tpu_torch.ops import diffnet_stack as ds
    from diffsinger_tpu_torch.ops import diffnet_train as tr
    from diffsinger_tpu_torch.ops import hifigan_mrf as mrf

    return {"diffnet_stack": ds.diffnet_stack.launches,
            "mrf_stage": mrf.mrf_stage.launches,
            "diffnet_train_fwd": tr.diffnet_train_fwd.launches,
            "diffnet_train_bwd": tr.diffnet_train_bwd.launches}


def _since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in _launches().items()}


def train(rank: int, world: int, spec: Dict) -> Dict[str, Any]:
    """``spec["steps"]`` training steps of the spec's task on a mesh of
    ``spec["num_data"]`` x ``spec["num_model"]`` ranks, on the global
    ``spec["batch"]`` with the global draws ``spec["draws"]`` ([(t, noise)]
    per step, or None: the trainer's generator). Returns each step's losses
    and time, the first step's summed gradients, the buffers (BatchNorm
    statistics) after the first step, the final whole parameters and
    buffers, the kernel launches, the tensor-parallel layout and, with
    ``spec["infer_noise"]``, the trained task's ``inference`` mel on
    ``spec["infer_batch"]`` (default the batch); with ``spec["work_dir"]``
    the run's checkpoint is saved there (rank 0); with
    ``spec["sharded_names"]`` the bytes this rank holds at rest for those
    parameters and their AdamW moments. Without a process group it is the
    one-process run of the same steps."""
    import torch.distributed as dist

    from diffsinger_tpu_torch.parallel.mesh import make_mesh
    from diffsinger_tpu_torch.training.trainer import Trainer

    device = torch.device(spec.get("device", "cpu"))
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    task = build_task(spec, device)
    mesh = make_mesh(spec.get("num_data"), spec.get("num_model", 1))
    trainer = Trainer(spec["hp"], task, device=device, mesh=mesh,
                      work_dir=spec.get("work_dir"))
    trainer.initialize()
    draws = spec.get("draws") or [None] * spec["steps"]
    out: Dict[str, Any] = {"losses": [], "mesh": repr(mesh), "rank": rank}
    if trainer.tp is not None:
        out["sharded"] = {n: (d, tuple(trainer.tp.shards[n].shape))
                          for n, d in trainer.tp.dims.items()}
    step_ms = []
    before = _launches()
    for i in range(spec["steps"]):
        t, noise = (None, None) if draws[i] is None else (
            torch.as_tensor(draws[i][0], device=device),
            torch.as_tensor(draws[i][1], device=device))
        if i == 0:
            _, grads = trainer.loss_and_grads(spec["batch"], t=t, noise=noise)
            out["grads"] = {n: g.detach().cpu().numpy()
                            for n, g in zip(trainer.param_names, grads)}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        losses = trainer.train_step(spec["batch"], t=t, noise=noise)
        out["losses"].append({k: float(v) for k, v in losses.items()})
        if i == 0:  # the buffers (BatchNorm statistics) after one update
            params = dict(task.named_parameters())
            out["buffers_1"] = _numpy({k: v for k, v in task.state_dict().items()
                                       if k not in params})
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    out["step_ms"] = step_ms
    out["launches"] = _since(before)  # the kernels the steps (and the first gradient) ran
    if spec.get("sharded_names") is not None:
        # what this rank holds at rest for the named parameters and their
        # moments: shards under tensor parallelism, whole tensors without
        names = set(spec["sharded_names"])
        held = {n: (trainer.tp.shards[n] if trainer.tp and n in trainer.tp.shards else p)
                for n, p in task.named_parameters() if n in names}
        state = trainer.optimizer.adamw.state
        out["resident_bytes"] = sum(
            t.numel() * t.element_size() for p in held.values()
            for t in [p] + [v for v in state.get(p, {}).values()
                            if torch.is_tensor(v) and v.ndim > 0])
    with trainer.gathered():
        out["state_dict"] = _numpy(task.state_dict())
        if spec.get("infer_noise") is not None:
            gen = torch.Generator(device=device).manual_seed(0)
            with torch.no_grad():
                mel = task.inference(spec.get("infer_batch", spec["batch"]),
                                     use_gt_dur=True, use_gt_f0=True,
                                     noise=torch.as_tensor(spec["infer_noise"],
                                                           device=device),
                                     generator=gen)["mel_out"]
            out["mel"] = mel.float().cpu().numpy()
    if spec.get("work_dir"):
        out["ckpt"] = trainer.save_checkpoint()
    if device.type == "cuda":
        out["peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
    if dist.is_initialized():
        dist.barrier()
    return out


def serve(rank: int, world: int, spec: Dict) -> Dict[str, Any]:
    """``FusedSynthesizer.synthesize_many`` of the spec's requests over a
    data mesh of every rank, with the spec's vocoder hparams and weights;
    returns the waveforms and each kernel's launch count on this rank."""
    from diffsinger_tpu_torch.inference.serve import FusedSynthesizer
    from diffsinger_tpu_torch.inference.vocoder import HifiGAN
    from diffsinger_tpu_torch.parallel.mesh import make_mesh

    device = torch.device(spec.get("device", "cpu"))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    task = build_task(spec, device)
    voc = HifiGAN(spec["voc_hp"], device=device)
    voc.load_state_dict(_state(spec["voc_sd"]))
    syn = FusedSynthesizer(spec["hp"], task, voc, use_gt_dur=spec.get("use_gt_dur", False),
                           device=device, mesh=make_mesh())
    requests = spec["requests"]
    if spec.get("warmup"):
        syn.synthesize_many(requests, seed=1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    before = _launches()
    t0 = time.perf_counter()
    wavs = syn.synthesize_many(requests, seed=spec.get("seed", 0))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"wavs": wavs, "ms": (time.perf_counter() - t0) * 1e3, "rank": rank,
            "launches": _since(before)}



def batchnorm(rank: int, world: int, spec: Dict) -> Dict[str, Any]:
    """One training-mode ``BatchNorm1dTBC`` forward and backward on this
    rank's rows of the global ``spec["x"]`` [B, T, C] under a data mesh of
    every rank: the output rows, the input gradient of sum(y * w) and the
    running statistics."""
    from diffsinger_tpu_torch.models.common import BatchNorm1dTBC
    from diffsinger_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    x = torch.as_tensor(spec["x"])
    start, stop = mesh.row_span(x.shape[0])
    x = x[start:stop].clone().requires_grad_(True)
    bn = BatchNorm1dTBC(x.shape[-1])
    with mesh.active():
        y = bn(x, train=True)
    (y * torch.as_tensor(spec["w"])[start:stop]).sum().backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
            "running_mean": bn.running_mean.numpy(), "running_var": bn.running_var.numpy()}


def probe_all_reduce(rank: int, world: int, spec: Dict) -> Dict[str, Any]:
    """One all-reduce of a one-element tensor on ``spec["device"]``: its
    result, or the error the backend raised (NCCL refuses two ranks of one
    communicator on one card)."""
    import torch.distributed as dist

    device = torch.device(spec.get("device", "cpu"))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    x = torch.ones(1, device=device)
    try:
        dist.all_reduce(x)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return {"ok": True, "value": float(x)}
    except Exception as e:  # the refusal is the finding
        return {"ok": False, "error": f"{type(e).__name__}: {str(e)[:400]}"}


JOBS = {"train": train, "serve": serve, "batchnorm": batchnorm}


def jobs(rank: int, world: int, spec: Dict) -> Dict[str, Any]:
    """Several workers in one set of processes: ``spec["jobs"]`` is a list of
    (key, worker name in JOBS, spec); returns {key: result}."""
    return {key: JOBS[name](rank, world, sub) for key, name, sub in spec["jobs"]}
