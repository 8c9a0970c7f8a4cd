"""The training cell: the program's ``Trainer`` built as a user of the
configuration builds it, with the benchmark's seeded weights, stepped by
``Trainer.train_step`` on batches of the configuration's length set.

Set-up drives that one trainer through its first three steps on three
different batches and reads, for the check, each step's loss, the first
gradient as the optimizer got it (AdamW's first moment after one step over
1 - beta1) and each parameter's change after the three; then it steps once
on every other batch shape. The window goes on stepping the same trainer,
the host-to-device copy of each batch inside it. The benchmark draws each
step's diffusion step, noise and dropout generator from the run's seed
(``t=``, ``noise=``, ``generator=``), so the reference takes the same.
"""

from __future__ import annotations

import gc
import statistics
import time
import traceback
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..counts import diffnet_train as train_counts
from ..counts import model as model_counts
from ..reference import cwt
from ..reference.system import precision
from ..reference.train import TrainStep
from . import weights
from .serving import make_weights, part, reference_system
from .trace import TRACE_SECONDS, OpCalls, Tracer, nbytes
from .traffic import Traffic

CHECKED_STEPS = 3


def batch_rows(lengths: np.ndarray, max_tokens: int, max_sentences: int) -> List[List[int]]:
    """Utterances sorted by length, cut into batches of at most
    ``max_sentences`` whose longest times count stays within ``max_tokens``."""
    out, cur, longest = [], [], 0
    for i in np.argsort(lengths, kind="stable"):
        n = max(longest, int(lengths[i]))
        if cur and ((len(cur) + 1) * n > max_tokens or len(cur) == max_sentences):
            out.append(cur)
            cur, n = [], int(lengths[i])
        cur.append(int(i))
        longest = n
    out.append(cur)
    return out


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def make_batch(rng: np.random.Generator, specs: List[Dict[str, Any]], hp: Dict[str, Any],
               frame_mult: int, token_mult: int) -> Dict[str, np.ndarray]:
    """One padded training batch with cwt pitch targets: per utterance
    durations that fill its frames (at least one a phone), a log-mel around
    -2, and a voiced/unvoiced F0 contour (vibrato around 110-250 Hz, 15%
    unvoiced) with its CWT spectrogram and log-F0 statistics."""
    b = len(specs)
    t_txt = min(_round_up(max(s["n_phones"] for s in specs), token_mult),
                int(hp.get("max_input_tokens", 1 << 30)))
    t_mel = min(_round_up(max(s["frames"] for s in specs), frame_mult),
                int(hp.get("max_frames", 1 << 30)))
    bins = int(hp.get("audio_num_mel_bins", 80))
    out = {"txt_tokens": np.zeros((b, t_txt), np.int64),
           "mels": np.zeros((b, t_mel, bins), np.float32),
           "mel2ph": np.zeros((b, t_mel), np.int64),
           "f0": np.zeros((b, t_mel), np.float32),
           "uv": np.zeros((b, t_mel), np.float32),
           "cwt_spec": np.zeros((b, t_mel, 10), np.float32),
           "f0_mean": np.zeros((b,), np.float32), "f0_std": np.zeros((b,), np.float32)}
    for i, s in enumerate(specs):
        n, frames = s["n_phones"], s["frames"]
        out["txt_tokens"][i, :n] = s["tokens"]
        dur = 1 + rng.multinomial(frames - n, np.full(n, 1.0 / n))
        out["mel2ph"][i, :frames] = np.repeat(np.arange(1, n + 1), dur)
        out["mels"][i, :frames] = rng.standard_normal((frames, bins)) * 0.5 - 2.0
        f0 = rng.uniform(110, 250) * 2 ** (0.2 * np.sin(np.arange(frames) / rng.uniform(3, 9)))
        f0[rng.random(frames) < 0.15] = 0.0
        out["f0"][i, :frames] = f0
        out["uv"][i, :frames] = (f0 == 0)
        _, cont = cwt.get_cont_lf0(f0)
        mean, std = float(np.mean(cont)), float(np.std(cont))
        w, _ = cwt.get_lf0_cwt((cont - mean) / std)
        out["cwt_spec"][i, :frames] = w
        out["f0_mean"][i], out["f0_std"][i] = mean, std
    return out


def _fwd_count(args, kwargs, out):
    return train_counts.forward([tuple(a.shape) for a in args], nbytes(args), nbytes(out))


def _bwd_count(args, kwargs, out):
    return train_counts.backward([tuple(a.shape) for a in args], nbytes(args), nbytes(out))


def _leaf_gaps(got: Dict[str, float], want: Dict[str, float], skip: set) -> float:
    """The worst leaf's gap between two norms, over the larger of the
    reference's norm and its median leaf's."""
    med = statistics.median(want.values())
    return max((abs(got[k] - want[k]) / max(want[k], med) for k in want if k not in skip),
               default=0.0)


class TrainCell:
    """One run of a training cell."""

    def __init__(self, cell: Dict[str, Any], config: Dict[str, Any], mix: Dict[str, Any],
                 limits: Optional[Dict[str, float]], device="cuda", log=print):
        self.cell, self.config, self.mix, self.limits = cell, config, mix, limits
        self.hp = config["hparams"]
        self.device = torch.device(device)
        self.log = log
        self.trainer = None
        self.ops: List[OpCalls] = []

    # ------------------------------------------------------------- set-up
    def build(self, seed: int):
        from diffsinger_tpu_torch.training.tasks import DiffSingerTask
        from diffsinger_tpu_torch.training.trainer import Trainer

        hp = dict(self.hp)
        task = DiffSingerTask(hp, vocab_size=int(self.config["vocab_size"]), device=self.device)
        self.w0 = make_weights(self.config, seed, self.device)
        weights.load(task, part(self.w0, "fs2.", "denoise_fn."))
        trainer = Trainer(hp, task, device=self.device)
        trainer.initialize()
        return trainer

    def setup_traffic(self, seed: int) -> None:
        self.seed = seed
        self.traffic = Traffic(self.mix, self.config, seed)
        specs = [self.traffic.spec(self.traffic.rng(8, i), int(n))
                 for i, n in enumerate(self.traffic.n_phones)]
        frames = np.asarray([s["frames"] for s in specs])
        rows = batch_rows(frames, int(self.hp["max_tokens"]), int(self.hp["max_sentences"]))
        rng = self.traffic.rng(10)
        self.specs = [[specs[i] for i in r] for r in rows]
        self.batches = [make_batch(rng, s, self.hp, int(self.mix["frame_multiple"]),
                                   int(self.mix["token_multiple"])) for s in self.specs]
        self.order = [int(i) for i in rng.permutation(len(self.batches))]
        self.flops = [sum(model_counts.train_step_flops(self.hp, 1, s["n_phones"], s["frames"])
                          for s in specs_b) for specs_b in self.specs]

    def draws(self, step: int, batch: Dict[str, np.ndarray]):
        """(t, noise, dropout generator) of a step, from the run's seed."""
        gen = torch.Generator(device=self.device).manual_seed(self.traffic.draw_seed(6, step))
        b, t_mel = batch["mels"].shape[:2]
        t = torch.randint(0, int(self.hp["K_step"]), (b,), generator=gen, device=self.device)
        noise = torch.randn((b, t_mel, batch["mels"].shape[2]), generator=gen, device=self.device)
        drop = torch.Generator(device=self.device).manual_seed(self.traffic.draw_seed(7, step))
        return t, noise, drop

    def _step(self, step: int):
        batch = self.batches[self.order[step % len(self.order)]]
        t, noise, drop = self.draws(step, batch)
        return self.trainer.train_step(batch, t=t, noise=noise, generator=drop)

    def first_steps(self) -> Dict[str, Any]:
        """The three checked steps: losses, the first gradient's and the
        change's norms by leaf."""
        tr = self.trainer
        beta1 = float(self.hp.get("optimizer_adam_beta1", 0.9))
        read = {"loss": [], "norm": []}
        for s in range(CHECKED_STEPS):
            losses = self._step(s)
            read["loss"].append(float(losses["total_loss"]))
            read["norm"].append(float(losses["grad_norm"]))
            if s == 0:
                # a parameter the optimizer has not stepped has no moment
                state = tr.optimizer.adamw.state
                read["grad"] = {n: float(state[p]["exp_avg"].norm()) / (1 - beta1)
                                if "exp_avg" in state.get(p, {}) else 0.0
                                for n, p in zip(tr.param_names, tr.params)}
        read["update"] = {n: float((p.detach() - self.w0[n]).norm())
                          for n, p in zip(tr.param_names, tr.params)}
        return read

    def setup(self, seed: int, trace: bool) -> None:
        self.trainer = self.build(seed)
        self.setup_traffic(seed)
        if trace:
            from diffsinger_tpu_torch.ops import diffnet_train

            self.ops = [OpCalls(diffnet_train, "diffnet_train_fwd", _fwd_count),
                        OpCalls(diffnet_train, "diffnet_train_bwd", _bwd_count)]
        self.checked = self.first_steps()
        del self.w0
        # every other batch shape once, on the same trainer
        self.steps = CHECKED_STEPS
        while self.steps < len(self.order):
            self._step(self.steps)
            self.steps += 1
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    # ------------------------------------------------------------- window
    def window(self, seconds: float, trace: bool) -> Dict[str, Any]:
        tracer = Tracer(self.ops) if trace else None
        if tracer is not None:
            tracer.start()
        out: Dict[str, Any] = {"attempted": 0, "failed": 0, "flops": 0.0, "steps": 0}
        self._sync()
        t0 = time.perf_counter()
        untraced = (t0, 0.0)   # where the profiler's cost ends: (time, flops so far)
        while True:
            b = self.order[self.steps % len(self.order)]
            out["attempted"] += len(self.specs[b])
            try:
                self._step(self.steps)
                out["flops"] += self.flops[b]
            except Exception:  # a failed step fails its rows
                out["failed"] += len(self.specs[b])
                self.log(f"step {self.steps} failed:\n{traceback.format_exc()}")
            self.steps += 1
            out["steps"] += 1
            elapsed = time.perf_counter() - t0
            if tracer is not None and tracer.on and elapsed >= min(TRACE_SECONDS, seconds):
                self._sync()
                tracer.stop()
                untraced = (time.perf_counter(), out["flops"])
            if elapsed >= seconds:
                break
        self._sync()
        t1 = time.perf_counter()
        out["window_s"] = t1 - t0
        out["untraced_s"], out["untraced_flops"] = t1 - untraced[0], out["flops"] - untraced[1]
        out["calls"] = out["steps"]
        if tracer is not None:
            out.update(tracer.readings())
        return out

    def free(self) -> None:
        for op in self.ops:
            op.restore()
        self.trainer = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check
    def reference(self, seed: int):
        ref = reference_system(self.config, self.device)
        weights.load(ref, make_weights(self.config, seed, self.device))
        return ref

    def reference_steps(self, ref, tf32: bool) -> Dict[str, Any]:
        """The reference's three steps from the seed's weights, on the same
        batches and draws: float32, or in TF32 for the control."""
        w0 = {n: p.detach().clone() for n, p in ref.named_parameters()}
        steps = TrainStep(ref)
        beta1 = steps.adamw.defaults["betas"][0]
        read = {"loss": [], "norm": []}
        with precision(tf32):
            for s in range(CHECKED_STEPS):
                batch = self.batches[self.order[s]]
                t, noise, drop = self.draws(s, batch)
                dev = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
                read["loss"].append(steps.step(dev, t, noise, drop))
                read["norm"].append(steps.last_norm)
                if s == 0:
                    read["grad"] = {n: float(steps.adamw.state[p]["exp_avg"].norm()) / (1 - beta1)
                                    for n, p in zip(steps.names, steps.params)}
        read["update"] = {n: float((p.detach() - w0[n]).norm())
                          for n, p in zip(steps.names, steps.params)}
        return read

    def judge(self, out: Dict[str, Any], ref, tf32_control: bool = False):
        """The numbers compared: each checked step's loss, the first
        gradient's and the three steps' change by worst leaf. Leaves whose
        reference gradient is under a thousandth of the median leaf's move
        by round-off alone and are left out."""
        # the float32 reference steps its own copy: read it once a seed
        if getattr(self, "_want", (None,))[0] != self.seed:
            self._want = (self.seed, self.reference_steps(ref, False))
        want = self._want[1]
        if tf32_control:
            got = self.reference_steps(self.reference(self.seed), True)
        else:
            got = self.checked
        if set(got["grad"]) != set(want["grad"]):
            return {"loss_gap": float("inf"), "grad_gap": float("inf"),
                    "update_gap": float("inf")}, 0
        med = statistics.median(want["grad"].values())
        skip = {k for k, v in want["grad"].items() if v < 1e-3 * med}
        self.skipped = sorted(skip)
        side = "control" if tf32_control else "program"
        self.diagnostics = {"loss_" + side: got["loss"], "loss_reference": want["loss"],
                            "grad_norm_" + side: got["norm"], "grad_norm_reference": want["norm"],
                            "leaves_left_out": len(skip), "leaves": len(want["grad"])}
        loss = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"]))
        return {"loss_gap": loss, "grad_gap": _leaf_gaps(got["grad"], want["grad"], skip),
                "update_gap": _leaf_gaps(got["update"], want["update"], skip)}, CHECKED_STEPS
