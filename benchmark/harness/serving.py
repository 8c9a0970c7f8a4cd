"""The serving cells: the program built from the configuration's file with the
benchmark's seeded weights, warmed on the cell's own shapes, driven by the
cell's traffic for the window, and its outputs held to the plain reference.

Two mixes (``harness/traffic.py``):

* ``batch_calls``: back-to-back calls of ``FusedSynthesizer.synthesize_many``;
  ``audio_s_per_s`` is all the audio of the calls over the time they took.
* ``closed_b1``: one phrase at a time through
  ``DiffSingerE2EInfer.infer_once``; ``request_p95_ms`` over every request.

The benchmark draws the sampler's noise and the NSF source for each device
batch from the run's seed (``noises=`` / ``sources=``), so the reference
can be handed the same draws.
"""

from __future__ import annotations

import gc
import time
import traceback
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..counts import diffnet_stack as stack_counts
from ..counts import model as model_counts
from ..counts import mrf_stage as mrf_counts
from ..reference import frontend
from ..reference.system import System
from . import check, weights
from .trace import TRACE_SECONDS, OpCalls, Tracer, nbytes
from .traffic import Traffic, fused_request, phoneme_input

N_SINES = 9            # the NSF source's harmonics (rand_ini and noise widths)
DISTINCT_CALLS = 4     # the batch mix's calls, each drawn anew; the window cycles them


def _overrides(config: Dict[str, Any]):
    """The configuration's assumed weights: ``scale`` multiplies a leaf,
    ``set`` gives it (a list: the leaf's values; a number: every value)."""
    spec = config.get("weights", {})

    def apply(w: Dict[str, torch.Tensor]) -> None:
        for name, s in spec.get("scale", {}).items():
            w[name].mul_(float(s))
        for name, v in spec.get("set", {}).items():
            w[name].copy_(torch.as_tensor(v, dtype=w[name].dtype).expand_as(w[name]))

    return apply


def reference_system(config: Dict[str, Any], device) -> System:
    return System(config["hparams"], int(config["vocab_size"]), bool(config.get("pe"))).to(device)


def make_weights(config: Dict[str, Any], seed: int, device) -> Dict[str, torch.Tensor]:
    with torch.device("meta"):
        tree = System(config["hparams"], int(config["vocab_size"]), bool(config.get("pe")))
    return weights.make(tree, seed, device, _overrides(config))


def part(w: Dict[str, torch.Tensor], *prefixes: str, strip: bool = False):
    out = {}
    for k, v in w.items():
        for p in prefixes:
            if k.startswith(p):
                out[k[len(p):] if strip else k] = v
    return out


class Program:
    """The system under test, built as a user of the configuration builds it,
    its weights the benchmark's."""

    def __init__(self, config: Dict[str, Any], entry: str, device):
        from diffsinger_tpu_torch.inference.serve import FusedSynthesizer
        from diffsinger_tpu_torch.inference.svs import DiffSingerE2EInfer
        from diffsinger_tpu_torch.inference.vocoder import HifiGAN
        from diffsinger_tpu_torch.models.pe import PEConfig, PitchExtractor
        from diffsinger_tpu_torch.training.tasks import DiffSingerTask

        hp = dict(config["hparams"])
        self.hp = hp
        self.task = DiffSingerTask(hp, vocab_size=int(config["vocab_size"]), device="cpu")
        self.voc = HifiGAN(hp, device="cpu")
        self.pe = PitchExtractor(PEConfig.from_hparams(hp)) if config.get("pe") else None
        if entry == "infer_once":
            self.infer = DiffSingerE2EInfer(hp, self.task, self.voc, pe=self.pe, device=device)
            self.syn = self.infer.fused
        else:
            self.infer = None
            self.syn = FusedSynthesizer(hp, self.task, self.voc, pe=self.pe, device=device)
        self.hop = self.syn.hop
        self.nsf = bool(self.voc.cfg.use_pitch_embed)
        # what the vocoder is handed, kept for the calls a check samples
        self.keep: set = set()
        self.kept: Dict[int, tuple] = {}
        self.applies = 0
        apply = self.voc.apply

        def recorded(mel, f0=None, generator=None, source=None):
            if self.applies in self.keep:
                self.kept[self.applies] = (mel, f0)
            self.applies += 1
            return apply(mel, f0=f0, generator=generator, source=source)

        self.voc.apply = recorded

    def load(self, w: Dict[str, torch.Tensor]) -> None:
        weights.load(self.task, part(w, "fs2.", "denoise_fn."))
        self.voc.load_state_dict(part(w, "voc.", strip=True))
        if self.pe is not None:
            weights.load(self.pe, part(w, "pe.", strip=True))


class Draws:
    """The sampler's and the NSF source's draws of one device batch, from a
    generator on the device seeded from the run's seed and the batch."""

    def __init__(self, hp: Dict[str, Any], nsf: bool, hop: int, device):
        self.n_draws = 1 if hp.get("pndm_speedup") else int(hp["K_step"]) + 1
        self.bins = int(hp.get("keep_bins", hp.get("audio_num_mel_bins", 80)))
        self.nsf, self.hop, self.device = nsf, hop, device

    def __call__(self, seed: int, rows: int, t_b: int):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        noise = torch.randn((self.n_draws, rows, t_b, self.bins), generator=gen,
                            device=self.device)
        if not self.nsf:
            return noise, None
        rand_ini = torch.rand((rows, 1, N_SINES), generator=gen, device=self.device)
        rand_ini[:, :, 0] = 0.0
        src = torch.randn((rows, t_b * self.hop, N_SINES), generator=gen, device=self.device)
        return noise, (rand_ini, src)


def request_flops(hp: Dict[str, Any], spec: Dict[str, Any], with_pe: bool) -> float:
    """The model's operations for one request at its own unpadded length."""
    n, frames = spec["n_phones"], spec["frames"]
    total = (model_counts.sampler_flops(hp, 1, n, frames)
             + model_counts.hifigan_flops(hp, 1, frames))
    if with_pe:
        total += model_counts.pe_flops(hp, 1, frames)
    return total


def _stack_count(args, kwargs, out):
    return stack_counts.counts([tuple(a.shape) for a in args], nbytes(args))


def _mrf_count(args, kwargs, out):
    return mrf_counts.counts([tuple(a.shape) for a in args], [a.element_size() for a in args],
                             kwargs["kernel_sizes"], kwargs["dilation_sets"])


class Cell:
    """One run of one serving cell."""

    def __init__(self, cell: Dict[str, Any], config: Dict[str, Any], mix: Dict[str, Any],
                 limits: Optional[Dict[str, float]], device="cuda", log=print):
        self.cell, self.config, self.mix, self.limits = cell, config, mix, limits
        self.hp = config["hparams"]
        self.kind = mix["kind"]
        self.device = torch.device(device)
        self.log = log
        self.program: Optional[Program] = None
        self.ops: List[OpCalls] = []

    # ------------------------------------------------------------- set-up
    def setup(self, seed: int, trace: bool) -> None:
        entry = "infer_once" if self.kind == "closed_b1" else "synthesize_many"
        self.program = p = Program(self.config, entry, self.device)
        p.load(make_weights(self.config, seed, self.device))
        self.draws = Draws(self.hp, p.nsf, p.hop, self.device)
        self.mel_mult = int(self.hp.get("mel_pad_multiple", 128))
        self.max_b = int(self.hp.get("max_serve_batch", 16))
        self.txt_mult = int(self.hp.get("txt_pad_multiple", 16))
        if trace:
            from diffsinger_tpu_torch.ops import diffnet_stack, hifigan_mrf

            self.ops = [OpCalls(diffnet_stack, "diffnet_stack", _stack_count),
                        OpCalls(hifigan_mrf, "mrf_stage", _mrf_count)]
        self.setup_traffic(seed)
        self.warm()
        self._sync()

    def setup_traffic(self, seed: int) -> None:
        """The run's requests, and what the reference works out from them:
        the batcher's plan, the singing entry's mel buckets."""
        self.seed = seed
        self.traffic = Traffic(self.mix, self.config, seed)
        if self.kind == "batch_calls":
            self.calls = [self.traffic.call(k) for k in range(DISTINCT_CALLS)]
            self.requests = [[fused_request(s) for s in specs] for specs in self.calls]
            self.plans = [frontend.plan([t for _, t in reqs], self.mel_mult, self.max_b)
                          for reqs in self.requests]
        else:
            self.phrases = self.traffic.phrases()
            self.inputs = [phoneme_input(s, frontend.CPOP_PHONES) for s in self.phrases]
            self.t_b = [frontend.round_up(frontend.singing_t_mel(
                self.hp, np.full(s["n_phones"], s["note_s"], np.float32)), self.mel_mult)
                for s in self.phrases]

    def warm(self) -> None:
        """Every shape the window will use, once, on other draws: one call of
        the batch mix (every call has the same lengths); each (text bucket,
        mel bucket) pair of the phrase set."""
        if self.kind == "batch_calls":
            self._batch_call(self.requests[0], self.plans[0], stream=(9, 0))
            return
        seen = set()
        for i, s in enumerate(self.phrases):
            key = (frontend.round_up(s["n_phones"], self.txt_mult), self.t_b[i])
            if key not in seen:
                seen.add(key)
                self._phrase(i, stream=(9, i))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    # ------------------------------------------------------------- calls
    def _batch_call(self, requests, plan, stream):
        draws = [self.draws(self.traffic.draw_seed(*stream, g), rows, t_b)
                 for g, (t_b, _, rows) in enumerate(plan)]
        sources = [d[1] for d in draws] if self.program.nsf else None
        return self.program.syn.synthesize_many(requests, noises=[d[0] for d in draws],
                                                sources=sources)

    def _phrase(self, i: int, stream):
        noise, source = self.draws(self.traffic.draw_seed(*stream), 1, self.t_b[i])
        return self.program.infer.infer_once(self.inputs[i], noise=noise, source=source)

    # ------------------------------------------------------------- window
    def window(self, seconds: float, trace: bool) -> Dict[str, Any]:
        """Drive the traffic for ``seconds``; returns the run's host readings."""
        rng = self.traffic.rng(5)
        tracer = Tracer(self.ops) if trace else None
        if tracer is not None:
            tracer.start()
        out: Dict[str, Any] = {"attempted": 0, "failed": 0, "flops": 0.0}
        p = self.program
        if self.kind == "batch_calls":
            # the check's sample: the first call and one drawn from the seed
            # among the next four, each with its longest batch and one more
            # drawn from the seed
            sampled = {0, int(rng.integers(1, 5))}
            out.update(audio_s=0.0, padded_frames=0, useful_frames=0, samples=[])
        else:
            n = len(self.phrases)
            longest = int(np.argmax([s["n_phones"] for s in self.phrases]))
            sampled = set(int(i) for i in rng.choice(min(n, 64), size=6, replace=False))
            sampled.add(longest)
            out.update(latencies_s=[], samples=[])
        sr = int(self.hp["audio_sample_rate"])
        self._sync()
        t0 = time.perf_counter()
        untraced = (t0, 0.0)   # where the profiler's cost ends: (time, flops so far)
        k = 0
        while True:
            if self.kind == "batch_calls":
                c = k % len(self.requests)
                reqs, plan = self.requests[c], self.plans[c]
                keep = {}
                if k in sampled:
                    longest = max(range(len(plan)), key=lambda g: plan[g][0])
                    others = [g for g in range(len(plan)) if g != longest]
                    keep = {longest}
                    if others:
                        keep.add(int(rng.choice(others)))
                p.keep, p.kept, p.applies = keep, {}, 0
                out["attempted"] += len(reqs)
                try:
                    wavs = self._batch_call(reqs, plan, stream=(3, k))
                except Exception:  # a failed call fails its requests
                    out["failed"] += len(reqs)
                    self.log(f"call {k} failed:\n{traceback.format_exc()}")
                    wavs = None
                if wavs is not None:
                    out["audio_s"] += sum(len(w) for w in wavs) / sr
                    for g, (t_b, idx, rows) in enumerate(plan):
                        out["padded_frames"] += rows * t_b
                        out["useful_frames"] += sum(self.calls[c][i]["frames"] for i in idx)
                    out["flops"] += sum(request_flops(self.hp, s, p.pe is not None)
                                        for s in self.calls[c])
                    for g in sorted(p.kept):
                        mel, f0 = p.kept[g]
                        out["samples"].append({"call": k, "content": c, "batch": g,
                                               "mel": mel, "f0": f0,
                                               "wavs": [wavs[i] for i in plan[g][1]]})
            else:
                i = k % len(self.phrases)
                p.keep, p.kept, p.applies = ({0} if k in sampled else set()), {}, 0
                out["attempted"] += 1
                s0 = time.perf_counter()
                try:
                    wav = self._phrase(i, stream=(4, k))
                except Exception:  # a failed request never comes
                    out["failed"] += 1
                    self.log(f"request {k} failed:\n{traceback.format_exc()}")
                    wav = None
                out["latencies_s"].append(time.perf_counter() - s0)
                if wav is not None:
                    out["flops"] += request_flops(self.hp, self.phrases[i], p.pe is not None)
                    if 0 in p.kept:
                        mel, f0 = p.kept[0]
                        out["samples"].append({"request": k, "phrase": i, "mel": mel,
                                               "f0": f0, "wavs": [wav]})
            k += 1
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
        out["calls"] = k
        if tracer is not None:
            out.update(tracer.readings())
        p.keep, p.kept = set(), {}
        return out

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        for op in self.ops:
            op.restore()
        self.program = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check
    def cases(self, out: Dict[str, Any]) -> List[Dict[str, Any]]:
        """What the reference needs for each sampled device batch, worked out
        from the requests: the padded batch, its bucket, its draws, its rows."""
        cases = []
        for s in out["samples"]:
            if self.kind == "batch_calls":
                reqs = self.requests[s["content"]]
                t_b, idx, rows = self.plans[s["content"]][s["batch"]]
                batch = frontend.pad_batch([reqs[i][0] for i in idx], self.txt_mult, rows)
                seed = self.traffic.draw_seed(3, s["call"], s["batch"])
                real = len(idx)
            else:
                i = s["phrase"]
                batch = frontend.pad_batch([frontend.phoneme_batch(self.inputs[i])],
                                           self.txt_mult, 1)
                t_b, rows, real = self.t_b[i], 1, 1
                seed = self.traffic.draw_seed(4, s["request"])
            cases.append({"batch": batch, "t_b": t_b, "rows": rows, "real": real,
                          "seed": seed, "mel": s["mel"], "f0": s["f0"], "wavs": s["wavs"]})
        return cases

    def weights(self, seed: int) -> Dict[str, torch.Tensor]:
        return make_weights(self.config, seed, self.device)

    def reference(self, seed: int) -> System:
        ref = reference_system(self.config, self.device)
        weights.load(ref, self.weights(seed))
        return ref

    def judge(self, out: Dict[str, Any], ref: System, tf32_control: bool = False):
        """The numbers compared, each the worst over the sampled batches."""
        nsf = bool(ref.voc.cfg.use_pitch_embed)
        draws = Draws(self.hp, nsf, ref.hop, self.device)
        worst: Dict[str, float] = {}
        for case in self.cases(out):
            noise, source = draws(case["seed"], case["rows"], case["t_b"])
            if tf32_control:
                case = check.control_case(ref, case, noise, source)
            got = check.compare(ref, case, noise, source, with_pe=ref.pe is not None)
            for name, v in got.items():
                worst[name] = max(worst.get(name, 0.0), v)
        return worst, len(out["samples"])
