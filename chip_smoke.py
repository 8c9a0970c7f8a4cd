#!/usr/bin/env python3
"""The port's correctness check on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

It checks; it does not measure the system: the benchmark (benchmark/run.py)
owns every end-to-end time, rate, device-idle share and MFU. Each phase
raises AssertionError, and the run exits non-zero, when a check fails. The
kernels are held against their plain twins (ops/*: ``*_plain``), which run
with TF32 off in cuBLAS and cuDNN (the port's entry points turn it off too);
the paths are held against those twins, the CPU or a host recomputation.
Phases, labelled as in the code below:
  1. the card's name and power limit; the CUDA kernels of
     diffsinger_tpu_torch/csrc/ built with nvcc (sm_90a) into build/kernels/,
     ptxas register and spill lines printed;
  2. stack: diffnet_stack at the serving, singing and batcher shapes (8 x
     1024 at cycles 1 and 4, 4 x 512, 1 x 256, 3 x 301, 2 x 5 below the
     largest dilation, 2 x 4096, 1 x 7936), each in bf16 and float32, float32
     at C = 128 and at d = 32 (the SIMT body), and the float32 column-split
     shapes (1 x 1152, 1 x 2432, 4 x 384, 16 x 640): within 1e-4 (float32) /
     1e-2 (bf16) of the output's scale; two calls bit-equal; x0 unwritten;
     the body that ran, its device launches (one a layer on the tensor cores,
     two on SIMT), the library's tensor_core_info (shared memory <= 227 KB)
     and the column split equal to the wrapper's rules on the card's
     resident counts. Each row also carries the kernel-alone ms, the plain
     twin's ms and the 3xTF32 / bf16 bound (and the FMA bound for float32);
  3. mrf: mrf_stage at C = 128 / 64 / 32 (and 16 in float32) on 8 x 1024 mel
     frames, B = 1, a T off the tile and a T under one halo, in float32 and
     bf16 (and bf16 at C = 16): within 1e-4 / 1e-2 of the output's scale,
     two calls bit-equal; rows carry ms, plain ms and bounds as in phase 2;
  4. serving: FusedSynthesizer over DiffSpeech-LJSpeech at full width
     (configs/lj/ds_beta6.yaml with bench.py's overrides, bf16 stack,
     HiFiGAN v1), seeded weights: 12 requests in three mel buckets and one
     __call__; stack and MRF launches equal K_step and 3 a batch; waveform
     shapes and finiteness; the 8 x 1024 batch against the plain twins on
     the same noise within 1e-4 of the waveform's scale;
  5a. serve_cwt: the same with the config's own cwt pitch: 71 / 3 launches,
     the batch against the plain twins by phase 4's rule;
  5b. singing: DiffSinger-Opencpop (configs/opencpop/ds1000.yaml at full
     width, bf16 stack, PLMS-25 = 26 denoiser calls, PE, NSF-HiFiGAN 8/8/2):
     an 8 x 1024 and a 2 x 4096 batch, the SVS example and a word-level
     input; 26 stack and 2 MRF launches a batch; the 8 x 1024 batch's
     sampler mel (1e-2 of its scale) and its vocoder on the same mel, F0 and
     source draws (1e-4 of the waveform's scale) against the plain twins;
  5c. serve_shipped: ds_beta6.yaml and ds1000.yaml with their own float32
     stack: each batch ran the tensor-core body (20 device launches a call),
     71 / 3 and 26 / 2 launches a batch, each batch against the plain twins
     by phases 5a and 5b's rules;
  5d. shipped_matrix: configs/lj/ds_pndm.yaml (PNDM, 101 stack calls) and
     configs/opencpop/ds100_adj_rel.yaml (DDPM K 100, PE, NSF) as shipped,
     built with TF32 switched on: the entry points leave it off through the
     phase; each config is what its YAML says; exactly 101 / 100 stack and 3
     / 2 MRF launches; each batch against the plain twins by phase 5c's rules;
  5e. wide: the openvpi release's widths (benchmark/configs/ds512_44k_cpop.json):
     the float32 stack at C = 512, cycle 4, at 1 x 432, 8 x 640 and 16 x 1152,
     and cycle 5 (d = 16) at 1 x 432, at each split the card holds: the
     library reports the wgmma body, 20 launches and the split, two calls
     bit-equal, x0 unwritten, 1e-4 of the output's scale (rows carry ms); the
     float32 MRF at C = 16 by phase 3; the configuration served once: 101
     stack launches, every one on the wgmma body, 4 MRF, the batch against
     the plain twins by phase 5b's rules;
  6. train_stack: diffnet_train forward and backward at 24 x 1024 (bf16 and
     float32, cycles 1 and 4), 3 x 301 with H = 200 (SIMT) and H = 256, 1 x
     1024, 2 x 5, 2 x 100 at d = 16, and float32 24 x 1500 cycle 4: skips,
     xs and all nine cotangents within 1e-4 / 1e-2 of each tensor's scale;
     two calls bit-equal; the backward writes none of its inputs; the
     kernels a call ran, counted inside the library, and its tensor_core_info
     (body, shared memory) against the dispatch rule. Rows carry forward and
     backward ms, plain ms and bounds;
  7. train: Trainer on DiffSpeech-LJSpeech at full width (bf16 stack,
     dropout on): one step's kernels against their plain twins
     (``step_vs_plain``, judged by ``step_agrees``), the loss terms, then two
     optimizer steps: one forward and one backward launch a step on the
     tensor cores, finite losses;
  7a. train_cwt: the same with the config's cwt pitch and its loss terms;
  7b. train_shipped: ds_beta6.yaml as shipped (float32 stack on the 3xTF32
     training kernels): the first step by the float32 criterion
     (``step_agrees_f32``), two steps, 20 forward and <= 100 backward device
     launches, the library's 3xtf32 body;
  7d. train_fs2: configs/lj/fs2.yaml at 24 x 1024 and
     configs/opencpop/aux_rel.yaml at 24 x 1500: one step on the card
     against the CPU in float64 on 4 rows (losses 1e-4 relative, each
     gradient within 1e-3 of its scale beyond the CPU float32 step's own
     distance), JAX's loss names, two finite steps; aux_rel is saved;
  7e. train_midi: ds1000.yaml as shipped at 24 x 1500: the first step by the
     float32 criterion, two steps, 20 / 80 device launches and the 3xtf32
     body; then ds60_rel.yaml warm-started from aux_rel (every FS2 tensor,
     FS2 frozen) with switch_midi2f0_step 2: four steps, the trainer's F0
     record [(0, True), (3, False)];
  7f. train_pe: configs/opencpop/pe.yaml at 16 x 2000 with padded tails: the
     first step's BatchNorm running statistics within 1e-7 of a float64 host
     recomputation of flax's rule, a limit the unbiased-variance control must
     exceed; two finite steps;
  7c. cli (after 7f): an LJ-style corpus under build/chip_smoke/cli/, the
     binarizer in a child process (split sizes, cwt_spec, F0 range), seeded
     FS2 and HiFiGAN
     checkpoints in upstream's layout, 20 steps through cli.train
     (validation, checkpoints at 10 and 20), step 20 restored bit for bit,
     resumed to 30, cli.infer on the 4 test items (the RTF line names the
     card; wav and mel shapes; 71 stack and 3 MRF launches a call); the
     training kernels against their twins on the run's largest and a
     validation batch, the first test utterance against the plain twins;
  7h. cli_cascade: on that corpus, cli.train on lj/fs2.yaml (20 steps) and
     lj/ds_beta6.yaml as shipped warm-started from it (10 steps; only the
     predictors move), --infer of both: launches, wavs, the training kernels
     and each run's first utterance against the plain twins;
  7i. serve_web: SVSWebApp over GradioInfer(DiffSingerE2EInfer) on
     127.0.0.1:0 with ds1000.yaml as shipped from checkpoints on disk: the
     four gradio demo sentences as RIFF PCM16, each within 2 LSB of a direct
     greet, the first twice at once, 400 / 413 / 400 for the status rules,
     26 stack and 2 MRF launches a request; the unfused path against the
     fused one on the same draws (relative RMS <= 5e-2, correlation > 0.99);
  7j. vocoders: the bf16 MRF body in HiFiGAN v1 and NSF-HiFiGAN (3 + 2
     launches) against the plain twins within 1e-2 of the waveform's scale; a
     resblock '2' generator at HiFiGAN v3's widths and ParallelWaveGAN from a
     written official release, card against CPU within 1e-4;
  7k. crf: ds_beta6.yaml with dur_loss: crf: the first step on 2 rows
     against the CPU in float64 by phase 7d's rule for the FS2 side, the
     training kernels by ``step_agrees_f32``, two steps; one 8 x 1024 batch
     on the Viterbi durations: dur_choice equal to the CPU's, log Z within
     1e-5 of float64, 71 / 3 launches;
  7l. vocoder_train: HifiGanTask at HiFiGAN v1's widths with MPD and MSD on
     16 x 8192 samples of a harmonic-tone corpus: the first step's D and G
     losses (1e-4) and gradients (relative L2 within 1e-3 beyond the CPU
     float32 step's own) on 4 rows against the CPU in float64, two finite
     steps; the trained generator through the float32 MRF kernel (3
     launches) against the plain twins; MelGAN card against CPU; a PQMF
     round trip;
  7m. parallel: ds_beta6.yaml as shipped on the train_shipped batch: (a) the
     mesh trainer under NCCL with one rank against the plain trainer
     (losses 1e-5, first-step gradients 1e-6, updates 1e-3 relative L2); (b)
     NCCL refuses two ranks on one card; dp=2 on 2 x 12 and 23 rows and tp=2
     in two gloo processes against one process, tp=2's resident bytes at
     most half of tp=1's; (c) DP serving of the LJ 8 x 1024 batch, 4 rows a
     rank, within 1e-4 of one process, 71 / 3 launches a rank;
  8. the ``kernels`` line (each kernel's launches by path, its kernel-alone
     ms, plain ms and bound), the card line and, last, {"ok": true, ...}.
Long output goes to build/chip_smoke/chip_smoke.json.
"""

import json
import subprocess
import sys
from contextlib import ExitStack, contextmanager
from pathlib import Path
from typing import Optional
from unittest import mock

ROOT = Path(__file__).resolve().parent
H100_BF16_FLOPS = 989e12   # dense tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12     # float32 outside the tensor cores
H100_TF32_FLOPS = 495e12   # dense TF32 tensor-core peak
# float32 accuracy on the tensor cores takes three TF32 passes a product
# (a_hi*b_hi + a_hi*b_lo + a_lo*b_hi): the rate the card can give the
# float32 MRF kernel at the accuracy its tolerance needs
H100_3XTF32_FLOPS = H100_TF32_FLOPS / 3
H100_BYTES = 3.35e12       # HBM3 bandwidth
# the bf16 mma.sync rate measured on an H100 80GB HBM3 at 700 W
# (tools/mma_rate.py): the most the bf16 MRF body's warp-level products can give
H100_MMA_SYNC_BF16_FLOPS = 637.8e12


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


@contextmanager
def plain_twins(ds=None, mrf=None, tr=None):
    """The kernel wrappers of the given ops modules (``ops/diffnet_stack``,
    ``ops/hifigan_mrf``, ``ops/diffnet_train``) replaced by their plain twins
    while the block runs, the wrappers back after it, also on an exception."""
    swaps = [(ds, "diffnet_stack", "diffnet_stack_plain"),
             (mrf, "mrf_stage", "mrf_stage_plain"),
             (tr, "diffnet_train_fwd", "diffnet_train_stack_fwd_plain"),
             (tr, "diffnet_train_bwd", "diffnet_train_stack_bwd_plain")]
    with ExitStack() as stack:
        for module, entry, twin in swaps:
            if module is not None:
                stack.enter_context(mock.patch.object(module, entry, getattr(module, twin)))
        yield


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call from CUDA events, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: float, nbytes: float, peak_flops: float):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / H100_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# --------------------------------------------------------------------- phase 2
# (dtype, dilation cycle, B, T, C): the serving shapes; T = 301: not a multiple
# of the 64-row tile; the other serving buckets; T = 5: shorter than cycle 4's
# largest dilation (8); the singing batches, cycle 4 at 2 x 4096 and at
# max_frames; each in bf16 and in float32 (the shipped configs' type); one
# float32 case at C = 128; cycle 6 (d = 32, past the tensor-core bodies'
# widest halo), which the float32 SIMT body takes; and the shapes the float32
# body's column split serves: singing phrases at B = 1 (the median and the
# p95 length of the benchmark's phrases) and small batches of the batcher
STACK_CASES = ([(dt, cycle, 8, 1024, 256) for dt in ("bfloat16", "float32") for cycle in (1, 4)]
               + [(dt, cycle, b, t, 256) for dt in ("bfloat16", "float32")
                  for cycle, b, t in ((4, 3, 301), (1, 4, 512), (1, 1, 256), (4, 2, 5),
                                      (4, 2, 4096), (4, 1, 7936))]
               + [("float32", 4, 4, 512, 128), ("float32", 6, 2, 100, 256)]
               + [("float32", cycle, b, t, 256)
                  for cycle, b, t in ((4, 1, 1152), (4, 1, 2432), (1, 4, 384), (1, 16, 640))])


def phase_stack(torch, ds, cases=STACK_CASES):
    num_layers = 20
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    rows = []
    for dt_name, cycle, b, t, c in cases:
        dt = torch.bfloat16 if dt_name == "bfloat16" else None
        wdt = dt or torch.float32
        what = f"diffnet_stack {dt_name} cycle {cycle} {b}x{t} C={c}"
        args = (torch.relu(rn(b, t, c)), rn(num_layers, b, c, scale=0.5),
                rn(num_layers, b, t, 2 * c, scale=0.5).to(wdt),
                rn(num_layers, 3, c, 2 * c, scale=(3 * c) ** -0.5).to(wdt),
                rn(num_layers, 2 * c, scale=0.1),
                rn(num_layers, c, 2 * c, scale=c ** -0.5).to(wdt),
                rn(num_layers, 2 * c, scale=0.1))
        dil = tuple(2 ** (i % cycle) for i in range(num_layers))
        x0_before = args[0].clone()
        got = ds.diffnet_stack(*args, dilations=dil, compute_dtype=dt)
        # counted by the library where it launches, and which body it ran
        launched, ran_tc = ds.diffnet_stack.device_launches, ds.diffnet_stack.ran_tensor_cores
        split = ds.diffnet_stack.column_split
        again = ds.diffnet_stack(*args, dilations=dil, compute_dtype=dt)
        want = ds.diffnet_stack_plain(*args, dilations=dil, compute_dtype=dt)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{what}: two calls on the same inputs gave different bits")
        if not torch.equal(args[0], x0_before):
            raise AssertionError(f"{what}: x0 was written")
        del again, x0_before
        # the library's own account of its tensor-core bodies for this shape,
        # against the wrapper's rule and the body that ran
        info = ds.tensor_core_info(c, dil, dt)
        expect_tc = ds.takes_tensor_cores(c, dil, dt)
        if (info is not None) != expect_tc or ran_tc != expect_tc:
            raise AssertionError(f"{what}: the wrapper's rule says tensor cores={expect_tc}, "
                                 f"the library {info}, the call ran {ran_tc}")
        if info and info["smem"] > 227 * 1024:
            raise AssertionError(f"{what}: shared memory {info['smem']} above 227 KB")
        # tensor cores: one launch a layer; SIMT: two
        if launched != (1 if expect_tc else 2) * num_layers:
            raise AssertionError(f"{what}: {launched} device launches for {num_layers} layers")
        # the column split the library ran is the wrapper's rule on the card's
        # resident counts (the float32 tensor-core body; 1 elsewhere), and a
        # shape that fills a wave keeps the unsplit body
        resident = ds._resident(c, max(dil), torch.cuda.current_device()) \
            if expect_tc and dt is None else None
        want_k = ds.column_split(b, t, c, resident) if resident else 1
        if split != want_k or ((b, t) == (8, 1024) and split != 1):
            raise AssertionError(f"{what}: the library ran column split {split}, the rule "
                                 f"says {want_k} (resident {resident})")
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        # f32: same products, sums of up to 3C=768 terms in another order over
        # 20 layers -> 1e-4 relative to the output scale (the JAX package's
        # stack tolerance at scale 1). bf16: both round y and g at the same
        # points, but a float32 sum in another order can round a value one
        # bf16 step (2^-8) apart and carry it through later layers -> 1e-2
        # relative to the output scale.
        tol = (1e-2 if dt else 1e-4) * max(scale, 1.0)
        ms = cuda_ms(lambda: ds.diffnet_stack(*args, dilations=dil, compute_dtype=dt), 5)
        plain_ms = cuda_ms(lambda: ds.diffnet_stack_plain(*args, dilations=dil,
                                                          compute_dtype=dt), 3)
        flops = num_layers * 4 * 2 * (b * t) * c * (2 * c)
        moved = nbytes(*args) + b * t * c * 4
        # float32: the least time at float32 accuracy is three TF32 passes on
        # the tensor cores; the FMA bound beside it is what the SIMT body faces
        bnd, by = bound_ms(flops, moved, H100_BF16_FLOPS if dt else H100_3XTF32_FLOPS)
        row = dict(dtype=dt_name, cycle=cycle, B=b, T=t, C=c,
                   body="tensor-core" if ran_tc else "simt", device_launches=launched,
                   column_split=split, resident=resident,
                   tensor_core_info=info, max_abs_err=err, tolerance=tol,
                   out_scale=scale, ms=ms, tflops=flops / ms / 1e9, plain_ms=plain_ms,
                   bound_ms=bnd, bound_by=by)
        if dt is None:
            row["bound_fma_ms"], _ = bound_ms(flops, moved, H100_F32_FLOPS)
        print("diffnet_stack", json.dumps(row), flush=True)
        if not err <= tol:
            raise AssertionError(f"{what}: max|err| {err} > {tol}")
        rows.append(row)
        del got, want, args
    return rows


# --------------------------------------------------------------------- phase 3
# (dtype, C, B, T): the three C <= 128 scales at 8 x 1024 mel frames in both
# types; then, in both, T not a multiple of the tile, B = 1 (a 256-frame
# request's first scale) and T shorter than one halo (60 rows); and C = 16 in
# bf16, the smallest width the body takes
MRF_CASES = ([(dt, c, 8, t) for dt in ("float32", "bfloat16")
              for c, t in ((128, 65536), (64, 131072), (32, 262144))]
             + [("float32", 16, 8, 524288)]
             + [(dt, c, b, t) for dt in ("float32", "bfloat16")
                for c, b, t in ((64, 2, 1037), (128, 1, 16384), (32, 2, 37))]
             + [("bfloat16", 16, 2, 4096)])


def phase_mrf(torch, mrf, cases=MRF_CASES):
    ks, ds_ = (3, 7, 11), ((1, 3, 5),) * 3
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for dt_name, c, b, t in cases:
        dt = torch.bfloat16 if dt_name == "bfloat16" else None
        x = torch.randn(b, t, c, generator=gen, device="cuda") * 0.3
        w1 = torch.zeros(3, 3, 11 * c, c, device="cuda")
        w2 = torch.zeros_like(w1)
        for j, k in enumerate(ks):
            for w in (w1, w2):
                w[j, :, : k * c] = torch.randn(3, k * c, c, generator=gen,
                                               device="cuda") * (k * c) ** -0.5
        b1 = torch.randn(3, 3, c, generator=gen, device="cuda") * 0.05
        b2 = torch.randn(3, 3, c, generator=gen, device="cuda") * 0.05
        if dt is not None:
            x, w1, w2 = x.to(dt), w1.to(dt), w2.to(dt)
        kw = dict(kernel_sizes=ks, dilation_sets=ds_, compute_dtype=dt)
        got = mrf.mrf_stage(x, w1, b1, w2, b2, **kw)
        again = mrf.mrf_stage(x, w1, b1, w2, b2, **kw)
        want = mrf.mrf_stage_plain(x, w1, b1, w2, b2, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"mrf_stage {dt_name} C={c} {b}x{t}: two calls on the same "
                                 "inputs gave different bits")
        del again
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        # f32: sums of up to 11C terms in another order (and, on the tensor
        # cores, products split 3xTF32, exact to 2^-20) through 18 convs ->
        # 1e-4 relative to the output scale. bf16: same rounding points; a sum
        # in another order can round the chain state one bf16 step apart ->
        # 1e-2 relative to the output scale.
        tol = (1e-2 if dt else 1e-4) * max(scale, 1.0)
        reps = 2 if t > 10000 else 5
        ms = cuda_ms(lambda: mrf.mrf_stage(x, w1, b1, w2, b2, **kw), reps)
        plain_ms = cuda_ms(lambda: mrf.mrf_stage_plain(x, w1, b1, w2, b2, **kw), reps)
        flops = 252 * c * c * b * t
        useful_w = sum(2 * 3 * k * c * c for k in ks) * w1.element_size()
        bnd, by = bound_ms(flops, nbytes(x, b1, b2) + useful_w + b * t * c * 4,
                           H100_BF16_FLOPS if dt else H100_3XTF32_FLOPS)
        row = dict(dtype=dt_name, C=c, B=b, T=t, max_abs_err=err, tolerance=tol,
                   out_scale=scale, ms=ms, tflops=flops / ms / 1e9, plain_ms=plain_ms,
                   bound_ms=bnd, bound_by=by, bound_share=bnd / ms,
                   body="mma.sync" if dt else "wgmma")
        if dt is not None:
            row["bound_mma_sync_ms"] = flops / H100_MMA_SYNC_BF16_FLOPS * 1e3
        print("mrf_stage", json.dumps(row), flush=True)
        if not err <= tol:
            raise AssertionError(f"mrf_stage {dt_name} C={c} T={t}: max|err| {err} > {tol}")
        rows.append(row)
    return rows


# --------------------------------------------------------------------- phase 4
FRAMES_PER_PHONE = 8


def build_synth(torch, seed: int = 0, frame_pitch: bool = True,
                stack_dtype: Optional[str] = "bfloat16", config: Optional[str] = None):
    """DiffSpeech-LJSpeech for serving; ``frame_pitch`` keeps bench.py's
    pitch_type override, else the config's own cwt pitch; ``stack_dtype``
    None keeps the config's own (float32) stack. ``config`` (a path under
    configs/) serves that config as shipped instead: its own widths, sampler,
    pitch and stack type."""
    import numpy as np
    import torch.nn as nn

    from diffsinger_tpu_torch.config.hparams import set_hparams
    from diffsinger_tpu_torch.inference.serve import FusedSynthesizer
    from diffsinger_tpu_torch.inference.vocoder import HifiGAN
    from diffsinger_tpu_torch.training.tasks import DiffSingerTask

    if config is not None:
        hp = set_hparams(str(ROOT / "configs" / config))
        hp["seed"] = seed
    else:
        hp = set_hparams(str(ROOT / "configs" / "lj" / "ds_beta6.yaml"))
        # bench.py's serving workload: DiffSpeech LJSpeech at its published
        # width (its use_pallas_diffnet switch has no counterpart: the port's
        # stack always runs through the kernel wrapper)
        hp.update(hidden_size=256, enc_layers=4, dec_layers=4, residual_layers=20,
                  residual_channels=256, timesteps=100, K_step=71, max_beta=0.06,
                  schedule_type="linear", seed=seed)
        if stack_dtype is not None:
            hp["compute_dtype"] = stack_dtype
        if frame_pitch:
            hp["pitch_type"] = "frame"
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        task = DiffSingerTask(hp, vocab_size=80, device="cpu")
        voc = HifiGAN(hp, device="cpu")
        with torch.no_grad():
            # seeded random weights; the DiffNet output projection is zero at
            # init and the HiFiGAN convs 0.01-scaled, so give both torch's
            # default scale to make every layer move the waveform
            nn.init.normal_(task.denoise_fn.output_projection.weight, 0.0, 0.05)
            for m in voc.model.modules():
                if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
                    m.reset_parameters()
            # known durations: every phone lasts FRAMES_PER_PHONE frames
            lin = task.fs2.dur_predictor.linear
            lin.weight.zero_()
            lin.bias.fill_(float(np.log(FRAMES_PER_PHONE + 1.0)))
            if hp["pitch_type"] == "cwt":
                # the CWT statistics: log-F0 around 5.2 (181 Hz), std 0.35
                stats = task.fs2.cwt_stats_layers[4]
                stats.weight.mul_(0.1)
                stats.bias.copy_(torch.tensor([5.2, 0.35]))
    syn = FusedSynthesizer(hp, task, voc)  # default device: the card
    return hp, syn


def phase_serve(torch, ds, mrf, card: str):
    import numpy as np

    hp, syn = build_synth(torch)
    rng = np.random.RandomState(0)

    def request(n_phones, t_mel):
        return {"txt_tokens": rng.randint(3, 80, size=(1, n_phones)).astype(np.int64)}, t_mel

    big = [request(128, 1024) for _ in range(8)]                 # 8 x 1024 frames
    small = [request(n, 480) for n in (40, 52, 60)]              # bucket 512
    single = request(30, 240)                                    # bucket 256
    syn.warmup([1024, 512, 256], batch_sizes=(8, 4, 1))

    ds.diffnet_stack.launches = 0
    mrf.mrf_stage.launches = 0
    wav_big = syn.synthesize_many(big)
    wav_small = syn.synthesize_many(small)
    wav_single = syn(*single)
    launches = {"diffnet_stack": ds.diffnet_stack.launches,
                "mrf_stage": mrf.mrf_stage.launches}

    k_step = int(hp["K_step"])
    n_batches = len(syn.plan(big)) + len(syn.plan(small)) + 1
    expect = {"diffnet_stack": k_step * n_batches, "mrf_stage": 3 * n_batches}
    if launches != expect:
        raise AssertionError(f"kernel launches on the serving path {launches}, "
                             f"expected {expect}")
    hop = syn.hop
    for (batch, _), wav in zip(big + small + [single], wav_big + wav_small + [wav_single]):
        n_frames = batch["txt_tokens"].shape[1] * FRAMES_PER_PHONE
        if wav.shape != (n_frames * hop,) or not np.isfinite(wav).all():
            raise AssertionError(f"bad waveform {wav.shape} for {n_frames} frames")

    # the 8 x 1024 batch again, kernels vs plain twins, same fixed noise
    noise = torch.randn((k_step + 1, 8, 1024, 80), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(5))
    wav_k = syn.synthesize_many(big, noises=[noise])
    with plain_twins(ds, mrf):
        wav_p = syn.synthesize_many(big, noises=[noise])
    a, b = np.concatenate(wav_k), np.concatenate(wav_p)
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        raise AssertionError("non-finite waveform in the kernel/plain comparison")
    diff = float(np.abs(a - b).max())
    corr = float(np.corrcoef(a, b)[0, 1])
    # both paths round to bf16 at the same points in the stack and accumulate
    # in float32, so they differ only by summation order (a value now and then
    # one bf16 step apart), which the 71 clipped DDPM steps and the vocoder's
    # branch mean keep small: 1e-4 relative to the waveform's scale. A wrong
    # cast, transpose or weight layout in the glue moves it by far more.
    wav_tol = 1e-4 * max(float(np.abs(b).max()), 1.0)
    out = {
        "card": card, "requests": len(big) + len(small) + 1, "batches": n_batches,
        "launches": launches,
        "wav_max_abs": float(np.abs(a).max()),
        "kernel_vs_plain_wav_max_abs_diff": diff,
        "kernel_vs_plain_wav_tolerance": wav_tol,
        "kernel_vs_plain_wav_corr": corr,
    }
    print("serving", json.dumps(out), flush=True)
    if not diff <= wav_tol:
        raise AssertionError(f"serving: kernel and plain waveforms differ by {diff} "
                             f"> {wav_tol}")
    return out


def phase_serve_cwt(torch, ds, mrf, card: str):
    """configs/lj/ds_beta6.yaml with its own cwt pitch (no pitch_type
    override): one warm 8 x 1024 batch, its launches, and the batch again
    through the plain twins on the same noise."""
    import numpy as np

    hp, syn = build_synth(torch, frame_pitch=False)
    if hp["pitch_type"] != "cwt" or not hasattr(syn.task.fs2, "cwt_predictor"):
        raise AssertionError("serve_cwt: the model is not the config's cwt-pitch FS2")
    rng = np.random.RandomState(2)
    big = [({"txt_tokens": rng.randint(3, 80, size=(1, 128)).astype(np.int64)}, 1024)
           for _ in range(8)]
    syn.warmup([1024], batch_sizes=(8,))

    ds.diffnet_stack.launches = 0
    mrf.mrf_stage.launches = 0
    wavs = syn.synthesize_many(big)
    launches = {"diffnet_stack": ds.diffnet_stack.launches,
                "mrf_stage": mrf.mrf_stage.launches}
    k_step = int(hp["K_step"])
    if launches != {"diffnet_stack": k_step, "mrf_stage": 3}:
        raise AssertionError(f"serve_cwt: kernel launches {launches}, expected "
                             f"{k_step} stack and 3 MRF")
    for wav in wavs:
        if wav.shape != (1024 * syn.hop,) or not np.isfinite(wav).all():
            raise AssertionError(f"serve_cwt: bad waveform {wav.shape}")

    # the predicted pitch the conditioner embedded, on the first row
    (t_mel_b, group, _), = syn.plan(big)
    stacked = syn._stack_group(group, 128, t_mel_b)
    with torch.no_grad():
        ret = syn.task.fs2(torch.as_tensor(stacked["txt_tokens"], device="cuda"),
                           t_mel=t_mel_b, skip_decoder=True)
    f0 = ret["f0_denorm"][ret["mel2ph"] > 0]
    noise = torch.randn((k_step + 1, 8, 1024, 80), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(6))
    wav_k = syn.synthesize_many(big, noises=[noise])
    with plain_twins(ds, mrf):
        wav_p = syn.synthesize_many(big, noises=[noise])
    a, b = np.concatenate(wav_k), np.concatenate(wav_p)
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        raise AssertionError("serve_cwt: non-finite waveform in the kernel/plain comparison")
    diff = float(np.abs(a - b).max())
    # the frame phase's tolerance: the same kernels, casts and vocoder
    wav_tol = 1e-4 * max(float(np.abs(b).max()), 1.0)
    out = {"card": card, "config": "configs/lj/ds_beta6.yaml as shipped (pitch_type cwt) "
                                   "with bench.py's width and precision, seeded weights",
           "launches": launches,
           "voiced_share": float((f0 > 0).float().mean()),
           "f0_hz_median": float(f0[f0 > 0].median()) if bool((f0 > 0).any()) else 0.0,
           "wav_max_abs": float(np.abs(a).max()),
           "kernel_vs_plain_wav_max_abs_diff": diff,
           "kernel_vs_plain_wav_tolerance": wav_tol}
    print("serve_cwt", json.dumps(out), flush=True)
    if not diff <= wav_tol:
        raise AssertionError(f"serve_cwt: kernel and plain waveforms differ by {diff} "
                             f"> {wav_tol}")
    return out


# -------------------------------------------------------------------- phase 5b
SING_FRAMES_PER_PHONE = 8
SING_HOP = 128
# the NSF-HiFiGAN geometry tools/bench_opencpop.py assumes for the released
# hop-128 vocoder, until its config.yaml is in the repository
SING_VOCODER = dict(resblock="1", upsample_rates=[8, 8, 2], upsample_kernel_sizes=[16, 16, 4],
                    upsample_initial_channel=512, resblock_kernel_sizes=[3, 7, 11],
                    resblock_dilation_sizes=[[1, 3, 5], [1, 3, 5], [1, 3, 5]],
                    nsf_source_mode="exact")
SING_WORD_INPUT = {
    "text": "小酒窝长睫毛AP是你最美的记号",
    "notes": "C#4/Db4 | F#4/Gb4 | G#4/Ab4 | A#4/Bb4 F#4/Gb4 | F#4/Gb4 C#4/Db4 | C#4/Db4 | "
             "rest | C#4/Db4 | A#4/Bb4 | G#4/Ab4 | A#4/Bb4 G#4/Ab4 | F#4/Gb4 | C#4/Db4 | "
             "C#4/Db4",
    "notes_duration": "0.407 | 0.376 | 0.242 | 0.509 0.183 | 0.315 0.235 | 0.361 | 0.223 | "
                      "0.377 | 0.340 | 0.299 | 0.344 0.283 | 0.323 | 0.360 | 0.300",
    "input_type": "word"}


def build_singer(torch, seed: int = 0, stack_dtype: Optional[str] = "bfloat16",
                 config: str = "ds1000.yaml"):
    from diffsinger_tpu_torch.config.hparams import set_hparams
    from diffsinger_tpu_torch.inference.svs import DiffSingerE2EInfer

    hp = set_hparams(str(ROOT / "configs" / "opencpop" / config))
    # the released DiffSinger-Opencpop model (or ``config``, another OpenCpop
    # config) at its published width, the stack in bf16
    # (tools/bench_opencpop.py's setting) unless stack_dtype is None (the
    # config's own float32); the vocoder's geometry is given explicitly (hop
    # 8 * 8 * 2 = 128 = hop_size)
    hp.update(seed=seed, **SING_VOCODER)
    if stack_dtype is not None:
        hp["compute_dtype"] = stack_dtype
    task, voc, pe = seeded_singer(torch, hp, seed, SING_FRAMES_PER_PHONE)
    infer = DiffSingerE2EInfer(hp, task, voc, pe=pe)  # default device: the card
    return hp, infer


def seeded_singer(torch, hp, seed: int, frames_per_phone: int):
    """The singing task, vocoder and PE of ``hp`` on the CPU with seeded
    weights, the phone durations fixed at ``frames_per_phone``."""
    import numpy as np
    import torch.nn as nn

    from diffsinger_tpu_torch.inference.svs import CPOP_PHONE_LIST
    from diffsinger_tpu_torch.inference.vocoder import HifiGAN
    from diffsinger_tpu_torch.models.pe import PEConfig, PitchExtractor
    from diffsinger_tpu_torch.training.tasks import DiffSingerTask

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        task = DiffSingerTask(hp, vocab_size=len(CPOP_PHONE_LIST) + 3, device="cpu")
        voc = HifiGAN(hp, device="cpu")
        pe = PitchExtractor(PEConfig.from_hparams(hp))
        with torch.no_grad():
            # as build_synth: a nonzero DiffNet output projection, the
            # vocoder's convs at torch's default scale, fixed phone durations
            nn.init.normal_(task.denoise_fn.output_projection.weight, 0.0, 0.05)
            for m in voc.model.modules():
                if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
                    m.reset_parameters()
            lin = task.fs2.dur_predictor.linear
            lin.weight.zero_()
            lin.bias.fill_(float(np.log(frames_per_phone + 1.0)))
            # a seeded PE with running statistics, its F0 head centred on
            # 2^7.5 = 181 Hz with a uv logit around 0 (voiced and unvoiced
            # frames both occur)
            for layer in pe.mel_prenet.layers:
                layer[2].running_mean.normal_(0.0, 0.2)
                layer[2].running_var.uniform_(0.5, 2.0)
            head = pe.pitch_predictor.linear
            head.weight.mul_(0.01)
            head.bias.copy_(torch.tensor([7.5, 0.0]))
    return task, voc, pe


def sing_vs_plain(torch, ds, mrf, syn, requests, seed: int) -> dict:
    """One singing batch, kernels against plain twins, in two parts: a mel a
    hair apart can flip the PE's voicing of a frame, which moves the waveform
    far more than any kernel error, so sampler and vocoder are held apart."""
    from diffsinger_tpu_torch.models.hifigan import draw_source

    (t_mel_b, group, b_pad), = syn.plan(requests)
    stacked = syn._stack_group(group, requests[0][0]["txt_tokens"].shape[1], t_mel_b)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cfg = syn.task.gd.cfg  # PLMS draws its start, DDPM also one noise a step
    n_draws = 1 if cfg.pndm_speedup else cfg.k_step + 1
    bins = int(syn.hp.get("audio_num_mel_bins", 80))
    noise = torch.randn((n_draws, b_pad, t_mel_b, bins), device="cuda", generator=gen)
    with torch.no_grad():
        out = syn.task.inference(stacked, t_mel=t_mel_b, noise=noise)
        with plain_twins(ds):
            out_p = syn.task.inference(stacked, t_mel=t_mel_b, noise=noise)
        mel_k, mel_p = out["mel_out"], out_p["mel_out"]
        mel_scale = mel_p.abs().max().item()
        mel_diff = (mel_k - mel_p).abs().max().item()
        f0 = syn.pe(mel_k)["f0_denorm_pred"]
        mel_v = torch.where((out["mel2ph"] > 0)[..., None], mel_k, mel_k.min())
        source = draw_source(b_pad, t_mel_b * syn.hop, "cuda", gen)
        wav_k = syn.vocoder.apply(mel_v, f0=f0, source=source)
        with plain_twins(mrf=mrf):
            wav_p = syn.vocoder.apply(mel_v, f0=f0, source=source)
    wav_scale = wav_p.abs().max().item()
    wav_diff = (wav_k - wav_p).abs().max().item()
    finite = all(bool(torch.isfinite(a).all()) for a in (mel_k, mel_p, wav_k, wav_p))
    # sampler: both stacks round to bf16 at the same points and differ by
    # float32 summation order, a value now and then one bf16 step apart: the
    # stack's own tolerance, 1e-2 of the output's scale (26 calls of a PLMS
    # with no clipping carry such a step on, scaled like the mel itself).
    # Vocoder: the float32 MRF kernel (3xTF32) against float32 convolutions,
    # 1e-4 of the waveform's scale, as on the serving path.
    return {"pe_voiced_share": float((f0[out["mel2ph"] > 0] > 0).float().mean()),
            "sampler_mel_scale": mel_scale,
            "kernel_vs_plain_mel_max_abs_diff": mel_diff,
            "kernel_vs_plain_mel_tolerance": 1e-2 * max(mel_scale, 1.0),
            "wav_max_abs": wav_scale,
            "kernel_vs_plain_wav_max_abs_diff": wav_diff,
            "kernel_vs_plain_wav_tolerance": 1e-4 * max(wav_scale, 1.0),
            "finite": finite}


def sing_check_or_raise(what: str, check: dict) -> None:
    if not check["finite"]:
        raise AssertionError(f"{what}: non-finite mel or waveform in the kernel/plain check")
    mel_diff, mel_tol = (check["kernel_vs_plain_mel_max_abs_diff"],
                         check["kernel_vs_plain_mel_tolerance"])
    wav_diff, wav_tol = (check["kernel_vs_plain_wav_max_abs_diff"],
                         check["kernel_vs_plain_wav_tolerance"])
    if not (mel_diff <= mel_tol and wav_diff <= wav_tol):
        raise AssertionError(f"{what}: kernel vs plain mel {mel_diff} (tolerance {mel_tol}), "
                             f"waveform {wav_diff} (tolerance {wav_tol})")


def phase_sing(torch, ds, mrf, card: str):
    import numpy as np

    from diffsinger_tpu_torch.inference.svs import EXAMPLE_INPUT

    hp, infer = build_singer(torch)
    syn = infer.fused
    n_calls = syn.task.gd.denoiser_calls()
    if n_calls != 26:
        raise AssertionError(f"PLMS-25 makes {n_calls} denoiser calls, expected 26")
    rng = np.random.RandomState(1)
    vocab = len(infer.ph_encoder)

    def request(n_phones, t_mel):
        return {"txt_tokens": rng.randint(3, vocab, size=(1, n_phones)).astype(np.int64),
                "pitch_midi": rng.randint(48, 80, size=(1, n_phones)).astype(np.int64),
                "midi_dur": rng.uniform(0.05, 0.6, size=(1, n_phones)).astype(np.float32),
                "is_slur": (rng.rand(1, n_phones) < 0.1).astype(np.int64)}, t_mel

    # tools/bench_opencpop.py's sampler row (8 x 1024) and e2e row (2 x 4096)
    big = [request(1024 // SING_FRAMES_PER_PHONE, 1024) for _ in range(8)]
    long = [request(4096 // SING_FRAMES_PER_PHONE, 4096) for _ in range(2)]
    items = {k: infer.preprocess_input(inp, inp["input_type"])
             for k, inp in (("e2e", EXAMPLE_INPUT), ("word", SING_WORD_INPUT))}
    syn.warmup([1024], batch_sizes=(8,))
    syn.warmup([4096], batch_sizes=(2,))
    syn.warmup([infer.estimate_t_mel(it) for it in items.values()], batch_sizes=(1,))

    ds.diffnet_stack.launches = 0
    mrf.mrf_stage.launches = 0
    wav_big = syn.synthesize_many(big)
    wav_long = syn.synthesize_many(long)
    wav_e2e = infer.infer_once(EXAMPLE_INPUT)
    wav_word = infer.infer_once(SING_WORD_INPUT)
    launches = {"diffnet_stack": ds.diffnet_stack.launches,
                "mrf_stage": mrf.mrf_stage.launches}

    n_batches = len(syn.plan(big)) + len(syn.plan(long)) + 2
    expect = {"diffnet_stack": n_calls * n_batches, "mrf_stage": 2 * n_batches}
    if launches != expect:
        raise AssertionError(f"kernel launches on the singing path {launches}, "
                             f"expected {expect}")
    for name, wavs, per_row in (
            ("batch_8x1024", wav_big, 1024), ("batch_2x4096", wav_long, 4096),
            ("e2e_example", [wav_e2e], len(items["e2e"]["ph_token"]) * SING_FRAMES_PER_PHONE),
            ("word_level", [wav_word], len(items["word"]["ph_token"]) * SING_FRAMES_PER_PHONE)):
        for wav in wavs:
            if wav.shape != (per_row * SING_HOP,) or not np.isfinite(wav).all():
                raise AssertionError(f"singing {name}: bad waveform {wav.shape} for "
                                     f"{per_row} frames")

    check = sing_vs_plain(torch, ds, mrf, syn, big, seed=5)
    result = {
        "card": card, "config": "configs/opencpop/ds1000.yaml (bf16 stack, NSF-HiFiGAN "
                                "8/8/2, 512 ch, exact source), seeded weights",
        "requests": len(big) + len(long) + 2, "batches": n_batches,
        "denoiser_calls_per_batch": n_calls, "launches": launches, **check,
    }
    print("singing", json.dumps(result), flush=True)
    sing_check_or_raise("singing", check)
    return result


# -------------------------------------------------------------------- phase 5c
def stack_ran(ds, what: str, num_layers: int = 20) -> None:
    """The last stack call of a path ran the float32 tensor-core body."""
    if not (ds.diffnet_stack.ran_tensor_cores and
            ds.diffnet_stack.device_launches == num_layers):
        raise AssertionError(f"{what}: the stack ran tensor cores="
                             f"{ds.diffnet_stack.ran_tensor_cores} with "
                             f"{ds.diffnet_stack.device_launches} device launches, "
                             f"expected the tensor-core body, {num_layers}")


def phase_serve_shipped(torch, ds, mrf, card: str):
    """The shipped configs with their own float32 stack (no compute_dtype
    override): configs/lj/ds_beta6.yaml (cwt pitch, HiFiGAN v1) on one warm
    8 x 1024 batch, configs/opencpop/ds1000.yaml (PLMS-25, PE, NSF-HiFiGAN with
    the 8/8/2 geometry) on an 8 x 1024 and a 2 x 4096 batch; launches, and
    each batch against the plain twins by the serve_cwt and singing phases'
    criteria."""
    import numpy as np

    # --- LJ, ds_beta6.yaml as shipped
    hp, syn = build_synth(torch, frame_pitch=False, stack_dtype=None)
    if syn.task.compute_dtype is not None or hp["pitch_type"] != "cwt":
        raise AssertionError("serve_shipped: the LJ model is not ds_beta6.yaml's float32 "
                             "cwt-pitch model")
    rng = np.random.RandomState(3)
    big = [({"txt_tokens": rng.randint(3, 80, size=(1, 128)).astype(np.int64)}, 1024)
           for _ in range(8)]
    syn.warmup([1024], batch_sizes=(8,))
    ds.diffnet_stack.launches = 0
    mrf.mrf_stage.launches = 0
    wavs = syn.synthesize_many(big)
    lj_launches = {"diffnet_stack": ds.diffnet_stack.launches,
                   "mrf_stage": mrf.mrf_stage.launches}
    k_step = int(hp["K_step"])
    if lj_launches != {"diffnet_stack": k_step, "mrf_stage": 3}:
        raise AssertionError(f"serve_shipped LJ: kernel launches {lj_launches}, expected "
                             f"{k_step} stack and 3 MRF")
    stack_ran(ds, "serve_shipped LJ")
    for wav in wavs:
        if wav.shape != (1024 * syn.hop,) or not np.isfinite(wav).all():
            raise AssertionError(f"serve_shipped LJ: bad waveform {wav.shape}")
    noise = torch.randn((k_step + 1, 8, 1024, 80), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(7))
    wav_k = syn.synthesize_many(big, noises=[noise])
    with plain_twins(ds, mrf):
        wav_p = syn.synthesize_many(big, noises=[noise])
    a, b = np.concatenate(wav_k), np.concatenate(wav_p)
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        raise AssertionError("serve_shipped LJ: non-finite waveform in the kernel/plain check")
    lj = {"config": "configs/lj/ds_beta6.yaml as shipped (cwt pitch, float32 stack, "
                    "HiFiGAN v1 float32), seeded weights",
          "launches": lj_launches,
          "wav_max_abs": float(np.abs(a).max()),
          "kernel_vs_plain_wav_max_abs_diff": float(np.abs(a - b).max()),
          # the serve_cwt phase's criterion
          "kernel_vs_plain_wav_tolerance": 1e-4 * max(float(np.abs(b).max()), 1.0)}
    print("serve_shipped_lj", json.dumps(lj), flush=True)
    if not lj["kernel_vs_plain_wav_max_abs_diff"] <= lj["kernel_vs_plain_wav_tolerance"]:
        raise AssertionError(f"serve_shipped LJ: kernel and plain waveforms differ by "
                             f"{lj['kernel_vs_plain_wav_max_abs_diff']} > "
                             f"{lj['kernel_vs_plain_wav_tolerance']}")
    del syn, wav_k, wav_p, noise

    # --- singing, ds1000.yaml as shipped (the vocoder geometry given)
    hp, infer = build_singer(torch, stack_dtype=None)
    syn = infer.fused
    if syn.task.compute_dtype is not None:
        raise AssertionError("serve_shipped: the singing model's stack is not float32")
    n_calls = syn.task.gd.denoiser_calls()
    rng = np.random.RandomState(4)
    vocab = len(infer.ph_encoder)

    def request(n_phones, t_mel):
        return {"txt_tokens": rng.randint(3, vocab, size=(1, n_phones)).astype(np.int64),
                "pitch_midi": rng.randint(48, 80, size=(1, n_phones)).astype(np.int64),
                "midi_dur": rng.uniform(0.05, 0.6, size=(1, n_phones)).astype(np.float32),
                "is_slur": (rng.rand(1, n_phones) < 0.1).astype(np.int64)}, t_mel

    batches = {"batch_8x1024": [request(1024 // SING_FRAMES_PER_PHONE, 1024) for _ in range(8)],
               "batch_2x4096": [request(4096 // SING_FRAMES_PER_PHONE, 4096) for _ in range(2)]}
    syn.warmup([1024], batch_sizes=(8,))
    syn.warmup([4096], batch_sizes=(2,))
    ds.diffnet_stack.launches = 0
    mrf.mrf_stage.launches = 0
    for name, reqs in batches.items():
        for wav in syn.synthesize_many(reqs):
            if wav.shape != (reqs[0][1] * SING_HOP,) or not np.isfinite(wav).all():
                raise AssertionError(f"serve_shipped singing {name}: bad waveform {wav.shape}")
    sing_launches = {"diffnet_stack": ds.diffnet_stack.launches,
                     "mrf_stage": mrf.mrf_stage.launches}
    if sing_launches != {"diffnet_stack": 2 * n_calls, "mrf_stage": 2 * 2}:
        raise AssertionError(f"serve_shipped singing: kernel launches {sing_launches}, "
                             f"expected {n_calls} stack and 2 MRF a batch")
    stack_ran(ds, "serve_shipped singing")
    checks = {name: sing_vs_plain(torch, ds, mrf, syn, reqs, seed=8 + i)
              for i, (name, reqs) in enumerate(batches.items())}
    singing = {"config": "configs/opencpop/ds1000.yaml as shipped (float32 stack, PLMS-25), "
                         "NSF-HiFiGAN 8/8/2, seeded weights",
               "denoiser_calls_per_batch": n_calls, "launches": sing_launches,
               "kernel_vs_plain": checks}
    print("serve_shipped_singing", json.dumps(singing), flush=True)
    for name, check in checks.items():
        sing_check_or_raise(f"serve_shipped singing {name}", check)
    out = {"card": card, "lj": lj, "singing": singing,
           "launches": {k: lj_launches[k] + sing_launches[k] for k in lj_launches}}
    return out


# -------------------------------------------------------------------- phase 5e
# the openvpi release's acoustic widths (benchmark/configs/ds512_44k_cpop.json):
# the float32 stack at C = 512, cycle 4, at a phrase, a mid batch and the
# longest full batch of the benchmark's cpop512_batch, each split the rule can
# take; the float32 MRF at C = 16, the 44.1 kHz vocoder's fifth scale, at a
# short batch and at the cell's longest (2 x 1152 frames x hop 512)
WIDE_CONFIG = ROOT / "benchmark" / "configs" / "ds512_44k_cpop.json"
# (B, T, dilation cycle): the cell's batches at cycle 4, and one at cycle 5,
# whose d = 16 halo only the four-way split holds
WIDE_STACK_SHAPES = ((1, 432, 4), (8, 640, 4), (16, 1152, 4), (1, 432, 5))
WIDE_MRF_CASES = [("float32", 16, 2, 4096), ("float32", 16, 2, 1152 * 512)]
WIDE_FRAMES_PER_PHONE = 17


def build_wide(torch, seed: int = 0):
    """``ds512_44k_cpop``'s hparams as the benchmark runs them, with seeded
    weights set as ``build_singer`` sets them (17 frames a phone)."""
    from diffsinger_tpu_torch.inference.serve import FusedSynthesizer

    hp = dict(json.loads(WIDE_CONFIG.read_text())["hparams"], seed=seed)
    task, voc, pe = seeded_singer(torch, hp, seed, WIDE_FRAMES_PER_PHONE)
    return hp, FusedSynthesizer(hp, task, voc, pe=pe)


def phase_wide(torch, ds, mrf, card: str):
    """The C = 512 stack against its plain twin at each split the card
    holds (the wgmma body), the float32 MRF at C = 16, and ds512_44k_cpop
    served once: one 8 x 640 batch, its launches (101 stack calls, every one
    on the wgmma body; one MRF call a scale of at most 128 channels), and the
    batch against the plain twins by the singing phases' criteria."""
    import numpy as np

    num_layers, c = 20, 512
    gen = torch.Generator(device="cuda").manual_seed(512)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    stack_rows = []
    for b, t, cycle in WIDE_STACK_SHAPES:
        dil = tuple(2 ** (i % cycle) for i in range(num_layers))
        resident = ds._resident(c, max(dil), torch.cuda.current_device())
        args = (torch.relu(rn(b, t, c)), rn(num_layers, b, c, scale=0.5),
                rn(num_layers, b, t, 2 * c, scale=0.5),
                rn(num_layers, 3, c, 2 * c, scale=(3 * c) ** -0.5),
                rn(num_layers, 2 * c, scale=0.1), rn(num_layers, c, 2 * c, scale=c ** -0.5),
                rn(num_layers, 2 * c, scale=0.1))
        x0_before = args[0].clone()
        want = ds.diffnet_stack_plain(*args, dilations=dil)
        scale = want.abs().max().item()
        tol = 1e-4 * max(scale, 1.0)   # the f32 stack's tolerance (phase 2)
        rule_k = ds.column_split(b, t, c, resident)
        for k in [j for j in ds.splits_for(c) if resident.get(j, 0) > 0]:
            what = f"wide stack {b} x {t} C=512 cycle {cycle} k={k}"
            with mock.patch.object(ds, "column_split", lambda *_, k=k: k):
                got = ds.diffnet_stack(*args, dilations=dil)
                ran = (ds.diffnet_stack.body, ds.diffnet_stack.device_launches,
                       ds.diffnet_stack.column_split)
                again = ds.diffnet_stack(*args, dilations=dil)
                ms = cuda_ms(lambda: ds.diffnet_stack(*args, dilations=dil), 3)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            row = dict(B=b, T=t, C=c, cycle=cycle, k=k, rule_k=rule_k, resident=resident,
                       ran=ran, max_abs_err=err, tolerance=tol, out_scale=scale, ms=ms,
                       tflops=num_layers * 8 * b * t * c * 2 * c / ms / 1e9)
            print("wide_stack", json.dumps(row), flush=True)
            if ran != ("wgmma", num_layers, k):
                raise AssertionError(f"{what}: ran (body, launches, split) {ran}")
            if not torch.equal(got, again) or not torch.equal(args[0], x0_before):
                raise AssertionError(f"{what}: repeat differs or x0 was written")
            if not err <= tol:
                raise AssertionError(f"{what}: max|err| {err} > {tol}")
            stack_rows.append(row)
        del args, want, got, again, x0_before
    mrf_rows = phase_mrf(torch, mrf, WIDE_MRF_CASES)

    hp, syn = build_wide(torch)
    n_calls = syn.task.gd.denoiser_calls()
    from diffsinger_tpu_torch.inference.svs import CPOP_PHONE_LIST

    vocab = len(CPOP_PHONE_LIST) + 3
    rng = np.random.RandomState(5)
    n_ph = 640 // WIDE_FRAMES_PER_PHONE
    reqs = [({"txt_tokens": rng.randint(3, vocab, size=(1, n_ph)).astype(np.int64),
              "pitch_midi": rng.randint(48, 77, size=(1, n_ph)).astype(np.int64),
              "midi_dur": np.full((1, n_ph), WIDE_FRAMES_PER_PHONE * syn.hop / 44100.0,
                                  np.float32),
              "is_slur": np.zeros((1, n_ph), np.int64)}, n_ph * WIDE_FRAMES_PER_PHONE)
            for _ in range(8)]
    syn.synthesize_many(reqs)   # warm
    ds.diffnet_stack.launches = 0
    ds.diffnet_stack.launches_by_body = {}
    mrf.mrf_stage.launches = 0
    wavs = syn.synthesize_many(reqs)
    launches = {"diffnet_stack": ds.diffnet_stack.launches, "mrf_stage": mrf.mrf_stage.launches,
                "diffnet_stack_by_body": dict(ds.diffnet_stack.launches_by_body)}
    if launches != {"diffnet_stack": n_calls, "mrf_stage": 4,
                    "diffnet_stack_by_body": {"wgmma": n_calls}} or n_calls != 101:
        raise AssertionError(f"wide serve: launches {launches}, expected 101 stack calls, all "
                             f"on the wgmma body, and 4 MRF (C = 128 / 64 / 32 / 16; "
                             f"{n_calls} denoiser calls)")
    stack_ran(ds, "wide serve")
    for wav in wavs:
        if wav.shape != (reqs[0][1] * syn.hop,) or not np.isfinite(wav).all():
            raise AssertionError(f"wide serve: bad waveform {wav.shape}")
    check = sing_vs_plain(torch, ds, mrf, syn, reqs, seed=6)
    serve = {"config": "benchmark/configs/ds512_44k_cpop.json (DiffNet 20 x 512, PLMS-100, "
                       "PE at 128 bins, NSF-HiFiGAN 44.1 kHz 8/8/2/2/2), seeded weights",
             "batch": "8 x 640", "launches": launches, **check}
    print("wide_serve", json.dumps(serve), flush=True)
    sing_check_or_raise("wide serve", check)
    return {"card": card, "stack": stack_rows, "mrf": mrf_rows, "serve": serve,
            "launches": launches}


# -------------------------------------------------------------------- phase 5d
def tf32_switches(torch):
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


def phase_shipped_matrix(torch, ds, mrf, card: str):
    """The two longest reverse loops of the shipped configs, as shipped, at
    full width from seeded weights: configs/lj/ds_pndm.yaml (DiffSpeech +
    PNDM: K = 1000 at speedup 10 from a Gaussian start, 101 float32 stack
    calls a batch; frame pitch, no pitch embedding; HiFiGAN v1 float32) and
    configs/opencpop/ds100_adj_rel.yaml (OpenCpop e2e: DDPM K = 100 on the
    linear schedule from a Gaussian start, 100 calls; MIDI + rel_pos, the PE's
    F0 into NSF-HiFiGAN 8/8/2). Both are built with TF32 switched on, and the
    entry points must leave it off, to the end of the phase. One warm 8 x 1024
    batch each: launches (exactly 101 / 100 stack, 3 / 2 MRF), and each batch
    against the plain twins by serve_shipped's criteria."""
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    hp, syn = build_synth(torch, config="lj/ds_pndm.yaml")
    hp_s, infer = build_singer(torch, stack_dtype=None, config="ds100_adj_rel.yaml")
    if tf32_switches(torch) != (False, False):
        raise AssertionError(f"shipped_matrix: TF32 (matmul, cuDNN) = "
                             f"{tf32_switches(torch)} after the entry points, expected off")
    sing = infer.fused
    if not (syn.task.compute_dtype is None and hp["pitch_type"] == "frame"
            and not hp["use_pitch_embed"] and syn.task.gd.denoiser_calls() == 101
            and hp["hidden_size"] == hp["residual_channels"] == 256
            and hp["residual_layers"] == 20):
        raise AssertionError("shipped_matrix: the LJ model is not ds_pndm.yaml as shipped")
    if not (sing.task.compute_dtype is None and sing.pe is not None and hp_s["pe_enable"]
            and sing.task.gd.denoiser_calls() == 100 and not sing.task.gd.cfg.pndm_speedup
            and sing.task.gd.cfg.schedule_type == "linear" and sing.hop == SING_HOP):
        raise AssertionError("shipped_matrix: the singing model is not ds100_adj_rel.yaml "
                             "as shipped")

    # --- LJ, ds_pndm.yaml
    rng = np.random.RandomState(5)
    big = [({"txt_tokens": rng.randint(3, 80, size=(1, 128)).astype(np.int64)}, 1024)
           for _ in range(8)]
    syn.warmup([1024], batch_sizes=(8,))
    ds.diffnet_stack.launches = 0
    mrf.mrf_stage.launches = 0
    wavs = syn.synthesize_many(big)
    lj_launches = {"diffnet_stack": ds.diffnet_stack.launches,
                   "mrf_stage": mrf.mrf_stage.launches}
    if lj_launches != {"diffnet_stack": 101, "mrf_stage": 3}:
        raise AssertionError(f"shipped_matrix ds_pndm: kernel launches {lj_launches}, "
                             f"expected 101 stack and 3 MRF")
    stack_ran(ds, "shipped_matrix ds_pndm")
    for wav in wavs:
        if wav.shape != (1024 * syn.hop,) or not np.isfinite(wav).all():
            raise AssertionError(f"shipped_matrix ds_pndm: bad waveform {wav.shape}")
    noise = torch.randn((1, 8, 1024, 80), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(9))
    wav_k = syn.synthesize_many(big, noises=[noise])
    with plain_twins(ds, mrf):
        wav_p = syn.synthesize_many(big, noises=[noise])
    a, b = np.concatenate(wav_k), np.concatenate(wav_p)
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        raise AssertionError("shipped_matrix ds_pndm: non-finite waveform in the "
                             "kernel/plain check")
    lj = {"config": "configs/lj/ds_pndm.yaml as shipped (PLMS, K 1000, speedup 10, "
                    "gaussian start, frame pitch, no pitch embedding, float32 stack, "
                    "HiFiGAN v1 float32), seeded weights",
          "denoiser_calls_per_batch": 101, "launches": lj_launches,
          "wav_max_abs": float(np.abs(a).max()),
          "kernel_vs_plain_wav_max_abs_diff": float(np.abs(a - b).max()),
          # serve_shipped's LJ criterion
          "kernel_vs_plain_wav_tolerance": 1e-4 * max(float(np.abs(b).max()), 1.0)}
    print("shipped_matrix_pndm", json.dumps(lj), flush=True)
    if not lj["kernel_vs_plain_wav_max_abs_diff"] <= lj["kernel_vs_plain_wav_tolerance"]:
        raise AssertionError(f"shipped_matrix ds_pndm: kernel and plain waveforms differ by "
                             f"{lj['kernel_vs_plain_wav_max_abs_diff']} > "
                             f"{lj['kernel_vs_plain_wav_tolerance']}")
    del syn, wav_k, wav_p, noise

    # --- singing, ds100_adj_rel.yaml (the vocoder geometry given)
    rng = np.random.RandomState(6)
    vocab = len(infer.ph_encoder)
    reqs = [({"txt_tokens": rng.randint(3, vocab, size=(1, 128)).astype(np.int64),
              "pitch_midi": rng.randint(48, 80, size=(1, 128)).astype(np.int64),
              "midi_dur": rng.uniform(0.05, 0.6, size=(1, 128)).astype(np.float32),
              "is_slur": (rng.rand(1, 128) < 0.1).astype(np.int64)}, 1024) for _ in range(8)]
    sing.warmup([1024], batch_sizes=(8,))
    ds.diffnet_stack.launches = 0
    mrf.mrf_stage.launches = 0
    wavs = sing.synthesize_many(reqs)
    sing_launches = {"diffnet_stack": ds.diffnet_stack.launches,
                     "mrf_stage": mrf.mrf_stage.launches}
    if sing_launches != {"diffnet_stack": 100, "mrf_stage": 2}:
        raise AssertionError(f"shipped_matrix ds100_adj_rel: kernel launches "
                             f"{sing_launches}, expected 100 stack and 2 MRF")
    stack_ran(ds, "shipped_matrix ds100_adj_rel")
    for wav in wavs:
        if wav.shape != (1024 * SING_HOP,) or not np.isfinite(wav).all():
            raise AssertionError(f"shipped_matrix ds100_adj_rel: bad waveform {wav.shape}")
    check = sing_vs_plain(torch, ds, mrf, sing, reqs, seed=10)
    singing = {"config": "configs/opencpop/ds100_adj_rel.yaml as shipped (DDPM K 100, "
                         "linear schedule, max_beta 0.06, gaussian start, cycle 4, float32 "
                         "stack, PE), NSF-HiFiGAN 8/8/2, seeded weights",
               "denoiser_calls_per_batch": 100, "launches": sing_launches,
               "kernel_vs_plain": check}
    print("shipped_matrix_adj_rel", json.dumps(singing), flush=True)
    sing_check_or_raise("shipped_matrix ds100_adj_rel", check)
    del infer, sing
    if tf32_switches(torch) != (False, False):
        raise AssertionError("shipped_matrix: TF32 left on")
    return {"card": card, "ds_pndm": lj, "ds100_adj_rel": singing,
            "launches": {k: lj_launches[k] + sing_launches[k] for k in lj_launches}}


# --------------------------------------------------------------------- phase 6
def train_stack_flops(b, t, c, h, num_layers):
    """Products of the training kernels: forward (taps, cond, out) and
    backward (recompute, dg, dW_dil + dK, dW_out, dcond, dy)."""
    rows = b * t
    fwd = num_layers * 2 * rows * ((3 * c + h) * 2 * c + c * 2 * c)
    bwd = num_layers * 2 * rows * (2 * (3 * c + h) * 2 * c + 2 * (2 * c * c) + 2 * c * h
                                   + 6 * c * c)
    return fwd, bwd


TRAIN_STACK_CASES = (
    # the training shapes (dtype, dilation cycle, B, T, H)
    [(dt, cycle, 24, 1024, 256) for dt in ("bfloat16", "float32") for cycle in (1, 4)]
    # B*T = 903 rows (not a multiple of the 64-row tile) with H=200, a width
    # the tensor-core kernels are not built for: the SIMT kernels take it
    + [("bfloat16", 4, 3, 301, 200), ("float32", 4, 3, 301, 200),
       # ragged row blocks on the tensor-core kernels; one batch row (one
       # slab of weight gradients); T below cycle 4's largest dilation (8)
       ("bfloat16", 4, 3, 301, 256), ("bfloat16", 1, 1, 1024, 256),
       ("bfloat16", 4, 2, 5, 256),
       # cycle 5: d = 16, the widest halo the tensor-core tiles hold in 227 KB
       ("bfloat16", 5, 2, 100, 256),
       # the same edges on the float32 tensor-core kernels
       ("float32", 4, 3, 301, 256), ("float32", 4, 2, 5, 256),
       ("float32", 5, 2, 100, 256),
       # the Opencpop training batch of ds1000.yaml (max_tokens 36,000) as
       # train_midi runs it: float32, cycle 4, 24 x 1500
       ("float32", 4, 24, 1500, 256)])


def phase_train_stack(torch, tr, cases=TRAIN_STACK_CASES):
    c, num_layers = 256, 20
    gen = torch.Generator(device="cuda").manual_seed(2)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    rows = []
    for dt_name, cycle, b, t, h in cases:
        dt = torch.bfloat16 if dt_name == "bfloat16" else None
        args = (torch.relu(rn(b, t, c)), rn(num_layers, b, c, scale=0.5), rn(b, t, h),
                rn(num_layers, h, 2 * c, scale=h ** -0.5), rn(num_layers, 2 * c, scale=0.1),
                rn(num_layers, 3, c, 2 * c, scale=(3 * c) ** -0.5),
                rn(num_layers, 2 * c, scale=0.1), rn(num_layers, c, 2 * c, scale=c ** -0.5),
                rn(num_layers, 2 * c, scale=0.1))
        ds = rn(b, t, c)
        dil = tuple(2 ** (i % cycle) for i in range(num_layers))
        kw = dict(dilations=dil, compute_dtype=dt)
        what = f"diffnet_train {dt_name} cycle {cycle} B={b} T={t} H={h}"
        x0_before = args[0].clone()
        skips, xs = tr.diffnet_train_fwd(*args, **kw)
        # counted by the library where it launches, and which kernels it ran
        fwd_launched = tr.diffnet_train_fwd.device_launches
        fwd_tc = tr.diffnet_train_fwd.ran_tensor_cores
        skips2, xs2 = tr.diffnet_train_fwd(*args, **kw)
        want_skips, want_xs = tr.diffnet_train_stack_fwd_plain(*args, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(skips, skips2) and torch.equal(xs, xs2)):
            raise AssertionError(f"{what}: two forward calls gave different bits")
        if not torch.equal(args[0], x0_before):
            raise AssertionError(f"{what}: the forward wrote x0")
        del skips2, xs2, x0_before
        # both backwards read the kernel's xs, so this compares the backward alone
        bwd_in = (xs, *args[1:8], ds)
        before = [a.clone() for a in bwd_in]
        got = tr.diffnet_train_bwd(*bwd_in, **kw)
        bwd_launched = tr.diffnet_train_bwd.device_launches
        bwd_tc = tr.diffnet_train_bwd.ran_tensor_cores
        again = tr.diffnet_train_bwd(*bwd_in, **kw)
        want = tr.diffnet_train_stack_bwd_plain(*bwd_in, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(g_, a_) for g_, a_ in zip(got, again)):
            raise AssertionError(f"{what}: two backward calls gave different bits")
        if not all(torch.equal(a_, b_) for a_, b_ in zip(bwd_in, before)):
            raise AssertionError(f"{what}: the backward wrote xs, ds or a weight")
        del again, before
        # f32: the same products summed in another order (up to 3C+H = 1024
        # terms per output, 24576 rows per weight gradient) through 20 layers
        # -> 1e-4 of each tensor's scale. bf16: both round at the same points,
        # but a float32 sum in another order can round y, g, dout or dconv one
        # bf16 step (2^-8) apart and carry it on -> 1e-2 of the scale.
        rel = 1e-2 if dt else 1e-4
        errs = {}
        for name, g_, w_ in (("skips", skips, want_skips), ("xs", xs, want_xs),
                             *zip(tr.GRAD_NAMES, got, want)):
            err = (g_.float() - w_.float()).abs().max().item()
            scale = w_.float().abs().max().item()
            errs[name] = {"max_abs_err": err, "scale": scale,
                          "tolerance": rel * max(scale, 1.0)}
        ms = cuda_ms(lambda: tr.diffnet_train_fwd(*args, **kw), 3)
        bwd_ms = cuda_ms(lambda: tr.diffnet_train_bwd(*bwd_in, **kw), 3)
        plain_ms = cuda_ms(lambda: tr.diffnet_train_stack_fwd_plain(*args, **kw), 2)
        plain_bwd_ms = cuda_ms(lambda: tr.diffnet_train_stack_bwd_plain(*bwd_in, **kw), 2)
        f_fwd, f_bwd = train_stack_flops(b, t, c, h, num_layers)
        esz = 2 if dt else 4
        w_bytes = sum(a.numel() for a in (args[2], args[3], args[5], args[7])) * esz
        f32_in = nbytes(args[0], args[1], args[4], args[6], args[8])
        xs_bytes = xs.numel() * esz
        # float32: the least time at float32 accuracy is three TF32 passes on
        # the tensor cores; the FMA bound beside it is what the SIMT kernels face
        peak = H100_BF16_FLOPS if dt else H100_3XTF32_FLOPS
        fwd_moved = w_bytes + f32_in + nbytes(skips) + xs_bytes
        bnd, by = bound_ms(f_fwd, fwd_moved, peak)
        grad_bytes = nbytes(*got)
        in_bytes = xs_bytes + w_bytes + nbytes(args[1], args[4], args[6]) + ds.numel() * esz
        bwd_bnd, bwd_by = bound_ms(f_bwd, in_bytes + grad_bytes, peak)
        # the library's own account of its tensor-core kernels for this shape
        info = tr.tensor_core_info(b, c, h, dil, dt)
        expect_tc = tr.takes_tensor_cores(c, h, dil, dt)
        if (info is not None) != expect_tc or fwd_tc != expect_tc or bwd_tc != expect_tc:
            raise AssertionError(f"{what}: the wrapper's rule says tensor cores={expect_tc}, "
                                 f"the library {info}, forward ran {fwd_tc}, backward {bwd_tc}")
        if info and max(info["smem"].values()) > 227 * 1024:
            raise AssertionError(f"{what}: shared memory {info['smem']} above 227 KB")
        if info and info["body"] != ("bf16" if dt else "3xtf32"):
            raise AssertionError(f"{what}: the library's body {info['body']} for {dt_name}")
        # tensor cores: one launch a layer forward, at most five backward
        if expect_tc and not (fwd_launched == num_layers and bwd_launched <= 5 * num_layers):
            raise AssertionError(f"{what}: {fwd_launched} forward and {bwd_launched} backward "
                                 f"launches for {num_layers} layers")
        row = dict(dtype=dt_name, cycle=cycle, B=b, T=t, H=h,
                   kernels="tensor-core" if fwd_tc and bwd_tc else "simt",
                   fwd_device_launches=fwd_launched, bwd_device_launches=bwd_launched,
                   tensor_core_info=info,
                   fwd_max_abs_err=max(errs[k]["max_abs_err"] for k in ("skips", "xs")),
                   bwd_max_abs_err=max(errs[k]["max_abs_err"] for k in tr.GRAD_NAMES),
                   errors=errs, fwd_ms=ms, bwd_ms=bwd_ms, fwd_tflops=f_fwd / ms / 1e9,
                   bwd_tflops=f_bwd / bwd_ms / 1e9, fwd_plain_ms=plain_ms,
                   bwd_plain_ms=plain_bwd_ms, fwd_gflop=f_fwd / 1e9, bwd_gflop=f_bwd / 1e9,
                   fwd_bound_ms=bnd, fwd_bound_by=by, bwd_bound_ms=bwd_bnd,
                   bwd_bound_by=bwd_by)
        if dt is None:
            row["fwd_bound_fma_ms"], _ = bound_ms(f_fwd, fwd_moved, H100_F32_FLOPS)
            row["bwd_bound_fma_ms"], _ = bound_ms(f_bwd, in_bytes + grad_bytes,
                                                  H100_F32_FLOPS)
        print("diffnet_train", json.dumps({k: v for k, v in row.items() if k != "errors"}),
              flush=True)
        bad = {k: e for k, e in errs.items() if not e["max_abs_err"] <= e["tolerance"]}
        if bad:
            raise AssertionError(f"{what}: {bad}")
        rows.append(row)
        del skips, xs, want_skips, want_xs, got, want, bwd_in
    return rows


# --------------------------------------------------------------------- phase 7
def synthetic_batch(rng, b: int, t_txt: int, t_mel: int, n_mels: int = 80):
    """The training batch of tools/bench_train.py: random phone durations of
    1 to t_mel // t_txt frames, the rest of the frames padding."""
    import numpy as np

    dur = rng.randint(1, max(2, t_mel // t_txt + 1), size=(b, t_txt))
    mel2ph = np.zeros((b, t_mel), np.int64)
    for i in range(b):
        pos = 0
        for j, d in enumerate(dur[i]):
            mel2ph[i, pos: pos + d] = j + 1
            pos += d
    return {
        "txt_tokens": rng.randint(3, 10, size=(b, t_txt)).astype(np.int64),
        "mels": (rng.randn(b, t_mel, n_mels) * 0.5 - 2.0).astype(np.float32),
        "mel2ph": mel2ph,
        "f0": rng.uniform(6, 9, size=(b, t_mel)).astype(np.float32),
        "uv": (rng.rand(b, t_mel) < 0.1).astype(np.float32),
        "energy": rng.uniform(0.1, 2.0, size=(b, t_mel)).astype(np.float32),
    }


def synthetic_cwt_batch(rng, b: int, t_txt: int, t_mel: int):
    """``synthetic_batch`` with cwt pitch targets: per row a voiced/unvoiced
    F0 contour (a vibrato around 110-250 Hz, 15% unvoiced frames), its uv,
    and its CWT spectrogram and log-F0 statistics from the port's
    ``get_f0cwt``."""
    import numpy as np

    from diffsinger_tpu_torch.data.binarize import collate_cwt, get_f0cwt

    batch = synthetic_batch(rng, b, t_txt, t_mel)
    items = []
    for i in range(b):
        f0 = rng.uniform(110, 250) * 2 ** (0.2 * np.sin(np.arange(t_mel)
                                                       / rng.uniform(3, 9)))
        f0[rng.rand(t_mel) < 0.15] = 0.0
        res = {}
        get_f0cwt(f0, res)
        items.append(res)
        batch["uv"][i] = (f0 == 0).astype(np.float32)
    batch.update(collate_cwt(items, t_mel))
    return batch


def build_trainer(torch, seed: int = 0, frame_pitch: bool = True,
                  compute_dtype: Optional[str] = "bfloat16"):
    from diffsinger_tpu_torch.config.hparams import set_hparams
    from diffsinger_tpu_torch.training.tasks import DiffSingerTask
    from diffsinger_tpu_torch.training.trainer import Trainer

    hp = set_hparams(str(ROOT / "configs" / "lj" / "ds_beta6.yaml"))
    # tools/bench_train.py's workload: DiffSpeech LJSpeech at its published
    # width with its training rates (fs2_ckpt stays set: FS2 is frozen but
    # for its predictors, and the missing checkpoint means seeded weights);
    # frame_pitch keeps its pitch_type override, else the config's cwt pitch;
    # compute_dtype None keeps the config's (none: the stack in float32). The
    # other values are the config's own.
    hp.update(hidden_size=256, enc_layers=4, dec_layers=4, residual_layers=20,
              residual_channels=256, timesteps=100, K_step=71, max_beta=0.06,
              schedule_type="linear", lr=0.001, decay_steps=50000,
              clip_grad_norm=1, dropout=0.1, predictor_dropout=0.5, seed=seed)
    if compute_dtype is not None:
        hp["compute_dtype"] = compute_dtype
    if frame_pitch:
        hp["pitch_type"] = "frame"
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        # token 3 stands for a silence phone, so the word-duration loss has words
        task = DiffSingerTask(hp, vocab_size=80, sil_ids=(3,))
    with torch.no_grad():
        # the DiffNet output projection is zero at init: give it weights so the
        # stack's backward carries gradients from the first step
        w = task.denoise_fn.output_projection.weight
        w.copy_(torch.randn(w.shape, generator=torch.Generator().manual_seed(seed)) * 0.05)
    trainer = Trainer(hp, task)  # default device: the card
    trainer.initialize()
    return hp, trainer


def _grad_agreement(got, want):
    """Worst cosine, worst max-error relative to each tensor's scale, and the
    index of the tensor with that error."""
    worst_cos, worst_rel, worst_at = 1.0, 0.0, None
    for i, (g_, w_) in enumerate(zip(got, want)):
        g_, w_ = g_.double().flatten(), w_.double().flatten()
        wn = w_.norm().item()
        if wn == 0.0:
            rel = g_.abs().max().item()
        else:
            worst_cos = min(worst_cos, (g_ @ w_).item() / (g_.norm().item() * wn))
            rel = ((g_ - w_).abs().max() / w_.abs().max()).item()
        if rel >= worst_rel:
            worst_rel, worst_at = rel, i
    return worst_cos, worst_rel, worst_at


def step_vs_plain(torch, tr, trainer, batch, k_step: int) -> dict:
    """One step's losses and gradients (same weights, t and noise, dropout
    off; no update is applied) with the kernels, and each kernel against its
    plain twin on the inputs the step gave it:
      * forward: the stack's inputs as the step passed them, the kernel's
        skips and xs against the forward twin's (``fwd_rel_err``: max error
        over max(scale, 1), the train_stack rule);
      * backward: the same step with the backward twin in place of the
        kernel and the kernel forward kept, so both backwards take the same
        xs and ds (``grad_*``: worst cosine, worst max error over each
        trainable parameter's scale, and that parameter);
      * losses: the step with both twins (``plain_losses``, ``loss_abs_diff``).
    That step's gradients are reported too (``all_plain_grad_*``), not
    judged: the forward twin's skips differ in the last bits, which flips
    the ReLU after the skip projection wherever its input is near 0, and a
    flipped row changes ds outright."""
    b, t_mel, n_mels = batch["mels"].shape
    gen = torch.Generator(device="cuda").manual_seed(7)
    t = torch.randint(0, k_step, (b,), generator=gen, device="cuda")
    noise = torch.randn((b, t_mel, n_mels), generator=gen, device="cuda")
    fwd, seen = tr.diffnet_train_fwd, []

    def record(*args, **kw):
        seen.append((args, kw))
        return fwd(*args, **kw)

    record.launches = 0  # the wrapper counts its launches on the module's name
    with mock.patch.object(tr, "diffnet_train_fwd", record):
        lk, gk = trainer.loss_and_grads(batch, t=t, noise=noise, deterministic=True)
    with mock.patch.object(tr, "diffnet_train_bwd", tr.diffnet_train_stack_bwd_plain):
        _, gb = trainer.loss_and_grads(batch, t=t, noise=noise, deterministic=True)
    with plain_twins(tr=tr):
        lp, gp = trainer.loss_and_grads(batch, t=t, noise=noise, deterministic=True)
    args, kw = seen[0]
    fwd_rel = {}
    for name, k_, p_ in zip(("skips", "xs"), fwd(*args, **kw),
                            tr.diffnet_train_stack_fwd_plain(*args, **kw)):
        fwd_rel[name] = ((k_.float() - p_.float()).abs().max()
                         / max(p_.float().abs().max().item(), 1.0)).item()
    torch.cuda.synchronize()
    names = [n for n, p in trainer.task.named_parameters() if p.requires_grad]
    cos, rel, at = _grad_agreement(gk, gb)
    cos_all, rel_all, at_all = _grad_agreement(gk, gp)
    return {"bf16": kw.get("compute_dtype") is not None,
            "losses": {k: float(v) for k, v in lk.items()},
            "plain_losses": {k: float(v) for k, v in lp.items()},
            "loss_abs_diff": {k: abs(float(lk[k]) - float(lp[k])) for k in lk},
            "fwd_rel_err": fwd_rel,
            "grad_worst_cos": cos, "grad_worst_rel": rel,
            "grad_worst_rel_param": names[at] if at is not None else None,
            "all_plain_grad_worst_cos": cos_all, "all_plain_grad_worst_rel": rel_all,
            "all_plain_grad_worst_rel_param": names[at_all] if at_all is not None else None}


def step_agrees(r: dict) -> bool:
    """bf16 stack: the FS2 terms run the same code on both sides; the mel
    loss differs only by bf16 roundings one step apart (1e-3 of its scale);
    the forward within 1e-2 of max(scale, 1) (the train_stack rule);
    gradients by the JAX package's bf16 criterion (cosine > 0.999, max error
    < 5% of each tensor's scale)."""
    bad = [k for k, d in r["loss_abs_diff"].items()
           if not d <= 1e-3 * max(abs(r["plain_losses"][k]), 1.0)]
    return (not bad and max(r["fwd_rel_err"].values()) <= 1e-2
            and r["grad_worst_cos"] > 0.999 and r["grad_worst_rel"] < 0.05)


# the optimizer steps a training phase takes after its checked first step:
# the fewest that still hold a step after an update
STEPS = 2


def run_steps(tr, trainer, batch, steps: int):
    """``steps`` optimizer steps (dropout on, draws from the trainer's
    generator), the training kernels' launches counted from zero (``tr``
    None: a task that runs none). Returns the launch readings and each step's
    losses."""
    fns = () if tr is None else (tr.diffnet_train_fwd, tr.diffnet_train_bwd)
    for fn in fns:
        fn.launches = 0
    history = [{k: float(v) for k, v in trainer.train_step(batch).items()}
               for _ in range(steps)]
    if not fns:
        return {}, history
    return {"launches": {fn.__name__: fn.launches for fn in fns},
            # the last step's kernels, as the library counted them where it launched
            "device_launches_last_step": {fn.__name__: fn.device_launches for fn in fns},
            "ran_tensor_cores": all(fn.ran_tensor_cores for fn in fns)}, history


def phase_train(torch, tr, card: str, cwt: bool = False):
    """Frame pitch, or with ``cwt`` the config's own cwt pitch: the first
    step against the plain twins, then two steps."""
    import numpy as np

    hp, trainer = build_trainer(torch, frame_pitch=not cwt)
    b, t_txt, t_mel = 24, 128, 1024
    make = synthetic_cwt_batch if cwt else synthetic_batch
    batch = trainer.prepare_batch(make(np.random.RandomState(0), b, t_txt, t_mel))
    # the first step, kernels vs plain twins
    vs_plain = step_vs_plain(torch, tr, trainer, batch, int(hp["K_step"]))
    want_terms = {"mel", "pdur", "wdur", "sdur"} | (
        {"C", "uv", "f0_mean", "f0_std"} if cwt else {"uv", "f0"})
    if not want_terms <= set(vs_plain["losses"]):
        raise AssertionError(f"training loss terms {sorted(vs_plain['losses'])}, expected "
                             f"{sorted(want_terms)}")

    ran, history = run_steps(tr, trainer, batch, STEPS)
    launches, ran_tc = ran["launches"], ran["ran_tensor_cores"]
    out = {
        "card": card, "pitch_type": hp["pitch_type"], "steps": STEPS, "B": b,
        "T_mel": t_mel, "T_txt": t_txt, **ran,
        "trainable_params": sum(p.numel() for p in trainer.params),
        "first_loss": history[0], "last_loss": history[-1], "kernel_vs_plain": vs_plain,
    }
    print("train_cwt" if cwt else "train", json.dumps(out), flush=True)
    if launches != {"diffnet_train_fwd": STEPS, "diffnet_train_bwd": STEPS}:
        raise AssertionError(f"training kernel launches {launches}, expected {STEPS} each")
    if not ran_tc:
        raise AssertionError("the training step did not run the tensor-core kernels")
    if not all(np.isfinite(v) for h in history for v in h.values()):
        raise AssertionError(f"non-finite training losses: {history}")
    if not step_agrees(vs_plain):
        raise AssertionError(f"train step kernel vs plain: {vs_plain}")
    return out


def step_agrees_f32(r: dict) -> bool:
    """Float32 on both sides: the stack kernels hold the twins to 1e-4 of each
    tensor's scale (3xTF32 keeps a product to ~2^-21; sums in another order
    over 20 layers), and everything around the stack is the same float32
    code. So each loss term within 1e-4 of its scale, the forward within
    1e-4 of max(scale, 1) (the train_stack rule), gradient cosine above
    0.99999, and each gradient's max error below 1e-3 of its scale (a weight
    gradient sums 24,576 rows in another order)."""
    bad = [k for k, d in r["loss_abs_diff"].items()
           if not d <= 1e-4 * max(abs(r["plain_losses"][k]), 1.0)]
    return (not bad and max(r["fwd_rel_err"].values()) <= 1e-4
            and r["grad_worst_cos"] > 0.99999 and r["grad_worst_rel"] < 1e-3)


# -------------------------------------------------------------------- phase 7b
def phase_train_shipped(torch, tr, card: str):
    """The training step of configs/lj/ds_beta6.yaml as shipped (cwt pitch, no
    compute_dtype: the float32 stack) on the synthetic cwt batch at 24 x
    1024: the first step against the plain twins by its float32 criterion,
    then two steps, with launches and the library's body checked."""
    import numpy as np

    num_layers = 20
    hp, trainer = build_trainer(torch, frame_pitch=False, compute_dtype=None)
    if hp.get("compute_dtype") is not None or trainer.task.compute_dtype is not None:
        raise AssertionError(f"ds_beta6.yaml as shipped has compute_dtype "
                             f"{hp.get('compute_dtype')}; the task runs "
                             f"{trainer.task.compute_dtype}")
    b, t_txt, t_mel = 24, 128, 1024
    batch = trainer.prepare_batch(synthetic_cwt_batch(np.random.RandomState(0), b, t_txt,
                                                      t_mel))
    vs_plain = step_vs_plain(torch, tr, trainer, batch, int(hp["K_step"]))
    ran, history = run_steps(tr, trainer, batch, STEPS)
    dil = tuple(trainer.task.denoise_fn.dilations)
    out = {
        "card": card, "config": "configs/lj/ds_beta6.yaml", "pitch_type": hp["pitch_type"],
        "compute_dtype": hp.get("compute_dtype"), "steps": STEPS, "B": b, "T_mel": t_mel,
        "T_txt": t_txt, **ran,
        "tensor_core_info": tr.tensor_core_info(b, 256, 256, dil, None),
        "first_loss": history[0], "last_loss": history[-1], "kernel_vs_plain": vs_plain,
    }
    print("train_shipped", json.dumps(out), flush=True)
    want_terms = {"mel", "pdur", "wdur", "sdur", "C", "uv", "f0_mean", "f0_std"}
    if not want_terms <= set(out["first_loss"]):
        raise AssertionError(f"shipped training loss terms {sorted(out['first_loss'])}, "
                             f"expected {sorted(want_terms)}")
    if out["launches"] != {"diffnet_train_fwd": STEPS, "diffnet_train_bwd": STEPS}:
        raise AssertionError(f"shipped training launches {out['launches']}, "
                             f"expected {STEPS} each")
    dev = out["device_launches_last_step"]
    if not (dev["diffnet_train_fwd"] == num_layers
            and dev["diffnet_train_bwd"] <= 5 * num_layers and out["ran_tensor_cores"]):
        raise AssertionError(f"shipped training step ran tensor cores "
                             f"{out['ran_tensor_cores']} with device launches {dev}")
    info = out["tensor_core_info"]
    if not info or info["body"] != "3xtf32" or max(info["smem"].values()) > 227 * 1024:
        raise AssertionError(f"the library's account of the shipped step: {info}")
    if not all(np.isfinite(v) for h in history for v in h.values()):
        raise AssertionError(f"non-finite shipped training losses: {history}")
    if not step_agrees_f32(out["kernel_vs_plain"]):
        raise AssertionError(f"shipped train step kernel vs plain: {out['kernel_vs_plain']}")
    return out


# -------------------------------------------------------------------- phase 7d
def cpop_vocab() -> int:
    """The Opencpop phone set plus the encoder's specials (build_singer's)."""
    from diffsinger_tpu_torch.inference.svs import CPOP_PHONE_LIST

    return len(CPOP_PHONE_LIST) + 3


def synthetic_midi_batch(rng, b: int, t_txt: int, t_mel: int, vocab: int):
    """One Opencpop training batch: ``t_txt`` phones of ``t_mel // t_txt``
    frames each, a word boundary every 2-3 phones, one MIDI note (48-72) a
    word with its length in seconds at hop 128 / 24 kHz, ~20% slurs, log2-F0
    around each note with a vibrato and ~10% unvoiced frames (F0 0 there)."""
    import numpy as np

    per = t_mel // t_txt
    mel2ph = np.repeat(np.arange(1, t_txt + 1), per)[None].repeat(b, 0).astype(np.int64)
    wb = np.zeros((b, t_txt), np.int64)
    note = np.zeros((b, t_txt), np.int64)
    note_s = np.zeros((b, t_txt), np.float32)
    for i in range(b):
        start = 0
        while start < t_txt:
            end = min(start + int(rng.randint(2, 4)), t_txt)
            wb[i, end - 1] = 1
            note[i, start:end] = rng.randint(48, 73)
            note_s[i, start:end] = (end - start) * per * 128 / 24000
            start = end
    hz = 440.0 * 2 ** ((np.repeat(note, per, axis=1) - 69) / 12)
    hz = hz * 2 ** (0.02 * np.sin(np.arange(t_mel) / 5.0))[None]
    uv = rng.rand(b, t_mel) < 0.1
    return {
        "txt_tokens": rng.randint(3, vocab, size=(b, t_txt)).astype(np.int64),
        "mels": (rng.randn(b, t_mel, 80) * 0.5 - 2.0).astype(np.float32),
        "mel2ph": mel2ph,
        "f0": np.where(uv, 0.0, np.log2(hz)).astype(np.float32),
        "uv": uv.astype(np.float32),
        "energy": rng.uniform(0.1, 2.0, size=(b, t_mel)).astype(np.float32),
        "pitch_midi": note, "midi_dur": note_s,
        "is_slur": (rng.rand(b, t_txt) < 0.2).astype(np.int64),
        "word_boundary": wb,
    }


def build_task_trainer(torch, config: str, vocab: int, seed: int = 0,
                       work_dir: Optional[str] = None, **over):
    """A shipped config through ``build_task`` (its own ``task_cls``) and a
    Trainer on the card, seeded; ``over`` overrides hparams. A diffusion
    task's DiffNet output projection gets weights (it is zero at init)."""
    from diffsinger_tpu_torch.config.hparams import set_hparams
    from diffsinger_tpu_torch.training.tasks import build_task
    from diffsinger_tpu_torch.training.trainer import Trainer

    hp = set_hparams(str(ROOT / config))
    hp.update(seed=seed, **over)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        task = build_task(hp, vocab_size=vocab)  # default device: the card
    if getattr(task, "denoise_fn", None) is not None:
        with torch.no_grad():
            w = task.denoise_fn.output_projection.weight
            w.copy_(torch.randn(w.shape, generator=torch.Generator().manual_seed(seed)) * 0.05)
    trainer = Trainer(hp, task, work_dir=work_dir)
    trainer.initialize()
    return hp, trainer


def _grad_rel(gk, gw, names):
    """{parameter: max error relative to the reference tensor's scale}."""
    out = {}
    for n, a, w in zip(names, gk, gw):
        a, w = a.double().cpu(), w.double().cpu()
        scale = float(w.abs().max())
        out[n] = float((a - w).abs().max()) / scale if scale else float(a.abs().max())
    return out


def _worst(rel):
    n = max(rel, key=rel.get)
    return rel[n], n


def card_vs_cpu_step(torch, hp, trainer, batch, vocab: int, rows: int = 4, draws=None,
                     judged=None):
    """One deterministic step's losses and gradients (no update) on the card
    against the same step on the CPU in float64, same weights, on the
    batch's first ``rows`` rows. The CPU also evaluates the step in float32:
    ``d32[n]`` is how far that faithful float32 evaluation sits from float64
    for parameter n (up to ~1e-2 of the scale at some predictors' layer
    norms). A card gradient within 1e-3 of its scale of a float32
    evaluation on the CPU lies within ``1e-3 + d32[n]`` of float64 (triangle
    inequality); that is parameter n's limit, so ``excess[n]`` = card vs
    float64 minus ``d32[n]`` is held to 1e-3. ``draws`` = (t, noise) fixes a
    diffusion task's draws on both sides; ``judged(name)`` picks the
    parameters whose excess is judged (the others' worst is reported).
    Returns the losses' relative difference from float64 and the gradient
    readings."""
    from diffsinger_tpu_torch.training import tasks
    from diffsinger_tpu_torch.training.trainer import Trainer

    def fixed(device, dtype):
        if draws is None:
            return {}
        return {"t": draws[0].to(device), "noise": draws[1].to(device, dtype)}

    sub = {k: v[:rows] for k, v in batch.items()}
    lk, gk = trainer.loss_and_grads(sub, deterministic=True,
                                    **fixed(trainer.device, torch.float32))
    names = [n for n, p in trainer.task.named_parameters() if p.requires_grad]
    state = {k: v.cpu() for k, v in trainer.task.state_dict().items()}
    host = {k: v.cpu() for k, v in sub.items()}
    as_tensor = tasks._as_tensor

    def cpu_step(dtype):
        task = tasks.build_task(hp, vocab_size=vocab, device="cpu",
                                sil_ids=trainer.task.sil_ids)
        task.load_state_dict(state)
        task.to(dtype)
        cpu = Trainer(hp, task, device="cpu")
        cpu.initialize()
        # the task casts float inputs to float32: to ``dtype`` here
        with mock.patch.object(tasks, "_as_tensor", lambda v, dt, dev: as_tensor(
                v, dtype if dt == torch.float32 else dt, dev)):
            return cpu.loss_and_grads(host, deterministic=True, **fixed("cpu", dtype))

    l64, g64 = cpu_step(torch.float64)
    _, g32 = cpu_step(torch.float32)
    loss_rel = {k: abs(float(lk[k]) - float(l64[k])) / max(abs(float(l64[k])), 1e-12)
                for k in l64}
    vs64, d32 = _grad_rel(gk, g64, names), _grad_rel(g32, g64, names)
    excess = {n: vs64[n] - d32[n] for n in names}
    at = max((n for n in names if judged is None or judged(n)), key=excess.get)
    out = {"loss_rel": loss_rel, "grad_excess_worst": [excess[at], at],
           "grad_vs_cpu64_there": vs64[at], "cpu32_vs_cpu64_there": d32[at],
           "grad_worst_vs_cpu64": _worst(vs64), "cpu32_vs_cpu64_grad_worst": _worst(d32)}
    if judged is not None:
        out["grad_excess_worst_not_judged"] = _worst({n: excess[n] for n in names
                                                      if not judged(n)})
    return out


FS2_TRAIN_CASES = (  # config, B, phones, frames, batch kind
    ("configs/lj/fs2.yaml", 24, 128, 1024, "cwt"),
    ("configs/opencpop/aux_rel.yaml", 24, 150, 1500, "midi"),
)
FS2_LOSS_TERMS = {"cwt": {"l1", "pdur", "wdur", "sdur", "C", "uv", "f0_mean", "f0_std"},
                  "midi": {"ssim", "l1", "pdur", "wdur", "sdur", "uv", "f0"}}


def phase_train_fs2(torch, card: str, out_dir: Path):
    """FastSpeech2 training as the shipped FS2 configs run it: lj/fs2.yaml
    (cwt pitch, mel_loss l1) at 24 x 1024 and opencpop/aux_rel.yaml (MIDI,
    rel_pos, mel_loss ssim:0.5|l1:0.5) at 24 x 1500; one deterministic step
    against the same step on the CPU in float64 (``card_vs_cpu_step``), then
    two steps; the aux_rel run is saved for train_midi's warm start."""
    import numpy as np

    out = {}
    for config, b, t_txt, t_mel, kind in FS2_TRAIN_CASES:
        name = Path(config).parent.name + "_" + Path(config).stem
        vocab = 80 if kind == "cwt" else cpop_vocab()
        hp, trainer = build_task_trainer(torch, config, vocab,
                                         work_dir=str(out_dir / "train_fs2" / name))
        if type(trainer.task).__name__ != "FastSpeech2Task":
            raise AssertionError(f"train_fs2: {config} built {type(trainer.task).__name__}")
        rng = np.random.RandomState(0)
        host = (synthetic_cwt_batch(rng, b, t_txt, t_mel) if kind == "cwt"
                else synthetic_midi_batch(rng, b, t_txt, t_mel, vocab))
        batch = trainer.prepare_batch(host)
        vs_cpu = card_vs_cpu_step(torch, hp, trainer, batch, vocab)
        loss_rel, (grad_excess, _) = vs_cpu["loss_rel"], vs_cpu["grad_excess_worst"]
        _, history = run_steps(None, trainer, batch, STEPS)
        row = {"card": card, "config": config, "task": type(trainer.task).__name__,
               "mel_loss": hp.get("mel_loss"), "pitch_type": hp.get("pitch_type"),
               "B": b, "T_txt": t_txt, "T_mel": t_mel, "steps": STEPS,
               "trainable_params": sum(p.numel() for p in trainer.params),
               "first_loss": history[0], "last_loss": history[-1],
               "card_vs_cpu_rows": 4, "card_vs_cpu": vs_cpu}
        if kind == "midi":
            row["checkpoint"] = trainer.save_checkpoint()
        print("train_fs2", json.dumps(row), flush=True)
        if set(history[0]) != FS2_LOSS_TERMS[kind] | {"total_loss", "grad_norm"}:
            raise AssertionError(f"train_fs2 {config}: loss terms {sorted(history[0])}, "
                                 f"expected JAX's {sorted(FS2_LOSS_TERMS[kind])}")
        if not all(np.isfinite(v) for h in history for v in h.values()):
            raise AssertionError(f"train_fs2 {config}: non-finite losses {history}")
        if not (max(loss_rel.values()) <= 1e-4 and grad_excess <= 1e-3):
            raise AssertionError(f"train_fs2 {config}: card vs CPU: {vs_cpu}")
        out[name] = row
        del trainer, batch
    return out


# -------------------------------------------------------------------- phase 7e
def phase_train_midi(torch, tr, card: str, fs2_ckpt: str):
    """The Opencpop diffusion configs' training. ds1000.yaml as shipped (the
    float32 stack on the 3xTF32 training kernels, cycle 4, MIDI + rel_pos,
    no pitch embedding) at 24 x 1500: the first step against the plain twins
    by the float32 criterion, then two steps, launches and the library's
    report. Then ds60_rel.yaml (the MIDI cascade, pitch embedding and F0
    losses) on the same batch for four steps, warm-started from train_fs2's
    aux_rel FS2, with switch_midi2f0_step 2: ground-truth F0 while
    global_step <= 2."""
    import numpy as np

    num_layers, b, t_txt, t_mel = 20, 24, 150, 1500
    vocab = cpop_vocab()
    hp, trainer = build_task_trainer(torch, "configs/opencpop/ds1000.yaml", vocab)
    task = trainer.task
    if not (hp.get("compute_dtype") is None and task.compute_dtype is None and task.use_midi
            and task.fs2.cfg.rel_pos and tuple(task.denoise_fn.dilations)[:4] == (1, 2, 4, 8)):
        raise AssertionError("train_midi: ds1000.yaml did not build its float32 cycle-4 "
                             "MIDI task")
    batch = trainer.prepare_batch(synthetic_midi_batch(np.random.RandomState(0), b, t_txt,
                                                       t_mel, vocab))
    vs_plain = step_vs_plain(torch, tr, trainer, batch, int(hp["K_step"]))
    ran, history = run_steps(tr, trainer, batch, STEPS)
    dil = tuple(task.denoise_fn.dilations)
    ds1000 = {
        "card": card, "config": "configs/opencpop/ds1000.yaml", "compute_dtype": None,
        "cycle": 4, "B": b, "T_txt": t_txt, "T_mel": t_mel, "steps": STEPS, **ran,
        "tensor_core_info": tr.tensor_core_info(b, 256, 256, dil, None),
        "first_loss": history[0], "last_loss": history[-1], "kernel_vs_plain": vs_plain,
    }
    print("train_midi", json.dumps(ds1000), flush=True)
    if set(history[0]) != {"mel", "pdur", "wdur", "sdur", "total_loss", "grad_norm"}:
        raise AssertionError(f"train_midi: ds1000 loss terms {sorted(history[0])}")
    if ds1000["launches"] != {"diffnet_train_fwd": STEPS, "diffnet_train_bwd": STEPS}:
        raise AssertionError(f"train_midi: launches {ds1000['launches']}, expected {STEPS} each")
    dev = ds1000["device_launches_last_step"]
    info = ds1000["tensor_core_info"]
    if not (dev == {"diffnet_train_fwd": num_layers, "diffnet_train_bwd": 4 * num_layers}
            and ds1000["ran_tensor_cores"] and info and info["body"] == "3xtf32"):
        raise AssertionError(f"train_midi: device launches {dev}, tensor cores "
                             f"{ds1000['ran_tensor_cores']}, library {info}")
    if not all(np.isfinite(v) for h in history for v in h.values()):
        raise AssertionError(f"train_midi: non-finite losses {history}")
    if not step_agrees_f32(vs_plain):
        raise AssertionError(f"train_midi: kernel vs plain {vs_plain}")
    del trainer, task

    # ds60_rel.yaml: the cascade, warm-started and with the F0 switch
    switch, n2 = 2, 4
    with _Tee() as tee:
        hp2, trainer2 = build_task_trainer(torch, "configs/opencpop/ds60_rel.yaml", vocab,
                                           fs2_ckpt=fs2_ckpt, switch_midi2f0_step=switch)
    n_fs2 = len(trainer2.task.fs2.state_dict())
    warm = [ln for ln in tee.text.splitlines() if "warm-started fs2" in ln]
    frozen = not any(n.startswith("fs2.") for n, p in trainer2.task.named_parameters()
                     if p.requires_grad)
    ran2, history2 = run_steps(tr, trainer2, batch, n2)
    ds60 = {"card": card, "config": "configs/opencpop/ds60_rel.yaml",
            "overrides": {"fs2_ckpt": fs2_ckpt, "switch_midi2f0_step": switch},
            "warm_start_line": warm, "fs2_tensors": n_fs2, "fs2_frozen": frozen,
            "gt_f0_log": trainer2.gt_f0_log, "steps": n2, **ran2,
            "losses": history2}
    print("train_midi_cascade", json.dumps(ds60), flush=True)
    if not (warm and warm[-1].endswith(f"({n_fs2} tensors)") and frozen):
        raise AssertionError(f"train_midi: ds60_rel warm start {warm} of {n_fs2} FS2 tensors, "
                             f"FS2 frozen {frozen}")
    want_log = [(0, True), (switch + 1, False)]
    if [tuple(x) for x in trainer2.gt_f0_log] != want_log:
        raise AssertionError(f"train_midi: F0 record {trainer2.gt_f0_log}, expected {want_log}")
    if set(history2[0]) != {"mel", "pdur", "wdur", "sdur", "uv", "f0", "total_loss",
                            "grad_norm"} or not all(np.isfinite(v) for h in history2
                                                    for v in h.values()):
        raise AssertionError(f"train_midi: ds60_rel losses {history2}")
    if ran2["launches"] != {"diffnet_train_fwd": n2, "diffnet_train_bwd": n2}:
        raise AssertionError(f"train_midi: ds60_rel launches {ran2['launches']}")
    return {"ds1000": ds1000, "ds60_rel": ds60,
            "launches": {k: ds1000["launches"][k] + ran2["launches"][k]
                         for k in ds1000["launches"]}}


# -------------------------------------------------------------------- phase 7f
def pe_stats_host(torch, pe_state, mels, unbiased: bool = False):
    """Flax's BatchNorm rule recomputed on the host in float64 from the
    weights before the step: each prenet layer's conv and ReLU, statistics
    over every frame (padding included), the biased variance (``unbiased``:
    torch's, the control), momentum 0.99; the next layer reads the
    batch-normalized, masked output."""
    import torch.nn.functional as F

    x = mels.double().cpu()
    nonpad = (x.abs().sum(-1) != 0).double()[:, :, None]
    out = {}
    for i in range(3):
        key = f"mel_prenet.layers.{i}."
        w, bias = pe_state[key + "0.weight"].double(), pe_state[key + "0.bias"].double()
        h = torch.relu(F.conv1d(x.transpose(1, 2), w, bias, padding=w.shape[-1] // 2))
        h = h.transpose(1, 2)
        mean = h.mean((0, 1))
        var = h.var((0, 1), unbiased=unbiased)
        out[key + "2.running_mean"] = 0.99 * pe_state[key + "2.running_mean"].double() \
            + 0.01 * mean
        out[key + "2.running_var"] = 0.99 * pe_state[key + "2.running_var"].double() \
            + 0.01 * var
        h = (h - mean) / torch.sqrt(var + 1e-5) * pe_state[key + "2.weight"].double() \
            + pe_state[key + "2.bias"].double()
        x = h * nonpad
    return out


def phase_train_pe(torch, card: str):
    """configs/opencpop/pe.yaml as shipped (PitchExtractionTask) at 16 x 2000
    frames (its max_tokens 32000), rows padded at their tails: the first
    step's new running statistics against the host recomputation of flax's
    rule, with the unbiased-variance recomputation as the control the check
    must reject, then two steps."""
    import numpy as np

    b, t = 16, 2000
    hp, trainer = build_task_trainer(torch, "configs/opencpop/pe.yaml", 0)
    if type(trainer.task).__name__ != "PitchExtractionTask":
        raise AssertionError(f"train_pe: pe.yaml built {type(trainer.task).__name__}")
    rng = np.random.RandomState(0)
    lengths = rng.randint(1500, t + 1, size=b)
    lengths[0] = t
    mels = (rng.randn(b, t, 80) * 0.5 - 2.0).astype(np.float32)
    mel2ph = np.zeros((b, t), np.int64)
    for i, n in enumerate(lengths):
        mels[i, n:] = 0.0
        mel2ph[i, :n] = np.arange(n) // 10 + 1
    uv = rng.rand(b, t) < 0.1
    f0 = np.where(uv, 0.0, rng.uniform(7.0, 9.0, size=(b, 1)) + 0.05 * np.sin(
        np.arange(t) / 7.0)[None]).astype(np.float32)
    batch = trainer.prepare_batch({"mels": mels, "mel2ph": mel2ph, "f0": f0,
                                   "uv": uv.astype(np.float32)})
    pe = trainer.task.pe
    before = {k: v.detach().cpu().clone() for k, v in pe.state_dict().items()}
    want = pe_stats_host(torch, before, batch["mels"])
    control = pe_stats_host(torch, before, batch["mels"], unbiased=True)
    trainer.train_step(batch)  # the first step

    def rel_err(got):
        return {k: float((got[k] - w).abs().max()) / max(float(w.abs().max()), 1.0)
                for k, w in want.items()}

    stats_err = rel_err({k: pe.get_buffer(k).double().cpu() for k in want})
    control_err = rel_err(control)
    # float32 statistics (E[x^2] - E[x]^2 over 32,000 frames) stored near 1,
    # where half a float32 step is 3e-8 to 6e-8 (read 4.0e-8 on an H100);
    # torch's unbiased variance moves running_var by 0.01 * var / (N - 1),
    # ~5e-7 at the first layer (var ~2), which the limit must catch
    limit = 1e-7
    moved = all(not torch.equal(pe.get_buffer(k).cpu(), before[k]) for k in want)
    _, history = run_steps(None, trainer, batch, STEPS)
    out = {"card": card, "config": "configs/opencpop/pe.yaml", "B": b, "T_mel": t,
           "frames_real": int(lengths.sum()), "steps": STEPS,
           "trainable_params": sum(p.numel() for p in trainer.params),
           "first_step_stats_rel_err": stats_err, "stats_limit": limit,
           "unbiased_control_rel_err": control_err, "first_loss": history[0],
           "last_loss": history[-1]}
    print("train_pe", json.dumps(out), flush=True)
    if not max(control_err.values()) > limit:
        raise AssertionError(f"train_pe: the unbiased-variance control {control_err} passes "
                             f"the limit {limit}; the check cannot tell the two rules apart")
    if not (moved and max(stats_err.values()) <= limit):
        raise AssertionError(f"train_pe: running statistics vs flax's rule {stats_err}, "
                             f"moved {moved}")
    if set(history[0]) != {"f0", "uv", "total_loss", "grad_norm"} or not all(
            np.isfinite(v) for h in history for v in h.values()):
        raise AssertionError(f"train_pe: losses {history}")
    return out



# -------------------------------------------------------------------- phase 7c
CLI_ITEMS, CLI_TEST, CLI_VALID, CLI_STEPS, CLI_RESUME_STEPS = 64, 4, 4, 20, 30
# HiFiGAN v1 (hop 256) as the vocoder directory's config.yaml gives it; not
# an NSF vocoder, though the acoustic config embeds pitch
CLI_VOCODER = dict(resblock="1", upsample_rates=[8, 8, 2, 2], upsample_kernel_sizes=[16, 16, 4, 4],
                   upsample_initial_channel=512, resblock_kernel_sizes=[3, 7, 11],
                   resblock_dilation_sizes=[[1, 3, 5], [1, 3, 5], [1, 3, 5]],
                   audio_sample_rate=22050, audio_num_mel_bins=80, hop_size=256,
                   use_pitch_embed=False, use_nsf=False)


def _cli_corpus(root: Path) -> Path:
    """The raw corpus and the run's config (ds_beta6.yaml and the paths)."""
    import yaml

    from diffsinger_tpu_torch.tools import fixtures

    fixtures.write_lj_corpus(str(root / "raw"), str(root / "processed"), CLI_ITEMS, seed=0)
    cfg = {"base_config": [str(ROOT / "configs" / "lj" / "ds_beta6.yaml")],
           "raw_data_dir": str(root / "raw"), "processed_data_dir": str(root / "processed"),
           "binary_data_dir": str(root / "binary"), "test_num": CLI_TEST,
           "valid_num": CLI_VALID, "num_test_samples": 0, "test_ids": [],
           # tools/bench_train.py's bf16 stack; a 30-step duration predictor is
           # no product, so --infer takes ground-truth durations and F0
           "compute_dtype": "bfloat16", "max_updates": CLI_STEPS, "val_check_interval": 10,
           "num_sanity_val_steps": 1, "log_interval": 5, "use_gt_dur": True,
           "use_gt_f0": True, "profile_infer": True,
           "fs2_ckpt": str(root / "fs2_start"), "vocoder_ckpt": str(root / "hifigan")}
    path = root / "cli.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def _cli_start_ckpts(torch, root: Path, cfg_path: Path):
    """A seeded FS2 (model_ckpt_steps_0.ckpt, keys under model.) for
    fs2_ckpt and a seeded HiFiGAN v1 directory (config.yaml, weight-norm
    pairs) for vocoder_ckpt, both in upstream's layout."""
    import torch.nn as nn

    from diffsinger_tpu_torch.config.hparams import set_hparams
    from diffsinger_tpu_torch.models.hifigan import HifiGanConfig, HifiGanGenerator
    from diffsinger_tpu_torch.tools import fixtures
    from diffsinger_tpu_torch.training.tasks import DiffSingerTask
    from diffsinger_tpu_torch.utils.text_encoder import build_phone_encoder

    hp = set_hparams(str(cfg_path))
    vocab = len(build_phone_encoder(hp["binary_data_dir"]))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        fs2 = DiffSingerTask(hp, vocab_size=vocab, device="cpu").fs2
        gen = HifiGanGenerator(HifiGanConfig.from_hparams(CLI_VOCODER))
        with torch.no_grad():
            for m in gen.modules():  # torch's default scale, as build_synth
                if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
                    m.reset_parameters()
    fs2_path = fixtures.write_task_ckpt(str(root / "fs2_start"), fs2.state_dict(), step=0)
    voc_path = fixtures.write_hifigan_dir(str(root / "hifigan"), gen.state_dict(), CLI_VOCODER)
    return fs2_path, voc_path


class _Tee:
    """Copies what is printed to stdout while it is active."""

    def __enter__(self):
        self.out, self.parts = sys.stdout, []
        sys.stdout = self
        return self

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def __exit__(self, *exc):
        sys.stdout = self.out

    @property
    def text(self) -> str:
        return "".join(self.parts)


def fit_batches_vs_plain(torch, tr, trainer, hp, agrees):
    """The training kernels at a CLI run's own shapes against their plain
    twins (``step_vs_plain``): the dataset's largest training batch and a
    validation batch (fit's eval batching: max_eval_sentences utterances),
    each judged by ``agrees``. Returns the readings."""
    import numpy as np

    from diffsinger_tpu_torch.data.dataset import FastSpeechDataset

    np.random.seed(0)
    batch = trainer.prepare_batch(max(FastSpeechDataset(hp, "train", shuffle=True).iter_batches(),
                                      key=lambda b: b["mels"].size))
    valid_batch = trainer.prepare_batch(next(FastSpeechDataset(hp, "valid").iter_batches(
        max_sentences=int(hp["max_eval_sentences"]))))
    readings = {}
    for kind, b in (("train", batch), ("valid", valid_batch)):
        r = step_vs_plain(torch, tr, trainer, b, int(hp["K_step"]))
        readings[kind] = {"batch_shape": list(b["mels"].shape), **r, "agrees": agrees(r)}
    return readings


def utterance_vs_plain(torch, ds, mrf, hp_inf, gen_dir: Path):
    """The first test utterance of a CLI run's --infer again (B = 1, its own
    length), with the kernels and with the plain twins, same seed and
    weights; the kernel run must also repeat the mel --infer saved. The
    serving phases' rule: the waveform within 1e-4 of its scale, the log10
    mel (values around -5..1) within 1e-3 of its scale."""
    import numpy as np

    from diffsinger_tpu_torch import cli
    from diffsinger_tpu_torch.data.dataset import FastSpeechDataset
    from diffsinger_tpu_torch.inference.vocoder import HifiGAN
    from diffsinger_tpu_torch.training.trainer import Trainer

    device = "cuda"
    _, task = cli._build(hp_inf, device)
    Trainer(hp_inf, task, device=device).initialize()
    voc = HifiGAN(hp_inf, device=device)
    batch = next(FastSpeechDataset(hp_inf, "test").iter_batches(max_sentences=1))

    def utterance():
        gen = torch.Generator(device=device).manual_seed(int(hp_inf["seed"]))
        out = task.inference(batch, use_gt_dur=True, use_gt_f0=True, generator=gen)
        n = int((out["mel2ph"][0] > 0).sum())
        mel = out["mel_out"][0, :n].float().cpu().numpy()
        f0 = out["f0_denorm"][0, :n].float().cpu().numpy() if "f0_denorm" in out else None
        return mel, voc.spec2wav(mel, f0=f0)

    mel_k, wav_k = utterance()
    with plain_twins(ds, mrf):
        mel_p, wav_p = utterance()
    saved = np.load(gen_dir / "P_mels_npy" / f"{batch['item_name'][0]}.npy")
    out = {"frames": int(mel_k.shape[0]),
           "mel_max_abs_diff": float(np.abs(mel_k - mel_p).max()),
           "mel_tolerance": 1e-3 * max(float(np.abs(mel_p).max()), 1.0),
           "wav_max_abs_diff": float(np.abs(wav_k - wav_p).max()),
           "wav_tolerance": 1e-4 * max(float(np.abs(wav_p).max()), 1.0),
           "infer_vs_rerun_mel_max_abs_diff": float(np.abs(saved - mel_k).max())}
    out["agrees"] = bool(out["mel_max_abs_diff"] <= out["mel_tolerance"]
                         and out["wav_max_abs_diff"] <= out["wav_tolerance"]
                         and out["infer_vs_rerun_mel_max_abs_diff"] <= out["mel_tolerance"])
    return out


def phase_cli(torch, ds, mrf, tr, card: str, out_dir: Path):
    """The user path: corpus on disk -> binarizer -> cli.train (validation,
    checkpoints) -> resume -> cli.infer -> waveforms on disk, with
    configs/lj/ds_beta6.yaml at full width."""
    import os
    import shutil

    import numpy as np
    from scipy.io import wavfile

    from diffsinger_tpu_torch import cli
    from diffsinger_tpu_torch.config.hparams import set_hparams
    from diffsinger_tpu_torch.data.indexed_dataset import IndexedDataset
    from diffsinger_tpu_torch.training.trainer import Trainer

    device = "cuda"
    root = out_dir / "cli"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cfg_path = _cli_corpus(root)

    # 1. binarize, in a child process: its worker pool forks, and forked
    # workers cannot use the CUDA context this process holds
    proc = subprocess.run([sys.executable, "-m", "diffsinger_tpu_torch.data.binarize",
                           "--config", str(cfg_path)], cwd=ROOT, capture_output=True,
                          text=True, timeout=600,
                          env={**os.environ, "N_PROC": str(min(8, os.cpu_count() or 1))})
    (root / "binarize.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise AssertionError(f"cli: binarize failed ({proc.returncode}): {proc.stderr[-2000:]}")
    binary = root / "binary"
    want = {"test": CLI_TEST, "valid": CLI_TEST + CLI_VALID,
            "train": CLI_ITEMS - CLI_TEST - CLI_VALID}
    got, frames, voiced_min, f0_lo, f0_hi = {}, 0, 1.0, 1e9, 0.0
    for split, n in want.items():
        items = IndexedDataset(str(binary / split))
        got[split] = len(items)
        lengths = np.load(binary / f"{split}_lengths.npy")
        if len(lengths) != len(items):
            raise AssertionError(f"cli: {split}_lengths.npy has {len(lengths)} entries")
        for i in range(len(items)):
            it = items[i]
            if "cwt_spec" not in it or it["mel"].shape != (it["len"], 80):
                raise AssertionError(f"cli: item {it['item_name']} lacks cwt_spec or its mel")
            f0 = it["f0"]
            voiced = f0[f0 > 0]
            voiced_min = min(voiced_min, len(voiced) / len(f0))
            f0_lo, f0_hi = min(f0_lo, float(voiced.min())), max(f0_hi, float(voiced.max()))
            if split != "valid":
                frames += int(it["len"])
        items.close()
    if got != want or not (binary / "phone_set.json").exists():
        raise AssertionError(f"cli: split sizes {got}, expected {want}, or no phone_set.json")
    if not (voiced_min > 0.5 and 80.0 <= f0_lo and f0_hi <= 750.0):
        raise AssertionError(f"cli: F0 voiced share {voiced_min} or range [{f0_lo}, {f0_hi}]")

    # 2. checkpoints to start from
    _cli_start_ckpts(torch, root, cfg_path)

    # 3. train: 20 steps, validation and checkpoints at 10 and 20
    ckpt_root = str(root / "checkpoints")
    hp = set_hparams(str(cfg_path), "chip_cli", ckpt_root=ckpt_root)
    for fn in (tr.diffnet_train_fwd, tr.diffnet_train_bwd, ds.diffnet_stack, mrf.mrf_stage):
        fn.launches = 0
    trainer = cli.train(hp, device=device)
    launches = {"diffnet_train_fwd": tr.diffnet_train_fwd.launches,
                "diffnet_train_bwd": tr.diffnet_train_bwd.launches}
    work = Path(hp["work_dir"])
    ckpt20 = work / f"model_ckpt_steps_{CLI_STEPS}.ckpt"
    steps_saved = sorted(int(p.stem.split("_")[-1]) for p in work.glob("model_ckpt_steps_*.ckpt"))
    history = trainer.history
    if trainer.global_step != CLI_STEPS or steps_saved != [10, CLI_STEPS] \
            or not (work / "best_valid.npy").exists():
        raise AssertionError(f"cli: train ended at {trainer.global_step}, checkpoints "
                             f"{steps_saved}")
    if not all(np.isfinite(v) for _, _, sc in history for v in sc.values()) or \
            {kind for _, kind, _ in history} != {"train", "val"}:
        raise AssertionError(f"cli: train/validation losses {history}")
    if not (launches["diffnet_train_bwd"] == CLI_STEPS
            and launches["diffnet_train_fwd"] >= CLI_STEPS):
        raise AssertionError(f"cli: training kernel launches {launches} for {CLI_STEPS} steps")
    del trainer

    # 4. a fresh Trainer restores step 20 bit for bit: params and AdamW moments
    _, task_r = cli._build(hp, device)
    fresh = Trainer(hp, task_r, device=device)
    fresh.initialize()
    raw = torch.load(ckpt20, map_location="cpu", weights_only=False)
    sd = task_r.state_dict()
    params_equal = all(torch.equal(sd[k].cpu(), v) for k, v in raw["state_dict"]["model"].items())
    saved_state = raw["optimizer_states"][0]["state"]
    live_state = fresh.optimizer.adamw.state_dict()["state"]
    moments_equal = saved_state.keys() == live_state.keys() and all(
        torch.equal(live_state[i][m].cpu(), saved_state[i][m])
        for i in saved_state for m in ("exp_avg", "exp_avg_sq", "step"))
    if not (fresh.global_step == CLI_STEPS and params_equal and moments_equal):
        raise AssertionError(f"cli: restore at step {fresh.global_step}: params equal "
                             f"{params_equal}, moments equal {moments_equal}")
    del task_r, fresh, raw

    # 5. resume to step 30
    hp_resume = set_hparams(str(cfg_path), "chip_cli", f"max_updates={CLI_RESUME_STEPS}",
                            ckpt_root=ckpt_root)
    tr.diffnet_train_fwd.launches = tr.diffnet_train_bwd.launches = 0
    with _Tee() as tee:
        trainer = cli.train(hp_resume, device=device)
    if f"restored checkpoint at step {CLI_STEPS}" not in tee.text:
        raise AssertionError(f"cli: the resume printed no restore at step {CLI_STEPS}")
    resume_launches = {"diffnet_train_fwd": tr.diffnet_train_fwd.launches,
                       "diffnet_train_bwd": tr.diffnet_train_bwd.launches}
    kept = sorted(int(p.stem.split("_")[-1]) for p in work.glob("model_ckpt_steps_*.ckpt"))
    if trainer.global_step != CLI_RESUME_STEPS or len(kept) > int(hp["num_ckpt_keep"]) \
            or kept[-1] != CLI_RESUME_STEPS:
        raise AssertionError(f"cli: resume ended at {trainer.global_step}, kept {kept}")
    if resume_launches["diffnet_train_bwd"] != CLI_RESUME_STEPS - CLI_STEPS:
        raise AssertionError(f"cli: the resume took {resume_launches} kernel launches; "
                             "it did not start at the saved step")
    for k in launches:
        launches[k] += resume_launches[k]

    # the training kernels at this path's own shapes, against their plain twins
    fit_vs_plain = fit_batches_vs_plain(torch, tr, trainer, hp_resume, step_agrees)
    del trainer

    # 6. --infer on the test split
    hp_inf = set_hparams(str(cfg_path), "chip_cli", infer=True, ckpt_root=ckpt_root)
    ds.diffnet_stack.launches = mrf.mrf_stage.launches = 0
    with _Tee() as tee:
        gen_dir = Path(cli.infer(hp_inf, device=device))
    rtf_line = [ln for ln in tee.text.splitlines() if "RTF" in ln]
    where = torch.cuda.get_device_name(0)
    if not (rtf_line and rtf_line[-1].endswith(f"on {where}")):
        raise AssertionError(f"cli: --infer printed no RTF line for {where}: {rtf_line}")
    launches.update(diffnet_stack=ds.diffnet_stack.launches, mrf_stage=mrf.mrf_stage.launches)
    if not gen_dir.name.startswith(f"generated_{CLI_RESUME_STEPS}_"):
        raise AssertionError(f"cli: --infer wrote {gen_dir}: not from the step-30 checkpoint")
    test_items = IndexedDataset(str(binary / "test"))
    names = []
    for i in range(len(test_items)):
        it = test_items[i]
        names.append(it["item_name"])
        t_mel = int(it["len"])
        mel = np.load(gen_dir / "P_mels_npy" / f"{it['item_name']}.npy")
        if mel.shape != (t_mel, 80) or not np.isfinite(mel).all():
            raise AssertionError(f"cli: P mel {mel.shape} for {t_mel} frames")
        for kind in ("P", "G"):
            sr, wav = wavfile.read(gen_dir / "wavs" / f"{kind}_{it['item_name']}.wav")
            if sr != 22050 or wav.shape != (t_mel * 256,):
                raise AssertionError(f"cli: {kind} wav {wav.shape} at {sr} Hz for {t_mel} frames")
    test_items.close()
    k_step = int(hp_inf["K_step"])
    if (launches["diffnet_stack"] != k_step * CLI_TEST
            or launches["mrf_stage"] != 3 * 2 * CLI_TEST):
        raise AssertionError(f"cli: --infer launches {launches}, expected {k_step} stack a "
                             "test utterance and 3 MRF a vocoder call (P and G)")

    # 7. the first test utterance again, kernels and plain twins
    infer_vs_plain = utterance_vs_plain(torch, ds, mrf, hp_inf, gen_dir)

    out = {
        "card": card, "config": "configs/lj/ds_beta6.yaml as shipped (cwt pitch, full width) "
                                "with the bf16 stack, ground-truth durations and F0 at --infer",
        "items": got, "frames_train_and_test": frames, "voiced_share_min": voiced_min,
        "f0_hz_range": [f0_lo, f0_hi], "steps": CLI_STEPS, "resumed_to": CLI_RESUME_STEPS,
        "fit_kernel_vs_plain": fit_vs_plain, "checkpoint_bytes": ckpt20.stat().st_size,
        "last_train_loss": [sc for _, k, sc in history if k == "train"][-1],
        "last_val_loss": [sc for _, k, sc in history if k == "val"][-1],
        "infer_rtf_line": rtf_line[-1],
        "test_items": names, "launches": launches, "infer_kernel_vs_plain": infer_vs_plain,
    }
    print("cli", json.dumps(out), flush=True)
    if not all(c["agrees"] for c in fit_vs_plain.values()):
        raise AssertionError(f"cli: training kernels vs plain twins {fit_vs_plain}")
    if not infer_vs_plain["agrees"]:
        raise AssertionError(f"cli: --infer kernels vs plain twins {infer_vs_plain}")
    return out


# -------------------------------------------------------------------- phase 7h
CASCADE_FS2_STEPS, CASCADE_DS_STEPS = 20, 10


def phase_cli_cascade(torch, ds, mrf, tr, card: str, out_dir: Path):
    """The published DiffSpeech recipe through the CLI, on the cli phase's
    binarized corpus: cli.train on configs/lj/fs2.yaml (20 steps), cli.train
    on configs/lj/ds_beta6.yaml as shipped (float32) for 10 steps with
    fs2_ckpt set to that run's directory (every FS2 tensor warm-started, the
    predictors trainable, the rest of the FS2 frozen), then cli --infer of
    both runs on the 4 test items. The training kernels are held against
    their plain twins at the run's largest training batch and a validation
    batch, and each --infer's first test utterance with its kernels against
    the plain twins."""
    import numpy as np
    import yaml
    from scipy.io import wavfile

    from diffsinger_tpu_torch import cli
    from diffsinger_tpu_torch.config.hparams import set_hparams
    from diffsinger_tpu_torch.convert.checkpoint import load_torch_state_dict
    from diffsinger_tpu_torch.data.indexed_dataset import IndexedDataset

    root = out_dir / "cli"
    if not (root / "binary" / "phone_set.json").exists():
        raise AssertionError("cli_cascade: the cli phase's binarized corpus is missing")
    ckpt_root = str(root / "cascade_checkpoints")
    common = {"raw_data_dir": str(root / "raw"), "processed_data_dir": str(root / "processed"),
              "binary_data_dir": str(root / "binary"), "test_num": CLI_TEST,
              "valid_num": CLI_VALID, "num_test_samples": 0, "test_ids": [],
              "val_check_interval": 10, "num_sanity_val_steps": 1, "log_interval": 5,
              # a 20-step duration predictor is no product: ground-truth
              # durations and F0 at --infer, as in the cli phase
              "use_gt_dur": True, "use_gt_f0": True, "save_gt": False,
              "profile_infer": True, "vocoder_ckpt": str(root / "hifigan")}
    fs2_cfg, ds_cfg = root / "cascade_fs2.yaml", root / "cascade_ds.yaml"
    fs2_cfg.write_text(yaml.safe_dump({"base_config": [str(ROOT / "configs/lj/fs2.yaml")],
                                       **common, "max_updates": CASCADE_FS2_STEPS}))
    fs2_dir = str(Path(ckpt_root) / "cascade_fs2")
    ds_cfg.write_text(yaml.safe_dump({"base_config": [str(ROOT / "configs/lj/ds_beta6.yaml")],
                                      **common, "max_updates": CASCADE_DS_STEPS,
                                      "fs2_ckpt": fs2_dir}))
    for fn in (tr.diffnet_train_fwd, tr.diffnet_train_bwd, ds.diffnet_stack, mrf.mrf_stage):
        fn.launches = 0
    hp_fs2 = set_hparams(str(fs2_cfg), "cascade_fs2", ckpt_root=ckpt_root)
    fs2_trainer = cli.train(hp_fs2, device="cuda")
    fs2_launches = {"diffnet_train_fwd": tr.diffnet_train_fwd.launches,
                    "diffnet_train_bwd": tr.diffnet_train_bwd.launches}
    fs2_hist = fs2_trainer.history
    fs2_ok = (type(fs2_trainer.task).__name__ == "FastSpeech2Task"
              and fs2_trainer.global_step == CASCADE_FS2_STEPS
              and all(np.isfinite(v) for _, _, sc in fs2_hist for v in sc.values()))
    fs2_ckpt_path = fs2_trainer.ckpt_path(CASCADE_FS2_STEPS)
    fs2_saved = load_torch_state_dict(fs2_ckpt_path)
    del fs2_trainer

    hp_ds = set_hparams(str(ds_cfg), "cascade_ds", ckpt_root=ckpt_root)
    with _Tee() as tee:
        ds_trainer = cli.train(hp_ds, device="cuda")
    task = ds_trainer.task
    n_fs2 = len(task.fs2.state_dict())
    warm = [ln for ln in tee.text.splitlines() if "warm-started fs2" in ln]
    trainable = [n for n, p in task.fs2.named_parameters() if p.requires_grad]
    frozen = [n for n, p in task.fs2.named_parameters() if not p.requires_grad]
    frozen_kept = all(torch.equal(p.detach().cpu(), fs2_saved[n])
                      for n, p in task.fs2.named_parameters() if not p.requires_grad)
    preds_moved = any(not torch.equal(p.detach().cpu(), fs2_saved[n])
                      for n, p in task.fs2.named_parameters() if p.requires_grad)
    ds_launches = {"diffnet_train_fwd": tr.diffnet_train_fwd.launches,
                   "diffnet_train_bwd": tr.diffnet_train_bwd.launches}
    ds_hist = ds_trainer.history
    # the float32 training kernels at this run's own shapes, against their
    # plain twins by the float32 criterion
    fit_vs_plain = fit_batches_vs_plain(torch, tr, ds_trainer, hp_ds, step_agrees_f32)
    del ds_trainer, task

    # --infer of both runs on the test split
    infer = {}
    for name, cfg in (("cascade_fs2", fs2_cfg), ("cascade_ds", ds_cfg)):
        ds.diffnet_stack.launches = mrf.mrf_stage.launches = 0
        gen_dir = Path(cli.infer(set_hparams(str(cfg), name, infer=True, ckpt_root=ckpt_root),
                                 device="cuda"))
        infer[name] = {"gen_dir": str(gen_dir),
                       "launches": {"diffnet_stack": ds.diffnet_stack.launches,
                                    "mrf_stage": mrf.mrf_stage.launches}}
    # the first test utterance of each --infer at its B = 1 shape, kernels
    # (the float32 stack, the MRF) against the plain twins
    for name, cfg in (("cascade_fs2", fs2_cfg), ("cascade_ds", ds_cfg)):
        infer[name]["kernel_vs_plain"] = utterance_vs_plain(
            torch, ds, mrf, set_hparams(str(cfg), name, infer=True, ckpt_root=ckpt_root),
            Path(infer[name]["gen_dir"]))
    test_items = IndexedDataset(str(root / "binary" / "test"))
    frames = [int(test_items[i]["len"]) for i in range(len(test_items))]
    names = [test_items[i]["item_name"] for i in range(len(test_items))]
    test_items.close()
    wav_ok = {}
    for name, rec in infer.items():
        ok = True
        for item, t_mel in zip(names, frames):
            sr, wav = wavfile.read(Path(rec["gen_dir"]) / "wavs" / f"P_{item}.wav")
            mel = np.load(Path(rec["gen_dir"]) / "P_mels_npy" / f"{item}.npy")
            ok &= (sr == 22050 and wav.shape == (t_mel * 256,) and mel.shape == (t_mel, 80)
                   and bool(np.isfinite(mel).all()) and float(np.abs(wav).max()) > 0)
        wav_ok[name] = ok
    launches = {**{k: fs2_launches[k] + ds_launches[k] for k in ds_launches},
                "diffnet_stack": sum(r["launches"]["diffnet_stack"] for r in infer.values()),
                "mrf_stage": sum(r["launches"]["mrf_stage"] for r in infer.values())}
    out = {"card": card, "fs2_config": "configs/lj/fs2.yaml",
           "ds_config": "configs/lj/ds_beta6.yaml (float32, fs2_ckpt = the FS2 run)",
           "fs2_steps": CASCADE_FS2_STEPS,
           "ds_steps": CASCADE_DS_STEPS, "warm_start_line": warm, "fs2_tensors": n_fs2,
           "fs2_trainable": trainable, "fs2_frozen_count": len(frozen),
           "frozen_kept": frozen_kept, "predictors_moved": preds_moved,
           "last_fs2_loss": [sc for _, k, sc in fs2_hist if k == "train"][-1],
           "last_ds_loss": [sc for _, k, sc in ds_hist if k == "train"][-1],
           "fit_kernel_vs_plain": fit_vs_plain, "infer": infer, "test_items": names, "wavs_ok": wav_ok, "launches": launches}
    print("cli_cascade", json.dumps(out), flush=True)
    if not fs2_ok or fs2_launches != {"diffnet_train_fwd": 0, "diffnet_train_bwd": 0}:
        raise AssertionError(f"cli_cascade: the FS2 run {fs2_hist[-1:]}, launches {fs2_launches}")
    if not (warm and warm[-1].endswith(f"({n_fs2} tensors)")):
        raise AssertionError(f"cli_cascade: warm start {warm}, the FS2 has {n_fs2} tensors")
    if not (trainable and all("predictor" in n for n in trainable) and frozen and frozen_kept
            and preds_moved):
        raise AssertionError(f"cli_cascade: trainable FS2 {trainable}, frozen kept "
                             f"{frozen_kept}, predictors moved {preds_moved}")
    if not (ds_launches["diffnet_train_bwd"] == CASCADE_DS_STEPS
            and ds_launches["diffnet_train_fwd"] >= CASCADE_DS_STEPS):
        raise AssertionError(f"cli_cascade: training kernel launches {ds_launches}")
    if not all(np.isfinite(v) for _, _, sc in ds_hist for v in sc.values()):
        raise AssertionError(f"cli_cascade: DiffSpeech losses {ds_hist}")
    if not all(c["agrees"] for c in fit_vs_plain.values()):
        raise AssertionError(f"cli_cascade: training kernels vs plain twins {fit_vs_plain}")
    if not all(r["kernel_vs_plain"]["agrees"] for r in infer.values()):
        raise AssertionError(f"cli_cascade: --infer kernels vs plain twins "
                             f"{ {k: r['kernel_vs_plain'] for k, r in infer.items()} }")
    k_step = int(hp_ds["K_step"])
    want_infer = {"cascade_fs2": {"diffnet_stack": 0, "mrf_stage": 3 * CLI_TEST},
                  "cascade_ds": {"diffnet_stack": k_step * CLI_TEST, "mrf_stage": 3 * CLI_TEST}}
    if {k: r["launches"] for k, r in infer.items()} != want_infer or not all(wav_ok.values()):
        raise AssertionError(f"cli_cascade: --infer launches "
                             f"{ {k: r['launches'] for k, r in infer.items()} }, expected "
                             f"{want_infer}; wavs {wav_ok}")
    return out


# -------------------------------------------------------------------- phase 7i
# the reference gradio demo sentences (text, notes, note durations)
WEB_DEMO = [
    ("你 说 你 不 SP 懂 为 何 在 这 时 牵 手 AP",
     "D#4/Eb4 | D#4/Eb4 | D#4/Eb4 | D#4/Eb4 | rest | D#4/Eb4 | D4 | D4 | D4 "
     "| D#4/Eb4 | F4 | D#4/Eb4 | D4 | rest",
     "0.113740 | 0.329060 | 0.287950 | 0.133480 | 0.150900 | 0.484730 | "
     "0.242010 | 0.180820 | 0.343570 | 0.152050 | 0.266720 | 0.280310 | "
     "0.633300 | 0.444590"),
    ("小酒窝长睫毛AP是你最美的记号",
     "C#4/Db4 | F#4/Gb4 | G#4/Ab4 | A#4/Bb4 F#4/Gb4 | F#4/Gb4 C#4/Db4 | "
     "C#4/Db4 | rest | C#4/Db4 | A#4/Bb4 | G#4/Ab4 | A#4/Bb4 | G#4/Ab4 | F4 "
     "| C#4/Db4",
     "0.407140 | 0.376190 | 0.242180 | 0.509550 0.183420 | 0.315400 0.235020"
     " | 0.361660 | 0.223070 | 0.377270 | 0.340550 | 0.299620 | 0.344510 | "
     "0.283770 | 0.323390 | 0.360340"),
    ("我真的SP爱你SP句句不轻易",
     "D4 | A4 | F#4 |  rest | A4 | D4 | rest | B4 | A4 F#4 | F#4 | A4 | A4",
     "0.8 | 0.4 | 0.967 | 0.3 | 0.4 | 0.967 | 0.4 | 0.8 | 0.4 0.4 | 0.25 | "
     "0.967 | 0.9"),
    ("好冷啊 AP 我在东北玩泥巴",
     "F4 | F4 | D4 | rest | D4 | D4 | C4 | C4 | B3 | C4 | D4",
     "0.5 | 0.3 | 0.3 | 0.3 | 0.2 | 0.2 | 0.2 | 0.2 | 0.25 | 0.25 | 0.4"),
]
WEB_LSB = 2   # int16 steps two greet calls may differ by where cuDNN is not bit-reproducible


def _post(port: int, body: bytes, headers=None, timeout: float = 120):
    """(status, content type, body) of one POST to /api/synthesize."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.putrequest("POST", "/api/synthesize")
        for k, v in {"Content-Length": str(len(body)), **(headers or {})}.items():
            conn.putheader(k, v)
        conn.endheaders()
        if body:
            conn.send(body)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def _lsb(body: bytes, wav) -> int:
    """Largest int16 step between a wav body and a greet waveform."""
    import numpy as np

    got = np.frombuffer(body[44:], "<i2").astype(np.int32)
    if got.shape != wav.shape:
        return 1 << 16
    return int(np.abs(got - wav.astype(np.int32)).max()) if got.size else 0


def write_singer_ckpts(torch, root: Path) -> dict:
    """``build_singer``'s seeded DiffSinger-Opencpop (ds1000.yaml as shipped:
    the float32 stack), its NSF-HiFiGAN and its PitchExtractor written in
    upstream's layout under ``root``; returns the hparams that point at them."""
    from diffsinger_tpu_torch.tools import fixtures

    hp, infer = build_singer(torch, stack_dtype=None)
    syn = infer.fused
    fixtures.write_task_ckpt(str(root / "exp"), syn.task.checkpoint_module().state_dict(),
                             step=1000)
    geometry = dict(SING_VOCODER, audio_sample_rate=int(hp["audio_sample_rate"]),
                    audio_num_mel_bins=80, hop_size=SING_HOP)
    fixtures.write_hifigan_dir(str(root / "hifigan"), syn.vocoder.model.state_dict(), geometry)
    fixtures.write_task_ckpt(str(root / "pe"), syn.pe.state_dict(), step=1000)
    return {"work_dir": str(root / "exp"), "vocoder_ckpt": str(root / "hifigan"),
            "pe_enable": True, "pe_ckpt": str(root / "pe"), "seed": 0}


def phase_serve_web(torch, ds, mrf, card: str, out_dir: Path):
    """The port's web server over DiffSinger-Opencpop (configs/opencpop/ds1000.yaml
    as shipped, seeded checkpoints on disk): SVSWebApp over
    GradioInfer(DiffSingerE2EInfer) on 127.0.0.1:0 answers the four gradio
    demo sentences, each body equal to a direct ``greet``, one sentence twice
    at once; the status rules; and the unfused path against the fused one."""
    import threading

    import numpy as np

    from diffsinger_tpu_torch.config.hparams import set_hparams
    from diffsinger_tpu_torch.inference.gradio_app import GradioInfer
    from diffsinger_tpu_torch.inference.svs import EXAMPLE_INPUT, DiffSingerE2EInfer
    from diffsinger_tpu_torch.inference.vocoder import pad_frames
    from diffsinger_tpu_torch.inference.web_app import MAX_REQUEST_BYTES, SVSWebApp, wav_bytes

    hp = set_hparams(str(ROOT / "configs" / "opencpop" / "ds1000.yaml"))
    hp.update(write_singer_ckpts(torch, out_dir / "serve_web"))
    core = GradioInfer(hp, DiffSingerE2EInfer, title="DiffSinger",
                       description="lyrics + MIDI notes -> singing voice")  # the card
    infer = core.infer_ins
    if infer.fused is None or infer.task.compute_dtype is not None or infer.pe is None:
        raise AssertionError("serve_web: not ds1000.yaml's fused float32 path with its PE")
    sr = int(hp["audio_sample_rate"])
    app = SVSWebApp(core)
    port = app.start("127.0.0.1", 0)
    try:
        direct = [core.greet(*s) for s in WEB_DEMO]   # warm-up, and the reference bodies
        payloads = [json.dumps(dict(zip(("text", "notes", "notes_duration"), s))).encode()
                    for s in WEB_DEMO]
        ds.diffnet_stack.launches = 0
        mrf.mrf_stage.launches = 0
        requests = []
        for payload in payloads:
            status, ctype, body = _post(port, payload)
            requests.append({"status": status, "ctype": ctype, "body": body})
        launches = {"diffnet_stack": ds.diffnet_stack.launches,
                    "mrf_stage": mrf.mrf_stage.launches}
        results = [None, None]

        def worker(i):
            results[i] = _post(port, payloads[0])

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        status_rules = {
            "negative_length": _post(port, b"", {"Content-Length": "-1"}, timeout=5)[0],
            "too_large": _post(port, b"", {"Content-Length": str(MAX_REQUEST_BYTES + 1)},
                               timeout=5)[0]}
        bad = {"text": WEB_DEMO[3][0], "notes": "F4 | F4", "notes_duration": "0.5 | 0.3"}
        status, _, msg = _post(port, json.dumps(bad).encode(), timeout=30)
        status_rules["misaligned_notes"] = status
        status_rules["misaligned_message"] = msg.decode(errors="replace")
    finally:
        app.stop()

    rows, lsb = [], []
    for (s, _, _), (dsr, wav), r in zip(WEB_DEMO, direct, requests):
        body = r.pop("body")
        ok = (r["status"] == 200 and r["ctype"] == "audio/wav" and body[:4] == b"RIFF"
              and body[8:16] == b"WAVEfmt " and int.from_bytes(body[24:28], "little") == sr
              and int.from_bytes(body[34:36], "little") == 16 and dsr == sr
              and (len(body) - 44) // 2 == len(wav))
        lsb.append(_lsb(body, wav) if ok else 1 << 16)
        rows.append({**r, "format_ok": ok, "samples": len(wav), "max_lsb_vs_greet": lsb[-1],
                     "bit_equal": body == wav_bytes(wav, sr)})
    concurrent_lsb = [_lsb(r[2], direct[0][1]) if r and r[0] == 200 else 1 << 16
                      for r in results]

    # the unfused path (fused_infer: false) on the same parts, against the fused
    # one on EXAMPLE_INPUT with the same draws. They differ by design in the
    # padding: the fused sampler runs the 128-frame bucket, its PE and vocoder
    # the padded mel; the unfused PE and vocoder the cut mel padded to 64
    # frames. The PE's F0 moves a little with it, and the NSF source
    # integrates F0 into its phase over the utterance (and the seeded PE
    # voices frames near a uv logit of 0), so the waveforms agree as a whole
    # (correlation, relative RMS), not sample by sample
    unfused = DiffSingerE2EInfer(dict(hp, fused_infer=False, work_dir="", vocoder_ckpt="",
                                      pe_ckpt=""),
                                 task=infer.task, vocoder=infer.vocoder, pe=infer.pe.module)
    item = infer.preprocess_input(EXAMPLE_INPUT, "phoneme")
    t_mel = infer.estimate_t_mel(item)
    t_b = -(-t_mel // int(hp.get("mel_pad_multiple", 128))) * int(hp.get("mel_pad_multiple", 128))
    n = len(item["ph_token"]) * SING_FRAMES_PER_PHONE
    gen = torch.Generator(device="cuda").manual_seed(6)
    noise = torch.randn((1, 1, t_b, 80), device="cuda", generator=gen)
    rand_ini = torch.rand((1, 1, 9), device="cuda", generator=gen)
    rand_ini[:, :, 0] = 0.0
    src = torch.randn((1, t_b * SING_HOP, 9), device="cuda", generator=gen)
    wav_f = infer.forward_model(item, noise=noise, source=(rand_ini, src))
    t_pad = pad_frames(n, hp)
    wav_u = unfused.forward_model(item, noise=noise[:, :, :t_mel],
                                  source=(rand_ini, src[:, : t_pad * SING_HOP]))
    edge = 16 * SING_HOP   # the vocoder's reach into the padding, in samples
    inner = slice(0, max(len(wav_f) - edge, 0))
    scale = float(np.abs(wav_f).max())
    unfused_row = {
        "frames": n, "t_mel": t_mel, "t_bucket": t_b, "samples": [len(wav_f), len(wav_u)],
        "finite": bool(np.isfinite(wav_f).all() and np.isfinite(wav_u).all()),
        "wav_scale": scale, "max_abs_diff": float(np.abs(wav_f - wav_u).max())
        if len(wav_f) == len(wav_u) else None,
        "max_abs_diff_but_last_16_frames": float(np.abs(wav_f[inner] - wav_u[inner]).max())
        if len(wav_f) == len(wav_u) else None,
        "corr_but_last_16_frames": float(np.corrcoef(wav_f[inner], wav_u[inner])[0, 1])
        if len(wav_f) == len(wav_u) else None,
        "rel_rms_but_last_16_frames": float(np.linalg.norm(wav_f[inner] - wav_u[inner])
                                            / np.linalg.norm(wav_f[inner]))
        if len(wav_f) == len(wav_u) else None,
        "diff_by_frame": np.abs(wav_f - wav_u).reshape(-1, SING_HOP).max(1).round(5).tolist()
        if len(wav_f) == len(wav_u) else None}

    per_req = {k: v / len(WEB_DEMO) for k, v in launches.items()}
    out = {"card": card, "config": "configs/opencpop/ds1000.yaml as shipped (float32 stack, "
                                   "PLMS-25, PE, NSF-HiFiGAN 8/8/2), seeded checkpoints on disk",
           "requests": rows, "launches": launches,
           "launches_per_request": per_req,
           "bodies_vs_greet": "bit-equal" if all(r["bit_equal"] for r in rows)
           else f"within {max(lsb)} LSB",
           "concurrent_max_lsb": concurrent_lsb, "status": status_rules,
           "unfused_vs_fused": unfused_row}
    print("serve_web", json.dumps(out), flush=True)
    n_calls = infer.fused.task.gd.denoiser_calls()
    if not all(r["format_ok"] for r in rows) or max(lsb) > WEB_LSB:
        raise AssertionError(f"serve_web: bodies {rows}")
    if max(concurrent_lsb) > WEB_LSB:
        raise AssertionError(f"serve_web: concurrent bodies off by {concurrent_lsb} LSB")
    if launches != {"diffnet_stack": n_calls * len(WEB_DEMO), "mrf_stage": 2 * len(WEB_DEMO)}:
        raise AssertionError(f"serve_web: launches {launches}, expected {n_calls} stack and "
                             f"2 MRF a request")
    if (status_rules["negative_length"], status_rules["too_large"],
            status_rules["misaligned_notes"]) != (400, 413, 400):
        raise AssertionError(f"serve_web: status rules {status_rules}")
    u = unfused_row
    if not (u["finite"] and u["samples"] == [n * SING_HOP] * 2
            and u["rel_rms_but_last_16_frames"] <= 5e-2 and u["corr_but_last_16_frames"] > 0.99):
        raise AssertionError(f"serve_web: unfused vs fused {u}")
    return out


# -------------------------------------------------------------------- phase 7j
# HiFiGAN v3's published generator (resblock '2'), hop 8 * 8 * 4 = 256
V3_VOCODER = dict(resblock="2", upsample_rates=[8, 8, 4], upsample_kernel_sizes=[16, 16, 8],
                  upsample_initial_channel=256, resblock_kernel_sizes=[3, 5, 7],
                  resblock_dilation_sizes=[[1, 2], [2, 6], [3, 12]], audio_sample_rate=22050,
                  audio_num_mel_bins=80, hop_size=256, use_pitch_embed=False, use_nsf=False)


def _seeded_vocoder(torch, hp, seed: int):
    """A HifiGAN wrapper on the CPU whose convolutions have torch's default
    scale (as build_synth gives them), moved to the card."""
    import torch.nn as nn

    from diffsinger_tpu_torch.inference.vocoder import HifiGAN

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        voc = HifiGAN(hp, device="cpu")
        with torch.no_grad():
            for m in voc.model.modules():
                if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
                    m.reset_parameters()
    return voc.to("cuda")


def _voc_mel(torch, b: int, t: int, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((b, t, 80), device="cuda", generator=g) * 0.7 - 2.5


def phase_vocoders(torch, mrf, card: str, out_dir: Path):
    """(a) ``vocoder_compute_dtype: bfloat16``: HiFiGAN v1 on the LJ 8 x 1024
    mel batch and NSF-HiFiGAN (8/8/2) on the singing 8 x 1024 batch, the MRF
    scales on the kernel's bf16 body, each against the same module on its
    plain twins, its distance from the float32 module printed beside it;
    (b) a ``resblock: '2'``
    generator at HiFiGAN v3's widths from a written checkpoint, card against
    CPU; (c) ParallelWaveGAN at its default widths from a written official
    release (.pkl + stats.npy), ``spec2wav`` of one 1024-frame mel, card
    against CPU."""
    import numpy as np
    import torch.nn as nn

    from diffsinger_tpu_torch.config.hparams import set_hparams
    from diffsinger_tpu_torch.inference.vocoder import PWG, HifiGAN, get_vocoder_cls
    from diffsinger_tpu_torch.models.hifigan import HifiGanConfig, HifiGanGenerator, draw_source
    from diffsinger_tpu_torch.models.pwg import ParallelWaveGANGenerator, PWGConfig
    from diffsinger_tpu_torch.tools import fixtures

    root = out_dir / "vocoders"
    lj = set_hparams(str(ROOT / "configs" / "lj" / "ds_beta6.yaml"))
    sing = dict(set_hparams(str(ROOT / "configs" / "opencpop" / "ds1000.yaml")), **SING_VOCODER)
    vocs = {}
    for name, hp, seed in (("lj_v1", lj, 0), ("singing_nsf", sing, 1)):
        bf = _seeded_vocoder(torch, dict(hp, vocoder_compute_dtype="bfloat16"), seed)
        f32 = HifiGAN(hp)  # the card
        f32.load_state_dict(bf.model.state_dict())
        if bf.cfg.dtype != torch.bfloat16 or f32.cfg.dtype is not None:
            raise AssertionError(f"vocoders {name}: dtypes {bf.cfg.dtype}, {f32.cfg.dtype}")
        vocs[name] = (bf, f32)
    mels = {"lj_v1": _voc_mel(torch, 8, 1024, 3), "singing_nsf": _voc_mel(torch, 8, 1024, 4)}
    g = torch.Generator(device="cuda").manual_seed(5)
    f0 = torch.rand((8, 1024), device="cuda", generator=g) * 180 + 120
    f0 = f0 * (torch.rand((8, 1024), device="cuda", generator=g) > 0.1)
    source = draw_source(8, 1024 * SING_HOP, "cuda", g)
    kw = {"lj_v1": {}, "singing_nsf": {"f0": f0, "source": source}}

    # (b) HiFiGAN v3 from a written checkpoint
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(2)
        gen = HifiGanGenerator(HifiGanConfig.from_hparams(V3_VOCODER))
        with torch.no_grad():
            for m in gen.modules():
                if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
                    m.reset_parameters()
    fixtures.write_hifigan_dir(str(root / "v3"), gen.state_dict(), V3_VOCODER)
    hp_v3 = dict(lj, vocoder_ckpt=str(root / "v3"))
    v3, v3_cpu = HifiGAN(hp_v3), HifiGAN(hp_v3, device="cpu")
    mel_v3 = _voc_mel(torch, 2, 1024, 6)

    # (c) PWG at its defaults, an official release with its statistics
    pwg_cfg = PWGConfig()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        pwg_gen = ParallelWaveGANGenerator(pwg_cfg)
    stats = np.stack([np.linspace(-4.0, -1.0, 80), np.linspace(0.6, 1.2, 80)])
    fixtures.write_pwg_dir(str(root / "pwg"), pwg_gen.state_dict(),
                           {"layers": 30, "stacks": 3, "residual_channels": 64,
                            "gate_channels": 128, "skip_channels": 64, "aux_channels": 80,
                            "aux_context_window": 2,
                            "upsample_params": {"upsample_scales": [4, 4, 4, 4]}},
                           official=True, stats=stats)
    hp_pwg = dict(lj, vocoder="pwg", vocoder_ckpt=str(root / "pwg"))
    pwg = get_vocoder_cls(hp_pwg)(hp_pwg)  # the card
    pwg_cpu = PWG(hp_pwg, device="cpu")
    if not (isinstance(pwg, PWG) and pwg.scaler is not None and pwg.has_weights):
        raise AssertionError("vocoders: the PWG release did not load with its statistics")
    mel_pwg = _voc_mel(torch, 1, 1024, 7)[0].cpu().numpy()
    z = torch.randn((1, 1024 * 256), generator=torch.Generator().manual_seed(8))

    # the main path: every vocoder once, the MRF kernel's launches counted
    mrf.mrf_stage.launches = 0
    with torch.no_grad():
        main = {name: vocs[name][0].apply(mels[name], **kw[name]) for name in vocs}
        wav_v3 = v3.apply(mel_v3)
        wav_pwg = pwg.spec2wav(mel_pwg, z=z)
    launches = {"mrf_stage": mrf.mrf_stage.launches}

    out = {"card": card, "launches": launches, "bf16": {}}
    for name, (bf, f32) in vocs.items():
        with torch.no_grad(), plain_twins(mrf=mrf):
            plain = bf.apply(mels[name], **kw[name])
        got = main[name]
        scale = plain.abs().max().item()
        with torch.no_grad():
            wav32 = f32.apply(mels[name], **kw[name])
        out["bf16"][name] = {
            "B": 8, "T_mel": 1024, "samples": int(got.shape[1]),
            "finite": bool(torch.isfinite(got).all()), "wav_scale": scale,
            "kernel_vs_plain_max_abs_diff": (got - plain).abs().max().item(),
            # bf16 rounding, phase_mrf's rule, on the waveform's own scale (a
            # tanh output, below 1)
            "kernel_vs_plain_tolerance": 1e-2 * scale,
            "vs_float32_max_abs_diff": (got - wav32).abs().max().item()}
    with torch.no_grad():
        wav_v3_cpu = v3_cpu.apply(mel_v3.cpu())
    v3_scale = wav_v3_cpu.abs().max().item()
    out["v3"] = {"geometry": "upsample 8/8/4, kernels 16/16/8, 256 channels, resblock '2' "
                             "3/5/7 [[1,2],[2,6],[3,12]]",
                 "B": 2, "T_mel": 1024, "finite": bool(torch.isfinite(wav_v3).all()),
                 "wav_scale": v3_scale,
                 "card_vs_cpu_max_abs_diff": (wav_v3.cpu() - wav_v3_cpu).abs().max().item(),
                 "tolerance": 1e-4 * max(v3_scale, 1.0)}
    wav_pwg_cpu = pwg_cpu.spec2wav(mel_pwg, z=z)
    pwg_scale = float(np.abs(wav_pwg_cpu).max())
    out["pwg"] = {"config": "PWGConfig defaults: 30 layers, 3 stacks, 64/128/64 channels, "
                            "upsample 4^4", "T_mel": 1024, "samples": len(wav_pwg),
                  "finite": bool(np.isfinite(wav_pwg).all()), "wav_scale": pwg_scale,
                  "card_vs_cpu_max_abs_diff": float(np.abs(wav_pwg - wav_pwg_cpu).max()),
                  "tolerance": 1e-4 * max(pwg_scale, 1.0)}
    print("vocoders", json.dumps(out), flush=True)
    if launches != {"mrf_stage": 3 + 2}:
        raise AssertionError(f"vocoders: bf16 MRF launches {launches}, expected 3 (LJ) + 2 "
                             "(singing)")
    for name, r in out["bf16"].items():
        if not (r["finite"] and r["samples"] == 1024 * vocs[name][0].cfg.total_upsample
                and r["kernel_vs_plain_max_abs_diff"] <= r["kernel_vs_plain_tolerance"]):
            raise AssertionError(f"vocoders bf16 {name}: {r}")
    for name in ("v3", "pwg"):
        r = out[name]
        if not (r["finite"] and r["card_vs_cpu_max_abs_diff"] <= r["tolerance"]):
            raise AssertionError(f"vocoders {name}: {r}")
    if out["pwg"]["samples"] != 1024 * 256 or wav_v3.shape != (2, 1024 * 256):
        raise AssertionError(f"vocoders: PWG {out['pwg']['samples']}, v3 {tuple(wav_v3.shape)} "
                             "samples")
    return out


# -------------------------------------------------------------------- phase 7k
def _stack_autograd(x0, step_proj, cond, k_cond, b_cond, w_dil, b_dil, w_out, b_out, *,
                    dilations, compute_dtype=None):
    """The training stack's forward in its inputs' dtype, differentiated by
    autograd: the float64 reference of a training step on the CPU (the plain
    twin computes in float32)."""
    from diffsinger_tpu_torch.ops import diffnet_train as tr

    x, skips = x0, 0
    for i, d in enumerate(dilations):
        conv = tr._conv_pre(x + step_proj[i][:, None, :], cond, w_dil[i], k_cond[i], b_dil[i],
                            b_cond[i], d)
        gate, filt = conv.chunk(2, dim=-1)
        residual, skip = ((gate.sigmoid() * filt.tanh()) @ w_out[i] + b_out[i]).chunk(2, dim=-1)
        x = (x + residual) * tr.SQRT_HALF
        skips = skips + skip
    return skips


def _train_forward_f64_on_cpu(tasks):
    """``diffnet_train_forward`` whose float64 CPU calls run the DiffNet in
    float64 (the step embedding computed as ever, then widened; the stack by
    ``_stack_autograd``) and whose other calls run as before (the card: the
    kernels)."""
    import torch

    from diffsinger_tpu_torch.models.diffnet import pointwise, timestep_embedding
    from diffsinger_tpu_torch.ops.diffnet_train import pack_train_params

    kernel = tasks.diffnet_train_forward

    def forward(denoiser, spec, t, cond, *, compute_dtype=None):
        if not (spec.device.type == "cpu" and spec.dtype == torch.float64):
            return kernel(denoiser, spec, t, cond, compute_dtype=compute_dtype)
        n = denoiser.num_layers
        w_step, b_step, k_cond, b_cond, w_dil, b_dil, w_out, b_out = pack_train_params(denoiser)
        x0 = torch.relu(pointwise(spec, denoiser.input_projection))
        step = denoiser.mlp(timestep_embedding(t, denoiser.residual_channels).to(spec.dtype))
        step_proj = (step @ w_step + b_step).reshape(step.shape[0], n, -1).transpose(0, 1)
        skips = _stack_autograd(x0, step_proj, cond, k_cond, b_cond, w_dil, b_dil, w_out,
                                b_out, dilations=denoiser.dilations)
        x = torch.relu(pointwise(skips * (n ** -0.5), denoiser.skip_projection))
        return pointwise(x, denoiser.output_projection)

    return forward


def build_crf_synth(torch, seed: int = 0):
    """``build_synth`` with configs/lj/ds_beta6.yaml as shipped (cwt pitch,
    float32 stack) and ``dur_loss: crf``: the duration head's emissions favour
    6-10 frames a phone, and its Viterbi path picks each duration."""
    import torch.nn as nn

    from diffsinger_tpu_torch.config.hparams import set_hparams
    from diffsinger_tpu_torch.inference.serve import FusedSynthesizer
    from diffsinger_tpu_torch.inference.vocoder import HifiGAN
    from diffsinger_tpu_torch.training.tasks import DiffSingerTask

    hp = set_hparams(str(ROOT / "configs" / "lj" / "ds_beta6.yaml"))
    hp.update(dur_loss="crf", seed=seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        task = DiffSingerTask(hp, vocab_size=80, device="cpu")
        voc = HifiGAN(hp, device="cpu")
        with torch.no_grad():
            nn.init.normal_(task.denoise_fn.output_projection.weight, 0.0, 0.05)
            for m in voc.model.modules():
                if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
                    m.reset_parameters()
            lin = task.fs2.dur_predictor.linear
            lin.weight.mul_(2.0)
            lin.bias.fill_(-2.0)
            lin.bias[6:11] = torch.tensor([1.0, 1.4, 1.6, 1.4, 1.0])
            stats = task.fs2.cwt_stats_layers[4]   # log-F0 around 5.2, as build_synth
            stats.weight.mul_(0.1)
            stats.bias.copy_(torch.tensor([5.2, 0.35]))
    return hp, FusedSynthesizer(hp, task, voc)  # the card


def phase_crf(torch, ds, mrf, tr, card: str):
    """``dur_loss: crf`` with configs/lj/ds_beta6.yaml: two float32
    training steps on the cwt batch at 24 x 1024 (the training kernels). The
    first step: on 2 rows against the same step on the CPU in float64 by
    ``train_fs2``'s criterion for the FS2 side (the CRF head and the other
    predictors, which the denoiser does not reach; the losses all), and the
    training kernels against their plain twins by ``step_vs_plain`` and
    ``step_agrees_f32`` (the denoiser's gradients: a card step and a CPU
    step flip the ReLU after the skip projection at other near-zero inputs,
    so their denoiser gradients are printed, not judged). Then one 8 x 1024
    FusedSynthesizer batch on the CRF's Viterbi durations, the decode
    against the CPU's, the smallest best-to-second-best path gap, and log Z
    against a float64 host evaluation."""
    import copy

    import numpy as np

    from diffsinger_tpu_torch.ops import crf as crf_ops

    hp, trainer = build_task_trainer(torch, "configs/lj/ds_beta6.yaml", 80, dur_loss="crf")
    crf_mod = getattr(trainer.task.fs2.dur_predictor, "crf", None)
    if crf_mod is None or not crf_mod.transitions.requires_grad:
        raise AssertionError("crf: the duration head holds no trainable CRF")
    host = synthetic_cwt_batch(np.random.RandomState(0), 24, 128, 1024)
    batch = trainer.prepare_batch(host)
    rows = 2
    g = torch.Generator().manual_seed(9)
    t = torch.randint(0, int(hp["K_step"]), (rows,), generator=g)
    noise = torch.randn((rows, 1024, 80), generator=g)
    from diffsinger_tpu_torch.training import tasks

    with mock.patch.object(tasks, "diffnet_train_forward", _train_forward_f64_on_cpu(tasks)):
        vs_cpu = card_vs_cpu_step(torch, hp, trainer, batch, 80, rows=rows, draws=(t, noise),
                                  judged=lambda n: n.startswith("fs2."))
    vs_plain = step_vs_plain(torch, tr, trainer, batch, int(hp["K_step"]))
    ran, history = run_steps(tr, trainer, batch, STEPS)
    train = {"config": "configs/lj/ds_beta6.yaml, dur_loss: crf (cwt pitch, float32 stack)",
             "B": 24, "T_mel": 1024, "steps": STEPS, **ran, "first_loss": history[0],
             "last_loss": history[-1], "card_vs_cpu_rows": rows, "card_vs_cpu": vs_cpu,
             "kernel_vs_plain": vs_plain}
    del trainer, batch

    hp_s, syn = build_crf_synth(torch)
    rng = np.random.RandomState(5)
    big = [({"txt_tokens": rng.randint(3, 80, size=(1, 128)).astype(np.int64)}, 1024)
           for _ in range(8)]
    syn.warmup([1024], batch_sizes=(8,))
    ds.diffnet_stack.launches = 0
    mrf.mrf_stage.launches = 0
    wavs = syn.synthesize_many(big)
    launches = {"diffnet_stack": ds.diffnet_stack.launches, "mrf_stage": mrf.mrf_stage.launches,
                **ran["launches"]}
    # the decode the batch ran, on the card and on the CPU
    tokens = torch.from_numpy(np.concatenate([b["txt_tokens"] for b, _ in big]))
    (t_b, _, _), = syn.plan(big)
    fs2_cpu = copy.deepcopy(syn.task.fs2).cpu().eval()
    valid = tokens != 0
    valid[:, 0] = True
    with torch.no_grad():
        ret = syn.task.fs2(tokens.cuda(), t_mel=t_b, skip_decoder=True)
        ret_cpu = fs2_cpu(tokens, t_mel=t_b, skip_decoder=True)
        tables = [p.cpu().double() for p in fs2_cpu.dur_predictor.crf.tables()]
        gap = crf_ops.crf_viterbi_gap(ret_cpu["dur"].double(), valid, *tables)
        log_z = crf_ops.crf_log_partition(ret["dur"], valid.cuda(),
                                          *syn.task.fs2.dur_predictor.crf.tables())
        log_z64 = crf_ops.crf_log_partition(ret["dur"].cpu().double(), valid, *tables)
    dur, dur_cpu = ret["dur_choice"].cpu(), ret_cpu["dur_choice"]
    log_z = log_z.cpu().double()
    frames = [int(m) for m in (ret["mel2ph"] > 0).sum(1).cpu()]
    serve = {"B": 8, "T_txt": 128, "T_mel": 1024, "frames": frames,
             "dur_choice_equal_cpu": bool(torch.equal(dur, dur_cpu)),
             "dur_choice_differs_at": int((dur != dur_cpu).sum()),
             "dur_mean": float(dur.float().mean()), "dur_range": [int(dur.min()), int(dur.max())],
             "viterbi_min_gap": float(gap.min()),
             "log_z_max_rel_vs_float64": float(((log_z - log_z64).abs() / log_z64.abs()).max()),
             "wav_samples": [len(w) for w in wavs],
             "finite": all(bool(np.isfinite(w).all()) for w in wavs)}
    out = {"card": card, "train": train, "serve": serve, "launches": launches}
    print("crf", json.dumps(out), flush=True)
    k_step = int(hp_s["K_step"])
    if {k: launches[k] for k in ("diffnet_stack", "mrf_stage")} != {"diffnet_stack": k_step,
                                                                     "mrf_stage": 3}:
        raise AssertionError(f"crf: serving launches {launches}, expected {k_step} / 3")
    if ran["launches"] != {"diffnet_train_fwd": STEPS, "diffnet_train_bwd": STEPS}:
        raise AssertionError(f"crf: training launches {ran['launches']}")
    if not ({"pdur", "mel"} <= set(history[0]) and not {"wdur", "sdur"} & set(history[0])):
        raise AssertionError(f"crf: loss terms {sorted(history[0])}")
    if not all(np.isfinite(v) for h in history for v in h.values()):
        raise AssertionError(f"crf: non-finite losses {history}")
    if not (max(vs_cpu["loss_rel"].values()) <= 1e-4 and vs_cpu["grad_excess_worst"][0] <= 1e-3):
        raise AssertionError(f"crf: card vs CPU {vs_cpu}")
    if not step_agrees_f32(vs_plain):
        raise AssertionError(f"crf: train step kernel vs plain {vs_plain}")
    if not (serve["dur_choice_equal_cpu"] and serve["log_z_max_rel_vs_float64"] <= 1e-5
            and serve["finite"] and serve["wav_samples"] == [f * 256 for f in frames]):
        raise AssertionError(f"crf: serving {serve}")
    return out


# -------------------------------------------------------------------- phase 7l
# configs/base.yaml's audio settings; the rest of the task's hparams are its
# defaults (HiFiGAN v1's lr 2e-4 and betas 0.8 / 0.99; base.yaml's lr 2.0 and
# betas belong to the acoustic models' schedule)
VOC_AUDIO_KEYS = ("audio_sample_rate", "fft_size", "hop_size", "win_size",
                  "audio_num_mel_bins", "fmin", "fmax")
VOC_BATCH, VOC_FRAMES = 16, 32         # HiFiGAN v1's batch_size and segment_size / hop
VOC_SERVE = (8, 1024)                  # the trained generator's serving batch (B, frames)
VOC_MELGAN = (2, 1024)                 # MelGAN's mel batch


def voc_train_batch(torch, hp, root: Path, device, seed: int = 0):
    """16 aligned (mel, wav) crops of 32 frames from an LJ-style corpus of
    harmonic tones written under ``root``, the mels by ``ops/mel.py:wav2spec``
    and the crops by ``sample_segments``."""
    import numpy as np

    from diffsinger_tpu_torch.ops.mel import MelConfig, wav2spec
    from diffsinger_tpu_torch.tools import fixtures
    from diffsinger_tpu_torch.training.vocoder_task import sample_segments
    from diffsinger_tpu_torch.utils.misc import load_wav

    names = fixtures.write_lj_corpus(str(root / "raw"), str(root / "processed"), VOC_BATCH,
                                     seed=seed)
    cfg = MelConfig.from_hparams(hp)
    rng = np.random.RandomState(seed)
    mels, wavs = [], []
    for name in names:
        wav, mel = wav2spec(load_wav(str(root / "raw" / "wavs" / f"{name}.wav"),
                                     cfg.sample_rate), cfg)
        m, w = sample_segments(mel, wav, cfg.hop_size, VOC_FRAMES, rng)
        mels.append(m)
        wavs.append(w)
    return (torch.from_numpy(np.stack(mels)).to(device),
            torch.from_numpy(np.stack(wavs).astype(np.float32)).to(device))


def _grad_rel_l2(gk, gw, names):
    """{parameter: |error|_2 / |reference|_2}."""
    out = {}
    for n, a, w in zip(names, gk, gw):
        a, w = a.double().cpu(), w.double().cpu()
        scale = float(w.norm())
        out[n] = float((a - w).norm()) / scale if scale else float(a.norm())
    return out


def voc_card_vs_cpu(torch, task, hp, mel, wav, rows: int = 4) -> dict:
    """The D and G losses and gradients of one step (no update) on the card
    against the same on the CPU in float64, same weights, first ``rows``
    rows, with the CPU's float32 evaluation's distance from float64 as each
    parameter's allowance (``card_vs_cpu_step``'s rule). The distance is
    relative in the L2 norm: a leaky ReLU input within float32 rounding of 0
    takes the other slope in one evaluation, which moves the gradients of
    every layer below it by up to 5e-3 of their largest element (the CPU's
    float32 step on 4 rows: 4.9e-3 in the worst tensor, 6.5e-4 in L2), and
    the card and the CPU meet such inputs at different places. The max-norm
    readings are printed beside it."""
    from diffsinger_tpu_torch.training.vocoder_task import HifiGanTask

    names = [n for n, _ in task.named_parameters()]
    lk, dg, gg = task.losses_and_grads(mel[:rows], wav[:rows])
    cpu = HifiGanTask(hp, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in task.state_dict().items()})
    host = mel[:rows].cpu(), wav[:rows].cpu()
    _, dg32, gg32 = cpu.losses_and_grads(*host)
    l64, dg64, gg64 = cpu.to(torch.float64).losses_and_grads(*host)
    loss_rel = {k: abs(float(lk[k]) - float(l64[k])) / max(abs(float(l64[k])), 1e-12)
                for k in l64}
    card, f32, f64 = dg + gg, dg32 + gg32, dg64 + gg64
    vs64, d32 = _grad_rel_l2(card, f64, names), _grad_rel_l2(f32, f64, names)
    excess = {n: vs64[n] - d32[n] for n in names}
    at = max(names, key=excess.get)
    return {"rows": rows, "loss_rel": loss_rel, "grad_l2_excess_worst": [excess[at], at],
            "grad_l2_vs_cpu64_there": vs64[at], "cpu32_l2_vs_cpu64_there": d32[at],
            "grad_l2_worst_vs_cpu64": _worst(vs64), "cpu32_l2_vs_cpu64_worst": _worst(d32),
            "grad_max_worst_vs_cpu64": _worst(_grad_rel(card, f64, names)),
            "cpu32_max_vs_cpu64_worst": _worst(_grad_rel(f32, f64, names))}


def phase_vocoder_train(torch, mrf, card: str, out_dir: Path):
    """HiFi-GAN training (``training/vocoder_task.py:HifiGanTask``) at
    HiFiGAN v1's widths with configs/base.yaml's audio settings, seeded
    weights, MPD periods 2-11 and the 3-scale MSD, on 16 x 32-frame crops of
    a harmonic-tone corpus: the first step's losses and gradients on 4 rows
    against the CPU in float64, then two steps;
    the trained generator served through ``HifiGAN`` on an 8 x 1024 mel batch
    (the float32 MRF kernel: 3 launches) against the plain twins; MelGAN at
    its defaults on a 2 x 1024 mel batch, card against CPU; a PQMF
    analysis -> synthesis round trip of the batch's waveforms."""
    import copy

    import numpy as np

    from diffsinger_tpu_torch.config.hparams import set_hparams
    from diffsinger_tpu_torch.inference.vocoder import HifiGAN
    from diffsinger_tpu_torch.models.melgan import MelGANGenerator
    from diffsinger_tpu_torch.ops.pqmf import PQMF
    from diffsinger_tpu_torch.training.vocoder_task import HifiGanTask

    base = set_hparams(str(ROOT / "configs" / "base.yaml"))
    hp = {k: base[k] for k in VOC_AUDIO_KEYS}
    task = HifiGanTask(hp, generator=torch.Generator().manual_seed(0))
    cfg = task.gen_cfg
    if (cfg.upsample_initial_channel, cfg.upsample_rates, cfg.resblock,
            len(task.mpd.discriminators), len(task.msd.discriminators)) != (
                512, (8, 8, 2, 2), "1", 5, 3):
        raise AssertionError(f"vocoder_train: not HiFiGAN v1 with MPD 2-11 and MSD x3: {cfg}")
    mel, wav = voc_train_batch(torch, hp, out_dir / "vocoder_train", task.device)
    vs_cpu = voc_card_vs_cpu(torch, task, hp, mel, wav)

    history = [{k: float(v) for k, v in task.train_step(mel, wav).items()}
               for _ in range(STEPS)]
    train = {"config": "HiFiGAN v1 (512 ch, 8/8/2/2, k 16/16/4/4, resblock 1: 3/7/11 x "
                       "1/3/5), MPD 2/3/5/7/11, MSD x3, configs/base.yaml audio, lr 2e-4, "
                       "betas 0.8/0.99, float32 (TF32 off)",
             "B": VOC_BATCH, "segment_samples": VOC_FRAMES * cfg.total_upsample,
             "steps": STEPS, "first_logs": history[0], "last_logs": history[-1],
             "card_vs_cpu": vs_cpu}

    # the trained generator serves through the MRF kernel
    voc = HifiGAN(hp)
    voc.load_state_dict(task.gen.state_dict())
    del task
    serve_mel = _voc_mel(torch, *VOC_SERVE, 13)
    mrf.mrf_stage.launches = 0
    with torch.no_grad():
        got = voc.apply(serve_mel)
    launches = {"mrf_stage": mrf.mrf_stage.launches}
    with torch.no_grad(), plain_twins(mrf=mrf):
        plain = voc.apply(serve_mel)
    wav_scale = plain.abs().max().item()
    serve = {"B": VOC_SERVE[0], "T_mel": VOC_SERVE[1], "samples": int(got.shape[1]),
             "finite": bool(torch.isfinite(got).all()), "wav_scale": wav_scale,
             "kernel_vs_plain_max_abs_diff": (got - plain).abs().max().item(),
             "tolerance": 1e-4 * max(wav_scale, 1.0)}
    del voc

    # MelGAN at its defaults, card against CPU
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(4)
        mg_cpu = MelGANGenerator().eval()
    mg_mel = _voc_mel(torch, *VOC_MELGAN, 14)
    mg = copy.deepcopy(mg_cpu).to(mg_mel.device)
    with torch.no_grad():
        mg_wav = mg(mg_mel)
        mg_wav_cpu = mg_cpu(mg_mel.cpu())
    mg_scale = mg_wav_cpu.abs().max().item()
    melgan = {"config": "MelGANGenerator defaults: 512 ch, upsample 8/8/2/2, 3 stacks",
              "B": VOC_MELGAN[0], "T_mel": VOC_MELGAN[1], "samples": int(mg_wav.shape[1]),
              "finite": bool(torch.isfinite(mg_wav).all()), "wav_scale": mg_scale,
              "card_vs_cpu_max_abs_diff": (mg_wav.cpu() - mg_wav_cpu).abs().max().item(),
              "tolerance": 1e-4 * max(mg_scale, 1.0)}
    del mg, mg_cpu

    # PQMF: analysis -> synthesis of the batch's waveforms, aligned by the
    # bank's delay
    pq = PQMF(4, device=wav.device)
    rec = pq.synthesis(pq.analysis(wav))
    n = wav.shape[1]
    errs = torch.stack([(wav[:, : n - d] - rec[:, d:]).abs().mean() for d in range(80)])
    delay = int(errs.argmin())
    pqmf = {"subbands": 4, "taps": 62, "B": VOC_BATCH, "samples": n,
            "bands_shape": list(pq.analysis(wav).shape), "delay": delay,
            "mean_abs_err": float(errs[delay]), "mean_abs_level": float(wav.abs().mean())}

    out = {"card": card, "train": train, "serve": serve,
           "melgan": melgan, "pqmf": pqmf, "launches": launches}
    print("vocoder_train", json.dumps(out), flush=True)
    if set(history[0]) != {"d_loss", "g_loss", "mel", "fm", "adv"} or not all(
            np.isfinite(v) for h in history for v in h.values()):
        raise AssertionError(f"vocoder_train: logs {history}")
    if not (max(vs_cpu["loss_rel"].values()) <= 1e-4
            and vs_cpu["grad_l2_excess_worst"][0] <= 1e-3):
        raise AssertionError(f"vocoder_train: card vs CPU {vs_cpu}")
    if launches != {"mrf_stage": 3}:
        raise AssertionError(f"vocoder_train: serving launches {launches}, expected 3")
    if not (serve["finite"] and serve["samples"] == VOC_SERVE[1] * 256
            and serve["kernel_vs_plain_max_abs_diff"] <= serve["tolerance"]):
        raise AssertionError(f"vocoder_train: serving {serve}")
    if not (melgan["finite"] and melgan["samples"] == VOC_MELGAN[1] * 256
            and melgan["card_vs_cpu_max_abs_diff"] <= melgan["tolerance"]):
        raise AssertionError(f"vocoder_train: MelGAN {melgan}")
    if not (pqmf["bands_shape"] == [VOC_BATCH, n // 4, 4]
            and pqmf["mean_abs_err"] < 0.15 * pqmf["mean_abs_level"]):
        raise AssertionError(f"vocoder_train: PQMF {pqmf}")
    return out


# -------------------------------------------------------------------- phase 7m
PAR_STEPS = 3
PAR_BATCH = (24, 128, 1024)   # the train_shipped batch: rows, phones, frames
PAR_SERVE = (8, 128, 1024)    # the serve_shipped LJ batch
# the limits of the parallel phase, set before its first run: summation order
# only. Step 1 is the semantic check; each later step follows an AdamW update,
# whose g / (|g| + eps) turns rounding noise in a near-zero gradient into a
# visible weight difference, and float32 rounding flips a ReLU whose input is
# within rounding of 0 (the train_shipped notes)
PAR_LOSS_STEP1_RTOL = 1e-5
PAR_LOSS_LATER_RTOL = 1e-4
PAR_GRAD_REL_L2 = 1e-3
PAR_UPDATE_REL_L2 = 1e-2
# NCCL with one rank against the plain trainer: every loss within 1e-5, the
# first step's gradients within 1e-6 (relative L2), the three steps' weight
# updates within 1e-3 (relative L2 of the weights' difference over the plain
# run's update). The weights are not held element by element: atomics in
# cuDNN's weight gradients, the embedding backward and scatter_add make the
# plain step itself nondeterministic, and where a gradient is near AdamW's
# eps its update g / (|g| + eps) turns that noise into a visible difference
# (two plain runs on the card: 7.5e-7 apart in one call, 3.8e-5 in another)
PAR_ONE_RANK_RTOL = 1e-5
PAR_ONE_RANK_GRAD_REL_L2 = 1e-6
PAR_ONE_RANK_UPDATE_REL_L2 = 1e-3


def _par_compare(ref: dict, run: dict, init: dict) -> dict:
    """Losses of every step, the first step's summed gradients (relative L2
    of each trainable tensor) and the weights' updates (the relative L2 of
    the final weights' difference over the one-process run's update from
    ``init``) of a mesh run against a one-process run."""
    import numpy as np

    def rel(a, b):
        return float(abs(a - b) / max(abs(b), 1e-12))

    loss = [rel(r["total_loss"], w["total_loss"]) for r, w in zip(run["losses"], ref["losses"])]
    grads = {n: float(np.linalg.norm(run["grads"][n] - g) / max(np.linalg.norm(g), 1e-12))
             for n, g in ref["grads"].items()}
    worst = max(grads, key=grads.get)
    params = max(float(np.abs(run["state_dict"][k] - v).max())
                 for k, v in ref["state_dict"].items())
    diff = np.sqrt(sum(float(np.square(run["state_dict"][k] - v).sum())
                       for k, v in ref["state_dict"].items()))
    update = np.sqrt(sum(float(np.square(v - init[k]).sum())
                         for k, v in ref["state_dict"].items()))
    upd = float(diff / max(update, 1e-30))
    return {"loss_rel": loss, "grad_rel_l2_worst": grads[worst], "grad_worst_param": worst,
            "param_max_abs_diff": params, "update_rel_l2": upd,
            "ok": (loss[0] <= PAR_LOSS_STEP1_RTOL
                   and max(loss[1:], default=0.0) <= PAR_LOSS_LATER_RTOL
                   and grads[worst] <= PAR_GRAD_REL_L2 and upd <= PAR_UPDATE_REL_L2)}


def phase_parallel(torch, card: str, out_dir: Path, device: str = "cuda:0",
                   one_rank_backend: str = "nccl"):
    """Data and tensor parallelism on one card, configs/lj/ds_beta6.yaml as
    shipped (float32, cwt, the 3xTF32 training kernels) on the train_shipped
    batch (24 x 1024), seeded weights and draws (dropout on):
      (a) NCCL with one rank on cuda:0: three steps of the mesh trainer
          against the plain trainer from the same weights and generator;
      (b) two processes sharing the card: NCCL's refusal of two ranks on one
          device, then gloo (tensors staged through the host): dp=2 on 2 x 12
          rows and on a 23-row batch (padded to 24), and tp=2, each against
          the one-process run on the same global batch (first step's summed
          gradients, every step's loss); tp=2's resident bytes for the
          sharded parameters and their moments against tp=1;
      (c) DP serving on two processes: the shipped LJ 8 x 1024 batch
          (float32 stack) as 4 rows a rank against one process, waveforms
          within 1e-4 of their scale, 71 stack and 3 MRF launches a rank.
    These runs hold the semantics on one card; they do not measure scaling.
    ``device`` and ``one_rank_backend`` let a rehearsal run the phase on the
    CPU with gloo."""
    import datetime

    import numpy as np
    import torch.distributed as dist

    from diffsinger_tpu_torch.parallel.mesh import pad_batch_for_sharding, param_shardings
    from diffsinger_tpu_torch.tools import mesh_check as mc

    work = out_dir / "parallel"
    work.mkdir(parents=True, exist_ok=True)
    hp, trainer = build_trainer(torch, frame_pitch=False, compute_dtype=None)
    sd_path = work / "task.pt"
    init = {k: v.detach().cpu() for k, v in trainer.task.state_dict().items()}
    torch.save(init, sd_path)
    init = {k: v.float().numpy() for k, v in init.items()}
    names = sorted(param_shardings(trainer.task, 2, int(hp.get("tp_min_param_size", 1 << 16))))
    del trainer
    b, t_txt, t_mel = PAR_BATCH
    batch = synthetic_cwt_batch(np.random.RandomState(0), b, t_txt, t_mel)
    batch23 = {k: v[:b - 1] for k, v in batch.items()}   # a batch the data axis pads
    padded23 = {k: v for k, v in pad_batch_for_sharding(batch23, 2).items()
                if isinstance(v, np.ndarray)}
    base = {"hp": hp, "vocab": 80, "sil_ids": (3,), "state_dict": str(sd_path),
            "steps": PAR_STEPS, "device": device, "threads": 4}
    out = {"card": card, "config": "configs/lj/ds_beta6.yaml as shipped (cwt, float32)",
           "batch": [b, t_mel], "steps": PAR_STEPS, "sharded_names": len(names),
           "limits": {"loss_step1_rtol": PAR_LOSS_STEP1_RTOL,
                      "loss_later_rtol": PAR_LOSS_LATER_RTOL,
                      "grad_rel_l2": PAR_GRAD_REL_L2, "update_rel_l2": PAR_UPDATE_REL_L2,
                      "serving": "1e-4 x max(|wav|, 1)"}}

    # (a) the plain trainer, then the mesh trainer under NCCL with one rank
    ref = mc.train(0, 1, dict(base, batch=batch, sharded_names=names))
    repeat = _par_compare(ref, mc.train(0, 1, dict(base, batch=batch)), init)  # the card's spread
    ref23 = mc.train(0, 1, dict(base, batch=padded23))
    dist.init_process_group(one_rank_backend,
                            init_method=f"tcp://localhost:{mc.free_port()}",
                            world_size=1, rank=0, timeout=datetime.timedelta(seconds=300))
    try:
        one = mc.train(0, 1, dict(base, batch=batch))
    finally:
        dist.destroy_process_group()
    vs = _par_compare(ref, one, init)
    keys = ("loss_rel", "grad_rel_l2_worst", "param_max_abs_diff", "update_rel_l2")
    out["nccl_one_rank"] = {
        "backend": one_rank_backend, "mesh": one["mesh"], **{k: vs[k] for k in keys},
        "grad_worst_param": vs["grad_worst_param"],
        "plain_repeat": {k: repeat[k] for k in keys},
        "loss_rtol": PAR_ONE_RANK_RTOL, "grad_limit": PAR_ONE_RANK_GRAD_REL_L2,
        "update_limit": PAR_ONE_RANK_UPDATE_REL_L2, "launches": one["launches"]}
    print("parallel_nccl", json.dumps(out["nccl_one_rank"]), flush=True)
    if not (max(vs["loss_rel"]) <= PAR_ONE_RANK_RTOL
            and vs["grad_rel_l2_worst"] <= PAR_ONE_RANK_GRAD_REL_L2
            and vs["update_rel_l2"] <= PAR_ONE_RANK_UPDATE_REL_L2):
        raise AssertionError(f"parallel (a): the one-rank NCCL mesh trainer differs from "
                             f"the plain one: {out['nccl_one_rank']}")

    # (b) two processes on the one card: NCCL first, which must refuse
    try:
        probe = mc.spawn_ranks(mc.probe_all_reduce, 2, {"device": device,
                                                         "collective_timeout": 60},
                               backend=one_rank_backend, timeout=150)
        nccl = {"accepted": all(r["ok"] for r in probe), "ranks": probe}
    except (RuntimeError, TimeoutError) as e:
        nccl = {"accepted": False, "error": str(e)[-600:]}
    out["nccl_two_ranks_one_card"] = nccl
    print("parallel_nccl_probe", json.dumps(nccl), flush=True)

    rng = np.random.RandomState(3)
    sb, s_txt, s_mel = PAR_SERVE
    requests = [({"txt_tokens": rng.randint(3, 80, size=(1, s_txt)).astype(np.int64)}, s_mel)
                for _ in range(sb)]
    hp_s, syn = build_synth(torch, frame_pitch=False, stack_dtype=None)
    torch.save({k: v.detach().cpu() for k, v in syn.task.state_dict().items()},
               work / "serve_task.pt")
    torch.save({k: v.detach().cpu() for k, v in syn.vocoder.model.state_dict().items()},
               work / "serve_voc.pt")
    del syn
    serve = {"hp": hp_s, "vocab": 80, "state_dict": str(work / "serve_task.pt"),
             "voc_hp": hp_s, "voc_sd": str(work / "serve_voc.pt"), "requests": requests,
             "device": device, "warmup": True, "threads": 4}
    serve_one = mc.serve(0, 1, serve)
    torch.cuda.empty_cache()
    ranks = mc.spawn_ranks(mc.jobs, 2, {"threads": 4, "jobs": [
        ("dp24", "train", dict(base, batch=batch, num_data=2)),
        ("dp23", "train", dict(base, batch=batch23, num_data=2)),
        ("tp2", "train", dict(base, batch=batch, num_data=1, num_model=2,
                              hp=dict(hp, num_model_shards=2), sharded_names=names)),
        ("serve", "serve", serve)]}, backend="gloo", timeout=1200)
    checks = {}
    for key, want in (("dp24", ref), ("dp23", ref23), ("tp2", ref)):
        checks[key] = [dict(_par_compare(want, r[key], init), mesh=r[key]["mesh"],
                            launches=r[key]["launches"]) for r in ranks]
    for i, r in enumerate(ranks):
        checks["tp2"][i]["resident_bytes"] = r["tp2"]["resident_bytes"]
    checks["tp1_resident_bytes"] = ref["resident_bytes"]
    out["gloo"] = {"backend": "gloo (card tensors staged through the host)", **checks}
    print("parallel_gloo", json.dumps(out["gloo"]), flush=True)

    # (c) DP serving
    scale = max(float(np.abs(np.concatenate(serve_one["wavs"])).max()), 1.0)
    diffs = [max(float(np.abs(a - b).max()) for a, b in zip(r["serve"]["wavs"],
                                                           serve_one["wavs"])) for r in ranks]
    out["dp_serving"] = {"backend": "gloo", "rows_per_rank": sb // 2,
                         "wav_max_abs_diff": diffs, "tolerance": 1e-4 * scale,
                         "launches": [r["serve"]["launches"] for r in ranks],
                         "one_process_launches": serve_one["launches"]}
    print("parallel_serving", json.dumps(out["dp_serving"]), flush=True)

    out["launches"] = {k: one["launches"][k] + serve_one["launches"][k] + sum(
        r[j]["launches"][k] for r in ranks for j in ("dp24", "dp23", "tp2", "serve"))
        for k in one["launches"]}
    bad = [f"{k} rank {i}: {c}" for k in ("dp24", "dp23", "tp2")
           for i, c in enumerate(checks[k]) if not c["ok"]]
    if nccl["accepted"]:
        bad.append("NCCL accepted two ranks on one card")
    if not all(d <= out["dp_serving"]["tolerance"] for d in diffs):
        bad.append(f"DP serving waveforms differ by {diffs}")
    k_step = int(hp_s["K_step"])
    for r in ranks:
        if r["serve"]["launches"]["diffnet_stack"] != k_step or \
                r["serve"]["launches"]["mrf_stage"] != 3:
            bad.append(f"DP serving launches on rank {r['serve']['rank']}: "
                       f"{r['serve']['launches']}")
        for key in ("dp24", "dp23", "tp2"):
            ln = r[key]["launches"]
            if not ln["diffnet_train_fwd"] == ln["diffnet_train_bwd"] == PAR_STEPS + 1:
                bad.append(f"{key} training launches {ln}")
    if not all(c["resident_bytes"] * 2 <= checks["tp1_resident_bytes"] * 1.001
               for c in checks["tp2"]):
        bad.append("tp=2 holds more than half of tp=1's sharded bytes")
    if bad:
        raise AssertionError("parallel: " + "; ".join(bad))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    if not (ROOT / "diffsinger_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: diffsinger_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from diffsinger_tpu_torch.ops import _build
    from diffsinger_tpu_torch.ops import diffnet_stack as ds
    from diffsinger_tpu_torch.ops import diffnet_train as tr
    from diffsinger_tpu_torch.ops import hifigan_mrf as mrf

    card = card_line()
    print("card:", card, "| torch", torch.__version__, "cuda", torch.version.cuda,
          flush=True)
    built = _build.build()
    print(f"build: {[n for n, _, _ in built]}", flush=True)
    for name, secs, log in built:
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    stack_rows = phase_stack(torch, ds)
    mrf_rows = phase_mrf(torch, mrf)
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    serving = phase_serve(torch, ds, mrf, card)
    serving_cwt = phase_serve_cwt(torch, ds, mrf, card)
    singing = phase_sing(torch, ds, mrf, card)
    shipped = phase_serve_shipped(torch, ds, mrf, card)
    matrix = phase_shipped_matrix(torch, ds, mrf, card)
    wide = phase_wide(torch, ds, mrf, card)
    train_rows = phase_train_stack(torch, tr)
    training = phase_train(torch, tr, card)
    training_cwt = phase_train(torch, tr, card, cwt=True)
    training_shipped = phase_train_shipped(torch, tr, card)
    training_fs2 = phase_train_fs2(torch, card, out_dir)
    training_midi = phase_train_midi(torch, tr, card,
                                     training_fs2["opencpop_aux_rel"]["checkpoint"])
    training_pe = phase_train_pe(torch, card)
    cli_run = phase_cli(torch, ds, mrf, tr, card, out_dir)
    cascade = phase_cli_cascade(torch, ds, mrf, tr, card, out_dir)
    web = phase_serve_web(torch, ds, mrf, card, out_dir)
    vocoders = phase_vocoders(torch, mrf, card, out_dir)
    crf = phase_crf(torch, ds, mrf, tr, card)
    vocoder_train = phase_vocoder_train(torch, mrf, card, out_dir)
    parallel = phase_parallel(torch, card, out_dir)

    main_stack = stack_rows[0]                        # bf16, cycle 1: serving config
    # float32, cycle 1, 8 x 1024: the shipped configs' body (serve_shipped)
    f32_stack = next(r for r in stack_rows if r["dtype"] == "float32" and r["B"] == 8
                     and r["C"] == 256 and r["cycle"] == 1)
    # float32 at C = 128 / 64 / 32 (8 x 1024 mel frames): HiFiGAN v1's scales
    main_mrf = [r for r in mrf_rows if r["dtype"] == "float32" and r["B"] == 8 and r["C"] >= 32]
    # bfloat16 at C = 128 / 64 / 32 (8 x 1024 mel frames): the bf16 vocoder's scales
    bf16_mrf = [r for r in mrf_rows if r["dtype"] == "bfloat16" and r["B"] == 8]

    def path_launches(name, paths):
        """A kernel's launches on each main path that runs it, and their sum."""
        by_path = {path: out["launches"][name] for path, out in paths.items()
                   if name in out["launches"]}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    serve_paths = {"serving": serving, "serve_cwt": serving_cwt, "singing": singing,
                   "serve_shipped": shipped, "shipped_matrix": matrix, "wide": wide,
                   "cli": cli_run,
                   "cli_cascade": cascade,
                   "serve_web": web, "vocoders": vocoders, "crf": crf,
                   "vocoder_train": vocoder_train, "parallel": parallel}
    train_paths = {"train": training, "train_cwt": training_cwt,
                   "train_shipped": training_shipped, "train_midi": training_midi,
                   "cli": cli_run, "cli_cascade": cascade, "crf": crf, "parallel": parallel}

    kernels = [
        {"name": "diffnet_stack", "route": "cuda",
         "source": "diffsinger_tpu_torch/csrc/diffnet_stack.cu",
         "replaces": "diffsinger_tpu/ops/diffnet_stack.py:311",
         **path_launches("diffnet_stack", serve_paths),
         "max_abs_err": main_stack["max_abs_err"], "tolerance": main_stack["tolerance"],
         "ms": main_stack["ms"], "plain_ms": main_stack["plain_ms"],
         "bound_ms": main_stack["bound_ms"], "bound_by": main_stack["bound_by"],
         "library_ms": None,
         "float32": {k: f32_stack[k] for k in ("max_abs_err", "tolerance", "ms", "plain_ms",
                                               "bound_ms", "bound_by", "bound_fma_ms",
                                               "body", "device_launches")}
         | {"launches": shipped["launches"]["diffnet_stack"],
            "launches_path": "serve_shipped"},
         # float32 at C = 512: the wgmma body, every call of the wide path
         "float32_c512": {"body": "wgmma",
                          "launches": wide["launches"]["diffnet_stack_by_body"]["wgmma"],
                          "launches_path": "wide",
                          "ms": {f"{r['B']}x{r['T']} cycle {r['cycle']} k={r['k']}": r["ms"]
                                 for r in wide["stack"]}},
         "configs": stack_rows},
        {"name": "mrf_stage", "route": "cuda",
         "source": "diffsinger_tpu_torch/csrc/mrf_stage.cu",
         "replaces": "diffsinger_tpu/ops/hifigan_mrf.py:197",
         "also_replaces": "diffsinger_tpu/ops/hifigan_packed_mrf.py:231",
         **path_launches("mrf_stage", serve_paths),
         "max_abs_err": max(r["max_abs_err"] for r in main_mrf),
         "tolerance": min(r["tolerance"] for r in main_mrf),
         "ms": sum(r["ms"] for r in main_mrf),
         "plain_ms": sum(r["plain_ms"] for r in main_mrf),
         "bound_ms": sum(r["bound_ms"] for r in main_mrf),
         "bound_by": main_mrf[0]["bound_by"],
         "library_ms": None,
         "body": "wgmma",
         "by_C": [{k: r[k] for k in ("C", "T", "ms", "plain_ms", "bound_ms", "bound_share")}
                  for r in mrf_rows if r["dtype"] == "float32" and r["B"] == 8],
         "bfloat16": {"max_abs_err": max(r["max_abs_err"] for r in bf16_mrf),
                      "tolerance": min(r["tolerance"] for r in bf16_mrf),
                      "ms": sum(r["ms"] for r in bf16_mrf),
                      "plain_ms": sum(r["plain_ms"] for r in bf16_mrf),
                      "bound_ms": sum(r["bound_ms"] for r in bf16_mrf),
                      "bound_by": bf16_mrf[0]["bound_by"], "body": "tc",
                      "by_C": [{k: r[k] for k in ("C", "T", "ms", "plain_ms", "bound_ms",
                                                  "bound_by", "bound_mma_sync_ms")}
                               | {"bound_share": r["bound_ms"] / r["ms"],
                                  "mma_sync_share": r["bound_mma_sync_ms"] / r["ms"]}
                               for r in bf16_mrf],
                      "launches": vocoders["launches"]["mrf_stage"],
                      "launches_path": "vocoders"},
         "configs": mrf_rows},
    ]
    main_train = train_rows[0]                        # bf16, cycle 1: the slice config
    # float32, cycle 1, 24 x 1024: what the shipped configs train with
    f32_train = next(r for r in train_rows if r["dtype"] == "float32" and r["B"] == 24
                     and r["cycle"] == 1)
    # float32, cycle 4, 24 x 1500: the Opencpop training batch (train_midi)
    midi_train = next(r for r in train_rows if r["dtype"] == "float32" and r["T"] == 1500)
    for name, part in (("diffnet_train_fwd", "fwd"), ("diffnet_train_bwd", "bwd")):
        keys = ("skips", "xs") if part == "fwd" else tr.GRAD_NAMES

        def worst_tol(row):
            # the tolerance of the tensor with the largest error
            return max((row["errors"][k] for k in keys),
                       key=lambda e: e["max_abs_err"])["tolerance"]

        kernels.append(
            {"name": name, "route": "cuda", "source": "diffsinger_tpu_torch/csrc/diffnet_train.cu",
             "replaces": "diffsinger_tpu/ops/diffnet_train.py:" + ("315" if part == "fwd" else "389"),
             **path_launches(name, train_paths),
             "max_abs_err": main_train[f"{part}_max_abs_err"],
             "tolerance": worst_tol(main_train),
             "ms": main_train[f"{part}_ms"], "plain_ms": main_train[f"{part}_plain_ms"],
             "bound_ms": main_train[f"{part}_bound_ms"],
             "bound_by": main_train[f"{part}_bound_by"], "library_ms": None,
             "float32": {"max_abs_err": f32_train[f"{part}_max_abs_err"],
                         "tolerance": worst_tol(f32_train), "ms": f32_train[f"{part}_ms"],
                         "plain_ms": f32_train[f"{part}_plain_ms"],
                         "bound_ms": f32_train[f"{part}_bound_ms"],
                         "bound_by": f32_train[f"{part}_bound_by"],
                         "bound_fma_ms": f32_train[f"{part}_bound_fma_ms"],
                         "kernels": f32_train["kernels"],
                         "device_launches": f32_train[f"{part}_device_launches"],
                         "launches": training_shipped["launches"][name],
                         "launches_path": "train_shipped"},
             "float32_midi": {"B": 24, "T": 1500, "cycle": 4,
                              "max_abs_err": midi_train[f"{part}_max_abs_err"],
                              "tolerance": worst_tol(midi_train),
                              "ms": midi_train[f"{part}_ms"],
                              "plain_ms": midi_train[f"{part}_plain_ms"],
                              "bound_ms": midi_train[f"{part}_bound_ms"],
                              "bound_by": midi_train[f"{part}_bound_by"],
                              "bound_share": midi_train[f"{part}_bound_ms"]
                              / midi_train[f"{part}_ms"],
                              "device_launches": midi_train[f"{part}_device_launches"],
                              "launches": training_midi["launches"][name],
                              "launches_path": "train_midi"},
             "configs": [{k: v for k, v in r.items() if k != "errors"} for r in train_rows]})
    with open(out_dir / "chip_smoke.json", "w") as f:
        json.dump({"card": card, "kernels": kernels,
                   "serving": serving, "serve_cwt": serving_cwt, "singing": singing,
                   "serve_shipped": shipped, "shipped_matrix": matrix, "wide": wide,
                   "train_stack": train_rows, "training": training,
                   "train_cwt": training_cwt, "train_shipped": training_shipped,
                   "train_fs2": training_fs2, "train_midi": training_midi,
                   "train_pe": training_pe, "cli": cli_run, "cli_cascade": cascade,
                   "serve_web": web, "vocoders": vocoders, "crf": crf,
                   "vocoder_train": vocoder_train, "parallel": parallel}, f, indent=1)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
