#!/usr/bin/env python3
"""Run one cell of the benchmark of diffsinger_tpu_torch once, on this machine's
NVIDIA GPU:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the program with seeded weights, warms the cell's own shapes (set-up,
``setup_s``), drives the cell's traffic for ``--seconds``, frees the program,
holds a sample of its outputs to the plain reference, and prints one JSON
line last on standard output. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics and the device's busy time.

Two options serve setting the limits of ``correct`` and are not part of a
check: ``--readings N`` reads the compared numbers for N seeds from
``--seed`` on in one process (a short window each, the program kept), and
``--control M`` adds, for the first M of them, the numbers of the control
(the reference with TF32 in the program's place). They print one JSON line
per seed and no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

FORBIDDEN = ("jax", "jaxlib", "flax", "diffsinger_tpu")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    flax's or the JAX package's, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0, choices=(0, 1))
    ap.add_argument("--readings", type=int, default=0)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--fault", default="")
    args = ap.parse_args(argv)

    from benchmark.harness import manifest

    bench = manifest.load()
    cell = manifest.cell(bench, args.workload)
    config = manifest.config(bench, cell["config"])
    from benchmark.harness.traffic import load_mix

    mix = load_mix(cell["traffic"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        log(f"needs {cell['chips']} CUDA device(s): is_available="
            f"{torch.cuda.is_available()}, count={torch.cuda.device_count()}")
        return 2
    card = card_line()
    log(f"card: {card}")
    from benchmark.harness import check

    kind = cell_class(mix)
    if args.readings:
        return readings(kind(cell, config, mix, None, "cuda", log), args)

    limits = manifest.limits(cell["name"])
    run = kind(cell, config, mix, limits, "cuda", log)
    torch.cuda.reset_peak_memory_stats()
    run.setup(args.seed, bool(args.trace))
    setup_s = time.perf_counter() - T_START
    from diffsinger_tpu_torch.ops import diffnet_stack, diffnet_train, hifigan_mrf

    entries = {"diffnet_stack": diffnet_stack, "mrf_stage": hifigan_mrf,
               "diffnet_train_fwd": diffnet_train, "diffnet_train_bwd": diffnet_train}

    def launches():
        """The program's own counts of the kernel ops' calls."""
        return [getattr(m, n).launches for n, m in entries.items()]

    before = launches()
    out = run.window(args.seconds, bool(args.trace))
    torch.cuda.synchronize()
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(int(cell["chips"])))
    log(f"window: {out['window_s']:.3f} s, {out['calls']} calls, {out['attempted']} requests, "
        f"{out['failed']} failed; kernel calls "
        f"{dict(zip(entries, (a - b for a, b in zip(launches(), before))))}")
    if out.get("latencies_s"):
        lat = out["latencies_s"]
        log(f"request latency: median {statistics.median(lat) * 1e3:.3f} ms over "
            f"{len(lat)} requests")
    if "trace" in out:
        tr = out["trace"]
        log(f"trace: busy {tr['busy_s']:.4f} s of {tr['window_s']:.4f} s; "
            f"{tr['device_events']} device events, {tr['unlaunched_events']} not tied to a "
            f"launch; op calls timed {({k: len(v) for k, v in tr['op_s'].items()})}; "
            f"events by kind {tr['kinds']}")

    run.free()
    t_check = time.perf_counter()
    ref = run.reference(args.seed)
    numbers, samples = run.judge(out, ref)
    del ref
    log(f"reference check: {time.perf_counter() - t_check:.3f} s for {samples} batches")
    correct = check.verdict(numbers, limits, samples, out["failed"])

    readings_of_run = {"setup_s": setup_s, "window": out, "trace": out.get("trace"),
                       "op_counts": out.get("op_counts", {})}
    group = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in manifest.metrics_of(bench, cell["name"], group):
        v = manifest.reader(m["name"])(readings_of_run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if args.trace:
        device["busy_s"] = out["trace"]["busy_s"]
        device["window_s"] = out["trace"]["window_s"]
        result["breakdown"] = out["trace"]["breakdown"]
    result["card"] = card
    result["checks"] = {k: {"value": numbers.get(k, float("inf")), "limit": v}
                        for k, v in limits.items()}
    result["checks"]["batches_compared"] = {"value": samples, "limit": 1}

    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded in this process: {found}")
        return 3
    for k, c in result["checks"].items():
        log(f"check {k}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


def cell_class(mix):
    """The runner of a mix's kind: serving calls or training steps."""
    if mix["kind"] == "train_steps":
        from benchmark.harness.training import TrainCell

        return TrainCell
    from benchmark.harness.serving import Cell

    return Cell


def readings(run, args) -> int:
    """The compared numbers of the program, and of the control, over seeds:
    a serving cell's after a short window each (the program built once), a
    training cell's after its checked steps (a trainer built for each seed);
    with ``--fault`` of the program with that fault planted."""
    import contextlib

    from benchmark.harness import faults
    from benchmark.harness.training import TrainCell

    with faults.ALL[args.fault]() if args.fault else contextlib.nullcontext():
        return _readings(run, args, TrainCell)


def _readings(run, args, TrainCell) -> int:
    import torch

    for j in range(args.readings):
        seed = args.seed + j
        if isinstance(run, TrainCell):
            run.free()
            run.setup(seed, False)
            out = {"attempted": 0, "failed": 0}
        else:
            if j == 0:
                run.setup(seed, False)
            else:
                run.program.load(run.weights(seed))
                run.setup_traffic(seed)
            out = run.window(args.seconds, False)
        ref = run.reference(seed)
        numbers, samples = run.judge(out, ref)
        line = {"seed": seed, "program": numbers, "samples": samples,
                "attempted": out["attempted"], "failed": out["failed"]}
        if args.fault:
            line["fault"] = args.fault
        line.update(getattr(run, "diagnostics", {}))
        if j < args.control:
            line["control"], _ = run.judge(out, ref, tf32_control=True)
            line.update(getattr(run, "diagnostics", {}))
        del ref
        torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
