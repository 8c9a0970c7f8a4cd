"""The float32 stack at each column split k, side by side, on the card.

    python3 -m diffsinger_tpu_torch.tools.stack_split [--channels C] [--against]
        [CYCLE:BxT ...]  (default 4:1x1152 4:1x2432 1:4x384 1:16x640 1:8x1024 1:1x256)

For each shape (C = 256 unless ``--channels``, L = 20, dilations
2^(i % CYCLE)) it runs every k of ``splits_for(C)`` the card holds through
the wrapper, its rule ``column_split`` replaced for the call by one that
names that k, checks each against the width's smallest split k0 (1e-4 of
the output's scale), times each with CUDA events, and prints one JSON line:
the card's resident tiles by k, the k ``column_split`` picks, the
milliseconds of each k, and each k's cost beyond k0/k of a k0 block,
``ms_k * k / (ms_k0 * k0) - 1``, which is what ``SPLIT_COST[C]`` holds. The
cost is read where every k runs one wave (few tiles), else it includes the
waves. ``--against`` also times the plain twin (TF32 off) and the SIMT body
on the same inputs and checks both against k0. Runs on the GPU only.
"""

from __future__ import annotations

import json
import sys
from unittest import mock

DEFAULT = ("4:1x1152", "4:1x2432", "1:4x384", "1:16x640", "1:8x1024", "1:1x256")


def main(argv) -> int:
    import torch

    from diffsinger_tpu_torch.ops import diffnet_stack as ds

    if not torch.cuda.is_available():
        print("stack_split: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    against = "--against" in argv
    argv = [a for a in argv if a != "--against"]
    c, num_layers = 256, 20
    if argv[:1] == ["--channels"]:
        c, argv = int(argv[1]), argv[2:]
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    def ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    for spec in argv or DEFAULT:
        cycle, shape = spec.split(":")
        b, t = (int(v) for v in shape.split("x"))
        dil = tuple(2 ** (i % int(cycle)) for i in range(num_layers))
        args = (torch.relu(rn(b, t, c)), rn(num_layers, b, c, scale=0.5),
                rn(num_layers, b, t, 2 * c, scale=0.5),
                rn(num_layers, 3, c, 2 * c, scale=(3 * c) ** -0.5),
                rn(num_layers, 2 * c, scale=0.1), rn(num_layers, c, 2 * c, scale=c ** -0.5),
                rn(num_layers, 2 * c, scale=0.1))
        resident = ds._resident(c, max(dil), torch.cuda.current_device())
        outs, times = {}, {}
        for k in [j for j in ds.splits_for(c) if resident.get(j, 0) > 0]:
            with mock.patch.object(ds, "column_split", lambda *_, k=k: k):
                outs[k] = ds.diffnet_stack(*args, dilations=dil)
                if ds.diffnet_stack.column_split != k:
                    raise AssertionError(f"{spec}: asked for k = {k}, the library ran "
                                         f"{ds.diffnet_stack.column_split}")
                times[k] = ms(lambda: ds.diffnet_stack(*args, dilations=dil))
        k0 = min(outs)
        if against:
            outs["plain"] = ds.diffnet_stack_plain(*args, dilations=dil)
            times["plain"] = ms(lambda: ds.diffnet_stack_plain(*args, dilations=dil), 3)
            with mock.patch.object(ds, "_body", lambda *_: 0):
                outs["simt"] = ds.diffnet_stack(*args, dilations=dil)
                times["simt"] = ms(lambda: ds.diffnet_stack(*args, dilations=dil), 3)
        scale = max(float(outs[k0].abs().max()), 1.0)
        err = {k: float((outs[k] - outs[k0]).abs().max()) for k in outs}
        if max(err.values()) > 1e-4 * scale:
            raise AssertionError(f"{spec}: a body differs from k = {k0}: {err}")
        print("stack_split", json.dumps({
            "C": c, "cycle": int(cycle), "B": b, "T": t, "resident": resident,
            "rule_k": ds.column_split(b, t, c, resident), "ms": times, "err_vs_k0": err,
            "cost": {k: times[k] * k / (times[k0] * k0) - 1.0 for k in times
                     if isinstance(k, int)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
