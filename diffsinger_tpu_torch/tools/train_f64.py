"""How far the float32 training kernels and their plain twin each are from
float64.

    python3 -m diffsinger_tpu_torch.tools.train_f64 [B T [B T ...]]
        (default 24 1024 24 1500 24 2048)

For each shape, at C = H = 256, L = 20, dilation cycle 4, on seeded inputs as
``chip_smoke.py``'s ``train_stack`` phase draws them: one float32 backward on
the card (``diffnet_train_bwd``, the 3xTF32 kernels), the float32 plain twin,
and the plain twin's code evaluated in float64, all on the kernel's saved
``xs``. Prints one JSON line a shape: for each of the nine cotangents, its
scale (max |float64|) and each float32 result's max error from the float64
one over that scale (a drift that grows with T points at a sum over rows),
and the backward's mean time over five calls after one (CUDA events).
Runs on the GPU only.
"""

from __future__ import annotations

import json
import sys

import torch


def main(argv) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("train_f64 runs on the GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from diffsinger_tpu_torch.ops import _build
    from diffsinger_tpu_torch.ops import diffnet_train as tr

    _build.build()
    nums = [int(a) for a in argv] or [24, 1024, 24, 1500, 24, 2048]
    c = h = 256
    num_layers = 20
    dil = tuple(2 ** (i % 4) for i in range(num_layers))
    for b, t in zip(nums[::2], nums[1::2]):
        gen = torch.Generator(device="cuda").manual_seed(2)

        def rn(*shape, scale=1.0):
            return torch.randn(*shape, generator=gen, device="cuda") * scale

        args = (torch.relu(rn(b, t, c)), rn(num_layers, b, c, scale=0.5), rn(b, t, h),
                rn(num_layers, h, 2 * c, scale=h ** -0.5), rn(num_layers, 2 * c, scale=0.1),
                rn(num_layers, 3, c, 2 * c, scale=(3 * c) ** -0.5),
                rn(num_layers, 2 * c, scale=0.1), rn(num_layers, c, 2 * c, scale=c ** -0.5),
                rn(num_layers, 2 * c, scale=0.1))
        ds = rn(b, t, c)
        kw = dict(dilations=dil, compute_dtype=None)
        _, xs = tr.diffnet_train_fwd(*args, **kw)
        bwd_in = (xs, *args[1:8], ds)
        got = tr.diffnet_train_bwd(*bwd_in, **kw)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            tr.diffnet_train_bwd(*bwd_in, **kw)
        end.record()
        torch.cuda.synchronize()
        plain = tr.diffnet_train_stack_bwd_plain(*bwd_in, **kw)
        want = tr.diffnet_train_stack_bwd_plain(*[a.double() for a in bwd_in], dilations=dil,
                                                acc_dtype=torch.float64)
        torch.cuda.synchronize()
        row = {"device": torch.cuda.get_device_name(0), "B": b, "T": t, "cycle": 4,
               "bwd_ms": start.elapsed_time(end) / 5}
        for name, k_, p_, w_ in zip(tr.GRAD_NAMES, got, plain, want):
            scale = w_.abs().max().item()
            row[name] = {"scale": scale,
                         "kernel_rel_err": (k_.double() - w_).abs().max().item() / scale,
                         "plain_rel_err": (p_.double() - w_).abs().max().item() / scale}
        print("train_f64", json.dumps(row), flush=True)
        del got, plain, want, xs, bwd_in, args, ds
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1:])
