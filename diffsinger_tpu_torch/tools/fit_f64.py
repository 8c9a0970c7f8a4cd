"""How far the training kernels' backward is from float64 on a CLI run's own
batch.

    python3 -m diffsinger_tpu_torch.tools.fit_f64 CONFIG EXP_NAME [CKPT_ROOT]

Restores the run's last checkpoint (``cli.train``'s work directory under
CKPT_ROOT, default ``checkpoints``) and takes the batches ``chip_smoke.py``'s
``fit_batches_vs_plain`` takes: the training split's largest batch as
``fit`` batches it (shuffle seeded 0) and the first validation batch. For
each, one deterministic step with the kernels (t and noise seeded 7, as
``step_vs_plain``) records the stack backward's inputs; on them run the
kernel backward (``diffnet_train_bwd``), the plain twin, and the plain
twin's steps in float64 (rounded to the compute dtype at the same points).
Prints one JSON line a batch: for each of the nine cotangents, at the layer
where the kernel and the twin differ most over that layer's scale (the
step check's measure), the float64 scale, each result's max error from
float64 over it, and the worst such errors over the layers. Runs on the
GPU only.
"""

from __future__ import annotations

import json
import sys
from unittest import mock

import numpy as np
import torch


def main(argv) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("fit_f64 runs on the GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from diffsinger_tpu_torch import cli
    from diffsinger_tpu_torch.config.hparams import set_hparams
    from diffsinger_tpu_torch.data.dataset import FastSpeechDataset
    from diffsinger_tpu_torch.ops import _build
    from diffsinger_tpu_torch.ops import diffnet_train as tr
    from diffsinger_tpu_torch.training.trainer import Trainer

    _build.build()
    config, exp_name = argv[0], argv[1]
    hp = set_hparams(config, exp_name, ckpt_root=argv[2] if len(argv) > 2 else "checkpoints")
    _, task = cli._build(hp, "cuda")
    trainer = Trainer(hp, task, device="cuda")
    trainer.initialize()
    np.random.seed(0)
    batches = {"train": max(FastSpeechDataset(hp, "train", shuffle=True).iter_batches(),
                            key=lambda b: b["mels"].size),
               "valid": next(FastSpeechDataset(hp, "valid").iter_batches(
                   max_sentences=int(hp["max_eval_sentences"])))}
    bwd = tr.diffnet_train_bwd
    for kind, host in batches.items():
        batch = trainer.prepare_batch(host)
        b, t_mel, n_mels = batch["mels"].shape
        gen = torch.Generator(device="cuda").manual_seed(7)
        t = torch.randint(0, int(hp["K_step"]), (b,), generator=gen, device="cuda")
        noise = torch.randn((b, t_mel, n_mels), generator=gen, device="cuda")
        seen = []

        def record(*args, **kw):
            seen.append((args, kw))
            return bwd(*args, **kw)

        # the wrapper counts its launches on the module's name, this one
        record.launches = 0

        with mock.patch.object(tr, "diffnet_train_bwd", record):
            trainer.loss_and_grads(batch, t=t, noise=noise, deterministic=True)
        args, kw = seen[0]
        got = bwd(*args, **kw)
        plain = tr.diffnet_train_stack_bwd_plain(*args, **kw)
        want = tr.diffnet_train_stack_bwd_plain(*[a.double() for a in args], **kw,
                                                acc_dtype=torch.float64)
        torch.cuda.synchronize()
        row = {"device": torch.cuda.get_device_name(0), "config": config,
               "exp_name": exp_name, "step": trainer.global_step, "batch": kind,
               "batch_shape": [b, t_mel, n_mels],
               "compute_dtype": str(kw.get("compute_dtype")),
               "ds_max_abs": args[-1].abs().max().item()}
        for name, k_, p_, w_ in zip(tr.GRAD_NAMES, got, plain, want):
            k_, p_ = k_.double(), p_.double()
            # per layer where the cotangent has one, as the step's check
            # measures each layer's parameter against its own scale
            per = name not in ("x0", "cond")
            k_, p_, w_ = ((a if per else a[None]).flatten(1) for a in (k_, p_, w_))
            scale = w_.abs().amax(1)
            rel = {"kernel_rel_err": (k_ - w_).abs().amax(1) / scale,
                   "plain_rel_err": (p_ - w_).abs().amax(1) / scale,
                   "kernel_vs_plain": (k_ - p_).abs().amax(1) / p_.abs().amax(1)}
            at = int(rel["kernel_vs_plain"].argmax())
            row[name] = {"layer": at if per else None, "scale": scale[at].item(),
                         **{k: v[at].item() for k, v in rel.items()},
                         "worst_kernel_rel_err": rel["kernel_rel_err"].max().item(),
                         "worst_plain_rel_err": rel["plain_rel_err"].max().item()}
        print("fit_f64", json.dumps(row), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
