"""Where a float32 FastSpeech2 training step departs from float64.

    python3 -m diffsinger_tpu_torch.tools.fs2_f32_drift

Runs on the CPU. For configs/lj/fs2.yaml and configs/opencpop/aux_rel.yaml,
with the weights ``chip_smoke.py``'s ``train_fs2`` phase draws (seed 0) and
the first 4 rows of its synthetic batches (24 x 1024 cwt, 24 x 1500 MIDI),
one deterministic step's gradients in float64, in float32, and in float32
with LayerNorms evaluated in float64: every one, only those of eps 1e-12
(the variance predictors' Conv -> ReLU -> LayerNorm blocks), or only the
others (eps 1e-6: the FFT blocks' and the encoder's). Prints one JSON line a
config: for each float32 variant, the parameter whose gradient sits
farthest from float64 and that distance over the float64 gradient's scale.
A variant whose distance falls to the size of the other parameters' locates
the float32 gap in the layer norms it evaluates in float64.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[2]
CASES = (("configs/lj/fs2.yaml", "cwt", 128, 1024), ("configs/opencpop/aux_rel.yaml", "midi",
                                                     150, 1500))


def _rel(got, want, names):
    out = {}
    for n, a, w in zip(names, got, want):
        a, w = a.double(), w.double()
        scale = float(w.abs().max())
        out[n] = float((a - w).abs().max()) / scale if scale else float(a.abs().max())
    return out


def main() -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from diffsinger_tpu_torch.config.hparams import set_hparams
    from diffsinger_tpu_torch.training import tasks
    from diffsinger_tpu_torch.training.trainer import Trainer

    as_tensor, layer_norm = tasks._as_tensor, F.layer_norm

    def ln_in_f64(which):
        """F.layer_norm evaluated in float64 where ``which(eps)`` holds."""
        def ln(x, shape, weight=None, bias=None, eps=1e-5):
            if not which(eps):
                return layer_norm(x, shape, weight, bias, eps)
            return layer_norm(x.double(), shape, weight.double(), bias.double(),
                              eps).to(x.dtype)
        return ln

    for config, kind, t_txt, t_mel in CASES:
        hp = set_hparams(str(ROOT / config))
        hp.update(seed=0)
        vocab = 80 if kind == "cwt" else cs.cpop_vocab()
        torch.manual_seed(0)
        base = tasks.build_task(hp, vocab_size=vocab, device="cpu")
        state = base.state_dict()
        rng = np.random.RandomState(0)
        host = (cs.synthetic_cwt_batch(rng, 24, t_txt, t_mel) if kind == "cwt"
                else cs.synthetic_midi_batch(rng, 24, t_txt, t_mel, vocab))
        host = {k: torch.as_tensor(v[:4]) for k, v in host.items()}
        names = [n for n, p in base.named_parameters() if p.requires_grad]

        def grads(dtype, ln=layer_norm):
            task = tasks.build_task(hp, vocab_size=vocab, device="cpu", sil_ids=base.sil_ids)
            task.load_state_dict(state)
            task.to(dtype)
            trainer = Trainer(hp, task, device="cpu")
            trainer.initialize()
            with mock.patch.object(tasks, "_as_tensor", lambda v, dt, dev: as_tensor(
                    v, dtype if dt == torch.float32 else dt, dev)), \
                    mock.patch.object(F, "layer_norm", ln):
                return trainer.loss_and_grads(host, deterministic=True)[1]

        g64 = grads(torch.float64)
        row = {"config": config, "rows": 4, "T_mel": t_mel}
        for label, g in (("float32", grads(torch.float32)),
                         ("float32_every_layer_norm_in_float64",
                          grads(torch.float32, ln_in_f64(lambda eps: True))),
                         ("float32_eps_1e-12_layer_norms_in_float64",
                          grads(torch.float32, ln_in_f64(lambda eps: eps <= 1e-12))),
                         ("float32_other_layer_norms_in_float64",
                          grads(torch.float32, ln_in_f64(lambda eps: eps > 1e-12)))):
            rel = _rel(g, g64, names)
            worst = max(rel, key=rel.get)
            row[label] = {"worst_param": worst, "rel_err": rel[worst]}
        print("fs2_f32_drift", json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
