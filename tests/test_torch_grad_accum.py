"""The port's per-epoch ``accumulate_grad_batches`` dict against the JAX
package: ``grad_accum_schedule`` against JAX's over a few epochs, its
errors, and a ``Trainer.fit`` run whose updates per epoch match what
``optax.MultiSteps`` with JAX's schedule makes of the same mini-steps."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as g
from diffsinger_tpu.training import schedules as jsched
from diffsinger_tpu_torch.training import schedules as tsched
from diffsinger_tpu_torch.training.tasks import FastSpeech2Task
from diffsinger_tpu_torch.training.trainer import Trainer, build_optimizer

torch.set_num_threads(1)


@pytest.mark.parametrize("sched,bpe", [({1: 1, 2: 2}, 4), ({2: 3, 5: 2}, 7),
                                       ({1: 4, 3: 1, 4: 8}, 10), ({3: 2}, 5)])
def test_grad_accum_schedule_matches_jax(sched, bpe):
    want = jsched.grad_accum_schedule(sched, bpe)
    got = tsched.grad_accum_schedule(sched, bpe)
    for u in range(0, 8 * bpe):
        assert got(u) == int(want(jnp.asarray(u))), u


def test_grad_accum_schedule_errors_match_jax():
    for fn in (jsched.grad_accum_schedule, tsched.grad_accum_schedule):
        with pytest.raises(TypeError):
            fn({}, 4)
        with pytest.raises(IndexError):
            fn({0: 2}, 4)
    with pytest.raises(ValueError, match="batches_per_epoch"):
        build_optimizer({"accumulate_grad_batches": {1: 1, 2: 2}, "lr": 1e-3,
                         "decay_steps": 100}, [torch.nn.Parameter(torch.zeros(2))])


def _jax_updates(sched, bpe, mini_steps):
    """optax.MultiSteps' update count after each mini-step."""
    tx = optax.MultiSteps(optax.sgd(1.0),
                          every_k_schedule=jsched.grad_accum_schedule(sched, bpe))
    p = jnp.zeros(2)
    state = tx.init(p)
    out = []
    for _ in range(mini_steps):
        _, state = tx.update(jnp.ones(2), state, p)
        out.append(int(state.gradient_step))
    return out


class _Batches:
    """A dataset of fixed batches with the two methods ``fit`` reads."""

    def __init__(self, batches):
        self._batches = batches

    def batches(self, **kw):
        return [[i] for i in range(len(self._batches))]

    def iter_batches(self, **kw):
        yield from self._batches


def test_fit_with_a_per_epoch_dict_updates_as_jax(tmp_path):
    from tests.test_torch_cwt_train import make_batch

    sched, bpe, epochs = {1: 1, 2: 2}, 4, 3
    hp = {**g._tiny_hp(), "hidden_size": 32, "task_cls": "fs2", "enc_layers": 1,
          "dec_layers": 1, "accumulate_grad_batches": sched, "max_updates": bpe * epochs,
          "val_check_interval": 1000, "log_interval": 1000, "num_sanity_val_steps": 0,
          "work_dir": str(tmp_path)}
    task = FastSpeech2Task(hp, 16, device="cpu", sil_ids=(3,))
    batch = make_batch("frame")
    trainer = Trainer(hp, task, device="cpu")
    counts = []
    step = trainer.train_step

    def counting(b):
        losses = step(b)
        counts.append(trainer.optimizer.num_updates)
        return losses

    trainer.train_step = counting
    trainer.fit(_Batches([batch] * bpe))
    assert trainer.batches_per_epoch == bpe and trainer.global_step == bpe * epochs
    assert counts == _jax_updates(sched, bpe, bpe * epochs)
    per_epoch = np.diff([0] + counts[bpe - 1::bpe]).tolist()
    assert per_epoch == [4, 2, 2]
