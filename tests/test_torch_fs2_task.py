"""The port's FastSpeech2 task against the JAX package's: ``train_loss`` loss
by loss with every gradient for frame pitch, for cwt pitch (as
``configs/lj/fs2.yaml``) and for the MIDI variant with the ssim mel loss (as
``configs/opencpop/aux_rel.yaml``); ``inference``; and ``build_task`` over
every shipped config's ``task_cls``.

Shapes: hidden 32 (cwt head 16), two encoder and two decoder layers, B=2,
12-16 phones, 48-64 frames; dropout 0, JAX ``deterministic=True``.
Tolerances: loss terms rtol 1e-5; gradients rtol 1e-4, atol 1e-5 after
dividing by max(1, |g|max); the inference mel atol 5e-5.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as g
from diffsinger_tpu.config.hparams import set_hparams as jset_hparams
from diffsinger_tpu.training.tasks import FastSpeech2Task as JFS2Task
from diffsinger_tpu.training.tasks import build_task as jbuild_task
from diffsinger_tpu_torch.config.hparams import set_hparams
from diffsinger_tpu_torch.convert.from_jax import task_state_dict
from diffsinger_tpu_torch.training.tasks import FastSpeech2Task, build_task
from tests import test_torch_cwt_train as cwt_case
from tests import test_torch_midi_train as midi_case

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
VOCAB = 16
SIL = (3,)
VARIANTS = {
    "frame": ({"pitch_type": "frame", "mel_loss": "l1"}, {"l1", "uv", "f0"}),
    "cwt": ({"pitch_type": "cwt", "cwt_hidden_size": 16, "mel_loss": "l1"},
            {"l1", "C", "uv", "f0_mean", "f0_std"}),
    "midi": ({"pitch_type": "frame", "use_midi": True, "rel_pos": True,
              "mel_loss": "ssim:0.5|l1:0.5"}, {"ssim", "l1", "uv", "f0"}),
}


def _hp(variant):
    hp = g._tiny_hp()
    hp.update(hidden_size=32, task_cls="fs2", **VARIANTS[variant][0])
    return hp


def _batch(variant):
    if variant == "midi":
        return midi_case._batch()
    return cwt_case.make_batch("cwt") if variant == "cwt" else cwt_case.make_batch("frame")


@pytest.fixture(scope="module", params=list(VARIANTS))
def case(request):
    variant = request.param
    hp, batch = _hp(variant), _batch(variant)
    jtask = JFS2Task(hp, VOCAB, sil_ids=SIL)
    params = jtask.init_params(jax.random.PRNGKey(0), batch)
    task = FastSpeech2Task(hp, VOCAB, device="cpu", sil_ids=SIL)
    task.load_state_dict(task_state_dict(jax.device_get(params)), strict=True)
    return variant, hp, batch, jtask, params, task


def _close_scaled(got, want, name):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=1e-4, atol=1e-5,
                               err_msg=f"grad mismatch: {name}")


def test_fs2_train_loss_and_grads_match_jax(case):
    variant, hp, batch, jtask, params, task = case
    (j_total, j_losses), j_grads = jax.jit(jax.value_and_grad(
        lambda p: jtask.train_loss(p, batch, jax.random.PRNGKey(5), deterministic=True),
        has_aux=True))(params)
    trainable = dict(task.set_trainable())
    assert set(trainable) == {n for n, _ in task.named_parameters()}  # all train
    task.zero_grad(set_to_none=True)
    total, losses = task.train_loss(batch, deterministic=True)
    total.backward()

    want_terms = VARIANTS[variant][1] | {"pdur", "wdur", "sdur"}
    assert set(losses) == set(j_losses) == want_terms
    for k in losses:
        np.testing.assert_allclose(float(losses[k].detach()), float(j_losses[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(total.detach()), float(j_total), rtol=1e-5)
    want = task_state_dict(jax.device_get(j_grads))
    assert set(want) == set(trainable)
    for name, w in want.items():
        grad = trainable[name].grad
        _close_scaled(np.zeros_like(w.numpy()) if grad is None else grad.numpy(), w.numpy(),
                      name)
    # the decoder trains here (a diffusion task skips it)
    assert trainable["fs2.mel_out.weight"].grad.abs().max() > 0


def test_fs2_inference_matches_jax(case):
    variant, hp, batch, jtask, params, task = case
    want = jtask.inference(params, batch, jax.random.PRNGKey(0), use_gt_dur=True,
                           use_gt_f0=True)
    got = task.inference(batch, use_gt_dur=True, use_gt_f0=True,
                         generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got["mel2ph"].numpy(), np.asarray(want["mel2ph"]))
    np.testing.assert_allclose(got["mel_out"].numpy(), np.asarray(want["mel_out"]), atol=5e-5)


def test_fs2_train_loss_needs_draws_unless_deterministic(case):
    _, _, batch, _, _, task = case
    with pytest.raises(ValueError, match="Generator"):
        task.train_loss(batch)
    # dropout from a generator: two seeds, two losses
    hp = {**_hp("frame"), "dropout": 0.2}
    t = FastSpeech2Task(hp, VOCAB, device="cpu", sil_ids=SIL)
    b = cwt_case.make_batch("frame")
    with torch.no_grad():
        a = [float(t.train_loss(b, generator=torch.Generator().manual_seed(s))[0])
             for s in (0, 1, 0)]
    assert a[0] == a[2] != a[1]


# every model config (stats.yaml holds statistics, tpu_production.yaml TPU
# settings to stack on one)
SHIPPED = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "configs").rglob("*.yaml")
                 if p.name not in ("stats.yaml", "tpu_production.yaml"))


@pytest.mark.parametrize("config", SHIPPED)
def test_build_task_over_every_shipped_config(config):
    """The port's ``build_task`` gives the class JAX's gives, for every shipped
    config's own ``task_cls``."""
    hp = set_hparams(str(ROOT / config))
    want = type(jbuild_task(jset_hparams(str(ROOT / config)), vocab_size=VOCAB)).__name__
    assert type(build_task(hp, VOCAB, device="cpu")).__name__ == want


def test_build_task_registry_matches_jax():
    from diffsinger_tpu.training.tasks import TASK_REGISTRY as JREG
    from diffsinger_tpu_torch.training.tasks import TASK_REGISTRY

    assert {k: v.__name__ for k, v in TASK_REGISTRY.items()} == {
        k: v.__name__ for k, v in JREG.items()}
    with pytest.raises(KeyError, match="unknown task_cls"):
        build_task({"task_cls": "nope"}, VOCAB, device="cpu")
    with pytest.raises(KeyError):
        jbuild_task({"task_cls": "nope"}, VOCAB)
