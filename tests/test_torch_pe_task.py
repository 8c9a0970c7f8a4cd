"""The port's PitchExtractor training against the JAX package's
``PitchExtractionTask``: one training step's loss, gradients and new
BatchNorm statistics against flax's mutable ``batch_stats`` update (padding
frames in the batch count in the statistics), the trainer writing the
statistics after the gradient, validation leaving them as they were, and
inference with the updated statistics.

flax's PitchPredictor always draws dropout in training mode (rate 0.1):
where the two are compared, flax's ``Dropout`` is the identity and the port
gets no dropout generator. Shapes: hidden 32, 16 mel bins, B=2, 40 frames.
Tolerances: loss terms rtol 1e-5; gradients rtol 1e-4, atol 1e-5 after
dividing by max(1, |g|max); statistics and outputs atol 3e-5.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.training.tasks import PitchExtractionTask as JPETask
from diffsinger_tpu_torch.convert.from_jax import pe_state_dict, task_state_dict
from diffsinger_tpu_torch.training.tasks import PitchExtractionTask, build_task
from diffsinger_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)
ATOL = 3e-5
HP = {"task_cls": "pe", "hidden_size": 32, "predictor_hidden": -1, "predictor_kernel": 5,
      "audio_num_mel_bins": 16, "pitch_type": "frame", "use_uv": True,
      "pitch_norm": "log", "pitch_loss": "l1", "lambda_f0": 1.0, "lambda_uv": 1.0,
      "lr": 0.001, "decay_steps": 50000, "optimizer_adam_beta1": 0.9,
      "optimizer_adam_beta2": 0.98, "weight_decay": 0.0, "clip_grad_norm": 1,
      "accumulate_grad_batches": 1, "seed": 1234, "fs2_ckpt": ""}
B, T, M = 2, 40, 16


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    mels = (rng.randn(B, T, M) * 0.5 - 2.0).astype(np.float32)
    mel2ph = np.repeat(np.arange(1, 11), 4)[None].repeat(B, 0).astype(np.int64)
    mels[1, 29:] = 0.0  # row 1: 11 padding frames
    mel2ph[1, 29:] = 0
    return {"mels": mels, "mel2ph": mel2ph,
            "f0": rng.uniform(6.5, 8.5, size=(B, T)).astype(np.float32),
            "uv": (rng.rand(B, T) < 0.2).astype(np.float32)}


@pytest.fixture()
def no_flax_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)


@pytest.fixture(scope="module")
def setup():
    batch = _batch()
    jtask = JPETask(HP)
    params = jtask.init_params(jax.random.PRNGKey(0),
                               {k: jnp.asarray(v) for k, v in batch.items()})
    rng = np.random.RandomState(2)
    stats = {name: {"mean": jnp.asarray(rng.randn(*bn["mean"].shape).astype(np.float32)),
                    "var": jnp.asarray(rng.uniform(0.5, 2.0, bn["var"].shape)
                                       .astype(np.float32))}
             for name, bn in params["batch_stats"]["mel_prenet"].items()}
    pe = jax.tree_util.tree_map_with_path(
        lambda path, a: a + jnp.asarray(rng.randn(*a.shape).astype(np.float32) * 0.1)
        if any(getattr(p, "key", "").startswith(("bn_", "norm_")) for p in path) else a,
        params["pe"])
    return batch, jtask, {"pe": pe, "batch_stats": {"mel_prenet": stats}}


def _port(params):
    task = PitchExtractionTask(HP, device="cpu")
    task.load_state_dict(task_state_dict(jax.device_get(params)), strict=True)
    return task


def _stats_sd(batch_stats):
    """flax batch_stats -> the port's PE buffer names."""
    sd = pe_state_dict({"params": {}, "batch_stats": jax.device_get(batch_stats)})
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


def _close_scaled(got, want, name):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=1e-4, atol=1e-5,
                               err_msg=f"grad mismatch: {name}")


def test_pe_training_step_matches_jax(setup, no_flax_dropout):
    batch, jtask, params = setup

    def loss_fn(pe):
        total, losses = jtask.train_loss({"pe": pe, "batch_stats": params["batch_stats"]},
                                         batch, jax.random.PRNGKey(1))
        return total, losses

    (j_total, j_losses), j_grads = jax.value_and_grad(loss_fn, has_aux=True)(params["pe"])
    j_new = j_losses.pop("_new_state")

    task = _port(params)
    trainable = dict(task.set_trainable())
    total, losses = task.train_loss(batch)
    new_state = losses.pop("_new_state")
    total.backward()
    assert set(losses) == set(j_losses) == {"f0", "uv"}
    for k in losses:
        np.testing.assert_allclose(float(losses[k].detach()), float(j_losses[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(total.detach()), float(j_total), rtol=1e-5)
    want = task_state_dict({"pe": jax.device_get(j_grads)})
    assert set(want) == set(trainable)  # the statistics are not trained
    for name, w in want.items():
        _close_scaled(trainable[name].grad.numpy(), w.numpy(), name)

    want_stats = _stats_sd(j_new)
    assert set(new_state) == set(want_stats) and len(want_stats) == 6
    for k, w in want_stats.items():
        np.testing.assert_allclose(new_state[k].numpy(), w.numpy(), atol=ATOL, err_msg=k)
    # the padding frames count: statistics over the unpadded frames alone differ
    bn0 = task.pe.mel_prenet.layers[0]
    x = torch.relu(torch.nn.functional.conv1d(torch.from_numpy(batch["mels"]).transpose(1, 2),
                                              bn0[0].weight, bn0[0].bias, padding=2))
    x = x.transpose(1, 2).detach()
    real = torch.from_numpy(batch["mel2ph"] > 0)
    mean_real = 0.99 * bn0[2].running_mean + 0.01 * x[real].mean(0)
    assert not torch.allclose(mean_real, new_state["mel_prenet.layers.0.2.running_mean"],
                              atol=1e-4)


def test_trainer_writes_statistics_after_the_gradient_and_validation_keeps_them(
        setup, no_flax_dropout):
    batch, jtask, params = setup
    task = _port(params)
    trainer = Trainer(HP, task, device="cpu")
    trainer.initialize()
    before = {k: v.clone() for k, v in task.pe.state_dict().items() if "running" in k}
    # the statistics a forward with the weights before the step gives
    with torch.no_grad():
        expected = task.train_loss(batch)[1]["_new_state"]
    trainer.generator = None  # no dropout: the statistics do not depend on draws
    losses = trainer.train_step(batch, generator=None)
    assert "_new_state" not in losses
    for k, v in expected.items():
        assert torch.equal(task.pe.get_buffer(k), v), k
        assert not torch.equal(v, before[k])
    after = {k: v.clone() for k, v in task.pe.state_dict().items() if "running" in k}
    val = trainer.validate([batch])
    assert set(val) == {"f0", "uv", "total_loss"}
    for k, v in after.items():
        assert torch.equal(task.pe.state_dict()[k], v), k


def test_inference_after_the_update_matches_jax(setup, no_flax_dropout):
    batch, jtask, params = setup
    _, j_losses = jtask.train_loss(params, batch, jax.random.PRNGKey(1))
    j_params = {"pe": params["pe"], "batch_stats": j_losses["_new_state"]}
    want = jtask.inference(j_params, batch)
    task = _port(params)
    task.update_state(task.train_loss(batch)[1]["_new_state"])
    got = task.inference(batch)
    np.testing.assert_allclose(got["pitch_pred"].numpy(), np.asarray(want["pitch_pred"]),
                               atol=ATOL)
    f0_w, f0_g = np.asarray(want["f0_denorm_pred"]), got["f0_denorm_pred"].numpy()
    np.testing.assert_array_equal(f0_g == 0, f0_w == 0)
    np.testing.assert_allclose(f0_g, f0_w, rtol=1e-4)


def test_pe_dropout_follows_the_generator_even_when_deterministic(setup):
    """JAX's task ignores ``deterministic``: the port draws the PE's dropout
    (rate 0.1) from the generator it is given, in validation too."""
    batch, _, params = setup
    task = _port(params)
    assert task.pe.pitch_predictor.conv[0].dropout == 0.1
    with torch.no_grad():
        loss = [float(task.train_loss(batch, generator=torch.Generator().manual_seed(s),
                                      deterministic=True)[0]) for s in (0, 1, 0)]
    assert loss[0] == loss[2] != loss[1]
    assert isinstance(build_task(HP, 0, device="cpu"), PitchExtractionTask)
