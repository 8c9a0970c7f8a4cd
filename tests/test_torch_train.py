"""The port's DiffSpeech training path against the JAX package: the task's
training loss term by term with its gradients, the freezing rule, two
optimizer steps of the Trainer, dropout in training mode, the schedules.

Shapes follow ``__graft_entry__._tiny_hp`` (hidden 64, DiffNet 4 x 32,
T=8 diffusion steps) at B=2, 16 phonemes, 64 frames. The diffusion step and
noise are drawn with JAX exactly as ``DiffSingerTask.train_loss`` draws them
and handed to the port; dropout is 0 wherever JAX and the port are compared.
Tolerances: loss terms rtol 1e-5; gradients rtol 1e-4, atol 1e-5 after
dividing by max(1, |g|max) (the JAX package's kernel-gradient tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as g
from diffsinger_tpu.models import predictors as jpred
from diffsinger_tpu.parallel.mesh import make_mesh
from diffsinger_tpu.training import schedules as jsched
from diffsinger_tpu.training.tasks import DiffSingerTask as JTask
from diffsinger_tpu.training.tasks import trainable_mask
from diffsinger_tpu.training.trainer import Trainer as JTrainer
from diffsinger_tpu.training.trainer import merge_params, partition_params
from diffsinger_tpu_torch.convert.from_jax import task_state_dict
from diffsinger_tpu_torch.models import predictors as tpred
from diffsinger_tpu_torch.training import schedules as tsched
from diffsinger_tpu_torch.training.tasks import DiffSingerTask
from diffsinger_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)
VOCAB = 16
SIL = (3,)  # token 3 is a silence phone: the word-duration loss has words
MISSING_CKPT = "checkpoints/__no_such_fs2__/model_ckpt_steps_0.ckpt"


def _batch():
    rng = np.random.RandomState(3)
    batch = g._synthetic_batch(rng, b=2, t_txt=16, t_mel=64)
    # text padding in row 1: its last 4 phones and their frames
    batch["txt_tokens"][1, 12:] = 0
    batch["mel2ph"][1][batch["mel2ph"][1] > 12] = 0
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}


@pytest.fixture(scope="module")
def setup():
    hp = g._tiny_hp()
    batch = _batch()
    params = JTask(hp, VOCAB, sil_ids=SIL).init_params(jax.random.PRNGKey(0), batch)
    # a nonzero DiffNet output projection, so the stack gets gradients
    r = np.random.RandomState(7)
    params["denoiser"] = dict(params["denoiser"])
    params["denoiser"]["output_projection"] = {
        "kernel": jnp.asarray(r.randn(1, 32, 80).astype(np.float32) * 0.1),
        "bias": jnp.zeros((80,), jnp.float32)}
    return hp, batch, params


def _jax_draws(rng, batch, k_step):
    """t and noise as DiffSingerTask.train_loss draws them from ``rng``."""
    _, _, t_rng, noise_rng = jax.random.split(rng, 4)
    t = jax.random.randint(t_rng, (batch["mels"].shape[0],), 0, k_step)
    noise = jax.random.normal(noise_rng, batch["mels"].shape)
    return torch.from_numpy(np.array(t)).long(), torch.from_numpy(np.array(noise))


def _close_scaled(got, want, name):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=1e-4, atol=1e-5,
                               err_msg=f"grad mismatch: {name}")


def _port_task(hp, params):
    task = DiffSingerTask(hp, VOCAB, device="cpu", sil_ids=SIL)
    task.load_state_dict(task_state_dict(jax.device_get(params)), strict=True)
    return task


@pytest.mark.parametrize("fs2_ckpt", ["", MISSING_CKPT])
@pytest.mark.parametrize("pallas", [False, True])
def test_train_loss_and_grads_match_jax(setup, pallas, fs2_ckpt):
    """JAX's task.train_loss through its XLA module path and through its
    fused training kernels (interpret mode); the port always runs the
    training-stack wrapper. With fs2_ckpt set, FS2 is frozen except its
    predictors: the trainable sets match and frozen parameters get no
    gradient."""
    hp, batch, params = setup
    hp = {**hp, "use_pallas_diffnet_train": pallas, "fs2_ckpt": fs2_ckpt,
          "freeze_fs2_all": False}
    jtask = JTask(hp, VOCAB, sil_ids=SIL)
    p_train, p_frozen = partition_params(params, trainable_mask(params,
                                                                jtask.trainable_rule()))
    rng = jax.random.PRNGKey(5)

    def loss_fn(pt):
        return jtask.train_loss(merge_params(pt, p_frozen), batch, rng)

    (j_total, j_losses), j_grads = jax.value_and_grad(loss_fn, has_aux=True)(p_train)

    task = _port_task(hp, params)
    trainable = dict(task.set_trainable())
    t, noise = _jax_draws(rng, batch, hp["K_step"])
    total, losses = task.train_loss(batch, t=t, noise=noise, deterministic=True)
    total.backward()

    assert set(losses) == set(j_losses) == {"mel", "pdur", "wdur", "sdur", "uv", "f0"}
    for k in losses:
        np.testing.assert_allclose(float(losses[k]), float(j_losses[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(total), float(j_total), rtol=1e-5)
    want = task_state_dict(jax.device_get(j_grads))
    assert set(want) == set(trainable)
    if fs2_ckpt:
        assert {n.split(".")[1] for n in trainable if n.startswith("fs2.")} == {
            "dur_predictor", "pitch_predictor"}
    for name, p in task.named_parameters():
        if name not in trainable:
            assert p.grad is None and not p.requires_grad, name
    for name, w in want.items():
        grad = trainable[name].grad  # None: the loss does not reach it (FS2 decoder)
        _close_scaled(np.zeros_like(w.numpy()) if grad is None else grad.numpy(),
                      w.numpy(), name)


def test_two_trainer_steps_match_jax(setup, tmp_path):
    """Two Trainer.train_steps (AdamW, StepLR, clip 1, DiffSpeech freezing)
    against JAX's Trainer: losses and grad_norm at rtol 1e-4, and every
    parameter after each update at atol 1e-5, a hundredth of the 1e-3
    learning rate (Adam normalises, so every update is about lr in size). The
    largest difference measured is 5.3e-6, one weight whose gradient is near
    Adam's eps of 1e-8, where g / (|g| + eps) magnifies float noise; all
    others stay below 4e-7."""
    hp, batch, params = setup
    hp = {**hp, "fs2_ckpt": MISSING_CKPT, "freeze_fs2_all": False}
    jtrainer = JTrainer(hp, JTask(hp, VOCAB, sil_ids=SIL),
                        mesh=make_mesh(num_data=1, devices=jax.devices()[:1]),
                        work_dir=str(tmp_path))
    jtrainer.initialize(batch)
    jtrainer.params = jax.tree_util.tree_map(jnp.array, params)  # a copy: donated
    jtrainer.opt_state = jtrainer.tx.init(partition_params(params, jtrainer.mask)[0])
    task = _port_task(hp, params)
    trainer = Trainer(hp, task, device="cpu")
    trainer.initialize()
    for i in range(2):
        rng = jax.random.PRNGKey(100 + i)
        j_losses = jtrainer.train_step(batch, rng)
        t, noise = _jax_draws(rng, batch, hp["K_step"])
        losses = trainer.train_step(batch, t=t, noise=noise, deterministic=True)
        for k, v in j_losses.items():
            np.testing.assert_allclose(float(losses[k]), float(v), rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {i}: {k}")
        want = task_state_dict(jax.device_get(jtrainer.params))
        got = task.state_dict()
        for name, w in want.items():
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=1e-5,
                                       err_msg=f"step {i}: {name}")
    assert trainer.optimizer.num_updates == 2 and trainer.global_step == 2


def test_accumulated_steps_update_once(setup):
    """accumulate_grad_batches=2: the first mini-step leaves the weights as
    they are, the second applies one update (optax.MultiSteps)."""
    hp, batch, params = setup
    task = _port_task({**hp, "accumulate_grad_batches": 2}, params)
    trainer = Trainer({**hp, "accumulate_grad_batches": 2}, task, device="cpu")
    trainer.initialize()
    before = {k: v.clone() for k, v in task.state_dict().items()}
    gen = torch.Generator().manual_seed(0)
    trainer.train_step(batch, generator=gen)
    assert all(torch.equal(v, before[k]) for k, v in task.state_dict().items())
    trainer.train_step(batch, generator=gen)
    assert trainer.optimizer.num_updates == 1
    assert any(not torch.equal(v, before[k]) for k, v in task.state_dict().items())


def test_dropout_follows_the_generator_in_training_mode_only(setup):
    """With dropout > 0 the training forward changes with the generator's
    seed (and repeats for the same seed); without a generator (eval) it
    does not change."""
    hp, batch, params = setup
    hp = {**hp, "dropout": 0.2, "predictor_dropout": 0.5}
    task = _port_task(hp, params)
    tokens, mel2ph = torch.from_numpy(batch["txt_tokens"]), torch.from_numpy(batch["mel2ph"])
    f0, uv = torch.from_numpy(batch["f0"]), torch.from_numpy(batch["uv"])

    def run(seed):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            ret = task.fs2(tokens, mel2ph=mel2ph, f0=f0, uv=uv, skip_decoder=True,
                           drop_gen=gen)
        return torch.cat([ret["decoder_inp"].flatten(), ret["dur"].flatten(),
                          ret["pitch_pred"].flatten()])

    a0, a0b, a1 = run(0), run(0), run(1)
    e, e2 = run(None), run(None)
    torch.testing.assert_close(a0, a0b, rtol=0, atol=0)
    assert (a0 - a1).abs().max() > 1e-3
    torch.testing.assert_close(e, e2, rtol=0, atol=0)
    assert (a0 - e).abs().max() > 1e-3
    t = torch.tensor([1, 2])
    noise = torch.zeros(batch["mels"].shape)
    losses = [float(task.train_loss(batch, t=t, noise=noise,
                                    generator=torch.Generator().manual_seed(s))[0])
              for s in (0, 1)]
    assert losses[0] != losses[1]


def test_mel2ph_to_dur_matches_jax():
    batch = _batch()
    want = jpred.mel2ph_to_dur(jnp.asarray(batch["mel2ph"]), 16)
    got = tpred.mel2ph_to_dur(torch.from_numpy(batch["mel2ph"]), 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("hp", [{"lr": 0.001, "decay_steps": 50000},
                                {"lr": 2.0, "warmup_updates": 4000, "hidden_size": 256}])
def test_lr_schedules_match_jax(hp):
    want, got = jsched.build_lr_schedule(hp), tsched.build_lr_schedule(hp)
    for step in (0, 1, 3999, 4000, 49999, 50000, 120000):
        np.testing.assert_allclose(got(step), float(want(jnp.asarray(step))), rtol=1e-6)
