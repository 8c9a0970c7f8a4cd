"""The port's MIDI (DiffSinger-Opencpop) training path against the JAX
package: ``midi_duration_loss`` with its gradients, the MIDI task's
``train_loss`` with ground-truth and with predicted F0 (the
``switch_midi2f0_step`` curriculum), with the pitch embedding on (as
``ds60_rel.yaml``) and off (as ``ds1000.yaml``), and the trainer's switch.

Shapes: hidden 32, two encoder layers, a two-layer DiffNet of 32 channels
at dilation cycle 2, B=2, 12 phones, 48 frames. The diffusion step and
noise are drawn with JAX as ``DiffSingerTask.train_loss`` draws them and
handed to the port; dropout is 0. Tolerances: loss terms rtol 1e-5;
gradients rtol 1e-4, atol 1e-5 after dividing by max(1, |g|max).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as g
from diffsinger_tpu.training import losses as JL
from diffsinger_tpu.training.tasks import DiffSingerTask as JTask
from diffsinger_tpu_torch.convert.from_jax import task_state_dict
from diffsinger_tpu_torch.training import losses as TL
from diffsinger_tpu_torch.training.tasks import DiffSingerTask
from diffsinger_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)
VOCAB = 16
B, T_TXT, T_MEL = 2, 12, 48


def _hp(use_pitch_embed=True):
    hp = g._tiny_hp()
    hp.update(hidden_size=32, residual_channels=32, residual_layers=2,
              dilation_cycle_length=2, use_midi=True, rel_pos=True,
              use_pitch_embed=use_pitch_embed, pitch_type="frame")
    return hp


def _batch(seed=3):
    rng = np.random.RandomState(seed)
    batch = g._synthetic_batch(rng, b=B, t_txt=T_TXT, t_mel=T_MEL)
    batch["txt_tokens"][1, 9:] = 0  # row 1: 3 padded phones and their frames
    batch["mel2ph"][1][batch["mel2ph"][1] > 9] = 0
    batch["mels"][1][batch["mel2ph"][1] == 0] = 0.0
    batch["pitch_midi"] = rng.randint(48, 72, size=(B, T_TXT)).astype(np.int64)
    batch["midi_dur"] = (rng.rand(B, T_TXT) * 0.5).astype(np.float32)
    batch["is_slur"] = (rng.rand(B, T_TXT) < 0.2).astype(np.int64)
    # words end at these phones; row 0 has single-phone words (0, 1, 2 each
    # ends a word)
    wb = np.zeros((B, T_TXT), np.int64)
    wb[0, [0, 1, 2, 5, 8, 11]] = 1
    wb[1, [1, 4, 6, 8]] = 1
    batch["word_boundary"] = wb
    for k in ("pitch_midi", "midi_dur", "is_slur", "word_boundary"):
        batch[k][1, 9:] = 0
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}


def _close_scaled(got, want, name):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=1e-4, atol=1e-5,
                               err_msg=f"grad mismatch: {name}")


@pytest.mark.parametrize("lambdas", [(1.0, 1.0, 1.0), (1.0, 0.0, 1.0), (0.5, 1.0, 0.0),
                                     (1.0, 0.0, 0.0)])
def test_midi_duration_loss_matches_jax(lambdas):
    """Values and gradients, with padding (where the masked head's output
    is exactly 0) and single-phone words."""
    batch = _batch()
    rng = np.random.RandomState(5)
    dur_log = (rng.randn(B, T_TXT) * 0.5 + 1.0).astype(np.float32)
    dur_log[batch["txt_tokens"] == 0] = 0.0
    kw = dict(lambda_ph_dur=lambdas[0], lambda_word_dur=lambdas[1], lambda_sent_dur=lambdas[2])
    args = [batch[k] for k in ("mel2ph", "txt_tokens", "word_boundary")]

    def jloss(d):
        losses = {}
        JL.midi_duration_loss(losses, d, *map(jnp.asarray, args), **kw)
        return sum(losses.values()), losses

    (_, want), want_g = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(dur_log))
    x = torch.from_numpy(dur_log).requires_grad_(True)
    got = {}
    TL.midi_duration_loss(got, x, *map(torch.from_numpy, args), **kw)
    sum(got.values()).backward()
    assert set(got) == set(want)
    assert ("wdur" in got) == (lambdas[1] > 0) and ("sdur" in got) == (lambdas[2] > 0)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    _close_scaled(x.grad.numpy(), np.asarray(want_g), "dur_pred_log")
    pad = batch["txt_tokens"] == 0
    np.testing.assert_allclose(x.grad.numpy()[pad], np.asarray(want_g)[pad], rtol=1e-5,
                               atol=1e-8, err_msg="padded phones")
    if lambdas[2] > 0:  # the sentence loss reaches the padded phones
        assert np.abs(x.grad.numpy()[pad]).min() > 0


@pytest.fixture(scope="module")
def params_by_pitch():
    out = {}
    batch = _batch()
    for pe in (True, False):
        params = JTask(_hp(pe), VOCAB).init_params(jax.random.PRNGKey(0), batch)
        r = np.random.RandomState(7)
        params["denoiser"] = dict(params["denoiser"])
        params["denoiser"]["output_projection"] = {
            "kernel": jnp.asarray(r.randn(1, 32, 80).astype(np.float32) * 0.1),
            "bias": jnp.zeros((80,), jnp.float32)}
        out[pe] = params
    return batch, out


def _port_task(hp, params):
    task = DiffSingerTask(hp, VOCAB, device="cpu")
    task.load_state_dict(task_state_dict(jax.device_get(params)), strict=True)
    return task


@pytest.mark.parametrize("use_gt_f0", [True, False])
@pytest.mark.parametrize("use_pitch_embed", [True, False])
def test_midi_train_loss_and_grads_match_jax(params_by_pitch, use_pitch_embed, use_gt_f0):
    batch, by_pitch = params_by_pitch
    params = by_pitch[use_pitch_embed]
    hp = _hp(use_pitch_embed)
    jtask = JTask(hp, VOCAB)
    rng = jax.random.PRNGKey(5)
    (j_total, j_losses), j_grads = jax.jit(jax.value_and_grad(
        lambda p: jtask.train_loss(p, batch, rng, deterministic=True, use_gt_f0=use_gt_f0),
        has_aux=True))(params)

    task = _port_task(hp, params)
    assert task.hp["task_type"] == "midi"
    trainable = dict(task.set_trainable())
    _, _, t_rng, noise_rng = jax.random.split(rng, 4)
    t = torch.from_numpy(np.array(jax.random.randint(t_rng, (B,), 0, hp["K_step"]))).long()
    noise = torch.from_numpy(np.array(jax.random.normal(noise_rng, batch["mels"].shape)))
    total, losses = task.train_loss(batch, t=t, noise=noise, deterministic=True,
                                    use_gt_f0=use_gt_f0)
    total.backward()

    want_terms = {"mel", "pdur", "wdur", "sdur"} | ({"uv", "f0"} if use_pitch_embed else set())
    assert set(losses) == set(j_losses) == want_terms
    for k in losses:
        np.testing.assert_allclose(float(losses[k].detach()), float(j_losses[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(total.detach()), float(j_total), rtol=1e-5)
    want = task_state_dict(jax.device_get(j_grads))
    assert set(want) == set(trainable)
    for name, w in want.items():
        grad = trainable[name].grad  # None: the loss does not reach it (the FS2 decoder)
        _close_scaled(np.zeros_like(w.numpy()) if grad is None else grad.numpy(), w.numpy(),
                      name)


def test_ground_truth_and_predicted_f0_differ_with_a_pitch_embedding(params_by_pitch):
    """With a pitch embedding the two conditioners differ, so the switch is
    visible in the loss; without one they are the same."""
    batch, by_pitch = params_by_pitch
    t, noise = torch.zeros(B, dtype=torch.long) + 3, torch.ones(B, T_MEL, 80) * 0.1
    for pe in (True, False):
        task = _port_task(_hp(pe), by_pitch[pe])
        with torch.no_grad():
            mel = [float(task.train_loss(batch, t=t, noise=noise, deterministic=True,
                                         use_gt_f0=gt)[1]["mel"]) for gt in (True, False)]
        assert (mel[0] != mel[1]) == pe, (pe, mel)


@pytest.mark.parametrize("switch", [0, 3])
def test_trainer_switch_at_the_threshold_and_one_past(params_by_pitch, switch):
    """``use_gt_f0 = switch is None or global_step <= switch`` at each step, as
    JAX's Trainer.train_step evaluates it: ground truth at the threshold
    step, predicted one step past it; the trainer's log records both."""
    batch, by_pitch = params_by_pitch
    hp = {**_hp(True), "switch_midi2f0_step": switch}
    task = _port_task(hp, by_pitch[True])
    seen = []
    orig = task.train_loss

    def spy(*a, use_gt_f0=True, **kw):
        seen.append(use_gt_f0)
        return orig(*a, use_gt_f0=use_gt_f0, **kw)

    task.train_loss = spy
    trainer = Trainer(hp, task, device="cpu")
    trainer.initialize()
    trainer.global_step = switch
    assert trainer.use_gt_f0()
    trainer.train_step(batch)
    assert trainer.global_step == switch + 1 and not trainer.use_gt_f0()
    trainer.train_step(batch)
    assert seen == [True, False]
    assert trainer.gt_f0_log == [(switch, True), (switch + 1, False)]
    # validation keeps the JAX default: ground truth
    trainer.validate([batch])
    assert seen[-1] is True
    # no switch: ground truth at every step
    trainer.hp.pop("switch_midi2f0_step")
    assert trainer.use_gt_f0()
