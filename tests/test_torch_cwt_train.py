"""The training loss of the pitch and energy variants against the JAX task:
``train_loss`` term by term and its gradients for cwt pitch (targets built
with the port's ``get_f0cwt`` from voiced/unvoiced F0 contours), phone-level
pitch (``f0`` of the batch is [B, T_txt]) and energy, with and without the
``fs2_ckpt`` freezing rule. The JAX task runs ``deterministic=True``; the
diffusion step and noise are drawn with JAX as ``DiffSingerTask.train_loss``
draws them and handed to the port.

Tolerances: loss terms rtol 1e-5; gradients rtol 1e-4, atol 1e-5 after
dividing by max(1, |g|max) (``test_pallas_kernels.py:182-184``). The coarse
pitch ids and energy ids that the conditioner embeds are checked to lie at
least 2e-3 from a rounding boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as g
from diffsinger_tpu.training.tasks import DiffSingerTask as JTask
from diffsinger_tpu.training.tasks import trainable_mask
from diffsinger_tpu.training.trainer import merge_params, partition_params
from diffsinger_tpu.utils import pitch as jpitch
from diffsinger_tpu_torch.convert.from_jax import task_state_dict
from diffsinger_tpu_torch.data.binarize import collate_cwt, get_f0cwt
from diffsinger_tpu_torch.training.tasks import DiffSingerTask

torch.set_num_threads(1)
VOCAB, SIL = 16, (3,)
B, T_TXT, T_MEL = 2, 16, 64
MARGIN = 2e-3
MISSING_CKPT = "checkpoints/__no_such_fs2__/model_ckpt_steps_0.ckpt"
VARIANTS = {"cwt": {"pitch_type": "cwt", "cwt_hidden_size": 16},
            "ph": {"pitch_type": "ph"},
            "energy": {"use_energy_embed": True}}
LOSS_KEYS = {"cwt": {"C", "uv", "f0_mean", "f0_std"}, "ph": {"f0"},
             "energy": {"uv", "f0", "e"}}


def f0_contour(rng, t):
    """F0 in Hz around 110-250 with a slow vibrato and unvoiced runs."""
    f0 = rng.uniform(110, 250) * 2 ** (0.2 * np.sin(np.arange(t) / rng.uniform(3, 9)))
    uv = rng.rand(t) < 0.15
    uv[:2] = True
    return np.where(uv, 0.0, f0)


def _coarse_margin(f0_hz, real):
    f0 = np.asarray(f0_hz, np.float64)
    v = ((1127 * np.log(1 + f0 / 700) - jpitch.F0_MEL_MIN) * 254
         / (jpitch.F0_MEL_MAX - jpitch.F0_MEL_MIN) + 1)
    v = v[real & (f0 > 0) & (v > 1.5) & (v < 254.5)]
    assert v.size > 10
    return float(np.abs(v % 1 - 0.5).min())


def make_batch(variant, seed=3):
    rng = np.random.RandomState(seed)
    batch = g._synthetic_batch(rng, b=B, t_txt=T_TXT, t_mel=T_MEL)
    batch["txt_tokens"][1, 12:] = 0  # text padding in row 1
    batch["mel2ph"][1][batch["mel2ph"][1] > 12] = 0
    batch = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    if variant == "cwt":
        items = []
        for i in range(B):
            f0 = f0_contour(rng, T_MEL)
            res = {}
            get_f0cwt(f0, res)
            items.append(res)
            batch["uv"][i] = (f0 == 0).astype(np.float32)
        batch.update(collate_cwt(items, T_MEL))
    elif variant == "energy":  # energies whose ids floor(e * 64) are 0.2 off a step
        e = rng.randint(6, 128, size=(B, T_MEL)) + rng.uniform(0.2, 0.8, size=(B, T_MEL))
        batch["energy"] = (e / 64).astype(np.float32)
    elif variant == "ph":
        # phone-level log2 F0 whose coarse bins sit within 0.3 of a bin centre
        v = rng.randint(40, 200, size=(B, T_TXT)) + rng.uniform(-0.3, 0.3, size=(B, T_TXT))
        mel = (v - 1) * (jpitch.F0_MEL_MAX - jpitch.F0_MEL_MIN) / 254 + jpitch.F0_MEL_MIN
        batch["f0"] = np.log2(700 * (np.exp(mel / 1127) - 1)).astype(np.float32)
    return batch


@pytest.mark.parametrize("variant,fs2_ckpt", [("cwt", ""), ("cwt", MISSING_CKPT),
                                              ("ph", ""), ("energy", MISSING_CKPT)])
def test_train_loss_and_grads_match_jax(variant, fs2_ckpt):
    hp = {**g._tiny_hp(), **VARIANTS[variant], "fs2_ckpt": fs2_ckpt,
          "freeze_fs2_all": False}
    batch = make_batch(variant)
    jtask = JTask(hp, VOCAB, sil_ids=SIL)
    params = jtask.init_params(jax.random.PRNGKey(0), batch)
    r = np.random.RandomState(7)
    params["denoiser"] = dict(params["denoiser"])
    params["denoiser"]["output_projection"] = {  # zero at init
        "kernel": jnp.asarray(r.randn(1, 32, 80).astype(np.float32) * 0.1),
        "bias": jnp.zeros((80,), jnp.float32)}

    # what the conditioner rounds is away from the rounding boundaries
    real = batch["mel2ph"] > 0
    if variant == "cwt":
        f0n = jtask.m.fs2.apply({"params": params["fs2"]}, jnp.asarray(batch["cwt_spec"]),
                                jnp.asarray(batch["f0_mean"]), jnp.asarray(batch["f0_std"]),
                                method=type(jtask.m.fs2).cwt2f0_norm)
        assert _coarse_margin(2.0 ** np.asarray(f0n), real & (batch["uv"] == 0)) > MARGIN
    elif variant == "ph":
        assert _coarse_margin(2.0 ** batch["f0"], batch["txt_tokens"] > 0) > MARGIN
    else:
        assert _coarse_margin(2.0 ** batch["f0"], real & (batch["uv"] == 0)) > MARGIN
        e = batch["energy"][real] * 64
        assert np.minimum(e % 1, 1 - e % 1).min() > MARGIN

    p_train, p_frozen = partition_params(params, trainable_mask(params,
                                                                jtask.trainable_rule()))
    rng = jax.random.PRNGKey(5)

    def loss_fn(pt):
        return jtask.train_loss(merge_params(pt, p_frozen), batch, rng, deterministic=True)

    (j_total, j_losses), j_grads = jax.value_and_grad(loss_fn, has_aux=True)(p_train)

    task = DiffSingerTask(hp, VOCAB, device="cpu", sil_ids=SIL)
    task.load_state_dict(task_state_dict(jax.device_get(params)), strict=True)
    trainable = dict(task.set_trainable())
    _, _, t_rng, noise_rng = jax.random.split(rng, 4)
    t = torch.from_numpy(np.array(jax.random.randint(t_rng, (B,), 0, hp["K_step"]))).long()
    noise = torch.from_numpy(np.array(jax.random.normal(noise_rng, batch["mels"].shape)))
    total, losses = task.train_loss(batch, t=t, noise=noise, deterministic=True)
    total.backward()

    assert set(losses) == set(j_losses) == {"mel", "pdur", "wdur", "sdur"} | LOSS_KEYS[variant]
    for k in losses:
        np.testing.assert_allclose(float(losses[k].detach()), float(j_losses[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(total.detach()), float(j_total), rtol=1e-5)
    want = task_state_dict(jax.device_get(j_grads))
    assert set(want) == set(trainable)
    if fs2_ckpt:  # FS2 frozen but for its predictors, as JAX names them
        heads = {"cwt": {"dur_predictor", "cwt_predictor"},
                 "energy": {"dur_predictor", "pitch_predictor", "energy_predictor"}}[variant]
        assert {n.split(".")[1] for n in trainable if n.startswith("fs2.")} == heads
        assert not any(n.startswith("fs2.cwt_predictor.0.") for n in trainable)
    for name, p in task.named_parameters():
        if name not in trainable:
            assert p.grad is None and not p.requires_grad, name
    for name, w in want.items():
        grad = trainable[name].grad  # None: the loss does not reach it (FS2 decoder)
        got = np.zeros_like(w.numpy()) if grad is None else grad.numpy()
        scale = max(1.0, float(np.abs(w.numpy()).max()))
        np.testing.assert_allclose(got / scale, w.numpy() / scale, rtol=1e-4, atol=1e-5,
                                   err_msg=f"grad mismatch: {name}")
    # the pitch and energy heads get gradients
    for head in ("cwt_predictor.1", "cwt_stats_layers", "pitch_predictor", "energy_predictor"):
        names = [n for n in trainable if n.startswith(f"fs2.{head}.")]
        if names:
            assert any(float(trainable[n].grad.abs().max()) > 0 for n in names), head
