"""The port's HiFi-GAN vocoder training against the JAX package on shared
weights (``convert/from_jax.py``): the torch mel spectrogram (against JAX's
and the numpy one), the period and scale discriminators, the GAN losses and
their gradients, ``sample_segments``, the task's losses and gradients, and
two ``HifiGanTask.train_step``s in float32 and with the bf16 generator.

Widths: the JAX vocoder-task test's generator (32 channels, ``resblock:
'2'``, 8/8/2/2), segments of 16 frames, MPD periods 2 and 3 (patched into
both tasks' module namespaces), the MSD as shipped. The JAX step is jitted
once for the module.

Tolerances: modules atol 3e-5 (feature maps and logits 3e-5 of max(1,
scale)); losses rtol 1e-5; gradients rtol 1e-4 and atol 1e-5 after dividing
by max(1e-12, |g|max) per tensor; parameters after an update atol 1e-5
(``tests/test_torch_train.py``'s rules). Each step starts both sides from
the same weights and AdamW moments: the second step starts from JAX's state
after the first, handed to the port. Run on, the two sides drift apart
faster than float32 rounding: Adam divides each update by the root of its
own second moment, so an element whose gradient sits 1e-3 below its
tensor's scale (an almost silent channel of the 32-channel generator, its
gradients near Adam's eps) turns its rounding noise into update noise of
up to 2e-5 after one step, and the discriminators' next gradients follow.
The bf16 generator (JAX's rounding points, ``tests/test_torch_vocoders.py``)
is held by that file's rule: losses within 1e-2, and each parameter's update
at cosine 0.99 or more to JAX's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.models import hifigan_disc as jdisc
from diffsinger_tpu.ops import mel as jmel
from diffsinger_tpu.training import vocoder_task as jvt
from diffsinger_tpu_torch.convert.from_jax import hifigan_disc_state_dict, hifigan_state_dict
from diffsinger_tpu_torch.models import hifigan_disc as tdisc
from diffsinger_tpu_torch.ops import mel as tmel
from diffsinger_tpu_torch.training import vocoder_task as tvt
from diffsinger_tpu_torch.training.losses import l1

torch.set_num_threads(1)
HP = {"audio_sample_rate": 22050, "fft_size": 1024, "hop_size": 256, "win_size": 1024,
      "audio_num_mel_bins": 80, "fmin": 80, "fmax": 7600,
      "upsample_rates": [8, 8, 2, 2], "upsample_kernel_sizes": [16, 16, 4, 4],
      "upsample_initial_channel": 32, "resblock": "2", "resblock_kernel_sizes": [3],
      "resblock_dilation_sizes": [[1, 3]], "lr": 2e-4}
PERIODS = (2, 3)
FRAMES = 16
LOG_KEYS = ("d_loss", "g_loss", "mel", "fm", "adv")


def _wave(rng, b, n):
    """Harmonic tones over a noise floor, as a recording has."""
    t = np.arange(n) / 22050.0
    f0 = rng.uniform(110, 220, size=(b, 1))
    y = sum(0.5 ** k * np.sin(2 * np.pi * (k + 1) * f0 * t) for k in range(4))
    return (0.2 * y + 0.01 * rng.randn(b, n)).astype(np.float32)


def _batch(b=2):
    rng = np.random.RandomState(0)
    wav = _wave(rng, 2, FRAMES * 256)[:b]
    mel = np.stack([tmel.wav2spec(w, tmel.MelConfig.from_hparams(HP))[1][:FRAMES]
                    for w in wav])
    return mel, wav


def _torch_tree(state):
    """A JAX {g, mpd, msd} tree (weights or gradients) in the port's task
    naming."""
    return {**{"gen." + k: v for k, v in hifigan_state_dict(state.get("g", {})).items()},
            **{f"{d}.{k}": v for d in ("mpd", "msd")
               for k, v in hifigan_disc_state_dict(state.get(d, {})).items()}}


def _torch_task(hp, params, dtype=torch.float32):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tvt, "MultiPeriodDiscriminator",
                   functools.partial(tdisc.MultiPeriodDiscriminator, PERIODS))
        task = tvt.HifiGanTask(hp, device="cpu").to(dtype)
    task.load_state_dict({k: v.to(dtype) for k, v in _torch_tree(params).items()})
    return task


def _jax_task(hp):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvt, "MultiPeriodDiscriminator",
                   functools.partial(jdisc.MultiPeriodDiscriminator, periods=PERIODS))
        return jvt.HifiGanTask(hp)


@pytest.fixture(scope="module")
def params():
    """Shared initial weights: the JAX task's discriminators as it inits
    them, the generator at 0.08 (``tests/test_torch_vocoders.py``'s scale)."""
    jt = _jax_task(HP)
    mel, wav = (jnp.asarray(a) for a in _batch())
    g_rng, p_rng, s_rng = jax.random.split(jax.random.PRNGKey(0), 3)
    g = jax.jit(jt.gen.init)(g_rng, mel)["params"]
    rng = np.random.RandomState(11)
    g = jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32) * 0.08, g)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return {"g": g, "mpd": as_np(jax.jit(jt.mpd.init)(p_rng, wav, wav)["params"]),
            "msd": as_np(jax.jit(jt.msd.init)(s_rng, wav, wav)["params"])}


def _jax_losses_and_grads(jt):
    """JAX's step without the updates: the discriminators' loss and
    gradients, then the generator's against the same discriminators."""
    def run(state, mel, wav):
        d_params = {"mpd": state["mpd"], "msd": state["msd"]}
        y_hat = jax.lax.stop_gradient(jt.gen.apply({"params": state["g"]}, mel))

        def d_loss_fn(dp):
            p_rs, p_gs, _, _ = jt.mpd.apply({"params": dp["mpd"]}, wav, y_hat)
            s_rs, s_gs, _, _ = jt.msd.apply({"params": dp["msd"]}, wav, y_hat)
            pr, pg = jdisc.discriminator_loss(p_rs, p_gs)
            sr, sg = jdisc.discriminator_loss(s_rs, s_gs)
            return pr + pg + sr + sg

        def g_loss_fn(gp):
            _, mel_loss, (_, p_gs, p_fr, p_fg), (_, s_gs, s_fr, s_fg) = jt._losses(
                gp, d_params, mel, wav)
            fm = jdisc.feature_loss(p_fr, p_fg) + jdisc.feature_loss(s_fr, s_fg)
            adv = jdisc.generator_loss(p_gs) + jdisc.generator_loss(s_gs)
            return adv + fm + 45.0 * mel_loss, {"mel": mel_loss, "fm": fm, "adv": adv}

        d_loss, d_grads = jax.value_and_grad(d_loss_fn)(d_params)
        (g_loss, logs), g_grads = jax.value_and_grad(g_loss_fn, has_aux=True)(state["g"])
        return ({"d_loss": d_loss, "g_loss": g_loss, **logs},
                {"g": g_grads, "mpd": d_grads["mpd"], "msd": d_grads["msd"]})
    return jax.jit(run)


def _jax_run(hp, params, dtype=np.float32, with_grads=False, b=2):
    """JAX's two steps on ``_batch(b)`` from ``params`` in ``dtype`` (float64:
    under ``jax.enable_x64``), and with ``with_grads`` the first step's losses
    and gradients. Results as numpy trees."""
    jt = _jax_task(hp)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    with jax.enable_x64(dtype == np.float64):
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, dtype)), t)
        p, (mel, wav) = cast(params), cast(_batch(b))
        state = {**p, "g_opt": jt.g_tx.init(p["g"]),
                 "d_opt": jt.d_tx.init({"mpd": p["mpd"], "msd": p["msd"]})}
        out = {"params": [as_np(p)], "logs": []}
        if with_grads:
            logs, grads = _jax_losses_and_grads(jt)(state, mel, wav)
            out["losses"] = {k: float(v) for k, v in logs.items()}
            out["grads"] = as_np(grads)
        step = jt.make_train_step()
        for _ in range(2):
            # the jitted step donates its state: hand it a copy
            state, logs = step(jax.tree_util.tree_map(jnp.array, state), mel, wav)
            out["params"].append(as_np({k: state[k] for k in ("g", "mpd", "msd")}))
            out["logs"].append({k: float(v) for k, v in logs.items()})
    return out


@pytest.fixture(scope="module")
def run32(params):
    return _jax_run(HP, params, with_grads=True)


@pytest.fixture(scope="module")
def run64(params):
    # one row: XLA's float64 convolutions on the CPU take ~13 s a row for a step
    return _jax_run(HP, params, np.float64, with_grads=True, b=1)


def _scaled_close(got, want, err_msg=""):
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got / scale, want / scale, rtol=1e-4, atol=1e-5,
                               err_msg=err_msg)


# ------------------------------------------------------------------ the mel
def test_mel_spectrogram_torch_matches_jax_and_numpy():
    cfg = tmel.MelConfig.from_hparams(HP)
    jcfg = jmel.MelConfig.from_hparams(HP)
    wav = _wave(np.random.RandomState(1), 2, 4000)   # not a multiple of the hop
    y = torch.from_numpy(wav).requires_grad_(True)
    got = tmel.mel_spectrogram_torch(y, cfg)
    want = np.asarray(jmel.mel_spectrogram(jnp.asarray(wav), jcfg))
    assert got.shape == want.shape == (2, 4000 // 256 + 1, 80)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=3e-5)
    for row in range(2):
        np.testing.assert_allclose(got[row].detach().numpy(),
                                   tmel.mel_spectrogram(wav[row], cfg), rtol=0, atol=3e-5)
    # the gradient of a weighted sum, as the mel L1 sends it back
    w = np.random.RandomState(2).randn(*want.shape).astype(np.float32)
    (got * torch.from_numpy(w)).sum().backward()
    want_g = jax.grad(lambda a: (jmel.mel_spectrogram(a, jcfg) * w).sum())(jnp.asarray(wav))
    _scaled_close(y.grad.numpy(), np.asarray(want_g))


def test_frames_and_window_follow_the_numpy_framing():
    y = torch.arange(1000, dtype=torch.float32)
    frames = tmel.frame_signal_torch(y, 256, 100)
    np.testing.assert_array_equal(frames.numpy(), tmel.frame_signal(y.numpy(), 256, 100))
    mag = tmel.stft_magnitude_torch(y[None], n_fft=256, hop_size=100, win_length=200)
    np.testing.assert_allclose(mag[0].numpy(), tmel.stft_magnitude(
        y.numpy(), n_fft=256, hop_size=100, win_length=200), rtol=1e-5, atol=1e-2)


# ------------------------------------------------------- the discriminators
@pytest.mark.parametrize("which", ["mpd", "msd"])
def test_discriminators_match_jax(params, which):
    """Logits and every feature map on shared weights; 4099 samples: neither
    period divides it (both reflect-pad) and the scales pool an odd length."""
    jt, state = _jax_task(HP), params
    jmod = jt.mpd if which == "mpd" else jt.msd
    tmod = (tdisc.MultiPeriodDiscriminator(PERIODS) if which == "mpd"
            else tdisc.MultiScaleDiscriminator())
    sd = hifigan_disc_state_dict(state[which])
    assert set(sd) == set(tmod.state_dict())
    tmod.load_state_dict(sd)
    rng = np.random.RandomState(3)
    y, y_hat = _wave(rng, 2, 4099), (rng.randn(2, 4099) * 0.1).astype(np.float32)
    want = jax.jit(jmod.apply)({"params": state[which]}, jnp.asarray(y), jnp.asarray(y_hat))
    with torch.no_grad():
        got = tmod(torch.from_numpy(y), torch.from_numpy(y_hat))
    for part in (0, 1):   # logits
        for g, w in zip(got[part], want[part]):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=3e-5 * max(1.0, np.abs(w).max()))
    for part in (2, 3):   # feature maps, channels-first in the port
        for gd, wd in zip(got[part], want[part]):
            assert len(gd) == len(wd) == (6 if which == "mpd" else 8)
            for g, w in zip(gd, wd):
                w = np.asarray(w)
                g = g.numpy()
                g = g.transpose(0, 2, 3, 1) if g.ndim == 4 else g.transpose(0, 2, 1)
                np.testing.assert_allclose(g, w, rtol=0,
                                           atol=3e-5 * max(1.0, np.abs(w).max()))


def test_from_jax_maps_every_discriminator_leaf(params):
    state = params
    for which, mod in (("mpd", tdisc.MultiPeriodDiscriminator(PERIODS)),
                       ("msd", tdisc.MultiScaleDiscriminator())):
        leaves = jax.tree_util.tree_leaves(state[which])
        sd = hifigan_disc_state_dict(state[which])
        assert len(sd) == len(leaves) == len(mod.state_dict())
        mod.load_state_dict(sd, strict=True)
    assert tuple(sd["discriminators.0.convs.6.weight"].shape) == (1024, 1024, 5)
    assert tuple(sd["discriminators.1.convs.4.weight"].shape) == (1024, 32, 41)
    sd_p = hifigan_disc_state_dict(state["mpd"])
    assert tuple(sd_p["discriminators.1.convs.3.weight"].shape) == (1024, 512, 5, 1)


# -------------------------------------------------------------- the losses
def test_gan_losses_and_gradients_match_jax():
    """feature_loss, discriminator_loss and generator_loss with their
    gradients; one pair of maps is equal, so the L1 meets 0 exactly and takes
    JAX's derivative there (+1)."""
    rng = np.random.RandomState(4)
    shapes = [[(2, 8, 5), (2, 1, 5)], [(2, 4, 3, 2), (2, 1, 3, 2)]]
    fr = [[rng.randn(*s).astype(np.float32) for s in d] for d in shapes]
    fg = [[rng.randn(*s).astype(np.float32) for s in d] for d in shapes]
    fg[1][0] = fr[1][0].copy()
    rs = [rng.randn(2, 6).astype(np.float32), rng.randn(2, 4).astype(np.float32)]
    gs = [rng.randn(2, 6).astype(np.float32), rng.randn(2, 4).astype(np.float32)]

    def j_all(fr, fg, rs, gs):
        r, g = jdisc.discriminator_loss(rs, gs)
        return {"fm": jdisc.feature_loss(fr, fg), "d_real": r, "d_fake": g,
                "g": jdisc.generator_loss(gs)}

    t = lambda tree: [[torch.from_numpy(a).requires_grad_(True) for a in d] for d in tree]
    tfr, tfg = t(fr), t(fg)
    trs = [torch.from_numpy(a).requires_grad_(True) for a in rs]
    tgs = [torch.from_numpy(a).requires_grad_(True) for a in gs]
    r, g = tdisc.discriminator_loss(trs, tgs)
    got = {"fm": tdisc.feature_loss(tfr, tfg), "d_real": r, "d_fake": g,
           "g": tdisc.generator_loss(tgs)}
    want = j_all(fr, fg, rs, gs)
    inputs = [a for d in tfr + tfg for a in d] + trs + tgs
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, err_msg=k)
        grads = torch.autograd.grad(got[k], inputs, allow_unused=True, retain_graph=True)
        jg = jax.grad(lambda *a: j_all(*a)[k], argnums=(0, 1, 2, 3))(fr, fg, rs, gs)
        jflat = [a for d in jg[0] + jg[1] for a in d] + list(jg[2]) + list(jg[3])
        for gt, gw in zip(grads, jflat):
            gt = np.zeros_like(gw) if gt is None else gt.numpy()
            _scaled_close(gt, np.asarray(gw), err_msg=k)
    # at the equal pair: d|r - g|/dr = +1 on both sides, where torch.abs gives 0
    gr = torch.autograd.grad(got["fm"], tfr[1][0])[0]
    n = fr[1][0].size
    np.testing.assert_allclose(gr.numpy(), np.full(fr[1][0].shape, 2.0 / n, np.float32),
                               rtol=1e-6)
    x = torch.zeros(3, requires_grad=True)
    assert torch.autograd.grad(l1(x).sum(), x)[0].tolist() == [1.0, 1.0, 1.0]


def test_sample_segments_gives_jax_crops():
    rng = np.random.RandomState(5)
    mel = rng.randn(100, 80).astype(np.float32)
    wav = rng.randn(100 * 256).astype(np.float32)
    for m, w in ((mel, wav), (mel[:10], wav[: 10 * 256])):
        got = tvt.sample_segments(m, w, 256, 32, np.random.RandomState(6))
        want = jvt.sample_segments(m, w, 256, 32, np.random.RandomState(6))
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g, x)
        assert got[0].shape == (32, 80) and got[1].shape == (32 * 256,)


# -------------------------------------------------------------- the task
def _cos(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def _named(task, tensors):
    return dict(zip([n for n, _ in task.named_parameters()], tensors))


def test_task_losses_and_gradients_match_jax(params, run64):
    """Both sides in float64: the step's losses and every gradient. The
    port's float32 evaluation: the losses against float64 at rtol 1e-5, each
    gradient at cosine 0.9999 or more to the port's own float64 one."""
    mel, wav = _batch(1)
    got = {}
    for dt in (torch.float64, torch.float32):
        logs, d_grads, g_grads = _torch_task(HP, params, dt).losses_and_grads(mel, wav)
        got[dt] = logs, _named(_torch_task(HP, params), d_grads + g_grads)
    want = _torch_tree(run64["grads"])
    assert set(got[torch.float64][1]) == set(want)
    for k in LOG_KEYS:
        for dt in got:
            np.testing.assert_allclose(float(got[dt][0][k]), run64["losses"][k], rtol=1e-5,
                                       err_msg=f"{k} {dt}")
    for n, g in got[torch.float64][1].items():
        _scaled_close(g.numpy(), want[n].numpy(), err_msg=n)
        assert _cos(got[torch.float32][1][n], g) >= 0.9999, n


def test_two_train_steps_match_jax_in_float64(params, run64):
    """Two full steps from shared weights: the five logs (rtol 1e-5) and every
    generator and discriminator parameter after each update (atol 1e-5)."""
    mel, wav = _batch(1)
    task = _torch_task(HP, params, torch.float64)
    for i in range(2):
        logs = task.train_step(mel, wav)
        assert set(logs) == set(LOG_KEYS)
        for k in LOG_KEYS:
            np.testing.assert_allclose(float(logs[k]), run64["logs"][i][k], rtol=1e-5,
                                       err_msg=k)
        want = _torch_tree(run64["params"][i + 1])
        for n, p in task.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=0,
                                       atol=1e-5, err_msg=n)


def test_two_train_steps_match_jax_in_float32(params, run32):
    """The same two steps in float32 on both sides: the five logs."""
    mel, wav = _batch()
    task = _torch_task(HP, params)
    for i in range(2):
        logs = task.train_step(mel, wav)
        assert all(v.dtype == torch.float32 for v in logs.values())
        for k in LOG_KEYS:
            np.testing.assert_allclose(float(logs[k]), run32["logs"][i][k], rtol=1e-5,
                                       err_msg=k)


def test_bf16_generator_losses_gradients_and_steps_match_jax(params, run32):
    """``vocoder_compute_dtype: bfloat16`` against JAX's bf16 task: the
    losses (rtol 1e-2) and each gradient (cosine 0.99 or more), then two
    steps' logs (rtol 1e-2). The parameters after a bf16 step are not held
    element by element: Adam's first steps move each element by about +-lr
    whatever its gradient's size, so a bf16 rounding that flips a small
    gradient's sign flips that element's update. Two exceptions, each
    checked: (1) PyTorch's oneDNN kernel for the CPU's bf16 transposed-conv
    input gradient is wrong at stride 4 and 8 (cosine 0.15 to its float32
    result; its plain CPU kernel and cuDNN are right), so the port runs here
    with oneDNN off; (2) XLA's CPU sum of a bf16 bias gradient over the last
    scale's 8192 samples goes astray (JAX's bf16 gradient there at cosine
    -0.99 to its float32 one), so a gradient that JAX's bf16 evaluation
    gets wrong by that measure is held to JAX's float32 one."""
    hp = dict(HP, vocoder_compute_dtype="bfloat16")
    assert tvt.generator_config(hp).compute_dtype == "bfloat16"
    run = _jax_run(hp, params, with_grads=True)
    mel, wav = _batch()
    task = _torch_task(hp, params)
    with torch.backends.mkldnn.flags(enabled=False):
        logs, d_grads, g_grads = task.losses_and_grads(mel, wav)
    for k in LOG_KEYS:
        np.testing.assert_allclose(float(logs[k]), run["losses"][k], rtol=1e-2, err_msg=k)
    want, want32 = _torch_tree(run["grads"]), _torch_tree(run32["grads"])
    held_to_f32 = set()
    for n, g in _named(task, d_grads + g_grads).items():
        w = want[n]
        if _cos(w, want32[n]) < 0.99:
            held_to_f32.add(n)
            w = want32[n]
        assert _cos(g, w) >= 0.99, (n, _cos(g, w))
    assert all(n.endswith(".bias") for n in held_to_f32) and len(held_to_f32) <= 4, held_to_f32
    for i in range(2):
        with torch.backends.mkldnn.flags(enabled=False):
            logs = task.train_step(mel, wav)
        for k in LOG_KEYS:
            np.testing.assert_allclose(float(logs[k]), run["logs"][i][k], rtol=1e-2, err_msg=k)


def test_generator_config_follows_the_jax_task():
    v1 = tvt.generator_config({"audio_sample_rate": 24000, "audio_num_mel_bins": 128,
                               "vocoder_compute_dtype": "bfloat16", "use_nsf": True})
    assert (v1.upsample_rates, v1.upsample_initial_channel, v1.resblock) == ((8, 8, 2, 2), 512,
                                                                               "1")
    assert (v1.audio_sample_rate, v1.num_mels, v1.compute_dtype, v1.use_pitch_embed) == (
        24000, 80, "float32", False)
    cfg = tvt.generator_config(dict(HP, use_pitch_embed=True))
    assert cfg.upsample_initial_channel == 32 and not cfg.use_pitch_embed


def test_task_runs_on_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tvt.HifiGanTask(HP)
