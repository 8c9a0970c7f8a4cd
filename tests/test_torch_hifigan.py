"""The port's MRF-scale twin and HiFiGAN generator against the JAX package.

JAX's Pallas kernels ``fused_mrf`` and ``fused_packed_stage`` run in
interpret mode, as tests/test_hifigan_mrf.py and test_hifigan_packed.py run
them. Tolerances: 2e-5 for one scale in float32 (the JAX package's own
kernel tolerance) and 5e-5 for the whole generator. In bf16 both sides round
at the same points, but a float32 sum taken in another order can round the
chain state one bf16 step apart (2^-8 relative, ~4e-3 for states of order 1,
divided by the three branches in the mean); such flips stay rare, so the bf16
check also bounds their share."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.models.hifigan import HifiGanConfig as JCfg
from diffsinger_tpu.models.hifigan import HifiGanGenerator as JGen
from diffsinger_tpu.ops.hifigan_mrf import fused_mrf
from diffsinger_tpu.ops.hifigan_mrf import pack_mrf_params as jpack
from diffsinger_tpu.ops.hifigan_packed_mrf import fused_packed_stage
from diffsinger_tpu_torch.convert.from_jax import hifigan_state_dict
from diffsinger_tpu_torch.inference.vocoder import HifiGAN
from diffsinger_tpu_torch.models.hifigan import HifiGanConfig, HifiGanGenerator
from diffsinger_tpu_torch.ops import hifigan_mrf as tmrf

torch.set_num_threads(1)
KS = (3, 7, 11)
DS = ((1, 3, 5),) * 3


def _stage_params(rng, stage, c, ks=KS, ns=3):
    out = {}
    for j, k in enumerate(ks):
        rb = {}
        for i in range(ns):
            for nm in ("convs1", "convs2"):
                rb[f"{nm}_{i}"] = {
                    "kernel": jnp.asarray(rng.randn(k, c, c).astype(np.float32) * 0.05),
                    "bias": jnp.asarray(rng.randn(c).astype(np.float32) * 0.02)}
        out[f"resblocks_{stage * len(ks) + j}"] = rb
    return out


def _twin(x, packed, compute_dtype=None):
    w1, b1, w2, b2 = (torch.from_numpy(np.array(a, np.float32)) for a in packed)
    return tmrf.mrf_stage(torch.from_numpy(x), w1, b1[:, :, 0], w2, b2[:, :, 0],
                          kernel_sizes=KS, dilation_sets=DS,
                          compute_dtype=compute_dtype).numpy()


@pytest.mark.parametrize("c,t,tt", [(32, 256, 128), (16, 192, 64)])
def test_mrf_twin_matches_fused_mrf(c, t, tt):
    rng = np.random.RandomState(c)
    x = (rng.randn(2, t, c) * 0.3).astype(np.float32)
    packed = jpack(_stage_params(rng, 0, c), 0, KS, DS, c)
    want = fused_mrf(jnp.asarray(x), *packed, kernel_sizes=KS, dilation_sets=DS,
                     t_tile=tt, interpret=True)
    np.testing.assert_allclose(_twin(x, packed), np.asarray(want), atol=2e-5)


def test_mrf_twin_matches_fused_mrf_bf16():
    rng = np.random.RandomState(5)
    c, t = 32, 128
    x = (rng.randn(2, t, c) * 0.3).astype(np.float32)
    packed = jpack(_stage_params(rng, 0, c), 0, KS, DS, c)
    want = np.asarray(fused_mrf(jnp.asarray(x), *packed, kernel_sizes=KS,
                                dilation_sets=DS, t_tile=64, interpret=True,
                                compute_dtype=jnp.bfloat16))
    got = _twin(x, packed, torch.bfloat16)
    err = np.abs(got - want)
    assert err.max() <= 4e-3 / 3, err.max()
    assert (err > 1e-4).mean() < 0.01, (err > 1e-4).mean()
    assert np.abs(got - _twin(x, packed)).max() > 1e-4  # bf16 really rounds


@pytest.mark.parametrize("c,p,theta,t", [(32, 4, 1, 88), (16, 1, 0, 53)])
def test_mrf_twin_matches_fused_packed_stage(c, p, theta, t):
    """The time-folded kernel computes the same function: unfold its output
    [B, R, p*C] -> [B, R*p, C] and cut the frames at offset theta. T is not a
    multiple of the fold, so both sequence edges are exercised."""
    rng = np.random.RandomState(100 + c)
    params = _stage_params(rng, 2, c)
    r = -(-(t + theta) // p)
    xf = np.zeros((2, r * p, c), np.float32)
    xf[:, theta:theta + t] = rng.randn(2, t, c).astype(np.float32) * 0.3
    got_p = fused_packed_stage(jnp.asarray(xf.reshape(2, r, p * c)), params, 2, nb=3,
                               ch=c, p=p, theta=theta, t=t, kernel_sizes=KS,
                               dilation_sets=DS, interpret=True)
    want = np.asarray(got_p).reshape(2, r * p, c)[:, theta:theta + t]
    packed = jpack(params, 2, KS, DS, c)
    np.testing.assert_allclose(_twin(xf[:, theta:theta + t], packed), want, atol=2e-5)


def _generators():
    kw = dict(upsample_rates=(4, 4, 4, 4), upsample_kernel_sizes=(8, 8, 8, 8),
              upsample_initial_channel=32, resblock_kernel_sizes=KS,
              resblock_dilation_sizes=DS, num_mels=16)
    rng = np.random.RandomState(7)
    mel = (rng.randn(2, 24, 16) * 0.5 - 2.0).astype(np.float32)
    jgen = JGen(JCfg(**kw))
    params = jgen.init(jax.random.PRNGKey(0), jnp.asarray(mel))["params"]
    # larger weights than the 0.01 init so every layer moves the output
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32) * 0.15), params)
    tgen = HifiGanGenerator(HifiGanConfig(**kw))
    tgen.load_state_dict(hifigan_state_dict(params), strict=True)
    return jgen, params, tgen, mel


def test_generator_matches_jax():
    jgen, params, tgen, mel = _generators()
    want = np.asarray(jgen.apply({"params": params}, jnp.asarray(mel)))
    with torch.no_grad():
        got = tgen(torch.from_numpy(mel)).numpy()
        got_mrf = tmrf.hifigan_mrf_apply(tgen, torch.from_numpy(mel)).numpy()
    assert got.shape == (2, 24 * 256) and np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, atol=5e-5)
    np.testing.assert_allclose(got_mrf, want, atol=5e-5)


def test_pack_mrf_params_matches_jax():
    _, params, tgen, _ = _generators()
    for stage, c in ((0, 16), (3, 2)):
        want = jpack(params, stage, KS, DS, c)
        got = tmrf.pack_mrf_params(tgen, stage)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.detach().numpy(),
                                          np.asarray(w).reshape(g.shape))


def test_vocoder_wrapper_trims_batched_waveforms():
    _, params, tgen, mel = _generators()
    voc = HifiGAN({"upsample_rates": [4, 4, 4, 4], "upsample_kernel_sizes": [8, 8, 8, 8],
                   "upsample_initial_channel": 32, "resblock_kernel_sizes": list(KS),
                   "resblock_dilation_sizes": [list(d) for d in DS],
                   "audio_num_mel_bins": 16}, device="cpu")
    voc.load_state_dict(tgen.state_dict())
    wavs = voc.spec2wav_batch(mel, lengths=[24, 10])
    with torch.no_grad():
        full = tmrf.hifigan_mrf_apply(tgen, torch.from_numpy(mel)).numpy()
    assert [w.shape for w in wavs] == [(24 * 256,), (10 * 256,)]
    np.testing.assert_array_equal(wavs[1], full[1, :2560])


def test_vocoder_wrapper_repacks_after_load_and_move():
    _, params, tgen, mel = _generators()
    hp = {"upsample_rates": [4, 4, 4, 4], "upsample_kernel_sizes": [8, 8, 8, 8],
          "upsample_initial_channel": 32, "resblock_kernel_sizes": list(KS),
          "resblock_dilation_sizes": [list(d) for d in DS], "audio_num_mel_bins": 16}
    voc = HifiGAN(hp, device="cpu")
    first = voc.apply(torch.from_numpy(mel)).numpy()
    voc.load_state_dict(tgen.state_dict())
    with torch.no_grad():
        want = tmrf.hifigan_mrf_apply(tgen, torch.from_numpy(mel)).numpy()
    np.testing.assert_array_equal(voc.apply(torch.from_numpy(mel)).numpy(), want)
    assert np.abs(first - want).max() > 1e-3
    packed = voc._packed
    assert voc.to("cpu") is voc and voc._packed is None
    voc.apply(torch.from_numpy(mel))
    assert voc._packed is not packed

