"""The port's NSF-HiFiGAN against the JAX generator on the same weights and
the same source draws, and the vocoder wrapper's hop check.

The JAX generator takes its source draws as ``source_rand_ini`` /
``source_noise``; the JAX ``hifigan_mrf_apply`` (vocoder_backend 'mrf', its
Pallas MRF kernel in interpret mode) draws them from its key as
diffsinger_tpu/models/hifigan.py:sine_source does (``split(rng)`` into a
phase key, ``uniform`` with the fundamental's phase zeroed, and a noise key,
``normal``), and the test draws the same to hand them to the port.
Tolerance 5e-5 on waveforms in [-1, 1], the JAX package's generator
tolerance: float32 on both sides; the phase cumsums may sum in another order,
which moves a wrap of the mod-1 carry by a sample at most and sin() not at
all."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.models.hifigan import HifiGanConfig as JCfg
from diffsinger_tpu.models.hifigan import HifiGanGenerator as JGen
from diffsinger_tpu.ops.hifigan_mrf import hifigan_mrf_apply as jmrf_apply
from diffsinger_tpu_torch.convert.from_jax import hifigan_state_dict
from diffsinger_tpu_torch.inference.vocoder import HifiGAN
from diffsinger_tpu_torch.models.hifigan import HifiGanConfig, HifiGanGenerator
from diffsinger_tpu_torch.ops.hifigan_mrf import hifigan_mrf_apply

torch.set_num_threads(1)
ATOL = 5e-5
SR = 24000
GEOM = {"resblock": "1", "upsample_rates": [4, 2, 2], "upsample_kernel_sizes": [8, 4, 4],
        "upsample_initial_channel": 64, "resblock_kernel_sizes": [3, 7, 11],
        "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
        "audio_sample_rate": SR, "audio_num_mel_bins": 16}
HOP = 16


def jax_source_draws(rng, b, t_wav):
    rng_phase, rng_noise = jax.random.split(rng)
    rand_ini = jax.random.uniform(rng_phase, (b, 1, 9)).at[:, :, 0].set(0.0)
    return np.asarray(rand_ini), np.asarray(jax.random.normal(rng_noise, (b, t_wav, 9)))


def _inputs(rng, b=2, t=24):
    mel = (rng.randn(b, t, 16) * 0.5 - 3).astype(np.float32)
    f0 = rng.uniform(150, 700, size=(b, t)).astype(np.float32)
    f0[0, 5:9] = 0.0    # unvoiced frames
    f0[1, 19:] = 0.0    # a padded tail
    return mel, f0


@pytest.fixture(scope="module", params=["exact", "framewise"])
def pair(request):
    mode = request.param
    rng = np.random.RandomState(0)
    jcfg = JCfg.from_hparams(dict(GEOM, use_pitch_embed=True, nsf_source_mode=mode))
    jgen = JGen(jcfg)
    mel, f0 = _inputs(rng)
    params = jgen.init(jax.random.PRNGKey(0), jnp.asarray(mel), jnp.asarray(f0),
                       jax.random.PRNGKey(1))["params"]
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32) * 0.05), params)
    voc = HifiGAN(dict(GEOM, use_nsf=True, nsf_source_mode=mode, hop_size=HOP),
                  device="cpu")
    voc.load_state_dict(hifigan_state_dict(params), strict=True)
    return mode, jcfg, jgen, params, voc, (mel, f0)


def test_nsf_generator_matches_jax(pair):
    mode, _, jgen, params, voc, (mel, f0) = pair
    assert voc.cfg.use_pitch_embed and voc.cfg.source_mode == mode
    assert {"m_source.l_linear.weight", "noise_convs.0.weight", "noise_convs.2.bias"} <= \
        set(voc.model.state_dict())
    rand_ini, noise = jax_source_draws(jax.random.PRNGKey(3), 2, 24 * HOP)
    want = jgen.apply({"params": params}, jnp.asarray(mel), jnp.asarray(f0),
                      jax.random.PRNGKey(0), source_rand_ini=jnp.asarray(rand_ini),
                      source_noise=jnp.asarray(noise))
    args = [torch.from_numpy(np.array(a)) for a in (mel, f0, rand_ini, noise)]
    with torch.no_grad():
        got = voc.model(*args)
        got_mrf = hifigan_mrf_apply(voc.model, args[0], f0=args[1], rand_ini=args[2],
                                    noise=args[3])
        # the source moves the waveform: without F0 it is another signal
        no_f0 = hifigan_mrf_apply(voc.model, args[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got_mrf.numpy(), np.asarray(want), atol=ATOL)
    assert float((no_f0 - got_mrf).abs().max()) > 1e-3


def test_mrf_apply_and_wrapper_match_jax_mrf_backend(pair):
    mode, jcfg, _, params, voc, (mel, f0) = pair
    key = jax.random.PRNGKey(7)
    want = jmrf_apply(params, jcfg, jnp.asarray(mel), jnp.asarray(f0), key)
    source = jax_source_draws(key, 2, 24 * HOP)
    got = voc.apply(torch.from_numpy(mel), torch.from_numpy(f0), source=source)
    assert got.shape == (2, 24 * HOP)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # a generator draws the source when none is given, the same for the same seed
    a = voc.apply(torch.from_numpy(mel), torch.from_numpy(f0),
                  generator=torch.Generator().manual_seed(4))
    b = voc.apply(torch.from_numpy(mel), torch.from_numpy(f0),
                  generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="draws"), torch.no_grad():
        voc.model(torch.from_numpy(mel), torch.from_numpy(f0))


def test_exact_and_framewise_sources_agree():
    """The framewise phase is the exact one reduced mod 1 as it is built."""
    from diffsinger_tpu_torch.models.hifigan import sine_source, sine_source_framewise

    rng = np.random.RandomState(1)
    f0 = torch.from_numpy(rng.uniform(100, 800, size=(2, 40)).astype(np.float32))
    f0[0, 10:14] = 0.0
    rand_ini = torch.from_numpy(rng.rand(2, 1, 9).astype(np.float32))
    noise = torch.from_numpy(rng.randn(2, 40 * 128, 9).astype(np.float32))
    exact, uv_e = sine_source(torch.repeat_interleave(f0, 128, dim=1), SR, rand_ini, noise)
    frame, uv_f = sine_source_framewise(f0, 128, SR, rand_ini, noise)
    torch.testing.assert_close(uv_e, uv_f, rtol=0, atol=0)
    assert float((exact - frame).abs().max()) < 2e-4


def test_vocoder_hop_must_match_hop_size():
    # no geometry given: the 22.05 kHz HiFiGAN v1 (hop 256) under a hop-128 mel
    with pytest.raises(ValueError, match="hop_size"):
        HifiGanConfig.from_hparams({"hop_size": 128, "audio_sample_rate": 24000})
    with pytest.raises(ValueError, match="hop_size"):
        HifiGAN(dict(GEOM, hop_size=256), device="cpu")
    assert HifiGanConfig.from_hparams({"hop_size": 256}).total_upsample == 256
    assert HifiGanConfig.from_hparams(dict(GEOM, hop_size=HOP)).total_upsample == HOP
    # hparams that name no hop_size are not checked
    assert HifiGanConfig.from_hparams(GEOM).total_upsample == HOP
    # NSF keys: use_nsf always, use_pitch_embed only beside an explicit geometry
    assert HifiGanConfig.from_hparams({"use_pitch_embed": True}).use_pitch_embed is False
    assert HifiGanConfig.from_hparams({"use_nsf": True}).use_pitch_embed is True
    assert HifiGanConfig.from_hparams(dict(GEOM, use_pitch_embed=True)).use_pitch_embed
    with pytest.raises(ValueError, match="nsf_source_mode"):
        HifiGanConfig.from_hparams(dict(GEOM, nsf_source_mode="fast"))
    gen = HifiGanGenerator(HifiGanConfig.from_hparams(dict(GEOM, use_nsf=True)))
    # noise convs: kernel 2s, stride s for s = 4 and 2, kernel 1 on the last scale
    assert [tuple(c.weight.shape[2:]) + c.stride for c in gen.noise_convs] == \
        [(8, 4), (4, 2), (1, 1)]
