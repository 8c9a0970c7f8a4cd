"""The other vocoders and the rest of the vocoder wrapper's API, port against
the JAX package on shared weights (``convert/from_jax.py``) and draws:
HiFiGAN with ``resblock: '2'``, the bf16 vocoder (``vocoder_compute_dtype:
bfloat16``, JAX's ``hifigan_mrf_apply`` with its Pallas MRF kernel in
interpret mode), ParallelWaveGAN from upstream's and the official checkpoint
layouts (with and without mel statistics), ``denoise`` and ``wav2spec``.

Tolerances: float32 generators atol 5e-5 (module parity); the bf16 vocoder
1e-2 of max(1, the waveform's scale), ``chip_smoke.py``'s rule for the bf16
MRF kernel. Both sides round to bf16 at the same points (the conv inputs,
weights, outputs and bias sums, the leaky ReLU's slope: held bit for bit
piece by piece below), but a float32 sum taken in another order moves a
state one bf16 step now and then, and the next convolutions spread such
steps: on the C = 256 scale of these weights, the port with float32 sums
and the port with exact (float64) sums differ in ~40% of the elements, as
the port and JAX do. ``denoise`` and ``wav2spec`` (numpy and scipy on both
sides) 1e-6.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.inference import vocoder as jvoc
from diffsinger_tpu.models.hifigan import HifiGanConfig as JCfg
from diffsinger_tpu.models.hifigan import HifiGanGenerator as JGen
from diffsinger_tpu.models.hifigan import conv_transpose_1d
from diffsinger_tpu.models.pwg import ParallelWaveGANGenerator as JPWG
from diffsinger_tpu.models.pwg import PWGConfig as JPWGConfig
from diffsinger_tpu.ops.hifigan_mrf import hifigan_mrf_apply as j_mrf_apply
from diffsinger_tpu_torch.convert.from_jax import hifigan_state_dict, pwg_state_dict
from diffsinger_tpu_torch.inference import vocoder as tvoc
from diffsinger_tpu_torch.models.hifigan import HifiGanConfig, HifiGanGenerator
from diffsinger_tpu_torch.ops import hifigan_mrf as tmrf
from diffsinger_tpu_torch.tools.fixtures import write_pwg_dir
from diffsinger_tpu_torch.utils.misc import save_wav

torch.set_num_threads(1)
MEL = 16


def _rand_params(params, rng, scale):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32) * scale), params)


def _mel(rng, b, t):
    return (rng.randn(b, t, MEL) * 0.5 - 2.0).astype(np.float32)


# ------------------------------------------------------------ HiFiGAN v3
V3 = dict(resblock="2", upsample_rates=(4, 2, 2), upsample_kernel_sizes=(8, 4, 4),
          upsample_initial_channel=64, resblock_kernel_sizes=(3, 5, 7),
          resblock_dilation_sizes=((1, 2), (2, 6), (3, 12)), num_mels=MEL)


def _v3_pair(**over):
    cfg = dict(V3, **over)
    jgen = JGen(JCfg(**cfg))
    rng = np.random.RandomState(0)
    mel = _mel(rng, 2, 24)
    params = jgen.init(jax.random.PRNGKey(0), jnp.asarray(mel))["params"]
    params = _rand_params(params, rng, 0.08)
    tgen = HifiGanGenerator(HifiGanConfig(**cfg)).eval()
    tgen.load_state_dict(hifigan_state_dict(params), strict=True)
    return jgen, params, tgen, mel


def test_resblock2_generator_matches_jax():
    jgen, params, tgen, mel = _v3_pair()
    assert "resblocks.8.convs.1.weight" in tgen.state_dict()
    want = np.asarray(jgen.apply({"params": params}, jnp.asarray(mel)))
    with torch.no_grad():
        got = tgen(torch.from_numpy(mel)).numpy()
        served = tmrf.hifigan_mrf_apply(tgen, torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, 24 * 16)
    np.testing.assert_allclose(got, want, atol=5e-5)
    # the serving path takes every resblock-2 scale outside the MRF kernel
    assert tmrf.pack_mrf_scales(tgen) == [None, None, None]
    np.testing.assert_array_equal(served, got)
    assert np.abs(want).max() > 1e-2


@pytest.mark.parametrize("backend", ["module", "mrf", "packed", "fast"])
def test_vocoder_backends_take_one_path(backend):
    """The four backends compute one function; ``mrf`` and ``packed`` refuse
    ``resblock: '2'``, as in the JAX wrapper."""
    geom = {"upsample_rates": list(V3["upsample_rates"]),
            "upsample_kernel_sizes": list(V3["upsample_kernel_sizes"]),
            "upsample_initial_channel": 64, "audio_num_mel_bins": MEL,
            "resblock_kernel_sizes": list(V3["resblock_kernel_sizes"]),
            "resblock_dilation_sizes": [list(d) for d in V3["resblock_dilation_sizes"]],
            "vocoder_backend": backend}
    if backend in ("mrf", "packed"):
        with pytest.raises(ValueError, match="resblock '1'"):
            tvoc.HifiGAN({**geom, "resblock": "2"}, device="cpu")
    else:
        assert tvoc.HifiGAN({**geom, "resblock": "2"}, device="cpu").cfg.resblock == "2"
    voc = tvoc.HifiGAN({**geom, "resblock": "1"}, device="cpu")
    voc.load_state_dict(voc.model.state_dict())
    mel = torch.from_numpy(_mel(np.random.RandomState(1), 1, 12))
    with torch.no_grad():
        np.testing.assert_allclose(voc.apply(mel).numpy(), voc.model(mel).numpy(), atol=5e-5)
    with pytest.raises(ValueError, match="vocoder_backend"):
        tvoc.HifiGAN({**geom, "vocoder_backend": "xla"}, device="cpu")


# ------------------------------------------------------------ bf16 vocoder
BF16 = dict(resblock="1", upsample_rates=(2, 2, 2), upsample_kernel_sizes=(4, 4, 4),
            upsample_initial_channel=512, resblock_kernel_sizes=(3, 7, 11),
            resblock_dilation_sizes=((1, 3, 5),) * 3, num_mels=MEL, audio_sample_rate=24000,
            compute_dtype="bfloat16")


@pytest.mark.parametrize("nsf", [False, True])
def test_bf16_vocoder_matches_jax_mrf_apply(nsf):
    """C = 256 (the plain bf16 resblocks), 128 and 64 (the MRF kernel's bf16
    body; its plain twin here) against JAX ``hifigan_mrf_apply`` in bf16."""
    cfg = dict(BF16, use_pitch_embed=nsf)
    jcfg = JCfg(**cfg)
    rng = np.random.RandomState(2)
    b, t = 2, 16
    mel = _mel(rng, b, t)
    f0 = (rng.uniform(120, 300, size=(b, t)) * (rng.rand(b, t) > 0.2)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jgen = JGen(jcfg)
    args = (jnp.asarray(mel), jnp.asarray(f0), key) if nsf else (jnp.asarray(mel),)
    params = _rand_params(jgen.init(jax.random.PRNGKey(0), *args)["params"], rng, 0.03)
    want = np.asarray(j_mrf_apply(params, jcfg, *args))
    tgen = HifiGanGenerator(HifiGanConfig(**cfg)).eval()
    tgen.load_state_dict(hifigan_state_dict(params), strict=True)
    assert tgen.cfg.dtype == torch.bfloat16
    kw = {}
    if nsf:
        rng_phase, rng_noise = jax.random.split(key)
        rand_ini = jax.random.uniform(rng_phase, (b, 1, 9)).at[:, :, 0].set(0.0)
        noise = jax.random.normal(rng_noise, (b, t * 8, 9))
        kw = dict(f0=torch.from_numpy(f0), rand_ini=torch.from_numpy(np.asarray(rand_ini)),
                  noise=torch.from_numpy(np.asarray(noise)))
    with torch.no_grad():
        got = tmrf.hifigan_mrf_apply(tgen, torch.from_numpy(mel), **kw).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (b, t * 8)
    scale = float(np.abs(want).max())
    assert scale > 1e-2
    np.testing.assert_allclose(got, want, atol=1e-2 * max(scale, 1.0))
    # the bf16 rounding shows: JAX's float32 generator lies further off
    want32 = np.asarray(j_mrf_apply(params, JCfg(**dict(cfg, compute_dtype="float32")),
                                    *args))
    assert np.abs(got - want).max() < np.abs(want32 - want).max()


def test_bf16_rounding_points_match_jax():
    """conv_pre, the first upsample (leaky ReLU, transposed conv, bias) and
    an NSF noise conv in bf16, each from the same input, against JAX's bf16
    ops: equal but for the rare element a float32 sum in another order
    rounds one bf16 step apart."""
    cfg = dict(BF16, use_pitch_embed=True)
    rng = np.random.RandomState(5)
    mel = _mel(rng, 2, 16)
    f0 = rng.uniform(120, 300, size=(2, 16)).astype(np.float32)
    jgen = JGen(JCfg(**cfg))
    params = _rand_params(jgen.init(jax.random.PRNGKey(0), jnp.asarray(mel), jnp.asarray(f0),
                                    jax.random.PRNGKey(1))["params"], rng, 0.03)
    tgen = HifiGanGenerator(HifiGanConfig(**cfg)).eval()
    tgen.load_state_dict(hifigan_state_dict(params), strict=True)
    bf = jnp.bfloat16
    dn = ("NHC", "HIO", "NHC")

    def jconv(x, p, stride=1, pad=(3, 3)):
        return jax.lax.conv_general_dilated(x.astype(bf), p["kernel"].astype(bf), (stride,),
                                            [pad], dimension_numbers=dn) + p["bias"].astype(bf)

    def same(got, want):
        got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
        assert got.shape == want.shape and got.dtype == np.float32
        off = got != want
        assert off.mean() < 1e-3, off.mean()
        np.testing.assert_allclose(got, want, rtol=2 ** -7)

    x = jconv(jnp.asarray(mel), params["conv_pre"])
    with torch.no_grad():
        xt = tgen.pre(torch.from_numpy(mel))
    assert xt.dtype == torch.bfloat16
    same(xt, x)
    ups = params["ups_0"]
    want = conv_transpose_1d(jax.nn.leaky_relu(x, 0.1), ups["kernel"].astype(bf),
                             ups["bias"].astype(bf), 2, 1)
    with torch.no_grad():
        same(tgen.upsample(xt, 0), want)
    src = jnp.asarray(rng.uniform(-1, 1, size=(2, 16 * 8, 1)).astype(np.float32))
    with torch.no_grad():
        got = tgen.add_source(torch.zeros(2, 32, 256, dtype=torch.bfloat16),
                              torch.from_numpy(np.asarray(src)), 0)
    same(got, jconv(src, params["noise_convs_0"], stride=4, pad=(2, 2)))


def test_bf16_module_path_matches_jax_module():
    jcfg = JCfg(**BF16)
    rng = np.random.RandomState(4)
    mel = _mel(rng, 1, 12)
    jgen = JGen(jcfg)
    params = _rand_params(jgen.init(jax.random.PRNGKey(0), jnp.asarray(mel))["params"],
                          rng, 0.03)
    want = np.asarray(jgen.apply({"params": params}, jnp.asarray(mel)))
    tgen = HifiGanGenerator(HifiGanConfig(**BF16)).eval()
    tgen.load_state_dict(hifigan_state_dict(params), strict=True)
    with torch.no_grad():
        got = tgen(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-2 * max(float(np.abs(want).max()), 1.0))


def test_vocoder_compute_dtype_from_hparams():
    hp = {"vocoder_compute_dtype": "bfloat16", "upsample_rates": [2, 2],
          "upsample_kernel_sizes": [4, 4], "upsample_initial_channel": 16,
          "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]]}
    assert HifiGanConfig.from_hparams(hp).dtype == torch.bfloat16
    assert HifiGanConfig.from_hparams({}).dtype is None
    with pytest.raises(ValueError):
        HifiGanConfig.from_hparams({**hp, "vocoder_compute_dtype": "float16"})


# --------------------------------------------------------------------- PWG
PWG_PARAMS = {"layers": 4, "stacks": 2, "residual_channels": 8, "gate_channels": 16,
              "skip_channels": 8, "aux_channels": MEL, "aux_context_window": 2,
              "upsample_params": {"upsample_scales": [4, 4]}}
HOP = 16


def _pwg_params(use_pitch_embed):
    gp = dict(PWG_PARAMS, use_pitch_embed=use_pitch_embed)
    jm = JPWG(JPWGConfig.from_config_dict(gp))
    rng = np.random.RandomState(5)
    t = 10
    z = jnp.zeros((1, t * HOP))
    c = jnp.zeros((1, t + 4, MEL))
    pitch = jnp.ones((1, t + 4), jnp.int32) if use_pitch_embed else None
    params = jm.init(jax.random.PRNGKey(0), z, c, pitch)["params"]
    return gp, _rand_params(params, rng, 0.2)


def _pwg_hp(path):
    return {"vocoder": "pwg", "vocoder_ckpt": path, "hop_size": HOP,
            "audio_sample_rate": 22050, "fft_size": 64, "win_size": 64,
            "audio_num_mel_bins": MEL, "fmin": 0, "fmax": 11025}


@pytest.mark.parametrize("layout,use_pitch_embed", [("upstream", False), ("official", False),
                                                    ("official", True)])
def test_pwg_matches_jax(tmp_path, layout, use_pitch_embed):
    gp, params = _pwg_params(use_pitch_embed)
    sd = pwg_state_dict(params)
    rng = np.random.RandomState(6)
    stats = np.stack([rng.randn(MEL), rng.uniform(0.5, 2.0, MEL)]) if layout == "official" \
        else None
    write_pwg_dir(str(tmp_path), sd, gp, official=layout == "official", stats=stats)
    hp = _pwg_hp(str(tmp_path))
    jv = jvoc.PWG(hp)
    tv = tvoc.get_vocoder_cls(hp)(hp, device="cpu")
    assert isinstance(tv, tvoc.PWG) and tv.has_weights
    assert (tv.scaler is not None) == (layout == "official")
    mel = _mel(rng, 1, 23)[0]
    f0 = (rng.uniform(100, 300, 23) * (rng.rand(23) > 0.2)).astype(np.float32)
    want = np.asarray(jv.spec2wav(mel, f0=f0))
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1, 23 * HOP)))
    got = tv.spec2wav(mel, f0=f0, z=z)
    assert got.shape == want.shape == (23 * HOP,)
    np.testing.assert_allclose(got, want, atol=5e-5)
    assert np.abs(want).max() > 1e-2
    # z from a generator: reproducible
    g1 = tv.spec2wav(mel, f0=f0, generator=torch.Generator().manual_seed(3))
    g2 = tv.spec2wav(mel, f0=f0, generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(g1, g2)


def test_pwg_pad_multiple_and_official_stats_rules(tmp_path, monkeypatch):
    gp, params = _pwg_params(False)
    sd = pwg_state_dict(params)
    rng = np.random.RandomState(7)
    mel = _mel(rng, 1, 21)[0]
    stats = np.stack([rng.randn(MEL), rng.uniform(0.5, 2.0, MEL)])
    write_pwg_dir(str(tmp_path / "a"), sd, gp, official=True, stats=stats)
    hp = dict(_pwg_hp(str(tmp_path / "a")), vocoder_pad_multiple=8)
    jv, tv = jvoc.PWG(hp), tvoc.PWG(hp, device="cpu")
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1, 24 * HOP)))
    np.testing.assert_allclose(tv.spec2wav(mel, z=z), jv.spec2wav(mel), atol=5e-5)
    # an official release without its statistics refuses to synthesize
    write_pwg_dir(str(tmp_path / "b"), sd, gp, official=True)
    with pytest.raises(FileNotFoundError, match="stats"):
        tvoc.PWG(_pwg_hp(str(tmp_path / "b")), device="cpu")
    # hdf5 statistics where h5py does not import fall back to stats.npy
    with open(tmp_path / "a" / "stats.h5", "wb") as f:
        f.write(b"not read")
    monkeypatch.setitem(sys.modules, "h5py", None)
    mean, scale = tvoc._load_pwg_stats(str(tmp_path / "a"), "hdf5")
    np.testing.assert_array_equal(np.stack([mean, scale]), stats.astype(np.float32))
    # no checkpoint: Griffin-Lim
    assert tvoc.PWG(_pwg_hp(""), device="cpu").spec2wav(mel).ndim == 1


# ------------------------------------------------------ denoise, wav2spec
def _hp_audio(**over):
    return {"audio_sample_rate": 22050, "fft_size": 1024, "win_size": 1024, "hop_size": 256,
            "audio_num_mel_bins": 80, "fmin": 80, "fmax": 7600, **over}


def _tone(rng, n=22050):
    t = np.arange(n) / 22050
    return (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.randn(n)).astype(np.float32)


def test_denoise_matches_jax():
    wav = _tone(np.random.RandomState(8))
    hp = _hp_audio()
    got, want = tvoc.denoise(wav, hp), jvoc.denoise(wav, hp)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)
    n = len(wav)
    assert np.abs(got[:n] - wav).max() > 1e-3  # it did subtract


@pytest.mark.parametrize("loud_norm", [False, True])
def test_wav2spec_matches_jax(tmp_path, loud_norm):
    path = str(tmp_path / "a.wav")
    save_wav(_tone(np.random.RandomState(9)), path, 22050)
    hp = _hp_audio(loud_norm=loud_norm)
    wav, mel = tvoc.HifiGAN.wav2spec(path, hp)
    jwav, jmel = jvoc.BaseVocoder.wav2spec(path, hp)
    np.testing.assert_allclose(wav, np.asarray(jwav), atol=1e-6)
    np.testing.assert_allclose(mel, np.asarray(jmel), atol=1e-6)
    assert mel.shape[1] == 80 and tvoc.PWG.wav2spec is tvoc.BaseVocoder.wav2spec
    assert os.path.getsize(path) > 0
