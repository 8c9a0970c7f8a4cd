"""The singing slice's modules against the JAX package on the same weights:
ESPnet's relative positions (with its table quirk), the FS2 MIDI conditioner
with rel_pos, the PLMS sampler through every Adams-Bashforth order, and the
PitchExtractor with BatchNorm running statistics.

Inputs are made with numpy from a seed; JAX parameters come from the flax
``init`` (the PitchExtractor's norms and statistics randomized) and reach the
port through ``convert/from_jax.py``. Tolerances: 5e-5 absolute for module
outputs of order 1 (float32 on both sides, only summation order differs);
1e-5 relative for the PLMS mel, whose toy denoiser drives it to values in
the thousands; the PLMS start noise is drawn with jax.random as
diffsinger_tpu/models/diffusion.py:sample draws it (``split(rng)``, then one
``normal`` from ``init_rng``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.models import common as jcommon
from diffsinger_tpu.models import fs2 as jfs2
from diffsinger_tpu.models import pe as jpe
from diffsinger_tpu.models.diffusion import DiffusionConfig as JDCfg
from diffsinger_tpu.models.diffusion import GaussianDiffusion as JGD
from diffsinger_tpu_torch.convert.from_jax import fs2_state_dict, pe_state_dict
from diffsinger_tpu_torch.models import common as tcommon
from diffsinger_tpu_torch.models import fs2 as tfs2
from diffsinger_tpu_torch.models import pe as tpe
from diffsinger_tpu_torch.models.diffusion import DiffusionConfig, GaussianDiffusion

torch.set_num_threads(1)
ATOL = 5e-5
VOCAB = 30
MIDI_HP = {"hidden_size": 32, "enc_layers": 2, "dec_layers": 2, "num_heads": 2,
           "enc_ffn_kernel_size": 9, "dec_ffn_kernel_size": 9, "ffn_act": "gelu",
           "predictor_hidden": -1, "predictor_layers": 2, "predictor_kernel": 5,
           "dur_predictor_layers": 2, "dur_predictor_kernel": 3, "dropout": 0.0,
           "predictor_dropout": 0.0, "pitch_type": "frame", "use_uv": True,
           "pitch_norm": "log", "audio_num_mel_bins": 16, "use_midi": True,
           "rel_pos": True}


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


# ------------------------------------------------------------ rel positions
@pytest.mark.parametrize("t", [7, 300, 5003])
def test_rel_positional_encoding_matches_jax_with_the_espnet_quirk(t):
    dim = 16 if t < 5000 else 8
    x = np.random.RandomState(t).randn(2, t, dim).astype(np.float32)
    want = jcommon.RelPositionalEncoding(dim).apply({}, jnp.asarray(x))
    got = tcommon.RelPositionalEncoding(dim)(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-6)
    # the quirk itself: up to max_len rows the table's first rows are added,
    # positions max_len - 1 downwards, whatever t is
    length = max(5000, t)
    pos = np.arange(length - 1, length - 1 - t, -1)
    div = np.exp(np.arange(0, dim, 2) * -(np.log(10000.0) / dim))
    added = got.numpy()[0] - x[0] * np.sqrt(dim)
    np.testing.assert_allclose(added[:, 0::2], np.sin(pos[:, None] * div), atol=1e-4)
    np.testing.assert_allclose(added[:, 1::2], np.cos(pos[:, None] * div), atol=1e-4)


# ----------------------------------------------------------------- FS2 MIDI
def _midi_batch(rng, b=2, t_txt=12, t_mel=40):
    tokens = rng.randint(3, VOCAB, size=(b, t_txt)).astype(np.int64)
    tokens[1, 9:] = 0
    pitch_midi = rng.randint(40, 80, size=(b, t_txt)).astype(np.int64)
    pitch_midi[tokens == 0] = 0
    pitch_midi[0, 3] = 0  # a rest
    midi_dur = (rng.rand(b, t_txt) * 0.6).astype(np.float32)
    is_slur = (rng.rand(b, t_txt) < 0.3).astype(np.int64)
    mel2ph = np.zeros((b, t_mel), np.int64)
    for i in range(b):
        pos = 0
        for j, d in enumerate(rng.randint(1, 4, size=int((tokens[i] > 0).sum()))):
            mel2ph[i, pos:min(pos + d, t_mel)] = j + 1
            pos += d
    f0 = rng.uniform(6.5, 8.5, size=(b, t_mel)).astype(np.float32)
    uv = (rng.rand(b, t_mel) < 0.2).astype(np.float32)
    return tokens, pitch_midi, midi_dur, is_slur, mel2ph, f0, uv


@pytest.mark.parametrize("use_pitch_embed", [False, True])
def test_fs2_midi_rel_pos_matches_jax(use_pitch_embed):
    hp = dict(MIDI_HP, use_pitch_embed=use_pitch_embed)
    rng = np.random.RandomState(3)
    tokens, pitch_midi, midi_dur, is_slur, mel2ph, f0, uv = _midi_batch(rng)
    jm = jfs2.FastSpeech2(jfs2.FS2Config.from_hparams(hp, VOCAB))
    midi = dict(pitch_midi=jnp.asarray(pitch_midi), midi_dur=jnp.asarray(midi_dur),
                is_slur=jnp.asarray(is_slur))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(tokens), mel2ph=jnp.asarray(mel2ph),
                     skip_decoder=False, **midi)["params"]
    tm = tfs2.FastSpeech2(tfs2.FS2Config.from_hparams(hp, VOCAB))
    tm.load_state_dict(fs2_state_dict(params), strict=True)
    assert {"midi_embed.weight", "midi_dur_layer.weight", "is_slur_embed.weight"} <= \
        set(tm.state_dict())
    assert hasattr(tm, "pitch_predictor") == use_pitch_embed
    gt = dict(f0=f0, uv=uv) if use_pitch_embed else {}
    want = jm.apply({"params": params}, jnp.asarray(tokens), mel2ph=jnp.asarray(mel2ph),
                    **{k: jnp.asarray(v) for k, v in gt.items()}, **midi)
    with torch.no_grad():
        got = tm(_t(tokens), mel2ph=_t(mel2ph), pitch_midi=_t(pitch_midi),
                 midi_dur=_t(midi_dur), is_slur=_t(is_slur),
                 **{k: _t(v) for k, v in gt.items()})
    for key in ("dur", "decoder_inp", "mel_out") + (("pitch_pred",) if use_pitch_embed
                                                    else ()):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL,
                                   err_msg=key)
    assert ("f0_denorm" in got) == use_pitch_embed
    with pytest.raises(ValueError, match="pitch_midi"):
        tm(_t(tokens), mel2ph=_t(mel2ph))


# --------------------------------------------------------------------- PLMS
M = 8


def _plms_pair(timesteps, k_step, speedup, gaussian_start):
    rng = np.random.RandomState(k_step)
    spec_min = rng.uniform(-6, -4, M)
    spec_max = rng.uniform(0, 1.5, M)
    w = (rng.randn(M, M) * 0.3).astype(np.float32)
    calls = []

    def jden(params, x, ts, c):
        return jnp.tanh(x @ w + c) * 0.5 + 1e-3 * ts[:, None, None]

    def tden(x, ts, c):
        calls.append(int(ts[0]))
        return torch.tanh(x @ torch.from_numpy(w) + c) * 0.5 + 1e-3 * ts[:, None, None]

    jgd = JGD(JDCfg(timesteps=timesteps, k_step=k_step, schedule_type="linear",
                    max_beta=0.02, spec_min=tuple(spec_min), spec_max=tuple(spec_max),
                    keep_bins=M, mel_bins=M, pndm_speedup=speedup,
                    gaussian_start=gaussian_start), jden)
    hp = {"timesteps": timesteps, "K_step": k_step, "schedule_type": "linear",
          "max_beta": 0.02, "keep_bins": M, "spec_min": list(spec_min),
          "spec_max": list(spec_max), "pndm_speedup": speedup,
          "gaussian_start": gaussian_start}
    return jgd, GaussianDiffusion(DiffusionConfig.from_hparams(hp), tden), calls


@pytest.mark.parametrize("timesteps,k_step,speedup,gaussian_start", [
    (1000, 1000, 40, True),   # ds1000: 25 steps, 26 denoiser calls
    (20, 8, 2, False),        # ts 6, 4, 2, 0: orders 1 (warm-up), 2, 3, 4
])
def test_plms_sample_matches_jax(timesteps, k_step, speedup, gaussian_start):
    jgd, tgd, calls = _plms_pair(timesteps, k_step, speedup, gaussian_start)
    rng = np.random.RandomState(5)
    b, t = 2, 24
    cond = rng.randn(b, t, M).astype(np.float32)
    fs2_mel = (rng.randn(b, t, M) - 3).astype(np.float32)
    nonpad = np.ones((b, t), np.float32)
    nonpad[1, 17:] = 0
    key = jax.random.PRNGKey(11)
    want = jgd.sample(None, jnp.asarray(cond), key, fs2_mel=jnp.asarray(fs2_mel),
                      tgt_nonpadding=jnp.asarray(nonpad))
    start = jax.random.normal(jax.random.split(key)[1], (b, t, M))
    got = tgd.sample(_t(cond), fs2_mel=_t(fs2_mel), tgt_nonpadding=_t(nonpad),
                     noise=_t(np.asarray(start)[None]))
    # the toy denoiser is no real one, so the mel drifts far from [-1, 1]
    # (values in the thousands): hold it to float32's relative precision too
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-5)
    ts = list(range(0, k_step, speedup))[::-1]
    # the warm-up calls at t0 and t0 - interval, then once per later step
    assert calls == [ts[0], max(ts[0] - speedup, 0)] + ts[1:]
    assert tgd.denoiser_calls() == len(calls) == k_step // speedup + 1
    with pytest.raises(ValueError, match="noise must be"):
        tgd.sample(_t(cond), noise=torch.zeros(k_step + 1, b, t, M))


# -------------------------------------------------------------------- PE
PE_HP = {"hidden_size": 32, "predictor_hidden": -1, "predictor_kernel": 5,
         "audio_num_mel_bins": 16, "pitch_type": "frame", "use_uv": True,
         "pitch_norm": "log"}


def test_pitch_extractor_matches_jax_with_running_statistics():
    rng = np.random.RandomState(2)
    mel = (rng.randn(2, 40, 16) * 0.5 - 2.0).astype(np.float32)
    mel[1, 31:] = 0.0  # zero-padded tail: f0 forced to 0 there
    jm = jpe.PitchExtractor(jpe.PEConfig.from_hparams(PE_HP))
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(mel))
    stats = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(0.5, 2.0, a.shape).astype(np.float32)),
        variables["batch_stats"])
    stats = {name: {"mean": bn["mean"] - 1.2, "var": bn["var"]}
             for name, bn in stats["mel_prenet"].items()}
    variables = {"params": variables["params"], "batch_stats": {"mel_prenet": stats}}
    # perturb the norms' scale and bias away from 1 and 0
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a + jnp.asarray(rng.randn(*a.shape).astype(np.float32) * 0.1)
        if any(getattr(p, "key", "").startswith(("bn_", "norm_")) for p in path) else a,
        variables["params"])
    variables = {"params": params, "batch_stats": variables["batch_stats"]}
    want = jm.apply(variables, jnp.asarray(mel))
    tm = tpe.PitchExtractor(tpe.PEConfig.from_hparams(PE_HP))
    tm.load_state_dict(pe_state_dict(variables), strict=True)
    got = tm(_t(mel))
    np.testing.assert_allclose(got["pitch_pred"].numpy(), np.asarray(want["pitch_pred"]),
                               atol=ATOL)
    f0_w = np.asarray(want["f0_denorm_pred"])
    f0_g = got["f0_denorm_pred"].numpy()
    np.testing.assert_array_equal(f0_g == 0, f0_w == 0)
    np.testing.assert_allclose(f0_g, f0_w, rtol=1e-4)
    assert (f0_g[1, 31:] == 0).all() and (f0_g[0] > 0).any()
    # the running statistics matter: they differ from the batch's own
    bn = tm.mel_prenet.layers[0][2]
    assert float(bn.running_mean.abs().max()) > 0.1
