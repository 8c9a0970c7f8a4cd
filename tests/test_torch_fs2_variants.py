"""The FS2 variants the shipped configs name, port against the JAX model on
the same weights (``convert/from_jax.py``) and seeded numpy inputs: cwt, ph
and frame pitch, energy, the three speaker modes, ``use_pos_embed: false``
and ``ffn_padding: LEFT``, each in inference (predicted durations into a
static ``t_mel`` bucket, predicted pitch and energy) and with given
durations, f0, uv and energy.

Tolerances: atol 5e-5 on the continuous outputs (float32 on both sides,
only the summation order differs: ``test_reference_oracle.py:175-183``). The
discrete ones are equal: rounded durations, ``mel2ph`` and the coarse pitch
ids. ``f0_to_coarse`` rounds, and one flipped bin moves ``decoder_inp`` by a
whole embedding row, so the weights put the F0 in the voice range and every
test asserts that each value it rounds lies at least ``MARGIN`` (in bins,
or in energy steps) from a rounding boundary, far above the 1e-5 the two
sides differ by. ``fs2_compute_dtype: bfloat16`` has its own tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.models import fs2 as jfs2
from diffsinger_tpu.models.fft_denoiser import FFTDenoiser as JFFTDenoiser
from diffsinger_tpu.utils import pitch as jpitch
from diffsinger_tpu_torch.convert.from_jax import FFT_DENOISER_RULES, apply_rules, fs2_state_dict
from diffsinger_tpu_torch.models import fs2 as tfs2
from diffsinger_tpu_torch.models.fft_denoiser import FFTDenoiser
from diffsinger_tpu_torch.utils.pitch import f0_to_coarse

torch.set_num_threads(1)
ATOL = 5e-5
MARGIN = 2e-3
VOCAB, B, T_TXT, T_MEL, FRAMES = 20, 2, 12, 40, 3
HP = {"hidden_size": 32, "enc_layers": 2, "dec_layers": 2, "num_heads": 2,
      "enc_ffn_kernel_size": 9, "dec_ffn_kernel_size": 9, "ffn_act": "gelu",
      "predictor_hidden": -1, "predictor_layers": 2, "predictor_kernel": 5,
      "dur_predictor_layers": 2, "dur_predictor_kernel": 3, "dropout": 0.0,
      "predictor_dropout": 0.0, "use_pitch_embed": True, "pitch_type": "frame",
      "use_uv": True, "pitch_norm": "log", "audio_num_mel_bins": 16,
      "cwt_hidden_size": 24, "cwt_std_scale": 0.8, "num_spk": 4}
VARIANTS = {
    "cwt": {"pitch_type": "cwt"},
    "ph": {"pitch_type": "ph"},
    "energy": {"use_energy_embed": True},
    "spk_id": {"use_spk_id": True},
    "split_spk_id": {"use_spk_id": True, "use_split_spk_id": True, "pitch_type": "cwt"},
    "spk_embed": {"use_spk_embed": True, "pitch_type": "ph", "use_energy_embed": True},
    "no_pos_embed": {"use_pos_embed": False},
    "ffn_left": {"ffn_padding": "LEFT", "pitch_type": "cwt", "use_energy_embed": True},
}


def _inputs(rng):
    tokens = rng.randint(3, VOCAB, size=(B, T_TXT)).astype(np.int64)
    tokens[1, 9:] = 0  # text padding in row 1
    mel2ph = np.zeros((B, T_MEL), np.int64)
    for i in range(B):
        n_tok = int((tokens[i] > 0).sum())
        dur = rng.randint(1, 4, size=n_tok)
        pos = 0
        for j, d in enumerate(dur):
            mel2ph[i, pos:min(pos + d, T_MEL)] = j + 1
            pos += d
    return {"txt_tokens": tokens, "mel2ph": mel2ph,
            "f0": bin_centred_log2_f0(rng, (B, T_MEL)),
            "f0_ph": bin_centred_log2_f0(rng, (B, T_TXT)),
            "uv": (rng.rand(B, T_MEL) < 0.2).astype(np.float32),
            "energy": rng.uniform(0.05, 3.5, size=(B, T_MEL)).astype(np.float32),
            "spk_ids": np.asarray([1, 3], np.int64),
            "spk_embed": rng.randn(B, 256).astype(np.float32),
            "dur_id": np.asarray([2, 0], np.int64), "f0_id": np.asarray([4, 1], np.int64)}


def bin_centred_log2_f0(rng, shape) -> np.ndarray:
    """log2 F0 whose coarse bins are 40..200, each value within 0.3 of its
    bin's centre: no rounding boundary near any given F0."""
    v = rng.randint(40, 200, size=shape) + rng.uniform(-0.3, 0.3, size=shape)
    mel = (v - 1) * (jpitch.F0_MEL_MAX - jpitch.F0_MEL_MIN) / 254 + jpitch.F0_MEL_MIN
    return np.log2(700 * (np.exp(mel / 1127) - 1)).astype(np.float32)


def _shape_weights(params, rng):
    """Seeded weights that make the discrete decisions meaningful: phones of
    FRAMES frames give or take a few hundredths, predicted F0 around 2^7.5 =
    181 Hz (frame, ph) or e^5.2 (cwt statistics), energies spread over
    [-6, 3) so that ids wrap and fall off the table."""
    p = jax.tree_util.tree_map(np.array, params)
    lin = p["dur_predictor"]["linear"]
    lin["kernel"] *= 0.01
    lin["bias"][:] = np.log(FRAMES + 1.0)
    for name in ("pitch_predictor",):
        if name in p:
            p[name]["linear"]["bias"][0] = 7.5
    if "cwt_stats_2" in p:
        p["cwt_stats_2"]["kernel"] *= 0.1
        p["cwt_stats_2"]["bias"][:] = [5.2, 0.35]
    if "energy_predictor" in p:
        p["energy_predictor"]["linear"]["kernel"] *= 8.0
        p["energy_predictor"]["linear"]["bias"][0] = -1.53
    return p


def build(variant_hp, seed=0):
    hp = {**HP, **variant_hp}
    rng = np.random.RandomState(seed)
    x = _inputs(rng)
    jm = jfs2.FastSpeech2(jfs2.FS2Config.from_hparams(hp, VOCAB))
    kw = _jax_kwargs(hp, x, given=True)
    params = jax.jit(lambda k: jm.init(k, jnp.asarray(x["txt_tokens"]), skip_decoder=False,
                                       **kw))(jax.random.PRNGKey(seed))["params"]
    params = _shape_weights(params, rng)
    tm = tfs2.FastSpeech2(tfs2.FS2Config.from_hparams(hp, VOCAB))
    tm.load_state_dict(fs2_state_dict(params), strict=True)
    tm.eval()
    return hp, jm, params, tm, x


def _spk(hp, x):
    if hp.get("use_spk_id"):
        return x["spk_ids"]
    return x["spk_embed"] if hp.get("use_spk_embed") else None


def _jax_kwargs(hp, x, given):
    kw = {"spk_embed": _spk(hp, x)}
    if given:
        kw.update(mel2ph=x["mel2ph"], uv=x["uv"],
                  f0=x["f0_ph"] if hp.get("pitch_type") == "ph" else x["f0"])
        if hp.get("use_energy_embed"):
            kw["energy"] = x["energy"]
        if hp.get("use_split_spk_id"):
            kw.update(spk_embed_dur_id=x["dur_id"], spk_embed_f0_id=x["f0_id"])
    else:
        kw["t_mel"] = T_MEL + 8
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()
            if v is not None}


def _torch_kwargs(kw):
    return {k: (torch.from_numpy(np.array(v)) if isinstance(v, jax.Array) else v)
            for k, v in kw.items()}


def coarse_margin(f0_denorm) -> float:
    """Distance, in bins, of the F0 values that round into bins 2..254 from
    the nearest rounding boundary (bins 1 and 255 are clamps)."""
    f0 = np.asarray(f0_denorm, np.float64)
    mel = 1127 * np.log(1 + f0 / 700)
    v = (mel - jpitch.F0_MEL_MIN) * 254 / (jpitch.F0_MEL_MAX - jpitch.F0_MEL_MIN) + 1
    v = v[(f0 > 0) & (v > 1.5) & (v < 254.5)]
    return float(np.min(np.abs(v % 1 - 0.5))) if v.size else 1.0


def _energy_margin(energy, real) -> float:
    """Distance of energy * 64 on the real frames from the integers floor()
    cuts at."""
    e = np.asarray(energy, np.float64)[real] * 64
    return float(np.min(np.minimum(e % 1, 1 - e % 1)))


def _compare(got, want, keys):
    """atol 5e-5; F0 in Hz at rtol 1e-5 (the same relative error)."""
    for key in keys:
        tol = dict(rtol=1e-5) if key == "f0_denorm" else dict(atol=ATOL)
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want[key]),
                                   err_msg=key, **tol)


@pytest.mark.parametrize("mode", ["infer", "given"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_fs2_variant_matches_jax(variant, mode):
    hp, jm, params, tm, x = build(VARIANTS[variant])
    kw = _jax_kwargs(hp, x, given=mode == "given")
    want = jm.apply({"params": params}, jnp.asarray(x["txt_tokens"]), infer=True, **kw)
    with torch.no_grad():
        got = tm(torch.from_numpy(x["txt_tokens"]), **_torch_kwargs(kw))
    np.testing.assert_array_equal(got["mel2ph"].numpy(), np.asarray(want["mel2ph"]))
    if mode == "infer":
        np.testing.assert_array_equal(got["dur_choice"].numpy(),
                                      np.asarray(want["dur_choice"]))
        assert int((got["mel2ph"] > 0).sum()) == FRAMES * int((x["txt_tokens"] > 0).sum())
    keys = ["dur", "decoder_inp", "mel_out", "f0_denorm"]
    keys += {"cwt": ["cwt", "f0_mean", "f0_std"], "ph": ["pitch_pred"],
             "frame": ["pitch_pred"]}[hp["pitch_type"]]
    if hp.get("use_energy_embed"):
        keys.append("energy_pred")
        energy = x["energy"] if mode == "given" else np.asarray(want["energy_pred"])
        assert _energy_margin(energy, np.asarray(want["mel2ph"]) > 0) > MARGIN
    assert set(got) == set(want)
    if mode == "infer" and hp["pitch_type"] != "ph":  # predicted voicing: logit > 0
        logit = want["cwt"][..., -1] if hp["pitch_type"] == "cwt" else want["pitch_pred"][..., 1]
        assert np.abs(np.asarray(logit))[np.asarray(want["mel2ph"]) > 0].min() > MARGIN
    assert coarse_margin(want["f0_denorm"]) > MARGIN
    np.testing.assert_array_equal(f0_to_coarse(got["f0_denorm"]).numpy(),
                                  np.asarray(jpitch.f0_to_coarse(want["f0_denorm"])))
    # predicted pitch reaches more than a couple of bins
    assert len(np.unique(np.asarray(jpitch.f0_to_coarse(want["f0_denorm"])))) > 3
    _compare(got, want, keys)


def test_negative_energy_reads_the_table_as_jax_does():
    """Predicted energies from -6 to 3: ids in [-256, 0) wrap to the end of
    the table, ids below -256 read NaN rows (jnp.take's fill), and the port
    gives the same rows and the same NaNs instead of raising."""
    hp, jm, params, tm, x = build(VARIANTS["energy"], seed=1)
    kw = _jax_kwargs(hp, x, given=False)
    want = jm.apply({"params": params}, jnp.asarray(x["txt_tokens"]), infer=True, **kw)
    with torch.no_grad():
        got = tm(torch.from_numpy(x["txt_tokens"]), **_torch_kwargs(kw))
    energy = np.asarray(want["energy_pred"])
    real = np.asarray(want["mel2ph"]) > 0
    ids = np.minimum(np.floor(energy * 256 / 4), 255)[real]
    assert (ids < -256).any() and ((ids >= -256) & (ids < 0)).any() and (ids > 0).any()
    assert _energy_margin(energy, real) > MARGIN
    nan_frames = np.isnan(np.asarray(want["decoder_inp"])).any(-1)
    assert nan_frames.any()
    np.testing.assert_array_equal(np.isnan(got["decoder_inp"].numpy()).any(-1), nan_frames)
    _compare(got, want, ["energy_pred", "decoder_inp"])


def test_fs2_compute_dtype_bfloat16_matches_jax():
    """fs2_compute_dtype: bfloat16 (flax semantics: float32 parameters, each
    projection computed in bf16, attention scores and softmax in float32,
    the sublayer outputs cast back to float32). Given durations and f0, so
    nothing rounds to a different bin. Tolerance 2e-2 of each output's scale:
    both sides round to bf16 at the same points, but a bf16 product summed in
    another order, or a bias added before instead of after the rounding, can
    put a value one bf16 step (2^-8 relative) apart, and four layers carry
    it on."""
    hp, jm, params, tm, x = build({"fs2_compute_dtype": "bfloat16", "pitch_type": "cwt"})
    kw = _jax_kwargs(hp, x, given=True)
    want = jm.apply({"params": params}, jnp.asarray(x["txt_tokens"]), infer=True, **kw)
    with torch.no_grad():
        got = tm(torch.from_numpy(x["txt_tokens"]), **_torch_kwargs(kw))
    assert tm.encoder.layers[0].op.self_attn.dtype == torch.bfloat16
    for key in ("dur", "decoder_inp", "mel_out", "cwt", "f0_mean", "f0_std"):
        w = np.asarray(want[key])
        g = got[key].numpy()
        assert g.dtype == np.float32, key
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-2 * max(1.0, np.abs(w).max()),
                                   err_msg=key)
    # and it is not the float32 model: the bf16 rounding shows
    tm32 = tfs2.FastSpeech2(tfs2.FS2Config.from_hparams({**hp, "fs2_compute_dtype":
                                                         "float32"}, VOCAB))
    tm32.load_state_dict(tm.state_dict())
    with torch.no_grad():
        f32 = tm32(torch.from_numpy(x["txt_tokens"]), **_torch_kwargs(kw))
    assert (f32["mel_out"] - got["mel_out"]).abs().max() > 1e-4


@pytest.mark.parametrize("variant", list(VARIANTS) + ["fft_denoiser"])
def test_every_jax_parameter_maps(variant):
    """Every parameter of the JAX model has its torch key, of the right
    shape, and every port parameter is covered: no key left over either way."""
    if variant == "fft_denoiser":
        jd = JFFTDenoiser(in_dims=16, hidden_size=32, residual_channels=24, num_layers=2)
        params = jd.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 16)),
                         jnp.zeros((1,), jnp.int32), jnp.zeros((1, 8, 32)))["params"]
        sd = apply_rules(params, FFT_DENOISER_RULES)
        port = FFTDenoiser(in_dims=16, hidden_size=32, residual_channels=24, num_layers=2)
    else:
        _, _, params, port, _ = build(VARIANTS[variant])
        sd = fs2_state_dict(params)
    want = port.state_dict()
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(want[k].shape), k


def test_dur_loss_heads():
    """``dur_loss``: huber is mse's head; mog has 15 outputs and, as in JAX,
    no duration decoding; crf has 32 emissions and decodes by Viterbi
    (tests/test_torch_crf.py holds it against JAX)."""
    x = _inputs(np.random.RandomState(0))
    tokens = torch.from_numpy(x["txt_tokens"])
    for dur_loss, shape in (("huber", (B, T_TXT)), ("mog", (B, T_TXT, 15))):
        tm = tfs2.FastSpeech2(tfs2.FS2Config.from_hparams({**HP, "dur_loss": dur_loss},
                                                          VOCAB))
        with torch.no_grad():
            assert tuple(tm(tokens, mel2ph=torch.from_numpy(x["mel2ph"]))["dur"].shape) == shape
    with pytest.raises(NotImplementedError):
        with torch.no_grad():
            tm(tokens, t_mel=T_MEL)
    tm = tfs2.FastSpeech2(tfs2.FS2Config.from_hparams({**HP, "dur_loss": "crf"}, VOCAB))
    with torch.no_grad():
        out = tm(tokens, t_mel=T_MEL)
    assert tuple(out["dur"].shape) == (B, T_TXT, 32) and out["dur_choice"].dtype == torch.long
    with pytest.raises(ValueError):
        tfs2.FastSpeech2(tfs2.FS2Config.from_hparams({**HP, "dur_loss": "ctc"}, VOCAB))


@pytest.mark.parametrize("config,pitch_type", [("configs/lj/ds_beta6.yaml", "cwt"),
                                               ("configs/lj/fs2.yaml", "cwt"),
                                               ("configs/base.yaml", "ph")])
def test_shipped_configs_build_as_shipped(config, pitch_type):
    """The shipped configs, no pitch_type override: the task builds at their
    full width and its FS2 runs a short inference forward."""
    from diffsinger_tpu_torch.config.hparams import set_hparams
    from diffsinger_tpu_torch.training.tasks import DiffSingerTask

    hp = set_hparams(config)
    task = DiffSingerTask(hp, vocab_size=VOCAB, device="cpu")
    assert task.fs2.cfg.pitch_type == pitch_type
    assert hasattr(task.fs2, "cwt_predictor") == (pitch_type == "cwt")
    tokens = torch.from_numpy(np.random.RandomState(0).randint(3, VOCAB, size=(1, 8)))
    with torch.no_grad():
        ret = task.fs2(tokens, t_mel=32)
    assert ret["mel_out"].shape == (1, 32, 80) and torch.isfinite(ret["decoder_inp"]).all()
