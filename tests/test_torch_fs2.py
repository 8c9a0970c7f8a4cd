"""The port's FastSpeech2 parts against the JAX modules on the same weights.

Inputs are made with numpy from a seed; JAX parameters come from the flax
``init`` and reach the port through ``convert/from_jax.py``. Tolerance 5e-5
(float32 on both sides; only the summation order differs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.models import fs2 as jfs2
from diffsinger_tpu.models import predictors as jpred
from diffsinger_tpu_torch.convert.from_jax import fs2_state_dict
from diffsinger_tpu_torch.models import fs2 as tfs2
from diffsinger_tpu_torch.models import predictors as tpred

torch.set_num_threads(1)
ATOL = 5e-5
VOCAB = 20
HP = {"hidden_size": 32, "enc_layers": 2, "dec_layers": 2, "num_heads": 2,
      "enc_ffn_kernel_size": 9, "dec_ffn_kernel_size": 9, "ffn_act": "gelu",
      "predictor_hidden": -1, "predictor_layers": 2, "predictor_kernel": 5,
      "dur_predictor_layers": 2, "dur_predictor_kernel": 3, "dropout": 0.0,
      "predictor_dropout": 0.0, "use_pitch_embed": True, "pitch_type": "frame",
      "use_uv": True, "pitch_norm": "log", "audio_num_mel_bins": 16}


def _batch(rng, b=2, t_txt=12, t_mel=40):
    tokens = rng.randint(3, VOCAB, size=(b, t_txt)).astype(np.int64)
    tokens[1, 9:] = 0  # text padding in row 1
    mel2ph = np.zeros((b, t_mel), np.int64)
    for i in range(b):
        n_tok = int((tokens[i] > 0).sum())
        dur = rng.randint(1, 4, size=n_tok)
        pos = 0
        for j, d in enumerate(dur):
            mel2ph[i, pos:min(pos + d, t_mel)] = j + 1
            pos += d
    f0 = rng.uniform(6.5, 8.5, size=(b, t_mel)).astype(np.float32)
    uv = (rng.rand(b, t_mel) < 0.2).astype(np.float32)
    return tokens, mel2ph, f0, uv


@pytest.fixture(scope="module")
def models():
    rng = np.random.RandomState(0)
    tokens, mel2ph, f0, uv = _batch(rng)
    jm = jfs2.FastSpeech2(jfs2.FS2Config.from_hparams(HP, VOCAB))
    init = jax.jit(lambda k, t, m: jm.init(k, t, mel2ph=m, skip_decoder=False))
    params = init(jax.random.PRNGKey(0), jnp.asarray(tokens), jnp.asarray(mel2ph))["params"]
    tm = tfs2.FastSpeech2(tfs2.FS2Config.from_hparams(HP, VOCAB))
    tm.load_state_dict(fs2_state_dict(params), strict=True)
    tm.eval()
    return jm, params, tm, (tokens, mel2ph, f0, uv)


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def test_encoder_matches_jax(models):
    jm, params, tm, (tokens, *_ ) = models
    want = jm.apply({"params": params}, jnp.asarray(tokens),
                    method=lambda m, x: m.encoder(x))
    got = tm.encoder(_t(tokens))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)


def test_decoder_matches_jax(models):
    jm, params, tm, (_, mel2ph, *_ ) = models
    rng = np.random.RandomState(1)
    x = rng.randn(2, mel2ph.shape[1], HP["hidden_size"]).astype(np.float32)
    pad = mel2ph == 0
    x = x * (~pad)[..., None]
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(pad),
                    method=lambda m, x, p: m.decoder(x, padding_mask=p))
    got = tm.decoder(_t(x), padding_mask=_t(pad))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("gt_f0", [True, False])
def test_fs2_forward_matches_jax(models, gt_f0):
    """Full forward with ground-truth durations: the predictors' continuous
    outputs, the conditioner and the FS2 mel."""
    jm, params, tm, (tokens, mel2ph, f0, uv) = models
    kw = dict(f0=jnp.asarray(f0), uv=jnp.asarray(uv)) if gt_f0 else {}
    want = jm.apply({"params": params}, jnp.asarray(tokens),
                    mel2ph=jnp.asarray(mel2ph), infer=True, **kw)
    tkw = dict(f0=_t(f0), uv=_t(uv)) if gt_f0 else {}
    with torch.no_grad():
        got = tm(_t(tokens), mel2ph=_t(mel2ph), **tkw)
    for key in ("dur", "pitch_pred", "decoder_inp", "mel_out"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=ATOL, err_msg=key)


def test_duration_inference_matches_jax(models):
    """Predicted durations through ``out2dur`` and the length regulator."""
    jm, params, tm, (tokens, *_ ) = models
    want = jm.apply({"params": params}, jnp.asarray(tokens), infer=True, t_mel=48)
    with torch.no_grad():
        got = tm(_t(tokens), t_mel=48)
    np.testing.assert_array_equal(got["mel2ph"].numpy(), np.asarray(want["mel2ph"]))


def test_length_regulator_matches_jax():
    rng = np.random.RandomState(2)
    dur = rng.randint(0, 5, size=(3, 10))
    pad = np.zeros((3, 10), bool)
    pad[1, 7:] = True
    for t_mel in (16, 64):
        want = jpred.length_regulator(jnp.asarray(dur), t_mel,
                                      dur_padding=jnp.asarray(pad))
        got = tpred.length_regulator(_t(dur), t_mel, dur_padding=_t(pad))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
