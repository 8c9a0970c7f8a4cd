"""The port's library blocks that no shipped pipeline runs, against the JAX
package's: ``BatchNorm1dTBC`` in both modes with its running statistics,
``MultiHeadCrossAttention``, ``DecSALayer``, ``conv_tbc`` and
``FFTBlocks(norm='bn')``, weights carried by ``convert/from_jax.py``.
Tolerance: module parity, atol 3e-5 (``ROADMAP.md``'s ground rules).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.models import common as jcommon
from diffsinger_tpu.models.fft_blocks import FFTBlocks as JFFTBlocks
from diffsinger_tpu_torch.convert.from_jax import (dec_sa_layer_state_dict,
                                                   fft_blocks_state_dict)
from diffsinger_tpu_torch.models import common as tcommon
from diffsinger_tpu_torch.models.fft_blocks import FFTBlocks

torch.set_num_threads(1)
ATOL = 3e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


@pytest.fixture
def bn_pair():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 7, 8).astype(np.float32) * 2 + 0.5
    jbn = jcommon.BatchNorm1dTBC(8)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = {"params": {"scale": jnp.asarray(rng.rand(8).astype(np.float32) + 0.5),
                            "bias": jnp.asarray(rng.randn(8).astype(np.float32))},
                 "batch_stats": {"mean": jnp.asarray(rng.randn(8).astype(np.float32)),
                                 "var": jnp.asarray(rng.rand(8).astype(np.float32) + 0.5)}}
    tbn = tcommon.BatchNorm1dTBC(8)
    tbn.load_state_dict({"weight": _t(variables["params"]["scale"]),
                         "bias": _t(variables["params"]["bias"]),
                         "running_mean": _t(variables["batch_stats"]["mean"]),
                         "running_var": _t(variables["batch_stats"]["var"])})
    return x, jbn, variables, tbn


def test_batchnorm_tbc_training_mode_and_running_statistics(bn_pair):
    x, jbn, variables, tbn = bn_pair
    y, upd = jbn.apply(variables, jnp.asarray(x), use_running_average=False,
                       mutable=["batch_stats"])
    got = tbn(_t(x), train=True)
    _close(got.detach(), y)
    _close(tbn.running_mean, upd["batch_stats"]["mean"], 1e-6)
    _close(tbn.running_var, upd["batch_stats"]["var"], 1e-6)


def test_batchnorm_tbc_eval_mode_reads_running_statistics(bn_pair):
    x, jbn, variables, tbn = bn_pair
    y = jbn.apply(variables, jnp.asarray(x), use_running_average=True)
    before = tbn.running_mean.clone()
    _close(tbn(_t(x)).detach(), y)
    assert torch.equal(tbn.running_mean, before)


def test_batchnorm_tbc_matches_torch_batchnorm1d():
    """torch's convention: momentum 0.1 and the unbiased running variance."""
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 9, 5).astype(np.float32))
    ref = torch.nn.BatchNorm1d(5, momentum=0.1).train()
    want = ref(x.transpose(1, 2)).transpose(1, 2)
    bn = tcommon.BatchNorm1dTBC(5)
    _close(bn(x, train=True).detach(), want.detach(), 1e-5)
    _close(bn.running_mean, ref.running_mean, 1e-6)
    _close(bn.running_var, ref.running_var, 1e-6)


def test_cross_attention_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 16).astype(np.float32)
    enc = rng.randn(2, 9, 16).astype(np.float32)
    pad = np.array([[False] * 9, [False] * 5 + [True] * 4])
    jm = jcommon.MultiHeadCrossAttention(16, 2)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(enc))["params"]
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(enc),
                    key_padding_mask=jnp.asarray(pad))
    tm = tcommon.MultiHeadCrossAttention(16, 2)
    tm.load_state_dict({f"{k}.weight": _t(np.asarray(v["kernel"]).T)
                        for k, v in params.items()})
    got = tm(_t(x), _t(enc), key_padding_mask=_t(pad))
    _close(got.detach(), want)


@pytest.mark.parametrize("cross", [True, False])
def test_dec_sa_layer_matches_jax(cross):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 6, 16).astype(np.float32)
    enc = rng.randn(2, 9, 16).astype(np.float32)
    enc_pad = np.array([[False] * 9, [False] * 5 + [True] * 4])
    self_pad = np.array([[False] * 6, [False] * 4 + [True] * 2])
    layer = jcommon.DecSALayer(hidden_size=16, num_heads=2, dropout=0.0, kernel_size=9)
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(enc),
                        jnp.asarray(enc_pad))["params"]
    # nonzero biases and norm shifts, so every parameter is carried
    params = jax.tree_util.tree_map(
        lambda v: v + 0.1 * jnp.asarray(rng.randn(*v.shape).astype(np.float32)), params)
    args = (jnp.asarray(enc), jnp.asarray(enc_pad)) if cross else ()
    want = layer.apply({"params": params}, jnp.asarray(x), *args,
                       self_attn_padding_mask=jnp.asarray(self_pad))
    tl = tcommon.DecSALayer(16, 2, dropout=0.0, kernel_size=9)
    tl.load_state_dict(dec_sa_layer_state_dict(jax.device_get(params)), strict=True)
    targs = (_t(enc), _t(enc_pad)) if cross else ()
    got = tl(_t(x), *targs, self_attn_padding_mask=_t(self_pad))
    _close(got.detach(), want)


def test_conv_tbc_matches_jax_and_torch():
    rng = np.random.RandomState(3)
    x = rng.randn(9, 2, 4).astype(np.float32)  # [T, B, C_in]
    w = rng.randn(3, 4, 5).astype(np.float32)  # [K, C_in, C_out]
    b = rng.randn(5).astype(np.float32)
    for pad in (0, 1, 2):
        want = jcommon.conv_tbc(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), pad=pad)
        got = tcommon.conv_tbc(_t(x), _t(w), _t(b), pad=pad)
        assert got.shape == want.shape
        _close(got, want, 1e-5)
        _close(got, torch.conv_tbc(_t(x), _t(w), _t(b), pad), 1e-5)


@pytest.mark.parametrize("train", [True, False])
def test_fft_blocks_bn_norm_matches_jax(train):
    """norm='bn' in every layer and the last norm: training mode (batch
    statistics, the running statistics written) and eval mode."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 5, 8).astype(np.float32)
    pad = np.array([[False] * 5, [False] * 3 + [True] * 2])
    jb = JFFTBlocks(hidden_size=8, num_layers=2, num_heads=2, dropout=0.0, norm="bn")
    variables = jax.device_get(jb.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                       jnp.asarray(pad)))
    variables = {"params": jax.tree_util.tree_map(
        lambda v: v + 0.1 * rng.randn(*v.shape).astype(np.float32), variables["params"]),
        "batch_stats": jax.tree_util.tree_map(
            lambda v: v + 0.2 * rng.rand(*v.shape).astype(np.float32),
            variables["batch_stats"])}
    tb = FFTBlocks(8, 2, num_heads=2, dropout=0.0, norm="bn")
    tb.load_state_dict(fft_blocks_state_dict(variables), strict=True)
    assert isinstance(tb.layer_norm, tcommon.BatchNorm1dTBC)
    if train:
        want, upd = jb.apply(variables, jnp.asarray(x), jnp.asarray(pad),
                             deterministic=False, mutable=["batch_stats"])
        got = tb(_t(x), _t(pad), drop_gen=torch.Generator().manual_seed(0))
        stats = fft_blocks_state_dict({"params": variables["params"],
                                       "batch_stats": upd["batch_stats"]})
        for k, v in tb.state_dict().items():
            if "running" in k:
                _close(v, stats[k], 1e-5)
    else:
        want = jb.apply(variables, jnp.asarray(x), jnp.asarray(pad))
        got = tb(_t(x), _t(pad))
    _close(got.detach(), want)


def test_norm_knob_refuses_unknown_norms():
    with pytest.raises(ValueError, match="norm="):
        tcommon.EncSALayer(8, 2, norm="gn")
    layer = tcommon.EncSALayer(8, 2, norm="bn")
    assert isinstance(layer.layer_norm1, tcommon.BatchNorm1dTBC)
    assert set(layer.state_dict()) >= {"layer_norm1.running_mean", "layer_norm2.running_var"}
