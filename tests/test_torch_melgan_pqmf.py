"""The port's MelGAN, PQMF filterbank and multi-resolution STFT loss against
the JAX package on shared weights (``convert/from_jax.py``) and inputs.

MelGAN: the generator at 32 channels with an odd (3) and an even (2)
upsampling scale and two residual stacks, the single- and multi-scale
discriminators as shipped (16 -> 1024 channels, grouped strided convs).
Tolerances: modules atol 3e-5 of max(1, scale); losses rtol 1e-5; gradients
rtol 1e-4 and atol 1e-5 after dividing by the tensor's scale; the PQMF
filters 1e-6 (numpy and scipy on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.models import melgan as jmg
from diffsinger_tpu.ops import pqmf as jpq
from diffsinger_tpu.ops import stft_loss as jsl
from diffsinger_tpu_torch.convert.from_jax import melgan_state_dict
from diffsinger_tpu_torch.models import melgan as tmg
from diffsinger_tpu_torch.ops import pqmf as tpq
from diffsinger_tpu_torch.ops import stft_loss as tsl

torch.set_num_threads(1)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=3e-5 * max(1.0, float(np.abs(want).max())))


def _scaled_close(got, want, err_msg=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale, rtol=1e-4, atol=1e-5,
                               err_msg=err_msg)


def _rand_params(params, rng, scale):
    return jax.tree_util.tree_map(
        lambda a: rng.randn(*a.shape).astype(np.float32) * scale, params)


# ------------------------------------------------------------------- MelGAN
@pytest.mark.parametrize("scales", [(3, 2), (2, 3)], ids=["odd_first", "even_first"])
def test_melgan_generator_matches_jax(scales):
    """An odd scale appends one zero frame after its transposed conv."""
    kw = dict(in_channels=16, channels=32, upsample_scales=scales, stacks=2)
    jgen = jmg.MelGANGenerator(**kw)
    rng = np.random.RandomState(0)
    mel = (rng.randn(2, 12, 16) * 0.5 - 2).astype(np.float32)
    params = _rand_params(jgen.init(jax.random.PRNGKey(0), jnp.asarray(mel))["params"],
                          rng, 0.1)
    want = np.asarray(jax.jit(jgen.apply)({"params": params}, jnp.asarray(mel)))
    tgen = tmg.MelGANGenerator(**kw)
    sd = melgan_state_dict(params)
    assert len(sd) == len(jax.tree_util.tree_leaves(params)) == len(tgen.state_dict())
    tgen.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tgen(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, 12 * 6)
    _close(got, want)
    assert np.abs(got).max() <= 1.0


def test_melgan_default_generator_names_and_shapes():
    gen = tmg.MelGANGenerator()
    sd = gen.state_dict()
    assert tuple(sd["ups.0.weight"].shape) == (512, 256, 16)
    assert tuple(sd["stacks.3.2.conv_dilated.weight"].shape) == (32, 32, 3)
    assert gen.stacks[1][2].conv_dilated.dilation == (9,)
    with torch.no_grad():
        assert gen(torch.zeros(1, 8, 80)).shape == (1, 8 * 256)


@pytest.fixture(scope="module")
def msd():
    jdisc = jmg.MelGANMultiScaleDiscriminator(scales=2)
    x = np.random.RandomState(1).randn(2, 2050).astype(np.float32) * 0.3
    params = jax.jit(jdisc.init)(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    return jdisc, params, x


def test_melgan_discriminators_match_jax(msd):
    """Every layer's output of both scales; 2050 samples (not a multiple of
    the downsampling) on the first scale, 1025 (odd) on the second."""
    jdisc, params, x = msd
    want = jax.jit(jdisc.apply)({"params": params}, jnp.asarray(x))
    tdisc = tmg.MelGANMultiScaleDiscriminator(scales=2)
    sd = melgan_state_dict(params)
    assert len(sd) == len(jax.tree_util.tree_leaves(params)) == len(tdisc.state_dict())
    tdisc.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tdisc(torch.from_numpy(x))
    assert len(got) == len(want) == 2
    for gs, ws in zip(got, want):
        assert len(gs) == len(ws) == 7
        for g, w in zip(gs, ws):
            _close(g.numpy().transpose(0, 2, 1), w)   # channels-first in the port
    # the single-scale discriminator from the same weights, and its groups
    one = tmg.MelGANDiscriminator()
    one.load_state_dict(melgan_state_dict(params["discriminators_0"]), strict=True)
    assert [c.groups for c in one.down] == [4, 16, 64, 256]
    with torch.no_grad():
        _close(one(torch.from_numpy(x))[-1].numpy().transpose(0, 2, 1), want[0][-1])


# --------------------------------------------------------------------- PQMF
def test_pqmf_filters_analysis_and_synthesis_match_jax():
    np.testing.assert_allclose(tpq.design_prototype_filter(), jpq.design_prototype_filter(),
                               rtol=0, atol=1e-12)
    jp, tp = jpq.PQMF(4), tpq.PQMF(4)
    np.testing.assert_allclose(tp.analysis_filter.numpy(), np.asarray(jp.analysis_filter),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tp.synthesis_filter.numpy(), np.asarray(jp.synthesis_filter),
                               rtol=0, atol=1e-6)
    x = np.random.RandomState(2).randn(2, 4096).astype(np.float32)
    bands = tp.analysis(torch.from_numpy(x))
    want = np.asarray(jp.analysis(jnp.asarray(x)))
    assert bands.shape == want.shape == (2, 1024, 4)
    _close(bands.numpy(), want)
    y = np.random.RandomState(3).randn(2, 1024, 4).astype(np.float32)
    got = tp.synthesis(torch.from_numpy(y))
    want = np.asarray(jp.synthesis(jnp.asarray(y)))
    assert got.shape == want.shape == (2, 4096)
    _close(got.numpy(), want)
    with pytest.raises(ValueError):
        tpq.design_prototype_filter(taps=63)


def test_pqmf_round_trip_reconstructs():
    """Near-perfect reconstruction after the bank's group delay: the JAX
    package's own criterion (mean error under 0.15 of the mean level)."""
    x = np.random.RandomState(0).randn(2, 4096).astype(np.float32)
    pq = tpq.PQMF(4)
    x_hat = pq.synthesis(pq.analysis(torch.from_numpy(x))).numpy()
    err, delay = min((np.abs(x[:, : 4096 - d] - x_hat[:, d:]).mean(), d) for d in range(80))
    assert err < 0.15 * np.abs(x).mean(), (err, delay)


# ---------------------------------------------------------------- STFT loss
def _stft_grads(fn, x, y, args, i):
    """d term_i / dx of the port's and of JAX's ``fn`` in float64 (JAX under
    ``jax.enable_x64``)."""
    tx = torch.from_numpy(x.astype(np.float64)).requires_grad_(True)
    gx, = torch.autograd.grad(fn(tx, torch.from_numpy(y.astype(np.float64)), *args)[i], tx)
    jfn = getattr(jsl, fn.__name__)
    with jax.enable_x64(True):
        y64 = jnp.asarray(y.astype(np.float64))
        wx = np.asarray(jax.grad(lambda a: jfn(a, y64, *args)[i])(
            jnp.asarray(x.astype(np.float64))))
    return gx.numpy(), wx


def test_stft_loss_terms_and_gradients_match_jax():
    """Values in float32; gradients in float64 on both sides: the log term's
    gradient carries 1 / |X| of each bin, and at a bin near zero float32's
    FFT rounding alone moves it 1e-5 of the gradient's scale."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 3000).astype(np.float32) * 0.3
    y = rng.randn(2, 3000).astype(np.float32) * 0.3
    for fn, args in ((tsl.stft_loss, (512, 50, 240)), (tsl.multi_resolution_stft_loss, ())):
        got = fn(torch.from_numpy(x), torch.from_numpy(y), *args)
        want = getattr(jsl, fn.__name__)(jnp.asarray(x), jnp.asarray(y), *args)
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g.item(), float(w), rtol=1e-5)
            _scaled_close(*_stft_grads(fn, x, y, args, i), err_msg=f"{fn.__name__} term {i}")
    # the terms alone, on magnitudes
    xm, ym = (np.abs(rng.randn(2, 9, 33)).astype(np.float32) for _ in range(2))
    for name in ("spectral_convergence_loss", "log_stft_magnitude_loss"):
        np.testing.assert_allclose(
            getattr(tsl, name)(torch.from_numpy(xm), torch.from_numpy(ym)).item(),
            float(getattr(jsl, name)(jnp.asarray(xm), jnp.asarray(ym))), rtol=1e-5)


def test_stft_loss_of_equal_signals_and_its_gradient():
    """stft_loss(x, x): both terms 0. The log term's gradient takes JAX's
    derivative of |.| at 0 (+1) and matches JAX's (in float64, as above);
    the spectral convergence's
    norm of an all-zero difference has gradient NaN in JAX and 0 in the port
    (torch's ``vector_norm``), a difference the port documents and keeps."""
    x = np.random.RandomState(5).randn(1, 2000).astype(np.float32) * 0.3
    tx = torch.from_numpy(x).requires_grad_(True)
    sc, mag = tsl.stft_loss(tx, tx.detach(), 512, 50, 240)
    assert sc.item() == 0.0 and mag.item() == 0.0
    g_sc, = torch.autograd.grad(sc, tx)
    assert torch.equal(g_sc, torch.zeros_like(g_sc))
    j_sc = jax.grad(lambda a: jsl.stft_loss(a, jnp.asarray(x), 512, 50, 240)[0])(jnp.asarray(x))
    assert np.isnan(np.asarray(j_sc)).all()
    _scaled_close(*_stft_grads(tsl.stft_loss, x, x, (512, 50, 240), 1))
