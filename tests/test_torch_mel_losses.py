"""The port's SSIM and mel losses against the JAX package: the SSIM map and
its mean (zero-padded edges included), ``mel_l1_loss`` and
``mel_ssim_loss`` with their gradients, and the ``mel_loss`` spec.
Tolerances: values atol 3e-5 (module parity); gradients rtol 1e-4, atol
1e-5 after dividing by max(1, |g|max)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.ops import ssim as jssim
from diffsinger_tpu.training import losses as JL
from diffsinger_tpu_torch.ops import ssim as tssim
from diffsinger_tpu_torch.training import losses as TL

torch.set_num_threads(1)
ATOL = 3e-5


def _mels(seed=0, b=2, t=48, m=20):
    rng = np.random.RandomState(seed)
    target = (rng.randn(b, t, m) * 0.8 - 2.0).astype(np.float32)
    pred = (target + rng.randn(b, t, m) * 0.3).astype(np.float32)
    # row 1: padded tail, zero in the target and the (masked) prediction
    target[1, 35:] = 0.0
    pred[1, 35:] = 0.0
    return pred, target


def _close_scaled(got, want, name):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=1e-4, atol=1e-5,
                               err_msg=f"grad mismatch: {name}")


@pytest.mark.parametrize("shape", [(2, 48, 20), (1, 7, 5), (3, 11, 11)])
def test_ssim_map_and_mean_match_jax(shape):
    """Shapes below and at the window's 11 taps: the zero SAME padding decides
    every edge element."""
    rng = np.random.RandomState(1)
    a = (rng.randn(*shape) + 4.0).astype(np.float32)
    b = (a + rng.randn(*shape) * 0.5).astype(np.float32)
    want = np.asarray(jssim.ssim(jnp.asarray(a), jnp.asarray(b), reduce_mean=False))
    got = tssim.ssim(torch.from_numpy(a), torch.from_numpy(b), reduce_mean=False).numpy()
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(float(tssim.ssim(torch.from_numpy(a), torch.from_numpy(b))),
                               float(jssim.ssim(jnp.asarray(a), jnp.asarray(b))), atol=ATOL)
    # the window's taps
    np.testing.assert_array_equal(tssim._gaussian_kernel(), jssim._gaussian_kernel())


@pytest.mark.parametrize("name", ["l1", "ssim"])
def test_mel_loss_values_and_gradients_match_jax(name):
    pred, target = _mels()
    jfn = {"l1": JL.mel_l1_loss, "ssim": JL.mel_ssim_loss}[name]
    tfn = {"l1": TL.mel_l1_loss, "ssim": TL.mel_ssim_loss}[name]
    want, want_g = jax.value_and_grad(lambda p: jfn(p, jnp.asarray(target)))(jnp.asarray(pred))
    x = torch.from_numpy(pred).requires_grad_(True)
    got = tfn(x, torch.from_numpy(target))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5, atol=ATOL)
    _close_scaled(x.grad.numpy(), np.asarray(want_g), name)
    if name == "l1":  # l1 reads the padded frames with weight 0; ssim's window does not
        assert np.abs(x.grad.numpy()[1, 35:]).max() == 0.0
    else:
        assert np.abs(x.grad.numpy()[1, 35:40]).max() > 0.0
    np.testing.assert_array_equal(TL.weights_nonzero_speech(torch.from_numpy(target)).numpy(),
                                  np.asarray(JL.weights_nonzero_speech(jnp.asarray(target))))


def test_mel_l1_loss_gradient_at_an_exact_match():
    """Where the prediction meets the target exactly, JAX's |x| has derivative
    +1: the port keeps it (``losses.l1``)."""
    pred, target = _mels(2)
    pred[0, :5] = target[0, :5]
    want_g = jax.grad(lambda p: JL.mel_l1_loss(p, jnp.asarray(target)))(jnp.asarray(pred))
    x = torch.from_numpy(pred).requires_grad_(True)
    TL.mel_l1_loss(x, torch.from_numpy(target)).backward()
    _close_scaled(x.grad.numpy(), np.asarray(want_g), "l1 at ties")
    assert (x.grad.numpy()[0, :5] > 0).all()


@pytest.mark.parametrize("spec", ["l1", "ssim:0.5|l1:0.5", "l1:0.25", "ssim"])
def test_parse_and_add_mel_losses_match_jax(spec):
    pred, target = _mels(3)
    assert TL.parse_mel_loss(spec) == JL.parse_mel_loss(spec)
    want = {}
    JL.add_mel_losses(want, jnp.asarray(pred), jnp.asarray(target), spec)
    got = {}
    TL.add_mel_losses(got, torch.from_numpy(pred), torch.from_numpy(target), spec)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=ATOL,
                                   err_msg=k)


def test_unknown_mel_loss_raises():
    pred, target = _mels(4)
    with pytest.raises(NotImplementedError):
        JL.add_mel_losses({}, jnp.asarray(pred), jnp.asarray(target), "l1|mse")
    with pytest.raises(NotImplementedError, match="mse"):
        TL.add_mel_losses({}, torch.from_numpy(pred), torch.from_numpy(target), "l1|mse")
