"""The port's CWT code against the JAX package's.

The numpy decomposition (``cwt``, ``get_lf0_cwt``, ``convert_continuous_f0``,
``get_cont_lf0``, ``norm_scale``, ``cwt_to_f0_features`` and the binarizer's
``get_f0cwt``) is the same code on the same float64 inputs: equal arrays.
``inverse_cwt`` / ``cwt2f0`` on torch tensors against the JAX package's
``xp=jnp`` path: rtol 1e-5 (float32 sums over 10 scales and over T frames in
another order), on a bucket whose rows have padded frames and on a zero pad
row (std 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.data.binarize import BaseBinarizer
from diffsinger_tpu.utils import cwt as jcwt
from diffsinger_tpu_torch.data.binarize import collate_cwt, get_f0cwt
from diffsinger_tpu_torch.utils import cwt as tcwt


def f0_contour(rng, t: int) -> np.ndarray:
    """A voiced/unvoiced F0 contour in Hz: a vibrato around 120-260 Hz with
    unvoiced runs (0 Hz), also at both ends."""
    base = rng.uniform(120, 260)
    f0 = base * 2 ** (0.15 * np.sin(np.arange(t) / rng.uniform(4, 12))
                      + 0.05 * rng.randn(t).cumsum() / np.sqrt(t))
    uv = np.zeros(t, bool)
    for _ in range(3):
        s = rng.randint(0, t - 5)
        uv[s: s + rng.randint(2, 8)] = True
    uv[:2] = uv[-3:] = True
    return np.where(uv, 0.0, f0)


@pytest.mark.parametrize("t", [37, 64, 200])
def test_numpy_decomposition_is_jax_s(t):
    rng = np.random.RandomState(t)
    f0 = f0_contour(rng, t)
    for name in ("convert_continuous_f0", "get_cont_lf0"):
        for got, want in zip(getattr(tcwt, name)(f0), getattr(jcwt, name)(f0)):
            np.testing.assert_array_equal(got, want, err_msg=name)
    _, lf0 = jcwt.get_cont_lf0(f0)
    for got, want in zip(tcwt.get_lf0_cwt(lf0), jcwt.get_lf0_cwt(lf0)):
        np.testing.assert_array_equal(got, want)
    w, _ = jcwt.cwt(lf0)
    for got, want in zip(tcwt.norm_scale(w), jcwt.norm_scale(w)):
        np.testing.assert_array_equal(got, want)
    got = tcwt.cwt_to_f0_features(f0, 5.2, 0.3)
    want = jcwt.cwt_to_f0_features(f0, 5.2, 0.3)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # an all-unvoiced contour stays as it is
    for got, want in zip(tcwt.convert_continuous_f0(np.zeros(t)),
                         jcwt.convert_continuous_f0(np.zeros(t))):
        np.testing.assert_array_equal(got, want)


def test_get_f0cwt_is_the_binarizer_s():
    rng = np.random.RandomState(1)
    items = []
    for t in (90, 120):
        f0 = f0_contour(rng, t)
        got, want = {}, {}
        get_f0cwt(f0, got)
        BaseBinarizer.get_f0cwt(f0, want)
        assert got.keys() == want.keys() == {"cwt_spec", "cwt_scales", "f0_mean", "f0_std"}
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        items.append(got)
    # the batch keys as the JAX dataset collates them: cut or zero-padded
    # frames, per-utterance float32 statistics
    batch = collate_cwt(items, 100)
    assert batch["cwt_spec"].shape == (2, 100, 10)
    np.testing.assert_array_equal(batch["cwt_spec"][0, :90], items[0]["cwt_spec"])
    assert not batch["cwt_spec"][0, 90:].any()
    np.testing.assert_array_equal(batch["cwt_spec"][1], items[1]["cwt_spec"][:100])
    np.testing.assert_array_equal(
        batch["f0_mean"], np.asarray([it["f0_mean"] for it in items], np.float32))
    np.testing.assert_array_equal(
        batch["f0_std"], np.asarray([it["f0_std"] for it in items], np.float32))


def test_inverse_cwt_and_cwt2f0_match_jax():
    """A padded bucket: rows with 20 and 0 zero frames at the end (the mean
    and std run over all T frames, padding included), and a row of zeros, a
    pad row of the batch (std 0 divides by 1)."""
    rng = np.random.RandomState(2)
    b, t = 3, 64
    spec = rng.randn(b, t, 10).astype(np.float32)
    spec[0, 44:] = 0.0
    spec[2] = 0.0
    mean = rng.uniform(4.5, 6.0, size=b).astype(np.float32)
    std = rng.uniform(0.1, 0.4, size=b).astype(np.float32)
    want_inv = np.asarray(jcwt.inverse_cwt(jnp.asarray(spec), num_scales=10, xp=jnp))
    got_inv = tcwt.inverse_cwt(torch.from_numpy(spec)).numpy()
    np.testing.assert_allclose(got_inv, want_inv, rtol=1e-5, atol=1e-6)
    assert not got_inv[2].any()  # (rec - mean) / 1
    want = np.asarray(jcwt.cwt2f0(jnp.asarray(spec), jnp.asarray(mean), jnp.asarray(std),
                                  xp=jnp))
    got = tcwt.cwt2f0(torch.from_numpy(spec), torch.from_numpy(mean),
                      torch.from_numpy(std)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the population std: an unbiased one would scale every row by sqrt(T/(T-1))
    rec = (spec * (np.arange(10) + 3.5) ** -2.5).sum(-1)
    np.testing.assert_allclose(got_inv[1], (rec[1] - rec[1].mean()) / rec[1].std(),
                               rtol=1e-5, atol=1e-6)
