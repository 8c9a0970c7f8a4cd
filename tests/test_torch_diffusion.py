"""The port's DDPM sampler against the JAX sampler with the same noise.

JAX threefry and torch draw different numbers, so the noise is drawn with
jax.random exactly as diffsinger_tpu/models/diffusion.py:239-294 draws it
(``split(rng)`` -> boost noise from ``init_rng``, then ``split(rng, k)`` ->
one ``normal`` per reverse step) and handed to the port as ``noise``.
Tolerance 1e-5: float32 on both sides, elementwise arithmetic only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.models.diffusion import DiffusionConfig as JCfg
from diffsinger_tpu.models.diffusion import GaussianDiffusion as JGD
from diffsinger_tpu_torch.models.diffusion import DiffusionConfig, GaussianDiffusion

torch.set_num_threads(1)
M = 8


def jax_sampler_noise(rng, k, shape):
    rng, init_rng = jax.random.split(rng)
    draws = [jax.random.normal(init_rng, shape)]
    draws += [jax.random.normal(r, shape) for r in jax.random.split(rng, k)]
    return np.stack([np.asarray(d) for d in draws])


def _hp(schedule):
    rng = np.random.RandomState(0)
    return {"timesteps": 20, "K_step": 14, "schedule_type": schedule, "max_beta": 0.06,
            "keep_bins": M, "spec_min": list(rng.uniform(-6, -4, M)),
            "spec_max": list(rng.uniform(0, 1.5, M))}


@pytest.mark.parametrize("schedule", ["linear", "cosine"])
def test_ddpm_sample_matches_jax(schedule):
    hp = _hp(schedule)
    rng = np.random.RandomState(1)
    b, t = 2, 24
    cond = rng.randn(b, t, M).astype(np.float32)
    fs2_mel = (rng.randn(b, t, M) - 3).astype(np.float32)
    nonpad = np.ones((b, t), np.float32)
    nonpad[1, 17:] = 0
    w = (rng.randn(M, M) * 0.3).astype(np.float32)

    def jden(params, x, ts, c):
        return jnp.tanh(x @ w + c) * 0.5 + 0.01 * ts[:, None, None]

    def tden(x, ts, c):
        return torch.tanh(x @ torch.from_numpy(w) + c) * 0.5 + 0.01 * ts[:, None, None]

    jgd = JGD(JCfg(timesteps=20, k_step=14, schedule_type=schedule, max_beta=0.06,
                   spec_min=tuple(hp["spec_min"]), spec_max=tuple(hp["spec_max"]),
                   keep_bins=M, mel_bins=M), jden)
    key = jax.random.PRNGKey(5)
    want = jgd.sample(None, jnp.asarray(cond), key, fs2_mel=jnp.asarray(fs2_mel),
                      tgt_nonpadding=jnp.asarray(nonpad))
    noise = jax_sampler_noise(key, 14, (b, t, M))
    tgd = GaussianDiffusion(DiffusionConfig.from_hparams(hp), tden)
    got = tgd.sample(torch.from_numpy(cond), fs2_mel=torch.from_numpy(fs2_mel),
                     tgt_nonpadding=torch.from_numpy(nonpad),
                     noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_sample_checks_noise_shape_and_uses_generator():
    tgd = GaussianDiffusion(DiffusionConfig.from_hparams(_hp("linear")),
                            lambda x, ts, c: x * 0.1)
    cond = torch.zeros(1, 4, M)
    with pytest.raises(ValueError):
        tgd.sample(cond, noise=torch.zeros(3, 1, 4, M))
    a = tgd.sample(cond, generator=torch.Generator().manual_seed(3))
    b = tgd.sample(cond, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b)
    # the coefficient tables reach each device once
    assert list(tgd._on_device) == [torch.device("cpu")]
