"""The port's own copies of host helpers against the JAX package's: the YAML
config loader and the F0 codecs (float32 on both sides, so equal to 1e-6)."""

import importlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.utils import pitch as jpitch
from diffsinger_tpu_torch.config import hparams as thp
from diffsinger_tpu_torch.utils import pitch as tpitch

ROOT = Path(__file__).resolve().parents[1]
# the JAX package's config/__init__ exports an ``hparams`` object that shadows
# the module's name as an attribute
jhp = importlib.import_module("diffsinger_tpu.config.hparams")


@pytest.mark.parametrize("cfg", ["lj/ds_beta6.yaml", "popcs/ds_beta6.yaml",
                                 "tpu_production.yaml"])
def test_config_loader_matches_jax(cfg):
    path = str(ROOT / "configs" / cfg)
    assert dict(thp.load_config(path)) == dict(jhp.load_config(path))


def test_overrides_coerce_like_jax():
    base = {"lr": 0.1, "use_uv": True, "max_frames": 10, "spec_min": [1.0]}
    a, b = dict(base), dict(base)
    s = "lr=0.5,use_uv=false,max_frames=20,spec_min=[2.0],new_key=7"
    thp.parse_overrides(a, s)
    jhp.parse_cli_overrides(b, s)
    assert a == b and a["max_frames"] == 20 and a["use_uv"] is False


def test_f0_codecs_match_jax():
    rng = np.random.RandomState(0)
    f0 = rng.uniform(0, 1200, size=(3, 50)).astype(np.float32)
    f0[0, :5] = 0.0
    uv = (rng.rand(3, 50) < 0.3).astype(np.float32)
    pad = rng.rand(3, 50) < 0.1
    t = torch.from_numpy
    np.testing.assert_array_equal(tpitch.f0_to_coarse(t(f0)).numpy(),
                                  np.asarray(jpitch.f0_to_coarse(jnp.asarray(f0))))
    norm_t = tpitch.norm_f0(t(f0), t(uv))
    norm_j = jpitch.norm_f0(jnp.asarray(f0), jnp.asarray(uv))
    np.testing.assert_allclose(norm_t.numpy(), np.asarray(norm_j), atol=1e-6)
    den_t = tpitch.denorm_f0(norm_t, t(uv), pitch_padding=t(pad))
    den_j = jpitch.denorm_f0(norm_j, jnp.asarray(uv), pitch_padding=jnp.asarray(pad))
    np.testing.assert_allclose(den_t.numpy(), np.asarray(den_j), rtol=1e-6)
