"""The port's DiffNet stack twin and DiffNet forward against the JAX package.

The JAX Pallas kernel runs in interpret mode, as tests/test_pallas_kernels.py
runs it. Tolerance 1e-4, the JAX package's own stack tolerance, in float32
and in bf16 alike: in bf16 both sides round the same values at the same
points and accumulate in float32, so only the summation order differs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.models.diffnet import DiffNet as JDiffNet
from diffsinger_tpu.ops import diffnet_stack as jds
from diffsinger_tpu_torch.convert.from_jax import denoiser_state_dict
from diffsinger_tpu_torch.models.diffnet import DiffNet
from diffsinger_tpu_torch.ops import diffnet_stack as tds

torch.set_num_threads(1)


def _stack_inputs(rng, b=2, t=48, c=16, num_layers=4):
    f = np.float32
    return dict(
        x0=np.maximum(rng.randn(b, t, c), 0).astype(f),
        step_proj=(rng.randn(num_layers, b, c) * 0.5).astype(f),
        cond_proj=(rng.randn(num_layers, b, t, 2 * c) * 0.5).astype(f),
        w_dil=(rng.randn(num_layers, 3, c, 2 * c) * c ** -0.5).astype(f),
        b_dil=(rng.randn(num_layers, 2 * c) * 0.1).astype(f),
        w_out=(rng.randn(num_layers, c, 2 * c) * c ** -0.5).astype(f),
        b_out=(rng.randn(num_layers, 2 * c) * 0.1).astype(f))


def _port(inp, dilations, compute_dtype=None):
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    return tds.diffnet_stack(**t, dilations=dilations,
                             compute_dtype=compute_dtype).numpy()


@pytest.mark.parametrize("cycle", [1, 4])
def test_stack_twin_f32_matches_jax(cycle):
    rng = np.random.RandomState(cycle)
    inp = _stack_inputs(rng)
    dil = tuple(2 ** (i % cycle) for i in range(4))
    jin = {k: jnp.asarray(v) for k, v in inp.items()}
    got = _port(inp, dil)
    want_kernel = jds.diffnet_stack(**jin, dilations=dil, interpret=True)
    want_xla = jds._stack_xla(*jin.values(), dilations=dil)
    np.testing.assert_allclose(got, np.asarray(want_kernel), atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(want_xla), atol=1e-4)


@pytest.mark.parametrize("cycle", [1, 4])
def test_stack_twin_bf16_matches_jax(cycle):
    rng = np.random.RandomState(10 + cycle)
    inp = _stack_inputs(rng)
    dil = tuple(2 ** (i % cycle) for i in range(4))
    jin = {k: jnp.asarray(v) for k, v in inp.items()}
    want = jds.diffnet_stack(**jin, dilations=dil, interpret=True,
                             compute_dtype=jnp.bfloat16)
    got = _port(inp, dil, torch.bfloat16)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    # and the bf16 path really rounds: it differs from float32
    assert np.abs(got - _port(inp, dil)).max() > 1e-4


@pytest.mark.parametrize("cycle", [1, 4])
def test_stack_twin_matches_jax_chunked_path(cycle, monkeypatch):
    """A T the JAX kernel splits into halo chunks (budget shrunk as
    test_pallas_kernels.py does): the port has no chunking, the result must
    still equal the stitched JAX one."""
    rng = np.random.RandomState(20 + cycle)
    c, num_layers, t = 16, 4, 640
    inp = _stack_inputs(rng, b=1, t=t, c=c, num_layers=num_layers)
    dil = tuple(2 ** (i % cycle) for i in range(num_layers))
    halo = -(-sum(dil) // 8) * 8
    per_row = c * (32 if cycle == 1 else 40)
    monkeypatch.setattr(jds, "VMEM_TILE_BUDGET", per_row * (256 + 2 * halo))
    jds.diffnet_stack.clear_cache()
    try:
        want = jds.diffnet_stack(**{k: jnp.asarray(v) for k, v in inp.items()},
                                 dilations=dil, interpret=True)
    finally:
        jds.diffnet_stack.clear_cache()
    np.testing.assert_allclose(_port(inp, dil), np.asarray(want), atol=1e-4)


def _nets(rng, cycle=2, num_layers=4, c=16, m=8, h=12, b=2, t=40):
    jnet = JDiffNet(in_dims=m, encoder_hidden=h, residual_layers=num_layers,
                    residual_channels=c, dilation_cycle_length=cycle)
    spec = rng.randn(b, t, m).astype(np.float32)
    steps = np.array([3, 17][:b], np.int32)
    cond = rng.randn(b, t, h).astype(np.float32)
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(spec), jnp.asarray(steps),
                       jnp.asarray(cond))["params"]
    # the output projection is zero at init; give it weights so it is tested
    params = dict(params)
    params["output_projection"] = {
        "kernel": jnp.asarray(rng.randn(1, c, m).astype(np.float32) * 0.2),
        "bias": jnp.asarray(rng.randn(m).astype(np.float32) * 0.1)}
    tnet = DiffNet(in_dims=m, encoder_hidden=h, residual_layers=num_layers,
                   residual_channels=c, dilation_cycle_length=cycle)
    tnet.load_state_dict(denoiser_state_dict(params), strict=True)
    return jnet, params, tnet, spec, steps, cond


def test_diffnet_module_matches_jax():
    rng = np.random.RandomState(3)
    jnet, params, tnet, spec, steps, cond = _nets(rng)
    want = jnet.apply({"params": params}, jnp.asarray(spec), jnp.asarray(steps),
                      jnp.asarray(cond))
    with torch.no_grad():
        got = tnet(torch.from_numpy(spec), torch.from_numpy(steps),
                   torch.from_numpy(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


@pytest.mark.parametrize("bf16", [False, True])
def test_diffnet_forward_matches_jax_pallas_forward(bf16):
    """The kernel-path forward with hoisted, packed (and cast) context against
    ``diffnet_forward_pallas`` on a ``pack_sampling_ctx`` dict."""
    rng = np.random.RandomState(4)
    jnet, params, tnet, spec, steps, cond = _nets(rng)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    jcp = jds.precompute_cond_packed(params, jnp.asarray(cond), 4, compute_dtype=jdt)
    jctx = jds.pack_sampling_ctx(params, jcp, 4, compute_dtype=jdt)
    dil = tuple(2 ** (i % 2) for i in range(4))
    want = jds.diffnet_forward_pallas(params, jnp.asarray(spec), jnp.asarray(steps),
                                      jctx, dilations=dil, interpret=True,
                                      compute_dtype=jdt)
    with torch.no_grad():
        tcp = tds.precompute_cond_packed(tnet, torch.from_numpy(cond), compute_dtype=tdt)
        tctx = tds.pack_sampling_ctx(tnet, tcp, compute_dtype=tdt)
        got = tds.diffnet_forward(tnet, torch.from_numpy(spec),
                                  torch.from_numpy(steps), tctx, compute_dtype=tdt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
