"""The port's training stack (plain twins, autograd function) and
``diffnet_train_forward`` against the JAX package.

The JAX Pallas kernels run in interpret mode, as tests/test_pallas_kernels.py
runs them. Tolerances follow the JAX package: f32 values at atol 5e-5 (skips,
xs); f32 gradients at rtol 1e-4, atol 1e-5 after dividing by max(1, |g|max).
In bf16 both sides round the same values at the same points; the JAX kernel
also rounds its per-tile weight gradients and dcond to bf16 where the port
keeps f32, so the bf16 cotangents are held at cos > 0.9999 and a max error of
1e-2 of each tensor's scale (the JAX package's own bf16 test allows 0.999 and
0.05 against an f32 reference)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.models.diffnet import DiffNet as JDiffNet
from diffsinger_tpu.ops import diffnet_train as jdt
from diffsinger_tpu_torch.convert.from_jax import denoiser_state_dict
from diffsinger_tpu_torch.models.diffnet import DiffNet
from diffsinger_tpu_torch.ops import diffnet_train as tdt

torch.set_num_threads(1)
B, T, C, H, L = 2, 32, 16, 12, 4  # H != C on purpose


def _stack_args(rng, b=B, t=T, c=C, h=H, num_layers=L):
    f = np.float32
    return (rng.randn(b, t, c).astype(f),
            (rng.randn(num_layers, b, c) * 0.5).astype(f),
            rng.randn(b, t, h).astype(f),
            (rng.randn(num_layers, h, 2 * c) * 0.3).astype(f),
            (rng.randn(num_layers, 2 * c) * 0.1).astype(f),
            (rng.randn(num_layers, 3, c, 2 * c) * 0.3).astype(f),
            (rng.randn(num_layers, 2 * c) * 0.1).astype(f),
            (rng.randn(num_layers, c, 2 * c) * 0.3).astype(f),
            (rng.randn(num_layers, 2 * c) * 0.1).astype(f))


def _close_scaled(got, want, name):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=1e-4, atol=1e-5,
                               err_msg=f"grad mismatch: {name}")


def _close_bf16(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    cos = float(np.dot(got.ravel(), want.ravel())
                / (np.linalg.norm(got) * np.linalg.norm(want) + 1e-30))
    rel = float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))
    assert cos > 0.9999 and rel < 1e-2, (name, cos, rel)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("cycle", [1, 2])
def test_stack_twins_match_jax_vjp(cycle, bf16):
    """Forward twin (skips, xs) and explicit backward twin (all nine
    cotangents) against JAX's _fwd_call and make_stack_vjp."""
    rng = np.random.RandomState(cycle + 10 * bf16)
    args = _stack_args(rng)
    ds = rng.randn(B, T, C).astype(np.float32)
    dil = tuple(2 ** (i % cycle) for i in range(L))
    jcdt, tcdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    save = jnp.bfloat16 if bf16 else jnp.float32
    jargs = tuple(jnp.asarray(a) for a in args)
    want_skips, want_xs = jdt._fwd_call(*jargs, dil, 1, True, jcdt, save)
    fn = jdt.make_stack_vjp(dil, 1, True, jcdt, save)
    _, vjp = jax.vjp(fn, *jargs)
    want_grads = vjp(jnp.asarray(ds))

    targs = [torch.from_numpy(a) for a in args]
    skips, xs = tdt.diffnet_train_stack_fwd_plain(*targs, dilations=dil,
                                                  compute_dtype=tcdt)
    assert xs.dtype == (torch.bfloat16 if bf16 else torch.float32)
    got_grads = tdt.diffnet_train_stack_bwd_plain(xs, *targs[1:8], torch.from_numpy(ds),
                                                  dilations=dil, compute_dtype=tcdt)
    np.testing.assert_allclose(skips.numpy(), np.asarray(want_skips), atol=5e-5)
    np.testing.assert_allclose(xs.float().numpy(), np.asarray(want_xs, np.float32),
                               atol=5e-5)
    for name, g, w in zip(tdt.GRAD_NAMES, got_grads, want_grads):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        if bf16:
            _close_bf16(g.numpy(), w, name)
        else:
            _close_scaled(g.numpy(), w, name)


@pytest.mark.parametrize("cycle", [1, 2])
def test_stack_explicit_backward_equals_autograd_f32(cycle):
    """In f32 the explicit backward twin equals autograd of the plain
    forward (the stack_reference), and so does the autograd function."""
    rng = np.random.RandomState(20 + cycle)
    args = [torch.from_numpy(a).requires_grad_() for a in _stack_args(rng)]
    tgt = torch.from_numpy(rng.randn(B, T, C).astype(np.float32))
    dil = tuple(2 ** (i % cycle) for i in range(L))

    def stack_reference(*a):
        return tdt.diffnet_train_stack_fwd_plain(*a, dilations=dil, save_xs=False)[0]

    out = stack_reference(*args)
    want = torch.autograd.grad(((out - tgt) ** 2).sum(), args)
    _, xs = tdt.diffnet_train_stack_fwd_plain(*[a.detach() for a in args], dilations=dil)
    got = tdt.diffnet_train_stack_bwd_plain(xs, *[a.detach() for a in args[1:8]],
                                            2 * (out - tgt).detach(), dilations=dil)
    fn_out = tdt.diffnet_train_stack(*args, dilations=dil)
    via_fn = torch.autograd.grad(((fn_out - tgt) ** 2).sum(), args)
    for name, g, f, w in zip(tdt.GRAD_NAMES, got, via_fn, want):
        _close_scaled(g.numpy(), w.numpy(), name)
        _close_scaled(f.numpy(), w.numpy(), name)


def test_stack_backward_twin_in_float64():
    """``acc_dtype=float64`` runs the backward twin's steps in float64: its
    cotangents are float64, agree with the float32 twin at the f32 gradient
    tolerance, and move with a perturbation of ds (1e-10 relative) that
    float32 cannot resolve."""
    rng = np.random.RandomState(31)
    args = [torch.from_numpy(a).double() for a in _stack_args(rng)]
    ds = torch.from_numpy(rng.randn(B, T, C))
    dil = tuple(2 ** (i % 2) for i in range(L))
    _, xs = tdt.diffnet_train_stack_fwd_plain(*[a.float() for a in args], dilations=dil)
    g32 = tdt.diffnet_train_stack_bwd_plain(xs, *[a.float() for a in args[1:8]], ds.float(),
                                            dilations=dil)
    g64 = tdt.diffnet_train_stack_bwd_plain(xs.double(), *args[1:8], ds, dilations=dil,
                                            acc_dtype=torch.float64)
    moved = tdt.diffnet_train_stack_bwd_plain(xs.double(), *args[1:8], ds * (1 + 1e-10),
                                              dilations=dil, acc_dtype=torch.float64)
    for name, a, w, m in zip(tdt.GRAD_NAMES, g32, g64, moved):
        assert w.dtype == torch.float64, name
        _close_scaled(a.numpy(), w.numpy(), name)
        assert not torch.equal(m, w), name


def _nets(rng, cycle=2, num_layers=L, c=C, m=8, h=H, b=B, t=40):
    jnet = JDiffNet(in_dims=m, encoder_hidden=h, residual_layers=num_layers,
                    residual_channels=c, dilation_cycle_length=cycle)
    spec = rng.randn(b, t, m).astype(np.float32)
    steps = np.array([3, 17][:b], np.int32)
    cond = rng.randn(b, t, h).astype(np.float32)
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(spec), jnp.asarray(steps),
                       jnp.asarray(cond))["params"]
    params = dict(params)  # a nonzero output projection, so the stack gets gradients
    params["output_projection"] = {
        "kernel": jnp.asarray(rng.randn(1, c, m).astype(np.float32) * 0.2),
        "bias": jnp.asarray(rng.randn(m).astype(np.float32) * 0.1)}
    tnet = DiffNet(in_dims=m, encoder_hidden=h, residual_layers=num_layers,
                   residual_channels=c, dilation_cycle_length=cycle)
    tnet.load_state_dict(denoiser_state_dict(params), strict=True)
    tgt = rng.randn(b, t, m).astype(np.float32)
    dil = tuple(2 ** (i % cycle) for i in range(num_layers))
    return jnet, params, tnet, spec, steps, cond, tgt, dil


@pytest.fixture(scope="module")
def jax_diffnet_grads():
    """Loss value and gradients (params, cond) of JAX's module path and of
    JAX's fused training path on the same weights."""
    rng = np.random.RandomState(1)
    jnet, params, tnet, spec, steps, cond, tgt, dil = _nets(rng)
    s, st, tg = jnp.asarray(spec), jnp.asarray(steps), jnp.asarray(tgt)

    def loss_mod(p, cd):
        return jnp.sum((jnet.apply({"params": p}, s, st, cd) - tg) ** 2)

    def loss_pal(p, cd):
        out = jdt.diffnet_train_forward(p, s, st, cd, dilations=dil, interpret=True)
        return jnp.sum((out - tg) ** 2)

    out = {name: jax.value_and_grad(f, argnums=(0, 1))(params, jnp.asarray(cond))
           for name, f in (("module", loss_mod), ("pallas", loss_pal))}
    return out, tnet, spec, steps, cond, tgt


def _torch_loss_grads(tnet, fwd, spec, steps, cond, tgt):
    cond_t = torch.from_numpy(cond).requires_grad_()
    out = fwd(torch.from_numpy(spec), torch.from_numpy(steps).long(), cond_t)
    loss = ((out - torch.from_numpy(tgt)) ** 2).sum()
    names, params = zip(*tnet.named_parameters())
    grads = torch.autograd.grad(loss, list(params) + [cond_t])
    return loss.item(), dict(zip(names, grads[:-1])), grads[-1]


@pytest.mark.parametrize("path", ["train_forward", "module"])
@pytest.mark.parametrize("jax_path", ["module", "pallas"])
def test_diffnet_grads_match_jax(jax_diffnet_grads, path, jax_path):
    """``diffnet_train_forward`` (the port's fused training path) and the
    port's per-layer ``DiffNet.forward`` against JAX's ``DiffNet.apply`` and
    JAX's ``diffnet_train_forward``: value, every parameter gradient (mapped
    through from_jax) and the cond gradient."""
    out, tnet, spec, steps, cond, tgt = jax_diffnet_grads
    (v_j, (g_j, gc_j)) = out[jax_path]
    fwd = (tnet if path == "module" else
           lambda s, t, c: tdt.diffnet_train_forward(tnet, s, t, c))
    v_t, g_t, gc_t = _torch_loss_grads(tnet, fwd, spec, steps, cond, tgt)
    np.testing.assert_allclose(v_t, float(v_j), rtol=1e-5)
    _close_scaled(gc_t.numpy(), np.asarray(gc_j), "cond")
    want = denoiser_state_dict(g_j)
    assert set(want) == set(g_t)
    for name, w in want.items():
        _close_scaled(g_t[name].numpy(), w.numpy(), name)


def test_train_forward_bf16_tracks_jax_bf16():
    """The bf16 training path against JAX's bf16 fused path (bf16 saves)."""
    rng = np.random.RandomState(2)
    _, params, tnet, spec, steps, cond, tgt, dil = _nets(rng)
    s, st, tg = jnp.asarray(spec), jnp.asarray(steps), jnp.asarray(tgt)

    def loss_pal(p, cd):
        out = jdt.diffnet_train_forward(p, s, st, cd, dilations=dil, interpret=True,
                                        compute_dtype=jnp.bfloat16,
                                        save_dtype=jnp.bfloat16)
        return jnp.sum((out - tg) ** 2)

    v_j, (g_j, gc_j) = jax.value_and_grad(loss_pal, argnums=(0, 1))(params, jnp.asarray(cond))
    v_t, g_t, gc_t = _torch_loss_grads(
        tnet, lambda a, b, c: tdt.diffnet_train_forward(tnet, a, b, c,
                                                        compute_dtype=torch.bfloat16),
        spec, steps, cond, tgt)
    np.testing.assert_allclose(v_t, float(v_j), rtol=1e-4)
    _close_bf16(gc_t.numpy(), np.asarray(gc_j), "cond")
    for name, w in denoiser_state_dict(g_j).items():
        _close_bf16(g_t[name].numpy(), w.numpy(), name)


def test_no_grad_forward_saves_no_xs(monkeypatch):
    """Under torch.no_grad() (or with no input needing a gradient) the
    forward is asked for no xs; with gradients it saves them."""
    calls = []
    fwd = tdt.diffnet_train_fwd

    def spy(*a, **kw):
        skips, xs = fwd(*a, **kw)
        calls.append(xs is not None)
        return skips, xs

    monkeypatch.setattr(tdt, "diffnet_train_fwd", spy)
    rng = np.random.RandomState(3)
    _, _, tnet, spec, steps, cond, _, _ = _nets(rng)
    args = (torch.from_numpy(spec), torch.from_numpy(steps).long(), torch.from_numpy(cond))
    with torch.no_grad():
        out_ng = tdt.diffnet_train_forward(tnet, *args)
    out = tdt.diffnet_train_forward(tnet, *args)
    assert calls == [False, True]
    assert out.requires_grad and not out_ng.requires_grad
    torch.testing.assert_close(out.detach(), out_ng, rtol=0, atol=0)


def test_train_wrappers_take_the_twins_on_cpu_and_count_nothing():
    rng = np.random.RandomState(4)
    args = [torch.from_numpy(a) for a in _stack_args(rng)]
    dil = (1, 2, 1, 2)
    n_fwd, n_bwd = tdt.diffnet_train_fwd.launches, tdt.diffnet_train_bwd.launches
    skips, xs = tdt.diffnet_train_fwd(*args, dilations=dil)
    want_skips, want_xs = tdt.diffnet_train_stack_fwd_plain(*args, dilations=dil)
    torch.testing.assert_close(skips, want_skips, rtol=0, atol=0)
    torch.testing.assert_close(xs, want_xs, rtol=0, atol=0)
    ds = torch.ones_like(skips)
    got = tdt.diffnet_train_bwd(xs, *args[1:8], ds, dilations=dil)
    want = tdt.diffnet_train_stack_bwd_plain(xs, *args[1:8], ds, dilations=dil)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert (tdt.diffnet_train_fwd.launches, tdt.diffnet_train_bwd.launches) == (n_fwd, n_bwd)
    with pytest.raises(ValueError, match="one dilation per layer"):
        tdt.diffnet_train_fwd(*args, dilations=(1, 2))
