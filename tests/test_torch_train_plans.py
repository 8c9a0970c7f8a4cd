"""The redesigned training kernels' schedule and dispatch rule, on the CPU.

The tensor-core kernels of ``csrc/diffnet_train.cu`` run only on the card, so
nothing here executes them: the tests are a PyTorch model of their schedule,
held against the plain twins of ``ops/diffnet_train.py``. They show that the
schedule computes the twins' function; the CUDA code itself is held against
the twins on the card by ``chip_smoke.py``. The schedule:
  * the forward walks each layer row block by row block (a block is ``tm``
    frames of one batch row, never two), builds ``y`` with its dilation halo
    from the read-only input buffer (zero outside ``[0, T)``), and writes the
    other buffer;
  * the backward runs its four kernels a layer: ``dg`` before the recompute,
    ``dconv`` stored in bf16 with the bias sums taken from the unrounded
    float32 values, ``dy`` and ``dcond`` from one ``dconv`` tile with its halo,
    weight gradients by slabs of whole batch rows, and every cross-block sum
    from per-block or per-slab partials added in the kernels' fixed order.
Every buffer a kernel does not fully write is filled with NaN first (before
every layer for the per-layer scratch), so a stale or unwritten row that
reaches a kept value shows as NaN.

Tolerances. float32: the same products summed in another order (tile-sized
matmuls, slab partials) -> 1e-4 of each tensor's scale. bfloat16: both sides
round at the same points, but a float32 sum in another order can round y, g,
dout or dconv one bf16 step (2^-8) apart and carry it through later layers, so
no tensor is bit-equal by construction -> 1e-2 of each tensor's scale, the
tolerance the card's check uses.
"""

import numpy as np
import pytest
import torch

from diffsinger_tpu_torch.ops import diffnet_train as tdt
from diffsinger_tpu_torch.ops.diffnet_stack import SQRT_HALF

torch.set_num_threads(1)
F32 = torch.float32
NAN = float("nan")


def _inputs(seed, b, t, c, h, num_layers):
    rng = np.random.RandomState(seed)

    def f(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))

    args = (torch.relu(f(b, t, c)), f(num_layers, b, c, scale=0.5), f(b, t, h),
            f(num_layers, h, 2 * c, scale=h ** -0.5), f(num_layers, 2 * c, scale=0.1),
            f(num_layers, 3, c, 2 * c, scale=(3 * c) ** -0.5), f(num_layers, 2 * c, scale=0.1),
            f(num_layers, c, 2 * c, scale=c ** -0.5), f(num_layers, 2 * c, scale=0.1))
    return args, f(b, t, c)


def _halo_tile(src, t0, d, tm):
    """Rows t0 - d .. t0 + tm + d of one batch row ``src`` [T, W], zero outside
    [0, T), as the kernels stage a tile with its dilation halo."""
    t_len = src.shape[0]
    tile = torch.zeros(tm + 2 * d, src.shape[1])
    for q in range(tm + 2 * d):
        t = t0 - d + q
        if 0 <= t < t_len:
            tile[q] = src[t]
    return tile


def _conv_rows(ytile, cond_rows, w, kc, bias, d, n):
    """The block's n rows of the conv + cond product; tap k starts k*d rows
    into the y tile."""
    return (ytile[0:n] @ w[0] + ytile[d:d + n] @ w[1] + ytile[2 * d:2 * d + n] @ w[2]
            + cond_rows @ kc + bias)


def emulate_fwd(x0, step, cond, k_cond, b_cond, w_dil, b_dil, w_out, b_out, *, dilations,
                compute_dtype, tm, save_xs=True):
    rnd = tdt._rounder(compute_dtype)
    num_layers, (b, t, c) = w_dil.shape[0], x0.shape
    condc = rnd(cond)
    x_in = x0.to(F32)                      # layer 0 reads the caller's x0
    bufs = [torch.full_like(x_in, NAN), torch.full_like(x_in, NAN)]
    skip = torch.full_like(x_in, NAN)      # layer 0 writes it without reading
    xs = torch.full((num_layers, b, t, c), NAN).to(compute_dtype or F32) if save_xs else None
    if save_xs:
        xs[0] = x_in.to(xs.dtype)
    for l, d in enumerate(dilations):
        x_out = bufs[l % 2]
        x_out.fill_(NAN)
        w, kc, wo = rnd(w_dil[l]), rnd(k_cond[l]), rnd(w_out[l])
        for bi in range(b):
            for t0 in range(0, t, tm):
                n = min(tm, t - t0)
                ytile = _halo_tile(rnd(x_in[bi] + step[l, bi]), t0, d, tm)
                conv = _conv_rows(ytile, condc[bi, t0:t0 + n], w, kc, b_dil[l] + b_cond[l], d, n)
                g = rnd(torch.sigmoid(conv[:, :c]) * torch.tanh(conv[:, c:]))
                out = g @ wo + b_out[l]
                xn = (x_in[bi, t0:t0 + n] + out[:, :c]) * SQRT_HALF
                x_out[bi, t0:t0 + n] = xn
                skip[bi, t0:t0 + n] = out[:, c:] if l == 0 else skip[bi, t0:t0 + n] + out[:, c:]
                if save_xs and l + 1 < num_layers:
                    xs[l + 1, bi, t0:t0 + n] = xn.to(xs.dtype)
        x_in = x_out
    return skip, xs


def _lane_sum(parts):
    """Sum of ``parts`` [n, W] over n as the reducing kernel does it: lane q of
    8 adds rows q, q + 8, ..., then the lanes are added in order."""
    lanes = []
    for q in range(8):
        s = torch.zeros(parts.shape[1])
        for i in range(q, parts.shape[0], 8):
            s = s + parts[i]
        lanes.append(s)
    total = torch.zeros(parts.shape[1])
    for s in lanes:
        total = total + s
    return total


def emulate_bwd(xs, step, cond, k_cond, b_cond, w_dil, b_dil, w_out, ds, *, dilations,
                compute_dtype, tm, nslab):
    rnd = tdt._rounder(compute_dtype)
    store = compute_dtype or F32           # type of the per-layer scratch tensors
    num_layers, b, t, c = xs.shape
    h = cond.shape[-1]
    condc, dsc = rnd(cond), rnd(ds)
    n_tile = -(-t // tm)
    rows_per_slab = -(-b // nslab)
    dx, dcond = torch.zeros(b, t, c), torch.zeros(b, t, h)
    out = {k: [None] * num_layers for k in ("dstep", "dk", "db", "dwd", "dwo", "dbo")}
    for l in reversed(range(num_layers)):
        d = dilations[l]
        w, kc, wo = rnd(w_dil[l]), rnd(k_cond[l]), rnd(w_out[l])
        # per-layer scratch: nothing of the layer above may be read
        ybuf, gbuf = torch.full((b, t, c), NAN), torch.full((b, t, c), NAN)
        dconv, dxh = torch.full((b, t, 2 * c), NAN), torch.full((b, t, c), NAN)
        bias_part = torch.full((2, b * n_tile, 2 * c), NAN)
        dstep_part = torch.full((b, n_tile, c), NAN)
        # kernel 1: dg first, then the recompute and the gate derivatives
        for bi in range(b):
            for ti, t0 in enumerate(range(0, t, tm)):
                n = min(tm, t - t0)
                dout = torch.cat([dx[bi, t0:t0 + n] * SQRT_HALF, dsc[bi, t0:t0 + n]], dim=-1)
                bias_part[1, bi * n_tile + ti] = dout.sum(0)          # unrounded
                doutc = rnd(dout)
                dxh[bi, t0:t0 + n] = doutc[:, :c]
                dg = doutc @ wo.t()
                ytile = _halo_tile(rnd(xs[l, bi].to(F32) + step[l, bi]), t0, d, tm)
                ybuf[bi, t0:t0 + n] = ytile[d:d + n]
                conv = _conv_rows(ytile, condc[bi, t0:t0 + n], w, kc, b_dil[l] + b_cond[l], d, n)
                sg, tf = torch.sigmoid(conv[:, :c]), torch.tanh(conv[:, c:])
                gbuf[bi, t0:t0 + n] = rnd(sg * tf)
                dc = torch.cat([dg * tf * sg * (1.0 - sg), dg * sg * (1.0 - tf * tf)], dim=-1)
                bias_part[0, bi * n_tile + ti] = dc.sum(0)            # before rounding
                dconv[bi, t0:t0 + n] = dc.to(store).to(F32)
        # kernel 2: dy and dcond from one dconv tile with its halo
        for bi in range(b):
            for ti, t0 in enumerate(range(0, t, tm)):
                n = min(tm, t - t0)
                tile = _halo_tile(dconv[bi], t0, d, tm)
                dy = (tile[2 * d:2 * d + n] @ w[0].t() + tile[d:d + n] @ w[1].t()
                      + tile[0:n] @ w[2].t())
                dstep_part[bi, ti] = dy.sum(0)
                dx[bi, t0:t0 + n] = dx[bi, t0:t0 + n] * SQRT_HALF + dy
                dcond[bi, t0:t0 + n] += tile[d:d + n] @ kc.t()
        # kernel 3: weight gradients by slabs of whole batch rows; a tap is a
        # row offset of the copy, zero outside [0, T) of the same batch row
        m_all = 4 * c + h
        part = torch.full((nslab, m_all, 2 * c), NAN)
        for s in range(-(-b // rows_per_slab)):
            acc = torch.zeros(m_all, 2 * c)
            for bi in range(s * rows_per_slab, min(b, (s + 1) * rows_per_slab)):
                shifted = [_halo_tile(ybuf[bi], 0, d, t)[k * d:k * d + t] for k in range(3)]
                a = torch.cat(shifted + [condc[bi]], dim=-1)          # [T, 3C + H]
                acc[:3 * c + h] += a.t() @ dconv[bi]
                acc[3 * c + h:] += gbuf[bi].t() @ torch.cat([dxh[bi], dsc[bi]], dim=-1)
            part[s] = acc
        # kernel 4: every cross-block sum in a fixed order
        total = part[0].clone()
        for s in range(1, -(-b // rows_per_slab)):
            total = total + part[s]
        out["dwd"][l] = total[:3 * c].reshape(3, c, 2 * c)
        out["dk"][l] = total[3 * c:3 * c + h]
        out["dwo"][l] = total[3 * c + h:]
        out["db"][l] = _lane_sum(bias_part[0])
        out["dbo"][l] = _lane_sum(bias_part[1])
        out["dstep"][l] = torch.stack([_lane_sum(dstep_part[bi]) for bi in range(b)])
    st = {k: torch.stack(v) for k, v in out.items()}
    return (dx, st["dstep"], dcond, st["dk"], st["db"], st["dwd"], st["db"].clone(),
            st["dwo"], st["dbo"])


def _assert_close(got, want, rel, name):
    assert got.shape == want.shape, name
    got, want = got.to(F32), want.to(F32)
    assert torch.isfinite(got).all(), f"{name}: a NaN (unwritten row) reached a kept value"
    scale = max(float(want.abs().max()), 1.0)
    err = float((got - want).abs().max())
    assert err <= rel * scale, (name, err, rel * scale)


CASES = [
    # (B, T, C, H, layers, cycle, row block, slabs)
    pytest.param(2, 32, 16, 12, 4, 1, 8, 2, id="cycle1"),
    pytest.param(3, 40, 16, 16, 5, 4, 8, 2, id="cycle4-ragged-slab"),
    pytest.param(2, 5, 16, 16, 4, 4, 8, 2, id="T-below-largest-dilation"),
    pytest.param(3, 301, 8, 200, 4, 4, 64, 3, id="T301-H200"),
    pytest.param(1, 70, 16, 16, 3, 2, 64, 1, id="one-batch-row-one-slab"),
]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t,c,h,num_layers,cycle,tm,nslab", CASES)
def test_block_schedule_equals_the_plain_twins(b, t, c, h, num_layers, cycle, tm, nslab, bf16):
    args, ds = _inputs(b * 1000 + t, b, t, c, h, num_layers)
    dt = torch.bfloat16 if bf16 else None
    rel = 1e-2 if bf16 else 1e-4
    kw = dict(dilations=tuple(2 ** (i % cycle) for i in range(num_layers)), compute_dtype=dt)
    want_skips, want_xs = tdt.diffnet_train_stack_fwd_plain(*args, **kw)
    skips, xs = emulate_fwd(*args, tm=tm, **kw)
    _assert_close(skips, want_skips, rel, "skips")
    _assert_close(xs, want_xs, rel, "xs")
    assert xs.dtype == want_xs.dtype
    # both backwards read the same saved inputs, so this holds the backward alone
    want = tdt.diffnet_train_stack_bwd_plain(want_xs, *args[1:8], ds, **kw)
    got = emulate_bwd(want_xs, *args[1:8], ds, tm=tm, nslab=nslab, **kw)
    for name, g, w in zip(tdt.GRAD_NAMES, got, want):
        _assert_close(g, w, rel, name)


def test_forward_without_saves_is_the_same_skip_sum():
    args, _ = _inputs(7, 2, 20, 16, 16, 3)
    kw = dict(dilations=(1, 2, 4), compute_dtype=torch.bfloat16, tm=8)
    with_xs, xs = emulate_fwd(*args, **kw)
    without, none = emulate_fwd(*args, save_xs=False, **kw)
    assert none is None and xs is not None
    torch.testing.assert_close(without, with_xs, rtol=0, atol=0)


def test_a_stale_row_shows_as_nan():
    """The NaN fill is a real check: a halo that reads one row too many of the
    buffer being written makes the emulation fail."""
    buf = torch.full((4, 2), NAN)
    buf[:3] = 1.0
    assert torch.isfinite(_halo_tile(buf[:3], 0, 1, 3)).all()
    assert not torch.isfinite(_halo_tile(buf, 0, 1, 4)).all()


def test_bias_sums_come_from_the_unrounded_values():
    """In the layer the backward visits first no bf16 rounding has yet been
    carried on, so db_dil differs from the twin only by the order of a float32
    sum; a sum of the bf16-rounded dconv would be about 2^-9 of it away."""
    args, ds = _inputs(11, 2, 64, 16, 16, 2)
    kw = dict(dilations=(1, 1), compute_dtype=torch.bfloat16)
    _, xs = tdt.diffnet_train_stack_fwd_plain(*args, **kw)
    want = tdt.diffnet_train_stack_bwd_plain(xs, *args[1:8], ds, **kw)
    got = emulate_bwd(xs, *args[1:8], ds, tm=8, nslab=2, **kw)
    db = tdt.GRAD_NAMES.index("b_dil")
    scale = max(float(want[db][-1].abs().max()), 1.0)
    assert float((got[db][-1] - want[db][-1]).abs().max()) <= 1e-5 * scale
    assert torch.equal(got[db], got[tdt.GRAD_NAMES.index("b_cond")])


# ---------------------------------------------------------- the dispatch rule
# Tile sizes, shared memory and the slab count live in the CUDA source alone
# (a static_assert there holds the tiles to 227 KB at the largest dilation the
# rule admits; the card's check reads the library's own account of them).
@pytest.mark.parametrize("d", [1, 2, 4, 8, 16])
def test_dilations_up_to_16_take_the_tensor_cores(d):
    assert tdt.takes_tensor_cores(256, 256, (1, d), torch.bfloat16)


def test_shipped_training_shape_takes_the_tensor_cores():
    assert tdt.takes_tensor_cores(256, 256, (1,) * 20, torch.bfloat16)
    assert tdt.takes_tensor_cores(256, 256, tuple(2 ** (i % 4) for i in range(20)),
                                  torch.bfloat16)


@pytest.mark.parametrize("c,h,dil,dt", [
    (256, 256, (1,) * 20, None),                 # float32
    (256, 256, (1,) * 20, torch.float16),
    (256, 200, (1, 2, 4, 8), torch.bfloat16),    # a width not built for
    (128, 128, (1, 2), torch.bfloat16),
    (256, 256, (1, 17), torch.bfloat16),         # the halo does not fit
    (256, 256, (32, 1), torch.bfloat16),
], ids=["f32", "f16", "H200", "C128", "d17", "d32"])
def test_other_shapes_go_to_the_simt_kernels(c, h, dil, dt):
    assert not tdt.takes_tensor_cores(c, h, dil, dt)


@pytest.mark.parametrize("b,nslab", [(1, 1), (2, 2), (3, 3), (4, 3), (5, 3), (7, 3), (24, 3)])
def test_any_split_into_whole_batch_row_slabs_gives_the_same_gradients(b, nslab):
    """The weight gradients' slab count is the library's choice: the emulation
    gives the twin's gradients for one slab and for the split asked for, with
    no slab left empty and no batch row left out (a NaN would show)."""
    args, ds = _inputs(b, b, 9, 8, 8, 2)
    kw = dict(dilations=(1, 2), compute_dtype=None)
    _, xs = tdt.diffnet_train_stack_fwd_plain(*args, **kw)
    want = tdt.diffnet_train_stack_bwd_plain(xs, *args[1:8], ds, **kw)
    for n in (1, nslab):
        got = emulate_bwd(xs, *args[1:8], ds, tm=8, nslab=n, **kw)
        for name, g, w in zip(tdt.GRAD_NAMES, got, want):
            _assert_close(g, w, 1e-4, name)


def test_cpu_call_takes_the_twin_whatever_the_rule_says():
    args, ds = _inputs(3, 1, 8, 256, 256, 1)
    kw = dict(dilations=(1,), compute_dtype=torch.bfloat16)
    assert tdt.takes_tensor_cores(256, 256, (1,), torch.bfloat16)
    n = tdt.diffnet_train_fwd.launches, tdt.diffnet_train_bwd.launches
    skips, xs = tdt.diffnet_train_fwd(*args, **kw)
    want_skips, _ = tdt.diffnet_train_stack_fwd_plain(*args, **kw)
    torch.testing.assert_close(skips, want_skips, rtol=0, atol=0)
    tdt.diffnet_train_bwd(xs, *args[1:8], ds, **kw)
    assert (tdt.diffnet_train_fwd.launches, tdt.diffnet_train_bwd.launches) == n
    assert tdt.diffnet_train_fwd.device_launches is None   # nothing ran on a card
