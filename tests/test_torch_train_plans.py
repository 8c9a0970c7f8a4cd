"""The redesigned training kernels' schedule and dispatch rule, on the CPU.

The tensor-core kernels of ``csrc/diffnet_train.cu`` run only on the card, so
nothing here executes them: the tests are a PyTorch model of their schedule,
held against the plain twins of ``ops/diffnet_train.py`` (and, for the
float32 body, against the JAX package's Pallas kernels in interpret mode).
They show that the schedule computes the twins' function; the CUDA code
itself is held against the twins on the card by ``chip_smoke.py``. The
bfloat16 schedule:
  * the forward walks each layer row block by row block (a block is ``tm``
    frames of one batch row, never two), builds ``y`` with its dilation halo
    from the read-only input buffer (zero outside ``[0, T)``), and writes the
    other buffer;
  * the backward runs its four kernels a layer: ``dg`` before the recompute,
    ``dconv`` stored in bf16 with the bias sums taken from the unrounded
    float32 values, ``dy`` and ``dcond`` from one ``dconv`` tile with its halo,
    weight gradients by slabs of whole batch rows, and every cross-block sum
    from per-block or per-slab partials added in the kernels' fixed order.
The float32 schedule (``emulate_fwd32`` / ``emulate_bwd32``) has the same
blocks, launches and sums, with what the float32 kernels change: every
product in 3xTF32 (each operand cut as ``split_tf32`` cuts it, ``& 0xffffe000``,
then the remainder cut the same way; ``a_lo b_hi + a_hi b_lo + a_hi b_hi``);
one shared tile a block, into which the forward stages cond (its product
first), then y with its halo, then g, the gate kernel a dout half at a time,
then cond, then y, and the dx kernel dconv one half of its columns at a time;
dg parked in device memory and read back by the block that wrote it; the
backward's scratch (y, g, dconv, dout's dx half) in float32; blocks in a
shuffled order.
Every buffer a kernel does not fully write is filled with NaN first (before
every layer for the per-layer scratch, every block's shared tile before the
block), so a stale or unwritten row that reaches a kept value shows as NaN.

Tolerances. float32: the same products summed in another order (tile-sized
matmuls, slab partials) -> 1e-4 of each tensor's scale; 3xTF32 keeps each
product to ~2^-21. bfloat16: both sides
round at the same points, but a float32 sum in another order can round y, g,
dout or dconv one bf16 step (2^-8) apart and carry it through later layers, so
no tensor is bit-equal by construction -> 1e-2 of each tensor's scale, the
tolerance the card's check uses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.ops import diffnet_train as jdt
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


# ------------------------------------------------------- the float32 schedule
PAD = 4   # NaN rows past T in every device buffer of the float32 model


def _cut_tf32(a):
    """Sign, exponent and the top 10 mantissa bits (``split_tf32``'s mask)."""
    return (a.contiguous().view(torch.int32) & -8192).view(F32)


def _mm3(passes=3):
    """The kernels' product: both operands split into tf32 hi and lo,
    ``a_lo b_hi + a_hi b_lo + a_hi b_hi`` in float32 (``passes=1``: a_hi b_hi
    alone, one TF32 pass)."""
    def mm(a, w):
        a_hi, w_hi = _cut_tf32(a), _cut_tf32(w)
        if passes == 1:
            return a_hi @ w_hi
        a_lo, w_lo = _cut_tf32(a - a_hi), _cut_tf32(w - w_hi)
        return (a_lo @ w_hi + a_hi @ w_lo) + a_hi @ w_hi
    return mm


def _device(a, t):
    """A [.., T, W] tensor as a device buffer: NaN rows past T."""
    out = torch.full(a.shape[:-2] + (t + PAD, a.shape[-1]), NAN)
    out[..., :t, :] = a
    return out


def _stage(tile, src, t0, d, tm, width):
    """Frames t0 - d .. t0 + tm + d of one batch row of a device buffer into
    the first tm + 2d rows and ``width`` columns of the block's tile, zero
    outside [0, T) (T = src rows - PAD): only rows below T are read."""
    t_len = src.shape[0] - PAD
    ts = torch.arange(t0 - d, t0 + tm + d)
    inside = (ts >= 0) & (ts < t_len)
    tile[:tm + 2 * d, :width] = 0.0
    tile[:tm + 2 * d, :width][inside] = src[ts[inside], :width]


def _blocks(b, t, tm, order):
    blocks = [(bi, ti, t0) for bi in range(b) for ti, t0 in enumerate(range(0, t, tm))]
    return [blocks[i] for i in order.permutation(len(blocks))]


def _seq_sum(rows):
    """Sum over rows in order, as a thread of the gate kernel sums a column."""
    total = torch.zeros(rows.shape[1])
    for r in rows:
        total = total + r
    return total


def emulate_fwd32(x0, step, cond, k_cond, b_cond, w_dil, b_dil, w_out, b_out, *, dilations,
                  tm, save_xs=True, passes=3, seed=0):
    """``fwd_layer_tc32``'s schedule. Returns (skips, xs or None)."""
    mm = _mm3(passes)
    num_layers, (b, t, c), h = w_dil.shape[0], x0.shape, cond.shape[-1]
    width = max(c, h)
    cond_dev = _device(cond, t)
    x_in = _device(x0, t)                  # layer 0 reads the caller's x0
    bufs = [torch.full((b, t + PAD, c), NAN), torch.full((b, t + PAD, c), NAN)]
    skip = torch.full((b, t + PAD, c), NAN)    # layer 0 writes it without reading
    xs = torch.full((num_layers, b, t + PAD, c), NAN) if save_xs else None
    if save_xs:
        xs[0, :, :t] = x0                  # the wrapper's copy
    order = np.random.RandomState(seed)
    for l, d in enumerate(dilations):
        x_out = bufs[l % 2]
        for bi, _, t0 in _blocks(b, t, tm, order):
            tile = torch.full((tm + 2 * d, width), NAN)   # the block's shared memory
            rows = torch.arange(t0, t0 + tm)
            live = rows < t
            # cond first (an input of the call): its product before the wait
            _stage(tile, cond_dev[bi], t0, 0, tm, h)
            acc = mm(tile[:tm, :h], k_cond[l])
            # then y with its halo over the same space
            _stage(tile, x_in[bi], t0, d, tm, c)
            ts = torch.arange(t0 - d, t0 + tm + d)
            inside = (ts >= 0) & (ts < t)
            tile[:tm + 2 * d, :c][inside] += step[l, bi]
            for k in range(3):
                acc = acc + mm(tile[k * d:k * d + tm, :c], w_dil[l, k])
            pre = acc + b_dil[l] + b_cond[l]
            g = torch.sigmoid(pre[:, :c]) * torch.tanh(pre[:, c:])
            tile[:tm, :c] = torch.where(live[:, None], g, torch.zeros(()))   # g over y
            out = mm(tile[:tm, :c], w_out[l])
            keep = rows[live]
            xn = (x_in[bi, keep] + (out[live, :c] + b_out[l, :c])) * tdt.SQRT_HALF
            x_out[bi, keep] = xn
            sk = out[live, c:] + b_out[l, c:]
            skip[bi, keep] = sk if l == 0 else skip[bi, keep] + sk
            if save_xs and l + 1 < num_layers:
                xs[l + 1, bi, keep] = xn
        x_in = x_out
    return skip[:, :t], (xs[:, :, :t] if save_xs else None)


def emulate_bwd32(xs, step, cond, k_cond, b_cond, w_dil, b_dil, w_out, ds, *, dilations,
                  tm, nslab, passes=3, store=F32, seed=0):
    """The four float32 backward kernels a layer. ``store`` is the type of
    the per-layer scratch (float32 as built; bf16 only to show the
    tolerance needs float32 scratch)."""
    mm = _mm3(passes)
    num_layers, b, t, c = xs.shape
    h = cond.shape[-1]
    width = max(c, h)
    n_tile = -(-t // tm)
    nblk = b * n_tile
    rows_per_slab = -(-b // nslab)
    xs_dev, cond_dev, ds_dev = _device(xs, t), _device(cond, t), _device(ds, t)
    dx, dcond = torch.zeros(b, t + PAD, c), torch.zeros(b, t + PAD, h)
    out = {k: [None] * num_layers for k in ("dstep", "dk", "db", "dwd", "dwo", "dbo")}
    order = np.random.RandomState(seed)

    def kept(v):
        return v.to(store).to(F32)

    for l in reversed(range(num_layers)):
        d = dilations[l]
        # per-layer scratch: nothing of the layer above may be read
        ybuf, gbuf = torch.full((b, t + PAD, c), NAN), torch.full((b, t + PAD, c), NAN)
        dconv = torch.full((b, t + PAD, 2 * c), NAN)
        dxh = torch.full((b, t + PAD, c), NAN)
        dgs = torch.full((nblk, tm, c), NAN)
        bias_part = torch.full((2, nblk, 2 * c), NAN)
        dstep_part = torch.full((b, n_tile, c), NAN)
        # kernel 1: dout a half at a time, dg parked; cond, then y; epilogue
        for bi, ti, t0 in _blocks(b, t, tm, order):
            blk = bi * n_tile + ti
            rows = torch.arange(t0, t0 + tm)
            live = rows < t
            keep = rows[live]
            tile = torch.full((tm + 2 * d, width), NAN)
            dg = torch.zeros(tm, c)
            for hf, src in enumerate((dx[bi] * tdt.SQRT_HALF, ds_dev[bi])):
                _stage(tile, src, t0, 0, tm, c)
                if hf == 0:
                    dxh[bi, keep] = kept(tile[:tm, :c][live])
                bias_part[1, blk, hf * c:(hf + 1) * c] = _seq_sum(tile[:tm, :c])
                dg = dg + mm(tile[:tm, :c], w_out[l][:, hf * c:(hf + 1) * c].t())
            dgs[blk] = dg
            _stage(tile, cond_dev[bi], t0, 0, tm, h)
            acc = mm(tile[:tm, :h], k_cond[l])
            _stage(tile, xs_dev[l, bi], t0, d, tm, c)
            ts = torch.arange(t0 - d, t0 + tm + d)
            inside = (ts >= 0) & (ts < t)
            tile[:tm + 2 * d, :c][inside] += step[l, bi]
            ybuf[bi, keep] = kept(tile[d:d + tm, :c][live])
            for k in range(3):
                acc = acc + mm(tile[k * d:k * d + tm, :c], w_dil[l, k])
            pre = acc + b_dil[l] + b_cond[l]
            sg, tf = torch.sigmoid(pre[:, :c]), torch.tanh(pre[:, c:])
            dgv = dgs[blk]                    # read back by the block that parked it
            dc = torch.cat([dgv * tf * sg * (1.0 - sg), dgv * sg * (1.0 - tf * tf)], dim=-1)
            gbuf[bi, keep] = kept((sg * tf)[live])
            dconv[bi, keep] = kept(dc[live])
            bias_part[0, blk] = dc[live].sum(0)
        # kernel 2: dy and dcond from the dconv tile, one column half at a time
        for bi, ti, t0 in _blocks(b, t, tm, order):
            rows = torch.arange(t0, t0 + tm)
            live = rows < t
            keep = rows[live]
            tile = torch.full((tm + 2 * d, width), NAN)
            accy, accc = torch.zeros(tm, c), torch.zeros(tm, h)
            for hf in range(2):
                cols = slice(hf * c, (hf + 1) * c)
                _stage(tile, dconv[bi, :, cols], t0, d, tm, c)
                # tap k reads dconv[t - (k - 1) d]: it starts (2 - k) d rows in
                for k in range(3):
                    accy = accy + mm(tile[(2 - k) * d:(2 - k) * d + tm, :c], w_dil[l, k][:, cols].t())
                accc = accc + mm(tile[d:d + tm, :c], k_cond[l][:, cols].t())
            dstep_part[bi, ti] = accy[live].sum(0)
            dx[bi, keep] = dx[bi, keep] * tdt.SQRT_HALF + accy[live]
            dcond[bi, keep] = dcond[bi, keep] + accc[live]
        # kernel 3: weight gradients by slabs of whole batch rows; a tap is a
        # row offset of the copy, zero outside [0, T) of the same batch row
        m_all = 4 * c + h
        part = torch.full((nslab, m_all, 2 * c), NAN)
        n_slabs = -(-b // rows_per_slab)
        for s in order.permutation(n_slabs):
            acc = torch.zeros(m_all, 2 * c)
            for bi in range(s * rows_per_slab, min(b, (s + 1) * rows_per_slab)):
                shifted = []
                for k in range(3):
                    tile = torch.zeros(t + 2 * d, c)
                    _stage(tile, ybuf[bi], 0, d, t, c)
                    shifted.append(tile[k * d:k * d + t])
                a = torch.cat(shifted + [cond_dev[bi, :t]], dim=-1)    # [T, 3C + H]
                acc[:3 * c + h] += mm(a.t().contiguous(), dconv[bi, :t])
                acc[3 * c + h:] += mm(gbuf[bi, :t].t().contiguous(),
                                      torch.cat([dxh[bi, :t], ds_dev[bi, :t]], dim=-1))
            part[s] = acc
        # kernel 4: every cross-block sum in a fixed order
        total = part[0].clone()
        for s in range(1, n_slabs):
            total = total + part[s]
        out["dwd"][l] = total[:3 * c].reshape(3, c, 2 * c)
        out["dk"][l] = total[3 * c:3 * c + h]
        out["dwo"][l] = total[3 * c + h:]
        out["db"][l] = _lane_sum(bias_part[0])
        out["dbo"][l] = _lane_sum(bias_part[1])
        out["dstep"][l] = torch.stack([_lane_sum(dstep_part[bi]) for bi in range(b)])
    st = {k: torch.stack(v) for k, v in out.items()}
    return (dx[:, :t], st["dstep"], dcond[:, :t], st["dk"], st["db"], st["dwd"],
            st["db"].clone(), st["dwo"], st["dbo"])


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


@pytest.mark.parametrize("b,t,c,h,num_layers,cycle,tm,nslab", CASES)
def test_float32_schedule_equals_the_plain_twins(b, t, c, h, num_layers, cycle, tm, nslab):
    args, ds = _inputs(b * 1000 + t, b, t, c, h, num_layers)
    kw = dict(dilations=tuple(2 ** (i % cycle) for i in range(num_layers)), compute_dtype=None)
    want_skips, want_xs = tdt.diffnet_train_stack_fwd_plain(*args, **kw)
    skips, xs = emulate_fwd32(*args, dilations=kw["dilations"], tm=tm)
    _assert_close(skips, want_skips, 1e-4, "skips")
    _assert_close(xs, want_xs, 1e-4, "xs")
    # both backwards read the same saved inputs, so this holds the backward alone
    want = tdt.diffnet_train_stack_bwd_plain(want_xs, *args[1:8], ds, **kw)
    got = emulate_bwd32(want_xs, *args[1:8], ds, dilations=kw["dilations"], tm=tm,
                        nslab=nslab)
    for name, g, w in zip(tdt.GRAD_NAMES, got, want):
        _assert_close(g, w, 1e-4, name)


def test_float32_schedule_matches_jax_in_interpret_mode():
    """The float32 model, forward and backward, against JAX's own float32
    training kernels (``_fwd_call`` and ``make_stack_vjp`` with
    ``compute_dtype=None``, Pallas in interpret mode): skips, xs and the nine
    cotangents, at a cycle-4 case with ragged blocks and slabs."""
    b, t, c, h, num_layers, cycle, tm, nslab = 3, 40, 16, 16, 5, 4, 8, 2
    args, ds = _inputs(29, b, t, c, h, num_layers)
    dil = tuple(2 ** (i % cycle) for i in range(num_layers))
    jargs = tuple(jnp.asarray(a.numpy()) for a in args)
    want_skips, want_xs = jdt._fwd_call(*jargs, dil, 1, True, None, jnp.float32)
    _, vjp = jax.vjp(jdt.make_stack_vjp(dil, 1, True, None, jnp.float32), *jargs)
    want = vjp(jnp.asarray(ds.numpy()))
    skips, xs = emulate_fwd32(*args, dilations=dil, tm=tm)
    _assert_close(skips, torch.from_numpy(np.array(want_skips)), 1e-4, "skips")
    _assert_close(xs, torch.from_numpy(np.array(want_xs)), 1e-4, "xs")
    got = emulate_bwd32(xs, *args[1:8], ds, dilations=dil, tm=tm, nslab=nslab)
    for name, g, w in zip(tdt.GRAD_NAMES, got, want):
        _assert_close(g, torch.from_numpy(np.array(w, np.float32)), 1e-4, name)


def test_float32_needs_three_tf32_passes_and_float32_scratch():
    """One TF32 pass, or scratch rounded to bf16, misses the float32
    tolerance the three passes and float32 scratch hold; the split itself
    keeps a value to 2^-20 of it."""
    b, t, c, h, num_layers = 2, 64, 64, 64, 4
    args, ds = _inputs(5, b, t, c, h, num_layers)
    dil = (1, 2, 4, 8)
    kw = dict(dilations=dil, compute_dtype=None)
    want_skips, want_xs = tdt.diffnet_train_stack_fwd_plain(*args, **kw)
    tol = 1e-4 * max(float(want_skips.abs().max()), 1.0)
    three, _ = emulate_fwd32(*args, dilations=dil, tm=16)
    one, _ = emulate_fwd32(*args, dilations=dil, tm=16, save_xs=False, passes=1)
    assert float((three - want_skips).abs().max()) <= tol
    assert float((one - want_skips).abs().max()) > tol
    want = tdt.diffnet_train_stack_bwd_plain(want_xs, *args[1:8], ds, **kw)
    dw = tdt.GRAD_NAMES.index("w_dil")
    wtol = 1e-4 * max(float(want[dw].abs().max()), 1.0)
    for store, holds in ((F32, True), (torch.bfloat16, False)):
        got = emulate_bwd32(want_xs, *args[1:8], ds, dilations=dil, tm=16, nslab=2,
                            store=store)
        assert (float((got[dw] - want[dw]).abs().max()) <= wtol) == holds, store
    a = args[5]
    hi = _cut_tf32(a)
    assert float(((hi + _cut_tf32(a - hi)) - a).abs().max()) <= 2.0 ** -20 * float(a.abs().max())


def test_float32_model_reads_nothing_unwritten():
    """The NaN fill guards the float32 model too: a forward that read the
    buffer it writes (in place would be the kernel's fault) shows NaN."""
    args, _ = _inputs(13, 2, 24, 16, 16, 3)
    skips, _ = emulate_fwd32(*args, dilations=(1, 2, 4), tm=8)
    assert torch.isfinite(skips).all()
    buf = torch.full((24 + PAD, 16), NAN)
    tile = torch.full((8 + 2, 16), NAN)
    _stage(tile, buf, 0, 1, 8, 16)   # rows of an unwritten buffer stay NaN
    assert not torch.isfinite(tile[1:]).any() and torch.equal(tile[0], torch.zeros(16))


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


@pytest.mark.parametrize("dt", [None, torch.float32], ids=["none", "float32"])
@pytest.mark.parametrize("dil", [(1,) * 20, tuple(2 ** (i % 4) for i in range(20)),
                                 (1, 16)], ids=["lj", "cycle4", "d16"])
def test_float32_at_the_shipped_width_takes_the_tensor_cores(dil, dt):
    """ds_beta6.yaml and popcs/ds_beta6.yaml set no compute_dtype: their
    training stack (C = H = 256) is float32 and goes to the 3xTF32 kernels."""
    assert tdt.takes_tensor_cores(256, 256, dil, dt)


@pytest.mark.parametrize("c,h,dil,dt", [
    (256, 256, (1,) * 20, torch.float16),
    (256, 200, (1, 2, 4, 8), torch.bfloat16),    # a width not built for
    (128, 128, (1, 2), torch.bfloat16),
    (256, 256, (1, 17), torch.bfloat16),         # the halo does not fit
    (256, 256, (32, 1), torch.bfloat16),
    (256, 200, (1, 2, 4, 8), None),              # float32 off the built width
    (128, 128, (1, 2), None),
    (256, 256, (1, 17), None),                   # float32 past the halo
], ids=["f16", "H200", "C128", "d17", "d32", "f32-H200", "f32-C128", "f32-d17"])
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
