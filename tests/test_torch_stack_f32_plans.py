"""The float32 tensor-core stack body's schedule and dispatch rule, on the CPU.

``stack_layer_tc32`` in ``csrc/diffnet_stack.cu`` runs only on the card, so
nothing here executes it: the tests are a PyTorch model of its schedule, held
against the plain twin of ``ops/diffnet_stack.py`` and against the JAX
package's ``diffnet_stack`` (its Pallas kernel in interpret mode, as
tests/test_torch_diffnet.py runs it). They show that the schedule computes
the twins' function; the CUDA code itself is held against the twin on the
card by ``chip_smoke.py``. The schedule, a layer at a time:
  * a block owns ``tm`` rows of one batch row (never two) and, in the order
    the card picks (here a seeded shuffle), stages ``y = x_in + step`` for
    its rows with a d-row halo on each side, zero outside ``[0, T)``;
  * the conv GEMM reads each tap as a row offset into that tile; the gate
    adds the bias and the block's cond rows (only rows below T are read) and
    writes ``g`` over ``y``, zero past T;
  * the out GEMM reads ``g``; the epilogue reads x_in and (after layer 0)
    skip for the block's rows below T and writes x_out, the other buffer of
    two (x0 is layer 0's input and is never written), and skip;
  * every product is 3xTF32: each operand cut as ``split_tf32`` cuts it
    (``& 0xffffe000``, then the remainder cut the same way) and
    ``a_lo*b_hi + a_hi*b_lo + a_hi*b_hi`` summed in float32.
Every device buffer is NaN before the call and NaN past row T, so a row a
block must not read (the other buffer, a row past the sequence, skip before
layer 0 wrote it) shows as NaN in the result.

Tolerance: 1e-4 x max(scale, 1), the stack's float32 tolerance (the JAX
package's tests/test_pallas_kernels.py and chip_smoke.py): the same products
to 2^-21 of each, summed in another order, through the layers.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.ops import diffnet_stack as jds
from diffsinger_tpu_torch.ops import diffnet_stack as tds

torch.set_num_threads(1)
NAN = float("nan")
TM = 64
PAD = 8   # NaN rows past T in every device buffer
CU = Path(tds.__file__).resolve().parents[1] / "csrc" / "diffnet_stack.cu"


def _inputs(seed, b, t, c, num_layers):
    rng = np.random.RandomState(seed)

    def f(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))

    return (torch.relu(f(b, t, c)), f(num_layers, b, c, scale=0.5),
            f(num_layers, b, t, 2 * c, scale=0.5), f(num_layers, 3, c, 2 * c, scale=(3 * c) ** -0.5),
            f(num_layers, 2 * c, scale=0.1), f(num_layers, c, 2 * c, scale=c ** -0.5),
            f(num_layers, 2 * c, scale=0.1))


def _cut_tf32(a):
    """Sign, exponent and the top 10 mantissa bits (``split_tf32``'s mask)."""
    return (a.contiguous().view(torch.int32) & -8192).view(torch.float32)


def _mm_tf32(passes):
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


def emulate_stack_tc32(x0, step, cond, w_dil, b_dil, w_out, b_out, *, dilations,
                       tm=TM, passes=3, seed=0, buffers="double"):
    """The block schedule of ``stack_layer_tc32``; returns (skip, x0 buffer).
    ``buffers`` other than "double" are faults, for the tests of the NaN
    guard: "in_place" writes x where it reads it, "same" reads the buffer the
    layer writes."""
    mm = _mm_tf32(passes)
    b, t, c = x0.shape
    x0_dev = _device(x0, t)
    cond_dev = _device(cond, t)
    bufs = [torch.full((b, t + PAD, c), NAN), torch.full((b, t + PAD, c), NAN)]
    skip = torch.full((b, t + PAD, c), NAN)   # layer 0 writes it without reading
    order = np.random.RandomState(seed)
    x_in = x0_dev
    for l, d in enumerate(dilations):
        x_out = bufs[l % 2]
        if buffers == "in_place" and l > 0:
            x_out = x_in
        elif buffers == "same":
            x_in = x_out
        blocks = [(bi, t0) for bi in range(b) for t0 in range(0, t, tm)]
        for i in order.permutation(len(blocks)):
            bi, t0 = blocks[i]
            # y with its halo: tile row q is sequence row t0 - d + q
            ts = torch.arange(t0 - d, t0 + tm + d)
            inside = (ts >= 0) & (ts < t)
            ytile = torch.zeros(tm + 2 * d, c)
            ytile[inside] = x_in[bi, ts[inside]] + step[l, bi]
            conv = (mm(ytile[0:tm], w_dil[l, 0]) + mm(ytile[d:d + tm], w_dil[l, 1])
                    + mm(ytile[2 * d:2 * d + tm], w_dil[l, 2]))
            rows = torch.arange(t0, t0 + tm)
            live = rows < t
            cond_rows = torch.zeros(tm, 2 * c)
            cond_rows[live] = cond_dev[l, bi, rows[live]]
            pre = conv + b_dil[l] + cond_rows
            g = torch.sigmoid(pre[:, :c]) * torch.tanh(pre[:, c:])
            g[~live] = 0.0                     # written over y, zero past T
            out = mm(g, w_out[l])
            keep = rows[live]
            res, sk = out[live, :c] + b_out[l, :c], out[live, c:] + b_out[l, c:]
            x_out[bi, keep] = (x_in[bi, keep] + res) * tds.SQRT_HALF
            skip[bi, keep] = sk if l == 0 else skip[bi, keep] + sk
        x_in = x_out
    return skip[:, :t], x0_dev


def _jax_stack(args, dilations):
    """JAX's diffnet_stack, its Pallas kernel in interpret mode."""
    names = ("x0", "step_proj", "cond_proj", "w_dil", "b_dil", "w_out", "b_out")
    jin = {k: jnp.asarray(a.numpy()) for k, a in zip(names, args)}
    out = jds.diffnet_stack(**jin, dilations=dilations, interpret=True)
    return torch.from_numpy(np.array(out))


@pytest.mark.parametrize("t", [5, 64, 301])
@pytest.mark.parametrize("c", [128, 256])
@pytest.mark.parametrize("cycle", [1, 4])
def test_block_schedule_equals_the_plain_twin_and_jax(cycle, c, t):
    num_layers = 4
    args = _inputs(100 * cycle + t + c, 2, t, c, num_layers)
    dil = tuple(2 ** (i % cycle) for i in range(num_layers))
    got, x0_after = emulate_stack_tc32(*args, dilations=dil)
    want = tds.diffnet_stack_plain(*args, dilations=dil)
    tol = 1e-4 * max(float(want.abs().max()), 1.0)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= tol
    # JAX's kernel and its XLA twin shift by slicing and take no T shorter
    # than a dilation (T = 5 at cycle 4): there the plain twin alone, which
    # tests/test_torch_kernel_plans.py holds to zero outer taps
    if t > max(dil):
        assert float((got - _jax_stack(args, dil)).abs().max()) <= tol
    # the caller's x0 is read, never written
    assert torch.equal(x0_after[:, :t], args[0])


def test_three_tf32_passes_hold_the_float32_tolerance_and_one_pass_does_not():
    num_layers, dil = 4, (1, 2, 4, 8)
    args = _inputs(7, 2, 64, 256, num_layers)
    want = tds.diffnet_stack_plain(*args, dilations=dil)
    tol = 1e-4 * max(float(want.abs().max()), 1.0)
    three, _ = emulate_stack_tc32(*args, dilations=dil, passes=3)
    one, _ = emulate_stack_tc32(*args, dilations=dil, passes=1)
    err3, err1 = float((three - want).abs().max()), float((one - want).abs().max())
    assert err3 <= tol, (err3, tol)
    assert err1 > tol, (err1, tol)
    # the split itself: hi + lo is the value up to 2^-20 of it
    a = args[3]
    hi = _cut_tf32(a)
    lo = _cut_tf32(a - hi)
    assert float(((hi + lo) - a).abs().max()) <= 2.0 ** -20 * float(a.abs().max())


def test_the_schedule_needs_its_double_buffer_and_the_nan_guard_sees_it():
    """Blocks run in any order and read x_in[t +- d]: x updated in place
    gives a wrong result, and a layer reading the buffer it writes reads rows
    nobody wrote, which the NaN fill carries into the skip sum."""
    dil = (1, 2, 4, 8)
    args = _inputs(3, 2, 301, 128, len(dil))
    want = tds.diffnet_stack_plain(*args, dilations=dil)
    tol = 1e-4 * max(float(want.abs().max()), 1.0)
    in_place, _ = emulate_stack_tc32(*args, dilations=dil, buffers="in_place")
    assert float((in_place - want).abs().max()) > tol
    same, _ = emulate_stack_tc32(*args, dilations=dil, buffers="same")
    assert torch.isnan(same).any()


@pytest.mark.parametrize("dt", [None, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", tds.TC_CHANNELS)
def test_dilations_up_to_16_take_the_tensor_cores(c, dt):
    for d in range(1, 17):
        assert tds.takes_tensor_cores(c, (1, d), dt)
        assert tds._body(c, (1, d), dt) == 1
    # the shipped shapes: LJ (cycle 1) and singing (cycle 4) at C = 256
    assert tds.takes_tensor_cores(c, (1,) * 20, dt)
    assert tds.takes_tensor_cores(c, tuple(2 ** (i % 4) for i in range(20)), dt)


@pytest.mark.parametrize("c", tds.TC_CHANNELS)
def test_just_past_the_limit_float32_takes_simt_and_bfloat16_raises(c):
    dil = (1, tds.TC_MAX_DILATION + 1)
    for dt in (None, torch.float32, torch.bfloat16):
        assert not tds.takes_tensor_cores(c, dil, dt)
    assert tds._body(c, dil, None) == 0
    assert tds._body(c, dil, torch.float32) == 0
    with pytest.raises(ValueError, match="bfloat16 kernel takes C"):
        tds._body(c, dil, torch.bfloat16)


@pytest.mark.parametrize("d", [1, 8, 16, 17])
def test_float16_takes_no_body(d):
    assert not tds.takes_tensor_cores(256, (d,), torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tds._body(256, (d,), torch.float16)


@pytest.mark.parametrize("c,dil,dt,body", [
    (64, (1,), None, 0),             # float32 at another width: SIMT
    (96, (1, 2, 4, 8), None, 0),
    (512, (1,), None, 0),
    (64, (1,), torch.bfloat16, None),   # bfloat16 at another width: raises
    (48, (1,), None, None),             # C % 32 != 0: raises
    (256, (0, 1), None, None),          # a dilation below 1: raises
])
def test_other_shapes(c, dil, dt, body):
    if body is None:
        with pytest.raises(ValueError):
            tds._body(c, dil, dt)
    else:
        assert not tds.takes_tensor_cores(c, dil, dt)
        assert tds._body(c, dil, dt) == body


def test_cpu_call_takes_the_twin_whatever_the_rule_says():
    args = _inputs(5, 1, 20, 128, 2)
    before = tds.diffnet_stack.launches
    got = tds.diffnet_stack(*args, dilations=(1, 2))
    want = tds.diffnet_stack_plain(*args, dilations=(1, 2))
    assert torch.equal(got, want)
    assert tds.diffnet_stack.launches == before
    assert tds.diffnet_stack.device_launches is None   # nothing ran on a card


def _cu_constant(name):
    return int(re.search(rf"constexpr (?:int|size_t) {name} = ([0-9* ]+);",
                         CU.read_text()).group(1).replace(" ", "").split("*")[0])


def test_library_limits_match_the_wrapper_rule():
    """The library's widest dilation is the wrapper's, and at it both
    bodies' tiles fit a block's 227 KB at both widths (the .cu's
    static_assert; its smem formulas, copied)."""
    src = CU.read_text()
    assert _cu_constant("MAX_DIL") == tds.TC_MAX_DILATION
    assert "(C == 128 || C == 256)" in src and tds.TC_CHANNELS == (128, 256)
    tm, kc, nst = _cu_constant("TM"), _cu_constant("KC"), _cu_constant("NST")
    kc32, nst32 = _cu_constant("KC32"), _cu_constant("NST32")
    assert tm == TM

    def smem_bf16(c, d):
        return ((tm + 2 * d) * (c + 8) + tm * (c + 8) + 8 * (nst * kc + tm) * (c // 4 + 8)) * 2

    def smem_f32(c, d):
        return ((tm + 2 * d) * (c + 4) + 8 * nst32 * kc32 * (c // 4 + 8)) * 4

    for c in tds.TC_CHANNELS:
        assert smem_bf16(c, tds.TC_MAX_DILATION) <= 227 * 1024
        assert smem_f32(c, tds.TC_MAX_DILATION) <= 227 * 1024
    # the bf16 body at C = 256 would not fit one more halo row pair past 16
    assert smem_bf16(256, tds.TC_MAX_DILATION + 1) > 227 * 1024
