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
                       tm=TM, passes=3, seed=0, buffers="double", split=1, barrier=True):
    """The block schedule of ``stack_layer_tc32``; returns (skip, x0 buffer).
    ``split`` k > 1 runs each tile on a cluster of k blocks, rank j owning
    columns [jC/k, (j+1)C/k) of each half, in a shuffled rank order: each
    stages the whole y tile, computes its g slice and writes it to its own
    shared memory (NaN until written); after the cluster barrier the out GEMM
    of every rank reads all k slices. ``barrier=False`` is a fault: each rank
    runs to its end before the next starts, so the first reads unwritten
    slices. ``buffers`` other than "double" are faults, for the tests of the
    NaN guard: "in_place" writes x where it reads it, "same" reads the buffer
    the layer writes."""
    mm = _mm_tf32(passes)
    b, t, c = x0.shape
    cc = c // split
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
            rows = torch.arange(t0, t0 + tm)
            live = rows < t
            keep = rows[live]
            g_smem = [torch.full((tm, cc), NAN) for _ in range(split)]   # each rank's g slice

            def conv_gate(j):
                # y with its halo, every column: tile row q is sequence row t0 - d + q
                ts = torch.arange(t0 - d, t0 + tm + d)
                inside = (ts >= 0) & (ts < t)
                ytile = torch.zeros(tm + 2 * d, c)
                ytile[inside] = x_in[bi, ts[inside]] + step[l, bi]
                cols = torch.cat([torch.arange(j * cc, (j + 1) * cc),
                                  c + torch.arange(j * cc, (j + 1) * cc)])
                conv = sum(mm(ytile[tap * d:tap * d + tm], w_dil[l, tap][:, cols])
                           for tap in range(3))
                cond_rows = torch.zeros(tm, 2 * cc)
                cond_rows[live] = cond_dev[l, bi][rows[live]][:, cols]
                pre = conv + b_dil[l, cols] + cond_rows
                g = torch.sigmoid(pre[:, :cc]) * torch.tanh(pre[:, cc:])
                g[~live] = 0.0                     # written over y, zero past T
                g_smem[j] = g

            def out_epilogue(j):
                g = torch.cat(g_smem, dim=1)      # the peers' slices, pulled
                own = torch.arange(j * cc, (j + 1) * cc)
                out = mm(g, w_out[l][:, torch.cat([own, c + own])])
                res, sk = out[live, :cc] + b_out[l, own], out[live, cc:] + b_out[l, c + own]
                x_out[bi, keep[:, None], own] = (x_in[bi, keep[:, None], own] + res) * tds.SQRT_HALF
                skip[bi, keep[:, None], own] = sk if l == 0 else skip[bi, keep[:, None], own] + sk

            ranks = order.permutation(split)
            if barrier:
                for j in ranks:
                    conv_gate(j)
                for j in ranks:
                    out_epilogue(j)
            else:
                for j in ranks:
                    conv_gate(j)
                    out_epilogue(j)
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
    (384, (1,), None, 0),
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
    assert tds.diffnet_stack.column_split is None


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


# --------------------------------------------------------------- column split
# (C, split, cycle, T): each split at C = 256, and at C = 512 (split only)
# its two- and four-way column splits, whose wgmma body's stages and ring
# tests/test_torch_stack_wgmma_plans.py models; ids split-cycle-T
CLUSTER_CASES = ([pytest.param(256, k, cycle, t, id=f"{k}-{cycle}-{t}")
                  for t in (5, 301, 1152) for cycle in (1, 4) for k in tds.splits_for(256)]
                 + [pytest.param(512, k, 4, t, id=f"c512-{k}-4-{t}")
                    for t in (5, 97) for k in tds.splits_for(512)])


@pytest.mark.parametrize("c, split, cycle, t", CLUSTER_CASES)
def test_cluster_split_equals_the_plain_twin_and_jax(c, split, cycle, t):
    """k blocks of a cluster share each tile's columns; the result is the
    unsplit function's, every column written once (no NaN left)."""
    num_layers, b = 4, 1 + (split + cycle + t) % 3
    args = _inputs(10 * split + cycle + t, b, t, c, num_layers)
    dil = tuple(2 ** (i % cycle) for i in range(num_layers))
    got, x0_after = emulate_stack_tc32(*args, dilations=dil, split=split, seed=split)
    want = tds.diffnet_stack_plain(*args, dilations=dil)
    tol = 1e-4 * max(float(want.abs().max()), 1.0)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= tol
    if t > max(dil):   # JAX takes no T shorter than a dilation (see above)
        assert float((got - _jax_stack(args, dil)).abs().max()) <= tol
    assert torch.equal(x0_after[:, :t], args[0])


@pytest.mark.parametrize("split", [2, 4])
def test_a_missing_cluster_barrier_shows_as_nan(split):
    """Without the barrier between the ranks' g slices and the out GEMM, a
    rank reads a peer's slice before it is written: the NaN guard sees it."""
    dil = (1, 2)
    args = _inputs(11, 2, 301, 256, len(dil))
    with_barrier, _ = emulate_stack_tc32(*args, dilations=dil, split=split)
    assert torch.isfinite(with_barrier).all()
    without, _ = emulate_stack_tc32(*args, dilations=dil, split=split, barrier=False)
    assert torch.isnan(without).any()


# resident tiles a wave on the H100's 132 SMs: a block an SM unsplit; clusters
# of 2 and 4 as the card's GPCs hold them (the first as read on an H100 80GB
# HBM3; the others what another part of the GPCs' SMs could give)
RESIDENT = [{1: 132, 2: 66, 4: 30}, {1: 132, 2: 64, 4: 32}, {1: 132, 2: 66, 4: 33}]


def _units(b, t, k, resident, c=256):
    return -(-(-(-t // TM) * b) // resident[k]) * (1.0 + tds.SPLIT_COST.get(c, {1: 0.0})[k]) / k


@pytest.mark.parametrize("resident", RESIDENT)
def test_full_waves_keep_the_unsplit_body(resident):
    """8 x 1024 and 16 x 512 (128 tiles) already fill a wave: k = 1."""
    for b, t in ((8, 1024), (16, 512), (2, 4096), (1, 7936)):
        assert tds.column_split(b, t, 256, resident) == 1, (b, t)


@pytest.mark.parametrize("resident", RESIDENT)
def test_a_singing_phrase_at_b1_takes_the_widest_split(resident):
    """B = 1 at the median phrase (1,152 frames, 18 tiles) fills 18 SMs
    unsplit, 72 split four ways."""
    assert tds.column_split(1, 1152, 256, resident) == 4
    assert tds.column_split(1, 256, 256, resident) == 4


def test_the_split_is_capped_by_the_width():
    """A warp keeps whole 8-column tiles: k <= 4 at C = 256; C = 128, whose
    split cost was never measured, stays unsplit whatever the card would
    hold."""
    assert tds.splits_for(256) == (1, 2, 4)
    assert tds.splits_for(128) == (1,)
    many = {1: 132, 2: 66, 4: 33, 8: 16}
    for b in range(1, 17):
        for t in (5, 64, 301, 640, 1152, 2432, 4096):
            assert tds.column_split(b, t, 128, many) == 1
            assert tds.column_split(b, t, 256, many) <= 4


@pytest.mark.parametrize("resident", RESIDENT)
def test_the_chosen_split_never_takes_more_waves_than_unsplit(resident):
    """Against the width's smallest split: unsplit at C <= 256, two-way at
    C = 512, whose body is split only."""
    for b in range(1, 17):
        for t in range(64, 4097, 64):
            for c in tds.TC32_CHANNELS:
                k, k0 = tds.column_split(b, t, c, resident), tds.splits_for(c)[0]
                assert k in tds.splits_for(c)
                assert _units(b, t, k, resident, c) <= _units(b, t, k0, resident, c), (b, t, c, k)
                # the fewest wave-units of the splits the width allows, smaller k on a tie
                best = min(tds.splits_for(c), key=lambda j: (_units(b, t, j, resident, c), j))
                assert k == best


def test_the_measured_split_cost_keeps_one_unsplit_wave(monkeypatch):
    """At 67-90 tiles k = 4 needs three waves of 30 clusters: cheaper than one
    unsplit wave without its fixed cost, dearer with it."""
    card = RESIDENT[0]
    assert tds.column_split(1, 75 * TM, 256, card) == 1
    assert tds.column_split(16, 640, 256, card) == 2      # 160 tiles: 3 waves of 66
    monkeypatch.setattr(tds, "SPLIT_COST", {**tds.SPLIT_COST, 256: {k: 0.0 for k in tds.SPLIT_COST[256]}})
    assert tds.column_split(1, 75 * TM, 256, card) == 4


def test_a_split_the_card_cannot_hold_is_never_taken():
    assert tds.column_split(1, 1152, 256, {1: 132, 2: 66, 4: 0}) == 2
    assert tds.column_split(1, 1152, 256, {1: 132}) == 1


def test_the_wrapper_passes_the_rules_split_and_reads_back_the_librarys(monkeypatch):
    """The CUDA call asks the library for the rule's k on the card's resident
    counts, and ``column_split`` holds what the library reports it ran."""
    seen = {}

    def entry(path, dtype, split, *rest):
        seen.update(path=path, dtype=dtype, split=split)
        report = rest[-1]
        report[0], report[1], report[2] = 2, 1, split
        return 0

    class Stream:
        cuda_stream = 0

    for name in ("device_launches", "ran_tensor_cores", "column_split"):
        monkeypatch.setattr(tds.diffnet_stack, name, None)   # put back after the test
    monkeypatch.setattr(tds, "_entry", lambda: entry)
    monkeypatch.setattr(tds, "_resident", lambda c, dmax, dev: dict(RESIDENT[0]))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    for (b, t), k in (((1, 1152), 4), ((1, 2432), 2), ((8, 1024), 1)):
        args = _inputs(1, b, t, 256, 2)
        tds._launch(*args, (1, 2), None)
        assert seen == {"path": 1, "dtype": 0, "split": k}, (b, t, seen)
        assert tds.diffnet_stack.column_split == k
    # bfloat16 has no split: k = 1 whatever the shape
    args = _inputs(1, 1, 1152, 256, 2)
    tds._launch(*args, (1, 2), torch.bfloat16)
    assert seen["split"] == 1 and seen["dtype"] == 1


def test_library_splits_match_the_wrapper_rule():
    """The library's splits, tile rows and instances are the wrapper's: its
    split_takes names the splits of splits_for, it builds and dispatches an
    instance for each (width, split) pair, C = 512's on the wgmma body and
    no mma.sync instance at C = 512, and every split instance's tiles fit a
    block's 227 KB at the widest dilation it takes (its smem formula,
    copied)."""
    src = CU.read_text()
    assert _cu_constant("TM") == tds.TILE_ROWS
    assert "(dtype == 0 && (C == 128 || C == 256 || C == 512))" in src
    assert "C == 512 ? split == 2 || split == 4" in src
    assert "split == 1 || (C == 256 && (split == 2 || split == 4))" in src
    assert tds.splits_for(256) == (1, 2, 4)
    # C = 512 dispatches to stack_layer_wg (tests/test_torch_stack_wgmma_plans.py
    # models it); the mma.sync body keeps its 16-row chunks at C <= 256
    assert "template <int S> struct Body<float, 512, S>" in src
    assert "static auto kernel() { return stack_layer_wg<S>; }" in src
    assert "kc32" not in src and "(size_t)8 * NST32 * KC32 * w_stride32<C, S>()" in src
    assert tds.WG_CHANNELS == 512 and tds.BODIES[2] == "wgmma"
    assert "report[1] = dtype == 0 && C == 512 ? 2 : 1;" in src
    pairs = {(c, k) for c in tds.TC32_CHANNELS for k in tds.splits_for(c)}
    run = {(int(c), int(k)) for c, k in re.findall(r"STACK_TC\(float, (\d+), (\d+)\)", src)}
    resident = {(int(c), int(k)) for c, k in re.findall(r"tc::resident<(\d+), (\d+)>", src)}
    assert run == pairs and resident == pairs
    assert "return C / (4 * S) + 8;" in src
    kc32, nst32 = _cu_constant("KC32"), _cu_constant("NST32")
    wg_kc, wg_nst, wg_bars = _cu_constant("WG_KC"), _cu_constant("WG_NST"), _cu_constant("WG_BARS")
    for c, k in pairs:
        row = (c + 4) * 4
        if c == 512:
            # two warpgroups' rings of 16-row stages of 4/k 64-column units;
            # the two-way split holds cycle 4's halo of 8 rows and not 9
            d = 8 if k == 2 else tds.TC_MAX_DILATION
            smem = wg_bars + (2 * wg_nst * wg_kc * 128 * (4 // k)) * 4 + (TM + 2 * d) * row
            if k == 2:
                assert smem + 2 * row > 227 * 1024
        else:
            d = tds.TC_MAX_DILATION
            smem = (TM + 2 * d) * row + 8 * nst32 * kc32 * (c // (4 * k) + 8) * 4
            # a warp's columns of each half are whole 8-column mma tiles
            assert (c // k // 8) % 8 == 0
        assert smem <= 227 * 1024
