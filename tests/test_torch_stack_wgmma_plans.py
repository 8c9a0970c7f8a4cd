"""The float32 stack body at C = 512 on ``wgmma``, on the CPU.

``stack_layer_wg`` (``csrc/diffnet_stack.cu``) runs only on the card. It
reads the weights packed once (``ops/diffnet_stack.py:wg_weights``), one
float32 plane K-major in 64-column units, brings a warpgroup's units of
each 16-row stage into a ring slot by bulk copies, runs two of the three
TF32 passes on the stage as it lies (the tensor cores read a float32
operand's top 19 bits, its hi part), turns the stage into its lo part in
place, and runs the third. What can be held here:
  * the packing: the documented layout reads back every weight bit for bit;
  * the split: the tensor cores' cut of the raw plane and the in-place lo
    are ``split_tf32``'s hi and lo, bit for bit;
  * a model of the schedule: tiles of 64 rows, S blocks of a cluster each
    with 8/S warpgroups of one 64-column unit, the stages in ring order through
    their slots (NaN until a copy lands), A from the y tile at the tap's
    offset (NaN in every row and column a block must not read) split into hi
    and lo, g written over y and pulled from the peers after the cluster
    barrier; within 1e-4 of the scale of the plain twin over both splits,
    at cycle 4 and at d = 16, where one TF32 pass is not;
  * the ring's protocol with its warps run in a random order: two
    warpgroup barriers around the in-place lo, the last warp of four
    refilling a slot, and what goes wrong without the first barrier;
  * the shared memory of each split at the dilations it takes.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from diffsinger_tpu_torch.ops import diffnet_stack as tds
from diffsinger_tpu_torch.ops.hifigan_mrf import split_tf32

torch.set_num_threads(1)
NAN = float("nan")
C, TM, MAX_DIL = 512, 64, 16
CU = Path(tds.__file__).resolve().parents[1] / "csrc" / "diffnet_stack.cu"


def _cu_constant(name):
    return int(re.search(rf"constexpr (?:int|size_t) {name} = ([0-9]+);", CU.read_text()).group(1))


KC, NST, BARS = _cu_constant("WG_KC"), _cu_constant("WG_NST"), _cu_constant("WG_BARS")
KU, NG, NCH = KC // 8, 3 * C // KC, 4 * C // KC


def _inputs(seed, b, t, num_layers, c=C):
    rng = np.random.RandomState(seed)

    def f(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))

    return (torch.relu(f(b, t, c)), f(num_layers, b, c, scale=0.5),
            f(num_layers, b, t, 2 * c, scale=0.5), f(num_layers, 3, c, 2 * c, scale=(3 * c) ** -0.5),
            f(num_layers, 2 * c, scale=0.1), f(num_layers, c, 2 * c, scale=c ** -0.5),
            f(num_layers, 2 * c, scale=0.1))


def _cut(a):
    """What the tensor cores read of a float32 operand: its top 19 bits."""
    return (a.contiguous().view(torch.int32) & -8192).view(torch.float32)


def _tf32_lo(a):
    """The kernel's in-place lo (``tf32_lo``): the remainder, cut."""
    return _cut(a - _cut(a))


def _unit_index(n_cols):
    """Offsets into a stage of N = n_cols columns, for each of its 8-deep
    steps: [KU, 8, N], element (row k, column n) of step u at u * N * 8 +
    ((n // 8) * 2 + k // 4) * 32 + (n % 8) * 4 + k % 4 (the descriptor's
    core matrices: two along K 128 bytes apart, 8-column groups 256 apart)."""
    k = torch.arange(8)[:, None]
    n = torch.arange(n_cols)[None, :]
    one = ((n // 8) * 2 + k // 4) * 32 + (n % 8) * 4 + k % 4
    return torch.stack([u * n_cols * 8 + one for u in range(KU)])


def _unit_columns(unit):
    """The global columns of a unit, a warpgroup's N = 128 accumulator
    columns: its 64 gate (residual) columns, then its 64 filter (skip)."""
    base = 64 * unit
    return torch.tensor(list(range(base, base + 64)) + list(range(C + base, C + base + 64)))


# ---------------------------------------------------------------- packing
def test_the_packed_plane_reads_back_every_weight_bit_for_bit():
    num_layers = 2
    _, _, _, w_dil, _, w_out, _ = _inputs(1, 1, 8, num_layers)
    p = tds.wg_weights(w_dil, w_out)
    assert p.shape == (num_layers, 4 * C // 8, C // 64, 2, 8, 2, 8, 4)
    assert p.numel() == w_dil.numel() + w_out.numel()   # one plane: no byte more than the weights
    flat = p.reshape(num_layers, 4 * C // 8, C // 64, 1024)
    idx = _unit_index(128)[0]                             # one step of one unit: [8, 128]
    w = torch.cat([w_dil.reshape(num_layers, 3 * C, 2 * C), w_out], dim=1)
    for unit in (0, 3, 7):
        cols = _unit_columns(unit)
        for step in (0, 5, 191, 192, 255):                # conv taps 0 and 2, the out rows
            got = flat[:, step, unit][:, idx]             # [L, 8, 128]
            want = w[:, 8 * step: 8 * step + 8][:, :, cols]
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (unit, step)


def _awkward(n):
    """Random values, values at and beside powers of two, zeros, subnormals."""
    rng = np.random.RandomState(5)
    v = (rng.randn(n) * 0.2).astype(np.float32)
    pw = np.float32(2.0) ** rng.randint(-30, 30, size=n).astype(np.float32)
    near = pw * (np.float32(1) + np.float32(2 ** -23) * rng.randint(-9000, 9000, size=n))
    sign = np.where(rng.rand(n) < 0.5, 0, 1 << 31).astype(np.uint32)
    sub = (rng.randint(1, 2 ** 23, size=n).astype(np.uint32) | sign).view(np.float32)
    pick = rng.randint(0, 5, size=n)
    out = np.where(pick == 0, v, np.where(pick == 1, pw * np.sign(v),
                   np.where(pick == 2, near, np.where(pick == 3, 0.0, sub))))
    return torch.from_numpy(out.astype(np.float32))


def test_the_raw_plane_and_its_in_place_lo_are_the_kernels_split_bit_for_bit():
    w = _awkward(3 * 128 * 64)
    assert ((w != 0) & (w.abs() < 2 ** -126)).any() and (w == 0).any()
    hi, lo = split_tf32(w)                                # csrc/mma_sm90.cuh:split_tf32
    assert torch.equal(_cut(w).view(torch.int32), hi.view(torch.int32))
    assert torch.equal(_tf32_lo(w).view(torch.int32), lo.view(torch.int32))
    # the tensor cores' read of the lo plane is the lo plane: it is cut already
    assert torch.equal(_cut(lo).view(torch.int32), lo.view(torch.int32))
    # numpy's bits, as the card computes them
    x = w.numpy()
    hi_np = (x.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
    lo_np = ((x - hi_np).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
    assert np.array_equal(_tf32_lo(w).numpy().view(np.uint32), lo_np.view(np.uint32))


# ---------------------------------------------------------- the schedule
def emulate_stack_wg(x0, step, cond, w_dil, b_dil, w_out, b_out, *, dilations, split,
                     passes=3, seed=0, barrier=True):
    """The block schedule of ``stack_layer_wg<split>``; returns the skip sum.
    Each tile runs on a cluster of ``split`` blocks in a shuffled rank order,
    each with 8 / split warpgroups of one unit; ``barrier=False`` is a
    fault: each rank runs to its end before the next starts. Device buffers
    are NaN past T, the y tile NaN outside its (64 + 2d) x C, a ring slot NaN
    until its stage lands, and g's rows of a tile NaN from the conv's end
    until written (they held y)."""
    b, t, _ = x0.shape
    n_wg, n_cols = 8 // split, 128
    packed = tds.wg_weights(w_dil, w_out).reshape(len(dilations), 4 * C // 8, C // 64 * 1024)
    idx = _unit_index(n_cols)
    pad = 8
    bufs = [torch.full((b, t + pad, C), NAN) for _ in range(2)]
    skip = torch.full((b, t + pad, C), NAN)
    x_in = torch.full((b, t + pad, C), NAN)
    x_in[:, :t] = x0
    cond_dev = torch.full(cond.shape[:2] + (t + pad, 2 * C), NAN)
    cond_dev[:, :, :t] = cond
    order = np.random.RandomState(seed)
    for l, d in enumerate(dilations):
        x_out = bufs[l % 2]
        for i in order.permutation(b * -(-t // TM)):
            bi, t0 = i // -(-t // TM), i % -(-t // TM) * TM
            rows = torch.arange(t0, t0 + TM)
            live = rows < t
            # each rank's y tile before the layer: nothing a block may read
            tiles = {r: torch.full((TM + 2 * MAX_DIL, C + 4), NAN) for r in range(split)}
            state = {}

            def conv_gate(rank):
                ts = torch.arange(t0 - d, t0 + TM + d)
                inside = (ts >= 0) & (ts < t)
                ys = tiles[rank]
                ys[: TM + 2 * d, :C] = 0.0
                ys[: TM + 2 * d][inside, :C] = x_in[bi, ts[inside]] + step[l, bi]
                accs, rings = [], []
                for wg in range(n_wg):
                    u0 = rank * n_wg + wg
                    ring = torch.full((NST, KC * n_cols), NAN)

                    def fill(n, ring=ring, u0=u0):
                        if n < NCH:
                            src = packed[l, n * KU:(n + 1) * KU, u0 * 1024:(u0 + 1) * 1024]
                            ring[n % NST] = src.reshape(-1)

                    for n in range(NST):
                        fill(n)
                    rings.append((ring, fill))
                    accs.append(torch.zeros(TM, n_cols))
                state[rank] = (accs, rings)
                run_chunks(rank, range(0, NG))
                # the gate epilogue: g over y's first rows, zero past T
                ys[:TM] = NAN
                for wg in range(n_wg):
                    u0 = rank * n_wg + wg
                    cols = _unit_columns(u0)
                    cond_rows = torch.zeros(TM, n_cols)
                    cond_rows[live] = cond_dev[l, bi][rows[live]][:, cols]
                    pre = accs[wg] + b_dil[l, cols] + cond_rows
                    g = torch.sigmoid(pre[:, :64]) * torch.tanh(pre[:, 64:])
                    g[~live] = 0.0
                    ys[:TM, cols[:64]] = g
                    accs[wg].zero_()

            def run_chunks(rank, chunks):
                ys = tiles[rank]
                accs, rings = state[rank]
                for n in chunks:
                    if n < NG:
                        tap, c0 = n * KC // C, n * KC % C
                        a = ys[tap * d: tap * d + TM, c0: c0 + KC]
                    else:
                        a = ys[:TM, (n - NG) * KC: (n - NG + 1) * KC]
                    a_hi, a_lo = split_tf32(a.contiguous())
                    for wg in range(n_wg):
                        ring, fill = rings[wg]
                        stage = ring[n % NST]
                        for u in range(KU):
                            bh = _cut(stage[idx[u]])                 # the raw plane as read
                            if passes == 3:
                                accs[wg] += a_lo[:, 8 * u: 8 * u + 8] @ bh
                            accs[wg] += a_hi[:, 8 * u: 8 * u + 8] @ bh
                        stage.copy_(_tf32_lo(stage))                 # in place, after both passes
                        for u in range(KU):
                            if passes == 3:
                                accs[wg] += a_hi[:, 8 * u: 8 * u + 8] @ _cut(stage[idx[u]])
                        fill(n + NST)

            def pull_out_epilogue(rank):
                ys = tiles[rank]
                own = range(rank * C // split, (rank + 1) * C // split)
                for peer in range(split):
                    if peer != rank:
                        cols = torch.arange(peer * C // split, (peer + 1) * C // split)
                        ys[:TM, cols] = tiles[peer][:TM, cols]
                run_chunks(rank, range(NG, NCH))
                accs, _ = state[rank]
                keep = rows[live]
                for wg in range(n_wg):
                    u0 = rank * n_wg + wg
                    cols = _unit_columns(u0)
                    res_cols = cols[:64]
                    assert set(res_cols.tolist()) <= set(own)
                    out = accs[wg] + b_out[l, cols]
                    res, sk = out[live][:, :64], out[live][:, 64:]
                    x_out[bi, keep[:, None], res_cols] = (
                        (x_in[bi, keep[:, None], res_cols] + res) * tds.SQRT_HALF)
                    skip[bi, keep[:, None], res_cols] = (
                        sk if l == 0 else skip[bi, keep[:, None], res_cols] + sk)

            ranks = order.permutation(split)
            if barrier:
                for j in ranks:
                    conv_gate(j)
                for j in ranks:
                    pull_out_epilogue(j)
            else:
                for j in ranks:
                    conv_gate(j)
                    pull_out_epilogue(j)
        x_in = x_out
    return skip[:, :t]


CASES = ([pytest.param(k, 4, t, id=f"k{k}-cycle4-T{t}") for k in (2, 4) for t in (5, 97)]
         + [pytest.param(4, 16, 130, id="k4-d16-T130")])


def _dilations(cycle):
    return (16, 1) if cycle == 16 else tuple(2 ** (i % cycle) for i in range(2))


@pytest.mark.parametrize("split, cycle, t", CASES)
def test_the_wgmma_schedule_equals_the_plain_twin(split, cycle, t):
    dil = _dilations(cycle)
    args = _inputs(split + cycle + t, 1 + t % 2, t, len(dil))
    got = emulate_stack_wg(*args, dilations=dil, split=split, seed=t)
    want = tds.diffnet_stack_plain(*args, dilations=dil)
    tol = 1e-4 * max(float(want.abs().max()), 1.0)
    assert torch.isfinite(got).all()        # no NaN row or column reached a result
    assert float((got - want).abs().max()) <= tol


def test_one_tf32_pass_does_not_hold_the_tolerance():
    dil = _dilations(4)
    args = _inputs(3, 1, 64, len(dil))
    want = tds.diffnet_stack_plain(*args, dilations=dil)
    tol = 1e-4 * max(float(want.abs().max()), 1.0)
    one = emulate_stack_wg(*args, dilations=dil, split=2, passes=1)
    three = emulate_stack_wg(*args, dilations=dil, split=2)
    assert float((one - want).abs().max()) > tol
    assert float((three - want).abs().max()) <= tol


@pytest.mark.parametrize("split", [2, 4])
def test_a_missing_cluster_barrier_shows_as_nan(split):
    """A rank that pulls its peers' g columns before they are written reads
    rows that no longer hold y and do not hold g yet."""
    dil = _dilations(4)
    args = _inputs(11, 1, 70, len(dil))
    assert torch.isfinite(emulate_stack_wg(*args, dilations=dil, split=split)).all()
    assert torch.isnan(emulate_stack_wg(*args, dilations=dil, split=split, barrier=False)).any()


# -------------------------------------------------------------- the ring
def _ring_run(slots, n_stages, seed, first_barrier=True, n_warp=4):
    """A warpgroup's ring (``stack_layer_wg``) with its four warps as
    generators run in a random order. Slot n % slots holds stage n, raw,
    once its copy lands; a warp waits for it, reads it raw (two passes),
    meets the others at a barrier, writes its share of the lo part in
    place, meets them again, reads the lo part (the third pass), then counts
    itself done; the fourth warp to be done refills the slot with stage
    n + slots. Returns "done", "stalled" or "overwritten" (a pass read a
    slot in a state other than the one it needs)."""
    held = {s: (s, "raw", set()) for s in range(slots)}   # slot -> (stage, state, warps written lo)
    freed = [0] * slots
    bars = {"count": 0, "gen": 0}

    def barrier():
        gen = bars["gen"]
        bars["count"] += 1
        if bars["count"] == n_warp:
            bars["count"], bars["gen"] = 0, gen + 1
        while bars["gen"] == gen:
            yield "barrier"

    def warp(w):
        for n in range(n_stages):
            s = n % slots
            while held[s][0] != n:
                yield "wait"
            yield "products"
            if held[s][:2] != (n, "raw") or held[s][2]:
                raise AssertionError                     # read a slot half turned into lo
            if first_barrier:
                yield from barrier()
            stage, _, wrote = held[s]
            wrote.add(w)
            held[s] = (stage, "lo" if len(wrote) == n_warp else "raw", wrote)
            yield from barrier()
            yield "products"
            if held[s][:2] != (n, "lo"):
                raise AssertionError
            count = freed[s]
            freed[s] += 1
            if count % n_warp == n_warp - 1 and n + slots < n_stages:
                held[s] = (n + slots, "raw", set())

    rng = np.random.RandomState(seed)
    warps = [warp(w) for w in range(n_warp)]
    alive, blocked = list(range(n_warp)), 0
    while alive:
        w = alive[rng.randint(len(alive))]
        try:
            blocked = blocked + 1 if next(warps[w]) in ("wait", "barrier") else 0
        except StopIteration:
            alive.remove(w)
            blocked = 0
        except AssertionError:
            return "overwritten"
        if blocked > 50 * n_warp * slots:
            return "stalled"
    return "done"


def test_the_ring_turns_each_stage_into_lo_only_after_every_warp_read_it_raw():
    for seed in range(6):
        assert _ring_run(NST, NCH, seed) == "done"


def test_without_the_first_barrier_a_warp_reads_a_stage_half_turned():
    """The model sees the fault the barrier before the lo writes guards."""
    assert any(_ring_run(NST, 16, seed, first_barrier=False) == "overwritten"
               for seed in range(6))


# ------------------------------------------------------- shared memory
def _smem(split, d):
    return BARS + (8 // split * NST * KC * 128 + (TM + 2 * d) * (C + 4)) * 4


def test_each_split_fits_the_dilations_it_takes():
    """<512, 4> holds the widest halo; <512, 2>'s four rings (a warpgroup
    for each of its four units) leave it cycle 4's (d <= 8): past that it
    reports no resident cluster and the rule takes k = 4. 16-row stages (two
    8-deep steps), two a warpgroup."""
    limit = 227 * 1024
    assert KC == 16 and NST == 2
    assert _smem(4, MAX_DIL) <= limit
    assert _smem(2, 8) <= limit < _smem(2, 9)
    src = CU.read_text()
    assert "smem_bytes_wg<4>(MAX_DIL) <= SMEM_LIMIT && smem_bytes_wg<2>(8) <= SMEM_LIMIT" in src
    # each warpgroup's stage is whole float4 a thread
    assert KC * 128 % (4 * 128) == 0
    assert tds.column_split(1, 432, 512, {2: 0, 4: 30}) == 4


# ------------------------------------------------------------- the wrapper
def test_a_512_call_packs_once_and_reports_the_wgmma_body(monkeypatch):
    """A float32 C = 512 call (its entry mocked) hands the library the
    packed plane, made once per weight pair and again only when a tensor
    changes; the body the library reports is counted by name. C = 256
    passes its weights as they are."""
    calls, made = [], []

    def entry(path, dtype, split, x, skip, scratch, step, cond, wd, bd, wo, bo, b, t, c, *rest):
        calls.append((wd, wo))
        report = rest[-1]
        report[0], report[1], report[2] = 20, 2 if c == 512 else 1, split
        return 0

    class Stream:
        cuda_stream = 0

    for name in ("device_launches", "ran_tensor_cores", "column_split", "body"):
        monkeypatch.setattr(tds.diffnet_stack, name, None)   # put back after the test
    monkeypatch.setattr(tds.diffnet_stack, "launches_by_body", {})
    monkeypatch.setattr(tds, "_entry", lambda: entry)
    monkeypatch.setattr(tds, "_resident", lambda c, dmax, dev: {1: 132, 2: 66, 4: 30})
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    real = tds.wg_weights
    monkeypatch.setattr(tds, "wg_weights", lambda wd, wo: made.append(wd) or real(wd, wo))
    args = _inputs(4, 1, 100, 1)
    for _ in range(3):
        tds._launch(*args, (1,), None)
    assert len(made) == 1 and made[0] is args[3]
    packed = args[3]._wg_weights[1]
    assert {wd for wd, _ in calls} == {packed.data_ptr()} and calls[0][1] == packed.data_ptr()
    assert tds.diffnet_stack.body == "wgmma" and tds.diffnet_stack.ran_tensor_cores
    assert tds.diffnet_stack.launches_by_body == {"wgmma": 3}
    with torch.no_grad():
        args[5].mul_(2.0)                                   # w_out changed: packed anew
    tds._launch(*args, (1,), None)
    assert len(made) == 2
    flat = args[3]._wg_weights[1].reshape(1, 4 * C // 8, C // 64, 1024)
    assert torch.equal(flat[0, 3 * C // 8, 0][_unit_index(128)[0]][:, :64], args[5][0, :8, :64])
    w256 = _inputs(5, 1, 64, 1, c=256)
    tds._launch(*w256, (1,), None)
    assert calls[-1] == (w256[3].data_ptr(), w256[5].data_ptr()) and len(made) == 2
    assert tds.diffnet_stack.body == "mma_sync"
    assert tds.diffnet_stack.launches_by_body == {"wgmma": 4, "mma_sync": 1}

