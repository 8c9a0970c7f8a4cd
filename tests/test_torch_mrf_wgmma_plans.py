"""The float32 MRF kernel body on ``wgmma``, on the CPU.

The body (``csrc/mrf_stage.cu:mrf_wg_kernel``) runs only on the card. It
reads weights split into TF32 hi and lo planes once, when they are packed
(``ops/hifigan_mrf.py:weight_planes``), and computes every conv of the window
plan in 64-row warpgroup tiles. What can be held here:
  * the planes: hi keeps 10 mantissa bits, hi and lo are the kernel's
    ``split_tf32`` pieces bit for bit, and the documented K-major layout
    reads back the torch conv weights of every branch, stage and tap;
  * the planes are made once per weight tensor (at packing, or at the first
    call) and again only when the tensor changes;
  * a model of the schedule: 64-row tiles over the plan's ranges as the body
    rounds them, NaN in every row no conv computes, three TF32 passes on the
    planes, within 1e-4 of the scale of the plain twin; one pass is not;
  * the counters of a float32 call, and the tiles against shared memory with
    the hi + lo ring.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from diffsinger_tpu_torch.models.hifigan import HifiGanConfig, HifiGanGenerator
from diffsinger_tpu_torch.ops import hifigan_mrf as mrf
from diffsinger_tpu_torch.utils import trace

torch.set_num_threads(1)
KS = (3, 7, 11)
DS = ((1, 3, 5),) * 3
F32 = torch.float32


def _scale_inputs(seed, b, t, c, ks=KS, ns=3):
    rng = np.random.RandomState(seed)
    k_max = max(ks)
    x = torch.from_numpy((rng.randn(b, t, c) * 0.3).astype(np.float32))
    w1 = torch.zeros(len(ks), ns, k_max * c, c)
    w2 = torch.zeros_like(w1)
    for j, k in enumerate(ks):
        for w in (w1, w2):
            w[j, :, : k * c] = torch.from_numpy(
                (rng.randn(ns, k * c, c) * (k * c) ** -0.5).astype(np.float32))
    b1 = torch.from_numpy((rng.randn(len(ks), ns, c) * 0.05).astype(np.float32))
    b2 = torch.from_numpy((rng.randn(len(ks), ns, c) * 0.05).astype(np.float32))
    return x, w1, b1, w2, b2


def _bits(a):
    return a.contiguous().view(torch.int32)


def _unplane(planes, c):
    """(hi, lo) [n_branch, n_stage, k_max*C, C] read back from the planes by
    the layout ``weight_planes`` documents: element (kk, n) of a slice at
    ((n // 8 * KS / 4 + kk // 4) * 8 + n % 8) * 4 + kk % 4."""
    nb, ns, k_max, spt = planes.shape[:4]
    ks = c // spt
    flat = planes.reshape(nb, ns, k_max, spt, 2, ks * c)
    kk = torch.arange(ks)[:, None]
    n = torch.arange(c)[None, :]
    idx = ((n // 8 * (ks // 4) + kk // 4) * 8 + n % 8) * 4 + kk % 4
    w = flat[..., idx]                                   # [nb, ns, k_max, spt, 2, ks, c]
    w = w.permute(4, 0, 1, 2, 3, 5, 6).reshape(2, nb, ns, k_max * c, c)
    return w[0], w[1]


# ----------------------------------------------------------------- the planes
def _awkward_values(c, k_max=3):
    """Random values, values at and beside powers of two, zeros, subnormals."""
    rng = np.random.RandomState(5)
    n = k_max * c * c
    v = (rng.randn(n) * 0.2).astype(np.float32)
    pw = np.float32(2.0) ** rng.randint(-30, 30, size=n).astype(np.float32)
    near = pw * (np.float32(1) + np.float32(2 ** -23) * rng.randint(-9000, 9000, size=n))
    sign = np.where(rng.rand(n) < 0.5, 0, 1 << 31).astype(np.uint32)
    sub = (rng.randint(1, 2 ** 23, size=n).astype(np.uint32) | sign).view(np.float32)
    pick = rng.randint(0, 5, size=n)
    out = np.where(pick == 0, v, np.where(pick == 1, pw * np.sign(v),
                   np.where(pick == 2, near, np.where(pick == 3, 0.0, sub))))
    return torch.from_numpy(out.astype(np.float32)).reshape(1, 1, k_max * c, c)


@pytest.mark.parametrize("c", [16, 32, 64, 128])
def test_planes_are_the_kernels_split_bit_for_bit(c):
    w = _awkward_values(c)
    assert torch.isfinite(w).all() and (w == 0).any()
    assert ((w != 0) & (w.abs() < 2 ** -126)).any()          # subnormals
    hi, lo = _unplane(mrf.weight_planes(w), c)
    assert not (_bits(hi) & 0x1FFF).any() and not (_bits(lo) & 0x1FFF).any()
    # csrc/mma_sm90.cuh:split_tf32 in numpy: hi = bits & ~0x1fff, lo = (x - hi) cut the same way
    x = w.numpy().reshape(-1)
    hi_np = (x.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
    lo_np = ((x - hi_np).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
    assert np.array_equal(hi.numpy().reshape(-1).view(np.uint32), hi_np.view(np.uint32))
    assert np.array_equal(lo.numpy().reshape(-1).view(np.uint32), lo_np.view(np.uint32))
    # hi + lo is the value up to 2^-20 of it (2^-126 of slack for the subnormals)
    err = (hi.double() + lo.double() - w.double()).abs()
    assert bool((err <= 2.0 ** -20 * w.double().abs() + 2.0 ** -126).all())


def test_planes_unpack_to_every_branch_stage_and_tap_of_the_generator():
    kw = dict(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
              upsample_initial_channel=256, resblock_kernel_sizes=KS,
              resblock_dilation_sizes=DS, num_mels=8)
    gen = HifiGanGenerator(HifiGanConfig(**kw))
    with torch.no_grad():
        for p in gen.parameters():
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    for stage, c in ((0, 128), (1, 64)):
        w1, _, w2, _ = mrf.pack_mrf_params(gen, stage)
        for planes, convs in ((mrf.weight_planes(w1), "convs1"),
                              (mrf.weight_planes(w2), "convs2")):
            assert planes.shape == (3, 3, 11, c // mrf._TC_GEOMETRY[F32][c].slice_rows, 2,
                                    c // 8, mrf._TC_GEOMETRY[F32][c].slice_rows // 4, 8, 4)
            hi, lo = _unplane(planes, c)
            for j, k in enumerate(KS):
                rb = gen.resblocks[stage * len(KS) + j]
                for s, conv in enumerate(getattr(rb, convs)):
                    w = conv.weight.detach()                      # [out, in, k]
                    for tap in range(11):
                        got = (hi + lo)[j, s, tap * c: (tap + 1) * c]   # [in, out]
                        want = w[:, :, tap].T if tap < k else torch.zeros(c, c)
                        err = (got - want).abs().max()
                        assert float(err) <= 2.0 ** -20 * float(w.abs().max()), (j, s, tap)


def _fake_launch(monkeypatch):
    """``_launch`` on CPU tensors: the entry point and the stream are
    stand-ins that record each call's arguments."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(mrf, "_entry", lambda: entry)
    monkeypatch.setattr(mrf, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    return calls


def test_the_split_is_made_once_per_weight_tensor(monkeypatch):
    calls = _fake_launch(monkeypatch)
    made = []
    real = mrf.weight_planes
    monkeypatch.setattr(mrf, "weight_planes", lambda w: made.append(w) or real(w))
    x, w1, b1, w2, b2 = _scale_inputs(1, 1, 64, 32)
    for _ in range(3):
        mrf._launch(x, w1, b1, w2, b2, KS, DS, None)
    assert len(made) == 2 and made[0] is w1 and made[1] is w2
    assert calls[0][0] == 0                                  # the float32 body
    assert len({c[2] for c in calls}) == 1 and len({c[4] for c in calls}) == 1
    assert calls[0][2] == w1._mrf_planes[1].data_ptr()
    with torch.no_grad():
        w1.mul_(2.0)                                         # the weights changed: split again
    mrf._launch(x, w1, b1, w2, b2, KS, DS, None)
    assert len(made) == 3 and made[2] is w1
    hi, lo = _unplane(w1._mrf_planes[1], 32)
    assert torch.equal(hi + lo, w1) or float((hi + lo - w1).abs().max()) <= 2e-6
    # bfloat16 reads the packed weights as they are: no planes
    mrf._launch(x, w1, b1, w2, b2, KS, DS, torch.bfloat16)
    assert len(made) == 3 and calls[-1][0] == 1


def test_packing_a_float32_generator_splits_its_kernel_scales(monkeypatch):
    kw = dict(upsample_rates=(4, 4, 4), upsample_kernel_sizes=(8, 8, 8),
              upsample_initial_channel=64, resblock_kernel_sizes=KS,
              resblock_dilation_sizes=DS, num_mels=8)
    packed = mrf.pack_mrf_scales(HifiGanGenerator(HifiGanConfig(**kw)))
    # C = 32 and 16 run the kernel; C = 8 is packed for the twin only
    assert [p[0].shape[-1] for p in packed] == [32, 16, 8]
    for w1, _, w2, _ in packed[:2]:
        assert hasattr(w1, "_mrf_planes") and hasattr(w2, "_mrf_planes")
    assert not hasattr(packed[2][0], "_mrf_planes")
    made = []
    real = mrf.weight_planes
    monkeypatch.setattr(mrf, "weight_planes", lambda w: made.append(w) or real(w))
    _fake_launch(monkeypatch)
    w1, b1, w2, b2 = packed[0]
    mrf._launch(torch.zeros(1, 50, 32), w1, b1, w2, b2, KS, DS, None)
    assert made == []                                        # found made at packing
    bf16 = mrf.pack_mrf_scales(HifiGanGenerator(HifiGanConfig(**kw, compute_dtype="bfloat16")))
    assert not hasattr(bf16[0][0], "_mrf_planes")


# ------------------------------------------------------------ the schedule
def _wgmma_stage(x, planes1, b1, planes2, b2, ks, dsets, tiles, passes=3):
    """The body's schedule in PyTorch: a branch at a time, tile by tile, each
    conv over its range rounded up to 64-row tiles (A rows past the window
    clamped, as the body's ldmatrix), each tap's products from the planes'
    hi and lo (three passes: a_lo w_hi + a_hi w_lo + a_hi w_hi), only the
    range's rows kept; every row a conv does not write is NaN."""
    b, t, c = x.shape
    w1h, w1l = _unplane(planes1, c)
    w2h, w2l = _unplane(planes2, c)
    out = torch.zeros(b, t, c)
    nan = float("nan")
    for bj, br in enumerate(mrf.mrf_window_plan(ks, dsets, tiles)):
        k, tile, halo, rows = br["kernel_size"], br["tile"], br["halo"], br["rows"]
        for t0 in range(0, t, tile):
            gr = torch.arange(rows) + t0 - halo
            inside = (gr >= 0) & (gr < t)
            xc = torch.zeros(b, rows, c)
            xc[:, inside] = x[:, gr[inside]]
            yb = torch.full((b, rows, c), nan)
            for cv, (lo, hi) in enumerate(br["ranges"]):
                st, first = cv // 2, cv % 2 == 0
                d = dsets[bj][st] if first else 1
                n = -(-(hi - lo) // 64) * 64
                src = F.leaky_relu(xc, mrf.LRELU_SLOPE) if first else yb
                wh, wl = (w1h, w1l) if first else (w2h, w2l)
                acc = torch.zeros(b, n, c)
                for tap in range(k):
                    rr = (torch.arange(lo, lo + n) + (tap - k // 2) * d).clamp(0, rows - 1)
                    a_hi, a_lo = mrf.split_tf32(src[:, rr].contiguous())
                    th, tl = wh[bj, st, tap * c: (tap + 1) * c], wl[bj, st, tap * c: (tap + 1) * c]
                    if passes == 3:
                        acc = acc + a_lo @ th
                        acc = acc + a_hi @ tl
                    acc = acc + a_hi @ th
                v = acc[:, : hi - lo] + (b1 if first else b2)[bj, st]
                ok = inside[lo:hi][None, :, None]
                if first:
                    yb = torch.full((b, rows, c), nan)
                    yb[:, lo:hi] = torch.where(ok, F.leaky_relu(v, mrf.LRELU_SLOPE),
                                               torch.zeros(()))
                else:
                    new = torch.where(ok, xc[:, lo:hi] + v, torch.zeros(()))
                    xc = torch.full((b, rows, c), nan)
                    xc[:, lo:hi] = new
            m = min(tile, t - t0)
            out[:, t0: t0 + m] += xc[:, halo: halo + m]
    return out * (1.0 / len(ks))


@pytest.mark.parametrize("c,b,t,tiles", [
    (16, 1, 700, None),               # the chooser's tiles, B = 1
    (32, 2, 100, (45, 30, 18)),       # T not a multiple of any branch's tile
    (64, 1, 37, 7),                   # T shorter than one halo, many tiles
    (128, 1, 300, None),              # the widest scale at the chooser's tiles
    (128, 2, 90, (64, 50, 37)),
])
def test_wgmma_schedule_on_split_planes_holds_the_float32_tolerance(c, b, t, tiles):
    x, w1, b1, w2, b2 = _scale_inputs(c + t, b, t, c)
    if tiles is None:
        tiles = mrf.choose_mrf_tiles(c, b, t, KS, DS, 132)
    got = _wgmma_stage(x, mrf.weight_planes(w1), b1, mrf.weight_planes(w2), b2, KS, DS, tiles)
    assert torch.isfinite(got).all()    # no row outside a range reached a kept row
    want = mrf.mrf_stage_plain(x, w1, b1, w2, b2, kernel_sizes=KS, dilation_sets=DS)
    tol = 1e-4 * max(float(want.abs().max()), 1.0)
    assert float((got - want).abs().max()) <= tol


def test_one_pass_on_the_hi_planes_does_not_hold_it():
    x, w1, b1, w2, b2 = _scale_inputs(11, 2, 160, 32)
    p1, p2 = mrf.weight_planes(w1), mrf.weight_planes(w2)
    want = mrf.mrf_stage_plain(x, w1, b1, w2, b2, kernel_sizes=KS, dilation_sets=DS)
    tol = 1e-4 * max(float(want.abs().max()), 1.0)
    one = _wgmma_stage(x, p1, b1, p2, b2, KS, DS, 80, passes=1)
    three = _wgmma_stage(x, p1, b1, p2, b2, KS, DS, 80)
    assert float((one - want).abs().max()) > tol
    assert float((three - want).abs().max()) <= tol


# ------------------------------------------------------ tiles and counters
@pytest.mark.parametrize("c,b,t", [(128, 8, 65536), (64, 8, 131072), (32, 8, 262144),
                                   (16, 8, 524288), (128, 1, 40960), (16, 2, 4096)])
def test_float32_tiles_fit_shared_memory_with_the_hi_lo_ring(c, b, t):
    geo = mrf._TC_GEOMETRY[F32][c]
    tiles = mrf.choose_mrf_tiles(c, b, t, KS, DS, 132)
    ring = 128 + geo.slots * 2 * geo.slice_rows * c * 4    # barriers, then hi + lo slots
    for br in mrf.mrf_window_plan(KS, DS, tiles):
        smem = 2 * br["rows"] * (c + 4) * 4 + ring
        assert smem == mrf.block_smem(c, F32, br["rows"]) and smem <= 227 * 1024
        assert geo.blocks_per_sm * (smem + 1024) <= 228 * 1024
        # the first, longest range fits the warpgroups' 64-row tiles in one pass
        assert br["ranges"][0][1] - br["ranges"][0][0] <= 64 * geo.row_tiles * geo.warpgroups
        assert 1 <= br["tile"] <= t


def test_the_chooser_prices_the_64_row_rounding():
    """A tile whose ranges end just past a multiple of 64 costs a whole tile
    more a conv than one a row shorter: the chooser does not take it."""
    br = mrf.mrf_window_plan((3,), ((1, 3, 5),), 105)[0]
    assert [hi - lo for lo, hi in br["ranges"]] == [127, 125, 119, 117, 107, 105]
    longer = mrf.mrf_window_plan((3,), ((1, 3, 5),), 106)[0]
    assert mrf._branch_cost(longer, 128, F32) == mrf._branch_cost(br, 128, F32)
    past = mrf.mrf_window_plan((3,), ((1, 3, 5),), 108)[0]      # 129 rows: a third tile
    assert mrf._branch_cost(past, 128, F32) > mrf._branch_cost(longer, 128, F32)
    for c in (16, 32, 64, 128):
        for tile in mrf.choose_mrf_tiles(c, 8, 1 << 18, KS, DS, 132):
            assert tile >= 1


@pytest.mark.parametrize("c,b,t", [(128, 8, 65536), (32, 2, 37)])
def test_a_float32_call_counts_the_rows_it_computes(c, b, t, monkeypatch):
    _fake_launch(monkeypatch)
    x = torch.zeros(b, t, c)
    w = torch.zeros(3, 3, 11 * c, c)
    bias = torch.zeros(3, 3, c)
    trace.clear()
    mrf._launch(x, w, bias, w, bias, KS, DS, None)          # no profiler: nothing counted
    assert trace.summary() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        mrf._launch(x, w, bias, w, bias, KS, DS, None)
        mrf._launch(x.bfloat16(), w, bias, w, bias, KS, DS, torch.bfloat16)   # not counted
    s = trace.summary()
    trace.clear()
    tiles = mrf.choose_mrf_tiles(c, b, t, KS, DS, 132)
    done = sum(b * -(-t // br["tile"]) * sum(-(-(hi - lo) // 64) * 64 for lo, hi in br["ranges"])
               for br in mrf.mrf_window_plan(KS, DS, tiles))
    assert s["ds.mrf.conv_rows"] == {"count": 1, "total": done}
    assert s["ds.mrf.out_rows"] == {"count": 1, "total": 3 * b * t * 2 * 3}
    assert done > 3 * b * t * 2 * 3
    if t > 10000:   # the halo and the rounding: 1.0-1.7x of the rows the scale needs
        assert done / (18 * b * t) < 1.7


# ------------------------------------------------------------ the weight ring
def _ring_run(n_warp, slots, slices_per_conv, n_conv, seed, refill_at=None):
    """The float32 body's weight ring (``mrf_wg_kernel``) with its warps as
    generators run in a random order: slot q % slots holds slice q; a warp
    waits for its slice, reads it while its products run, then counts
    itself done with the slot; the warp whose count makes ``refill_at`` (by
    default the last of the block's warps) brings slice q + slots into the
    slot. A barrier of all warps ends each conv. Returns "done", "stalled"
    (no warp can move) or "overwritten" (a slice was replaced while a warp
    still read it)."""
    refill_at = n_warp - 1 if refill_at is None else refill_at
    total = n_conv * slices_per_conv
    held = {q: q for q in range(slots)}        # slot -> the slice in it
    freed = [0] * slots
    bar = {"count": 0, "gen": 0}

    def warp():
        q = 0
        for _ in range(n_conv):
            for _ in range(slices_per_conv):
                while held[q % slots] != q:
                    yield "wait"
                yield "products"
                if held[q % slots] != q:
                    raise AssertionError
                count = freed[q % slots]
                freed[q % slots] += 1
                if count % n_warp == refill_at and q + slots < total:
                    held[q % slots] = q + slots
                q += 1
            gen = bar["gen"]
            bar["count"] += 1
            if bar["count"] == n_warp:
                bar["count"], bar["gen"] = 0, gen + 1
            while bar["gen"] == gen:
                yield "barrier"

    rng = np.random.RandomState(seed)
    warps = [warp() for _ in range(n_warp)]
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


@pytest.mark.parametrize("c", [16, 32, 64, 128])
def test_the_weight_ring_refills_every_slot_without_overwriting_one_in_use(c):
    geo = mrf._TC_GEOMETRY[F32][c]
    for k in (3, 11):
        for seed in range(4):
            assert _ring_run(4 * geo.warpgroups, geo.slots, k * c // geo.slice_rows, 6,
                             seed) == "done"


def test_a_refill_by_an_earlier_warp_overwrites_a_slice_in_use():
    """The model sees the fault the last-warp rule guards against."""
    assert _ring_run(8, 3, 16, 2, 0) == "done"
    assert _ring_run(8, 3, 16, 2, 0, refill_at=0) == "overwritten"
