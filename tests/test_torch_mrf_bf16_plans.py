"""The bfloat16 MRF kernel body's plan and arithmetic, on the CPU.

The bf16 body (``csrc/mrf_stage.cu:mrf_bf16_kernel``) runs only on the card.
What the CPU can hold it to:
  * the tiles ``choose_mrf_tiles`` picks for it fit its shared memory and one
    pass of its warps, and the geometry the chooser models is the one the
    source launches;
  * the launch arguments the wrapper builds carry the bf16 plan;
  * a PyTorch emulation of its schedule (a branch at a time, tile by tile,
    each conv only on the plan's rows, two window buffers with the conv
    output written over its input, NaN in every row a conv does not compute)
    equals the full-sequence bf16 twin. With exact products and float64 sums
    on both sides the two agree bit for bit; against the twin as it runs
    (float32 sums in another order) within 1e-2 of the output scale, the
    rule ``chip_smoke.py`` holds the kernel to;
  * the body's input lrelu (float32 lrelu of a bf16 value, rounded to
    nearest) equals the twin's ``rnd(F.leaky_relu(.))`` on every finite bf16
    value, and truncation does not.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffsinger_tpu_torch.ops import hifigan_mrf as mrf

torch.set_num_threads(1)
KS = (3, 7, 11)
DS = ((1, 3, 5),) * 3
BF16 = torch.bfloat16
SERVING = [(128, 8, 65536), (64, 8, 131072), (32, 8, 262144)]


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


def _rne(a):
    """float32 -> bf16 by round to nearest even (``__floats2bfloat162_rn``),
    kept in float32: the bit arithmetic, independent of torch's cast."""
    u = a.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u)
    return u.to(torch.int32).view(torch.float32)


def _trunc(a):
    return (a.contiguous().view(torch.int32) & -65536).view(torch.float32)


def _lrelu_rne(v):
    """The body's lrelu: max(v, 0.1 v) in float32, rounded to nearest."""
    return _rne(torch.maximum(v, v * mrf.LRELU_SLOPE))


def _conv_rows_exact(src, w_packed, bias, k, d, lo, hi):
    """Rows [lo, hi) of a dilated conv over window ``src`` [B, R, C] of bf16
    values: exact products, float64 sums, rounded to float32 (the kernel's
    accumulator), then + bias in float32. The taps stay inside the window."""
    c = src.shape[-1]
    half = k // 2
    assert lo - half * d >= 0 and hi + half * d <= src.shape[1]
    acc = torch.zeros(src.shape[0], hi - lo, c, dtype=torch.float64)
    for tap in range(k):
        off = (tap - half) * d
        acc += src[:, lo + off: hi + off].double() @ w_packed[tap * c: (tap + 1) * c].double()
    return acc.float() + bias


def _conv_same_exact(x, w_packed, bias, k, d):
    """``mrf._conv_same`` with exact products and float64 sums."""
    c = x.shape[-1]
    w = w_packed[: k * c].reshape(k, c, c).permute(2, 1, 0).double()
    y = F.conv1d(x.transpose(1, 2).double(), w, None, padding=(k * d - d) // 2, dilation=d)
    return y.transpose(1, 2).float() + bias


def _windowed_bf16(x, w1, b1, w2, b2, ks, dsets, tiles):
    """The bf16 body's schedule in PyTorch. Per branch and tile: xc = the
    window of x, ya = lrelu(xc); a stage's first conv reads ya and writes
    y = bf16(mask(lrelu(conv + b1))) over it, the second reads y and writes
    xc = mask(bf16(xc + (conv + b2))) and ya = bf16(lrelu(xc)). Every row a
    conv does not compute is NaN."""
    rnd = lambda a: a.to(BF16).to(torch.float32)
    x, w1, w2 = rnd(x), rnd(w1), rnd(w2)
    b, t, c = x.shape
    nan = float("nan")
    out = torch.zeros(b, t, c)
    for bj, br in enumerate(mrf.mrf_window_plan(ks, dsets, tiles)):
        k, tile, halo, rows = br["kernel_size"], br["tile"], br["halo"], br["rows"]
        for t0 in range(0, t, tile):
            gr = torch.arange(rows) + t0 - halo
            inside = (gr >= 0) & (gr < t)
            valid = inside[None, :, None]
            xc = torch.zeros(b, rows, c)
            xc[:, inside] = x[:, gr[inside]]
            ya = _lrelu_rne(xc)
            for cv, (lo, hi) in enumerate(br["ranges"]):
                st = cv // 2
                if cv % 2 == 0:
                    y = _conv_rows_exact(ya, w1[bj, st], b1[bj, st], k, dsets[bj][st], lo, hi)
                    y = torch.where(valid[:, lo:hi], _lrelu_rne(y), torch.zeros(()))
                    ya = torch.full((b, rows, c), nan)
                    ya[:, lo:hi] = y
                else:
                    y = _conv_rows_exact(ya, w2[bj, st], b2[bj, st], k, 1, lo, hi)
                    new = _rne(torch.where(valid[:, lo:hi], xc[:, lo:hi] + y, torch.zeros(())))
                    xc = torch.full((b, rows, c), nan)
                    xc[:, lo:hi] = new
                    ya = torch.full((b, rows, c), nan)
                    ya[:, lo:hi] = _lrelu_rne(new)
            assert br["ranges"][-1] == (halo, halo + tile)
            n = min(tile, t - t0)
            out[:, t0: t0 + n] += xc[:, halo: halo + n]
    return out * (1.0 / len(ks))


# ------------------------------------------------------------------ (a) tiles
@pytest.mark.parametrize("c,b,t", SERVING + [(128, 1, 16384), (32, 2, 37), (16, 1, 500)])
def test_bf16_tiles_fit_shared_memory_and_one_pass_of_the_warps(c, b, t):
    tiles = mrf.choose_mrf_tiles(c, b, t, KS, DS, 132, BF16)
    n_tiles, row_tiles, slice_rows, blocks_per_sm, n_warps = mrf._TC_GEOMETRY[BF16][c]
    warps_m = n_warps // (c // (8 * n_tiles))
    assert mrf.pass_rows(c, BF16) == 16 * row_tiles * warps_m
    for br in mrf.mrf_window_plan(KS, DS, tiles):
        smem = (2 * br["rows"] + 3 * slice_rows) * (c + 8) * 2   # bf16 rows of C + 8
        assert smem == mrf.block_smem(c, BF16, br["rows"])
        assert blocks_per_sm * (smem + 1024) <= 228 * 1024
        assert all(hi - lo <= 16 * row_tiles * warps_m for lo, hi in br["ranges"])
        assert 1 <= br["tile"] <= t
    if (c, b, t) in SERVING:
        # half the bytes a row: the widest halo's tile is at least the float32
        # one, unless one pass of the bf16 warps (k = 11: the pass and the
        # first conv's reach, less both halos) cuts it shorter
        pass_tile = mrf.pass_rows(c, BF16) + 2 * 5 - 2 * 60
        assert tiles[2] >= min(mrf.choose_mrf_tiles(c, b, t, KS, DS, 132)[2], pass_tile)


@pytest.mark.parametrize("dtype,fn", [(torch.float32, "launch_f32"), (BF16, "launch_bf16")])
def test_chooser_geometry_is_the_one_the_source_launches(dtype, fn):
    src = (Path(mrf.__file__).parents[1] / "csrc" / "mrf_stage.cu").read_text()
    if dtype == torch.float32:
        # MRF_LAUNCH_F32(C, NWG, MT, KS, NST): the wgmma body, one block an SM
        found = {int(m[0]): tuple(int(v) for v in m[1:]) for m in re.findall(
            r"MRF_LAUNCH_F32\((\d+), (\d+), (\d+), (\d+), (\d+)\)", src)}
        assert sorted(found) == list(mrf.KERNEL_CHANNELS)
        assert "__launch_bounds__(NWG * 128, 1)" in src
        for c, (groups, row_tiles, slice_rows, slots) in found.items():
            assert mrf._TC_GEOMETRY[dtype][c] == (row_tiles, slice_rows, slots, 1, groups)
        return
    found = {int(m[0]): tuple(int(v) for v in m[1:]) for m in re.findall(
        rf"MRF_LAUNCH\({fn}, (\d+), (\d+), (\d+), (\d+), (\d+), (\d+)\)", src)}
    assert sorted(found) == list(mrf.KERNEL_CHANNELS)
    for c, (n_tiles, row_tiles, slice_rows, n_warps, blocks_per_sm) in found.items():
        assert mrf._TC_GEOMETRY[dtype][c] == (n_tiles, row_tiles, slice_rows, blocks_per_sm,
                                             n_warps)


# ---------------------------------------------------------- (b) launch arguments
@pytest.mark.parametrize("c,b,t", [(128, 8, 65536), (32, 2, 37)])
def test_bf16_launch_arguments_carry_the_bf16_plan(c, b, t, monkeypatch):
    """``_launch`` on bf16 passes dtype 1 and the bf16 tiles' plan, laid out
    as ``mrf_stage_run`` reads it (per branch tile, rows, halo, then a
    (lo, hi) pair per conv). The tensors stay on the CPU: the entry point and
    the stream are stand-ins that record the call."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(mrf, "_entry", lambda: entry)
    monkeypatch.setattr(mrf, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    x = torch.zeros(b, t, c)
    w = torch.zeros(3, 3, 11 * c, c)
    bias = torch.zeros(3, 3, c)
    mrf._launch(x, w, bias, w, bias, KS, DS, BF16)
    (args,) = calls
    assert args[0] == 1 and args[7:13] == (b, t, c, 3, 3, 11)
    ks, dils, win = args[13:16]
    assert list(ks) == list(KS) and list(dils) == [d for ds in DS for d in ds]
    tiles = mrf.choose_mrf_tiles(c, b, t, KS, DS, 132, BF16)
    flat, per_branch = list(win), 3 + 2 * 2 * len(DS[0])
    assert len(flat) == len(KS) * per_branch
    for j, br in enumerate(mrf.mrf_window_plan(KS, DS, tiles)):
        part = flat[j * per_branch: (j + 1) * per_branch]
        assert part[:3] == [br["tile"], br["rows"], br["halo"]] and part[0] == tiles[j]
        assert list(zip(part[3::2], part[4::2])) == br["ranges"]
    assert list(mrf._launch_args((b, t, c), KS, DS, BF16, 132)[2]) == flat
    if t > 10000:   # a real plan, not a placeholder, and not the float32 one
        assert min(tiles) > 1
        assert list(mrf._launch_args((b, t, c), KS, DS, torch.float32, 132)[2]) != flat


# ------------------------------------------------------- (c) windowed schedule
@pytest.mark.parametrize("c", [16, 32])
@pytest.mark.parametrize("t,tiles", [
    (96, 32),              # the tile divides T
    (100, 32),             # it does not: a ragged last tile
    (20, 64),              # T shorter than one tile, let alone one window
    (37, 7),               # T shorter than one halo, many tiles
    (90, (45, 30, 18)),    # a tile of its own per branch
    (150, None),           # the tiles the chooser picks for the bf16 body
])
def test_bf16_windowed_run_on_plan_rows_equals_full_sequence_twin(c, t, tiles, monkeypatch):
    args = _scale_inputs(c + t + 1, 2, t, c)
    if tiles is None:
        tiles = mrf.choose_mrf_tiles(c, 2, t, KS, DS, 132, BF16)
    got = _windowed_bf16(*args, KS, DS, tiles)
    assert torch.isfinite(got).all()    # no row outside a range reached a kept row
    kw = dict(kernel_sizes=KS, dilation_sets=DS, compute_dtype=BF16)
    twin = mrf.mrf_stage_plain(*args, **kw)
    scale = float(twin.abs().max())
    assert float((got - twin).abs().max()) <= 1e-2 * max(scale, 1.0)
    # the twin's rounding points with exact sums: bit for bit
    monkeypatch.setattr(mrf, "_conv_same", _conv_same_exact)
    torch.testing.assert_close(got, mrf.mrf_stage_plain(*args, **kw), rtol=0, atol=0)
    # bf16 really rounds: the float32 twin lies further off
    f32 = mrf.mrf_stage_plain(*args, kernel_sizes=KS, dilation_sets=DS)
    assert float((got - f32).abs().max()) > 1e-4


# ---------------------------------------------------------------- (d) lrelu
def test_lrelu_then_round_to_nearest_is_the_twins_rounding_and_truncation_is_not():
    bits = (torch.arange(65536, dtype=torch.int64) << 16)
    v = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32).view(torch.float32)
    v = v[torch.isfinite(v)]                      # every finite bf16 value
    twin = F.leaky_relu(v, mrf.LRELU_SLOPE).to(BF16).to(torch.float32)
    raw = torch.maximum(v, v * mrf.LRELU_SLOPE)
    assert torch.equal(raw, F.leaky_relu(v, mrf.LRELU_SLOPE))   # max(v, 0.1 v) is the lrelu
    assert torch.equal(_lrelu_rne(v), twin)
    assert torch.equal(_rne(raw), raw.to(BF16).to(torch.float32))
    trunc = _trunc(raw)
    assert (trunc != twin).sum() > 1000          # truncation drifts: about half the negatives
    assert torch.equal(trunc[v >= 0], twin[v >= 0])
