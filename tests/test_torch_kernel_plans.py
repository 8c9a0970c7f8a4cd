"""Host-side plans and arithmetic of the redesigned serving kernels, on the CPU.

The float32 MRF kernel computes, per T tile and branch, only the rows that
``mrf_window_plan`` lists, with products split 3xTF32. Neither can run here
(CUDA only), so the tests emulate both in PyTorch:
  * a windowed run that computes every conv only on the plan's row ranges,
    with NaN in every row it does not compute, equals the full-sequence twin
    on every kept row (atol 1e-6: the same products in another order);
  * the 3xTF32 arithmetic (mantissa cut to 10 bits, three products, float32
    sums) through a whole scale stays within 1e-4 x scale of the twin, and
    one TF32 pass does not: the recorded reason for the split.
The stack kernel reads the weights ``pack_diffnet_params`` gives; the MRF
kernel's bf16 body reads ``pack_mrf_params``' layout, its float32 body the hi
and lo planes cut from it (``tests/test_torch_mrf_wgmma_plans.py``).
"""

import numpy as np
import pytest
import torch

from diffsinger_tpu_torch.ops import _build
from diffsinger_tpu_torch.ops import diffnet_stack as ds
from diffsinger_tpu_torch.ops import hifigan_mrf as mrf

torch.set_num_threads(1)
KS = (3, 7, 11)
DS = ((1, 3, 5),) * 3


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


def _conv_rows(src, w_packed, bias, k, d, lo, hi, matmul=torch.matmul):
    """Rows [lo, hi) of a dilated conv over window ``src`` [B, R, C]; the taps
    must stay inside the window, as the plan promises."""
    c = src.shape[-1]
    half = k // 2
    assert lo - half * d >= 0 and hi + half * d <= src.shape[1]
    out = torch.zeros(src.shape[0], hi - lo, c)
    for tap in range(k):
        off = (tap - half) * d
        out = out + matmul(src[:, lo + off: hi + off], w_packed[tap * c: (tap + 1) * c])
    return out + bias


def _windowed_stage(x, w1, b1, w2, b2, ks, dsets, tiles, matmul=torch.matmul):
    """The kernel's schedule in PyTorch: a branch at a time, tile by tile, each
    conv only on the plan's rows; every other row of the buffers is NaN."""
    b, t, c = x.shape
    out = torch.zeros(b, t, c)
    for bj, br in enumerate(mrf.mrf_window_plan(ks, dsets, tiles)):
        k, tile, halo, rows = br["kernel_size"], br["tile"], br["halo"], br["rows"]
        for t0 in range(0, t, tile):
            win0 = t0 - halo
            gr = torch.arange(rows) + win0
            valid = ((gr >= 0) & (gr < t))[None, :, None]
            xc = torch.zeros(b, rows, c)
            inside = (gr >= 0) & (gr < t)
            xc[:, inside] = x[:, gr[inside]]
            yb = torch.full((b, rows, c), float("nan"))
            for cv, (lo, hi) in enumerate(br["ranges"]):
                stage = cv // 2
                if cv % 2 == 0:
                    src = torch.nn.functional.leaky_relu(xc, mrf.LRELU_SLOPE)
                    y = _conv_rows(src, w1[bj, stage], b1[bj, stage], k, dsets[bj][stage],
                                   lo, hi, matmul)
                    y = torch.nn.functional.leaky_relu(y, mrf.LRELU_SLOPE)
                    yb = torch.full((b, rows, c), float("nan"))
                    yb[:, lo:hi] = torch.where(valid[:, lo:hi], y, torch.zeros(()))
                else:
                    y = _conv_rows(yb, w2[bj, stage], b2[bj, stage], k, 1, lo, hi, matmul)
                    new = torch.where(valid[:, lo:hi], xc[:, lo:hi] + y, torch.zeros(()))
                    xc = torch.full((b, rows, c), float("nan"))
                    xc[:, lo:hi] = new
            assert br["ranges"][-1] == (halo, halo + tile)
            n = min(tile, t - t0)
            out[:, t0: t0 + n] += xc[:, halo: halo + n]
    return out * (1.0 / len(ks))


@pytest.mark.parametrize("c", [16, 32])
@pytest.mark.parametrize("t,tiles", [
    (96, 32),              # the tile divides T
    (100, 32),             # it does not: a ragged last tile
    (20, 64),              # T shorter than one tile, let alone one window
    (37, 7),               # T shorter than one halo, many tiles
    (90, (45, 30, 18)),    # a tile of its own per branch
])
def test_windowed_run_on_plan_rows_equals_full_sequence_twin(c, t, tiles):
    args = _scale_inputs(c + t, 2, t, c)
    want = mrf.mrf_stage_plain(*args, kernel_sizes=KS, dilation_sets=DS)
    got = _windowed_stage(*args, KS, DS, tiles)
    assert torch.isfinite(got).all()    # no row outside a range reached a kept row
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_plan_ranges_shrink_by_each_convs_reach_down_to_the_tile():
    for br, k, dils in zip(mrf.mrf_window_plan(KS, DS, (72, 40, 8)), KS, DS):
        assert br["halo"] == (k // 2) * (sum(dils) + len(dils))
        assert br["rows"] == br["tile"] + 2 * br["halo"]
        lo, hi = 0, br["rows"]
        reaches = [r for d in dils for r in ((k // 2) * d, k // 2)]
        for (rlo, rhi), reach in zip(br["ranges"], reaches):
            assert (rlo, rhi) == (lo + reach, hi - reach)   # reads stay in the range before
            lo, hi = rlo, rhi
        assert (lo, hi) == (br["halo"], br["halo"] + br["tile"])
    assert [br["halo"] for br in mrf.mrf_window_plan(KS, DS, 1)] == [12, 36, 60]
    with pytest.raises(ValueError):
        mrf.mrf_window_plan(KS, DS, (8, 8))
    with pytest.raises(ValueError):
        mrf.mrf_window_plan(KS, DS, 0)


@pytest.mark.parametrize("c,b,t", [(128, 8, 65536), (64, 8, 131072), (32, 8, 262144),
                                   (128, 1, 16384), (32, 2, 37), (16, 1, 500)])
def test_chosen_tiles_fit_shared_memory_and_one_pass_of_the_warps(c, b, t):
    """The float32 body: a window of xc and y rows of C + 4 floats, 128 bytes
    of barriers and a ring of slots holding a slice's hi and lo planes; every
    range in one pass of the warpgroups' 64-row tiles."""
    tiles = mrf.choose_mrf_tiles(c, b, t, KS, DS, 132)
    row_tiles, slice_rows, slots, blocks_per_sm, groups = mrf._TC_GEOMETRY[torch.float32][c]
    for br in mrf.mrf_window_plan(KS, DS, tiles):
        smem = 2 * br["rows"] * (c + 4) * 4 + 128 + slots * 2 * slice_rows * c * 4
        assert blocks_per_sm * (smem + 1024) <= 228 * 1024
        assert all(hi - lo <= 64 * row_tiles * groups for lo, hi in br["ranges"])
        assert 1 <= br["tile"] <= t
    # a narrow halo leaves room for a longer tile
    if t > 10000:
        assert tiles[0] >= tiles[2]


def test_launch_plan_flattens_the_plan_the_kernel_reads():
    tiles = (40, 24, 16)
    ks, dils, win = mrf._launch_plan(KS, DS, tiles)
    assert list(ks) == list(KS) and list(dils) == [d for dsets in DS for d in dsets]
    flat = list(win)
    per_branch = 3 + 2 * 2 * len(DS[0])
    assert len(flat) == len(KS) * per_branch
    for j, br in enumerate(mrf.mrf_window_plan(KS, DS, tiles)):
        part = flat[j * per_branch: (j + 1) * per_branch]
        assert part[:3] == [br["tile"], br["rows"], br["halo"]]
        assert list(zip(part[3::2], part[4::2])) == br["ranges"]


def _cut_tf32(a):
    """Sign, exponent and the top 10 mantissa bits: the kernel's hi / lo cut."""
    return (a.contiguous().view(torch.int32) & -8192).view(torch.float32)


def _matmul_tf32(passes):
    def matmul(a, w):
        a_hi, w_hi = _cut_tf32(a), _cut_tf32(w)
        if passes == 1:
            return a_hi @ w_hi
        a_lo, w_lo = _cut_tf32(a - a_hi), _cut_tf32(w - w_hi)
        return (a_lo @ w_hi + a_hi @ w_lo) + a_hi @ w_hi
    return matmul


def test_three_tf32_passes_hold_the_float32_tolerance_and_one_pass_does_not():
    c, t = 32, 160
    args = _scale_inputs(11, 2, t, c)
    want = mrf.mrf_stage_plain(*args, kernel_sizes=KS, dilation_sets=DS)
    tol = 1e-4 * max(float(want.abs().max()), 1.0)
    three = _windowed_stage(*args, KS, DS, 80, matmul=_matmul_tf32(3))
    one = _windowed_stage(*args, KS, DS, 80, matmul=_matmul_tf32(1))
    err3, err1 = float((three - want).abs().max()), float((one - want).abs().max())
    assert err3 <= tol, (err3, tol)
    assert err1 > tol, (err1, tol)
    # the split itself: hi + lo is the value up to 2^-20 of it
    a = args[0]
    hi = _cut_tf32(a)
    lo = _cut_tf32(a - hi)
    assert float(((hi + lo) - a).abs().max()) <= 2.0 ** -20 * float(a.abs().max())


def test_kernels_read_the_existing_weight_layouts():
    """The packed MRF weights are tap-major [k*C, C] rows, exactly what the
    windowed emulation slices, the bf16 body reads and the float32 body's
    planes are cut from."""
    x, w1, b1, w2, b2 = _scale_inputs(3, 1, 40, 16, ks=(3,), ns=1)
    k, c = 3, 16
    taps = w1[0, 0, : k * c].reshape(k, c, c)
    y = torch.nn.functional.leaky_relu(x, mrf.LRELU_SLOPE)
    want = mrf._conv_same(y, w1[0, 0], b1[0, 0], k, 1)
    got = _conv_rows(torch.nn.functional.pad(y, (0, 0, 1, 1)), w1[0, 0], b1[0, 0], k, 1, 1, 41)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert taps.shape == (3, 16, 16) and not w1[0, 0, k * c:].any()


def test_stack_twin_takes_a_sequence_shorter_than_the_dilation():
    rng = np.random.RandomState(0)
    f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.3)
    num_layers, b, t, c = 4, 2, 5, 32
    args = [f(b, t, c), f(num_layers, b, c), f(num_layers, b, t, 2 * c),
            f(num_layers, 3, c, 2 * c), f(num_layers, 2 * c), f(num_layers, c, 2 * c),
            f(num_layers, 2 * c)]
    dil = (1, 2, 4, 8)
    got = ds.diffnet_stack_plain(*args, dilations=dil)
    # with d = 8 > T both outer taps read only zeros: dropping their weights
    # must change nothing
    w_cut = args[3].clone()
    w_cut[3, 0] = 0
    w_cut[3, 2] = 0
    want = ds.diffnet_stack_plain(*args[:3], w_cut, *args[4:], dilations=dil)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.isfinite(got).all() and got.shape == (b, t, c)


def test_lib_path_follows_the_source_the_headers_and_the_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = _build._lib_path("k")
    assert first == _build._lib_path("k") and first.parent == _build.BUILD_DIR
    (tmp_path / "h.cuh").write_text("// two\n")
    second = _build._lib_path("k")
    assert second != first                                  # an edited header rebuilds
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert _build._lib_path("k") not in (first, second)     # so does an edited source
    assert _build._lib_path("k", ("-DX",)) != _build._lib_path("k")  # a variant has its own name


def test_shared_header_is_found_and_hashed_for_every_kernel_source():
    headers = sorted(p.name for p in _build.CSRC_DIR.glob("*.cuh"))
    assert headers == ["mma_sm90.cuh"]
    for name in ("diffnet_stack", "mrf_stage", "diffnet_train"):
        assert '#include "mma_sm90.cuh"' in (_build.CSRC_DIR / f"{name}.cu").read_text()
