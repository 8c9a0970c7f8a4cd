"""Fused HiFiGAN MRF scale: CUDA kernel wrapper, plain twin, packing, and the
generator forward that uses it.

Counterpart of diffsinger_tpu/ops/hifigan_mrf.py. The kernel
(``csrc/mrf_stage.cu``) replaces the Pallas TPU kernels ``fused_mrf``
(diffsinger_tpu/ops/hifigan_mrf.py:197) and ``fused_packed_stage``
(diffsinger_tpu/ops/hifigan_packed_mrf.py:231), which compute the same
function on two layouts. Its source note states what bounds it on the H100.

One scale: x [B, T, C] -> mean over branches of ResBlock1 chains, each stage
lrelu -> dilated conv (k, d) -> lrelu -> conv (k, 1) -> + residual, every
conv zero-padded at the sequence edges. Packed weights w1/w2 are
[n_branch, n_stage, k_max*C, C] (taps stacked tap-major on the contraction
axis, zero rows for the shorter kernels); biases b1/b2 [n_branch, n_stage, C].
``compute_dtype=torch.bfloat16`` rounds the conv inputs, weights and the chain
state to bf16 at the JAX kernel's cast points; accumulation stays float32.

Both kernel bodies run on the tensor cores, float32 with the 3xTF32 split
(warpgroup ``wgmma`` products on weights split once, :func:`weight_planes`),
bfloat16 with one bf16 ``mma.sync`` pass, and compute, per T tile, only the
rows :func:`mrf_window_plan` lists, a branch at a time;
:func:`choose_mrf_tiles` picks each branch's tile from the body's geometry.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from diffsinger_tpu_torch.ops._build import check, load_library
from diffsinger_tpu_torch.utils import trace

LRELU_SLOPE = 0.1
KERNEL_CHANNELS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _conv_same(x: torch.Tensor, w_packed: torch.Tensor, bias: torch.Tensor,
               k: int, d: int) -> torch.Tensor:
    """Zero-padded dilated conv on [B, T, C] from one packed [k_max*C, C] mat."""
    c = x.shape[-1]
    w = w_packed[: k * c].reshape(k, c, c).permute(2, 1, 0)   # [out, in, k]
    pad = (k * d - d) // 2
    y = F.conv1d(x.transpose(1, 2), w, bias, padding=pad, dilation=d)
    return y.transpose(1, 2)


def mrf_stage_plain(x, w1, b1, w2, b2, *, kernel_sizes: Tuple[int, ...],
                    dilation_sets: Tuple[Tuple[int, ...], ...],
                    compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The kernel's math in plain PyTorch: the ResBlock1 chains with the
    kernel's rounding points. Returns float32 [B, T, C]."""
    f32 = torch.float32

    def rnd(a):
        return a.to(compute_dtype).to(f32) if compute_dtype is not None else a.to(f32)

    x0 = rnd(x)
    acc = torch.zeros_like(x0)
    for bj, (k, dils) in enumerate(zip(kernel_sizes, dilation_sets)):
        xc = x0
        for i, d in enumerate(dils):
            y = rnd(F.leaky_relu(xc, LRELU_SLOPE))
            y = _conv_same(y, rnd(w1[bj, i]), b1[bj, i].to(f32), k, d)
            y = rnd(F.leaky_relu(y, LRELU_SLOPE))
            y = _conv_same(y, rnd(w2[bj, i]), b2[bj, i].to(f32), k, 1)
            xc = rnd(xc + y)
        acc = acc + xc
    return acc * (1.0 / len(kernel_sizes))


def mrf_window_plan(kernel_sizes: Tuple[int, ...],
                    dilation_sets: Tuple[Tuple[int, ...], ...], tile) -> list:
    """Rows of a T tile's window that each convolution has to compute, one
    dict per branch. ``tile`` is one tile size or one per branch.

    The float32 kernel runs a branch at a time; a block owns ``tile`` output
    rows of the branch and a window of ``rows = tile + 2 * halo`` rows around
    them, window row q being sequence row ``t0 - halo + q``. A branch with
    kernel size k and stage dilations d_s reaches ``halo = sum_s (k // 2) *
    (d_s + 1)`` rows to each side and loads x on the whole window. Each conv
    then gives up its own reach: conv 2s (dilation d_s) computes
    ``ranges[2s]``, conv 2s + 1 (dilation 1) ``ranges[2s + 1]``, each the
    range before it less ``(k // 2) * d`` rows on both sides; the last one is
    the tile itself, ``(halo, halo + tile)``. A conv reads only rows that the
    conv before it computed (or that were loaded from x), which keeps the
    stale values outside the ranges away from every kept row."""
    tiles = (tile,) * len(kernel_sizes) if isinstance(tile, int) else tuple(tile)
    if len(tiles) != len(kernel_sizes) or any(t < 1 for t in tiles):
        raise ValueError(f"one positive tile per branch is required, got {tile}")
    plan = []
    for k, ds, tl in zip(kernel_sizes, dilation_sets, tiles):
        halo = sum((k // 2) * (d + 1) for d in ds)
        rem, ranges = halo, []
        for d in ds:
            for reach in ((k // 2) * d, k // 2):
                rem -= reach
                ranges.append((halo - rem, halo + tl + rem))
        plan.append({"kernel_size": k, "tile": tl, "halo": halo, "rows": tl + 2 * halo,
                     "ranges": ranges})
    return plan


class MmaGeometry(NamedTuple):
    """The bfloat16 body (``mma.sync``): 8-column tiles per warp, 16-row
    tiles a warp may own in one conv, rows of a weight slice, blocks per SM,
    warps per block."""
    n_tiles: int
    row_tiles: int
    slice_rows: int
    blocks_per_sm: int
    n_warps: int


class WgmmaGeometry(NamedTuple):
    """The float32 body (``wgmma``): 64-row tiles a warpgroup may own in one
    conv, weight rows a ring slot holds (hi and lo planes), ring slots,
    blocks per SM, warpgroups per block."""
    row_tiles: int
    slice_rows: int
    slots: int
    blocks_per_sm: int
    warpgroups: int


# kernel geometry per type and channel count (csrc/mrf_stage.cu, MRF_LAUNCH_F32
# and MRF_LAUNCH)
_TC_GEOMETRY = {
    torch.float32: {16: WgmmaGeometry(4, 16, 6, 1, 4), 32: WgmmaGeometry(2, 32, 3, 1, 6),
                    64: WgmmaGeometry(1, 32, 2, 1, 6), 128: WgmmaGeometry(1, 16, 2, 1, 3)},
    torch.bfloat16: {16: MmaGeometry(2, 4, 16, 2, 8), 32: MmaGeometry(4, 4, 32, 2, 8),
                     64: MmaGeometry(8, 2, 64, 1, 16), 128: MmaGeometry(8, 2, 64, 1, 16)},
}
_SMEM_PER_SM = 228 * 1024       # H100; a block may use 227 KB, 1 KB is reserved per block
_RING_STAGES = 3                # the bfloat16 body's weight ring
_WG_ROWS = 64                   # rows of a wgmma tile
_BARRIER_BYTES = 128            # the float32 body's ring barriers, before the ring
TF32_MASK = -8192               # 0xffffe000: sign, exponent, top 10 mantissa bits


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _smem_layout(c: int, dtype: torch.dtype) -> Tuple[int, int]:
    """Shared memory of one block: bytes a window row takes in its two
    buffers (float32: xc and y, rows of C + 4; bfloat16: xc and the conv
    input, rows of C + 8), and bytes of the weight ring (float32: its
    barriers and slots of hi and lo planes)."""
    geo = _TC_GEOMETRY[dtype][c]
    if dtype == torch.bfloat16:
        return 2 * (c + 8) * 2, _RING_STAGES * geo.slice_rows * (c + 8) * 2
    return 2 * (c + 4) * 4, _BARRIER_BYTES + geo.slots * 2 * geo.slice_rows * c * 4


def block_smem(c: int, dtype: torch.dtype, rows: int) -> int:
    """Shared memory bytes of one block with a window of ``rows`` rows."""
    row_bytes, ring_bytes = _smem_layout(c, dtype)
    return rows * row_bytes + ring_bytes


def pass_rows(c: int, dtype: torch.dtype) -> int:
    """The longest range one conv may compute: one pass of the warps' row
    tiles (float32: the warpgroups' 64-row tiles), its accumulators in
    registers."""
    geo = _TC_GEOMETRY[dtype][c]
    if dtype == torch.bfloat16:
        return 16 * geo.row_tiles * (geo.n_warps // (c // (8 * geo.n_tiles)))
    return _WG_ROWS * geo.row_tiles * geo.warpgroups


def _branch_cost(branch: dict, c: int, dtype: torch.dtype) -> int:
    """The products a block makes for one branch, in tile steps. float32:
    every conv costs its taps times its 64-row tiles (the warpgroups share
    the SM's tensor cores); bfloat16: its taps times the 16-row tiles of the
    busiest warp."""
    geo = _TC_GEOMETRY[dtype][c]
    if dtype == torch.bfloat16:
        warps_m = geo.n_warps // (c // (8 * geo.n_tiles))
        return sum(branch["kernel_size"] * _ceil_div(_ceil_div(hi - lo, 16), warps_m)
                   for lo, hi in branch["ranges"])
    return sum(branch["kernel_size"] * _ceil_div(hi - lo, _WG_ROWS)
               for lo, hi in branch["ranges"])


@functools.lru_cache(maxsize=256)
def choose_mrf_tiles(c: int, b: int, t: int, kernel_sizes, dilation_sets,
                     n_sm: int, dtype: torch.dtype = torch.float32) -> Tuple[int, ...]:
    """The T tile of each branch of the ``dtype`` kernel for x [b, t, c] on a
    card of ``n_sm`` SMs: among the tiles whose window fits shared memory
    (:func:`block_smem`, ``blocks per SM`` blocks an SM) and whose first,
    longest range fits one pass of the warps (:func:`pass_rows`), the one with
    the least modelled time ``waves * cost of a block``."""
    blocks_per_sm = _TC_GEOMETRY[dtype][c].blocks_per_sm
    row_bytes, ring_bytes = _smem_layout(c, dtype)
    smem_rows = (_SMEM_PER_SM // blocks_per_sm - 1024 - ring_bytes) // row_bytes
    tiles = []
    for k, ds in zip(kernel_sizes, dilation_sets):
        halo = mrf_window_plan((k,), (ds,), 1)[0]["halo"]
        # the first conv computes rows - 2 * its reach
        max_rows = min(smem_rows, pass_rows(c, dtype) + 2 * (k // 2) * ds[0])
        if max_rows - 2 * halo < 1:
            raise ValueError(f"mrf_stage: a halo of {halo} rows leaves no tile at C={c}")
        best, best_time = None, None
        for tile in range(1, min(max_rows - 2 * halo, t) + 1):
            waves = _ceil_div(b * _ceil_div(t, tile), n_sm * blocks_per_sm)
            time = waves * _branch_cost(mrf_window_plan((k,), (ds,), tile)[0], c, dtype)
            if best_time is None or time <= best_time:
                best, best_time = tile, time
        tiles.append(best)
    return tuple(tiles)


def split_tf32(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 3xTF32 split of float32 ``a`` as ``csrc/mma_sm90.cuh:split_tf32``
    makes it: hi keeps the sign, the exponent and the top 10 mantissa bits,
    lo is the remainder ``a - hi`` (exact in float32) cut the same way."""
    hi = (a.view(torch.int32) & TF32_MASK).view(torch.float32)
    lo = ((a - hi).view(torch.int32) & TF32_MASK).view(torch.float32)
    return hi, lo


def weight_planes(w: torch.Tensor) -> torch.Tensor:
    """Packed weights ``w`` [n_branch, n_stage, k_max*C, C] split once for the
    float32 body: [n_branch, n_stage, k_max, C / KS, 2, C / 8, KS / 4, 8, 4],
    per tap and slice of KS input rows (the ring slot's) the hi plane, then
    the lo plane. A plane is the slice's B operand, K-major as ``wgmma``
    takes TF32: [C_out][C_in] in core matrices of 8 output columns by 4 input
    rows (16 bytes), output groups of 8 outer; element (C_in kk, C_out n) of
    the slice at ((n // 8 * KS / 4 + kk // 4) * 8 + n % 8) * 4 + kk % 4."""
    nb, ns, rows, c = w.shape
    ks = _TC_GEOMETRY[torch.float32][c].slice_rows
    v = w.detach().to(torch.float32).reshape(nb, ns, rows // c, c // ks, ks // 4, 4, c // 8, 8)
    hi, lo = split_tf32(v.permute(0, 1, 2, 3, 6, 4, 7, 5).contiguous())
    return torch.stack((hi, lo), dim=4)


def _planes_of(w: torch.Tensor) -> torch.Tensor:
    """:func:`weight_planes` of ``w``, made once and kept on the tensor
    itself: made anew only when ``w``'s storage or version changes."""
    key = (w.data_ptr(), w.device, None if w.is_inference() else w._version)
    kept = getattr(w, "_mrf_planes", None)
    if kept is None or kept[0] != key:
        kept = (key, weight_planes(w))
        w._mrf_planes = kept
    return kept[1]


@functools.lru_cache(maxsize=256)
def _launch_plan(kernel_sizes, dilation_sets, tiles):
    """ctypes arrays of a launch: kernel sizes, dilations and the window plan
    flattened as csrc/mrf_stage.cu:mrf_stage_run reads it (per branch: tile,
    rows, halo, then a (lo, hi) pair per conv)."""
    nb, ns = len(kernel_sizes), len(dilation_sets[0])
    flat = []
    for br in mrf_window_plan(kernel_sizes, dilation_sets, tiles):
        flat += [br["tile"], br["rows"], br["halo"]] + [v for r in br["ranges"] for v in r]
    return ((ctypes.c_int * nb)(*kernel_sizes),
            (ctypes.c_int * (nb * ns))(*[d for ds in dilation_sets for d in ds]),
            (ctypes.c_int * len(flat))(*flat))


def _launch_args(shape, kernel_sizes, dilation_sets, dtype: torch.dtype, n_sm: int):
    """The plan arguments of ``mrf_stage_run`` for x of ``shape`` [B, T, C]
    in ``dtype`` on a card of ``n_sm`` SMs: (ks, dils, win) of the tiles
    :func:`choose_mrf_tiles` picks for that body."""
    b, t, c = shape
    tiles = choose_mrf_tiles(c, b, t, kernel_sizes, dilation_sets, n_sm, dtype)
    return _launch_plan(kernel_sizes, dilation_sets, tiles)


@functools.lru_cache(maxsize=256)
def conv_rows(shape, kernel_sizes, dilation_sets, n_sm: int) -> Tuple[int, int]:
    """Rows the float32 body computes for x of ``shape`` [B, T, C], over
    every branch, block and conv, each range rounded up to 64-row tiles; and
    the rows the scale needs, B * T a conv. Their ratio is the recompute the
    window plan pays: the halo and the rounding."""
    b, t, c = shape
    tiles = choose_mrf_tiles(c, b, t, kernel_sizes, dilation_sets, n_sm)
    done = sum(b * _ceil_div(t, br["tile"])
               * sum(_WG_ROWS * _ceil_div(hi - lo, _WG_ROWS) for lo, hi in br["ranges"])
               for br in mrf_window_plan(kernel_sizes, dilation_sets, tiles))
    return done, sum(2 * len(ds) for ds in dilation_sets) * b * t


@functools.lru_cache(maxsize=None)
def _entry():
    fn = load_library("mrf_stage").mrf_stage_run
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_int)] * 3 + [ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(x, w1, b1, w2, b2, kernel_sizes, dilation_sets, compute_dtype):
    dt = compute_dtype or torch.float32
    b, t, c = x.shape
    nb, ns = len(kernel_sizes), len(dilation_sets[0])
    k_max = max(kernel_sizes)
    if c not in KERNEL_CHANNELS:
        raise ValueError(f"mrf_stage kernel takes C in {KERNEL_CHANNELS}, got {c}")
    if dt not in _DTYPE_CODE:
        raise ValueError(f"mrf_stage kernel takes float32 or bfloat16, got {dt}")
    if any(len(ds) != ns for ds in dilation_sets) or nb > 4 or ns > 4:
        raise ValueError("mrf_stage kernel takes up to 4 branches of equal depth <= 4")
    if any(k % 2 == 0 for k in kernel_sizes):
        raise ValueError(f"mrf_stage kernel takes odd kernel sizes, got {kernel_sizes}")
    for name, a, shape in (("w1", w1, (nb, ns, k_max * c, c)), ("w2", w2, (nb, ns, k_max * c, c)),
                           ("b1", b1, (nb, ns, c)), ("b2", b2, (nb, ns, c))):
        if tuple(a.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(a.shape)}")
        if a.device != x.device:
            raise ValueError(f"{name} is on {a.device}, x on {x.device}")
    xin = x.to(dt).contiguous()
    if dt == torch.float32:
        w1c, w2c = _planes_of(w1), _planes_of(w2)
    else:
        w1c, w2c = w1.to(dt).contiguous(), w2.to(dt).contiguous()
    b1c, b2c = b1.to(torch.float32).contiguous(), b2.to(torch.float32).contiguous()
    # the kernel reads x, w1, w2 in 16-byte pieces and the biases in 8
    for name, a, align in (("x", xin, 16), ("w1", w1c, 16), ("w2", w2c, 16), ("b1", b1c, 8),
                           ("b2", b2c, 8)):
        if a.data_ptr() % align:
            raise ValueError(f"mrf_stage kernel needs {name} aligned to {align} bytes")
    out = torch.empty((b, t, c), dtype=torch.float32, device=x.device)
    n_sm = _sm_count(x.device.index or 0)
    ks, dils, win = _launch_args((b, t, c), kernel_sizes, dilation_sets, dt, n_sm)
    if dt == torch.float32:
        done, needed = conv_rows((b, t, c), kernel_sizes, dilation_sets, n_sm)
        trace.count("ds.mrf.conv_rows", done)
        trace.count("ds.mrf.out_rows", needed)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _entry()(_DTYPE_CODE[dt], xin.data_ptr(), w1c.data_ptr(), b1c.data_ptr(),
                   w2c.data_ptr(), b2c.data_ptr(), out.data_ptr(), b, t, c, nb, ns, k_max,
                   ks, dils, win, stream)
    check(err, "mrf_stage")
    return out


def mrf_stage(x, w1, b1, w2, b2, *, kernel_sizes: Tuple[int, ...],
              dilation_sets: Tuple[Tuple[int, ...], ...],
              compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One whole MRF scale. CUDA tensors launch the hand-written kernel (and
    count the launch in ``mrf_stage.launches``); CPU tensors take the plain
    twin."""
    kernel_sizes = tuple(int(k) for k in kernel_sizes)
    dilation_sets = tuple(tuple(int(d) for d in ds) for ds in dilation_sets)
    if x.device.type == "cpu":
        return mrf_stage_plain(x, w1, b1, w2, b2, kernel_sizes=kernel_sizes,
                               dilation_sets=dilation_sets,
                               compute_dtype=compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"mrf_stage runs on cuda or cpu, not {x.device}")
    out = _launch(x, w1, b1, w2, b2, kernel_sizes, dilation_sets, compute_dtype)
    mrf_stage.launches += 1
    return out


mrf_stage.launches = 0


def pack_mrf_params(generator, stage_idx: int):
    """Stack one scale's resblock conv weights into the kernel layout:
    (w1, b1, w2, b2), w* [n_branch, n_stage, k_max*C, C], b* [n_branch,
    n_stage, C]. Torch conv weights [out, in, k] become tap-major [k*C, C]."""
    cfg = generator.cfg
    ks = cfg.resblock_kernel_sizes
    nb, k_max = len(ks), max(ks)

    def pack_w(conv, k):
        w = conv.weight.permute(2, 1, 0).reshape(k * conv.weight.shape[1], -1)
        return F.pad(w, (0, 0, 0, (k_max - k) * w.shape[1]))

    w1b, b1b, w2b, b2b = [], [], [], []
    for j, k in enumerate(ks):
        rb = generator.resblocks[stage_idx * nb + j]
        w1b.append(torch.stack([pack_w(cv, k) for cv in rb.convs1]))
        w2b.append(torch.stack([pack_w(cv, k) for cv in rb.convs2]))
        b1b.append(torch.stack([cv.bias for cv in rb.convs1]))
        b2b.append(torch.stack([cv.bias for cv in rb.convs2]))
    return (torch.stack(w1b), torch.stack(b1b), torch.stack(w2b), torch.stack(b2b))


def pack_mrf_scales(generator) -> list:
    """``pack_mrf_params`` for every scale the kernel runs (at most 128
    channels of ResBlock1 chains), ``None`` for the others (the wider scales,
    and every scale of a ``resblock: '2'`` generator, whose single-conv
    blocks the kernel does not compute); detached, for reuse across calls.
    For a float32 generator each scale's w1 and w2 also carry their
    :func:`weight_planes`, which ``mrf_stage`` then finds made."""
    cfg = generator.cfg
    c0 = cfg.upsample_initial_channel
    with torch.no_grad():
        packed = [pack_mrf_params(generator, i)
                  if cfg.resblock == "1" and c0 // 2 ** (i + 1) <= 128 else None
                  for i in range(len(cfg.upsample_rates))]
        if cfg.dtype is None:       # the float32 body's weights, split once here
            for scale in packed:
                if scale is not None and scale[0].shape[-1] in KERNEL_CHANNELS:
                    _planes_of(scale[0])
                    _planes_of(scale[2])
    return packed


def hifigan_mrf_apply(generator, mel: torch.Tensor, packed: Optional[list] = None,
                      f0: Optional[torch.Tensor] = None,
                      rand_ini: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """HiFiGAN forward with the fused MRF kernel on every scale of at most 128
    channels (counterpart of ``hifigan_mrf_apply``). conv_pre, the upsamples,
    the NSF source and its noise convs, conv_post and the wider scales run as
    plain convolutions, as the JAX package leaves them to XLA. A bf16
    generator (``vocoder_compute_dtype: bfloat16``) rounds as the JAX path
    does: its convs run in bf16 and the kernel takes each scale's input back
    in float32, computes in bf16 with float32 accumulation and returns
    float32. ``packed`` is
    :func:`pack_mrf_scales` of the generator, packed now when not given.
    mel [B, T, M] -> wav [B, T * hop]. An NSF generator given ``f0`` [B, T]
    also takes the source draws ``rand_ini`` [B, 1, 9] and ``noise``
    [B, T * hop, 9]; its harmonic source enters each scale after the upsample,
    before the MRF."""
    cfg = generator.cfg
    ks = cfg.resblock_kernel_sizes
    ds = tuple(tuple(d) for d in cfg.resblock_dilation_sizes)
    if packed is None:
        packed = pack_mrf_scales(generator)
    har_source = None
    if cfg.use_pitch_embed and f0 is not None:
        har_source = generator.source(f0, rand_ini, noise)
    x = generator.pre(mel)
    for i in range(len(cfg.upsample_rates)):
        x = generator.upsample(x, i)
        if har_source is not None:
            x = generator.add_source(x, har_source, i)
        if packed[i] is not None:
            x = mrf_stage(x.to(torch.float32), *packed[i], kernel_sizes=ks, dilation_sets=ds,
                          compute_dtype=cfg.dtype)
        else:
            x = generator.mrf(x, i)
    return generator.post(x)
