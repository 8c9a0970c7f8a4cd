"""Fused DiffNet residual stack: CUDA kernel wrapper, plain twin, packing.

Counterpart of diffsinger_tpu/ops/diffnet_stack.py. The kernel
(``csrc/diffnet_stack.cu``) replaces the Pallas TPU kernel ``diffnet_stack``
(pallas_call at diffsinger_tpu/ops/diffnet_stack.py:311). Its source note
states what bounds it on the H100 and how the design answers that.

Layouts: x0 [B, T, C] f32; step_proj [L, B, C] f32; cond_proj [L, B, T, 2C];
w_dil [L, 3, C, 2C]; b_dil [L, 2C] f32; w_out [L, C, 2C]; b_out [L, 2C] f32.
Output: the skip sum [B, T, C] f32 (before the 1/sqrt(L) scale).

``compute_dtype=torch.bfloat16`` gives bf16 GEMM inputs (cond, weights, the
conv input y and the gate g) with f32 accumulation, the same cast points as
the JAX kernel; ``None`` keeps everything float32. No shipped config sets
``compute_dtype``, so the shipped configs (LJ serving and ``--infer``: 71
calls a request; singing: 26) run the float32 body.

Which body a CUDA call runs is decided here, by shape
(:func:`takes_tensor_cores`): float32 or bfloat16 at C = 128 or 256, and
float32 at C = 512, with every dilation up to 16 takes the tensor-core
bodies (one launch a layer, ``x0`` untouched; float32 products as 3xTF32:
``mma.sync`` at C <= 256, ``wgmma`` at C = 512 on the weights
:func:`wg_weights` packs once), float32 at any other shape (C % 32 == 0)
takes the SIMT body (two launches a layer); bfloat16 outside the rule, and
every other type, raises. Neither ever reaches the plain twin.
The library reports what it launched: ``diffnet_stack.device_launches``,
``.ran_tensor_cores``, ``.body`` (a name of :data:`BODIES`) and
``.column_split`` hold the last CUDA call's, ``.launches_by_body`` counts the
calls by body, and :func:`tensor_core_info` gives its tile rows and shared
memory for a shape.

The grid of the float32 tensor-core bodies. A block owns 64 rows of one batch
row and runs alone on its SM (255 registers a thread), so a
layer launches ``ceil(T/64)·B`` blocks and takes as long as one block: on the
H100's 132 SMs a B = 1 singing phrase of 1,152 frames fills 18, and a batch of
160 tiles runs a second wave 28 blocks full. So each 64-row tile's output
columns are split over a thread-block cluster of k blocks: block j computes
gate and filter columns ``[jC/k, (j+1)C/k)`` (streaming 1/k of the layer's
weights), hands its slice of g to the others through distributed shared
memory, and computes the same 1/k of the residual and skip columns. k = 1 is
the unsplit body; C = 512 has none (its tile does not fit one block) and
runs k = 2 or 4. :func:`column_split` picks k from the shape and what the
card holds at once (``cudaOccupancyMaxActiveClusters`` of each instance, read
once per width and largest dilation; none for an instance whose tiles do not
fit at that dilation): the k of :func:`splits_for` with the fewest
``ceil(tiles / resident(k)) · (1 + SPLIT_COST[C][k]) / k`` wave-units, the
smaller k on a tie. No argument, hparam or environment variable sets k.

Each float32 tensor-core call counts, while a profiler records
(``utils/trace.py:count``), its tiles (``ds.stack.tiles``, ``ceil(T/64)·B``)
and the slots of the waves the rule's k gives them (``ds.stack.slots``,
``ceil(tiles / resident(k)) · resident(k)``): their ratio is how full the
card's waves were.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from diffsinger_tpu_torch.ops._build import check, load_library
from diffsinger_tpu_torch.utils import trace

SQRT_HALF = 0.5 ** 0.5
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _shift_t(arr: torch.Tensor, offset: int) -> torch.Tensor:
    """Shift [B, T, C] along T with zero fill: out[:, t] = arr[:, t + offset]."""
    if offset == 0:
        return arr
    if abs(offset) >= arr.shape[1]:
        return torch.zeros_like(arr)
    if offset > 0:
        return F.pad(arr[:, offset:], (0, 0, 0, offset))
    return F.pad(arr[:, :offset], (0, 0, -offset, 0))


def diffnet_stack_plain(x0, step_proj, cond_proj, w_dil, b_dil, w_out, b_out, *,
                        dilations: Sequence[int],
                        compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The kernel's math in plain PyTorch (twin of the JAX ``_stack_xla``).

    Values are rounded to ``compute_dtype`` where the kernel rounds them and
    multiplied in float32, which is exact for bf16 products, so the twin has
    the kernel's "bf16 inputs, f32 accumulation" numerics on any device."""
    f32 = torch.float32

    def rnd(a):
        return a.to(compute_dtype).to(f32) if compute_dtype is not None else a.to(f32)

    x = x0.to(f32)
    skips = torch.zeros_like(x)
    for i, d in enumerate(dilations):
        y = rnd(x + step_proj[i][:, None, :].to(f32))
        w = rnd(w_dil[i])
        conv = (_shift_t(y, -d) @ w[0] + y @ w[1] + _shift_t(y, d) @ w[2]
                + b_dil[i].to(f32) + rnd(cond_proj[i]))
        gate, filt = conv.chunk(2, dim=-1)
        g = rnd(torch.sigmoid(gate) * torch.tanh(filt))
        out = g @ rnd(w_out[i]) + b_out[i].to(f32)
        residual, skip = out.chunk(2, dim=-1)
        x = (x + residual) * SQRT_HALF
        skips = skips + skip
    return skips


TC_CHANNELS = (128, 256)   # widths both types' tensor-core bodies are built for
TC32_CHANNELS = TC_CHANNELS + (512,)   # ... and the float32 body's
TC_MAX_DILATION = 16       # the widest halo their tiles hold in a block's shared memory
WG_CHANNELS = 512          # the float32 width whose body is on wgmma (the others: mma.sync)
# the library's report of a call's body: 0 SIMT, 1 tensor cores by mma.sync, 2 by wgmma
BODIES = ("simt", "mma_sync", "wgmma")
TILE_ROWS = 64             # rows of one batch row a block (or a cluster) owns
# By width, the splits the float32 body is built for and what a k-split tile
# costs beyond k0/k of a tile at the width's smallest split k0, as a share of
# that: every block of a cluster stages the whole y tile, runs the launch's
# fixed latency, and exchanges g. Measured where every k runs one wave
# (tools/stack_split.py; H100 80GB HBM3, 700 W). C = 256: 1 x 1152, 1 x 256,
# 4 x 384 read 0.07-0.11 at k = 2 and 0.37-0.39 at k = 4; without the cost
# the rule would take k = 4 for 67-90 tiles (3 waves of 30 clusters), which
# read 0.4-2.2% slower than one unsplit wave (1 x 4800, 3 x 1600, 5 x 1088).
# C = 512 (no unsplit body; k0 = 2), the wgmma body: 1 x 128, 1 x 384,
# 1 x 432, 2 x 384, 2 x 896, 1 x 1024, 1 x 1152 at cycle 4 read 0.35-0.37 at
# k = 4 (its products take half the time the mma.sync body's took, its
# y tile and g exchange as long), so k = 4 takes only what one wave of 30
# clusters holds.
SPLIT_COST = {256: {1: 0.0, 2: 0.09, 4: 0.38}, 512: {2: 0.0, 4: 0.36}}


def takes_tensor_cores(c: int, dilations: Sequence[int],
                       compute_dtype: Optional[torch.dtype]) -> bool:
    """The dispatch rule: float32 (``None``) at C in :data:`TC32_CHANNELS`
    or bfloat16 at C in :data:`TC_CHANNELS`, every dilation in [1, 16], go to
    the tensor-core bodies. The library holds the same rule and refuses a
    call outside it."""
    dt = compute_dtype or torch.float32
    return (dt in _DTYPE_CODE and c in (TC32_CHANNELS if dt == torch.float32 else TC_CHANNELS)
            and 1 <= min(int(d) for d in dilations)
            and max(int(d) for d in dilations) <= TC_MAX_DILATION)


def splits_for(c: int) -> Tuple[int, ...]:
    """The column splits the float32 body is built for at width ``c``: those
    :data:`SPLIT_COST` was measured at, at C = 256 (1, 2, 4) and C = 512
    (2, 4: no unsplit body; a warp keeps whole 8-column ``mma`` tiles of each
    half up to k = 4); other widths stay unsplit. The library's
    ``split_takes`` names the same."""
    return tuple(SPLIT_COST.get(c, (1,)))


def column_split(b: int, t: int, c: int, resident: Dict[int, int]) -> int:
    """The split rule: the k of :func:`splits_for` that runs the call's
    ``ceil(t / 64) · b`` tiles in the fewest wave-units, where a wave is
    ``resident[k]`` tiles at once (clusters of k blocks, one block an SM)
    and lasts ``(1 + SPLIT_COST[c][k]) / k`` of a block at the width's
    smallest split; the smaller k on a tie. A k the card holds no cluster of
    is never taken; with none at all, the width's smallest split."""
    tiles = -(-t // TILE_ROWS) * b
    cost = SPLIT_COST.get(c, {1: 0.0})
    best, best_units = splits_for(c)[0], None
    for k in cost:
        if resident.get(k, 0) < 1:
            continue
        units = -(-tiles // resident[k]) * (1.0 + cost[k]) / k
        if best_units is None or units < best_units:
            best, best_units = k, units
    return best


def _body(c: int, dilations: Sequence[int], compute_dtype: Optional[torch.dtype]) -> int:
    """The body a CUDA call runs (1: tensor cores, 0: SIMT), or raises for a
    shape no body takes."""
    dt = compute_dtype or torch.float32
    if dt not in _DTYPE_CODE:
        raise ValueError(f"diffnet_stack kernel takes float32 or bfloat16, got {dt}")
    if min(int(d) for d in dilations) < 1:
        raise ValueError(f"dilations must be positive, got {tuple(dilations)}")
    if takes_tensor_cores(c, dilations, compute_dtype):
        return 1
    if dt == torch.bfloat16:
        raise ValueError(f"diffnet_stack bfloat16 kernel takes C in {TC_CHANNELS} and "
                         f"dilations up to {TC_MAX_DILATION}, got C={c}, "
                         f"dilations {tuple(dilations)}")
    if c % 32:
        raise ValueError(f"diffnet_stack kernel needs C % 32 == 0, got C={c}")
    return 0


@functools.lru_cache(maxsize=None)
def _entry():
    fn = load_library("diffnet_stack").diffnet_stack_run
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 9
                   + [ctypes.c_int] * 4
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
                      ctypes.POINTER(ctypes.c_int)])
    return fn


@functools.lru_cache(maxsize=None)
def _resident(c: int, dmax: int, device: int) -> Dict[int, int]:
    """Tiles the float32 body holds at once on the card, by split (the
    library's ``diffnet_stack_resident``; 0 for a split whose tiles do not
    fit a block at ``dmax``); read once per width, largest dilation and
    device."""
    fn = load_library("diffnet_stack").diffnet_stack_resident
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 1)()
    counts = {}
    with torch.cuda.device(device):
        for k in splits_for(c):
            check(fn(c, dmax, k, out), f"diffnet_stack_resident (split {k})")
            counts[k] = out[0]
    return counts


def tensor_core_info(c: int, dilations: Sequence[int],
                     compute_dtype: Optional[torch.dtype]) -> Optional[dict]:
    """What the built library says of these shapes: None when its tensor-core
    bodies do not take them, else the rows a block owns and the shared memory
    (bytes) a block takes at the largest dilation (float32: of the width's
    smallest split whose tiles fit). Needs the built library, so it runs on
    the card's machine."""
    info = load_library("diffnet_stack").diffnet_stack_tc_info
    info.restype = ctypes.c_int
    info.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 2)()
    code = _DTYPE_CODE.get(compute_dtype or torch.float32, -1)
    if not info(code, c, max(int(d) for d in dilations), out):
        return None
    return {"tile_rows": out[0], "smem": out[1]}


@functools.lru_cache(maxsize=64)
def _dilation_array(dilations: Tuple[int, ...]):
    return (ctypes.c_int * len(dilations))(*dilations)


def wg_weights(w_dil: torch.Tensor, w_out: torch.Tensor) -> torch.Tensor:
    """The float32 weights of the C = 512 body packed for its ring:
    [L, 4C/8, C/64, 2, 8, 2, 8, 4]. Per layer the 4C contraction rows of
    [w_dil (3C rows, tap-major); w_out (C rows)] in 8-row steps; a step's 2C
    columns in C/64 units (unit u: gate or residual columns [64u, 64u + 64),
    then filter or skip columns C + [64u, 64u + 64)); a unit's 128 columns
    K-major as ``wgmma`` takes TF32 B, in core matrices of 8 columns by 4
    rows: element (row k, column n) of a unit's step at
    ((n // 8) * 2 + k // 4) * 32 + (n % 8) * 4 + k % 4. One float32 plane,
    the same bytes as the two tensors: the body splits it into hi and lo in
    shared memory (``csrc/diffnet_stack.cu:stack_layer_wg``)."""
    num_layers, _, c, c2 = w_dil.shape
    out = torch.empty((num_layers, 4 * c // 8, c // 64, 2, 8, 2, 8, 4), dtype=torch.float32,
                      device=w_dil.device)
    for w, steps in ((w_dil.reshape(num_layers, 3 * c, c2), slice(0, 3 * c // 8)),
                     (w_out, slice(3 * c // 8, 4 * c // 8))):
        v = w.detach().to(torch.float32).reshape(num_layers, -1, 2, 4, 2, c // 64, 8, 8)
        out[:, steps].copy_(v.permute(0, 1, 5, 4, 6, 2, 7, 3))
    return out


def _wg_weights_of(w_dil: torch.Tensor, w_out: torch.Tensor) -> torch.Tensor:
    """:func:`wg_weights` of the pair, made once and kept on ``w_dil``: made
    anew only when either tensor's storage or version changes (the sampler
    packs its weights once a call, and its 101 or so stack calls share them)."""
    key = tuple((w.data_ptr(), w.device, None if w.is_inference() else w._version)
                for w in (w_dil, w_out))
    kept = getattr(w_dil, "_wg_weights", None)
    if kept is None or kept[0] != key:
        kept = (key, wg_weights(w_dil, w_out))
        w_dil._wg_weights = kept
    return kept[1]


def _launch(x0, step_proj, cond_proj, w_dil, b_dil, w_out, b_out, dilations,
            compute_dtype) -> torch.Tensor:
    dt = compute_dtype or torch.float32
    b, t, c = x0.shape
    num_layers = w_dil.shape[0]
    path = _body(c, dilations, compute_dtype)
    expect = {"step_proj": (num_layers, b, c), "cond_proj": (num_layers, b, t, 2 * c),
              "w_dil": (num_layers, 3, c, 2 * c), "b_dil": (num_layers, 2 * c),
              "w_out": (num_layers, c, 2 * c), "b_out": (num_layers, 2 * c)}
    args = dict(step_proj=step_proj, cond_proj=cond_proj, w_dil=w_dil, b_dil=b_dil,
                w_out=w_out, b_out=b_out)
    for k, shape in expect.items():
        if tuple(args[k].shape) != shape:
            raise ValueError(f"{k}: expected {shape}, got {tuple(args[k].shape)}")
        if args[k].device != x0.device:
            raise ValueError(f"{k} is on {args[k].device}, x0 on {x0.device}")
    x = x0.to(torch.float32).contiguous()
    if path:
        # the kernel reads x0 and alternates between two buffers of its own;
        # layer 0 writes skip, so it needs no zeros
        skip = torch.empty_like(x)
        scratch = torch.empty((2, b * t, c), dtype=torch.float32, device=x.device)
    else:
        x = x.clone()           # updated in place
        skip = torch.zeros_like(x)
        scratch = torch.empty((b * t, c), dtype=dt, device=x.device)   # g
    step = step_proj.to(torch.float32).contiguous()
    cond = cond_proj.to(dt).contiguous()
    if path and dt == torch.float32 and c == WG_CHANNELS:
        wd = wo = _wg_weights_of(w_dil, w_out)   # the library reads only w_dil then
    else:
        wd, wo = w_dil.to(dt).contiguous(), w_out.to(dt).contiguous()
    bd, bo = b_dil.to(torch.float32).contiguous(), b_out.to(torch.float32).contiguous()
    dil = _dilation_array(tuple(int(d) for d in dilations))
    split = 1
    if path and dt == torch.float32:
        dmax = max(int(d) for d in dilations)
        resident = _resident(c, dmax, x.device.index)
        split = column_split(b, t, c, resident)
        tiles, per_wave = -(-t // TILE_ROWS) * b, resident.get(split) or 1
        trace.count("ds.stack.tiles", tiles)
        trace.count("ds.stack.slots", -(-tiles // per_wave) * per_wave)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    report = (ctypes.c_int * 3)()
    err = _entry()(path, _DTYPE_CODE[dt], split, x.data_ptr(), skip.data_ptr(),
                   scratch.data_ptr(), step.data_ptr(), cond.data_ptr(), wd.data_ptr(),
                   bd.data_ptr(), wo.data_ptr(), bo.data_ptr(), b, t, c, num_layers, dil,
                   stream, report)
    check(err, "diffnet_stack")
    diffnet_stack.device_launches, diffnet_stack.ran_tensor_cores = report[0], bool(report[1])
    diffnet_stack.column_split = report[2]
    body = BODIES[report[1]]
    diffnet_stack.body = body
    diffnet_stack.launches_by_body[body] = diffnet_stack.launches_by_body.get(body, 0) + 1
    return skip


def diffnet_stack(x0, step_proj, cond_proj, w_dil, b_dil, w_out, b_out, *,
                  dilations: Sequence[int],
                  compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Run the whole residual stack; returns the skip sum [B, T, C] f32.

    CUDA tensors launch the hand-written kernel of the body
    :func:`takes_tensor_cores` names (and count the call in
    ``diffnet_stack.launches``); CPU tensors take the plain twin."""
    if len(dilations) != w_dil.shape[0]:
        raise ValueError("one dilation per layer is required")
    if x0.device.type == "cpu":
        return diffnet_stack_plain(x0, step_proj, cond_proj, w_dil, b_dil, w_out,
                                   b_out, dilations=dilations,
                                   compute_dtype=compute_dtype)
    if x0.device.type != "cuda":
        raise ValueError(f"diffnet_stack runs on cuda or cpu, not {x0.device}")
    out = _launch(x0, step_proj, cond_proj, w_dil, b_dil, w_out, b_out, dilations,
                  compute_dtype)
    diffnet_stack.launches += 1
    return out


diffnet_stack.launches = 0             # calls that launched kernels
diffnet_stack.device_launches = None   # kernels the library launched in the last such call
diffnet_stack.ran_tensor_cores = None  # whether that call ran a tensor-core body
diffnet_stack.body = None              # which body that call ran (a name of BODIES)
diffnet_stack.launches_by_body = {}    # CUDA calls by the body the library reported
diffnet_stack.column_split = None      # the column split k that call ran (1: unsplit)


# ---------------------------------------------------------------------------
# packing around the kernel (hoisted out of the reverse loop by the task)
# ---------------------------------------------------------------------------
def precompute_cond_packed(denoiser, cond: torch.Tensor,
                           compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """All L conditioner projections as one matmul: cond [B, T, H] ->
    [L, B, T, 2C]. The cast comes before the transpose, as in JAX."""
    layers = denoiser.residual_layers
    ks = torch.cat([ly.conditioner_projection.weight[..., 0].t() for ly in layers],
                   dim=-1)                                      # [H, L*2C]
    bs = torch.cat([ly.conditioner_projection.bias for ly in layers])
    b, t, _ = cond.shape
    out = cond @ ks + bs
    if compute_dtype is not None:
        out = out.to(compute_dtype)
    return out.reshape(b, t, len(layers), -1).permute(2, 0, 1, 3).contiguous()


def pack_diffnet_params(denoiser):
    """Per-layer weights in the kernel's layout: (w_dil [L,3,C,2C], b_dil,
    w_out [L,C,2C], b_out). Torch conv weights are [out, in, k]."""
    layers = denoiser.residual_layers
    w_dil = torch.stack([ly.dilated_conv.weight.permute(2, 1, 0) for ly in layers])
    b_dil = torch.stack([ly.dilated_conv.bias for ly in layers])
    w_out = torch.stack([ly.output_projection.weight[..., 0].t() for ly in layers])
    b_out = torch.stack([ly.output_projection.bias for ly in layers])
    return (w_dil.contiguous(), b_dil.contiguous(), w_out.contiguous(),
            b_out.contiguous())


def pack_step_params(denoiser):
    """All L step projections as one matmul: (w_step [C, L*C], b_step [L*C])."""
    layers = denoiser.residual_layers
    w_step = torch.cat([ly.diffusion_projection.weight.t() for ly in layers], dim=-1)
    b_step = torch.cat([ly.diffusion_projection.bias for ly in layers])
    return w_step, b_step


def pack_sampling_ctx(denoiser, cond_proj: torch.Tensor,
                      compute_dtype: Optional[torch.dtype] = None) -> dict:
    """Pack weights (and the hoisted cond projections) once per sampler call,
    cast to ``compute_dtype`` when given."""
    w_dil, b_dil, w_out, b_out = pack_diffnet_params(denoiser)
    if compute_dtype is not None:
        w_dil, w_out = w_dil.to(compute_dtype), w_out.to(compute_dtype)
        cond_proj = cond_proj.to(compute_dtype)
    w_step, b_step = pack_step_params(denoiser)
    return {"cond_proj": cond_proj, "w_dil": w_dil, "b_dil": b_dil, "w_out": w_out,
            "b_out": b_out, "w_step": w_step, "b_step": b_step}


def diffnet_forward(denoiser, spec: torch.Tensor, t: torch.Tensor, cond_proj, *,
                    compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """DiffNet forward with the fused stack (counterpart of
    ``diffnet_forward_pallas``). ``cond_proj`` is the raw [L, B, T, 2C]
    projections or a :func:`pack_sampling_ctx` dict. The input, step, skip and
    output projections run in float32 outside the kernel."""
    from diffsinger_tpu_torch.models.diffnet import pointwise, timestep_embedding

    num_layers = denoiser.num_layers
    x0 = torch.relu(pointwise(spec, denoiser.input_projection))
    step = denoiser.mlp(timestep_embedding(t, denoiser.residual_channels))
    ctx = cond_proj if isinstance(cond_proj, dict) else pack_sampling_ctx(denoiser,
                                                                          cond_proj)
    step_proj = (step @ ctx["w_step"] + ctx["b_step"]).reshape(
        step.shape[0], num_layers, -1).transpose(0, 1)
    skips = diffnet_stack(x0, step_proj, ctx["cond_proj"], ctx["w_dil"], ctx["b_dil"],
                          ctx["w_out"], ctx["b_out"], dilations=denoiser.dilations,
                          compute_dtype=compute_dtype)
    x = torch.relu(pointwise(skips * (num_layers ** -0.5), denoiser.skip_projection))
    return pointwise(x, denoiser.output_projection)
