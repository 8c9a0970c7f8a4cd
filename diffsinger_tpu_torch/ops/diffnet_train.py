"""Fused DiffNet stack for training: CUDA kernels, plain twins, autograd.

Counterpart of diffsinger_tpu/ops/diffnet_train.py. Two hand-written kernels
(``csrc/diffnet_train.cu``) replace its two Pallas TPU kernels: the forward
``_fwd_call`` (pallas_call at diffsinger_tpu/ops/diffnet_train.py:315) and
the backward ``_bwd_call`` (:389). Their source note states what bounds them
on the H100 and how the design answers that.

Layouts: x0 [B, T, C] f32; step_proj [L, B, C] f32; cond [B, T, H];
k_cond [L, H, 2C]; b_cond [L, 2C]; w_dil [L, 3, C, 2C]; b_dil [L, 2C];
w_out [L, C, 2C]; b_out [L, 2C]. The forward returns the skip sum
[B, T, C] f32 (before the 1/sqrt(L) scale) and each layer's input
``xs`` [L, B, T, C], saved in the compute dtype.

``compute_dtype=torch.bfloat16`` rounds cond, the weights, the conv input y,
the gate g, ``dout = [dx * sqrt(1/2), dskip]`` and ``dconv`` to bf16 before
each product and sums in float32, at the JAX kernels' cast points. The JAX
backward writes weight gradients per batch tile in bf16 and rounds dcond to
bf16 to fit VMEM; here both stay float32.

``diffnet_train_stack`` is the differentiable entry: an autograd function
whose forward and backward call ``diffnet_train_fwd`` / ``diffnet_train_bwd``.
Each of those launches its kernels for CUDA tensors (counted in
``.launches``, one a call; ``.device_launches`` and ``.ran_tensor_cores``
hold what the library counted and ran in the last call) and runs its plain
twin for CPU tensors. When no
gradient is needed (``torch.no_grad()`` or no input requires one) the forward
saves no ``xs``.

Which kernels a CUDA call runs is decided here, by shape (``takes_tensor_cores``):
float32 (``compute_dtype`` None, what every shipped config trains with) and
bfloat16 at C = H = 256 with dilations up to 16 take the tensor-core kernels
(one launch a layer forward, four backward; float32 products in 3xTF32);
every other shape takes the SIMT kernels (two and twelve). None ever reaches
a plain twin, and a tensor-core call that fails to build or launch raises.
Tile sizes, shared memory, the weight gradients' slab count and the body
(bf16 or 3xTF32 products) are the library's own (``diffnet_train_tc_info``
reports them).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from diffsinger_tpu_torch.ops._build import check, load_library
from diffsinger_tpu_torch.ops.diffnet_stack import (SQRT_HALF, _DTYPE_CODE, _dilation_array,
                                                    _shift_t, pack_diffnet_params,
                                                    pack_step_params)

GRAD_NAMES = ("x0", "step_proj", "cond", "k_cond", "b_cond", "w_dil", "b_dil", "w_out",
              "b_out")


def _rounder(compute_dtype: Optional[torch.dtype], acc_dtype: torch.dtype = torch.float32):
    if compute_dtype is None:
        return lambda a: a.to(acc_dtype)
    return lambda a: a.to(compute_dtype).to(acc_dtype)


def _conv_pre(y, condc, w, kc, b_dil_l, b_cond_l, d):
    """Dilated conv taps + cond projection + biases (f32, rounded inputs),
    summed in the JAX kernel's order."""
    side = _shift_t(y, -d) @ w[0] + _shift_t(y, d) @ w[2]
    return y @ w[1] + side + b_dil_l + (condc @ kc + b_cond_l)


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------
def diffnet_train_stack_fwd_plain(x0, step_proj, cond, k_cond, b_cond, w_dil, b_dil,
                                  w_out, b_out, *, dilations: Sequence[int],
                                  compute_dtype: Optional[torch.dtype] = None,
                                  save_xs: bool = True):
    """The forward kernel's math in plain PyTorch (``_make_fwd_kernel``).
    Returns (skips [B,T,C] f32, xs [L,B,T,C] or None)."""
    f32 = torch.float32
    rnd = _rounder(compute_dtype)
    x = x0.to(f32)
    skips = torch.zeros_like(x)
    condc = rnd(cond)
    xs = []
    for i, d in enumerate(dilations):
        if save_xs:
            xs.append(x.to(compute_dtype or f32))
        y = rnd(x + step_proj[i][:, None, :].to(f32))
        conv = _conv_pre(y, condc, rnd(w_dil[i]), rnd(k_cond[i]), b_dil[i].to(f32),
                         b_cond[i].to(f32), d)
        gate, filt = conv.chunk(2, dim=-1)
        g = rnd(torch.sigmoid(gate) * torch.tanh(filt))
        out = g @ rnd(w_out[i]) + b_out[i].to(f32)
        residual, skip = out.chunk(2, dim=-1)
        x = (x + residual) * SQRT_HALF
        skips = skips + skip
    return skips, (torch.stack(xs) if save_xs else None)


def diffnet_train_stack_bwd_plain(xs, step_proj, cond, k_cond, b_cond, w_dil, b_dil,
                                  w_out, ds, *, dilations: Sequence[int],
                                  compute_dtype: Optional[torch.dtype] = None,
                                  acc_dtype: torch.dtype = torch.float32):
    """The backward kernel's math in plain PyTorch, step by step as
    ``_make_bwd_kernel`` (not autograd). Returns the nine cotangents in
    :data:`GRAD_NAMES` order, all in ``acc_dtype``: float32 as the kernels
    accumulate, or float64 for the same steps as a yardstick of both."""
    acc = acc_dtype
    rnd = _rounder(compute_dtype, acc_dtype)
    num_layers = xs.shape[0]
    condc = rnd(cond)
    dskip = rnd(ds)  # the JAX wrapper casts ds to the compute dtype
    dx = torch.zeros(xs.shape[1:], dtype=acc, device=xs.device)
    dcond = torch.zeros(cond.shape, dtype=acc, device=xs.device)
    per_layer = {k: [None] * num_layers for k in ("dstep", "dk", "db", "dwd", "dwo", "dbo")}
    for i in reversed(range(num_layers)):
        d = dilations[i]
        # recompute from the saved (possibly bf16) layer input
        y = rnd(xs[i].to(acc) + step_proj[i][:, None, :].to(acc))
        w, kc, wo = rnd(w_dil[i]), rnd(k_cond[i]), rnd(w_out[i])
        conv = _conv_pre(y, condc, w, kc, b_dil[i].to(acc), b_cond[i].to(acc), d)
        gate, filt = conv.chunk(2, dim=-1)
        sg, tf = torch.sigmoid(gate), torch.tanh(filt)
        g = sg * tf
        # back through the layer
        dout = torch.cat([dx * SQRT_HALF, dskip], dim=-1)
        doutc = rnd(dout)
        per_layer["dwo"][i] = torch.einsum("btc,btd->cd", rnd(g), doutc)
        per_layer["dbo"][i] = dout.sum((0, 1))
        dg = doutc @ wo.t()
        dconv = torch.cat([dg * tf * sg * (1.0 - sg), dg * sg * (1.0 - tf * tf)], dim=-1)
        dconvc = rnd(dconv)
        per_layer["db"][i] = dconv.sum((0, 1))
        per_layer["dk"][i] = torch.einsum("bth,btd->hd", condc, dconvc)
        dcond = dcond + dconvc @ kc.t()
        per_layer["dwd"][i] = torch.stack([
            torch.einsum("btc,btd->cd", _shift_t(y, -d), dconvc),
            torch.einsum("btc,btd->cd", y, dconvc),
            torch.einsum("btc,btd->cd", _shift_t(y, d), dconvc)])
        # tap 0 read y[t-d], so its cotangent lands at t-d
        dy = (_shift_t(dconvc @ w[0].t(), d) + _shift_t(dconvc @ w[2].t(), -d)
              + dconvc @ w[1].t())
        per_layer["dstep"][i] = dy.sum(1)
        dx = dx * SQRT_HALF + dy
    st = {k: torch.stack(v) for k, v in per_layer.items()}
    return (dx, st["dstep"], dcond, st["dk"], st["db"], st["dwd"], st["db"].clone(),
            st["dwo"], st["dbo"])


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------
TC_WIDTH = 256        # C = H the tensor-core kernels are built for
TC_MAX_DILATION = 16  # the widest halo their tiles hold in a block's shared memory


def takes_tensor_cores(c: int, h: int, dilations: Sequence[int],
                       compute_dtype: Optional[torch.dtype]) -> bool:
    """The dispatch rule: float32 (``None``) or bfloat16, C = H = 256 and
    every dilation <= 16 go to the tensor-core kernels, everything else to
    the SIMT kernels. The library holds the same rule and refuses a call
    outside it."""
    return ((compute_dtype or torch.float32) in _DTYPE_CODE and c == TC_WIDTH
            and h == TC_WIDTH and max(int(d) for d in dilations) <= TC_MAX_DILATION)


@functools.lru_cache(maxsize=None)
def _entries():
    lib = load_library("diffnet_train")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    dil = ctypes.POINTER(ctypes.c_int)
    fwd, bwd, nbytes = (lib.diffnet_train_fwd, lib.diffnet_train_bwd,
                        lib.diffnet_train_bwd_scratch_bytes)
    fwd.restype = bwd.restype = i32
    fwd.argtypes = [i32] * 2 + [ptr] * 12 + [i32] * 5 + [dil, ptr, dil]
    bwd.argtypes = [i32] * 2 + [ptr] * 18 + [i32] * 5 + [dil, ptr, dil]
    nbytes.restype = ctypes.c_longlong
    nbytes.argtypes = [i32] * 6
    return fwd, bwd, nbytes


def tensor_core_info(b: int, c: int, h: int, dilations: Sequence[int],
                     compute_dtype: Optional[torch.dtype]) -> Optional[dict]:
    """What the built library says of these shapes: None when its tensor-core
    kernels do not take them, else their weight-gradient slab count for ``b``
    batch rows, each kernel's shared memory (bytes) at the largest dilation
    and the body that takes them ("bf16" products, or float32 as "3xtf32").
    Needs the built library, so it runs on the card's machine."""
    info = load_library("diffnet_train").diffnet_train_tc_info
    info.restype = ctypes.c_int
    info.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 6)()
    code = _DTYPE_CODE.get(compute_dtype or torch.float32, -1)
    if not info(code, b, c, h, max(int(d) for d in dilations), out):
        return None
    return {"nslab": out[0], "smem": dict(zip(("fwd", "gate", "dx", "wgrad"), out[1:5])),
            "body": "bf16" if out[5] == _DTYPE_CODE[torch.bfloat16] else "3xtf32"}


def _checked(name: str, t: torch.Tensor, shape, device) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x0 on {device}")


def _prepare(x0, step_proj, cond, k_cond, b_cond, w_dil, b_dil, w_out, extra, dilations,
             compute_dtype):
    """Shape/device checks, the kernels' operand types (contiguous) and the
    choice of kernels (1: tensor cores; 0: SIMT)."""
    dt = compute_dtype or torch.float32
    if dt not in _DTYPE_CODE:
        raise ValueError(f"diffnet_train kernels take float32 or bfloat16, got {dt}")
    num_layers, (b, t, c), h = w_dil.shape[0], x0.shape[-3:], cond.shape[-1]
    if c % 32:
        raise ValueError(f"diffnet_train kernels need C % 32 == 0, got C={c}")
    if min(int(d) for d in dilations) < 1:
        raise ValueError(f"dilations must be positive, got {tuple(dilations)}")
    dev = x0.device
    for name, ten, shape in (("step_proj", step_proj, (num_layers, b, c)),
                             ("cond", cond, (b, t, h)),
                             ("k_cond", k_cond, (num_layers, h, 2 * c)),
                             ("b_cond", b_cond, (num_layers, 2 * c)),
                             ("w_dil", w_dil, (num_layers, 3, c, 2 * c)),
                             ("b_dil", b_dil, (num_layers, 2 * c)),
                             ("w_out", w_out, (num_layers, c, 2 * c)), *extra):
        _checked(name, ten, shape, dev)
    f32 = torch.float32
    ops = [step_proj.to(f32).contiguous(), cond.to(dt).contiguous(),
           k_cond.to(dt).contiguous(), b_cond.to(f32).contiguous(),
           w_dil.to(dt).contiguous(), b_dil.to(f32).contiguous(), w_out.to(dt).contiguous()]
    path = int(takes_tensor_cores(c, h, dilations, compute_dtype))
    dil = _dilation_array(tuple(int(d) for d in dilations))
    return dt, (b, t, c, h, num_layers), ops, dil, path


def _report(fn, err: int, report) -> None:
    """Raise on a launch error; else keep what the library counted and ran."""
    check(err, fn.__name__)
    fn.device_launches, fn.ran_tensor_cores = report[0], bool(report[1])


def _launch_fwd(x0, step_proj, cond, k_cond, b_cond, w_dil, b_dil, w_out, b_out,
                dilations, compute_dtype, save_xs):
    dt, (b, t, c, h, num_layers), ops, dil, path = _prepare(
        x0, step_proj, cond, k_cond, b_cond, w_dil, b_dil, w_out,
        [("b_out", b_out, (w_dil.shape[0], 2 * x0.shape[-1]))], dilations, compute_dtype)
    x = x0.to(torch.float32).contiguous()
    if path:
        # x0 is read only, the layers alternate between two buffers of the
        # kernel's own; layer 0 writes skip, so it needs no zeros
        skip = torch.empty_like(x)
        scratch = torch.empty((2, b * t, c), dtype=torch.float32, device=x.device)
    else:
        x = x.clone()            # updated in place
        skip = torch.zeros_like(x)
        scratch = torch.empty((b * t, c), dtype=dt, device=x.device)   # g
    xs = None
    if save_xs:
        xs = torch.empty((num_layers, b, t, c), dtype=dt, device=x.device)
        xs[0].copy_(x)
    ops.append(b_out.to(torch.float32).contiguous())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    report = (ctypes.c_int * 2)()
    err = _entries()[0](path, _DTYPE_CODE[dt], x.data_ptr(), skip.data_ptr(),
                        scratch.data_ptr(), xs.data_ptr() if xs is not None else None,
                        *[o.data_ptr() for o in ops], b, t, c, h, num_layers, dil, stream,
                        report)
    _report(diffnet_train_fwd, err, report)
    return skip, xs


def _launch_bwd(xs, step_proj, cond, k_cond, b_cond, w_dil, b_dil, w_out, ds, dilations,
                compute_dtype):
    num_layers = w_dil.shape[0]
    dt, (b, t, c, h, _), ops, dil, path = _prepare(
        xs[0], step_proj, cond, k_cond, b_cond, w_dil, b_dil, w_out,
        [("xs", xs, (num_layers,) + tuple(xs.shape[1:])), ("ds", ds, tuple(xs.shape[1:]))],
        dilations, compute_dtype)
    if xs.dtype != dt:
        raise ValueError(f"xs must be saved in {dt}, got {xs.dtype}")
    dev, f32 = xs.device, torch.float32
    _, bwd, scratch_bytes = _entries()

    def buf(*shape, zero=False):
        return (torch.zeros if zero else torch.empty)(shape, dtype=f32, device=dev)

    dx, dcond = buf(b, t, c, zero=True), buf(b, t, h, zero=True)
    dstep, dk = buf(num_layers, b, c), buf(num_layers, h, 2 * c)
    dwd, dbd = buf(num_layers, 3, c, 2 * c), buf(num_layers, 2 * c)
    dwo, dbo = buf(num_layers, c, 2 * c), buf(num_layers, 2 * c)
    # the kernels carve their per-layer intermediates from one allocation
    scratch = torch.empty(int(scratch_bytes(path, _DTYPE_CODE[dt], b, t, c, h)),
                          dtype=torch.uint8, device=dev)
    dsc = ds.to(dt).contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    xs = xs.contiguous()
    report = (ctypes.c_int * 2)()
    err = bwd(path, _DTYPE_CODE[dt], xs.data_ptr(), *[o.data_ptr() for o in ops],
              dsc.data_ptr(), dx.data_ptr(), dstep.data_ptr(), dcond.data_ptr(),
              dk.data_ptr(), dwd.data_ptr(), dbd.data_ptr(), dwo.data_ptr(), dbo.data_ptr(),
              scratch.data_ptr(), b, t, c, h, num_layers, dil, stream, report)
    _report(diffnet_train_bwd, err, report)
    # db_cond == db_dil: both are the row sum of dconv
    return dx, dstep, dcond, dk, dbd.clone(), dwd, dbd, dwo, dbo


# ---------------------------------------------------------------------------
# wrappers (CUDA: kernel, counted; CPU: plain twin)
# ---------------------------------------------------------------------------
def _route(name: str, t: torch.Tensor) -> bool:
    """True for the kernel, False for the plain twin; raises elsewhere."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {t.device}")
    return True


def diffnet_train_fwd(x0, step_proj, cond, k_cond, b_cond, w_dil, b_dil, w_out, b_out,
                      *, dilations: Sequence[int],
                      compute_dtype: Optional[torch.dtype] = None,
                      save_xs: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Training forward of the stack: (skips, xs or None)."""
    if len(dilations) != w_dil.shape[0]:
        raise ValueError("one dilation per layer is required")
    args = (x0, step_proj, cond, k_cond, b_cond, w_dil, b_dil, w_out, b_out)
    if not _route("diffnet_train_fwd", x0):
        return diffnet_train_stack_fwd_plain(*args, dilations=dilations,
                                             compute_dtype=compute_dtype, save_xs=save_xs)
    out = _launch_fwd(*args, dilations, compute_dtype, save_xs)
    diffnet_train_fwd.launches += 1
    return out


def diffnet_train_bwd(xs, step_proj, cond, k_cond, b_cond, w_dil, b_dil, w_out, ds, *,
                      dilations: Sequence[int],
                      compute_dtype: Optional[torch.dtype] = None):
    """Training backward of the stack: the nine cotangents (GRAD_NAMES order)."""
    if len(dilations) != w_dil.shape[0]:
        raise ValueError("one dilation per layer is required")
    args = (xs, step_proj, cond, k_cond, b_cond, w_dil, b_dil, w_out, ds)
    if not _route("diffnet_train_bwd", xs):
        return diffnet_train_stack_bwd_plain(*args, dilations=dilations,
                                             compute_dtype=compute_dtype)
    out = _launch_bwd(*args, dilations, compute_dtype)
    diffnet_train_bwd.launches += 1
    return out


for _fn in (diffnet_train_fwd, diffnet_train_bwd):
    _fn.launches = 0             # calls that launched kernels
    _fn.device_launches = None   # kernels the library launched in the last such call
    _fn.ran_tensor_cores = None  # which set of kernels that call ran


class _TrainStack(torch.autograd.Function):
    """Forward and backward kernels joined for autograd (``make_stack_vjp``)."""

    @staticmethod
    def forward(ctx, dilations, compute_dtype, x0, step_proj, cond, k_cond, b_cond, w_dil,
                b_dil, w_out, b_out):
        skips, xs = diffnet_train_fwd(x0, step_proj, cond, k_cond, b_cond, w_dil, b_dil,
                                      w_out, b_out, dilations=dilations,
                                      compute_dtype=compute_dtype)
        ctx.save_for_backward(xs, step_proj, cond, k_cond, b_cond, w_dil, b_dil, w_out,
                              b_out)
        ctx.dilations, ctx.compute_dtype, ctx.x0_dtype = dilations, compute_dtype, x0.dtype
        return skips

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ds):
        xs, *inputs = ctx.saved_tensors
        grads = diffnet_train_bwd(xs, *inputs[:-1], ds.contiguous(),
                                  dilations=ctx.dilations,
                                  compute_dtype=ctx.compute_dtype)
        dtypes = [ctx.x0_dtype] + [t.dtype for t in inputs]
        return (None, None) + tuple(g.to(dt) for g, dt in zip(grads, dtypes))


def diffnet_train_stack(x0, step_proj, cond, k_cond, b_cond, w_dil, b_dil, w_out, b_out,
                        *, dilations: Sequence[int],
                        compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Differentiable fused stack: the skip sum [B, T, C] f32."""
    args = (x0, step_proj, cond, k_cond, b_cond, w_dil, b_dil, w_out, b_out)
    if not (torch.is_grad_enabled() and any(a.requires_grad for a in args)):
        # primal-only call: no backward will read the saved inputs
        return diffnet_train_fwd(*args, dilations=dilations, compute_dtype=compute_dtype,
                                 save_xs=False)[0]
    return _TrainStack.apply(tuple(dilations), compute_dtype, *args)


def pack_train_params(denoiser):
    """Per-layer step, cond and stack weights in the kernels' layout, as
    differentiable views of the module's parameters."""
    layers = denoiser.residual_layers
    k_cond = torch.stack([ly.conditioner_projection.weight[..., 0].t() for ly in layers])
    b_cond = torch.stack([ly.conditioner_projection.bias for ly in layers])
    return pack_step_params(denoiser) + (k_cond, b_cond) + pack_diffnet_params(denoiser)


def diffnet_train_forward(denoiser, spec: torch.Tensor, t: torch.Tensor,
                          cond: torch.Tensor, *,
                          compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Differentiable DiffNet forward with the fused training stack
    (counterpart of JAX ``diffnet_train_forward``). Equals ``DiffNet.forward``
    on a raw [B, T, H] cond; the input, step, skip and output projections run
    in plain float32 torch around the kernels, as in JAX."""
    from diffsinger_tpu_torch.models.diffnet import pointwise, timestep_embedding

    num_layers = denoiser.num_layers
    w_step, b_step, k_cond, b_cond, w_dil, b_dil, w_out, b_out = pack_train_params(denoiser)
    x0 = torch.relu(pointwise(spec, denoiser.input_projection))
    step = denoiser.mlp(timestep_embedding(t, denoiser.residual_channels))
    step_proj = (step @ w_step + b_step).reshape(step.shape[0], num_layers, -1).transpose(0, 1)
    skips = diffnet_train_stack(x0, step_proj, cond, k_cond, b_cond, w_dil, b_dil, w_out,
                                b_out, dilations=denoiser.dilations,
                                compute_dtype=compute_dtype)
    x = torch.relu(pointwise(skips * (num_layers ** -0.5), denoiser.skip_projection))
    return pointwise(x, denoiser.output_projection)
