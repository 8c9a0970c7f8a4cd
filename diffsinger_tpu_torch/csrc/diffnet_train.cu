// DiffNet residual stack for TRAINING on Hopper (sm_90a), plain C interface:
// a forward that saves each layer's input, and a backward that walks the
// layers in reverse. Every product of the TPU kernel bodies runs here.
//
// Replaces the Pallas TPU kernels of diffsinger_tpu/ops/diffnet_train.py:
//   _fwd_call (pallas_call at :315, body _make_fwd_kernel :74-135)  -> diffnet_train_fwd
//   _bwd_call (pallas_call at :389, body _make_bwd_kernel :141-257) -> diffnet_train_bwd
//
// Forward, per layer l with dilation d (x [R=B*T, C] f32):
//   xs[l] = cast(x)                                   (saved for the backward)
//   y     = cast(x + step[l])                         (f32 add, then input type)
//   conv  = y[t-d] @ W0 + y[t] @ W1 + y[t+d] @ W2 + cond @ K[l]
//           + b_dil[l] + b_cond[l]                    (f32 accumulation)
//   g     = cast(sigmoid(conv[:, :C]) * tanh(conv[:, C:]))
//   out   = g @ w_out[l] + b_out[l]
//   x     = (x + out[:, :C]) * sqrt(1/2);   skip += out[:, C:]
// Backward, per layer in reverse, carrying dx [R, C] f32 and dcond [R, H] f32,
// with dout = [dx*sqrt(1/2), ds]:
//   y, conv, sg, tf, g   recomputed from xs[l]: y = cast(float(xs) + step)
//   dW_out = cast(g)^T @ cast(dout);  db_out = column sums of dout (f32)
//   dg     = cast(dout) @ w_out^T
//   dconv  = [dg*tf*sg*(1-sg), dg*sg*(1-tf^2)];  db_dil = db_cond = column sums (f32)
//   [dW_dil taps; dK] = [y[t-d], y, y[t+d], cond]^T @ cast(dconv)
//   dcond += cast(dconv) @ K^T
//   dy     = sum_tap shift(cast(dconv) @ W_tap^T)   (tap 0 read y[t-d], so its
//            cotangent lands at t-d);  dstep[l, b] = sum over t of dy (f32)
//   dx     = dx*sqrt(1/2) + dy
// The TPU kernel writes weight gradients per batch tile in bf16 and rounds
// dcond to bf16, both to fit its 16 MB VMEM. Here weight gradients and dcond
// are accumulated and returned in f32. No atomics anywhere: every sum across
// blocks goes through per-block or per-slab partials added in a fixed order,
// so two runs give the same bits.
//
// Bound. At B=24, T=1024, C=H=256, L=20 the forward does 644 GFLOP and the
// backward 1.80 TFLOP over well under a GB of inputs and outputs: both are
// operation-bound on this card, by the bf16 tensor cores in bfloat16 and, in
// float32, by three TF32 passes a product (495 / 3 = 165 TFLOP/s: 3.90 ms
// forward, 10.93 ms backward; the FMA units would take 9.62 and 26.92).
//
// Three sets of kernels (the wrapper picks by shape and type, the library
// refuses a set that does not take the shape and reports the set that ran):
//
// bfloat16 with C = H = 256 (namespace tc, the bf16 training shape) - all
// products are mma.sync.m16n8k16 (bf16 in, f32 accumulate) fed by ldmatrix,
// in the tile design of the serving stack (diffnet_stack.cu): a row block is
// 64 frames of one batch row (grid = T tiles x B, so a dilation halo is zero
// exactly where t leaves [0, T)), eight warps, warp w owns all 64 rows and
// the gate columns [wC/8, (w+1)C/8) with the matching filter columns, and
// each warp streams only its own columns of the layer's weights through a
// cp.async ring of its own (16-deep chunks, four stages), so the GEMM loops
// need no block-wide barrier. Layers and kernels after the first are
// launched as programmatic dependents: their weight prefetch overlaps the
// tail of the kernel before.
//   forward, one launch a layer (fwd_layer_tc): y = bf16(x + step) with its
//     halo and the cond tile are staged once in shared memory; one product
//     over K = 3C + H (taps as row offsets into the y tile, then cond);
//     gate in registers; g stays in shared memory for the out product; the
//     epilogue writes x, skip and xs[l+1]. A neighbouring block still reads
//     x[t +- d] while this one writes, so x alternates between two buffers
//     and the caller's x0 is layer 0's read-only input.
//   backward, four launches a layer:
//   1 bwd_gate_tc (row block). dg depends only on dx and ds, so it runs first:
//     dout is staged as bf16 (its f32 column sums taken on the way: db_out),
//     dg = dout @ w_out^T is parked in shared memory in f32, in the layout
//     of the accumulators that will need it. The dout tile's space then
//     takes y and cond; the recompute leaves conv in registers, and one
//     epilogue forms sg, tf, g and dconv, writes y, g and dconv in bf16 and
//     reduces the f32 dconv to the block's column sums (db_dil). No f32 conv
//     or dconv ever reaches device memory.
//   2 bwd_dx_tc (row block). One staged bf16 dconv tile with its halo feeds
//     dy (three taps as row offsets, K = 6C) and dcond (K = 2C); the weights
//     enter transposed, which for mma.sync is a plain ldmatrix of [n][k]
//     rows. Epilogue: dx = dx sqrt(1/2) + dy in place, dcond +=, and the
//     block's column sums of the f32 dy (dstep).
//   3 wgrad_tc. [dW_dil; dK; dW_out] as one split-K product over slabs of
//     whole batch rows: 128 x 128 output tiles ((4C + H) / 128 x 2C / 128 =
//     40 of them) times as many slabs as fill the SMs once; both operands are
//     stored by row, so both fragments are transposed ldmatrix loads from a
//     four-stage cp.async pipeline of 64-row slices; a tap is a row offset of
//     the copy, zero-filled outside [0, T).
//   4 finish_kernel. All fixed-order sums of the layer: slabs -> dw_dil,
//     dk_cond, dw_out; row blocks' column sums -> db_dil, db_out, dstep.
//   What bounds them: each 64-row block streams the layer's weights (1.25 MB
//   forward and gate, 1 MB dx) through the L2, as the serving stack does, and
//   mma.sync tops out near 640 TFLOP/s on this card.
//
// float32 with C = H = 256 (namespace tc, the ...32 kernels) - what every
// shipped config trains with, since none sets compute_dtype. The same grid,
// blocks, warp column ownership, per-warp rings, dependent launches, x double
// buffer, slabs, fixed-order sums and launch count (one forward, four
// backward a layer); what the float32 type changes:
//   * every product is 3xTF32: mma.sync.m16n8k8 TF32 with f32 accumulators,
//     each operand split as a = a_hi + a_lo (split_tf32: the top 10 mantissa
//     bits, then the remainder cut the same way) and acc += a_lo b_hi +
//     a_hi b_lo + a_hi b_hi, as the serving stack's stack_layer_tc32: float32
//     accuracy (one TF32 pass keeps three digits). A fragments come from
//     ldmatrix of rows of four floats; B fragments are 32-bit shared loads,
//     conflict-free by the ring strides.
//   * tiles are twice as wide, so each row-block kernel keeps one float
//     tile of (64 + 2d) x (C + 4) (99,840 B at d = 16) beside three-stage
//     rings (110,592 B) and stages into it in turn, a barrier apiece:
//     forward: cond (an input of the call, so staged and multiplied before
//       griddep_wait, while the layer before drains), then y with its halo,
//       then g; the residual reads x from device memory.
//     gate: dout one half at a time (K = C each, column sums from the tile),
//       then cond, then y; dg [64, C] fits neither beside the tile nor in
//       registers beside the 128 conv accumulators, so each thread parks its
//       own dg values in device memory (dgs, 64 KB a block, read back by the
//       same thread in the epilogue; it stays in the L2).
//     dx: dconv with its halo one half of its columns at a time (the whole
//       tile, 198 KB at d = 16, does not fit); dy and dcond accumulate across
//       the halves (64 + 64 registers).
//   * the scratch is float32: y, g, dconv and dout's dx half as the weight
//     gradients read them, the parked dg (~150 MB at 24 x 1024).
//   * wgrad_tc32: ldmatrix.trans moves 16-bit elements only, so the two
//     operands stored by row are read as 32-bit shared loads in fragment
//     order from rows of 136 floats (t * 136 + g covers 32 banks); four
//     stages of 32-row slices (139,264 B); each slice's products are added
//     to a float32 sum in registers (a slab's rows in one tensor-core
//     accumulator drift ~1e-4 of the scale at 36,000 rows).
//   What bounds them: the products at the mma.sync TF32 rate (319.4 TFLOP/s
//   in tools/mma_rate.py, a third of it at float32 accuracy), with the split
//   arithmetic beside every mma and 2 MB of float32 weights a layer streamed
//   through the L2 by every row block.
//
// float32 and bfloat16 at any other width or dilation - the earlier
// shared-memory tiled SIMT kernels (f32 FMA on values converted from the
// input type): two launches a layer forward, twelve backward, f32 conv,
// dconv and dy through device memory.
// Neighbour rows of a dilation tap are read with zero fill only outside
// [0,T) of the same batch row, so a shift never crosses into the next one.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma_sm90.cuh"

namespace {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype does
}
// value rounded to the compute type, back in f32
template <typename In> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<In>(v));
}

constexpr int BM = 64;    // tile rows
constexpr int BN = 64;    // tile columns
constexpr int BK = 16;    // contraction slice staged in shared memory
constexpr int NT = 256;   // threads: 16 x 16, each owns 4 x 4 outputs
constexpr int HALF = 32;  // paired tiles: 32 gate | 32 filter columns
constexpr int NUM_SMS = 132;
constexpr float SQRT_HALF = 0.70710678118654752f;

__device__ __forceinline__ float sigmoidf_(float v) { return 1.f / (1.f + expf(-v)); }

// acc[i][j] += sum_k A(r, k) * B(k, n) over k in [k_begin, k_end), for tile
// row r = ty + 16 i and tile column n = tx + 16 j. The loaders take the
// tile-local row/column and the global k, and return values already rounded
// to the compute type (0 outside the problem). A_K_CONTIG: A is contiguous in
// k (consecutive threads load consecutive k); otherwise consecutive threads
// load consecutive rows r for one k. B_N_CONTIG likewise for B.
template <bool A_K_CONTIG, bool B_N_CONTIG, class LA, class LB>
__device__ __forceinline__ void tile_gemm(float (&acc)[4][4], int k_begin, int k_end,
                                          const LA& la, const LB& lb) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();
#pragma unroll
    for (int q = 0; q < (BM * BK) / NT; ++q) {
      const int e = tid + q * NT;
      const int r = A_K_CONTIG ? e / BK : e % BM;
      const int kk = A_K_CONTIG ? e % BK : e / BM;
      const int k = k0 + kk;
      As[kk][r] = k < k_end ? la(r, k) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < (BK * BN) / NT; ++q) {
      const int e = tid + q * NT;
      const int n = B_N_CONTIG ? e % BN : e / BK;
      const int kk = B_N_CONTIG ? e / BN : e % BK;
      const int k = k0 + kk;
      Bs[kk][n] = k < k_end ? lb(k, n) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

struct Dims {
  int B, T, C, H, R;
};

// y = cast(x + step) at row R shifted by `off` frames inside its batch row
template <typename In, typename X>
__device__ __forceinline__ float y_at(const X* x, const float* step, const Dims& g, int l,
                                      int R, int off, int c) {
  const int b = R / g.T, t = R - b * g.T, ts = t + off;
  if (ts < 0 || ts >= g.T) return 0.f;
  return rnd<In>(to_f(x[((size_t)b * g.T + ts) * g.C + c]) +
                 step[((size_t)l * g.B + b) * g.C + c]);
}

// ---------------------------------------------------------------- forward A
// Gated dilated conv + cond projection of layer l. Tile: 64 rows x (32 gate
// columns j0.. and the 32 filter columns C+j0..), so the gate is local.
// Writes g; with conv != nullptr (backward recompute) also the f32 conv.
template <typename In, typename X>
__global__ void __launch_bounds__(NT)
gate_kernel(const X* __restrict__ x, const float* __restrict__ step,
            const In* __restrict__ cond, const In* __restrict__ k_cond,
            const float* __restrict__ b_cond, const In* __restrict__ w_dil,
            const float* __restrict__ b_dil, In* __restrict__ g_out,
            float* __restrict__ conv_out, Dims g, int l, int d) {
  const int row0 = blockIdx.x * BM, j0 = blockIdx.y * HALF;
  const int C = g.C, C2 = 2 * C, K = 3 * C + g.H;
  auto la = [&](int r, int k) -> float {
    const int R = row0 + r;
    if (R >= g.R) return 0.f;
    if (k < 3 * C) {
      const int tap = k / C;
      return y_at<In>(x, step, g, l, R, (tap - 1) * d, k - tap * C);
    }
    return to_f(cond[(size_t)R * g.H + (k - 3 * C)]);
  };
  auto lb = [&](int k, int n) -> float {
    const int col = n < HALF ? j0 + n : C + j0 + (n - HALF);
    if (k < 3 * C) return to_f(w_dil[((size_t)l * 3 * C + k) * C2 + col]);
    return to_f(k_cond[((size_t)l * g.H + (k - 3 * C)) * C2 + col]);
  };
  float acc[4][4];
  zero(acc);
  tile_gemm<true, true>(acc, 0, K, la, lb);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int R = row0 + ty + 16 * i;
    if (R >= g.R) continue;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int col = j0 + tx + 16 * jj;
      const size_t bg = (size_t)l * C2 + col, bf = bg + C;
      const float gate = acc[i][jj] + b_dil[bg] + b_cond[bg];
      const float filt = acc[i][jj + 2] + b_dil[bf] + b_cond[bf];
      g_out[(size_t)R * C + col] = from_f<In>(sigmoidf_(gate) * tanhf(filt));
      if (conv_out != nullptr) {
        conv_out[(size_t)R * C2 + col] = gate;
        conv_out[(size_t)R * C2 + C + col] = filt;
      }
    }
  }
}

// ---------------------------------------------------------------- forward B
// Out projection of layer l: residual update of x, skip sum, and xs[l+1].
template <typename In>
__global__ void __launch_bounds__(NT)
out_kernel(float* __restrict__ x, float* __restrict__ skip, In* __restrict__ xs_next,
           const In* __restrict__ g_in, const In* __restrict__ w_out,
           const float* __restrict__ b_out, Dims g, int l) {
  const int row0 = blockIdx.x * BM, j0 = blockIdx.y * HALF;
  const int C = g.C, C2 = 2 * C;
  auto la = [&](int r, int k) -> float {
    const int R = row0 + r;
    return R < g.R ? to_f(g_in[(size_t)R * C + k]) : 0.f;
  };
  auto lb = [&](int k, int n) -> float {
    const int col = n < HALF ? j0 + n : C + j0 + (n - HALF);
    return to_f(w_out[((size_t)l * C + k) * C2 + col]);
  };
  float acc[4][4];
  zero(acc);
  tile_gemm<true, true>(acc, 0, C, la, lb);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int R = row0 + ty + 16 * i;
    if (R >= g.R) continue;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int col = j0 + tx + 16 * jj;
      const size_t o = (size_t)R * C + col;
      const float xn = (x[o] + acc[i][jj] + b_out[(size_t)l * C2 + col]) * SQRT_HALF;
      x[o] = xn;
      skip[o] += acc[i][jj + 2] + b_out[(size_t)l * C2 + C + col];
      if (xs_next != nullptr) xs_next[o] = from_f<In>(xn);
    }
  }
}

// dout = [dx * sqrt(1/2), ds] at (R, n), f32 (ds is already in the input type)
template <typename In>
__device__ __forceinline__ float dout_at(const float* dx, const In* ds, int C, int R, int n) {
  return n < C ? dx[(size_t)R * C + n] * SQRT_HALF : to_f(ds[(size_t)R * C + (n - C)]);
}

// ---------------------------------------------------------------- backward 2
// dg = cast(dout) @ w_out[l]^T, then the gate derivatives into dconv (f32).
template <typename In>
__global__ void __launch_bounds__(NT)
dg_kernel(const float* __restrict__ dx, const In* __restrict__ ds,
          const In* __restrict__ w_out, const float* __restrict__ conv,
          float* __restrict__ dconv, Dims g, int l) {
  const int row0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int C = g.C, C2 = 2 * C;
  auto la = [&](int r, int k) -> float {
    const int R = row0 + r;
    return R < g.R ? rnd<In>(dout_at(dx, ds, C, R, k)) : 0.f;
  };
  auto lb = [&](int k, int n) -> float {
    const int c = n0 + n;
    return c < C ? to_f(w_out[((size_t)l * C + c) * C2 + k]) : 0.f;
  };
  float acc[4][4];
  zero(acc);
  tile_gemm<true, false>(acc, 0, C2, la, lb);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int R = row0 + ty + 16 * i;
    if (R >= g.R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c >= C) continue;
      const size_t o = (size_t)R * C2 + c;
      const float sg = sigmoidf_(conv[o]), tf = tanhf(conv[o + C]);
      const float dgv = acc[i][j];
      dconv[o] = dgv * tf * sg * (1.f - sg);
      dconv[o + C] = dgv * sg * (1.f - tf * tf);
    }
  }
}

// ---------------------------------------------------------------- backward 3/5
// Weight gradients: contraction over all rows, split into blockIdx.z slabs of
// `rps` rows; part[z, m, n] holds each slab's sum.
// MODE 0: A rows m = (tap, c) of the shifted y, then m = 3C + h of cond;
//         B = cast(dconv). Output [3C + H, 2C].
// MODE 1: A = g (already in the input type), B = cast(dout). Output [C, 2C].
template <typename In, int MODE>
__global__ void __launch_bounds__(NT)
wgrad_kernel(const In* __restrict__ xs_l, const float* __restrict__ step,
             const In* __restrict__ cond, const float* __restrict__ dconv,
             const In* __restrict__ g_in, const float* __restrict__ dx,
             const In* __restrict__ ds, float* __restrict__ part, Dims g, int l, int d,
             int M, int rps) {
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, z = blockIdx.z;
  const int C = g.C, C2 = 2 * C;
  const int r_begin = z * rps, r_end = min(g.R, r_begin + rps);
  auto la = [&](int r, int R) -> float {
    const int m = m0 + r;
    if (m >= M) return 0.f;
    if (MODE == 1) return to_f(g_in[(size_t)R * C + m]);
    if (m < 3 * C) {
      const int tap = m / C;
      return y_at<In>(xs_l, step, g, l, R, (tap - 1) * d, m - tap * C);
    }
    return to_f(cond[(size_t)R * g.H + (m - 3 * C)]);
  };
  auto lb = [&](int R, int n) -> float {
    const int col = n0 + n;
    if (col >= C2) return 0.f;
    if (MODE == 1) return rnd<In>(dout_at(dx, ds, C, R, col));
    return rnd<In>(dconv[(size_t)R * C2 + col]);
  };
  float acc[4][4];
  zero(acc);
  tile_gemm<false, true>(acc, r_begin, r_end, la, lb);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < C2) part[((size_t)z * M + m) * C2 + col] = acc[i][j];
    }
  }
}

// Sum `splits` slabs of [rows, N] in a fixed order. The first rows0 rows go
// to dst0, the rest to dst1.
__global__ void reduce_kernel(const float* __restrict__ part, int splits, int rows, int N,
                              int rows0, float* __restrict__ dst0, float* __restrict__ dst1) {
  const size_t total = (size_t)rows * N;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[(size_t)z * total + e];
    const size_t first = (size_t)rows0 * N;
    if (e < first) dst0[e] = s;
    else dst1[e - first] = s;
  }
}

// ---------------------------------------------------------------- backward 7/11
// Column sums over row segments [s*rps, min(R, (s+1)*rps)), blockIdx.y = s.
// 32 columns x 8 row lanes per block, lanes summed in a fixed order.
// SRC 0: dconv [R, 2C] -> part[0, s, :];  dout [R, 2C] -> part[1, s, :]
//        (blockIdx.z picks which).  SRC 1: dy [R, C] -> part[s, :].
template <typename In, int SRC>
__global__ void __launch_bounds__(NT)
colsum_kernel(const float* __restrict__ src, const float* __restrict__ dx,
              const In* __restrict__ ds, float* __restrict__ part, Dims g, int N, int rps) {
  __shared__ float sh[8][32];
  const int lane = threadIdx.x / 32, cl = threadIdx.x % 32;
  const int col = blockIdx.x * 32 + cl, s = blockIdx.y, which = blockIdx.z;
  const int r_begin = s * rps, r_end = min(g.R, r_begin + rps);
  float acc = 0.f;
  if (col < N) {
    for (int R = r_begin + lane; R < r_end; R += 8) {
      if (SRC == 0 && which == 1) acc += dout_at(dx, ds, g.C, R, col);
      else acc += src[(size_t)R * N + col];
    }
  }
  sh[lane][cl] = acc;
  __syncthreads();
  if (lane == 0 && col < N) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) t += sh[q][cl];
    part[((size_t)which * gridDim.y + s) * N + col] = t;
  }
}

// ---------------------------------------------------------------- backward 9
// dcond += cast(dconv) @ k_cond[l]^T   ([R, H], K = 2C)
template <typename In>
__global__ void __launch_bounds__(NT)
dcond_kernel(const float* __restrict__ dconv, const In* __restrict__ k_cond,
             float* __restrict__ dcond, Dims g, int l) {
  const int row0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int C2 = 2 * g.C;
  auto la = [&](int r, int k) -> float {
    const int R = row0 + r;
    return R < g.R ? rnd<In>(dconv[(size_t)R * C2 + k]) : 0.f;
  };
  auto lb = [&](int k, int n) -> float {
    const int h = n0 + n;
    return h < g.H ? to_f(k_cond[((size_t)l * g.H + h) * C2 + k]) : 0.f;
  };
  float acc[4][4];
  zero(acc);
  tile_gemm<true, false>(acc, 0, C2, la, lb);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int R = row0 + ty + 16 * i;
    if (R >= g.R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int h = n0 + tx + 16 * j;
      if (h < g.H) dcond[(size_t)R * g.H + h] += acc[i][j];
    }
  }
}

// ---------------------------------------------------------------- backward 10
// dy[s] = sum_tap cast(dconv)[s - (tap-1) d] @ W_tap^T  ([R, C], K = 3 * 2C),
// then dx = dx * sqrt(1/2) + dy.
template <typename In>
__global__ void __launch_bounds__(NT)
dy_kernel(const float* __restrict__ dconv, const In* __restrict__ w_dil,
          float* __restrict__ dy, float* __restrict__ dx, Dims g, int l, int d) {
  const int row0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int C = g.C, C2 = 2 * C;
  auto la = [&](int r, int k) -> float {
    const int R = row0 + r;
    if (R >= g.R) return 0.f;
    const int tap = k / C2, j = k - tap * C2;
    const int b = R / g.T, t = R - b * g.T, ts = t - (tap - 1) * d;
    if (ts < 0 || ts >= g.T) return 0.f;
    return rnd<In>(dconv[((size_t)b * g.T + ts) * C2 + j]);
  };
  auto lb = [&](int k, int n) -> float {
    const int c = n0 + n;
    if (c >= C) return 0.f;
    const int tap = k / C2, j = k - tap * C2;
    return to_f(w_dil[(((size_t)l * 3 + tap) * C + c) * C2 + j]);
  };
  float acc[4][4];
  zero(acc);
  tile_gemm<true, false>(acc, 0, 3 * C2, la, lb);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int R = row0 + ty + 16 * i;
    if (R >= g.R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c >= C) continue;
      const size_t o = (size_t)R * C + c;
      dy[o] = acc[i][j];
      dx[o] = dx[o] * SQRT_HALF + acc[i][j];
    }
  }
}

// Split of `rows` into slabs so that `tiles` x slabs fills the card about
// twice; slab rows are a multiple of BK.
struct Split {
  int n, rps;
};
Split make_split(int tiles, int rows) {
  int s = (2 * NUM_SMS + tiles - 1) / tiles;
  s = s < 1 ? 1 : (s > 32 ? 32 : s);
  int rps = ((rows + s - 1) / s + BK - 1) / BK * BK;
  if (rps < BK) rps = BK;
  return {(rows + rps - 1) / rps, rps};
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

struct Splits {
  Split a, b, bias;
};
Splits splits_for(const Dims& g) {
  const int C2 = 2 * g.C;
  return {make_split(cdiv(3 * g.C + g.H, BM) * cdiv(C2, BN), g.R),
          make_split(cdiv(g.C, BM) * cdiv(C2, BN), g.R),
          make_split(cdiv(C2, 32) * 2, g.R)};
}

size_t part_floats(const Dims& g) {
  const Splits s = splits_for(g);
  const size_t C2 = 2 * (size_t)g.C;
  size_t a = (size_t)s.a.n * (3 * g.C + g.H) * C2;
  size_t b = (size_t)s.b.n * g.C * C2;
  size_t c = (size_t)2 * s.bias.n * C2;
  size_t m = a > b ? a : b;
  return m > c ? m : c;
}

size_t align256(size_t n) { return (n + 255) / 256 * 256; }

// The SIMT backward's scratch, carved from one allocation: conv [R,2C] f32,
// g [R,C] in the compute type, dconv [R,2C] f32, dy [R,C] f32, split-K partials.
struct SimtScratch {
  float* conv;
  void* g;
  float *dconv, *dy, *part;
  size_t bytes;
};
SimtScratch simt_carve(void* base, const Dims& g, int esize) {
  const size_t R = (size_t)g.R, C = (size_t)g.C;
  char* p = (char*)base;
  size_t o = 0;
  auto take = [&](size_t n) { char* q = p + o; o += align256(n); return q; };
  SimtScratch s;
  s.conv = (float*)take(R * 2 * C * 4);
  s.g = take(R * C * esize);
  s.dconv = (float*)take(R * 2 * C * 4);
  s.dy = (float*)take(R * C * 4);
  s.part = (float*)take(part_floats(g) * 4);
  s.bytes = o;
  return s;
}

// After a <<<>>> launch: returns the error, or counts the launch in the
// caller's *n_launched.
#define LAUNCH_CHECK()                              \
  do {                                              \
    cudaError_t err_ = cudaGetLastError();          \
    if (err_ != cudaSuccess) return (int)err_;      \
    ++*n_launched;                                  \
  } while (0)

template <typename In>
int fwd_run(float* x, float* skip, In* gbuf, In* xs, const float* step, const In* cond,
            const In* k_cond, const float* b_cond, const In* w_dil, const float* b_dil,
            const In* w_out, const float* b_out, Dims g, int L, const int* dil,
            cudaStream_t s, int* n_launched) {
  n_launched[1] = 0;  // the report's second int: the SIMT kernels ran
  const dim3 grid(cdiv(g.R, BM), g.C / HALF);
  for (int l = 0; l < L; ++l) {
    gate_kernel<In, float><<<grid, NT, 0, s>>>(x, step, cond, k_cond, b_cond, w_dil, b_dil,
                                               gbuf, nullptr, g, l, dil[l]);
    LAUNCH_CHECK();
    In* xs_next = (xs != nullptr && l + 1 < L) ? xs + (size_t)(l + 1) * g.R * g.C : nullptr;
    out_kernel<In><<<grid, NT, 0, s>>>(x, skip, xs_next, gbuf, w_out, b_out, g, l);
    LAUNCH_CHECK();
  }
  return 0;
}

template <typename In>
int bwd_run(const In* xs, const float* step, const In* cond, const In* k_cond,
            const float* b_cond, const In* w_dil, const float* b_dil, const In* w_out,
            const In* ds, float* dx, float* dstep, float* dcond, float* dk_cond,
            float* dw_dil, float* db_dil, float* dw_out, float* db_out, void* scratch,
            Dims g, int L, const int* dil, cudaStream_t s, int* n_launched) {
  n_launched[1] = 0;
  const int C = g.C, C2 = 2 * C;
  const SimtScratch sc = simt_carve(scratch, g, (int)sizeof(In));
  float *conv = sc.conv, *dconv = sc.dconv, *dy = sc.dy, *part = sc.part;
  In* gbuf = (In*)sc.g;
  const Splits sp = splits_for(g);
  const int ma = 3 * C + g.H;
  const dim3 paired(cdiv(g.R, BM), C / HALF);
  const dim3 rows_c(cdiv(g.R, BM), cdiv(C, BN));
  const dim3 rows_h(cdiv(g.R, BM), cdiv(g.H, BN));
  const dim3 wa(cdiv(ma, BM), cdiv(C2, BN), sp.a.n);
  const dim3 wb(cdiv(C, BM), cdiv(C2, BN), sp.b.n);
  const dim3 bias(cdiv(C2, 32), sp.bias.n, 2);
  const dim3 dst(cdiv(C, 32), g.B, 1);
  const int red_threads = 256, red_blocks = 4 * NUM_SMS;
  for (int l = L - 1; l >= 0; --l) {
    const int d = dil[l];
    const In* xs_l = xs + (size_t)l * g.R * C;
    gate_kernel<In, In><<<paired, NT, 0, s>>>(xs_l, step, cond, k_cond, b_cond, w_dil, b_dil,
                                              gbuf, conv, g, l, d);
    LAUNCH_CHECK();
    dg_kernel<In><<<rows_c, NT, 0, s>>>(dx, ds, w_out, conv, dconv, g, l);
    LAUNCH_CHECK();
    wgrad_kernel<In, 0><<<wa, NT, 0, s>>>(xs_l, step, cond, dconv, gbuf, dx, ds, part, g, l,
                                          d, ma, sp.a.rps);
    LAUNCH_CHECK();
    reduce_kernel<<<red_blocks, red_threads, 0, s>>>(
        part, sp.a.n, ma, C2, 3 * C, dw_dil + (size_t)l * 3 * C * C2,
        dk_cond + (size_t)l * g.H * C2);
    LAUNCH_CHECK();
    wgrad_kernel<In, 1><<<wb, NT, 0, s>>>(xs_l, step, cond, dconv, gbuf, dx, ds, part, g, l,
                                          d, C, sp.b.rps);
    LAUNCH_CHECK();
    reduce_kernel<<<red_blocks, red_threads, 0, s>>>(part, sp.b.n, C, C2, C,
                                                     dw_out + (size_t)l * C * C2, nullptr);
    LAUNCH_CHECK();
    colsum_kernel<In, 0><<<bias, NT, 0, s>>>(dconv, dx, ds, part, g, C2, sp.bias.rps);
    LAUNCH_CHECK();
    // part holds [2, n, 2C]: the n slabs of dconv sums, then those of dout
    reduce_kernel<<<red_blocks, red_threads, 0, s>>>(part, sp.bias.n, 1, C2, 1,
                                                     db_dil + (size_t)l * C2, nullptr);
    LAUNCH_CHECK();
    reduce_kernel<<<red_blocks, red_threads, 0, s>>>(part + (size_t)sp.bias.n * C2,
                                                     sp.bias.n, 1, C2, 1,
                                                     db_out + (size_t)l * C2, nullptr);
    LAUNCH_CHECK();
    dcond_kernel<In><<<rows_h, NT, 0, s>>>(dconv, k_cond, dcond, g, l);
    LAUNCH_CHECK();
    dy_kernel<In><<<rows_c, NT, 0, s>>>(dconv, w_dil, dy, dx, g, l, d);
    LAUNCH_CHECK();
    colsum_kernel<In, 1><<<dst, NT, 0, s>>>(dy, nullptr, ds, dstep + (size_t)l * g.B * C, g,
                                            C, g.T);
    LAUNCH_CHECK();
  }
  return 0;
}

// =================================================================== bfloat16
// The tensor-core kernels (C = H = 256). See the note at the top of the file.
namespace tc {

using namespace mma90;
typedef __nv_bfloat16 bf16;

constexpr int TM = 64;      // rows of a row block (one batch row, 64 frames)
constexpr int KC = 16;      // contraction depth of a weight chunk
constexpr int NST = 4;      // stages of a warp's weight ring
constexpr int NTHR = 256;   // 8 warps
constexpr int NKC = 32;     // contraction depth of an [n][k] weight chunk
constexpr int NKS = NKC + 8; // its row stride (bf16)
constexpr int SMEM_LIMIT = 227 * 1024;

// Built with -DTRAIN_PHASE_CLOCKS (tools/train_phases.py does), thread 0 of
// every row block records clock64() at up to eight points of the last launch
// of the bfloat16 forward (k = 0), gate (1) and dx (2) kernels and of their
// float32 counterparts (3, 4, 5).
#ifdef TRAIN_PHASE_CLOCKS
constexpr int CLK_POINTS = 8, CLK_BLOCKS = 1024;
__device__ long long g_clk[6 * CLK_BLOCKS * CLK_POINTS];
#define PHASE_CLOCK(k, i)                                                            \
  if (threadIdx.x == 0 && blockIdx.y * gridDim.x + blockIdx.x < CLK_BLOCKS)          \
  g_clk[((k) * CLK_BLOCKS + blockIdx.y * gridDim.x + blockIdx.x) * CLK_POINTS + (i)] = clock64()
#else
#define PHASE_CLOCK(k, i)
#endif

// Row strides carry 16 bytes of padding: the eight rows of an ldmatrix then
// fall on eight different 16-byte bank groups.
template <int C> __host__ __device__ constexpr int kn_stride() { return C / 4 + 8; }
template <int C, int H> __host__ __device__ constexpr int stage_elems() {
  // a [16 k][gate | filter columns of a warp] chunk or an [n of a warp][32 k] chunk
  return KC * kn_stride<C>() > ((C > H ? C : H) / 8) * NKS ? KC * kn_stride<C>()
                                                            : ((C > H ? C : H) / 8) * NKS;
}
template <int C, int H> __host__ __device__ constexpr size_t ring_bytes() {
  return (size_t)8 * NST * stage_elems<C, H>() * sizeof(bf16);
}
template <int C, int H> constexpr size_t smem_fwd(int d) {
  return ((size_t)(TM + 2 * d) * (C + 8) + (size_t)TM * (C + 8) + (size_t)TM * (H + 8)) *
             sizeof(bf16) + ring_bytes<C, H>();
}
template <int C, int H> __host__ __device__ constexpr size_t gate_union_elems(int d) {
  return (size_t)TM * (2 * C + 8) > (size_t)(TM + 2 * d) * (C + 8) + (size_t)TM * (H + 8)
             ? (size_t)TM * (2 * C + 8)
             : (size_t)(TM + 2 * d) * (C + 8) + (size_t)TM * (H + 8);
}
template <int C, int H> constexpr size_t smem_gate(int d) {
  return gate_union_elems<C, H>(d) * sizeof(bf16) + (size_t)TM * C * sizeof(float) +
         ring_bytes<C, H>();
}
template <int C, int H> constexpr size_t smem_dx(int d) {
  return (size_t)(TM + 2 * d) * (2 * C + 8) * sizeof(bf16) + ring_bytes<C, H>();
}

__device__ __forceinline__ float sigmoid_f(float a) {
  a = fminf(fmaxf(a, -30.f), 30.f);
  return __fdividef(1.f, 1.f + __expf(-a));
}
__device__ __forceinline__ float tanh_f(float a) {
  a = fminf(fmaxf(a, -15.f), 15.f);
  return 1.f - __fdividef(2.f, 1.f + __expf(2.f * a));
}
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// Rows [k0, k0 + 16) of a [K][2C] weight matrix (bf16 or float), the warp's
// gate and filter columns only, kn_stride<C>() elements a row; src points at
// row k0, the warp's first gate column.
template <int C, typename E>
__device__ __forceinline__ void fetch_kn(E* dst, const E* src, int lane) {
  constexpr int EP = 16 / sizeof(E);   // elements a 16-byte copy moves
  constexpr int WC = C / 8, PPH = WC / EP, WS = kn_stride<C>();
#pragma unroll
  for (int p = lane; p < KC * 2 * PPH; p += 32) {
    const int r = p / (2 * PPH), hp = p % (2 * PPH), h = hp / PPH, q = hp % PPH;
    cp_async16(smem_u32(dst + r * WS + h * WC + q * EP),
               src + (size_t)r * (2 * C) + h * C + q * EP);
  }
}
// Columns [k0, k0 + 32) of WN rows of an [N][ld] weight matrix (the operand of
// a product with the matrix transposed; 64 or 128 bytes a row, so the L2
// serves half or whole lines), rows of NKC elements + 16 bytes; src points at
// the warp's first row, column k0.
template <int WN, typename E>
__device__ __forceinline__ void fetch_nk(E* dst, const E* src, int ld, int lane) {
  constexpr int EP = 16 / sizeof(E), S = NKC + EP;
#pragma unroll
  for (int p = lane; p < WN * (NKC / EP); p += 32) {
    const int n = p / (NKC / EP), q = p % (NKC / EP);
    cp_async16(smem_u32(dst + n * S + q * EP), src + (size_t)n * ld + q * EP);
  }
}

// acc += A[64 x 16] (abase, row stride as) * chunk[16 k][gate | filter]
template <int C>
__device__ __forceinline__ void mma_kn(float (&acc)[4][C / 32][4], const bf16* abase, int as,
                                       const bf16* wst, int lane) {
  constexpr int WC = C / 8, NTH = C / 64, WS = kn_stride<C>();
  uint32_t bfr[2 * NTH][2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < NTH / 2; ++j) {
      uint32_t r[4];
      const int col = h * WC + j * 16 + (lane / 16) * 8;
      ldmatrix_x4_trans(r, smem_u32(wst + (size_t)(lane % 16) * WS + col));
      bfr[h * NTH + 2 * j][0] = r[0];
      bfr[h * NTH + 2 * j][1] = r[1];
      bfr[h * NTH + 2 * j + 1][0] = r[2];
      bfr[h * NTH + 2 * j + 1][1] = r[3];
    }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    uint32_t a[4];
    ldmatrix_x4(a, smem_u32(abase + (size_t)(mt * 16 + lane % 16) * as + (lane / 16) * 8));
#pragma unroll
    for (int nt = 0; nt < 2 * NTH; ++nt) mma_bf16(acc[mt][nt], a, bfr[nt][0], bfr[nt][1]);
  }
}

// acc += A[64 x 32] (abase, row stride as) * chunk[8 NT n][32 k]^T
template <int NT>
__device__ __forceinline__ void mma_nk(float (&acc)[4][NT][4], const bf16* abase, int as,
                                       const bf16* wst, int lane) {
#pragma unroll
  for (int kk = 0; kk < NKC; kk += 16) {
    uint32_t bfr[NT][2];
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t r[4];
      const int n = j * 16 + (lane / 16) * 8 + lane % 8, k = kk + ((lane / 8) % 2) * 8;
      ldmatrix_x4(r, smem_u32(wst + (size_t)n * NKS + k));
      bfr[2 * j][0] = r[0];
      bfr[2 * j][1] = r[1];
      bfr[2 * j + 1][0] = r[2];
      bfr[2 * j + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      uint32_t a[4];
      ldmatrix_x4(a, smem_u32(abase + (size_t)(mt * 16 + lane % 16) * as + kk + (lane / 16) * 8));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a, bfr[nt][0], bfr[nt][1]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&acc)[4][N][4]) {
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < N; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

// One step of a warp's weight ring of `nst` stages: chunk ch has landed for
// every lane, the stage of chunk ch - 1 is free and takes chunk ch + nst - 1.
#define RING_STEP(ch, nch, nst)                      \
  cp_async_wait<(nst) - 2>();                        \
  __syncwarp();                                      \
  if ((ch) + (nst) - 1 < (nch)) fetch((ch) + (nst) - 1); \
  cp_async_commit()

// Sum over the eight row groups of a warp (lanes that share lane % 4), in a
// fixed order.
__device__ __forceinline__ float sum_rows(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// Two neighbouring values to device memory in the type of the buffer.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// The epilogues the bfloat16 and float32 kernels share. A warp holds
// accumulators [4 row tiles][NT column tiles][4] over the block's 64 rows
// (frames t0 .. t0 + 63 of one batch row, starting at row_b) and its own
// column tiles from col0; rows past T are neither read nor written.

// The forward's residual epilogue: x_out = (x_in + res) * sqrt(1/2),
// skip (+)= sk, xs[l+1] = x_out (in the saved type), from the
// out-product accumulators (tiles [0, NTH) residual, [NTH, 2 NTH) skip).
template <int C, typename XS>
__device__ __forceinline__ void residual_epilogue(const float (&acc)[4][C / 32][4],
                                                  const float* x_in, float* x_out,
                                                  float* skip, XS* xs_next, const float* bo_l,
                                                  bool first_layer, size_t row_b, int t0, int T,
                                                  int col0, int lane) {
  constexpr int NTH = C / 64;
  const int g8 = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int nt = 0; nt < NTH; ++nt) {
    const int col = col0 + nt * 8 + 2 * t4;
    const float2 br = *reinterpret_cast<const float2*>(bo_l + col);
    const float2 bs = *reinterpret_cast<const float2*>(bo_l + C + col);
    float2 xi[4][2], so[4][2];   // all loads of the column pair first, then the stores
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int t = t0 + mt * 16 + g8 + hr * 8;
        xi[mt][hr] = so[mt][hr] = make_float2(0.f, 0.f);
        if (t < T) {
          const size_t o = (row_b + t) * C + col;
          xi[mt][hr] = *reinterpret_cast<const float2*>(x_in + o);
          if (!first_layer) so[mt][hr] = *reinterpret_cast<const float2*>(skip + o);
        }
      }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int t = t0 + mt * 16 + g8 + hr * 8;
        if (t >= T) continue;
        const size_t o = (row_b + t) * C + col;
        const float x0 = (xi[mt][hr].x + (acc[mt][nt][hr * 2] + br.x)) * SQRT_HALF;
        const float x1 = (xi[mt][hr].y + (acc[mt][nt][hr * 2 + 1] + br.y)) * SQRT_HALF;
        store2(x_out + o, x0, x1);
        store2(skip + o, so[mt][hr].x + (acc[mt][NTH + nt][hr * 2] + bs.x),
               so[mt][hr].y + (acc[mt][NTH + nt][hr * 2 + 1] + bs.y));
        if (xs_next != nullptr) store2(xs_next + o, x0, x1);
      }
  }
}

// The gate kernel's epilogue: from the recomputed conv accumulators (gate
// tiles [0, NTH), filter tiles [NTH, 2 NTH)) and dg (this lane's values of
// the warp's [64 (mt, nt, e)][32 lanes] block, at dg_lane), sg, tf, g and
// dconv at once; g and dconv to device memory in type S, the f32 column sums
// of dconv to bsum_blk (the block's row of biaspart[0]).
template <int C, typename S>
__device__ __forceinline__ void gate_grad_epilogue(const float (&acc)[4][C / 32][4],
                                                   const float* dg_lane, const float* bd_l,
                                                   const float* bc_l, S* gbuf, S* dconv,
                                                   float* bsum_blk, size_t row_b, int t0, int T,
                                                   int col0, int lane) {
  constexpr int C2 = 2 * C, NTH = C / 64;
  const int g8 = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int nt = 0; nt < NTH; ++nt) {
    const int col = col0 + nt * 8 + 2 * t4;
    const float2 bg1 = *reinterpret_cast<const float2*>(bd_l + col);
    const float2 bg2 = *reinterpret_cast<const float2*>(bc_l + col);
    const float2 bf1 = *reinterpret_cast<const float2*>(bd_l + C + col);
    const float2 bf2 = *reinterpret_cast<const float2*>(bc_l + C + col);
    float sg0 = 0.f, sg1 = 0.f, sf0 = 0.f, sf1 = 0.f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int t = t0 + mt * 16 + g8 + hr * 8;
        if (t >= T) continue;
        const float* dgp = dg_lane + ((mt * NTH + nt) * 4 + hr * 2) * 32;
        const float dg0 = dgp[0], dg1 = dgp[32];
        const float s0 = sigmoid_f(acc[mt][nt][hr * 2] + bg1.x + bg2.x);
        const float s1 = sigmoid_f(acc[mt][nt][hr * 2 + 1] + bg1.y + bg2.y);
        const float h0 = tanh_f(acc[mt][NTH + nt][hr * 2] + bf1.x + bf2.x);
        const float h1 = tanh_f(acc[mt][NTH + nt][hr * 2 + 1] + bf1.y + bf2.y);
        const float cg0 = dg0 * h0 * s0 * (1.f - s0), cg1 = dg1 * h1 * s1 * (1.f - s1);
        const float cf0 = dg0 * s0 * (1.f - h0 * h0), cf1 = dg1 * s1 * (1.f - h1 * h1);
        sg0 += cg0; sg1 += cg1; sf0 += cf0; sf1 += cf1;
        const size_t o = row_b + t;
        store2(gbuf + o * C + col, s0 * h0, s1 * h1);
        store2(dconv + o * C2 + col, cg0, cg1);
        store2(dconv + o * C2 + C + col, cf0, cf1);
      }
    sg0 = sum_rows(sg0); sg1 = sum_rows(sg1); sf0 = sum_rows(sf0); sf1 = sum_rows(sf1);
    if (g8 == 0) {
      store2(bsum_blk + col, sg0, sg1);
      store2(bsum_blk + C + col, sf0, sf1);
    }
  }
}

// The dx kernel's epilogues. dx = dx sqrt(1/2) + dy in place (dy in the
// accumulators, ld = C) and the block's column sums of dy to dsum_blk ...
template <int NT>
__device__ __forceinline__ void dx_epilogue(const float (&acc)[4][NT][4], float* dx,
                                            float* dsum_blk, int C, size_t row_b, int t0, int T,
                                            int col0, int lane) {
  const int g8 = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = col0 + nt * 8 + 2 * t4;
    float s0 = 0.f, s1 = 0.f;
    float2 xv[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int t = t0 + mt * 16 + g8 + hr * 8;
        xv[mt][hr] = make_float2(0.f, 0.f);
        if (t < T) xv[mt][hr] = *reinterpret_cast<const float2*>(dx + (row_b + t) * C + col);
      }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int t = t0 + mt * 16 + g8 + hr * 8;
        if (t >= T) continue;
        const float y0 = acc[mt][nt][hr * 2], y1 = acc[mt][nt][hr * 2 + 1];
        s0 += y0;
        s1 += y1;
        store2(dx + (row_b + t) * C + col, xv[mt][hr].x * SQRT_HALF + y0,
               xv[mt][hr].y * SQRT_HALF + y1);
      }
    s0 = sum_rows(s0);
    s1 = sum_rows(s1);
    if (g8 == 0) store2(dsum_blk + col, s0, s1);
  }
}
// ... and dcond += the accumulators (ld = H).
template <int NT>
__device__ __forceinline__ void dcond_epilogue(const float (&acc)[4][NT][4], float* dcond,
                                               int H, size_t row_b, int t0, int T, int col0,
                                               int lane) {
  const int g8 = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = col0 + nt * 8 + 2 * t4;
    float2 cv[4][2];   // all loads of the column pair first, then the stores
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int t = t0 + mt * 16 + g8 + hr * 8;
        cv[mt][hr] = make_float2(0.f, 0.f);
        if (t < T) cv[mt][hr] = *reinterpret_cast<const float2*>(dcond + (row_b + t) * H + col);
      }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int t = t0 + mt * 16 + g8 + hr * 8;
        if (t >= T) continue;
        store2(dcond + (row_b + t) * H + col, cv[mt][hr].x + acc[mt][nt][hr * 2],
               cv[mt][hr].y + acc[mt][nt][hr * 2 + 1]);
      }
  }
}

// ------------------------------------------------------------------- forward
// One layer: conv + cond product, gate, out product, residual / skip / xs.
template <int C, int H>
__global__ void __launch_bounds__(NTHR, 1)
fwd_layer_tc(const float* __restrict__ x_in, float* __restrict__ x_out,
             float* __restrict__ skip, bf16* __restrict__ xs_next,
             const float* __restrict__ step, const bf16* __restrict__ cond,
             const bf16* __restrict__ k_cond, const float* __restrict__ b_cond,
             const bf16* __restrict__ w_dil, const float* __restrict__ b_dil,
             const bf16* __restrict__ w_out, const float* __restrict__ b_out, int B, int T,
             int l, int d) {
  constexpr int C2 = 2 * C, YS = C + 8, CS = H + 8, WC = C / 8, NTH = C / 64;
  constexpr int NG = 3 * C / KC, NCV = NG + H / KC, NCH = NCV + C / KC;
  constexpr int STG = stage_elems<C, H>();
  static_assert(C % 128 == 0 && H % KC == 0, "two n-tiles per ldmatrix.x4");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ys = reinterpret_cast<bf16*>(smem_raw);      // [TM + 2d][YS] y
  bf16* gs = ys + (size_t)(TM + 2 * d) * YS;         // [TM][YS] g
  bf16* cs = gs + (size_t)TM * YS;                   // [TM][CS] cond
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  bf16* wring = cs + (size_t)TM * CS + (size_t)warp * NST * STG;   // the warp's own

  const int g8 = lane / 4, t4 = lane % 4;
  const int b = blockIdx.y, t0 = blockIdx.x * TM;
  const int wcol = warp * WC;
  const bf16* wd_l = w_dil + (size_t)l * 3 * C * C2;
  const bf16* kc_l = k_cond + (size_t)l * H * C2;
  const bf16* wo_l = w_out + (size_t)l * C * C2;
  const float* xin_b = x_in + (size_t)b * T * C;

  PHASE_CLOCK(0, 0);
  // Up to griddep_wait() only inputs of the whole call are touched.
  griddep_launch_dependents();
  for (int p = tid; p < TM * (H / 8); p += NTHR) {
    const int r = p / (H / 8), q = p % (H / 8), t = t0 + r;
    cp_async16_zfill(smem_u32(cs + r * CS + q * 8),
                     cond + ((size_t)b * T + (t < T ? t : T - 1)) * H + q * 8, t < T);
  }
  cp_async_commit();
  auto fetch = [&](int ch) {
    const bf16* src = ch < NG ? wd_l + (size_t)ch * KC * C2
                      : ch < NCV ? kc_l + (size_t)(ch - NG) * KC * C2
                                 : wo_l + (size_t)(ch - NCV) * KC * C2;
    fetch_kn<C>(wring + (size_t)(ch % NST) * STG, src + wcol, lane);
  };
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    fetch(s);
    cp_async_commit();
  }
  griddep_wait();   // the layer before has completed: x_in and skip are final
  if (l > 0)
    for (int i = tid; i < TM * (C * 4 / 128); i += NTHR) {
      const int t = t0 + i / (C * 4 / 128);
      if (t < T) prefetch_l2(skip + ((size_t)b * T + t) * C + (i % (C * 4 / 128)) * 32);
    }
  // y = bf16(x + step), rows t0 - d .. t0 + TM + d, zero outside [0, T)
  {
    constexpr int CP4 = C / 4, RPP = NTHR / CP4;
    const int c4 = tid % CP4, rq = tid / CP4;
    const float4 sv = reinterpret_cast<const float4*>(step + ((size_t)l * B + b) * C)[c4];
    const int nrows = TM + 2 * d;
    constexpr int UN = 24;
    for (int q0 = 0; q0 < nrows; q0 += UN * RPP) {
      float4 v[UN];
#pragma unroll
      for (int u = 0; u < UN; ++u) {
        const int q = q0 + u * RPP + rq, t = t0 - d + q;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (q < nrows && t >= 0 && t < T)
          v[u] = reinterpret_cast<const float4*>(xin_b + (size_t)t * C)[c4];
      }
#pragma unroll
      for (int u = 0; u < UN; ++u) {
        const int q = q0 + u * RPP + rq, t = t0 - d + q;
        if (q >= nrows) continue;
        const bool in = t >= 0 && t < T;
        uint2 pk;
        pk.x = pack_bf16(in ? v[u].x + sv.x : 0.f, in ? v[u].y + sv.y : 0.f);
        pk.y = pack_bf16(in ? v[u].z + sv.z : 0.f, in ? v[u].w + sv.w : 0.f);
        *reinterpret_cast<uint2*>(ys + (size_t)q * YS + c4 * 4) = pk;
      }
    }
  }
  cp_async_wait<NST - 1>();   // this thread's part of the cond tile
  __syncthreads();            // y and cond are staged
  PHASE_CLOCK(0, 1);

  float acc[4][2 * NTH][4];
  zero_acc(acc);
  for (int ch = 0; ch < NCV; ++ch) {
    RING_STEP(ch, NCH, NST);
    const bf16* wst = wring + (size_t)(ch % NST) * STG;
    if (ch < NG) {
      const int tap = (ch * KC) / C, c0 = (ch * KC) % C;
      mma_kn<C>(acc, ys + (size_t)(tap * d) * YS + c0, YS, wst, lane);
    } else {
      mma_kn<C>(acc, cs + (ch - NG) * KC, CS, wst, lane);
    }
  }
  PHASE_CLOCK(0, 2);
  // gate epilogue: biases, sigmoid * tanh, g -> shared memory (bf16)
  {
    const float* bd_l = b_dil + (size_t)l * C2;
    const float* bc_l = b_cond + (size_t)l * C2;
#pragma unroll
    for (int nt = 0; nt < NTH; ++nt) {
      const int col = wcol + nt * 8 + 2 * t4;
      const float2 bg1 = *reinterpret_cast<const float2*>(bd_l + col);
      const float2 bg2 = *reinterpret_cast<const float2*>(bc_l + col);
      const float2 bf1 = *reinterpret_cast<const float2*>(bd_l + C + col);
      const float2 bf2 = *reinterpret_cast<const float2*>(bc_l + C + col);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = mt * 16 + g8 + hr * 8;
          uint32_t gv = 0u;
          if (t0 + r < T) {
            const float g0 = acc[mt][nt][hr * 2] + bg1.x + bg2.x;
            const float g1 = acc[mt][nt][hr * 2 + 1] + bg1.y + bg2.y;
            const float f0 = acc[mt][NTH + nt][hr * 2] + bf1.x + bf2.x;
            const float f1 = acc[mt][NTH + nt][hr * 2 + 1] + bf1.y + bf2.y;
            gv = pack_bf16(sigmoid_f(g0) * tanh_f(f0), sigmoid_f(g1) * tanh_f(f1));
          }
          *reinterpret_cast<uint32_t*>(gs + (size_t)r * YS + col) = gv;
        }
    }
  }
  zero_acc(acc);
  __syncthreads();   // every warp's g columns are written
  PHASE_CLOCK(0, 3);
  for (int ch = NCV; ch < NCH; ++ch) {
    RING_STEP(ch, NCH, NST);
    mma_kn<C>(acc, gs + (ch - NCV) * KC, YS, wring + (size_t)(ch % NST) * STG, lane);
  }
  PHASE_CLOCK(0, 4);
  // residual epilogue: x_out = (x_in + res) * sqrt(1/2), skip (+)= sk, xs[l+1]
  residual_epilogue<C>(acc, x_in, x_out, skip, xs_next, b_out + (size_t)l * C2, l == 0,
                       (size_t)b * T, t0, T, wcol, lane);
  PHASE_CLOCK(0, 5);
}

// ---------------------------------------------------------------- backward 1
// Row block of layer l: dg, recompute, gate derivatives. Writes y, g, dconv
// and bf16(dx sqrt(1/2)) in bf16 and the block's float32 column sums of dout
// (biaspart[1]) and dconv (biaspart[0]).
template <int C, int H>
__global__ void __launch_bounds__(NTHR, 1)
bwd_gate_tc(const bf16* __restrict__ xs_l, const float* __restrict__ step,
            const bf16* __restrict__ cond, const bf16* __restrict__ k_cond,
            const float* __restrict__ b_cond, const bf16* __restrict__ w_dil,
            const float* __restrict__ b_dil, const bf16* __restrict__ w_out,
            const bf16* __restrict__ ds, const float* __restrict__ dx,
            bf16* __restrict__ ybuf, bf16* __restrict__ gbuf, bf16* __restrict__ dconv,
            bf16* __restrict__ dxh, float* __restrict__ biaspart, int B, int T, int l, int d) {
  constexpr int C2 = 2 * C, YS = C + 8, CS = H + 8, DS = C2 + 8, WC = C / 8, NTH = C / 64;
  constexpr int NDG = C2 / NKC, NG = 3 * C / KC, NCH = NDG + NG + H / KC;
  constexpr int STG = stage_elems<C, H>();
  static_assert(C % 128 == 0 && H % KC == 0 && 12 * C <= TM * C, "layout");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* un = reinterpret_cast<bf16*>(smem_raw);
  bf16* douts = un;                                // [TM][DS] bf16(dout), then ...
  bf16* ys = un;                                   // ... [TM + 2d][YS] y
  bf16* cs = un + (size_t)(TM + 2 * d) * YS;       // ... and [TM][CS] cond
  float* dgs = reinterpret_cast<float*>(un + gate_union_elems<C, H>(d));  // [8][64][32] dg
  float* red = dgs;                                // before dg: [4 + 8][C] partial column sums
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  bf16* wring = reinterpret_cast<bf16*>(dgs + (size_t)TM * C) + (size_t)warp * NST * STG;

  const int b = blockIdx.y, t0 = blockIdx.x * TM;
  const int blk = b * gridDim.x + blockIdx.x, nblk = gridDim.x * gridDim.y;
  const int wcol = warp * WC;
  const bf16* wd_l = w_dil + (size_t)l * 3 * C * C2;
  const bf16* kc_l = k_cond + (size_t)l * H * C2;
  const bf16* wo_l = w_out + (size_t)l * C * C2;
  const size_t row_b = (size_t)b * T;

  PHASE_CLOCK(1, 0);
  griddep_launch_dependents();
  auto fetch = [&](int ch) {
    bf16* dst = wring + (size_t)(ch % NST) * STG;
    if (ch < NDG) fetch_nk<WC>(dst, wo_l + (size_t)wcol * C2 + ch * NKC, C2, lane);
    else if (ch < NDG + NG) fetch_kn<C>(dst, wd_l + (size_t)(ch - NDG) * KC * C2 + wcol, lane);
    else fetch_kn<C>(dst, kc_l + (size_t)(ch - NDG - NG) * KC * C2 + wcol, lane);
  };
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    fetch(s);
    cp_async_commit();
  }
  griddep_wait();   // dx of the layer above is final

  // dout = [dx sqrt(1/2), ds]: bf16 tile, the dx half also to device memory
  // for the weight gradients; column sums of the float32 values
  {
    constexpr int CP4 = C / 4, RPP = NTHR / CP4, NR = TM / RPP;
    const int c4 = tid % CP4, rq = tid / CP4;
    float4 v[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int t = t0 + rq + i * RPP;
      v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < T) v[i] = reinterpret_cast<const float4*>(dx + (row_b + t) * C)[c4];
    }
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int r = rq + i * RPP, t = t0 + r;
      const float a0 = v[i].x * SQRT_HALF, a1 = v[i].y * SQRT_HALF;
      const float a2 = v[i].z * SQRT_HALF, a3 = v[i].w * SQRT_HALF;
      s.x += a0; s.y += a1; s.z += a2; s.w += a3;
      uint2 pk;
      pk.x = pack_bf16(a0, a1);
      pk.y = pack_bf16(a2, a3);
      *reinterpret_cast<uint2*>(douts + (size_t)r * DS + c4 * 4) = pk;
      if (t < T) *reinterpret_cast<uint2*>(dxh + (row_b + t) * C + c4 * 4) = pk;
    }
    *reinterpret_cast<float4*>(red + rq * C + c4 * 4) = s;
  }
  {
    constexpr int P8 = C / 8, RPP = NTHR / P8, NR = TM / RPP;
    const int p8 = tid % P8, rq = tid / P8;
    uint4 v[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int t = t0 + rq + i * RPP;
      v[i] = make_uint4(0u, 0u, 0u, 0u);
      if (t < T) v[i] = reinterpret_cast<const uint4*>(ds + (row_b + t) * C)[p8];
    }
    float s[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = 0.f;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int r = rq + i * RPP;
      const float2 f0 = unpack_bf16(v[i].x), f1 = unpack_bf16(v[i].y);
      const float2 f2 = unpack_bf16(v[i].z), f3 = unpack_bf16(v[i].w);
      s[0] += f0.x; s[1] += f0.y; s[2] += f1.x; s[3] += f1.y;
      s[4] += f2.x; s[5] += f2.y; s[6] += f3.x; s[7] += f3.y;
      *reinterpret_cast<uint4*>(douts + (size_t)r * DS + C + p8 * 8) = v[i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) red[(4 + rq) * C + p8 * 8 + j] = s[j];
  }
  __syncthreads();   // dout is staged
  PHASE_CLOCK(1, 1);
  for (int col = tid; col < C2; col += NTHR) {
    float s = 0.f;
    if (col < C) {
#pragma unroll
      for (int q = 0; q < 4; ++q) s += red[q * C + col];
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) s += red[(4 + q) * C + col - C];
    }
    biaspart[((size_t)nblk + blk) * C2 + col] = s;
  }

  // dg = bf16(dout) @ w_out^T: the warp's WC columns
  {
    float accd[4][NTH][4];
    zero_acc(accd);
    for (int ch = 0; ch < NDG; ++ch) {
      RING_STEP(ch, NCH, NST);
      mma_nk<NTH>(accd, douts + ch * NKC, DS, wring + (size_t)(ch % NST) * STG, lane);
    }
    __syncthreads();   // every warp is done with the dout tile (and with red)
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTH; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dgs[((size_t)warp * 64 + (mt * NTH + nt) * 4 + e) * 32 + lane] = accd[mt][nt][e];
  }

  PHASE_CLOCK(1, 2);
  // recompute: y = bf16(float(xs) + step) with its halo, cond
  for (int p = tid; p < TM * (H / 8); p += NTHR) {
    const int r = p / (H / 8), q = p % (H / 8), t = t0 + r;
    cp_async16_zfill(smem_u32(cs + r * CS + q * 8),
                     cond + (row_b + (t < T ? t : T - 1)) * H + q * 8, t < T);
  }
  cp_async_commit();
  {
    constexpr int P8 = C / 8, RPP = NTHR / P8;
    const int p8 = tid % P8, rq = tid / P8;
    const float4* st4 = reinterpret_cast<const float4*>(step + ((size_t)l * B + b) * C) + p8 * 2;
    const float4 s0 = st4[0], s1 = st4[1];
    const int nrows = TM + 2 * d;
    constexpr int UN = 12;
    for (int q0 = 0; q0 < nrows; q0 += UN * RPP) {
      uint4 v[UN];
#pragma unroll
      for (int u = 0; u < UN; ++u) {
        const int q = q0 + u * RPP + rq, t = t0 - d + q;
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (q < nrows && t >= 0 && t < T)
          v[u] = reinterpret_cast<const uint4*>(xs_l + (row_b + t) * C)[p8];
      }
#pragma unroll
      for (int u = 0; u < UN; ++u) {
        const int q = q0 + u * RPP + rq, t = t0 - d + q;
        if (q >= nrows) continue;
        uint4 pk = make_uint4(0u, 0u, 0u, 0u);
        if (t >= 0 && t < T) {
          const float2 f0 = unpack_bf16(v[u].x), f1 = unpack_bf16(v[u].y);
          const float2 f2 = unpack_bf16(v[u].z), f3 = unpack_bf16(v[u].w);
          pk.x = pack_bf16(f0.x + s0.x, f0.y + s0.y);
          pk.y = pack_bf16(f1.x + s0.z, f1.y + s0.w);
          pk.z = pack_bf16(f2.x + s1.x, f2.y + s1.y);
          pk.w = pack_bf16(f3.x + s1.z, f3.y + s1.w);
          if (q >= d && q < d + TM)
            *reinterpret_cast<uint4*>(ybuf + (row_b + t) * C + p8 * 8) = pk;
        }
        *reinterpret_cast<uint4*>(ys + (size_t)q * YS + p8 * 8) = pk;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // y and cond are staged
  PHASE_CLOCK(1, 3);

  float acc[4][2 * NTH][4];
  zero_acc(acc);
  for (int ch = NDG; ch < NCH; ++ch) {
    RING_STEP(ch, NCH, NST);
    const bf16* wst = wring + (size_t)(ch % NST) * STG;
    const int cv = ch - NDG;
    if (cv < NG) {
      const int tap = (cv * KC) / C, c0 = (cv * KC) % C;
      mma_kn<C>(acc, ys + (size_t)(tap * d) * YS + c0, YS, wst, lane);
    } else {
      mma_kn<C>(acc, cs + (cv - NG) * KC, CS, wst, lane);
    }
  }

  PHASE_CLOCK(1, 4);
  // epilogue: sg, tf, g and dconv at once; column sums of the float32 dconv
  gate_grad_epilogue<C>(acc, dgs + (size_t)warp * 64 * 32 + lane, b_dil + (size_t)l * C2,
                        b_cond + (size_t)l * C2, gbuf, dconv, biaspart + (size_t)blk * C2,
                        row_b, t0, T, wcol, lane);
  PHASE_CLOCK(1, 5);
}

// ---------------------------------------------------------------- backward 2
// Row block of layer l: dy and dcond from one staged dconv tile with its
// halo; dx = dx sqrt(1/2) + dy, dcond += ..., the block's column sums of dy.
template <int C, int H>
__global__ void __launch_bounds__(NTHR, 1)
bwd_dx_tc(const bf16* __restrict__ dconv, const bf16* __restrict__ w_dil,
          const bf16* __restrict__ k_cond, float* __restrict__ dx, float* __restrict__ dcond,
          float* __restrict__ dsp, int B, int T, int l, int d) {
  constexpr int C2 = 2 * C, DS = C2 + 8, WC = C / 8, WH = H / 8, NTH = C / 64, NTHH = H / 64;
  constexpr int NSEG = C2 / NKC, NDY = 3 * NSEG, NCH = NDY + NSEG;
  constexpr int STG = stage_elems<C, H>();
  static_assert(C % 128 == 0 && H % 128 == 0, "two n-tiles per ldmatrix.x4");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* tile = reinterpret_cast<bf16*>(smem_raw);   // [TM + 2d][DS] dconv
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  bf16* wring = tile + (size_t)(TM + 2 * d) * DS + (size_t)warp * NST * STG;

  const int b = blockIdx.y, t0 = blockIdx.x * TM;
  const int blk = b * gridDim.x + blockIdx.x;
  const bf16* wd_l = w_dil + (size_t)l * 3 * C * C2;
  const bf16* kc_l = k_cond + (size_t)l * H * C2;
  const size_t row_b = (size_t)b * T;

  PHASE_CLOCK(2, 0);
  griddep_launch_dependents();
  auto fetch = [&](int ch) {
    bf16* dst = wring + (size_t)(ch % NST) * STG;
    const int seg = ch / NSEG, k0 = (ch % NSEG) * NKC;
    if (seg < 3) fetch_nk<WC>(dst, wd_l + ((size_t)seg * C + warp * WC) * C2 + k0, C2, lane);
    else fetch_nk<WH>(dst, kc_l + (size_t)(warp * WH) * C2 + k0, C2, lane);
  };
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    fetch(s);
    cp_async_commit();
  }
  griddep_wait();   // dconv of this layer is final
  for (int p = tid; p < (TM + 2 * d) * (C2 / 8); p += NTHR) {
    const int q = p / (C2 / 8), pc = p % (C2 / 8), t = t0 - d + q;
    const bool in = t >= 0 && t < T;
    cp_async16_zfill(smem_u32(tile + (size_t)q * DS + pc * 8),
                     dconv + (row_b + (in ? t : 0)) * C2 + pc * 8, in);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();   // the dconv tile is staged
  PHASE_CLOCK(2, 1);

  // dy[t] = dconv[t+d] @ W0^T + dconv[t] @ W1^T + dconv[t-d] @ W2^T; tile row
  // q is frame t0 - d + q, so tap k starts (2 - k) d rows into the tile
  {
    float acc[4][NTH][4];
    zero_acc(acc);
    for (int ch = 0; ch < NDY; ++ch) {
      RING_STEP(ch, NCH, NST);
      const int seg = ch / NSEG, k0 = (ch % NSEG) * NKC;
      mma_nk<NTH>(acc, tile + (size_t)((2 - seg) * d) * DS + k0, DS,
                  wring + (size_t)(ch % NST) * STG, lane);
    }
    PHASE_CLOCK(2, 2);
    dx_epilogue<NTH>(acc, dx, dsp + (size_t)blk * C, C, row_b, t0, T, warp * WC, lane);
  }
  PHASE_CLOCK(2, 3);
  // dcond += dconv[t] @ K^T
  {
    float acc[4][NTHH][4];
    zero_acc(acc);
    for (int ch = NDY; ch < NCH; ++ch) {
      RING_STEP(ch, NCH, NST);
      mma_nk<NTHH>(acc, tile + (size_t)d * DS + (ch - NDY) * NKC, DS,
                   wring + (size_t)(ch % NST) * STG, lane);
    }
    PHASE_CLOCK(2, 4);
    dcond_epilogue<NTHH>(acc, dcond, H, row_b, t0, T, warp * WH, lane);
  }
  PHASE_CLOCK(2, 5);
}

// ---------------------------------------------------------------- backward 3
// Weight gradients of layer l as one split-K product over slabs of whole batch
// rows: part[slab, m, n] = sum over the slab's rows r of A[r + shift, m] B[r, n]
// with m over [y[t-d] | y | y[t+d] | cond | g] (3C + H + C rows) and B = dconv,
// or [bf16(dx sqrt(1/2)), ds] for the g rows. 128 x 128 output tiles, 64 rows a
// stage; both operands are stored by row, so both fragments are transposed loads.
constexpr int WT = 128;     // output tile
constexpr int WK = 64;      // rows (contraction) per stage
constexpr int WST = 4;      // stages
constexpr int WLD = WT + 8; // row stride (bf16) of a staged operand
constexpr size_t SMEM_WGRAD = (size_t)WST * 2 * WK * WLD * sizeof(bf16);

// The largest dilation the tensor-core kernels take: the gate kernel's y tile
// with its halo still fits beside the parked dg and the weight rings. The
// wrapper's dispatch rule names the same width and dilation.
constexpr int MAX_DIL = 16;
static_assert(smem_fwd<256, 256>(MAX_DIL) <= SMEM_LIMIT &&
                  smem_gate<256, 256>(MAX_DIL) <= SMEM_LIMIT &&
                  smem_dx<256, 256>(MAX_DIL) <= SMEM_LIMIT && SMEM_WGRAD <= SMEM_LIMIT,
              "a tensor-core kernel's tiles exceed the block's shared memory");

template <int C, int H>
__global__ void __launch_bounds__(NTHR, 1)
wgrad_tc(const bf16* __restrict__ ybuf, const bf16* __restrict__ cond,
         const bf16* __restrict__ gbuf, const bf16* __restrict__ dconv,
         const bf16* __restrict__ dxh, const bf16* __restrict__ ds, float* __restrict__ part,
         int B, int T, int d, int bps) {
  constexpr int C2 = 2 * C, M_ALL = 3 * C + H + C;
  static_assert(C % WT == 0 && H % WT == 0, "whole tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);          // [WST][WK][WLD]
  bf16* Bs = As + (size_t)WST * WK * WLD;                // [WST][WK][WLD]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * WT, n0 = blockIdx.y * WT, slab = blockIdx.z;

  const bf16 *a_src, *b_src;
  int a_ld, b_ld, off = 0;
  if (m0 < 3 * C) {
    a_src = ybuf + m0 % C; a_ld = C; off = (m0 / C - 1) * d;
    b_src = dconv + n0; b_ld = C2;
  } else if (m0 < 3 * C + H) {
    a_src = cond + (m0 - 3 * C); a_ld = H;
    b_src = dconv + n0; b_ld = C2;
  } else {
    a_src = gbuf + (m0 - 3 * C - H); a_ld = C;
    b_src = n0 < C ? dxh + n0 : ds + (n0 - C); b_ld = C;
  }
  const int b_begin = slab * bps, b_end = min(B, b_begin + bps);
  const int n_t = (T + WK - 1) / WK, nit = (b_end - b_begin) * n_t;

  griddep_launch_dependents();
  griddep_wait();   // y, g, dconv and dxh of this layer are final
  auto load = [&](int it) {
    const size_t row_b = (size_t)(b_begin + it / n_t) * T;
    const int tt0 = (it % n_t) * WK;
    bf16* as = As + (size_t)(it % WST) * WK * WLD;
    bf16* bs = Bs + (size_t)(it % WST) * WK * WLD;
#pragma unroll
    for (int p = tid; p < WK * (WT / 8); p += NTHR) {
      const int r = p / (WT / 8), q = p % (WT / 8), t = tt0 + r, ta = t + off;
      const bool ok_b = t < T, ok_a = ok_b && ta >= 0 && ta < T;
      cp_async16_zfill(smem_u32(as + r * WLD + q * 8),
                       a_src + (row_b + (ok_a ? ta : 0)) * a_ld + q * 8, ok_a);
      cp_async16_zfill(smem_u32(bs + r * WLD + q * 8),
                       b_src + (row_b + (ok_b ? t : 0)) * b_ld + q * 8, ok_b);
    }
  };
#pragma unroll
  for (int s = 0; s < WST - 1; ++s) {
    if (s < nit) load(s);
    cp_async_commit();
  }
  // warp (wm, wn) owns rows [64 wm, +64) and columns [32 wn, +32) of the tile
  const int wm = warp / 4, wn = warp % 4;
  float acc[4][4][4];
  zero_acc(acc);
  for (int it = 0; it < nit; ++it) {
    cp_async_wait<WST - 2>();
    __syncthreads();   // stage `it` has landed; the stage of it - 1 is free
    if (it + WST - 1 < nit) load(it + WST - 1);
    cp_async_commit();
    const bf16* as = As + (size_t)(it % WST) * WK * WLD + wm * 64;
    const bf16* bs = Bs + (size_t)(it % WST) * WK * WLD + wn * 32;
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk) {
      uint32_t bfr[4][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, smem_u32(bs + (size_t)(kk * 16 + lane % 16) * WLD + j * 16 +
                                      (lane / 16) * 8));
        bfr[2 * j][0] = r[0];
        bfr[2 * j][1] = r[1];
        bfr[2 * j + 1][0] = r[2];
        bfr[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, smem_u32(as + (size_t)(kk * 16 + (lane / 16) * 8 + lane % 8) * WLD +
                                      mi * 16 + ((lane / 8) % 2) * 8));
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a, bfr[ni][0], bfr[ni][1]);
      }
    }
  }
  const int g8 = lane / 4, t4 = lane % 4;
  float* out = part + ((size_t)slab * M_ALL + m0 + wm * 64) * C2 + n0 + wn * 32;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<float2*>(out + (size_t)(mi * 16 + g8 + hr * 8) * C2 + ni * 8 + 2 * t4) =
            make_float2(acc[mi][ni][hr * 2], acc[mi][ni][hr * 2 + 1]);
}

// ---------------------------------------------------------------- backward 4
// Every cross-block sum of layer l, each in a fixed order. Blocks below
// `red_blocks`: the weight-gradient slabs -> dw_dil[l], dk_cond[l], dw_out[l].
// The others, 32 columns x 8 lanes each: the row blocks' column sums of dconv
// and dout -> db_dil[l], db_out[l], and of dy -> dstep[l, b].
__global__ void __launch_bounds__(NTHR)
finish_kernel(const float* __restrict__ part, int nslab, int C, int H,
              float* __restrict__ dw_dil, float* __restrict__ dk_cond,
              float* __restrict__ dw_out, const float* __restrict__ biaspart, int nblk,
              float* __restrict__ db_dil, float* __restrict__ db_out,
              const float* __restrict__ dsp, int n_tile, float* __restrict__ dstep,
              int red_blocks) {
  griddep_wait();
  const int C2 = 2 * C;
  if ((int)blockIdx.x < red_blocks) {
    const size_t n4 = (size_t)(4 * C + H) * C2 / 4, e_dil = (size_t)3 * C * C2 / 4,
                 e_k = e_dil + (size_t)H * C2 / 4;
    const float4* p4 = reinterpret_cast<const float4*>(part);
    for (size_t e = (size_t)blockIdx.x * NTHR + threadIdx.x; e < n4;
         e += (size_t)red_blocks * NTHR) {
      float4 s = p4[e];
      for (int z = 1; z < nslab; ++z) {
        const float4 v = p4[(size_t)z * n4 + e];
        s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
      }
      float4* dst = e < e_dil ? reinterpret_cast<float4*>(dw_dil) + e
                    : e < e_k ? reinterpret_cast<float4*>(dk_cond) + (e - e_dil)
                              : reinterpret_cast<float4*>(dw_out) + (e - e_k);
      *dst = s;
    }
    return;
  }
  __shared__ float sh[8][32];
  const int gi = blockIdx.x - red_blocks, q = threadIdx.x / 32, cl = threadIdx.x % 32;
  const float* src;
  float* dst;
  int n, ld;
  if (gi < 2 * (C2 / 32)) {
    const int which = gi / (C2 / 32), col = (gi % (C2 / 32)) * 32 + cl;
    src = biaspart + (size_t)which * nblk * C2 + col;
    dst = (which ? db_out : db_dil) + col;
    n = nblk; ld = C2;
  } else {
    const int gj = gi - 2 * (C2 / 32), b = gj / (C / 32), col = (gj % (C / 32)) * 32 + cl;
    src = dsp + (size_t)b * n_tile * C + col;
    dst = dstep + (size_t)b * C + col;
    n = n_tile; ld = C;
  }
  float s = 0.f;
  for (int i = q; i < n; i += 8) s += src[(size_t)i * ld];
  sh[q][cl] = s;
  __syncthreads();
  if (q == 0) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += sh[i][cl];
    *dst = t;
  }
}

// Launch on `s`, counted in *n_launched when the card took it; `dependent`
// lets the kernel start while the one before it in the stream drains (it
// waits in griddep_wait() before touching its outputs).
template <typename... KArgs, typename... Args>
cudaError_t launch(int* n_launched, void (*kern)(KArgs...), dim3 grid, size_t smem,
                   cudaStream_t s, bool dependent, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NTHR);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
#ifdef TRAIN_NO_DEPENDENT_LAUNCH   // tools/train_phases.py: each kernel's time alone
  dependent = false;
#endif
  cfg.numAttrs = dependent ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err == cudaSuccess) ++*n_launched;
  return err;
}

#define TC_TRY(expr)                          \
  do {                                        \
    cudaError_t err_ = (expr);                \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

int max_dilation(const int* dil, int L) {
  int dmax = 0;
  for (int l = 0; l < L; ++l) {
    if (dil[l] < 1) return -1;
    if (dil[l] > dmax) dmax = dil[l];
  }
  return dmax;
}

// x0 is read only; xbuf holds two [B,T,C] f32 buffers the layers alternate
// between; skip needs no initial value; xs[0] is the caller's.
template <int C, int H>
int fwd_run(const float* x0, float* xbuf, float* skip, bf16* xs, const float* step,
            const bf16* cond, const bf16* k_cond, const float* b_cond, const bf16* w_dil,
            const float* b_dil, const bf16* w_out, const float* b_out, int B, int T, int L,
            const int* dil, cudaStream_t s, int* n_launched) {
  n_launched[1] = 1;  // the report's second int: the tensor-core kernels ran
  const int dmax = max_dilation(dil, L);
  if (dmax < 1 || dmax > MAX_DIL) return (int)cudaErrorInvalidValue;
  TC_TRY(cudaFuncSetAttribute(fwd_layer_tc<C, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_fwd<C, H>(dmax)));
  const dim3 grid((T + TM - 1) / TM, B);
  const size_t n = (size_t)B * T * C;
  for (int l = 0; l < L; ++l) {
    const float* xin = l == 0 ? x0 : xbuf + ((l - 1) % 2) * n;
    bf16* xs_next = (xs != nullptr && l + 1 < L) ? xs + (size_t)(l + 1) * n : nullptr;
    TC_TRY(launch(n_launched, fwd_layer_tc<C, H>, grid, smem_fwd<C, H>(dil[l]), s, l > 0,
                  xin, xbuf + (l % 2) * n, skip, xs_next, step, cond, k_cond, b_cond, w_dil, b_dil,
                  w_out, b_out, B, T, l, dil[l]));
  }
  return (int)cudaSuccess;
}

// The weight gradients' split of the batch: slabs of whole batch rows, as many
// as give every SM at most one of the (4C + H) / 128 x 2C / 128 output tiles,
// none of them empty.
struct Slabs {
  int n, batch_rows;
};
Slabs slabs_for(int B, int C, int H) {
  const int tiles = ((4 * C + H) / WT) * (2 * C / WT);
  int n = NUM_SMS / tiles;
  n = n < 1 ? 1 : (n > B ? B : n);
  const int batch_rows = (B + n - 1) / n;
  return {(B + batch_rows - 1) / batch_rows, batch_rows};
}

// The backward's scratch, carved from one allocation.
struct BwdScratch {
  bf16 *ybuf, *gbuf, *dconv, *dxh;
  float *biaspart, *dsp, *part;
  size_t bytes;
};
BwdScratch carve(void* base, int B, int T, int C, int H) {
  const size_t R = (size_t)B * T, nblk = (size_t)B * ((T + TM - 1) / TM);
  char* p = (char*)base;
  size_t o = 0;
  auto take = [&](size_t n) { char* q = p + o; o += align256(n); return q; };
  BwdScratch s;
  s.ybuf = (bf16*)take(R * C * 2);
  s.gbuf = (bf16*)take(R * C * 2);
  s.dconv = (bf16*)take(R * 2 * C * 2);
  s.dxh = (bf16*)take(R * C * 2);
  s.biaspart = (float*)take(2 * nblk * 2 * C * 4);
  s.dsp = (float*)take(nblk * C * 4);
  s.part = (float*)take((size_t)slabs_for(B, C, H).n * (4 * C + H) * 2 * C * 4);
  s.bytes = o;
  return s;
}

template <int C, int H>
int bwd_run(const bf16* xs, const float* step, const bf16* cond, const bf16* k_cond,
            const float* b_cond, const bf16* w_dil, const float* b_dil, const bf16* w_out,
            const bf16* ds, float* dx, float* dstep, float* dcond, float* dk_cond,
            float* dw_dil, float* db_dil, float* dw_out, float* db_out, void* scratch, int B,
            int T, int L, const int* dil, cudaStream_t s, int* n_launched) {
  n_launched[1] = 1;
  constexpr int C2 = 2 * C;
  const int dmax = max_dilation(dil, L);
  if (dmax < 1 || dmax > MAX_DIL) return (int)cudaErrorInvalidValue;
  TC_TRY(cudaFuncSetAttribute(bwd_gate_tc<C, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_gate<C, H>(dmax)));
  TC_TRY(cudaFuncSetAttribute(bwd_dx_tc<C, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_dx<C, H>(dmax)));
  TC_TRY(cudaFuncSetAttribute(wgrad_tc<C, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)SMEM_WGRAD));
  const Slabs sl = slabs_for(B, C, H);
  const BwdScratch sc = carve(scratch, B, T, C, H);
  const int n_tile = (T + TM - 1) / TM, nblk = B * n_tile, bps = sl.batch_rows;
  const dim3 rows(n_tile, B);
  const dim3 wgrid((4 * C + H) / WT, C2 / WT, sl.n);
  const int red_blocks = 2 * NUM_SMS, sum_blocks = 2 * (C2 / 32) + B * (C / 32);
  const size_t n = (size_t)B * T * C;
  for (int l = L - 1; l >= 0; --l) {
    const int d = dil[l];
    TC_TRY(launch(n_launched, bwd_gate_tc<C, H>, rows, smem_gate<C, H>(d), s, l < L - 1,
                  xs + (size_t)l * n, step, cond, k_cond, b_cond, w_dil, b_dil, w_out, ds, (const float*)dx, sc.ybuf,
                  sc.gbuf, sc.dconv, sc.dxh, sc.biaspart, B, T, l, d));
    TC_TRY(launch(n_launched, bwd_dx_tc<C, H>, rows, smem_dx<C, H>(d), s, true,
                  (const bf16*)sc.dconv, w_dil, k_cond, dx, dcond, sc.dsp, B, T, l, d));
    TC_TRY(launch(n_launched, wgrad_tc<C, H>, wgrid, SMEM_WGRAD, s, true,
                  (const bf16*)sc.ybuf, cond, (const bf16*)sc.gbuf, (const bf16*)sc.dconv, (const bf16*)sc.dxh, ds, sc.part,
                  B, T, d, bps));
    TC_TRY(launch(n_launched, finish_kernel, dim3(red_blocks + sum_blocks), 0, s, true,
                  (const float*)sc.part, (int)wgrid.z, C, H, dw_dil + (size_t)l * 3 * C * C2,
                  dk_cond + (size_t)l * H * C2, dw_out + (size_t)l * C * C2,
                  (const float*)sc.biaspart, nblk, db_dil + (size_t)l * C2,
                  db_out + (size_t)l * C2, (const float*)sc.dsp, n_tile,
                  dstep + (size_t)l * B * C, red_blocks));
  }
  return (int)cudaSuccess;
}

// ==================================================================== float32
// The float32 tensor-core kernels (C = H = 256): the row-block design of the
// bfloat16 kernels above with every product in 3xTF32 (see the note at the
// top of the file). Tiles are twice as wide, so each row-block kernel keeps
// one [TM + 2d][C + 4] float tile beside its rings and stages what it needs
// into it in turn.

// Weight chunks as in bfloat16: [KC = 16 k][a warp's 2 x C/8 columns] or
// [a warp's C/8 n][NKC = 32 k], the same element counts and rows of 4-byte
// elements.
constexpr int NKS32 = NKC + 4;    // [n][k] row stride (floats)
constexpr int NST32 = 3;          // stages of a warp's weight ring

// Strides in floats. A staged tile row holds max(C, H) + 4 floats, so the
// eight 16-byte rows of an ldmatrix fall on eight bank groups; a [k][n] ring
// row (kn_stride<C>(): C/4 + 8 floats) puts the four k rows of a B fragment
// (lanes 4 apart) on 32 banks; an [n][k] row of 36 floats does the same for
// the eight n rows of one.
template <int C, int H> __host__ __device__ constexpr int tile_stride32() {
  return (C > H ? C : H) + 4;
}
template <int C, int H> __host__ __device__ constexpr int stage_elems32() {
  return KC * kn_stride<C>() > ((C > H ? C : H) / 8) * NKS32 ? KC * kn_stride<C>()
                                                             : ((C > H ? C : H) / 8) * NKS32;
}
template <int C, int H> __host__ __device__ constexpr size_t ring_bytes32() {
  return (size_t)8 * NST32 * stage_elems32<C, H>() * sizeof(float);
}
// fwd_layer_tc32, bwd_gate_tc32 and bwd_dx_tc32 alike: the tile of TM + 2d
// rows (a cond tile or a dout half takes its first TM rows) and the rings
template <int C, int H> constexpr size_t smem_rows32(int d) {
  return (size_t)(TM + 2 * d) * tile_stride32<C, H>() * sizeof(float) + ring_bytes32<C, H>();
}
// wgrad_tc32: 128 x 128 output tiles as in bfloat16, four stages of 32-row
// slices of both operands
constexpr int WK32 = 32;
constexpr int WST32 = 4;
constexpr int WLD32 = WT + 8;     // row stride (floats): t * WLD32 + g covers 32 banks
constexpr size_t SMEM_WGRAD32 = (size_t)WST32 * 2 * WK32 * WLD32 * sizeof(float);
static_assert(smem_rows32<256, 256>(MAX_DIL) <= SMEM_LIMIT && SMEM_WGRAD32 <= SMEM_LIMIT,
              "a float32 tensor-core kernel's tiles exceed the block's shared memory");

// The A fragments of a 16 x 8 tile at abase of a row-major staged tile
// (stride `as` floats), split into hi and lo. A row of four floats is 16
// bytes, so ldmatrix (b16) delivers tf32 fragments: matrix i's lane (g, t)
// holds row g (+8 for i odd), column t (+4 for i >= 2).
__device__ __forceinline__ void load_a_split(uint32_t (&ah)[4], uint32_t (&al)[4],
                                             const float* abase, int as, int lane) {
  uint32_t a[4];
  ldmatrix_x4(a, smem_u32(abase + (size_t)(lane % 16) * as + (lane / 16) * 4));
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(a[e]), ah[e], al[e]);
}

// acc[nt] += a b over NT n-tiles in three TF32 passes, the small products
// first; an accumulator's three mma are NT instructions apart.
template <int NT>
__device__ __forceinline__ void mma3(float (&acc)[NT][4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[NT][2],
                                     const uint32_t (&bl)[NT][2]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[nt], al, bh[nt][0], bh[nt][1]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[nt], ah, bl[nt][0], bl[nt][1]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[nt], ah, bh[nt][0], bh[nt][1]);
}

// acc += A[64 x 16] (abase, row stride as) * chunk[16 k][gate | filter],
// n-tile nt < C/64 gate columns, the rest filter columns
template <int C>
__device__ __forceinline__ void mma32_kn(float (&acc)[4][C / 32][4], const float* abase, int as,
                                         const float* wst, int lane) {
  constexpr int NT = C / 32, WS = kn_stride<C>();
  const int g8 = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int k8 = 0; k8 < KC / 8; ++k8) {
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* wp = wst + (k8 * 8 + t4) * WS + nt * 8 + g8;
      split_tf32(wp[0], bh[nt][0], bl[nt][0]);
      split_tf32(wp[4 * WS], bh[nt][1], bl[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      uint32_t ah[4], al[4];
      load_a_split(ah, al, abase + (size_t)(mt * 16) * as + k8 * 8, as, lane);
      mma3<NT>(acc[mt], ah, al, bh, bl);
    }
  }
}

// acc += A[64 x 32] (abase, row stride as) * chunk[8 NT n][32 k]^T
template <int NT>
__device__ __forceinline__ void mma32_nk(float (&acc)[4][NT][4], const float* abase, int as,
                                         const float* wst, int lane) {
  const int g8 = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int k8 = 0; k8 < NKC / 8; ++k8) {
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* wp = wst + (nt * 8 + g8) * NKS32 + k8 * 8 + t4;
      split_tf32(wp[0], bh[nt][0], bl[nt][0]);
      split_tf32(wp[4], bh[nt][1], bl[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      uint32_t ah[4], al[4];
      load_a_split(ah, al, abase + (size_t)(mt * 16) * as + k8 * 8, as, lane);
      mma3<NT>(acc[mt], ah, al, bh, bl);
    }
  }
}


// Copies frames t0 - d .. t0 + TM + d of one batch row of src ([T][C] f32)
// into tile rows 0 .. TM + 2d (stride S), zero outside [0, T). The caller
// commits, waits for its own copies and then calls add_step.
template <int C, int S>
__device__ __forceinline__ void stage_rows(float* tile, const float* src_b, int t0, int d, int T,
                                           int tid) {
  const int n = (TM + 2 * d) * (C / 4);
  for (int p = tid; p < n; p += NTHR) {
    const int q = p / (C / 4), c4 = p % (C / 4), t = t0 - d + q;
    const bool in = t >= 0 && t < T;
    cp_async16_zfill(smem_u32(tile + q * S + c4 * 4), src_b + (size_t)(in ? t : 0) * C + c4 * 4,
                     in);
  }
}
// y = staged + step on the rows inside [0, T) that this thread copied in
// stage_rows (its own copies are visible to it after its wait); with ybuf_b,
// the block's own TM rows also go to device memory.
template <int C, int S>
__device__ __forceinline__ void add_step(float* tile, const float* step_lb, int t0, int d, int T,
                                         int tid, float* ybuf_b) {
  const int n = (TM + 2 * d) * (C / 4);
  for (int p = tid; p < n; p += NTHR) {
    const int q = p / (C / 4), c4 = p % (C / 4), t = t0 - d + q;
    if (t < 0 || t >= T) continue;
    float4* v = reinterpret_cast<float4*>(tile + q * S + c4 * 4);
    const float4 s = reinterpret_cast<const float4*>(step_lb)[c4];
    float4 y = *v;
    y.x += s.x;
    y.y += s.y;
    y.z += s.z;
    y.w += s.w;
    *v = y;
    if (ybuf_b != nullptr && q >= d && q < d + TM)
      reinterpret_cast<float4*>(ybuf_b + (size_t)t * C)[c4] = y;
  }
}

// ------------------------------------------------------------ float32 forward
// One layer. The cond tile is an input of the whole call, so it is staged and
// its product (K = H) taken before griddep_wait, while the layer before
// drains; then y with its halo takes the same space for the taps (K = 3C),
// then g, for the out product.
template <int C, int H>
__global__ void __launch_bounds__(NTHR, 1)
fwd_layer_tc32(const float* __restrict__ x_in, float* __restrict__ x_out,
               float* __restrict__ skip, float* __restrict__ xs_next,
               const float* __restrict__ step, const float* __restrict__ cond,
               const float* __restrict__ k_cond, const float* __restrict__ b_cond,
               const float* __restrict__ w_dil, const float* __restrict__ b_dil,
               const float* __restrict__ w_out, const float* __restrict__ b_out, int B, int T,
               int l, int d) {
  constexpr int C2 = 2 * C, US = tile_stride32<C, H>(), WC = C / 8, NTH = C / 64;
  constexpr int NCD = H / KC, NCV = NCD + 3 * C / KC, NCH = NCV + C / KC;
  constexpr int STG = stage_elems32<C, H>();
  static_assert(C % 64 == 0 && H % KC == 0, "whole n-tiles and k-steps");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [TM][US] cond, then [TM + 2d][US] y (tile row q is frame t0 - d + q),
  // then [TM][US] g
  float* us = reinterpret_cast<float*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* wring = us + (size_t)(TM + 2 * d) * US + (size_t)warp * NST32 * STG;

  const int g8 = lane / 4, t4 = lane % 4;
  const int b = blockIdx.y, t0 = blockIdx.x * TM;
  const int wcol = warp * WC;
  const float* wd_l = w_dil + (size_t)l * 3 * C * C2;
  const float* kc_l = k_cond + (size_t)l * H * C2;
  const float* wo_l = w_out + (size_t)l * C * C2;
  const size_t row_b = (size_t)b * T;

  PHASE_CLOCK(3, 0);
  // up to griddep_wait() only inputs of the whole call are touched
  griddep_launch_dependents();
  for (int p = tid; p < TM * (H / 4); p += NTHR) {
    const int r = p / (H / 4), q = p % (H / 4), t = t0 + r;
    cp_async16_zfill(smem_u32(us + r * US + q * 4),
                     cond + (row_b + (t < T ? t : T - 1)) * H + q * 4, t < T);
  }
  cp_async_commit();
  // chunk ch: 16 rows of [k_cond[l] (H rows); w_dil[l] (3C rows); w_out[l]]
  auto fetch = [&](int ch) {
    const float* src = ch < NCD ? kc_l + (size_t)ch * KC * C2
                       : ch < NCV ? wd_l + (size_t)(ch - NCD) * KC * C2
                                  : wo_l + (size_t)(ch - NCV) * KC * C2;
    fetch_kn<C>(wring + (size_t)(ch % NST32) * STG, src + wcol, lane);
  };
#pragma unroll
  for (int s = 0; s < NST32 - 1; ++s) {
    fetch(s);
    cp_async_commit();
  }
  cp_async_wait<NST32 - 1>();   // this thread's part of the cond tile
  __syncthreads();              // the cond tile is staged
  PHASE_CLOCK(3, 1);

  float acc[4][2 * NTH][4];
  zero_acc(acc);
  for (int ch = 0; ch < NCD; ++ch) {
    RING_STEP(ch, NCH, NST32);
    mma32_kn<C>(acc, us + ch * KC, US, wring + (size_t)(ch % NST32) * STG, lane);
  }
  PHASE_CLOCK(3, 2);
  griddep_wait();   // the layer before has completed: x_in and skip are final
  if (l > 0)
    for (int i = tid; i < TM * (C * 4 / 128); i += NTHR) {
      const int t = t0 + i / (C * 4 / 128);
      if (t < T) prefetch_l2(skip + (row_b + t) * C + (i % (C * 4 / 128)) * 32);
    }
  __syncthreads();   // every warp is done with the cond tile
  stage_rows<C, US>(us, x_in + row_b * C, t0, d, T, tid);
  cp_async_commit();
  cp_async_wait<0>();
  add_step<C, US>(us, step + ((size_t)l * B + b) * C, t0, d, T, tid, nullptr);
  __syncthreads();   // y is staged
  PHASE_CLOCK(3, 3);
  for (int ch = NCD; ch < NCV; ++ch) {
    RING_STEP(ch, NCH, NST32);
    const int k = (ch - NCD) * KC, tap = k / C, c0 = k % C;
    // tile row r + tap d is frame t0 + r + (tap - 1) d
    mma32_kn<C>(acc, us + (size_t)(tap * d) * US + c0, US, wring + (size_t)(ch % NST32) * STG,
                lane);
  }
  PHASE_CLOCK(3, 4);
  // gate epilogue: biases, sigmoid * tanh into the gate accumulators
  {
    const float* bd_l = b_dil + (size_t)l * C2;
    const float* bc_l = b_cond + (size_t)l * C2;
#pragma unroll
    for (int nt = 0; nt < NTH; ++nt) {
      const int col = wcol + nt * 8 + 2 * t4;
      const float2 bg1 = *reinterpret_cast<const float2*>(bd_l + col);
      const float2 bg2 = *reinterpret_cast<const float2*>(bc_l + col);
      const float2 bf1 = *reinterpret_cast<const float2*>(bd_l + C + col);
      const float2 bf2 = *reinterpret_cast<const float2*>(bc_l + C + col);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float* ga = &acc[mt][nt][hr * 2];
          const float* fa = &acc[mt][NTH + nt][hr * 2];
          const float g0 = ga[0] + bg1.x + bg2.x, g1 = ga[1] + bg1.y + bg2.y;
          const float f0 = fa[0] + bf1.x + bf2.x, f1 = fa[1] + bf1.y + bf2.y;
          ga[0] = sigmoid_f(g0) * tanh_f(f0);
          ga[1] = sigmoid_f(g1) * tanh_f(f1);
        }
    }
  }
  __syncthreads();   // every warp has read its last y fragment: g may replace y
#pragma unroll
  for (int nt = 0; nt < NTH; ++nt)
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = mt * 16 + g8 + hr * 8;
        const float2 gv = t0 + r < T ? make_float2(acc[mt][nt][hr * 2], acc[mt][nt][hr * 2 + 1])
                                     : make_float2(0.f, 0.f);
        *reinterpret_cast<float2*>(us + (size_t)r * US + wcol + nt * 8 + 2 * t4) = gv;
      }
  zero_acc(acc);
  __syncthreads();   // every warp's g columns are written
  PHASE_CLOCK(3, 5);
  for (int ch = NCV; ch < NCH; ++ch) {
    RING_STEP(ch, NCH, NST32);
    mma32_kn<C>(acc, us + (ch - NCV) * KC, US, wring + (size_t)(ch % NST32) * STG, lane);
  }
  PHASE_CLOCK(3, 6);
  // residual epilogue: x_out = (x_in + res) * sqrt(1/2), skip (+)= sk,
  // xs[l+1] = x_out; x_in and skip in fragment order from device memory
  residual_epilogue<C>(acc, x_in, x_out, skip, xs_next, b_out + (size_t)l * C2, l == 0, row_b,
                       t0, T, wcol, lane);
  PHASE_CLOCK(3, 7);
}

// --------------------------------------------------------- float32 backward 1
// Row block of layer l: dg, recompute, gate derivatives. dout = [dx sqrt(1/2),
// ds] is staged one half at a time (K = C each) and summed by column; dg [64,
// C] does not fit beside the tile and the rings, so each thread parks its own
// dg accumulators in device memory (dgs, in the order it reads them back) and
// the tile takes cond, then y. Writes y, g, dconv, dout's dx half (dxh) in
// float32, and the block's column sums of dout (biaspart[1]) and of dconv
// (biaspart[0]).
template <int C, int H>
__global__ void __launch_bounds__(NTHR, 1)
bwd_gate_tc32(const float* __restrict__ xs_l, const float* __restrict__ step,
              const float* __restrict__ cond, const float* __restrict__ k_cond,
              const float* __restrict__ b_cond, const float* __restrict__ w_dil,
              const float* __restrict__ b_dil, const float* __restrict__ w_out,
              const float* __restrict__ ds, const float* __restrict__ dx,
              float* __restrict__ ybuf, float* __restrict__ gbuf, float* __restrict__ dconv,
              float* __restrict__ dxh, float* __restrict__ dgs, float* __restrict__ biaspart,
              int B, int T, int l, int d) {
  constexpr int C2 = 2 * C, US = tile_stride32<C, H>(), WC = C / 8, NTH = C / 64;
  constexpr int NDG = C2 / NKC, NCD = NDG + H / KC, NCH = NCD + 3 * C / KC;
  constexpr int STG = stage_elems32<C, H>();
  constexpr int DG_WARP = TM * WC;   // dg floats a warp parks: [64 (mt, nt, e)][32 lanes]
  static_assert(C % 64 == 0 && H % KC == 0 && C % NKC == 0, "whole n-tiles and k-steps");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [TM][US] a dout half, then [TM][US] cond, then [TM + 2d][US] y
  float* us = reinterpret_cast<float*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* wring = us + (size_t)(TM + 2 * d) * US + (size_t)warp * NST32 * STG;

  const int b = blockIdx.y, t0 = blockIdx.x * TM;
  const int blk = b * gridDim.x + blockIdx.x, nblk = gridDim.x * gridDim.y;
  const int wcol = warp * WC;
  const float* wd_l = w_dil + (size_t)l * 3 * C * C2;
  const float* kc_l = k_cond + (size_t)l * H * C2;
  const float* wo_l = w_out + (size_t)l * C * C2;
  const size_t row_b = (size_t)b * T;
  float* dg_own = dgs + ((size_t)blk * 8 + warp) * DG_WARP + lane;

  PHASE_CLOCK(4, 0);
  griddep_launch_dependents();
  // chunk ch: [n][k] chunks of w_out[l] (dg), then [k][n] chunks of k_cond[l]
  // and w_dil[l] (the recompute)
  auto fetch = [&](int ch) {
    float* dst = wring + (size_t)(ch % NST32) * STG;
    if (ch < NDG) fetch_nk<WC>(dst, wo_l + (size_t)wcol * C2 + ch * NKC, C2, lane);
    else if (ch < NCD) fetch_kn<C>(dst, kc_l + (size_t)(ch - NDG) * KC * C2 + wcol, lane);
    else fetch_kn<C>(dst, wd_l + (size_t)(ch - NCD) * KC * C2 + wcol, lane);
  };
#pragma unroll
  for (int s = 0; s < NST32 - 1; ++s) {
    fetch(s);
    cp_async_commit();
  }
  griddep_wait();   // dx of the layer above is final

  // dg = dout @ w_out^T, one half of dout's columns at a time
  {
    float accd[4][NTH][4];
    zero_acc(accd);
    for (int hf = 0; hf < 2; ++hf) {
      if (hf) __syncthreads();   // every warp is done with the dx half and its sums
      {
        constexpr int CP4 = C / 4, RPP = NTHR / CP4, NR = TM / RPP;
        const int c4 = tid % CP4, rq = tid / CP4;
        const float* src = hf ? ds : dx;
        float4 v[NR];
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          const int t = t0 + rq + i * RPP;
          v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (t < T) v[i] = reinterpret_cast<const float4*>(src + (row_b + t) * C)[c4];
        }
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          const int r = rq + i * RPP, t = t0 + r;
          if (!hf) {
            v[i].x *= SQRT_HALF;
            v[i].y *= SQRT_HALF;
            v[i].z *= SQRT_HALF;
            v[i].w *= SQRT_HALF;
            if (t < T) reinterpret_cast<float4*>(dxh + (row_b + t) * C)[c4] = v[i];
          }
          *reinterpret_cast<float4*>(us + (size_t)r * US + c4 * 4) = v[i];
        }
      }
      __syncthreads();   // the half is staged
      if (hf == 0) PHASE_CLOCK(4, 1);
      // the block's column sums of the half, rows in order (zero past T)
      for (int col = tid; col < C; col += NTHR) {
        float s = 0.f;
#pragma unroll 8
        for (int r = 0; r < TM; ++r) s += us[(size_t)r * US + col];
        biaspart[((size_t)nblk + blk) * C2 + hf * C + col] = s;
      }
      for (int ch = hf * (NDG / 2); ch < (hf + 1) * (NDG / 2); ++ch) {
        RING_STEP(ch, NCH, NST32);
        mma32_nk<NTH>(accd, us + (ch - hf * (NDG / 2)) * NKC, US,
                      wring + (size_t)(ch % NST32) * STG, lane);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTH; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dg_own[((mt * NTH + nt) * 4 + e) * 32] = accd[mt][nt][e];
  }
  PHASE_CLOCK(4, 2);

  // recompute: cond tile, its product; then y with its halo, the taps
  __syncthreads();   // every warp is done with the ds half
  for (int p = tid; p < TM * (H / 4); p += NTHR) {
    const int r = p / (H / 4), q = p % (H / 4), t = t0 + r;
    cp_async16_zfill(smem_u32(us + r * US + q * 4),
                     cond + (row_b + (t < T ? t : T - 1)) * H + q * 4, t < T);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();   // the cond tile is staged
  PHASE_CLOCK(4, 3);
  float acc[4][2 * NTH][4];
  zero_acc(acc);
  for (int ch = NDG; ch < NCD; ++ch) {
    RING_STEP(ch, NCH, NST32);
    mma32_kn<C>(acc, us + (ch - NDG) * KC, US, wring + (size_t)(ch % NST32) * STG, lane);
  }
  PHASE_CLOCK(4, 4);
  __syncthreads();   // every warp is done with the cond tile
  stage_rows<C, US>(us, xs_l + row_b * C, t0, d, T, tid);
  cp_async_commit();
  cp_async_wait<0>();
  add_step<C, US>(us, step + ((size_t)l * B + b) * C, t0, d, T, tid, ybuf + row_b * C);
  __syncthreads();   // y is staged
  PHASE_CLOCK(4, 5);
  for (int ch = NCD; ch < NCH; ++ch) {
    RING_STEP(ch, NCH, NST32);
    const int k = (ch - NCD) * KC, tap = k / C, c0 = k % C;
    mma32_kn<C>(acc, us + (size_t)(tap * d) * US + c0, US, wring + (size_t)(ch % NST32) * STG,
                lane);
  }
  PHASE_CLOCK(4, 6);

  // epilogue: sg, tf, g and dconv at once; column sums of dconv
  gate_grad_epilogue<C>(acc, dg_own, b_dil + (size_t)l * C2, b_cond + (size_t)l * C2, gbuf,
                        dconv, biaspart + (size_t)blk * C2, row_b, t0, T, wcol, lane);
  PHASE_CLOCK(4, 7);
}

// --------------------------------------------------------- float32 backward 2
// Row block of layer l: dy (three taps, K = 3 x 2C) and dcond (K = 2C) from
// the dconv tile with its halo, staged one half of its columns at a time (the
// whole tile, 198 KB at d = 16, does not fit beside the rings); both products
// stay in registers across the halves (64 + 64 accumulators). Epilogue:
// dx = dx sqrt(1/2) + dy in place, dcond +=, the block's column sums of dy.
template <int C, int H>
__global__ void __launch_bounds__(NTHR, 1)
bwd_dx_tc32(const float* __restrict__ dconv, const float* __restrict__ w_dil,
            const float* __restrict__ k_cond, float* __restrict__ dx, float* __restrict__ dcond,
            float* __restrict__ dsp, int B, int T, int l, int d) {
  constexpr int C2 = 2 * C, US = tile_stride32<C, H>(), WC = C / 8, WH = H / 8;
  constexpr int NTH = C / 64, NTHH = H / 64;
  constexpr int NKH = C / NKC;              // [n][k] chunks over one half of dconv's columns
  constexpr int NDY = 3 * NKH, NHF = NDY + NKH, NCH = 2 * NHF;
  constexpr int STG = stage_elems32<C, H>();
  static_assert(C % 64 == 0 && H % 64 == 0 && C % NKC == 0, "whole n-tiles and k-steps");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [TM + 2d][US] one half of dconv's columns, tile row q is frame t0 - d + q
  float* us = reinterpret_cast<float*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* wring = us + (size_t)(TM + 2 * d) * US + (size_t)warp * NST32 * STG;

  const int b = blockIdx.y, t0 = blockIdx.x * TM;
  const int blk = b * gridDim.x + blockIdx.x;
  const float* wd_l = w_dil + (size_t)l * 3 * C * C2;
  const float* kc_l = k_cond + (size_t)l * H * C2;
  const size_t row_b = (size_t)b * T;

  PHASE_CLOCK(5, 0);
  griddep_launch_dependents();
  // chunk ch of half hf: the taps' W_tap rows (the warp's dy columns), then
  // K's rows (the warp's dcond columns), k over the half's columns
  auto fetch = [&](int ch) {
    float* dst = wring + (size_t)(ch % NST32) * STG;
    const int hf = ch / NHF, c = ch % NHF;
    if (c < NDY) {
      const int seg = c / NKH, k0 = hf * C + (c % NKH) * NKC;
      fetch_nk<WC>(dst, wd_l + ((size_t)seg * C + warp * WC) * C2 + k0, C2, lane);
    } else {
      fetch_nk<WH>(dst, kc_l + (size_t)(warp * WH) * C2 + hf * C + (c - NDY) * NKC, C2, lane);
    }
  };
#pragma unroll
  for (int s = 0; s < NST32 - 1; ++s) {
    fetch(s);
    cp_async_commit();
  }
  griddep_wait();   // dconv of this layer is final

  float accy[4][NTH][4], accc[4][NTHH][4];
  zero_acc(accy);
  zero_acc(accc);
  for (int hf = 0; hf < 2; ++hf) {
    if (hf) __syncthreads();   // every warp is done with the first half
    for (int p = tid; p < (TM + 2 * d) * (C / 4); p += NTHR) {
      const int q = p / (C / 4), pc = p % (C / 4), t = t0 - d + q;
      const bool in = t >= 0 && t < T;
      cp_async16_zfill(smem_u32(us + (size_t)q * US + pc * 4),
                       dconv + (row_b + (in ? t : 0)) * C2 + hf * C + pc * 4, in);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();   // the half is staged
    PHASE_CLOCK(5, 1 + 2 * hf);
    // dy[t] = dconv[t+d] @ W0^T + dconv[t] @ W1^T + dconv[t-d] @ W2^T: tap
    // seg starts (2 - seg) d rows into the tile; dcond reads rows d ..
    for (int c = 0; c < NHF; ++c) {
      const int ch = hf * NHF + c;
      RING_STEP(ch, NCH, NST32);
      const float* wst = wring + (size_t)(ch % NST32) * STG;
      if (c < NDY) {
        const int seg = c / NKH, k0 = (c % NKH) * NKC;
        mma32_nk<NTH>(accy, us + (size_t)((2 - seg) * d) * US + k0, US, wst, lane);
      } else {
        mma32_nk<NTHH>(accc, us + (size_t)d * US + (c - NDY) * NKC, US, wst, lane);
      }
    }
    PHASE_CLOCK(5, 2 + 2 * hf);
  }
  dx_epilogue<NTH>(accy, dx, dsp + (size_t)blk * C, C, row_b, t0, T, warp * WC, lane);
  PHASE_CLOCK(5, 5);
  dcond_epilogue<NTHH>(accc, dcond, H, row_b, t0, T, warp * WH, lane);
  PHASE_CLOCK(5, 6);
}

// --------------------------------------------------------- float32 backward 3
// The weight gradients of layer l as in wgrad_tc, in 3xTF32. Both operands are
// stored by row ([r][m], [r][n]) and the m16n8k8 A fragment wants (m, r):
// ldmatrix.trans moves 16-bit elements only, so every fragment is four (A) or
// two (B) 32-bit shared loads in fragment order, t * WLD32 + g apart: the 32
// lanes hit 32 banks.
template <int C, int H>
__global__ void __launch_bounds__(NTHR, 1)
wgrad_tc32(const float* __restrict__ ybuf, const float* __restrict__ cond,
           const float* __restrict__ gbuf, const float* __restrict__ dconv,
           const float* __restrict__ dxh, const float* __restrict__ ds, float* __restrict__ part,
           int B, int T, int d, int bps) {
  constexpr int C2 = 2 * C, M_ALL = 3 * C + H + C;
  static_assert(C % WT == 0 && H % WT == 0, "whole tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);        // [WST32][WK32][WLD32]
  float* Bs = As + (size_t)WST32 * WK32 * WLD32;         // [WST32][WK32][WLD32]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * WT, n0 = blockIdx.y * WT, slab = blockIdx.z;

  const float *a_src, *b_src;
  int a_ld, b_ld, off = 0;
  if (m0 < 3 * C) {
    a_src = ybuf + m0 % C; a_ld = C; off = (m0 / C - 1) * d;
    b_src = dconv + n0; b_ld = C2;
  } else if (m0 < 3 * C + H) {
    a_src = cond + (m0 - 3 * C); a_ld = H;
    b_src = dconv + n0; b_ld = C2;
  } else {
    a_src = gbuf + (m0 - 3 * C - H); a_ld = C;
    b_src = n0 < C ? dxh + n0 : ds + (n0 - C); b_ld = C;
  }
  const int b_begin = slab * bps, b_end = min(B, b_begin + bps);
  const int n_t = (T + WK32 - 1) / WK32, nit = (b_end - b_begin) * n_t;

  griddep_launch_dependents();
  griddep_wait();   // y, g, dconv and dxh of this layer are final
  auto load = [&](int it) {
    const size_t row_b = (size_t)(b_begin + it / n_t) * T;
    const int tt0 = (it % n_t) * WK32;
    float* as = As + (size_t)(it % WST32) * WK32 * WLD32;
    float* bs = Bs + (size_t)(it % WST32) * WK32 * WLD32;
#pragma unroll
    for (int p = tid; p < WK32 * (WT / 4); p += NTHR) {
      const int r = p / (WT / 4), q = p % (WT / 4), t = tt0 + r, ta = t + off;
      const bool ok_b = t < T, ok_a = ok_b && ta >= 0 && ta < T;
      cp_async16_zfill(smem_u32(as + r * WLD32 + q * 4),
                       a_src + (row_b + (ok_a ? ta : 0)) * a_ld + q * 4, ok_a);
      cp_async16_zfill(smem_u32(bs + r * WLD32 + q * 4),
                       b_src + (row_b + (ok_b ? t : 0)) * b_ld + q * 4, ok_b);
    }
  };
#pragma unroll
  for (int s = 0; s < WST32 - 1; ++s) {
    if (s < nit) load(s);
    cp_async_commit();
  }
  // warp (wm, wn) owns rows [64 wm, +64) and columns [32 wn, +32) of the tile.
  // acc holds one 32-row slice's products; sum takes each slice with a
  // rounded float add: left in the tensor cores' accumulator for a whole
  // slab (12,000 rows at 24 x 1500), the sums drift from float32 by ~1e-4
  // of the gradients' scale, growing with the rows
  const int wm = warp / 4, wn = warp % 4, g8 = lane / 4, t4 = lane % 4;
  float acc[4][4][4], sum[4][4][4];
  zero_acc(sum);
  for (int it = 0; it < nit; ++it) {
    zero_acc(acc);
    cp_async_wait<WST32 - 2>();
    __syncthreads();   // stage `it` has landed; the stage of it - 1 is free
    if (it + WST32 - 1 < nit) load(it + WST32 - 1);
    cp_async_commit();
    const float* as = As + (size_t)(it % WST32) * WK32 * WLD32 + wm * 64;
    const float* bs = Bs + (size_t)(it % WST32) * WK32 * WLD32 + wn * 32;
#pragma unroll
    for (int k8 = 0; k8 < WK32 / 8; ++k8) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float* bp = bs + (k8 * 8 + t4) * WLD32 + ni * 8 + g8;   // (k t, n g)
        split_tf32(bp[0], bh[ni][0], bl[ni][0]);
        split_tf32(bp[4 * WLD32], bh[ni][1], bl[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const float* ap = as + (k8 * 8 + t4) * WLD32 + mi * 16 + g8;   // (m g, k t)
        uint32_t ah[4], al[4];
        split_tf32(ap[0], ah[0], al[0]);
        split_tf32(ap[8], ah[1], al[1]);
        split_tf32(ap[4 * WLD32], ah[2], al[2]);
        split_tf32(ap[4 * WLD32 + 8], ah[3], al[3]);
        mma3<4>(acc[mi], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[mi][ni][e] += acc[mi][ni][e];
  }
  float* out = part + ((size_t)slab * M_ALL + m0 + wm * 64) * C2 + n0 + wn * 32;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<float2*>(out + (size_t)(mi * 16 + g8 + hr * 8) * C2 + ni * 8 + 2 * t4) =
            make_float2(sum[mi][ni][hr * 2], sum[mi][ni][hr * 2 + 1]);
}

template <int C, int H>
int fwd_run32(const float* x0, float* xbuf, float* skip, float* xs, const float* step,
              const float* cond, const float* k_cond, const float* b_cond, const float* w_dil,
              const float* b_dil, const float* w_out, const float* b_out, int B, int T, int L,
              const int* dil, cudaStream_t s, int* n_launched) {
  n_launched[1] = 1;  // the report's second int: the tensor-core kernels ran
  const int dmax = max_dilation(dil, L);
  if (dmax < 1 || dmax > MAX_DIL) return (int)cudaErrorInvalidValue;
  TC_TRY(cudaFuncSetAttribute(fwd_layer_tc32<C, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_rows32<C, H>(dmax)));
  const dim3 grid((T + TM - 1) / TM, B);
  const size_t n = (size_t)B * T * C;
  for (int l = 0; l < L; ++l) {
    const float* xin = l == 0 ? x0 : xbuf + ((l - 1) % 2) * n;
    float* xs_next = (xs != nullptr && l + 1 < L) ? xs + (size_t)(l + 1) * n : nullptr;
    TC_TRY(launch(n_launched, fwd_layer_tc32<C, H>, grid, smem_rows32<C, H>(dil[l]), s, l > 0,
                  xin, xbuf + (l % 2) * n, skip, xs_next, step, cond, k_cond, b_cond, w_dil,
                  b_dil, w_out, b_out, B, T, l, dil[l]));
  }
  return (int)cudaSuccess;
}

// The float32 backward's scratch, carved from one allocation: y, g, dxh and
// the parked dg [B*T, C], dconv [B*T, 2C], all float32, then the partial sums.
struct BwdScratch32 {
  float *ybuf, *gbuf, *dconv, *dxh, *dgs, *biaspart, *dsp, *part;
  size_t bytes;
};
BwdScratch32 carve32(void* base, int B, int T, int C, int H) {
  const size_t nblk = (size_t)B * ((T + TM - 1) / TM), R = nblk * TM;
  char* p = (char*)base;
  size_t o = 0;
  auto take = [&](size_t n) { char* q = p + o; o += align256(n); return (float*)q; };
  BwdScratch32 s;
  s.ybuf = take((size_t)B * T * C * 4);
  s.gbuf = take((size_t)B * T * C * 4);
  s.dconv = take((size_t)B * T * 2 * C * 4);
  s.dxh = take((size_t)B * T * C * 4);
  s.dgs = take(R * C * 4);   // TM x C floats a row block, ragged blocks included
  s.biaspart = take(2 * nblk * 2 * C * 4);
  s.dsp = take(nblk * C * 4);
  s.part = take((size_t)slabs_for(B, C, H).n * (4 * C + H) * 2 * C * 4);
  s.bytes = o;
  return s;
}

template <int C, int H>
int bwd_run32(const float* xs, const float* step, const float* cond, const float* k_cond,
              const float* b_cond, const float* w_dil, const float* b_dil, const float* w_out,
              const float* ds, float* dx, float* dstep, float* dcond, float* dk_cond,
              float* dw_dil, float* db_dil, float* dw_out, float* db_out, void* scratch, int B,
              int T, int L, const int* dil, cudaStream_t s, int* n_launched) {
  n_launched[1] = 1;
  constexpr int C2 = 2 * C;
  const int dmax = max_dilation(dil, L);
  if (dmax < 1 || dmax > MAX_DIL) return (int)cudaErrorInvalidValue;
  TC_TRY(cudaFuncSetAttribute(bwd_gate_tc32<C, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_rows32<C, H>(dmax)));
  TC_TRY(cudaFuncSetAttribute(bwd_dx_tc32<C, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_rows32<C, H>(dmax)));
  TC_TRY(cudaFuncSetAttribute(wgrad_tc32<C, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)SMEM_WGRAD32));
  const Slabs sl = slabs_for(B, C, H);
  const BwdScratch32 sc = carve32(scratch, B, T, C, H);
  const int n_tile = (T + TM - 1) / TM, nblk = B * n_tile, bps = sl.batch_rows;
  const dim3 rows(n_tile, B);
  const dim3 wgrid((4 * C + H) / WT, C2 / WT, sl.n);
  const int red_blocks = 2 * NUM_SMS, sum_blocks = 2 * (C2 / 32) + B * (C / 32);
  const size_t n = (size_t)B * T * C;
  for (int l = L - 1; l >= 0; --l) {
    const int d = dil[l];
    TC_TRY(launch(n_launched, bwd_gate_tc32<C, H>, rows, smem_rows32<C, H>(d), s, l < L - 1,
                  xs + (size_t)l * n, step, cond, k_cond, b_cond, w_dil, b_dil, w_out, ds,
                  (const float*)dx, sc.ybuf, sc.gbuf, sc.dconv, sc.dxh, sc.dgs, sc.biaspart, B,
                  T, l, d));
    TC_TRY(launch(n_launched, bwd_dx_tc32<C, H>, rows, smem_rows32<C, H>(d), s, true,
                  (const float*)sc.dconv, w_dil, k_cond, dx, dcond, sc.dsp, B, T, l, d));
    TC_TRY(launch(n_launched, wgrad_tc32<C, H>, wgrid, SMEM_WGRAD32, s, true,
                  (const float*)sc.ybuf, cond, (const float*)sc.gbuf, (const float*)sc.dconv,
                  (const float*)sc.dxh, ds, sc.part, B, T, d, bps));
    TC_TRY(launch(n_launched, finish_kernel, dim3(red_blocks + sum_blocks), 0, s, true,
                  (const float*)sc.part, (int)wgrid.z, C, H, dw_dil + (size_t)l * 3 * C * C2,
                  dk_cond + (size_t)l * H * C2, dw_out + (size_t)l * C * C2,
                  (const float*)sc.biaspart, nblk, db_dil + (size_t)l * C2,
                  db_out + (size_t)l * C2, (const float*)sc.dsp, n_tile,
                  dstep + (size_t)l * B * C, red_blocks));
  }
  return (int)cudaSuccess;
}

}  // namespace tc

}  // namespace

// path: 0 = the SIMT kernels (dtype 0 float32 or 1 bfloat16), 1 = the
// tensor-core kernels (C = H = 256, dilations up to 16; dtype 1 the bfloat16
// kernels, dtype 0 the float32 ones in 3xTF32).
// report (two ints) is written by the code that ran: [0] the kernels it
// launched in this call, [1] which set they were (0 SIMT, 1 tensor cores).

// What the tensor-core kernels take and how they would run it: returns 1 when
// they serve this type, width and largest dilation, and then fills out with
// the weight-gradient slab count for B batch rows, the shared memory (bytes)
// of the forward, gate, dx and weight-gradient kernels at dmax, and the body
// (the dtype code: 1 bfloat16 products, 0 float32 in 3xTF32).
extern "C" int diffnet_train_tc_info(int dtype, int B, int C, int H, int dmax, int* out) {
  if ((dtype != 0 && dtype != 1) || C != 256 || H != 256 || dmax < 1 || dmax > tc::MAX_DIL)
    return 0;
  out[0] = tc::slabs_for(B, C, H).n;
  if (dtype == 1) {
    out[1] = (int)tc::smem_fwd<256, 256>(dmax);
    out[2] = (int)tc::smem_gate<256, 256>(dmax);
    out[3] = (int)tc::smem_dx<256, 256>(dmax);
    out[4] = (int)tc::SMEM_WGRAD;
  } else {
    out[1] = out[2] = out[3] = (int)tc::smem_rows32<256, 256>(dmax);
    out[4] = (int)tc::SMEM_WGRAD32;
  }
  out[5] = dtype;
  return 1;
}

// Bytes of scratch the backward needs for these shapes.
extern "C" long long diffnet_train_bwd_scratch_bytes(int path, int dtype, int B, int T, int C,
                                                     int H) {
  if (path == 1)
    return (long long)(dtype == 1 ? tc::carve(nullptr, B, T, C, H).bytes
                                  : tc::carve32(nullptr, B, T, C, H).bytes);
  const Dims g{B, T, C, H, B * T};
  return (long long)simt_carve(nullptr, g, dtype == 1 ? 2 : 4).bytes;
}

// cond, k_cond, w_dil, w_out and xs are in the compute type.
// path 0: x [B,T,C] f32 starts as x0 and is updated in place; skip [B,T,C]
// f32 must start at zero; scratch is g [B*T, C] in the compute type.
// path 1: x is x0, read only; skip needs no initial value; scratch is two
// [B,T,C] f32 buffers.
// xs [L,B,T,C] (or null: no saves) has xs[0] written by the caller.
// Returns a cudaError_t code.
extern "C" int diffnet_train_fwd(int path, int dtype, void* x, void* skip, void* scratch,
                                 void* xs, const void* step, const void* cond,
                                 const void* k_cond, const void* b_cond, const void* w_dil,
                                 const void* b_dil, const void* w_out, const void* b_out,
                                 int B, int T, int C, int H, int L, const int* dil,
                                 void* stream, int* report) {
  typedef __nv_bfloat16 bf16;
  cudaStream_t s = (cudaStream_t)stream;
  report[0] = 0;
  report[1] = -1;
  if (path == 1) {
    if (C != 256 || H != 256) return (int)cudaErrorInvalidValue;
    if (dtype == 1)
      return tc::fwd_run<256, 256>((const float*)x, (float*)scratch, (float*)skip, (bf16*)xs,
                                   (const float*)step, (const bf16*)cond, (const bf16*)k_cond,
                                   (const float*)b_cond, (const bf16*)w_dil,
                                   (const float*)b_dil, (const bf16*)w_out,
                                   (const float*)b_out, B, T, L, dil, s, report);
    if (dtype == 0)
      return tc::fwd_run32<256, 256>((const float*)x, (float*)scratch, (float*)skip, (float*)xs,
                                     (const float*)step, (const float*)cond,
                                     (const float*)k_cond, (const float*)b_cond,
                                     (const float*)w_dil, (const float*)b_dil,
                                     (const float*)w_out, (const float*)b_out, B, T, L, dil, s,
                                     report);
    return (int)cudaErrorInvalidValue;
  }
  if (path != 0 || C % HALF != 0) return (int)cudaErrorInvalidValue;
  const Dims gd{B, T, C, H, B * T};
  if (dtype == 0)
    return fwd_run<float>((float*)x, (float*)skip, (float*)scratch, (float*)xs,
                          (const float*)step, (const float*)cond, (const float*)k_cond,
                          (const float*)b_cond, (const float*)w_dil, (const float*)b_dil,
                          (const float*)w_out, (const float*)b_out, gd, L, dil, s, report);
  if (dtype == 1)
    return fwd_run<bf16>((float*)x, (float*)skip, (bf16*)scratch, (bf16*)xs, (const float*)step,
                         (const bf16*)cond, (const bf16*)k_cond, (const float*)b_cond,
                         (const bf16*)w_dil, (const float*)b_dil, (const bf16*)w_out,
                         (const float*)b_out, gd, L, dil, s, report);
  return (int)cudaErrorInvalidValue;
}

// Backward. ds [B,T,C] in the compute type; dx [B,T,C] and dcond [B,T,H] f32
// must start at zero; outputs dstep [L,B,C], dk_cond [L,H,2C], dw_dil
// [L,3,C,2C], db_dil [L,2C] (= db_cond), dw_out [L,C,2C], db_out [L,2C], all
// f32; scratch of diffnet_train_bwd_scratch_bytes bytes. Nothing else is
// written.
extern "C" int diffnet_train_bwd(int path, int dtype, const void* xs, const void* step,
                                 const void* cond, const void* k_cond, const void* b_cond,
                                 const void* w_dil, const void* b_dil, const void* w_out,
                                 const void* ds, void* dx, void* dstep, void* dcond,
                                 void* dk_cond, void* dw_dil, void* db_dil, void* dw_out,
                                 void* db_out, void* scratch, int B, int T, int C, int H,
                                 int L, const int* dil, void* stream, int* report) {
  typedef __nv_bfloat16 bf16;
  cudaStream_t s = (cudaStream_t)stream;
  report[0] = 0;
  report[1] = -1;
  if (path == 1) {
    if (C != 256 || H != 256) return (int)cudaErrorInvalidValue;
    if (dtype == 1)
      return tc::bwd_run<256, 256>(
          (const bf16*)xs, (const float*)step, (const bf16*)cond, (const bf16*)k_cond,
          (const float*)b_cond, (const bf16*)w_dil, (const float*)b_dil, (const bf16*)w_out,
          (const bf16*)ds, (float*)dx, (float*)dstep, (float*)dcond, (float*)dk_cond,
          (float*)dw_dil, (float*)db_dil, (float*)dw_out, (float*)db_out, scratch, B, T, L,
          dil, s, report);
    if (dtype == 0)
      return tc::bwd_run32<256, 256>(
          (const float*)xs, (const float*)step, (const float*)cond, (const float*)k_cond,
          (const float*)b_cond, (const float*)w_dil, (const float*)b_dil, (const float*)w_out,
          (const float*)ds, (float*)dx, (float*)dstep, (float*)dcond, (float*)dk_cond,
          (float*)dw_dil, (float*)db_dil, (float*)dw_out, (float*)db_out, scratch, B, T, L,
          dil, s, report);
    return (int)cudaErrorInvalidValue;
  }
  if (path != 0 || C % HALF != 0) return (int)cudaErrorInvalidValue;
  const Dims gd{B, T, C, H, B * T};
  if (dtype == 0)
    return bwd_run<float>(
        (const float*)xs, (const float*)step, (const float*)cond, (const float*)k_cond,
        (const float*)b_cond, (const float*)w_dil, (const float*)b_dil, (const float*)w_out,
        (const float*)ds, (float*)dx, (float*)dstep, (float*)dcond, (float*)dk_cond,
        (float*)dw_dil, (float*)db_dil, (float*)dw_out, (float*)db_out, scratch, gd, L, dil, s,
        report);
  if (dtype == 1)
    return bwd_run<bf16>(
        (const bf16*)xs, (const float*)step, (const bf16*)cond, (const bf16*)k_cond,
        (const float*)b_cond, (const bf16*)w_dil, (const float*)b_dil, (const bf16*)w_out,
        (const bf16*)ds, (float*)dx, (float*)dstep, (float*)dcond, (float*)dk_cond,
        (float*)dw_dil, (float*)db_dil, (float*)dw_out, (float*)db_out, scratch, gd, L, dil, s,
        report);
  return (int)cudaErrorInvalidValue;
}

#ifdef TRAIN_PHASE_CLOCKS
// Copies the recorded clocks ([6 kernels][1024 blocks][8] int64) to the host.
extern "C" int diffnet_train_read_clocks(long long* dst) {
  return (int)cudaMemcpyFromSymbol(dst, tc::g_clk, sizeof(tc::g_clk));
}
#endif
