// DiffNet residual stack for TRAINING on Hopper (sm_90a), plain C interface:
// a forward that saves each layer's input, and a backward that walks the
// layers in reverse. Every product of the TPU kernel bodies runs here.
//
// Replaces the Pallas TPU kernels of diffsinger_tpu/ops/diffnet_train.py:
//   _fwd_call (pallas_call at :315, body _make_fwd_kernel :74-135)  -> diffnet_train_fwd
//   _bwd_call (pallas_call at :389, body _make_bwd_kernel :141-257) -> diffnet_train_bwd
//
// Forward, per layer l with dilation d (x [R=B*T, C] f32, updated in place):
//   xs[l] = cast(x)                                   (saved for the backward)
//   y     = cast(x + step[l])                         (f32 add, then input type)
//   conv  = y[t-d] @ W0 + y[t] @ W1 + y[t+d] @ W2 + cond @ K[l]
//           + b_dil[l] + b_cond[l]                    (f32 accumulation)
//   g     = cast(sigmoid(conv[:, :C]) * tanh(conv[:, C:]))
//   out   = g @ w_out[l] + b_out[l]
//   x     = (x + out[:, :C]) * sqrt(1/2);   skip += out[:, C:]
// Two launches per layer: (A) one GEMM with K = 3C + H (the three taps and
// the cond projection, read straight from x and cond) with the gate in its
// epilogue; (B) the out projection with the residual, skip and xs[l+1]
// writes in its epilogue. xs[0] is written by the caller.
//
// Backward, per layer in reverse, carrying dx [R, C] f32 and dcond [R, H] f32:
//   1 recompute  conv (f32) and g from xs[l]: y = cast(float(xs) + step), as
//                the TPU kernel does from its bf16-saved xs
//   2 dg         dg = cast(dout) @ w_out^T, dout = [dx*sqrt(1/2), ds];
//                epilogue dconv = [dg*tf*sg*(1-sg), dg*sg*(1-tf^2)] (f32)
//   3 wgrad      [dW_dil taps; dK] = [y[t-d], y, y[t+d], cond]^T @ cast(dconv)
//   4 reduce     split-K partials -> dw_dil[l], dk_cond[l]
//   5 wgrad      dW_out = cast(g)^T @ cast(dout)
//   6 reduce     -> dw_out[l]
//   7 bias       column sums of dconv (db_dil = db_cond) and of dout (db_out)
//   8 reduce x2  -> db_dil[l]; -> db_out[l]
//  10 dcond      dcond += cast(dconv) @ K^T
//  11 dy         dy = sum_tap shift(cast(dconv) @ W_tap^T) (tap 0 read y[t-d],
//                so its cotangent lands at t-d); epilogue dx = dx*sqrt(1/2)+dy
//  12 dstep      dstep[l, b] = sum over t of dy
// Twelve launches per layer: each product has its own output shape, and the
// three contractions over all B*T rows (3, 5, 7) need a second, reducing pass
// (4, 6, 8-9) to stay deterministic. No atomics: every partial slab is summed in a fixed
// order, so two runs give the same bits.
//
// Gradient layout. The TPU kernel writes weight gradients per batch tile in
// bf16 and rounds dcond to bf16, both to fit its 16 MB VMEM. Here weight
// gradients and dcond are accumulated and returned in f32.
//
// Bound. At B=24, T=1024, C=H=256, L=20 the forward does 644 GFLOP and the
// backward 1.80 TFLOP; the bytes are well under a GB, so both are
// operation-bound on this card. This first version is a shared-memory tiled
// SIMT GEMM (f32 FMA on values converted from the input type), far from the
// tensor-core peak; wgmma/TMA tiles are later work. Neighbour rows of a
// dilation tap are read from global memory with zero fill only outside [0,T)
// of the same batch row, so a shift never crosses into the next batch row.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

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

#define LAUNCH_CHECK()                              \
  do {                                              \
    cudaError_t err_ = cudaGetLastError();          \
    if (err_ != cudaSuccess) return (int)err_;      \
  } while (0)

template <typename In>
int fwd_run(float* x, float* skip, In* gbuf, In* xs, const float* step, const In* cond,
            const In* k_cond, const float* b_cond, const In* w_dil, const float* b_dil,
            const In* w_out, const float* b_out, Dims g, int L, const int* dil,
            cudaStream_t s) {
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
            float* dw_dil, float* db_dil, float* dw_out, float* db_out, float* conv,
            In* gbuf, float* dconv, float* dy, float* part, Dims g, int L, const int* dil,
            cudaStream_t s) {
  const int C = g.C, C2 = 2 * C;
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

}  // namespace

// Floats of split-K scratch the backward needs for these shapes.
extern "C" long long diffnet_train_part_floats(int B, int T, int C, int H) {
  const Dims g{B, T, C, H, B * T};
  return (long long)part_floats(g);
}

// dtype: 0 = float32, 1 = bfloat16 for cond, k_cond, w_dil, w_out, g and xs.
// x [B,T,C] f32 starts as x0 and is updated in place; skip [B,T,C] f32 must
// start at zero; g is scratch [B*T, C]; xs [L,B,T,C] (or null: no saves) has
// xs[0] written by the caller. Returns a cudaError_t code.
extern "C" int diffnet_train_fwd(int dtype, void* x, void* skip, void* g, void* xs,
                                 const void* step, const void* cond, const void* k_cond,
                                 const void* b_cond, const void* w_dil, const void* b_dil,
                                 const void* w_out, const void* b_out, int B, int T, int C,
                                 int H, int L, const int* dil, void* stream) {
  if (C % HALF != 0) return (int)cudaErrorInvalidValue;
  const Dims gd{B, T, C, H, B * T};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return fwd_run<float>((float*)x, (float*)skip, (float*)g, (float*)xs, (const float*)step,
                          (const float*)cond, (const float*)k_cond, (const float*)b_cond,
                          (const float*)w_dil, (const float*)b_dil, (const float*)w_out,
                          (const float*)b_out, gd, L, dil, s);
  if (dtype == 1)
    return fwd_run<__nv_bfloat16>(
        (float*)x, (float*)skip, (__nv_bfloat16*)g, (__nv_bfloat16*)xs, (const float*)step,
        (const __nv_bfloat16*)cond, (const __nv_bfloat16*)k_cond, (const float*)b_cond,
        (const __nv_bfloat16*)w_dil, (const float*)b_dil, (const __nv_bfloat16*)w_out,
        (const float*)b_out, gd, L, dil, s);
  return (int)cudaErrorInvalidValue;
}

// Backward. ds [B,T,C] in the input type; dx [B,T,C] and dcond [B,T,H] f32
// must start at zero; outputs dstep [L,B,C], dk_cond [L,H,2C], dw_dil
// [L,3,C,2C], db_dil [L,2C] (= db_cond), dw_out [L,C,2C], db_out [L,2C], all
// f32. Scratch: conv [B*T,2C] f32, g [B*T,C] input type, dconv [B*T,2C] f32,
// dy [B*T,C] f32, part of diffnet_train_part_floats floats.
extern "C" int diffnet_train_bwd(int dtype, const void* xs, const void* step,
                                 const void* cond, const void* k_cond, const void* b_cond,
                                 const void* w_dil, const void* b_dil, const void* w_out,
                                 const void* ds, void* dx, void* dstep, void* dcond,
                                 void* dk_cond, void* dw_dil, void* db_dil, void* dw_out,
                                 void* db_out, void* conv, void* g, void* dconv, void* dy,
                                 void* part, int B, int T, int C, int H, int L,
                                 const int* dil, void* stream) {
  if (C % HALF != 0) return (int)cudaErrorInvalidValue;
  const Dims gd{B, T, C, H, B * T};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return bwd_run<float>(
        (const float*)xs, (const float*)step, (const float*)cond, (const float*)k_cond,
        (const float*)b_cond, (const float*)w_dil, (const float*)b_dil, (const float*)w_out,
        (const float*)ds, (float*)dx, (float*)dstep, (float*)dcond, (float*)dk_cond,
        (float*)dw_dil, (float*)db_dil, (float*)dw_out, (float*)db_out, (float*)conv,
        (float*)g, (float*)dconv, (float*)dy, (float*)part, gd, L, dil, s);
  if (dtype == 1)
    return bwd_run<__nv_bfloat16>(
        (const __nv_bfloat16*)xs, (const float*)step, (const __nv_bfloat16*)cond,
        (const __nv_bfloat16*)k_cond, (const float*)b_cond, (const __nv_bfloat16*)w_dil,
        (const float*)b_dil, (const __nv_bfloat16*)w_out, (const __nv_bfloat16*)ds,
        (float*)dx, (float*)dstep, (float*)dcond, (float*)dk_cond, (float*)dw_dil,
        (float*)db_dil, (float*)dw_out, (float*)db_out, (float*)conv, (__nv_bfloat16*)g,
        (float*)dconv, (float*)dy, (float*)part, gd, L, dil, s);
  return (int)cudaErrorInvalidValue;
}
