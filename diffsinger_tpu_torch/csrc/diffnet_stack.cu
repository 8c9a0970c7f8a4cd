// Fused DiffNet residual stack for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel diffsinger_tpu/ops/diffnet_stack.py:
// diffnet_stack (pallas_call at :311, body _make_kernel :54-132).
//
// What it computes, per layer l with dilation d (x [B,T,C] f32, in place):
//   y    = cast(x + step[l])                       (f32 add, then input type)
//   conv = y[t-d] @ w_dil[l,0] + y[t] @ w_dil[l,1] + y[t+d] @ w_dil[l,2]
//          + b_dil[l] + cond[l]                    (f32 accumulation; rows
//                                                   outside [0,T) read zero)
//   g    = cast(sigmoid(conv[:, :C]) * tanh(conv[:, C:]))
//   out  = g @ w_out[l] + b_out[l]
//   x    = (x + out[:, :C]) * sqrt(1/2);  skip += out[:, C:]
//
// Design. The TPU kernel keeps the whole [T,C] activation and skip sum
// resident in a 9 MB VMEM budget across all layers; one H100 block has 227 KB
// of shared memory, so that does not carry over. Here each layer is a pair of
// launches: (A) the dilated-conv GEMM with bias, cond and the gate in its
// epilogue, writing g; (B) the out-projection GEMM with the residual update
// of x and the skip accumulation in its epilogue. A block of kernel A owns a
// 64-row tile and the matching gate columns j and filter columns j + C, so the
// gate is computed locally. Neighbouring rows are read straight from global
// memory, zero-filled only outside [0,T), so no chunk/halo stitching exists.
//
// Bound. At B=8, T=1024, C=256, L=20 one stack call does 171.8 GFLOP and
// moves ~205 MB (168 MB of it the bf16 cond tensor): compute-bound on this
// card. This first version is a shared-memory tiled SIMT GEMM (f32 FMA on
// values converted from the input type), far from the tensor-core peak;
// wgmma/TMA tiles are the next step.

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

constexpr int BM = 64;    // rows per block
constexpr int BNH = 32;   // columns per half (gate|filter, residual|skip)
constexpr int BK = 16;    // contraction slice staged in shared memory
constexpr int NT = 256;   // threads: 16 row groups x 16 column groups
constexpr float SQRT_HALF = 0.70710678118654752f;

// Kernel A: gated dilated conv of layer l -> g [B*T, C].
template <typename In>
__global__ void __launch_bounds__(NT)
gate_kernel(const float* __restrict__ x, const float* __restrict__ step,
            const In* __restrict__ cond, const In* __restrict__ w_dil,
            const float* __restrict__ b_dil, In* __restrict__ g,
            int B, int T, int C, int l, int d) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][2 * BNH];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int BT = B * T;
  const int row0 = blockIdx.x * BM;
  const int j0 = blockIdx.y * BNH;
  const int C2 = 2 * C;
  float acc[4][2][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j) acc[i][h][j] = 0.f;

  for (int k0 = 0; k0 < 3 * C; k0 += BK) {
    const int tap = k0 / C, c0 = k0 % C;
    __syncthreads();
#pragma unroll
    for (int q = 0; q < (BM * BK) / NT; ++q) {
      const int e = tid + q * NT, r = e / BK, kk = e % BK;
      const int R = row0 + r;
      float v = 0.f;
      if (R < BT) {
        const int b = R / T, t = R % T, ts = t + (tap - 1) * d;
        if (ts >= 0 && ts < T) {
          const int c = c0 + kk;
          v = to_f(from_f<In>(x[((size_t)b * T + ts) * C + c] +
                              step[((size_t)l * B + b) * C + c]));
        }
      }
      As[kk][r] = v;
    }
#pragma unroll
    for (int q = 0; q < (BK * 2 * BNH) / NT; ++q) {
      const int e = tid + q * NT, kk = e / (2 * BNH), n = e % (2 * BNH);
      const int col = (n / BNH) * C + j0 + (n % BNH);
      Bs[kk][n] = to_f(w_dil[(((size_t)l * 3 + tap) * C + c0 + kk) * C2 + col]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], bv[2][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 2; ++j) bv[h][j] = Bs[kk][h * BNH + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 2; ++j) acc[i][h][j] = fmaf(a[i], bv[h][j], acc[i][h][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int R = row0 + ty + 16 * i;
    if (R >= BT) continue;
    const size_t crow = ((size_t)l * BT + R) * C2;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = j0 + tx + 16 * j;
      const float gate = acc[i][0][j] + b_dil[(size_t)l * C2 + col] + to_f(cond[crow + col]);
      const float filt = acc[i][1][j] + b_dil[(size_t)l * C2 + C + col] +
                         to_f(cond[crow + C + col]);
      const float sig = 1.f / (1.f + expf(-gate));
      g[(size_t)R * C + col] = from_f<In>(sig * tanhf(filt));
    }
  }
}

// Kernel B: out projection of layer l, residual update of x, skip sum.
template <typename In>
__global__ void __launch_bounds__(NT)
out_kernel(float* __restrict__ x, float* __restrict__ skip, const In* __restrict__ g,
           const In* __restrict__ w_out, const float* __restrict__ b_out,
           int BT, int C, int l) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][2 * BNH];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * BM;
  const int j0 = blockIdx.y * BNH;
  const int C2 = 2 * C;
  float acc[4][2][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j) acc[i][h][j] = 0.f;

  for (int k0 = 0; k0 < C; k0 += BK) {
    __syncthreads();
#pragma unroll
    for (int q = 0; q < (BM * BK) / NT; ++q) {
      const int e = tid + q * NT, r = e / BK, kk = e % BK;
      const int R = row0 + r;
      As[kk][r] = R < BT ? to_f(g[(size_t)R * C + k0 + kk]) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < (BK * 2 * BNH) / NT; ++q) {
      const int e = tid + q * NT, kk = e / (2 * BNH), n = e % (2 * BNH);
      const int col = (n / BNH) * C + j0 + (n % BNH);
      Bs[kk][n] = to_f(w_out[((size_t)l * C + k0 + kk) * C2 + col]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], bv[2][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 2; ++j) bv[h][j] = Bs[kk][h * BNH + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 2; ++j) acc[i][h][j] = fmaf(a[i], bv[h][j], acc[i][h][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int R = row0 + ty + 16 * i;
    if (R >= BT) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = j0 + tx + 16 * j;
      const size_t o = (size_t)R * C + col;
      const float res = acc[i][0][j] + b_out[(size_t)l * C2 + col];
      const float sk = acc[i][1][j] + b_out[(size_t)l * C2 + C + col];
      x[o] = (x[o] + res) * SQRT_HALF;
      skip[o] += sk;
    }
  }
}

template <typename In>
int run(float* x, float* skip, In* g, const float* step, const In* cond,
        const In* w_dil, const float* b_dil, const In* w_out, const float* b_out,
        int B, int T, int C, int L, const int* dil, cudaStream_t stream) {
  const int BT = B * T;
  const dim3 grid((BT + BM - 1) / BM, C / BNH);
  for (int l = 0; l < L; ++l) {
    gate_kernel<In><<<grid, NT, 0, stream>>>(x, step, cond, w_dil, b_dil, g,
                                             B, T, C, l, dil[l]);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    out_kernel<In><<<grid, NT, 0, stream>>>(x, skip, g, w_out, b_out, BT, C, l);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 inputs, 1 = bfloat16 inputs (cond, w_dil, w_out, g).
// x [B,T,C] f32 is updated in place; skip [B,T,C] f32 must start at zero;
// g is scratch [B*T, C] of the input type. Returns a cudaError_t code.
extern "C" int diffnet_stack_run(int dtype, void* x, void* skip, void* g,
                                 const void* step, const void* cond,
                                 const void* w_dil, const void* b_dil,
                                 const void* w_out, const void* b_out,
                                 int B, int T, int C, int L, const int* dil,
                                 void* stream) {
  if (C % BNH != 0 || C % BK != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return run<float>((float*)x, (float*)skip, (float*)g, (const float*)step,
                      (const float*)cond, (const float*)w_dil, (const float*)b_dil,
                      (const float*)w_out, (const float*)b_out, B, T, C, L, dil, s);
  if (dtype == 1)
    return run<__nv_bfloat16>((float*)x, (float*)skip, (__nv_bfloat16*)g,
                              (const float*)step, (const __nv_bfloat16*)cond,
                              (const __nv_bfloat16*)w_dil, (const float*)b_dil,
                              (const __nv_bfloat16*)w_out, (const float*)b_out,
                              B, T, C, L, dil, s);
  return (int)cudaErrorInvalidValue;
}
