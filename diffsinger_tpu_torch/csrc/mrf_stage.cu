// One whole HiFiGAN multi-receptive-field (MRF) scale for Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas TPU kernels diffsinger_tpu/ops/hifigan_mrf.py:fused_mrf
// (pallas_call at :197, body :64-136) and its time-folded sibling
// diffsinger_tpu/ops/hifigan_packed_mrf.py:fused_packed_stage (pallas_call at
// :231). The fold there only filled the TPU's 128 lanes; this kernel computes
// the same function on the standard [B, T, C] layout.
//
// What it computes: out = mean over branches b of chain_b(x), where a chain
// runs, for each stage s with dilation d:
//   y  = cast(lrelu(xc));  y = conv_{k_b,d}(y) + b1;  y = cast(mask(lrelu(y)))
//   y  = conv_{k_b,1}(y) + b2;  xc = mask(cast(xc + y))
// with every convolution zero-padded at the sequence edges (mask() zeroes rows
// outside [0,T): the bias and lrelu make them nonzero otherwise). f32
// accumulation; cast() rounds to the input type (identity for float32).
//
// Design. One block owns one T tile of one batch row plus the chain halo H
// (sum over stages of half*d + half: 60 rows for k=11, d=(1,3,5)) and keeps
// that window in shared memory across all 18 convolutions: one buffer holds
// the chain state xc, the other the intermediate y (2 * R * C floats, R rows).
// Only x is read from and the output written to global memory; weights
// (k*C*C per conv) stream from L2 in 16-row slices. Rows whose taps leave the
// window compute garbage that never reaches the tile's centre, because the
// window is H rows wider than the tile on each side.
//
// Bound. 252 * C^2 FLOP per frame and batch row, i.e. 2.16, 1.08 and 0.54
// TFLOP for the C = 128, 64, 32 scales at 8 x 1024 mel frames: compute-bound
// at the float32 SIMT peak. This first version is a SIMT FMA kernel; the
// window recompute (R / tile rows: 2.7x at C=128, where 2H=120 of R=192 rows
// are halo) is its main overhead besides the missing tensor-core path.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

constexpr int NT = 256;   // 16 row groups x 16 column groups
constexpr int BK = 16;    // input channels per staged weight slice
constexpr int RC = 64;    // rows per output chunk
constexpr float SLOPE = 0.1f;
constexpr int MAXB = 4;   // branches / stages a plan may hold

struct Plan {
  int nb, ns, kmax;
  int ks[MAXB];
  int dil[MAXB][MAXB];
};

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : SLOPE * v; }

// One convolution over the whole window. FIRST: src = xc, input lrelu+cast,
// output y = cast(mask(lrelu(conv + bias))) into dst. Otherwise: src = y,
// output xc = mask(cast(xc + conv + bias)) updated in place in dst.
template <typename In, int C, bool FIRST>
__device__ __forceinline__ void conv(const float* __restrict__ src, float* __restrict__ dst,
                                     float* __restrict__ ws, const In* __restrict__ w,
                                     const float* __restrict__ bias, int k, int d,
                                     int R, int win0, int T) {
  constexpr int NC = C / 16;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int half = (k - 1) / 2;
  for (int rc = 0; rc < R; rc += RC) {
    float acc[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
    for (int tap = 0; tap < k; ++tap) {
      const int off = (tap - half) * d;
      for (int kc = 0; kc < C; kc += BK) {
        __syncthreads();
        for (int e = tid; e < BK * C; e += NT)
          ws[e] = to_f(w[(size_t)(tap * C + kc) * C + e]);
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
          float a[4], bv[NC];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int sr = rc + ty + 16 * i + off;
            float v = (sr >= 0 && sr < R) ? src[sr * C + kc + kk] : 0.f;
            if (FIRST) v = round_to<In>(lrelu(v));
            a[i] = v;
          }
#pragma unroll
          for (int j = 0; j < NC; ++j) bv[j] = ws[kk * C + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rc + ty + 16 * i;
      const int gr = win0 + row;
      const bool valid = gr >= 0 && gr < T;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int col = tx + 16 * j;
        const float v = acc[i][j] + bias[col];
        if (FIRST) {
          dst[row * C + col] = valid ? round_to<In>(lrelu(v)) : 0.f;
        } else {
          const float nv = round_to<In>(dst[row * C + col] + v);
          dst[row * C + col] = valid ? nv : 0.f;
        }
      }
    }
  }
}

template <typename In, int C>
__global__ void __launch_bounds__(NT)
mrf_kernel(const In* __restrict__ x, const In* __restrict__ w1,
           const float* __restrict__ b1, const In* __restrict__ w2,
           const float* __restrict__ b2, float* __restrict__ out,
           int T, int TT, int R, int H, Plan plan) {
  extern __shared__ float smem[];
  float* xc = smem;
  float* yb = smem + R * C;
  float* ws = yb + R * C;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int win0 = t0 - H;
  const In* xb = x + (size_t)b * T * C;
  float* ob = out + (size_t)b * T * C;
  const size_t wstride = (size_t)plan.kmax * C * C;
  const float inv_nb = 1.f / plan.nb;

  for (int bj = 0; bj < plan.nb; ++bj) {
    __syncthreads();
    for (int e = tid; e < R * C; e += NT) {
      const int gr = win0 + e / C;
      xc[e] = (gr >= 0 && gr < T) ? to_f(xb[(size_t)gr * C + e % C]) : 0.f;
    }
    __syncthreads();
    const int k = plan.ks[bj];
    for (int s = 0; s < plan.ns; ++s) {
      const int cs = bj * plan.ns + s;
      conv<In, C, true>(xc, yb, ws, w1 + cs * wstride, b1 + cs * C, k,
                        plan.dil[bj][s], R, win0, T);
      __syncthreads();
      conv<In, C, false>(yb, xc, ws, w2 + cs * wstride, b2 + cs * C, k, 1, R,
                         win0, T);
      __syncthreads();
    }
    for (int e = tid; e < TT * C; e += NT) {
      const int gr = t0 + e / C;
      if (gr >= T) continue;
      const float v = xc[(H + e / C) * C + e % C];
      float* o = ob + (size_t)gr * C + e % C;
      float acc = bj == 0 ? v : *o + v;
      if (bj == plan.nb - 1) acc = acc * inv_nb;
      *o = acc;
    }
  }
}

template <typename In, int C>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, void* out, int B, int T, int H, const Plan& plan,
           cudaStream_t stream) {
  const int budget = 220 * 1024 / 4;  // floats of dynamic shared memory
  int R = ((budget - BK * C) / (2 * C)) / RC * RC;
  const int need = ((T + 2 * H + RC - 1) / RC) * RC;
  if (need < R) R = need;
  const int TT = R - 2 * H;
  if (TT <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(2 * R * C + BK * C) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(mrf_kernel<In, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + TT - 1) / TT, B);
  mrf_kernel<In, C><<<grid, NT, smem, stream>>>(
      (const In*)x, (const In*)w1, (const float*)b1, (const In*)w2,
      (const float*)b2, (float*)out, T, TT, R, H, plan);
  return (int)cudaGetLastError();
}

template <typename In>
int dispatch(int C, const void* x, const void* w1, const void* b1, const void* w2,
             const void* b2, void* out, int B, int T, int H, const Plan& plan,
             cudaStream_t s) {
  switch (C) {
    case 16: return launch<In, 16>(x, w1, b1, w2, b2, out, B, T, H, plan, s);
    case 32: return launch<In, 32>(x, w1, b1, w2, b2, out, B, T, H, plan, s);
    case 64: return launch<In, 64>(x, w1, b1, w2, b2, out, B, T, H, plan, s);
    case 128: return launch<In, 128>(x, w1, b1, w2, b2, out, B, T, H, plan, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for x, w1, w2. x [B,T,C];
// w1, w2 [nb, ns, kmax*C, C] (tap-major rows); b1, b2 [nb, ns, C] f32;
// out [B,T,C] f32. ks [nb] kernel sizes, dils [nb*ns] stage dilations.
// C must be 16, 32, 64 or 128. Returns a cudaError_t code.
extern "C" int mrf_stage_run(int dtype, const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* out, int B, int T,
                             int C, int nb, int ns, int kmax, const int* ks,
                             const int* dils, void* stream) {
  if (nb < 1 || nb > MAXB || ns < 1 || ns > MAXB) return (int)cudaErrorInvalidValue;
  Plan plan;
  plan.nb = nb;
  plan.ns = ns;
  plan.kmax = kmax;
  int H = 0;
  for (int b = 0; b < nb; ++b) {
    plan.ks[b] = ks[b];
    const int half = (ks[b] - 1) / 2;
    int h = 0;
    for (int s = 0; s < ns; ++s) {
      plan.dil[b][s] = dils[b * ns + s];
      h += half * dils[b * ns + s] + half;
    }
    if (h > H) H = h;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(C, x, w1, b1, w2, b2, out, B, T, H, plan, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(C, x, w1, b1, w2, b2, out, B, T, H, plan, s);
  return (int)cudaErrorInvalidValue;
}
