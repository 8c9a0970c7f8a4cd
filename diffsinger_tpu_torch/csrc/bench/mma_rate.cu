// Micro-benchmarks of the warp-level tensor-core path the serving kernels are
// built from (a program of its own, not a library; tools/mma_rate.py builds
// and runs it). One block of 8 warps per SM, 132 blocks, 20000 iterations:
//   peak   - independent mma.sync chains from registers: the rate mma.sync
//            can reach on this card, bf16 m16n8k16 and tf32 m16n8k8;
//   stack  - the 16-deep step of csrc/diffnet_stack.cu's GEMM loop (4
//            ldmatrix.trans for B, 4 x (ldmatrix A + 8 mma)) from shared
//            memory, without the weight stream: what the loop could do if
//            the L2 kept up.
// Prints one line per case: milliseconds, TFLOP/s, nanoseconds per mma per
// scheduler (an SM has four).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "../mma_sm90.cuh"

using namespace mma90;

constexpr int BLOCKS = 132, THREADS = 256, ITERS = 20000;

template <int KIND, int NACC>
__global__ void peak_kernel(float* out, int iters) {
  float acc[NACC][4];
  for (int i = 0; i < NACC; ++i)
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  uint32_t b0 = threadIdx.x * 3, b1 = threadIdx.x * 5;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      if (KIND == 0) mma_bf16(acc[i], a, b0, b1);
      else mma_tf32(acc[i], a, b0, b1);
    }
  }
  float s = 0;
  for (int i = 0; i < NACC; ++i)
    for (int e = 0; e < 4; ++e) s += acc[i][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// y tile [80][264] bf16 shared by the warps, a [4][16][72] bf16 ring per warp
constexpr int STACK_SMEM = (80 * 264 + 8 * 4 * 16 * 72) * 2;
__global__ void __launch_bounds__(THREADS, 1) stack_step_kernel(float* out, int iters) {
  extern __shared__ __align__(16) unsigned char raw[];
  __nv_bfloat16* ys = (__nv_bfloat16*)raw;
  __nv_bfloat16* wr = ys + 80 * 264;
  for (int i = threadIdx.x; i < STACK_SMEM / 2; i += blockDim.x)
    ys[i] = __float2bfloat16(0.001f * (i % 97));
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const __nv_bfloat16* wring = wr + warp * 4 * 16 * 72;
  float acc[4][8][4];
  for (int i = 0; i < 4; ++i)
    for (int n = 0; n < 8; ++n)
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
  for (int it = 0; it < iters; ++it) {
    const __nv_bfloat16* wst = wring + (it & 3) * 16 * 72;
    const __nv_bfloat16* abase = ys + ((it >> 4) & 1) * 264 + (it & 15) * 16;
    uint32_t bfr[8][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, smem_u32(wst + (lane % 16) * 72 + h * 32 + j * 16 + (lane / 16) * 8));
        bfr[h * 4 + 2 * j][0] = r[0];
        bfr[h * 4 + 2 * j][1] = r[1];
        bfr[h * 4 + 2 * j + 1][0] = r[2];
        bfr[h * 4 + 2 * j + 1][1] = r[3];
      }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      uint32_t a[4];
      ldmatrix_x4(a, smem_u32(abase + (mt * 16 + lane % 16) * 264 + (lane / 16) * 8));
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mma_bf16(acc[mt][nt], a, bfr[nt][0], bfr[nt][1]);
    }
  }
  float s = 0;
  for (int i = 0; i < 4; ++i)
    for (int n = 0; n < 8; ++n)
      for (int e = 0; e < 4; ++e) s += acc[i][n][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <typename Launch>
static int report(const char* name, double mma_per_warp_iter, double flop_per_mma, Launch launch) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  launch(100);
  cudaEventRecord(e0);
  launch(ITERS);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    printf("%s: %s\n", name, cudaGetErrorString(err));
    return 1;
  }
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  const double warps = THREADS / 32;
  const double mmas = (double)BLOCKS * warps * ITERS * mma_per_warp_iter;
  printf("mma_rate %s: %.3f ms, %.1f TFLOP/s, %.2f ns per mma per scheduler\n", name, ms,
         mmas * flop_per_mma / ms / 1e9, ms * 1e6 / (ITERS * mma_per_warp_iter * warps / 4.0));
  return 0;
}

int main() {
  float* out;
  if (cudaMalloc(&out, BLOCKS * THREADS * sizeof(float)) != cudaSuccess) return 2;
  cudaFuncSetAttribute(stack_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, STACK_SMEM);
  int rc = 0;
  rc |= report("peak bf16 m16n8k16", 8, 4096, [&](int n) { peak_kernel<0, 8><<<BLOCKS, THREADS>>>(out, n); });
  rc |= report("peak tf32 m16n8k8", 8, 2048, [&](int n) { peak_kernel<1, 8><<<BLOCKS, THREADS>>>(out, n); });
  rc |= report("stack step (bf16, fragments from shared memory)", 32, 4096,
               [&](int n) { stack_step_kernel<<<BLOCKS, THREADS, STACK_SMEM>>>(out, n); });
  return rc;
}
