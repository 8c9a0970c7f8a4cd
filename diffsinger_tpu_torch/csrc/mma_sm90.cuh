// Device helpers shared by the tensor-core kernels (sm_80+ PTX, built
// for sm_90a): cp.async copies, ldmatrix fragment loads and warp-level
// mma.sync products with float32 accumulators.
//
// Fragment layouts (lane = threadIdx.x % 32, g = lane / 4, t = lane % 4):
//   m16n8k16 bf16  A: a0 (row g,   k 2t..2t+1)   a1 (row g+8, k 2t..2t+1)
//                     a2 (row g,   k 2t+8..+9)   a3 (row g+8, k 2t+8..+9)
//                  B: b0 (k 2t..2t+1, col g)     b1 (k 2t+8..+9, col g)
//   m16n8k8  tf32  A: a0 (row g, k t)  a1 (row g+8, k t)
//                     a2 (row g, k t+4) a3 (row g+8, k t+4)
//                  B: b0 (k t, col g)  b1 (k t+4, col g)
//   both           C: c0, c1 (row g, cols 2t, 2t+1)  c2, c3 (row g+8, same cols)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mma90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy global -> shared, bypassing L1.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
// The same, or 16 bytes of zeros when `valid` is false (nothing is read from
// src then, but it must still be an address inside the allocation).
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N of this thread's committed groups are still in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// Programmatic dependent launch (sm_90): a kernel launched with the
// programmatic-stream-serialization attribute may start while the kernel
// before it in the stream still runs. wait blocks until that kernel has
// completed and its writes are visible; launch_dependents lets the next
// kernel's blocks be scheduled as soon as SM resources are free. Both are
// no-ops in a kernel launched the ordinary way.
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Four 8x8 matrices of 16-bit values; lane l gives the address of row l % 8 of
// matrix l / 8 (16 bytes, 16-byte aligned). A row of four 32-bit values is
// the same 16 bytes, so this also loads tf32 A fragments.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// The same with each 8x8 matrix transposed: B fragments from a [k][n] tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), float32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16x8 tf32, row) * b (8x8 tf32, col), float32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 3xTF32 split: hi keeps the sign, the exponent and the top 10 mantissa
// bits (a valid tf32 value), lo is the exact remainder cut to tf32 the same
// way. x = hi + lo up to 2^-20 |x|.
constexpr uint32_t TF32_MASK = 0xffffe000u;
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & TF32_MASK;
  lo = __float_as_uint(x - __uint_as_float(hi)) & TF32_MASK;
}

}  // namespace mma90
