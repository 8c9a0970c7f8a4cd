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
// Two bodies, one per input type, each one launch a branch. One block owns
// one T tile of one batch row and keeps a window of it in shared memory
// across the 2 * ns convolutions of the branch (chain state xc and the conv
// input); only x is read from and the branch result written to device memory.
//   * The rows each conv computes come from a plan made on the host
//     (ops/hifigan_mrf.py:mrf_window_plan): every branch has its own halo
//     (12, 36, 60 rows for k = 3, 7, 11 with d = 1, 3, 5) and, being a launch
//     of its own, its own tile (a narrow halo leaves room for a long tile);
//     the range shrinks by the conv's reach after each conv, down to the tile
//     itself. Rows outside a conv's range keep stale values that no kept row
//     reads. A conv's whole range is one pass: its accumulators stay in
//     registers until the epilogue. The host picks each branch's tile
//     (ops/hifigan_mrf.py:choose_mrf_tiles) from the body's geometry: the
//     shared memory a block may take, the rows one pass covers, the rounding
//     of a range to the body's row tiles and the waves the grid makes.
//   * Weights stream through a ring of slices in shared memory; each slice
//     is staged once per conv and used for every row of the window, and the
//     ring runs on across conv boundaries, so the next conv's first slices
//     load during the epilogue.
//   * The branch sum is kept in `out` (device memory): branch 0 writes, later
//     branches add in stream order (no atomics, so two calls give the same
//     bits), the last scales by 1/nb. Holding it in shared memory would tie
//     all branches to one tile and cost a fifth of the tile rows at C = 128:
//     more recompute than the 2 reads + 2 writes of out save.
//
// float32 (the shipped vocoder's type) - mrf_wg_kernel. Products are
// wgmma.mma_async m64nCk8 TF32 (A from registers, B from shared memory) with
// float32 accumulators, at float32 accuracy by the 3xTF32 split: a = a_hi +
// a_lo (a_hi the top 10 mantissa bits), acc += a_lo*b_hi + a_hi*b_lo +
// a_hi*b_hi. One TF32 pass keeps three digits and does not hold 1e-4 through
// 18 chained convolutions.
//   * Weights are split once, on the host, when they are packed
//     (ops/hifigan_mrf.py:weight_planes): per tap and KS-row slice a hi and a
//     lo plane, K-major in the core-matrix order wgmma reads B in (no
//     swizzle), so the tensor cores read them as they lie. A ring slot holds
//     one slice's two planes; one bulk copy (cp.async.bulk) brings it and
//     completes on the slot's mbarrier. No warp is set aside to produce (it
//     would cost a whole warpgroup's registers): the last warp of the block
//     to be done with a slot refills it with the slice SLOTS ahead.
//   * A warpgroup owns whole 64-row tiles of a conv's range (tiles wg, wg +
//     NWG, ...) and all C columns: an activation fragment is loaded by
//     ldmatrix at the tap's row offset (any offset: A never goes through a
//     descriptor), lrelu'd and split once per warpgroup, and feeds 3 wgmma
//     per 8-deep step. A slice's steps are one wgmma group, waited for before
//     its slot is freed; the other warpgroups' products fill that wait.
//   * The window (xc and y, float32, rows of C + 4) and the ring share 227
//     KB, one block an SM: a deeper ring or a longer slice shortens the
//     window, and with it the tile under the halo. Per C the geometry that
//     measured fastest at 8 x 1024 mel frames (MRF_LAUNCH_F32): C = 128
//     takes two 16-row slots (188 window rows), C = 64 two 32-row slots.
//
// bfloat16 (vocoder_compute_dtype: bfloat16) - mrf_bf16_kernel. A warp owns
// 8*NT columns and up to MT 16-row tiles, interleaved over the warps that
// share its columns, so a range of any length balances to within one row
// tile; weights stream through a 3-stage cp.async ring, one __syncthreads a
// slice. Every value
// a conv reads (lrelu(xc), y) and the chain state xc are bf16 at the rounding
// points, so the window holds them as bf16 and the products are one
// mma.sync.m16n8k16 bf16 pass with float32 accumulators: A fragments by
// ldmatrix from rows of stride C + 8, B fragments by ldmatrix.trans from the
// [K, N] weight slice, once per 16-deep step for all the warp's row tiles.
// Two window buffers: xc, and `ya`, every conv's input. A stage's input
// lrelu is applied once per element (f32 lrelu of the bf16 value, rounded to
// nearest, as the twin's rnd(leaky_relu(xc))) where xc is written, and the
// conv writes its output y over its own input after a barrier (its
// accumulators hold the whole range). A row costs (C + 8) * 4 bytes, half the
// float32 body's, so the register file, not shared memory, bounds the window:
// one pass covers 16 * MT * WM rows (256 at C = 128, 512 below). The rows'
// accumulators are spread over 16 warps an SM (one block of 16 at C >= 64,
// two of 8 below), with 64 x 64 warp tiles at C >= 64: more warps hide more
// of the work beside the products than 8 with 4 row tiles each.
//
// Bound. 252 * C^2 FLOP per frame and batch row, i.e. 2.16, 1.08, 0.54 and
// 0.27 TFLOP for the C = 128, 64, 32, 16 scales at 8 x 1024 mel frames:
// compute-bound. float32: with 3xTF32 every product costs three tensor-core
// passes, so the rate the card can give at this accuracy is 495 / 3 = 165
// TFLOP/s. What limits mrf_wg_kernel (tools/mrf_ablate.py, an H100 80GB HBM3
// at 700 W): first the halo recompute with its 64-row rounding, 1.88 / 1.23 /
// 1.11 / 1.07 times the scale's products at C = 128 / 64 / 32 / 16 (the
// window is short at C = 128: its rows and the ring share the 227 KB); then,
// on the products it does execute, the body reaches 66 / 57 / 39 / 23% of
// the TF32 peak, and dropping two of the three passes saves only 25-41% of
// its time: the rest waits on each slice's wgmma group and on the slot
// refills behind it, and, at C <= 32, on the fragment loads and splits that
// feed products of N = 32 or 16 columns.
// bfloat16: 989 TFLOP/s, 637.8 by mma.sync as measured on an H100 80GB HBM3
// at 700 W (tools/mma_rate.py). What limits mrf_bf16_kernel
// (tools/mrf_ablate.py bfloat16, same card): the halo recompute (1.32 /
// 1.12 / 1.12 at C = 128 / 64 / 32) and the work beside the products,
// which 16 warps an SM do not hide (the accumulators of a pass fill the
// register file): the epilogues (12-37% of the time) and the fragment loads
// and barriers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma_sm90.cuh"

namespace {

constexpr float SLOPE = 0.1f;
constexpr int MAXB = 4;   // branches / stages a plan may hold
constexpr int NST = 3;    // stages of the bfloat16 body's weight ring

// lrelu in two operations: SLOPE < 1, so the larger of v and SLOPE * v is v
// for v >= 0 and SLOPE * v below
__device__ __forceinline__ float lrelu_max(float v) { return fmaxf(v, SLOPE * v); }

// One branch's window plan, built by ops/hifigan_mrf.py:mrf_window_plan. Rows
// are window rows: row q of the window is sequence row t0 - halo + q.
struct WPlan {
  int k, ns;                    // kernel size, stages
  int tile, rows, halo;         // output rows per block, window rows, the branch's halo
  int dil[MAXB];
  int lo[2 * MAXB];             // rows [lo, hi) conv j computes
  int hi[2 * MAXB];
};

// ------------------------------------------------------------------- float32
namespace wg {

using namespace mma90;

// One branch of the scale on float32 x and weights split at packing: wp1,
// wp2 hold, per stage of the chain, tap and KS-row slice of its [C, C]
// weights, the tf32 hi plane then the lo plane of the slice, each K-major
// ([C_out][C_in] in 8 x 4 core matrices: ops/hifigan_mrf.py:weight_planes).
// The branch result is written to out (accumulate == 0) or added to it, then
// multiplied by scale (1/nb on the last branch, else 1). NWG: warpgroups of
// a block; MT: 64-row tiles a warpgroup may own in one conv; KS: weight rows
// a ring slot holds; SLOTS: ring slots.
template <int C, int NWG, int MT, int KS, int SLOTS>
__global__ void __launch_bounds__(NWG * 128, 1)
mrf_wg_kernel(const float* __restrict__ x, const float* __restrict__ wp1,
              const float* __restrict__ b1, const float* __restrict__ wp2,
              const float* __restrict__ b2, float* __restrict__ out, int T, int kmax,
              int accumulate, float scale, const WPlan p) {
  constexpr int SA = C + 4;            // activation row stride: conflict-free ldmatrix
  constexpr int SPT = C / KS;          // slices per tap
  constexpr int SPS = KS / 8;          // k8 steps per slice
  constexpr int SLICE = 2 * KS * C;    // floats of a slice: hi plane, lo plane
  constexpr int NACC = C / 2;          // accumulators of a 64 x C tile per thread
  constexpr int NTHR = NWG * 128, NWARP = NWG * 4;
  static_assert(C % KS == 0 && KS % 8 == 0 && SLOTS * 12 <= 128, "tiling");

  extern __shared__ __align__(128) float wsmem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(wsmem);  // [SLOTS] a slot's slice arrived
  int* freed = reinterpret_cast<int*>(full + SLOTS);    // [SLOTS] warps done with a slot, ever
  float* ring = wsmem + 32;                             // [SLOTS][SLICE]
  float* xc = ring + SLOTS * SLICE;                     // [rows][SA] chain state
  float* yb = xc + (size_t)p.rows * SA;                 // [rows][SA] intermediate

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ncv = 2 * p.ns, k = p.k, half = (k - 1) / 2;
  const int nsl = k * SPT, total = ncv * nsl;           // slices of a conv, of the branch
  const size_t wstride = (size_t)kmax * C * C * 2;      // one conv's planes
  const uint32_t full0 = smem_u32(full);
  // slice q of the branch (conv q / nsl) into slot q % SLOTS, by the copy engine
  auto fill = [&](int q) {
    if (q >= total) return;
    const int cv = q / nsl, slot = q % SLOTS;
    const float* src = ((cv & 1) ? wp2 : wp1) + (size_t)(cv / 2) * wstride +
                       (size_t)(q % nsl) * SLICE;
    mbar_arrive_expect_tx(full0 + 8 * slot, SLICE * 4);
    bulk_copy_g2s(smem_u32(ring + slot * SLICE), src, SLICE * 4, full0 + 8 * slot);
  };
  if (tid == 0) {
    for (int i = 0; i < SLOTS; ++i) {
      mbar_init(full0 + 8 * i, 1);
      freed[i] = 0;
    }
    mbar_init_fence();
    for (int q = 0; q < SLOTS; ++q) fill(q);
  }
  // a warp's lane 0 is done with slot `slot`, which held slice q: the last
  // warp of the block to be done refills it with slice q + SLOTS (its
  // products, and every earlier warp's, have completed)
  auto release = [&](int slot, int q) {
    if (lane == 0 && atomicAdd(freed + slot, 1) % NWARP == NWARP - 1) fill(q + SLOTS);
  };

  // the warpgroup's index from a shuffle, so the compiler sees it uniform
  // over the warp: a wgmma under a branch it cannot prove uniform is
  // fenced and serialized
  const int wgi = __shfl_sync(0xffffffffu, warp / 4, 0), wl = warp % 4;
  const int g8 = lane / 4, t4 = lane % 4;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * p.tile;
  const int win0 = t0 - p.halo;
  const float* xb = x + (size_t)b * T * C;
  float* ob = out + (size_t)b * T * C;

  // the window of x, zero outside [0, T)
  for (int i = tid; i < p.rows * (C / 4); i += NTHR) {
    const int q = i / (C / 4), c4 = i % (C / 4);
    const int gr = win0 + q;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr >= 0 && gr < T) v = reinterpret_cast<const float4*>(xb + (size_t)gr * C)[c4];
    *reinterpret_cast<float4*>(xc + (size_t)q * SA + c4 * 4) = v;
  }
  __syncthreads();

  int slot = 0, qn = 0;   // the next slice's slot and number
  uint32_t par = 0;
  for (int cv = 0; cv < ncv; ++cv) {
    const bool first = (cv & 1) == 0;
    const int d = first ? p.dil[cv / 2] : 1;
    const int lo = p.lo[cv], hi = p.hi[cv];
    const int n_mt = (hi - lo + 63) / 64;   // 64-row tiles; warpgroup wgi owns wgi, wgi + NWG, ...
    const int mine = n_mt > wgi ? (n_mt - wgi + NWG - 1) / NWG : 0;
    const float* src = first ? xc : yb;
    float acc[MT][NACC];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < NACC; ++e) {
        acc[i][e] = 0.f;
        reg_fence(acc[i][e]);
      }

    // this lane's A row in its first tile (a warp's 16 rows of each tile),
    // and its 4-column half of an 8-deep step
    const int arow = lo + wgi * 64 + wl * 16 + lane % 16;
    const int acol = (lane / 16) * 4;
    // one slice s of the conv (tap s / SPT, input columns (s % SPT) * KS on):
    // its A fragments loaded, lrelu'd and split once for the warpgroup, then
    // three products a tile and 8-deep step, one wgmma group; when the group
    // is done the slot is free
    for (int s = 0; s < k * SPT; ++s) {
      const int off = (s / SPT - half) * d, kc = (s % SPT) * KS;
      // every tile's fragments load (a tile past the range reads a clamped
      // row it never uses): the loads stay one block of straight code
      uint32_t ah[SPS][MT][4], al[SPS][MT][4];
#pragma unroll
      for (int u = 0; u < SPS; ++u)
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          // rows past the window only feed output rows past hi: clamp them
          int row = arow + i * NWG * 64 + off;
          row = min(max(row, 0), p.rows - 1);
          uint32_t a[4];
          ldmatrix_x4(a, smem_u32(src + (size_t)row * SA + kc + u * 8 + acol));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float v = __uint_as_float(a[e]);
            if (first) v = lrelu_max(v);
            split_tf32(v, ah[u][i][e], al[u][i][e]);
            reg_fence(ah[u][i][e]);
            reg_fence(al[u][i][e]);
          }
        }
      mbar_wait(full0 + 8 * slot, par);
      // a step's 8 rows of the slice: two core matrices along K, 256 bytes
      const uint32_t bh = smem_u32(ring + slot * SLICE);
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < SPS; ++u) {
        const uint64_t dh = wgmma_desc(bh + u * 256, 128, KS * 32);
        const uint64_t dl = wgmma_desc(bh + KS * C * 4 + u * 256, 128, KS * 32);
        // pass by pass over the tiles: products into one accumulator are MT
        // wgmma apart
#pragma unroll
        for (int pass = 0; pass < 3; ++pass) {
#ifdef MRF_ABLATE_ONE_PASS
          if (pass != 2) continue;
#endif
#pragma unroll
          for (int i = 0; i < MT; ++i)
            if (i < mine) wgmma_tf32_rs(acc[i], pass == 0 ? al[u][i] : ah[u][i],
                                        pass == 1 ? dl : dh);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      release(slot, qn++);
      if (++slot == SLOTS) {
        slot = 0;
        par ^= 1;
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < NACC; ++e) reg_fence(acc[i][e]);

    // epilogue: first conv -> y = mask(lrelu(conv + b1)); second conv ->
    // xc = mask(xc + conv + b2), or the branch result for the last one
    const float* bias = (first ? b1 : b2) + (size_t)(cv / 2) * C;
    const bool last = cv == ncv - 1;
#pragma unroll
    for (int nt = 0; nt < C / 8; ++nt) {
      const int col = nt * 8 + 2 * t4;
      const float2 bv = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i >= mine) break;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = lo + (wgi + i * NWG) * 64 + wl * 16 + g8 + hr * 8;
          if (row >= hi) continue;
          const int gr = win0 + row;
          const bool valid = gr >= 0 && gr < T;
          float2 v;
          v.x = acc[i][nt * 4 + hr * 2] + bv.x;
          v.y = acc[i][nt * 4 + hr * 2 + 1] + bv.y;
          if (first) {
            v.x = valid ? lrelu_max(v.x) : 0.f;
            v.y = valid ? lrelu_max(v.y) : 0.f;
            *reinterpret_cast<float2*>(yb + (size_t)row * SA + col) = v;
            continue;
          }
          const float2 xo = *reinterpret_cast<const float2*>(xc + (size_t)row * SA + col);
          v.x = valid ? xo.x + v.x : 0.f;
          v.y = valid ? xo.y + v.y : 0.f;
          if (!last) {
            *reinterpret_cast<float2*>(xc + (size_t)row * SA + col) = v;
          } else if (valid) {   // the plan's last range is the tile itself
            float2* o = reinterpret_cast<float2*>(ob + (size_t)gr * C + col);
            if (accumulate) {
              const float2 prev = *o;
              v.x = prev.x + v.x;
              v.y = prev.y + v.y;
            }
            v.x *= scale;
            v.y *= scale;
            *o = v;
          }
        }
      }
    }
    // every row of this conv is written before the next conv reads it
    __syncthreads();
  }
}

}  // namespace wg

// ------------------------------------------------------------------ bfloat16
namespace tc16 {

using namespace mma90;
typedef __nv_bfloat16 bf16;

// lrelu of two bf16 values in float32, rounded to nearest back to bf16
__device__ __forceinline__ uint32_t lrelu_bf16x2(uint32_t v) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  const __nv_bfloat162 r = __floats2bfloat162_rn(lrelu_max(f.x), lrelu_max(f.y));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// One branch of the scale, as mrf_wg_kernel, on bf16 x, w1, w2 (b1, b2 and
// out float32) as pack_mrf_params lays them out. NT: 8-column tiles a warp
// owns; MT: 16-row tiles a warp may own in one conv; KS: rows of a weight
// slice, a multiple of 16; NW: warps of a block; MINB: blocks an SM should hold.
// Diagnostic builds (tools/mrf_ablate.py bfloat16; wrong values, only the
// times mean something): -DMRF_ABLATE_BF16_NO_MMA drops the products,
// -DMRF_ABLATE_BF16_NO_EPILOGUE every epilogue but the last conv's.
template <int C, int NT, int MT, int KS, int NW, int MINB>
__global__ void __launch_bounds__(NW * 32, MINB)
mrf_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                const float* __restrict__ b1, const bf16* __restrict__ w2,
                const float* __restrict__ b2, float* __restrict__ out, int T, int kmax,
                int accumulate, float scale, const WPlan p) {
  constexpr int S = C + 8;             // row stride of every buffer: 16-byte rows, conflict-free ldmatrix
  constexpr int WN = C / (8 * NT);     // warps along the columns
  constexpr int WM = NW / WN;          // warps along the rows
  constexpr int NTHR = NW * 32;
  constexpr int SPT = C / KS;          // slices per tap
  constexpr int C8 = C / 8;            // 16-byte chunks a row
  static_assert(C % (8 * NT) == 0 && NT % 2 == 0 && NW % WN == 0 && C % KS == 0 &&
                KS % 16 == 0, "tiling");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xc = reinterpret_cast<bf16*>(smem_raw);   // [rows][S] chain state
  bf16* ya = xc + (size_t)p.rows * S;             // [rows][S] every conv's input: lrelu(xc), then y
  bf16* ring = ya + (size_t)p.rows * S;           // [NST][KS][S] weight slices

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int wn = warp % WN, wm = warp / WN;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * p.tile;
  const int win0 = t0 - p.halo;
  const bf16* xb = x + (size_t)b * T * C;
  float* ob = out + (size_t)b * T * C;
  const size_t wstride = (size_t)kmax * C * C;
  const int ncv = 2 * p.ns;
  const int k = p.k, half = (k - 1) / 2, nsl = k * SPT;

  // producer side of the ring: walks every slice of every conv in order
  int p_cv = 0, p_s = 0, p_stage = 0;
  auto fetch_next = [&]() {
    if (p_cv < ncv) {
      const bf16* src = ((p_cv & 1) ? w2 : w1) + (size_t)(p_cv / 2) * wstride +
                        (size_t)p_s * KS * C;
      bf16* dst = ring + (size_t)p_stage * KS * S;
      for (int i = tid; i < KS * C8; i += NTHR) {
        const int r = i / C8, c = i % C8;
        cp_async16(smem_u32(dst + r * S + c * 8), src + (size_t)r * C + c * 8);
      }
      p_stage = p_stage + 1 == NST ? 0 : p_stage + 1;
      if (++p_s == nsl) {
        p_s = 0;
        ++p_cv;
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) fetch_next();
  int c_stage = 0;

  // the window of x (zero outside [0, T)) and its lrelu; the first slice's
  // barrier publishes both
  for (int i = tid; i < p.rows * C8; i += NTHR) {
    const int q = i / C8, c8 = i % C8;
    const int gr = win0 + q;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gr >= 0 && gr < T) v = reinterpret_cast<const uint4*>(xb + (size_t)gr * C)[c8];
    *reinterpret_cast<uint4*>(xc + (size_t)q * S + c8 * 8) = v;
    v = make_uint4(lrelu_bf16x2(v.x), lrelu_bf16x2(v.y), lrelu_bf16x2(v.z), lrelu_bf16x2(v.w));
    *reinterpret_cast<uint4*>(ya + (size_t)q * S + c8 * 8) = v;
  }
  for (int cv = 0; cv < ncv; ++cv) {
    const bool first = (cv & 1) == 0;
    const int d = first ? p.dil[cv / 2] : 1;
    const int lo = p.lo[cv], hi = p.hi[cv];
    const int n_mt = (hi - lo + 15) / 16;   // 16-row tiles; warp row wm owns wm, wm + WM, ...
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;

    for (int s = 0; s < nsl; ++s) {
      cp_async_wait<NST - 2>();
      __syncthreads();
      fetch_next();
      const bf16* wst = ring + (size_t)c_stage * KS * S;
      c_stage = c_stage + 1 == NST ? 0 : c_stage + 1;
      const int off = (s / SPT - half) * d, kc = (s % SPT) * KS;
#pragma unroll
      for (int k16 = 0; k16 < KS / 16; ++k16) {
        // B fragments of the warp's NT column tiles, two tiles an ldmatrix
        uint32_t bfr[NT][2];
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, smem_u32(wst + (size_t)(k16 * 16 + lane % 16) * S +
                                        (wn * NT + 2 * j) * 8 + (lane / 16) * 8));
          bfr[2 * j][0] = r[0];
          bfr[2 * j][1] = r[1];
          bfr[2 * j + 1][0] = r[2];
          bfr[2 * j + 1][1] = r[3];
        }
        // A fragments of all MT row tiles first, so their loads are in flight
        // together (a row tile past the range loads a clamped row it never
        // uses); rows past the window only feed output rows past hi: clamp them
        uint32_t af[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          int row = lo + (wm + i * WM) * 16 + off + lane % 16;
          row = min(max(row, 0), p.rows - 1);
          ldmatrix_x4(af[i], smem_u32(ya + (size_t)row * S + kc + k16 * 16 + (lane / 16) * 8));
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if (wm + i * WM >= n_mt) continue;
#ifndef MRF_ABLATE_BF16_NO_MMA
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[i][nt], af[i], bfr[nt][0], bfr[nt][1]);
#endif
        }
      }
    }
    // every warp is done reading ya: the epilogue may write over it
    __syncthreads();
#ifdef MRF_ABLATE_BF16_NO_EPILOGUE
    if (cv != ncv - 1) continue;
#endif

    // epilogue: first conv -> ya = bf16(mask(lrelu(conv + b1))); second conv
    // -> xc = mask(bf16(xc + (conv + b2))) and ya = bf16(lrelu(xc)), or the
    // branch result for the last one
    const float* bias = (first ? b1 : b2) + (size_t)(cv / 2) * C;
    const bool last = cv == ncv - 1;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int mt = wm + i * WM;
      if (mt >= n_mt) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = (wn * NT + nt) * 8 + 2 * t4;
        const float2 bv = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = lo + mt * 16 + g8 + hr * 8;
          if (row >= hi) continue;
          const int gr = win0 + row;
          const bool valid = gr >= 0 && gr < T;
          const float vx = acc[i][nt][hr * 2] + bv.x;
          const float vy = acc[i][nt][hr * 2 + 1] + bv.y;
          __nv_bfloat162* yp = reinterpret_cast<__nv_bfloat162*>(ya + (size_t)row * S + col);
          if (first) {
            *yp = __floats2bfloat162_rn(valid ? lrelu_max(vx) : 0.f, valid ? lrelu_max(vy) : 0.f);
            continue;
          }
          __nv_bfloat162* xp = reinterpret_cast<__nv_bfloat162*>(xc + (size_t)row * S + col);
          const float2 xo = __bfloat1622float2(*xp);
          const __nv_bfloat162 nv = __floats2bfloat162_rn(valid ? xo.x + vx : 0.f,
                                                          valid ? xo.y + vy : 0.f);
          if (!last) {
            *xp = nv;
            const uint32_t lr = lrelu_bf16x2(*reinterpret_cast<const uint32_t*>(&nv));
            *reinterpret_cast<uint32_t*>(yp) = lr;
          } else if (valid) {   // the plan's last range is the tile itself
            float2 v = __bfloat1622float2(nv);
            float2* o = reinterpret_cast<float2*>(ob + (size_t)gr * C + col);
            if (accumulate) {
              const float2 prev = *o;
              v.x = prev.x + v.x;
              v.y = prev.y + v.y;
            }
            v.x *= scale;
            v.y *= scale;
            *o = v;
          }
        }
      }
    }
  }
}

}  // namespace tc16

// One launch per branch, each with its own tile: branch 0 writes out, the
// others add to it, the last one scales the sum to the mean. A block takes
// rows * row_bytes + ring_bytes of shared memory; a range longer than
// range_max rows would not fit one pass of the warps. A branch's weights are
// w_branch elements of w1 and of w2.
template <typename E, typename K>
int launch_branches(K kernel, int nthr, int range_max, size_t row_bytes, size_t ring_bytes,
                    size_t w_branch, const E* x, const E* w1, const float* b1, const E* w2,
                    const float* b2, float* out, int B, int T, int C, int nb, int kmax,
                    const WPlan* plans, cudaStream_t stream) {
  size_t smem_max = 0;
  for (int bj = 0; bj < nb; ++bj) {
    const WPlan& p = plans[bj];
    for (int cv = 0; cv < 2 * p.ns; ++cv)
      if (p.hi[cv] - p.lo[cv] > range_max) return (int)cudaErrorInvalidValue;
    const size_t smem = p.rows * row_bytes + ring_bytes;
    if (smem > smem_max) smem_max = smem;
  }
  if (smem_max > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_max);
  if (err != cudaSuccess) return (int)err;
  for (int bj = 0; bj < nb; ++bj) {
    const WPlan& p = plans[bj];
    const size_t wofs = (size_t)bj * w_branch, bofs = (size_t)bj * p.ns * C;
    const dim3 grid((T + p.tile - 1) / p.tile, B);
    kernel<<<grid, nthr, p.rows * row_bytes + ring_bytes, stream>>>(
        x, w1 + wofs, b1 + bofs, w2 + wofs, b2 + bofs, out, T, kmax, bj > 0,
        bj == nb - 1 ? 1.f / nb : 1.f, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

template <int C, int NT, int MT, int KS, int NW, int MINB>
int launch_bf16(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                void* out, int B, int T, int nb, int kmax, const WPlan* plans,
                cudaStream_t stream) {
  typedef __nv_bfloat16 bf16;
  constexpr int WM = NW / (C / (8 * NT));
  return launch_branches(tc16::mrf_bf16_kernel<C, NT, MT, KS, NW, MINB>, NW * 32, 16 * MT * WM,
                         (size_t)2 * (C + 8) * sizeof(bf16),
                         (size_t)NST * KS * (C + 8) * sizeof(bf16),
                         (size_t)plans[0].ns * kmax * C * C, (const bf16*)x,
                         (const bf16*)w1, (const float*)b1, (const bf16*)w2,
                         (const float*)b2, (float*)out, B, T, C, nb, kmax, plans, stream);
}

// The float32 body: 128 bytes of barriers, then the ring, then the window.
template <int C, int NWG, int MT, int KS, int SLOTS>
int launch_f32(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
              void* out, int B, int T, int nb, int kmax, const WPlan* plans,
              cudaStream_t stream) {
  return launch_branches(wg::mrf_wg_kernel<C, NWG, MT, KS, SLOTS>, NWG * 128, 64 * MT * NWG,
                         (size_t)2 * (C + 4) * sizeof(float),
                         128 + (size_t)SLOTS * 2 * KS * C * sizeof(float),
                         (size_t)plans[0].ns * kmax * C * C * 2, (const float*)x,
                         (const float*)w1, (const float*)b1, (const float*)w2,
                         (const float*)b2, (float*)out, B, T, C, nb, kmax, plans, stream);
}

}  // namespace

// dtype: 0 = float32 (x f32; w1, w2 the split planes [nb, ns, kmax,
// C / KS, 2, KS * C] of ops/hifigan_mrf.py:weight_planes), 1 = bfloat16 (x,
// w1, w2 bf16; w1, w2 [nb, ns, kmax*C, C], tap-major rows), 2 = float32 on
// the mma.sync body (w1, w2 as for bfloat16, in f32). b1, b2 [nb, ns, C] f32;
// out [B,T,C] f32. ks [nb] kernel sizes, dils [nb*ns] stage dilations.
// C must be 16, 32, 64 or 128. win is the window plan as
// ops/hifigan_mrf.py:_launch_plan lays it out: per branch tile, rows, halo and
// 2*ns pairs (lo, hi). Returns a cudaError_t code.
extern "C" int mrf_stage_run(int dtype, const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* out, int B, int T,
                             int C, int nb, int ns, int kmax, const int* ks,
                             const int* dils, const int* win, void* stream) {
  if (nb < 1 || nb > MAXB || ns < 1 || ns > MAXB) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  WPlan plans[MAXB];
  const int* q = win;
  for (int b = 0; b < nb; ++b) {
    WPlan& p = plans[b];
    p.k = ks[b];
    p.ns = ns;
    for (int i = 0; i < ns; ++i) p.dil[i] = dils[b * ns + i];
    p.tile = *q++;
    p.rows = *q++;
    p.halo = *q++;
    if (p.k < 1 || p.k % 2 == 0 || p.tile < 1 || p.rows < p.tile)
      return (int)cudaErrorInvalidValue;
    for (int cv = 0; cv < 2 * ns; ++cv) {
      p.lo[cv] = *q++;
      p.hi[cv] = *q++;
      if (p.lo[cv] < 0 || p.hi[cv] > p.rows || p.lo[cv] >= p.hi[cv])
        return (int)cudaErrorInvalidValue;
    }
  }
  // geometry (C, NT, MT, KS, NW, MINB): ops/hifigan_mrf.py:_TC_GEOMETRY
#define MRF_LAUNCH(FN, CH, NTL, MTL, KSL, NWL, MINB) \
  return FN<CH, NTL, MTL, KSL, NWL, MINB>(x, w1, b1, w2, b2, out, B, T, nb, kmax, plans, s)
#define MRF_LAUNCH_F32(CH, NWGL, MTL, KSL, SLOTSL) \
  return launch_f32<CH, NWGL, MTL, KSL, SLOTSL>(x, w1, b1, w2, b2, out, B, T, nb, kmax, plans, s)
  if (dtype == 0) {
    switch (C) {
      case 16: MRF_LAUNCH_F32(16, 4, 4, 16, 6);
      case 32: MRF_LAUNCH_F32(32, 6, 2, 32, 3);
      case 64: MRF_LAUNCH_F32(64, 6, 1, 32, 2);
      case 128: MRF_LAUNCH_F32(128, 3, 1, 16, 2);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    switch (C) {
      case 16: MRF_LAUNCH(launch_bf16, 16, 2, 4, 16, 8, 2);
      case 32: MRF_LAUNCH(launch_bf16, 32, 4, 4, 32, 8, 2);
      case 64: MRF_LAUNCH(launch_bf16, 64, 8, 2, 64, 16, 1);
      case 128: MRF_LAUNCH(launch_bf16, 128, 8, 2, 64, 16, 1);
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef MRF_LAUNCH
#undef MRF_LAUNCH_F32
  return (int)cudaErrorInvalidValue;
}
