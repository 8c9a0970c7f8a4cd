// Fused DiffNet residual stack for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel diffsinger_tpu/ops/diffnet_stack.py:
// diffnet_stack (pallas_call at :311, body _make_kernel :54-132).
//
// What it computes, per layer l with dilation d (x [B,T,C] f32):
//   y    = cast(x + step[l])                       (f32 add, then input type)
//   conv = y[t-d] @ w_dil[l,0] + y[t] @ w_dil[l,1] + y[t+d] @ w_dil[l,2]
//          + b_dil[l] + cond[l]                    (f32 accumulation; rows
//                                                   outside [0,T) read zero)
//   g    = cast(sigmoid(conv[:, :C]) * tanh(conv[:, C:]))
//   out  = g @ w_out[l] + b_out[l]
//   x    = (x + out[:, :C]) * sqrt(1/2);  skip += out[:, C:]
//
// Three bodies on the tensor cores at the shapes the shipped configs and the
// release's width reach (C = 128 or 256, float32 also C = 512, dilations up
// to MAX_DIL), one launch a layer:
//
// bfloat16 (compute_dtype bfloat16) - stack_layer_tc. The TPU kernel keeps
// the whole [T,C] activation resident in VMEM across all layers; a block here
// has 227 KB, so a block owns 64 rows of one batch row and all 2C columns for
// one layer:
//   * y is staged once: the block's rows plus a d-row halo on each side are
//     read from x, step is added, the sum is rounded to bf16 and kept in
//     shared memory; each tap is a row offset into that tile. Blocks never
//     span two batch rows (grid = T tiles x B), so the halo is zero exactly
//     where t leaves [0,T).
//   * the products are mma.sync.m16n8k16 (bf16 in, f32 accumulate) fed by
//     ldmatrix; warp w owns gate columns [wC/8, (w+1)C/8) and the matching
//     filter columns + C, so the gate is computed in registers.
//   * the weights of the layer ([3C + C, 2C] bf16, 1 MB at C = 256) stream
//     through cp.async rings of 16-row chunks, four stages deep. Every warp
//     has a ring of its own that holds only its columns, so the GEMM loops
//     need no block-wide barrier (a wait and a __syncwarp a chunk) and the
//     warps drift apart and fill each other's bubbles; the out-projection
//     chunks follow the conv chunks in the same ring. A block has two
//     __syncthreads a layer: y staged, g written.
//   * cond and x reach the epilogues through shared memory as well: each warp
//     copies its own [64, C/4] cond tile with cp.async at the start and, once
//     the gate is computed, its f32 x rows into the same place for the
//     residual. Only skip is read from device memory in an epilogue.
//   * g stays on chip: the gate epilogue writes it (bf16) to shared memory and
//     the out GEMM reads it from there. The residual epilogue writes x_out:
//     x is double-buffered between layers (a neighbouring block still reads
//     x_in[t +- d]), the caller's x0 is layer 0's input and is never written.
//
// float32 (no compute_dtype: every shipped config, so LJ serving and --infer
// with 71 calls a request, singing with 26) - stack_layer_tc32, the same
// block (64 rows of one batch row, all 2C columns, 8 warps with the same
// column ownership, 128 accumulators a thread at C = 256), the same per-warp
// weight rings, programmatic dependent launch and x double buffer; what the
// float32 type changes:
//   * products in 3xTF32: mma.sync.m16n8k8 TF32 with float32 accumulators,
//     each operand split as a = a_hi + a_lo (the top 10 mantissa bits, then
//     the remainder cut the same way) and acc += a_lo*b_hi + a_hi*b_lo +
//     a_hi*b_hi: float32 accuracy (one TF32 pass keeps three digits and does
//     not hold 1e-4 through 20 layers). y and g are split as a warp loads
//     its A fragments (ldmatrix, one 16-row tile at a time), the weights as
//     it loads its B fragments (once per 8-deep step for all four row tiles).
//   * the tiles are twice as wide, so the bf16 layout (216-224 KB) would not
//     fit: y with its halo is kept in float32 ((64 + 2d) x (C + 4) floats,
//     99,840 B at C = 256, d = 16), g is written over y once every warp has
//     passed the conv GEMM (two barriers instead of one), the weight rings
//     are three stages of 16-row chunks (110,592 B for the 8 warps), and cond
//     and x are read straight from device memory in the epilogues, in
//     fragment order (a quad's four float2 are one 32-byte sector); the
//     block's cond rows are prefetched into L2 when the block starts.
//   * sigmoid and tanh as in the bf16 body (exp2-based, clamped): absolute
//     errors near 1e-7, well inside the 1e-4 the stack is held to.
//   * a column split S in {1, 2, 4} (stack_layer_tc32<C, S>; see "Grid"
//     below): S blocks of a thread-block cluster share one 64-row tile, block
//     rank j owning gate and filter columns [jC/S, (j+1)C/S) (+ C) and the
//     same residual and skip columns, each warp 1/8 of them. Each block
//     stages the whole y tile, streams only its columns of the weights (1/S
//     of 2 MB a layer), writes its g slice over y, and after a cluster
//     barrier copies the other blocks' slices from their shared memory
//     (distributed shared memory, ld.shared::cluster) into its own tile: the
//     out GEMM contracts over all C columns of g. A second barrier, arrived
//     at after the copy and waited at the block's end, keeps every block
//     alive while a peer still reads it. S = 1 has no cluster, barrier or
//     copy.
//
// float32 at C = 512 (the openvpi release's 512-channel DiffNet) -
// stack_layer_wg<S>, split only, S in {2, 4}: an unsplit block's y tile,
// (64 + 2d) x 516 floats (165,120 B at d = 8), leaves no room for the weights
// of all 1,024 columns. The tile, halo rule, column split, g exchange, cond
// and x reads, x double buffer and programmatic dependent launch are
// stack_layer_tc32's; the products are wgmma.mma_async m64n128k8 TF32 in
// 3xTF32, fed as follows:
//   * the 2C columns come in eight 64-column units (unit u: gate or residual
//     columns [64u, 64u + 64) and the filter or skip columns C + the same).
//     Block rank j owns units [8j/S, 8(j+1)/S), one warpgroup each (S = 2:
//     four warpgroups, 512 threads; S = 4: two, 256), so a warpgroup's
//     wgmma is 64 rows x 128 columns, 64 accumulators a thread, with gate
//     and filter (residual and skip) of a column in the same thread.
//   * A from registers: each warp ldmatrix's its 16 rows of y at the tap's
//     row offset (or of g) and splits them into hi and lo once for its
//     warpgroup, as mrf_stage.cu's wgmma body does.
//   * B from shared memory, K-major in core matrices, packed once on the host
//     (ops/diffnet_stack.py:wg_weights): one float32 plane, the bytes of
//     w_dil and w_out. Each warpgroup streams its unit through a ring of
//     WG_NST = 2 stages of WG_KC = 16 contraction rows (8 KB), filled by bulk
//     copies (cp.async.bulk) that complete on the slot's mbarrier; the last
//     of its four warps done with a stage refills the slot.
//   * B is split in the stage, once per block: the tensor cores read a
//     float32 operand's top 19 bits, the hi part of the split (probed on an
//     H100: every raw element read as its truncation, none as its rounding),
//     so the a_lo*b_hi and a_hi*b_hi passes read the stage as copied; then,
//     between two warpgroup barriers (every warp's two passes have read it;
//     the lo part is written and fenced for the async proxy), each thread
//     rewrites its share of the stage as b_lo, which the third pass reads.
//   * Why one plane split in shared memory, and not hi and lo planes packed
//     ahead as mrf_stage.cu's are: every block streams its columns of the
//     layer's 8.4 MB from L2 (4.2 MB a layer at S = 2, 0.55 GB a wave of
//     132 blocks), already 3.1 TB/s at 18 ms a 16 x 1152 call; two planes
//     would double those bytes and the ring's room (the stack's y tile leaves
//     67 KB), which would halve the stage to 8 rows. Split in place, the two
//     stages of 16 rows a warpgroup fit beside the y tile of d <= 8 at S = 2
//     (64 KB for the four rings) and of d = 16 at S = 4 (32 KB), and the L2
//     carries one plane, as the mma.sync body's did.
//   * Measured against the alternatives (tools/stack_split.py and variants
//     of this body; H100 80GB HBM3, 700 W; 16 x 1152 at S = 2): 8-row
//     stages four deep were 19% slower (the two barriers and waits a stage
//     are paid per 8 rows), a third pass kept in flight into the next stage
//     8-31% slower (the slot is freed later, and the L2 latency shows), two
//     warpgroups of two units each (N = 256) at S = 2 4-11% slower than four
//     of one.
//
// float32 at any other shape (C % 32 == 0 but not 128, 256 or 512, or a dilation
// past MAX_DIL) - the earlier shared-memory tiled SIMT pair of launches a
// layer (gate_kernel, out_kernel: f32 FMA, x updated in place, g through
// device memory).
//
// The wrapper (ops/diffnet_stack.py:takes_tensor_cores) decides the body by
// the same rule as diffnet_stack_tc_info below, and the column split by
// column_split, passes both in, and reads back in `report` what ran: the
// library refuses a body or split that does not take the shape and never
// falls back to another one.
//
// Bound. At B=8, T=1024, C=256, L=20 one stack call does 171.8 GFLOP and
// moves ~205 MB in bf16 (168 MB of it the cond tensor), ~394 MB in float32:
// compute-bound on this card either way: 0.174 ms at the bf16 tensor-core
// peak, 1.041 ms at float32 accuracy (3 TF32 passes at 495 TFLOP/s), 2.564 ms
// at the float32 FMA peak. What limits stack_layer_tc (tools/stack_phases.py
// times the phases of a block): the two GEMMs take about half of a layer and
// are fed by the L2, not by the tensor cores - every 64-row block streams the
// layer's whole 1 MB of weights, 128 MB a layer over 128 blocks, about
// 4.3 TB/s while the GEMMs run, and the bare fragment-load + mma.sync loop is
// twice as fast as that; blocks of 128 rows do not fit the register file, so
// sharing the weight stream needs a cluster with multicast copies. The other
// half is staging y, the two epilogues (sigmoid * tanh; skip read from device
// memory) and the tail of the launch, none of which overlaps the products with
// one block of 8 warps an SM (234 registers a thread). stack_layer_tc32
// has the same shape with both costs larger (255 registers, 48 bytes spilled):
// 2 MB of float32 weights a layer per block (5.1 GB a call from the L2) and
// three mma.sync a product (the TF32 mma.sync rate measured on this card,
// 319.4 TFLOP/s in tools/mma_rate.py, gives 1.6 ms a call for the products
// alone), so the two have to overlap; the split adds integer and float work
// beside every mma. At C = 512 (stack_layer_wg; B = 16, T = 1152, cycle 4,
// S = 2) a call does 1.546 TFLOP, 9.37 ms at 3xTF32 on 495 TFLOP/s; it takes
// 17.9 ms, 52% of that (the mma.sync body it replaced: 24.9 ms, 38%), and
// every block streams its 4.2 MB of a layer's weights from L2, 3.1 TB/s over
// the call. What limits it (variants of its first build, two warpgroups of
// N = 256; H100 80GB HBM3): each stage's chain of waits - two passes, the
// two warpgroup barriers around the in-place lo, the third pass - which the
// other warpgroups' products fill only in part. Leaving out the third pass
// and its split took 35% off, not copying the weights after the first
// stages 9%; on the products it did execute it ran at 59% of the TF32 peak
// in full waves.
//
// Grid. A block owns a 64-row tile and runs alone on its SM, so a layer of
// the unsplit body launches ceil(T/64)*B blocks and lasts as long as one
// block (~127 us of the float32 body at C = 256) however few there are: a
// B = 1 singing phrase of 1,152 frames filled 18 of the H100's 132 SMs and
// took 2.55 ms a call, the same as a full wave of 8 x 1024 (2.70 ms). The
// column split runs such a tile on S SMs at once: the grid is
// (ceil(T/64)*S, B) in clusters of (S, 1, 1), still never across two batch
// rows, so the halo rule is unchanged. A split block runs alone on its SM as
// an unsplit one does: it takes more than the 128 registers a thread that two
// blocks of 256 threads could share (ptxas -v). The
// wrapper (ops/diffnet_stack.py:column_split) picks S from the shape: the
// fewest ceil(tiles / resident(S)) * (1 + cost(S)) / S wave-units, with
// resident(S) from cudaOccupancyMaxActiveClusters (diffnet_stack_resident
// below; 132, 66 and 30 tiles at S = 1, 2, 4 on an H100 80GB HBM3) and
// cost(S) the fixed part of a block that does not shrink with its columns
// (staging the whole y tile, the launch's latency, the g exchange): measured
// 0.07-0.11 at S = 2 and 0.37-0.39 at S = 4 of 1/S of an unsplit block
// (tools/stack_split.py). A B = 1 phrase of 1,152 frames runs S = 4 in
// 0.89 ms, one of 2,432 frames S = 2 in 1.41 ms; full waves keep S = 1.
// At C = 512 (66 clusters of 2, 30 of 4 resident) a wave of S = 2 takes
// 3.2 ms a call and one of S = 4 2.2 ms, 0.35-0.37 beyond half of it: the
// rule takes S = 4 only where one wave of it holds every tile (up to 30);
// 16 x 1152 (288 tiles) runs S = 2 in 17.9 ms, 86 TFLOP/s (S = 2: 512
// threads of 128 registers, 12 bytes spilled; S = 4: 256 of 174).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma_sm90.cuh"

namespace {

constexpr float SQRT_HALF = 0.70710678118654752f;

// ------------------------------------------------------------- tensor cores
namespace tc {

using namespace mma90;
typedef __nv_bfloat16 bf16;

constexpr int TM = 64;    // rows per block
constexpr int NTHR = 256; // 8 warps, each 64 rows x (C/8 gate + C/8 filter) columns

// bfloat16 body
constexpr int KC = 16;    // contraction rows per staged weight chunk
constexpr int NST = 4;    // stages of each warp's weight ring

// Row strides carry 16 bytes of padding: ldmatrix's eight rows then fall on
// eight different 16-byte bank groups.
template <int C> __host__ __device__ constexpr int y_stride() { return C + 8; }      // bf16
template <int C> __host__ __device__ constexpr int w_stride() { return C / 4 + 8; }  // bf16, a warp's columns
template <int C> __host__ __device__ constexpr size_t smem_bytes(int d) {
  return ((size_t)(TM + 2 * d) * y_stride<C>() + (size_t)TM * y_stride<C>() +
          (size_t)8 * (NST * KC + TM) * w_stride<C>()) * sizeof(bf16);
}

// float32 body
constexpr int KC32 = 16;  // contraction rows per staged weight chunk (two m16n8k8 steps)
constexpr int NST32 = 3;  // stages of each warp's weight ring
// y / g rows: C + 4 floats, so ldmatrix's eight 16-byte rows fall on eight
// bank groups; ring rows: a warp's 2C/(8S) columns + 8 floats (S the column
// split), so the four k rows of a B fragment load (lanes 4k..4k+3 apart by
// one row) hit 32 banks.
template <int C> __host__ __device__ constexpr int y_stride32() { return C + 4; }
template <int C, int S> __host__ __device__ constexpr int w_stride32() { return C / (4 * S) + 8; }
template <int C, int S = 1> __host__ __device__ constexpr size_t smem_bytes32(int d) {
  return ((size_t)(TM + 2 * d) * y_stride32<C>() +
          (size_t)8 * NST32 * KC32 * w_stride32<C, S>()) * sizeof(float);
}

// The column splits the float32 body is built for: S blocks of a thread-block
// cluster share a 64-row tile, at C = 256 and C = 512, the widths the split's
// cost was measured at (a warp keeps whole 8-column mma tiles of each half up
// to S = 4). C = 512 is split always: an unsplit block's y tile and rings
// (and its 256 accumulators a thread) do not fit. The wrapper's rule
// (ops/diffnet_stack.py:splits_for) names the same splits.
__host__ __device__ constexpr bool split_takes(int C, int split) {
  return C == 512 ? split == 2 || split == 4
                  : split == 1 || (C == 256 && (split == 2 || split == 4));
}

// Thread-block clusters (sm_90): the shared::cluster address of the same
// variable in block `rank` of the cluster, a 16-byte load from there, and the
// cluster-wide barrier split in its two halves (arrive releases this thread's
// writes, wait acquires every other thread's; each thread alternates them).
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The widest dilation either body takes: the y tile with both halos still fits
// beside the weight rings at C = 256, and at C = 512 split four ways. The
// wrapper's dispatch rule (ops/diffnet_stack.py:TC_MAX_DILATION) names the
// same widths and dilation.
constexpr int MAX_DIL = 16;
constexpr size_t SMEM_LIMIT = 227 * 1024;
static_assert(smem_bytes<256>(MAX_DIL) <= SMEM_LIMIT && smem_bytes32<256>(MAX_DIL) <= SMEM_LIMIT &&
                  smem_bytes<128>(MAX_DIL) <= SMEM_LIMIT && smem_bytes32<128>(MAX_DIL) <= SMEM_LIMIT,
              "a tensor-core body's tiles exceed the block's shared memory");

__device__ __forceinline__ float sigmoid_f(float a) {
  a = fminf(fmaxf(a, -30.f), 30.f);
  return __fdividef(1.f, 1.f + __expf(-a));
}
__device__ __forceinline__ float tanh_f(float a) {
  a = fminf(fmaxf(a, -15.f), 15.f);
  return 1.f - __fdividef(2.f, 1.f + __expf(2.f * a));
}

// Built with -DSTACK_PHASE_CLOCKS (tools/stack_phases.py does), thread 0 of
// every block records clock64() at six points of the last layer launched.
#ifdef STACK_PHASE_CLOCKS
constexpr int CLK_POINTS = 6, CLK_BLOCKS = 4096;
__device__ long long g_clk[CLK_BLOCKS * CLK_POINTS];
#define PHASE_CLOCK(i)                                                               \
  if (threadIdx.x == 0 && blockIdx.y * gridDim.x + blockIdx.x < CLK_BLOCKS)          \
  g_clk[(blockIdx.y * gridDim.x + blockIdx.x) * CLK_POINTS + (i)] = clock64()
#else
#define PHASE_CLOCK(i)
#endif

template <int C>
__global__ void __launch_bounds__(NTHR, 1)
stack_layer_tc(const float* __restrict__ x_in, float* __restrict__ x_out,
               float* __restrict__ skip, const float* __restrict__ step,
               const bf16* __restrict__ cond, const bf16* __restrict__ w_dil,
               const float* __restrict__ b_dil, const bf16* __restrict__ w_out,
               const float* __restrict__ b_out, int B, int T, int l, int d) {
  constexpr int C2 = 2 * C, YS = y_stride<C>(), WS = w_stride<C>();
  constexpr int WC = C / 8;              // columns a warp owns in each half
  constexpr int NTH = C / 64;            // 8-column tiles per half per warp
  constexpr int PPH = WC / 8;            // 16-byte pieces of a bf16 row per half
  constexpr int NG = 3 * C / KC;         // weight chunks of the dilated conv
  constexpr int NCH = NG + C / KC;       // ... plus those of the out projection
  static_assert(C % 128 == 0, "two n-tiles per ldmatrix.x4");
  static_assert(TM * WC * 4 <= TM * WS * 2, "the x tile fits the cond tile");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ys = reinterpret_cast<bf16*>(smem_raw);      // [TM + 2d][YS] y, shared
  bf16* gs = ys + (size_t)(TM + 2 * d) * YS;         // [TM][YS] g, shared
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // private to the warp: its weight ring and its cond tile (columns
  // [0, WC) gate, [WC, 2WC) filter), which later holds its f32 x tile
  bf16* wring = gs + (size_t)TM * YS + (size_t)warp * (NST * KC + TM) * WS;  // [NST][KC][WS]
  bf16* ctile = wring + (size_t)NST * KC * WS;                               // [TM][WS]
  float* xtile = reinterpret_cast<float*>(ctile);                            // [TM][WS / 2]

  const int g8 = lane / 4, t4 = lane % 4;
  const int b = blockIdx.y, t0 = blockIdx.x * TM;
  const int wcol = warp * WC;             // this warp's first column in each half
  const bf16* wd_l = w_dil + (size_t)l * 3 * C * C2;
  const bf16* wo_l = w_out + (size_t)l * C * C2;
  const bf16* cond_b = cond + ((size_t)l * B + b) * T * C2;
  const float* xin_b = x_in + (size_t)b * T * C;

  PHASE_CLOCK(0);
  // Layers after the first are launched to overlap the layer before them:
  // up to griddep_wait() only inputs of the whole call are touched (cond,
  // weights), never x, skip or anything else a layer writes.
  griddep_launch_dependents();
  // the warp's cond tile first: the oldest copy group, landed before any chunk
  for (int p = lane; p < TM * 2 * PPH; p += 32) {
    const int r = p / (2 * PPH), hp = p % (2 * PPH), h = hp / PPH, q = hp % PPH;
    if (t0 + r < T)
      cp_async16(smem_u32(ctile + r * WS + h * WC + q * 8),
                 cond_b + (size_t)(t0 + r) * C2 + h * C + wcol + q * 8);
  }
  cp_async_commit();
  // chunk ch: rows [KC ch, KC ch + KC) of [w_dil[l] (3C rows); w_out[l] (C rows)],
  // the warp's gate and filter columns only
  auto fetch = [&](int ch) {
    const bf16* src = (ch < NG ? wd_l + (size_t)ch * KC * C2
                               : wo_l + (size_t)(ch - NG) * KC * C2) + wcol;
    bf16* dst = wring + (size_t)(ch % NST) * KC * WS;
#pragma unroll
    for (int p = lane; p < KC * 2 * PPH; p += 32) {
      const int r = p / (2 * PPH), hp = p % (2 * PPH), h = hp / PPH, q = hp % PPH;
      cp_async16(smem_u32(dst + r * WS + h * WC + q * 8), src + (size_t)r * C2 + h * C + q * 8);
    }
  };
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    fetch(s);
    cp_async_commit();
  }
  griddep_wait();   // the layer before has completed: x_in and skip are final
  // the residual epilogue's skip rows: pull them into L2 meanwhile
  if (l > 0)
    for (int i = tid; i < TM * (C * 4 / 128); i += NTHR) {
      const int t = t0 + i / (C * 4 / 128);
      if (t < T) prefetch_l2(skip + ((size_t)b * T + t) * C + (i % (C * 4 / 128)) * 32);
    }
  // y = bf16(x + step), rows t0 - d .. t0 + TM + d, zero outside [0, T);
  // up to 24 loads in flight per thread (all of them for d <= 16 at C = 256)
  {
    constexpr int CP4 = C / 4, RPP = NTHR / CP4;   // float4 per row, rows per pass
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
        __nv_bfloat162 lo = __floats2bfloat162_rn(in ? v[u].x + sv.x : 0.f, in ? v[u].y + sv.y : 0.f);
        __nv_bfloat162 hi = __floats2bfloat162_rn(in ? v[u].z + sv.z : 0.f, in ? v[u].w + sv.w : 0.f);
        uint2 pk;
        pk.x = *reinterpret_cast<uint32_t*>(&lo);
        pk.y = *reinterpret_cast<uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(ys + (size_t)q * YS + c4 * 4) = pk;
      }
    }
  }
  __syncthreads();   // y is staged
  PHASE_CLOCK(1);

  float acc[4][2 * NTH][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2 * NTH; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int ch = 0; ch < NCH; ++ch) {
    if (ch == NG) {
      PHASE_CLOCK(2);   // conv GEMM done
      // gate epilogue: bias + cond, sigmoid * tanh, g -> shared memory (bf16)
      const float* bd_l = b_dil + (size_t)l * C2;
#pragma unroll
      for (int nt = 0; nt < NTH; ++nt) {
        const int cw = nt * 8 + 2 * t4, col = wcol + cw;
        const float2 bg = *reinterpret_cast<const float2*>(bd_l + col);
        const float2 bf = *reinterpret_cast<const float2*>(bd_l + C + col);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int r = mt * 16 + g8 + hr * 8;
            __nv_bfloat162 gv = __floats2bfloat162_rn(0.f, 0.f);
            if (t0 + r < T) {
              const float2 cg = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(ctile + r * WS + cw));
              const float2 cf = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(ctile + r * WS + WC + cw));
              const float g0 = acc[mt][nt][hr * 2] + bg.x + cg.x;
              const float g1 = acc[mt][nt][hr * 2 + 1] + bg.y + cg.y;
              const float f0 = acc[mt][NTH + nt][hr * 2] + bf.x + cf.x;
              const float f1 = acc[mt][NTH + nt][hr * 2 + 1] + bf.y + cf.y;
              gv = __floats2bfloat162_rn(sigmoid_f(g0) * tanh_f(f0),
                                         sigmoid_f(g1) * tanh_f(f1));
            }
            *reinterpret_cast<__nv_bfloat162*>(gs + (size_t)r * YS + col) = gv;
          }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2 * NTH; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
      __syncthreads();   // every warp's g columns are written
      PHASE_CLOCK(3);
      // the cond tile is spent: the warp's f32 x rows (its residual columns)
      // take its place, copied with the next weight chunk's group
      for (int p = lane; p < TM * 2 * PPH; p += 32) {
        const int r = p / (2 * PPH), q = p % (2 * PPH);
        if (t0 + r < T)
          cp_async16(smem_u32(xtile + r * (WS / 2) + q * 4),
                     xin_b + (size_t)(t0 + r) * C + wcol + q * 4);
      }
    }
    cp_async_wait<NST - 2>();   // this lane's part of chunk ch has landed
    __syncwarp();               // ... and the other lanes'; chunk ch - 1's stage is free
    if (ch + NST - 1 < NCH) fetch(ch + NST - 1);
    cp_async_commit();

    const bf16* wst = wring + (size_t)(ch % NST) * KC * WS;
    const bf16* abase;
    if (ch < NG) {
      const int tap = (ch * KC) / C, c0 = (ch * KC) % C;
      abase = ys + (size_t)(tap * d) * YS + c0;   // tile row r + tap*d is t0 + r + (tap-1)d
    } else {
      abase = gs + (ch - NG) * KC;
    }
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
      ldmatrix_x4(a, smem_u32(abase + (size_t)(mt * 16 + lane % 16) * YS + (lane / 16) * 8));
#pragma unroll
      for (int nt = 0; nt < 2 * NTH; ++nt) mma_bf16(acc[mt][nt], a, bfr[nt][0], bfr[nt][1]);
    }
  }
  cp_async_wait<0>();   // the x tile
  __syncwarp();
  PHASE_CLOCK(4);   // out GEMM done

  // residual epilogue: x_out = (x_in + res) * sqrt(1/2), skip (+)= sk
  const float* bo_l = b_out + (size_t)l * C2;
#pragma unroll
  for (int nt = 0; nt < NTH; ++nt) {
    const int cw = nt * 8 + 2 * t4, col = wcol + cw;
    const float2 br = *reinterpret_cast<const float2*>(bo_l + col);
    const float2 bs = *reinterpret_cast<const float2*>(bo_l + C + col);
    float2 so[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int t = t0 + mt * 16 + g8 + hr * 8;
        so[mt][hr] = make_float2(0.f, 0.f);
        if (l > 0 && t < T)
          so[mt][hr] = *reinterpret_cast<const float2*>(skip + ((size_t)b * T + t) * C + col);
      }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = mt * 16 + g8 + hr * 8, t = t0 + r;
        if (t >= T) continue;
        const size_t o = ((size_t)b * T + t) * C + col;
        const float2 xi = *reinterpret_cast<const float2*>(xtile + r * (WS / 2) + cw);
        float2 xo, sk;
        xo.x = (xi.x + (acc[mt][nt][hr * 2] + br.x)) * SQRT_HALF;
        xo.y = (xi.y + (acc[mt][nt][hr * 2 + 1] + br.y)) * SQRT_HALF;
        sk.x = so[mt][hr].x + (acc[mt][NTH + nt][hr * 2] + bs.x);
        sk.y = so[mt][hr].y + (acc[mt][NTH + nt][hr * 2 + 1] + bs.y);
        *reinterpret_cast<float2*>(x_out + o) = xo;
        *reinterpret_cast<float2*>(skip + o) = sk;
      }
  }
  PHASE_CLOCK(5);
}

// The float32 bodies' y tile: y = x + step over rows t0 - d .. t0 + TM + d
// of batch row b ((TM + 2d) rows of YS floats, tile row q is sequence row
// t0 - d + q), zero outside [0, T); all C columns, whatever the split (each
// output column reads every channel). Up to 24 float4 loads in flight a thread.
template <int C, int NT = NTHR>
__device__ __forceinline__ void stage_y32(float* ys, const float* __restrict__ xin_b,
                                          const float* __restrict__ step_lb, int t0, int T,
                                          int d, int tid) {
  constexpr int YS = y_stride32<C>(), CP4 = C / 4, RPP = NT / CP4, UN = 24 * NTHR / NT;
  const int c4 = tid % CP4, rq = tid / CP4;
  const float4 sv = reinterpret_cast<const float4*>(step_lb)[c4];
  const int nrows = TM + 2 * d;
  for (int q0 = 0; q0 < nrows; q0 += UN * RPP) {
    float4 v[UN];
#pragma unroll
    for (int u = 0; u < UN; ++u) {
      const int q = q0 + u * RPP + rq, t = t0 - d + q;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q < nrows && t >= 0 && t < T) {
        v[u] = reinterpret_cast<const float4*>(xin_b + (size_t)t * C)[c4];
        v[u].x += sv.x;
        v[u].y += sv.y;
        v[u].z += sv.z;
        v[u].w += sv.w;
      }
    }
#pragma unroll
    for (int u = 0; u < UN; ++u) {
      const int q = q0 + u * RPP + rq;
      if (q < nrows) *reinterpret_cast<float4*>(ys + (size_t)q * YS + c4 * 4) = v[u];
    }
  }
}

// The g exchange of a split float32 body, after a cluster barrier: the out
// GEMM contracts over all C columns of g, so each block copies the other
// blocks' columns (CC = C / S each) of the tile's first TM rows from their
// shared memory (distributed shared memory) into the same place in its own;
// nobody writes a block's own columns again in the layer. At most 12 float4
// loads in flight a thread: all of them at C = 256, batches of 8 at C = 512.
template <int C, int S, int NT = NTHR>
__device__ __forceinline__ void pull_g(float* ys, int rank, int tid) {
  constexpr int YS = y_stride32<C>(), CC = C / S, P4 = CC / 4;
  constexpr int NPULL = (S - 1) * TM * P4 / NT, PB = NPULL <= 12 ? NPULL : 8;
  static_assert((S - 1) * TM * P4 % NT == 0 && NPULL % PB == 0, "whole pulls a thread");
#pragma unroll
  for (int q0 = 0; q0 < NPULL; q0 += PB) {
    float4 v[PB];
#pragma unroll
    for (int u = 0; u < PB; ++u) {
      const int i = (q0 + u) * NT + tid, peer = (rank + 1 + i / (TM * P4)) % S;
      const int r = i / P4 % TM, col = peer * CC + i % P4 * 4;
      v[u] = ld_cluster_f4(cluster_map(smem_u32(ys + (size_t)r * YS + col), peer));
    }
#pragma unroll
    for (int u = 0; u < PB; ++u) {
      const int i = (q0 + u) * NT + tid, peer = (rank + 1 + i / (TM * P4)) % S;
      const int r = i / P4 % TM, col = peer * CC + i % P4 * 4;
      *reinterpret_cast<float4*>(ys + (size_t)r * YS + col) = v[u];
    }
  }
}

// Diagnostic builds of the float32 body (tools/stack_ablate.py; the results
// are wrong, only the times mean something): -DSTACK_ABLATE_NO_SPLIT feeds
// the raw bits as both halves, -DSTACK_ABLATE_ONE_PASS runs one of the three
// products, -DSTACK_ABLATE_NO_WEIGHTS copies no weight chunk after the first
// two (the GEMMs read stale ring stages).
__device__ __forceinline__ void split32(float x, uint32_t& hi, uint32_t& lo) {
#ifdef STACK_ABLATE_NO_SPLIT
  hi = lo = __float_as_uint(x);
#else
  split_tf32(x, hi, lo);
#endif
}

// The float32 body: one layer of the stack on one 64-row tile of one batch
// row, products in 3xTF32 (see the note at the top of the file). S blocks
// (a cluster, S > 1) share the tile: block rank j of the cluster owns columns
// [jC/S, (j+1)C/S) of each half.
template <int C, int S>
__global__ void __launch_bounds__(NTHR, 1)
stack_layer_tc32(const float* __restrict__ x_in, float* __restrict__ x_out,
                 float* __restrict__ skip, const float* __restrict__ step,
                 const float* __restrict__ cond, const float* __restrict__ w_dil,
                 const float* __restrict__ b_dil, const float* __restrict__ w_out,
                 const float* __restrict__ b_out, int B, int T, int l, int d) {
  constexpr int C2 = 2 * C, YS = y_stride32<C>(), WS = w_stride32<C, S>();
  constexpr int CC = C / S;              // columns the block owns in each half
  constexpr int WC = CC / 8;             // columns a warp owns in each half
  constexpr int NTH = WC / 8;            // 8-column tiles per half per warp
  constexpr int PPH = WC / 4;            // 16-byte pieces of a warp's row per half
  constexpr int KC = KC32;               // contraction rows of a weight chunk
  constexpr int NG = 3 * C / KC;         // weight chunks of the dilated conv
  constexpr int NCH = NG + C / KC;       // ... plus those of the out projection
  constexpr int LPH = CC * 4 / 128;      // 128-byte lines of the block's columns of a half
  static_assert(split_takes(C, S) && C % 64 == 0 && KC % 8 == 0, "whole n-tiles and k-steps");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [TM + 2d][YS] y (tile row q is sequence row t0 - d + q); once the conv
  // GEMM is done its first TM rows hold g
  float* ys = reinterpret_cast<float*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // private to the warp: its weight ring, [NST32][KC][WS], columns [0, WC)
  // gate (or residual), [WC, 2WC) filter (or skip)
  float* wring = ys + (size_t)(TM + 2 * d) * YS + (size_t)warp * NST32 * KC * WS;

  const int g8 = lane / 4, t4 = lane % 4;
  // a cluster is S consecutive blocks along x, so its rank is blockIdx.x % S
  const int rank = blockIdx.x % S;
  const int b = blockIdx.y, t0 = blockIdx.x / S * TM;
  const int wcol = rank * CC + warp * WC; // this warp's first column in each half
  const float* wd_l = w_dil + (size_t)l * 3 * C * C2;
  const float* wo_l = w_out + (size_t)l * C * C2;
  const float* cond_b = cond + ((size_t)l * B + b) * T * C2;
  const float* xin_b = x_in + (size_t)b * T * C;

  PHASE_CLOCK(0);
  // up to griddep_wait() only inputs of the whole call are touched (cond,
  // weights, step), never x, skip or anything else a layer writes
  griddep_launch_dependents();
  // the gate epilogue reads the block's cond rows from device memory: pull
  // them into L2 now
  for (int i = tid; i < TM * 2 * LPH; i += NTHR) {
    const int t = t0 + i / (2 * LPH), h = i % (2 * LPH) / LPH;
    if (t < T) prefetch_l2(cond_b + (size_t)t * C2 + h * C + rank * CC + (i % LPH) * 32);
  }
  // chunk ch: rows [KC ch, KC ch + KC) of [w_dil[l] (3C rows); w_out[l]
  // (C rows)], the warp's two column groups only
  auto fetch = [&](int ch) {
    const float* src = (ch < NG ? wd_l + (size_t)ch * KC * C2
                                : wo_l + (size_t)(ch - NG) * KC * C2) + wcol;
    float* dst = wring + (size_t)(ch % NST32) * KC * WS;
#pragma unroll
    for (int p = lane; p < KC * 2 * PPH; p += 32) {
      const int r = p / (2 * PPH), hp = p % (2 * PPH), h = hp / PPH, q = hp % PPH;
      cp_async16(smem_u32(dst + r * WS + h * WC + q * 4), src + (size_t)r * C2 + h * C + q * 4);
    }
  };
#pragma unroll
  for (int s = 0; s < NST32 - 1; ++s) {
    fetch(s);
    cp_async_commit();
  }
  griddep_wait();   // the layer before has completed: x_in and skip are final
  if (l > 0)
    for (int i = tid; i < TM * LPH; i += NTHR) {
      const int t = t0 + i / LPH;
      if (t < T) prefetch_l2(skip + ((size_t)b * T + t) * C + rank * CC + (i % LPH) * 32);
    }
  stage_y32<C>(ys, xin_b, step + ((size_t)l * B + b) * C, t0, T, d, tid);
  __syncthreads();   // y is staged
  PHASE_CLOCK(1);

  float acc[4][2 * NTH][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2 * NTH; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int ch = 0; ch < NCH; ++ch) {
    if (ch == NG) {
      PHASE_CLOCK(2);   // conv GEMM done
      // gate epilogue: bias + cond, sigmoid * tanh, into the gate accumulators
      const float* bd_l = b_dil + (size_t)l * C2;
#pragma unroll
      for (int nt = 0; nt < NTH; ++nt) {
        const int col = wcol + nt * 8 + 2 * t4;
        const float2 bg = *reinterpret_cast<const float2*>(bd_l + col);
        const float2 bf = *reinterpret_cast<const float2*>(bd_l + C + col);
        float2 cg[4][2], cf[4][2];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int t = t0 + mt * 16 + g8 + hr * 8;
            cg[mt][hr] = cf[mt][hr] = make_float2(0.f, 0.f);
            if (t < T) {
              const float* cr = cond_b + (size_t)t * C2 + col;
              cg[mt][hr] = *reinterpret_cast<const float2*>(cr);
              cf[mt][hr] = *reinterpret_cast<const float2*>(cr + C);
            }
          }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            float* ga = &acc[mt][nt][hr * 2];
            const float* fa = &acc[mt][NTH + nt][hr * 2];
            const float g0 = ga[0] + bg.x + cg[mt][hr].x, g1 = ga[1] + bg.y + cg[mt][hr].y;
            const float f0 = fa[0] + bf.x + cf[mt][hr].x, f1 = fa[1] + bf.y + cf[mt][hr].y;
            ga[0] = sigmoid_f(g0) * tanh_f(f0);
            ga[1] = sigmoid_f(g1) * tanh_f(f1);
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
            *reinterpret_cast<float2*>(ys + (size_t)r * YS + wcol + nt * 8 + 2 * t4) = gv;
          }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2 * NTH; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
      if constexpr (S == 1) {
        __syncthreads();   // every warp's g columns are written
      } else {
        cluster_arrive();  // every block of the cluster has written its g columns
        cluster_wait();
        pull_g<C, S>(ys, rank, tid);
        // this block has read the others' columns; it waits at its end for
        // every block to have read its own, so none exits while a peer reads
        cluster_arrive();
        __syncthreads();   // the whole g tile is here
      }
      PHASE_CLOCK(3);
    }
    cp_async_wait<NST32 - 2>();   // this lane's part of chunk ch has landed
    __syncwarp();                 // ... and the other lanes'; chunk ch - 1's stage is free
#ifndef STACK_ABLATE_NO_WEIGHTS
    if (ch + NST32 - 1 < NCH) fetch(ch + NST32 - 1);
#endif
    cp_async_commit();

    const float* wst = wring + (size_t)(ch % NST32) * KC * WS;
    const float* abase;
    if (ch < NG) {
      const int tap = (ch * KC) / C, c0 = (ch * KC) % C;
      abase = ys + (size_t)(tap * d) * YS + c0;   // tile row r + tap*d is t0 + r + (tap-1)d
    } else {
      abase = ys + (ch - NG) * KC;                // g
    }
#pragma unroll
    for (int k8 = 0; k8 < KC / 8; ++k8) {
      // B fragments of all the warp's n-tiles (gate or residual tiles first,
      // then filter or skip: tile nt is ring columns 8nt..8nt+7), split once
      uint32_t bh[2 * NTH][2], bl[2 * NTH][2];
#pragma unroll
      for (int nt = 0; nt < 2 * NTH; ++nt) {
        const float* wp = wst + (size_t)(k8 * 8 + t4) * WS + nt * 8 + g8;
        split32(wp[0], bh[nt][0], bl[nt][0]);
        split32(wp[4 * WS], bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t a[4], ah[4], al[4];
        ldmatrix_x4(a, smem_u32(abase + (size_t)(mt * 16 + lane % 16) * YS + k8 * 8 +
                                (lane / 16) * 4));
#pragma unroll
        for (int e = 0; e < 4; ++e) split32(__uint_as_float(a[e]), ah[e], al[e]);
        // the small products first; each pass runs over all n-tiles, so an
        // accumulator's three mma are 2 NTH instructions apart
#ifndef STACK_ABLATE_ONE_PASS
#pragma unroll
        for (int nt = 0; nt < 2 * NTH; ++nt) mma_tf32(acc[mt][nt], al, bh[nt][0], bh[nt][1]);
#pragma unroll
        for (int nt = 0; nt < 2 * NTH; ++nt) mma_tf32(acc[mt][nt], ah, bl[nt][0], bl[nt][1]);
#endif
#pragma unroll
        for (int nt = 0; nt < 2 * NTH; ++nt) mma_tf32(acc[mt][nt], ah, bh[nt][0], bh[nt][1]);
      }
    }
  }
  PHASE_CLOCK(4);   // out GEMM done

  // residual epilogue: x_out = (x_in + res) * sqrt(1/2), skip (+)= sk; x_in
  // and skip in fragment order from device memory
  const float* bo_l = b_out + (size_t)l * C2;
#pragma unroll
  for (int nt = 0; nt < NTH; ++nt) {
    const int col = wcol + nt * 8 + 2 * t4;
    const float2 br = *reinterpret_cast<const float2*>(bo_l + col);
    const float2 bs = *reinterpret_cast<const float2*>(bo_l + C + col);
    float2 xi[4][2], so[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int t = t0 + mt * 16 + g8 + hr * 8;
        xi[mt][hr] = so[mt][hr] = make_float2(0.f, 0.f);
        if (t < T) {
          const size_t o = ((size_t)b * T + t) * C + col;
          xi[mt][hr] = *reinterpret_cast<const float2*>(x_in + o);
          if (l > 0) so[mt][hr] = *reinterpret_cast<const float2*>(skip + o);
        }
      }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int t = t0 + mt * 16 + g8 + hr * 8;
        if (t >= T) continue;
        const size_t o = ((size_t)b * T + t) * C + col;
        float2 xo, sk;
        xo.x = (xi[mt][hr].x + (acc[mt][nt][hr * 2] + br.x)) * SQRT_HALF;
        xo.y = (xi[mt][hr].y + (acc[mt][nt][hr * 2 + 1] + br.y)) * SQRT_HALF;
        sk.x = so[mt][hr].x + (acc[mt][NTH + nt][hr * 2] + bs.x);
        sk.y = so[mt][hr].y + (acc[mt][NTH + nt][hr * 2 + 1] + bs.y);
        *reinterpret_cast<float2*>(x_out + o) = xo;
        *reinterpret_cast<float2*>(skip + o) = sk;
      }
  }
  PHASE_CLOCK(5);
  if constexpr (S > 1) cluster_wait();   // every peer has read this block's g columns
}

// ----------------------------------------------- float32 at C = 512 on wgmma
// stack_layer_wg<S>: the body of the note's "C = 512" paragraph. The weights
// come packed (ops/diffnet_stack.py:wg_weights): per layer the 4C rows of
// [w_dil (3C rows); w_out (C rows)] in 8-row steps, each step's 2C columns in
// eight 64-column units (unit u: gate or residual columns [64u, 64u + 64),
// then filter or skip columns C + [64u, 64u + 64)), a unit's 128 columns in
// wgmma's K-major core matrices (8 columns x 4 rows, 16 bytes): element (row
// k, column n) of a unit at ((n / 8) * 2 + k / 4) * 32 + (n % 8) * 4 + k % 4.
constexpr int WG_KC = 16;                       // contraction rows of a ring stage
constexpr int WG_NST = 2;                       // stages of each warpgroup's ring
constexpr int WG_N = 128;                       // a unit's columns: a warpgroup's wgmma N
constexpr int WG_UNIT = 8 * WG_N;               // floats of a unit in one 8-row step
constexpr int WG_STEP = (512 / 64) * WG_UNIT;   // floats of one 8-row step, all units
constexpr size_t WG_LAYER = (size_t)(4 * 512 / 8) * WG_STEP;
constexpr int WG_BARS = 128;                    // bytes of mbarriers and counters
constexpr int WG_STAGE = WG_KC * WG_N;          // floats of a ring stage
// a block split S ways owns 8 / S units: a warpgroup each
template <int S> __host__ __device__ constexpr int wg_threads() { return 128 * 8 / S; }
template <int S> __host__ __device__ constexpr size_t smem_bytes_wg(int d) {
  return WG_BARS + ((size_t)8 / S * WG_NST * WG_STAGE + (size_t)(TM + 2 * d) * y_stride32<512>()) *
                       sizeof(float);
}
static_assert(smem_bytes_wg<4>(MAX_DIL) <= SMEM_LIMIT && smem_bytes_wg<2>(8) <= SMEM_LIMIT &&
                  smem_bytes_wg<2>(9) > SMEM_LIMIT,
              "<512, 4> holds the widest halo, <512, 2> cycle 4's (d <= 8)");

// The remainder of the 3xTF32 split (split_tf32's lo)
__device__ __forceinline__ float tf32_lo(float x) {
  return __uint_as_float(__float_as_uint(x - __uint_as_float(__float_as_uint(x) & TF32_MASK)) &
                         TF32_MASK);
}

// A warpgroup's weight ring: WG_NST slots of one stage of its unit, each
// filled by bulk copies that complete on the slot's mbarrier.
struct WgRing {
  static constexpr int KU = WG_KC / 8;          // 8-row steps a stage
  static constexpr int NCH = 4 * 512 / WG_KC;   // stages a layer
  float* ring;          // [WG_NST][WG_STAGE]
  uint32_t full0;       // the slots' mbarriers
  int* freed;           // [WG_NST] warps done with a slot, ever
  const float* wsrc;    // the layer's packed weights at the warpgroup's unit
  // stage n (rows [16n, 16n + 16) of the layer's 4C) into slot n % WG_NST:
  // one copy per 8-row step
  __device__ __forceinline__ void fill(int n) const {
    if (n >= NCH) return;
    const int s = n % WG_NST;
    mbar_arrive_expect_tx(full0 + 8 * s, WG_STAGE * 4);
#pragma unroll
    for (int u = 0; u < KU; ++u)
      bulk_copy_g2s(smem_u32(ring + s * WG_STAGE + u * WG_UNIT),
                    wsrc + (size_t)(n * KU + u) * WG_STEP, WG_UNIT * 4, full0 + 8 * s);
  }
  // this warp is done with stage n: the last of the warpgroup's four to be
  // done refills its slot with stage n + WG_NST
  __device__ __forceinline__ void release(int n, int lane) const {
    if (lane == 0 && atomicAdd(freed + n % WG_NST, 1) % 4 == 3) fill(n + WG_NST);
  }
};

// Stage n of a warpgroup's products, A at abase (this lane's row and column
// of y or g): A loaded and split once into hi and lo; the a_lo*b_hi and
// a_hi*b_hi passes on the stage as copied (the tensor cores read a float32
// operand's top 19 bits, its hi part); the stage turned into its lo part in
// place once every warp's two passes have read it; the a_hi*b_lo pass; the
// slot released.
__device__ __forceinline__ void wg_stage(int n, const float* abase, float (&acc)[WG_N / 2],
                                         const WgRing& rg, int wgi, int wt, int lane) {
  constexpr int KU = WG_KC / 8, CV = WG_STAGE / 4 / 128;
  const int s = n % WG_NST;
  uint32_t ah[KU][4], al[KU][4];
#pragma unroll
  for (int u = 0; u < KU; ++u) {
    uint32_t a[4];
    ldmatrix_x4(a, smem_u32(abase + u * 8));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      split_tf32(__uint_as_float(a[e]), ah[u][e], al[u][e]);
      reg_fence(ah[u][e]);
      reg_fence(al[u][e]);
    }
  }
  mbar_wait(rg.full0 + 8 * s, (n / WG_NST) & 1);
  // an 8-deep step's rows of the stage: N columns in core matrices, two
  // along K (128 bytes apart), 8-column groups 256 bytes apart
  const uint32_t sb = smem_u32(rg.ring + s * WG_STAGE);
  wgmma_fence();
#pragma unroll
  for (int u = 0; u < KU; ++u) {
    const uint64_t desc = wgmma_desc(sb + u * WG_N * 32, 128, 256);
    wgmma_tf32_rs(acc, al[u], desc);
    wgmma_tf32_rs(acc, ah[u], desc);
  }
  wgmma_commit();
  // meanwhile: this thread's share of the stage as its lo part
  float4* ring4 = reinterpret_cast<float4*>(rg.ring + s * WG_STAGE);
  float4 lo[CV];
#pragma unroll
  for (int i = 0; i < CV; ++i) {
    const float4 v = ring4[i * 128 + wt];
    lo[i] = make_float4(tf32_lo(v.x), tf32_lo(v.y), tf32_lo(v.z), tf32_lo(v.w));
  }
  wgmma_wait<0>();
#pragma unroll
  for (int u = 0; u < KU; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) reg_fence(al[u][e]);
  named_bar_sync(1 + wgi, 128);   // every warp's two passes have read the stage
#pragma unroll
  for (int i = 0; i < CV; ++i) ring4[i * 128 + wt] = lo[i];
  fence_proxy_async();
  named_bar_sync(1 + wgi, 128);   // the stage holds the lo part
  wgmma_fence();
#pragma unroll
  for (int u = 0; u < KU; ++u)
    wgmma_tf32_rs(acc, ah[u], wgmma_desc(sb + u * WG_N * 32, 128, 256));
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int u = 0; u < KU; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) reg_fence(ah[u][e]);
  rg.release(n, lane);
}

// One layer of the float32 stack at C = 512 on one 64-row tile of one batch
// row, split S ways over a cluster: block rank j owns units [8j/S, 8(j+1)/S),
// a warpgroup each.
template <int S>
__global__ void __launch_bounds__(wg_threads<S>(), 1)
stack_layer_wg(const float* __restrict__ x_in, float* __restrict__ x_out,
               float* __restrict__ skip, const float* __restrict__ step,
               const float* __restrict__ cond, const float* __restrict__ wpk,
               const float* __restrict__ b_dil, const float* __restrict__ b_out, int B, int T,
               int l, int d) {
  constexpr int C = 512, C2 = 2 * C, YS = y_stride32<C>();
  constexpr int NT = wg_threads<S>(), NWG = 8 / S, NACC = WG_N / 2;
  constexpr int CC = C / S;              // columns the block owns in each half
  constexpr int NG = 3 * C / WG_KC;      // stages of the dilated conv
  constexpr int NCH = NG + C / WG_KC;    // ... plus those of the out projection
  constexpr int LPH = CC * 4 / 128;      // 128-byte lines of the block's columns of a half
  static_assert(split_takes(C, S) && S > 1 && WG_STAGE % 512 == 0 &&
                    NWG * WG_NST * 12 <= WG_BARS, "whole float4 a thread; the barriers fit");

  extern __shared__ __align__(128) float wsmem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the warpgroup from a shuffle, so the compiler sees it uniform over the
  // warp (a wgmma under a branch it cannot prove uniform is serialized)
  const int wgi = __shfl_sync(0xffffffffu, warp / 4, 0), wl = warp % 4, wt = tid % 128;
  const int g8 = lane / 4, t4 = lane % 4;
  const int rank = blockIdx.x % S;       // a cluster is S consecutive blocks along x
  const int b = blockIdx.y, t0 = blockIdx.x / S * TM;
  const int unit = rank * NWG + wgi;     // the warpgroup's unit
  // per warpgroup: WG_NST mbarriers (a stage arrived) and counters (warps
  // done with a stage, ever), its ring [WG_NST][WG_STAGE]; then y, shared
  uint64_t* full = reinterpret_cast<uint64_t*>(wsmem) + wgi * WG_NST;
  int* freed = reinterpret_cast<int*>(reinterpret_cast<uint64_t*>(wsmem) + NWG * WG_NST) +
               wgi * WG_NST;
  float* ys = wsmem + WG_BARS / 4 + (size_t)NWG * WG_NST * WG_STAGE;
  const float* cond_b = cond + ((size_t)l * B + b) * T * C2;
  const WgRing rg{wsmem + WG_BARS / 4 + (size_t)wgi * WG_NST * WG_STAGE, smem_u32(full), freed,
                  wpk + (size_t)l * WG_LAYER + (size_t)unit * WG_UNIT};

  // up to griddep_wait() only inputs of the whole call are touched (cond,
  // weights, step), never x, skip or anything else a layer writes
  griddep_launch_dependents();
  if (wt == 0) {
    for (int s = 0; s < WG_NST; ++s) {
      mbar_init(rg.full0 + 8 * s, 1);
      freed[s] = 0;
    }
    mbar_init_fence();
    for (int n = 0; n < WG_NST; ++n) rg.fill(n);
  }
  for (int i = tid; i < TM * 2 * LPH; i += NT) {
    const int t = t0 + i / (2 * LPH), h = i % (2 * LPH) / LPH;
    if (t < T) prefetch_l2(cond_b + (size_t)t * C2 + h * C + rank * CC + (i % LPH) * 32);
  }
  griddep_wait();   // the layer before has completed: x_in and skip are final
  if (l > 0)
    for (int i = tid; i < TM * LPH; i += NT) {
      const int t = t0 + i / LPH;
      if (t < T) prefetch_l2(skip + ((size_t)b * T + t) * C + rank * CC + (i % LPH) * 32);
    }
  stage_y32<C, NT>(ys, x_in + (size_t)b * T * C, step + ((size_t)l * B + b) * C, t0, T, d, tid);
  __syncthreads();   // y is staged, the barriers are set up

  float acc[NACC];
#pragma unroll
  for (int e = 0; e < NACC; ++e) {
    acc[e] = 0.f;
    reg_fence(acc[e]);
  }
  // this lane's A row (a warp's 16 rows of the tile) and 4-column half of an
  // 8-deep step; its accumulator rows crow (+ 8)
  const int arow = wl * 16 + lane % 16, acol = (lane / 16) * 4, crow = wl * 16 + g8;
  // the conv GEMM: stage n's A is y at the tap's row offset
  for (int n = 0; n < NG; ++n)
    wg_stage(n, ys + (size_t)(arow + n * WG_KC / C * d) * YS + n * WG_KC % C + acol, acc, rg, wgi,
             wt, lane);
#pragma unroll
  for (int e = 0; e < NACC; ++e) reg_fence(acc[e]);
  // gate epilogue: bias + cond, sigmoid * tanh, into the gate accumulators
  // (column tile j of the unit's gate columns; j + 8 its filter columns)
  const float* bd_l = b_dil + (size_t)l * C2;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 64 * unit + 8 * j + 2 * t4;
    const float2 bg = *reinterpret_cast<const float2*>(bd_l + col);
    const float2 bf = *reinterpret_cast<const float2*>(bd_l + C + col);
    float2 cg[2], cf[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int t = t0 + crow + hr * 8;
      cg[hr] = cf[hr] = make_float2(0.f, 0.f);
      if (t < T) {
        const float* cr = cond_b + (size_t)t * C2 + col;
        cg[hr] = *reinterpret_cast<const float2*>(cr);
        cf[hr] = *reinterpret_cast<const float2*>(cr + C);
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float* ga = &acc[4 * j + 2 * hr];
      const float* fa = &acc[4 * (j + 8) + 2 * hr];
      const float g0 = ga[0] + bg.x + cg[hr].x, g1 = ga[1] + bg.y + cg[hr].y;
      const float f0 = fa[0] + bf.x + cf[hr].x, f1 = fa[1] + bf.y + cf[hr].y;
      ga[0] = sigmoid_f(g0) * tanh_f(f0);
      ga[1] = sigmoid_f(g1) * tanh_f(f1);
    }
  }
  __syncthreads();   // every warp has read its last y fragment: g may replace y
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = crow + hr * 8;
      const float2 gv = t0 + r < T ? make_float2(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1])
                                   : make_float2(0.f, 0.f);
      *reinterpret_cast<float2*>(ys + (size_t)r * YS + 64 * unit + 8 * j + 2 * t4) = gv;
    }
#pragma unroll
  for (int e = 0; e < NACC; ++e) {
    acc[e] = 0.f;
    reg_fence(acc[e]);
  }
  cluster_arrive();  // every block of the cluster has written its g columns
  cluster_wait();
  pull_g<C, S, NT>(ys, rank, tid);
  // this block has read the others' columns; it waits at its end for every
  // block to have read its own, so none exits while a peer reads
  cluster_arrive();
  __syncthreads();   // the whole g tile is here
  // the out GEMM over g
  for (int n = NG; n < NCH; ++n)
    wg_stage(n, ys + (size_t)arow * YS + (n - NG) * WG_KC + acol, acc, rg, wgi, wt, lane);
#pragma unroll
  for (int e = 0; e < NACC; ++e) reg_fence(acc[e]);

  // residual epilogue: x_out = (x_in + res) * sqrt(1/2), skip (+)= sk; x_in
  // and skip in fragment order from device memory (column tile j of the
  // unit's residual columns; j + 8 its skip columns)
  const float* bo_l = b_out + (size_t)l * C2;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 64 * unit + 8 * j + 2 * t4;
    const float2 br = *reinterpret_cast<const float2*>(bo_l + col);
    const float2 bs = *reinterpret_cast<const float2*>(bo_l + C + col);
    float2 xi[2], so[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int t = t0 + crow + hr * 8;
      xi[hr] = so[hr] = make_float2(0.f, 0.f);
      if (t < T) {
        const size_t o = ((size_t)b * T + t) * C + col;
        xi[hr] = *reinterpret_cast<const float2*>(x_in + o);
        if (l > 0) so[hr] = *reinterpret_cast<const float2*>(skip + o);
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int t = t0 + crow + hr * 8;
      if (t >= T) continue;
      const size_t o = ((size_t)b * T + t) * C + col;
      const float* ra = &acc[4 * j + 2 * hr];
      const float* sa = &acc[4 * (j + 8) + 2 * hr];
      float2 xo, sk;
      xo.x = (xi[hr].x + (ra[0] + br.x)) * SQRT_HALF;
      xo.y = (xi[hr].y + (ra[1] + br.y)) * SQRT_HALF;
      sk.x = so[hr].x + (sa[0] + bs.x);
      sk.y = so[hr].y + (sa[1] + bs.y);
      *reinterpret_cast<float2*>(x_out + o) = xo;
      *reinterpret_cast<float2*>(skip + o) = sk;
    }
  }
  cluster_wait();   // every peer has read this block's g columns
}

// A body: its kernel, the shared memory of a block at dilation d, and the
// launch of one layer (the wgmma body reads w_dil as wg_weights packs both
// weight tensors, and never w_out).
template <typename E, int C, int S> struct Body;
template <int C> struct Body<bf16, C, 1> {
  static auto kernel() { return stack_layer_tc<C>; }
  static int threads() { return NTHR; }
  static size_t smem(int d) { return smem_bytes<C>(d); }
  template <typename... A> static cudaError_t launch(const cudaLaunchConfig_t* cfg, A... args) {
    return cudaLaunchKernelEx(cfg, kernel(), args...);
  }
};
template <int C, int S> struct Body<float, C, S> {
  static auto kernel() { return stack_layer_tc32<C, S>; }
  static int threads() { return NTHR; }
  static size_t smem(int d) { return smem_bytes32<C, S>(d); }
  template <typename... A> static cudaError_t launch(const cudaLaunchConfig_t* cfg, A... args) {
    return cudaLaunchKernelEx(cfg, kernel(), args...);
  }
};
template <int S> struct Body<float, 512, S> {
  static auto kernel() { return stack_layer_wg<S>; }
  static int threads() { return wg_threads<S>(); }
  static size_t smem(int d) { return smem_bytes_wg<S>(d); }
  static cudaError_t launch(const cudaLaunchConfig_t* cfg, const float* xin, float* xout,
                            float* skip, const float* step, const float* cond,
                            const float* w_dil, const float* b_dil, const float*,
                            const float* b_out, int B, int T, int l, int d) {
    return cudaLaunchKernelEx(cfg, kernel(), xin, xout, skip, step, cond, w_dil, b_dil, b_out, B,
                              T, l, d);
  }
};

// The launch of one layer: grid, block, shared memory, and the attributes:
// programmatic dependent launch after the first layer, the cluster for S > 1.
template <int S> struct LayerLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  LayerLaunch(int T, int B, int threads, size_t smem, cudaStream_t stream, bool after_a_layer) {
    cfg.gridDim = dim3((T + TM - 1) / TM * S, B);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 0;
    if (after_a_layer) {
      attr[cfg.numAttrs].id = cudaLaunchAttributeProgrammaticStreamSerialization;
      attr[cfg.numAttrs++].val.programmaticStreamSerializationAllowed = 1;
    }
    if (S > 1) {
      attr[cfg.numAttrs].id = cudaLaunchAttributeClusterDimension;
      attr[cfg.numAttrs].val.clusterDim.x = S;
      attr[cfg.numAttrs].val.clusterDim.y = 1;
      attr[cfg.numAttrs++].val.clusterDim.z = 1;
    }
  }
};

// x0 is read only; xbuf holds two [B,T,C] f32 buffers the layers alternate
// between; skip needs no initial value (layer 0 writes it). cond and the
// weights are E (bf16 or float). S > 1 splits each tile's columns over a
// cluster of S blocks. Every launch the card takes is counted in *n_launched.
template <typename E, int C, int S>
int run(const float* x0, float* xbuf, float* skip, const float* step, const E* cond,
        const E* w_dil, const float* b_dil, const E* w_out, const float* b_out,
        int B, int T, int L, const int* dil, cudaStream_t stream, int* n_launched) {
  int dmax = 0;
  for (int l = 0; l < L; ++l) {
    if (dil[l] < 1) return (int)cudaErrorInvalidValue;
    if (dil[l] > dmax) dmax = dil[l];
  }
  if (dmax > MAX_DIL || Body<E, C, S>::smem(dmax) > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(Body<E, C, S>::kernel(),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Body<E, C, S>::smem(dmax));
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)B * T * C;
  for (int l = 0; l < L; ++l) {
    const float* xin = l == 0 ? x0 : xbuf + ((l - 1) % 2) * n;
    float* xout = xbuf + (l % 2) * n;
    // layers after the first may start (their cond and weight copies) while
    // the layer before them drains; layer 0 waits for the caller's kernels
    LayerLaunch<S> launch(T, B, Body<E, C, S>::threads(), Body<E, C, S>::smem(dil[l]), stream,
                          l > 0);
    err = Body<E, C, S>::launch(&launch.cfg, xin, xout, skip, step, cond, w_dil, b_dil, w_out,
                                b_out, B, T, l, dil[l]);
    if (err != cudaSuccess) return (int)err;
    ++*n_launched;
  }
  return (int)cudaSuccess;
}

// How many tiles of the float32 body at width C, split S ways, the card holds
// at once with dmax its largest dilation: clusters of S blocks
// (cudaOccupancyMaxActiveClusters), or blocks for S = 1; none where the
// instance's tiles do not fit a block at dmax.
template <int C, int S> int resident(int dmax, int* out) {
  typedef Body<float, C, S> Bd;
  const size_t smem = Bd::smem(dmax);
  if (smem > SMEM_LIMIT) {
    *out = 0;
    return (int)cudaSuccess;
  }
  cudaError_t err = cudaFuncSetAttribute(Bd::kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (S == 1) {
    int dev = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Bd::kernel(), Bd::threads(),
                                                          smem);
    *out = per_sm * sms;
    return (int)err;
  }
  LayerLaunch<S> launch(S, 1, Bd::threads(), smem, 0, false);
  return (int)cudaOccupancyMaxActiveClusters(out, Bd::kernel(), &launch.cfg);
}

}  // namespace tc

// ------------------------------------------------------- float32, SIMT body
constexpr int BM = 64;    // rows per block
constexpr int BNH = 32;   // columns per half (gate|filter, residual|skip)
constexpr int BK = 16;    // contraction slice staged in shared memory
constexpr int NT = 256;   // threads: 16 row groups x 16 column groups

// Kernel A: gated dilated conv of layer l -> g [B*T, C].
__global__ void __launch_bounds__(NT)
gate_kernel(const float* __restrict__ x, const float* __restrict__ step,
            const float* __restrict__ cond, const float* __restrict__ w_dil,
            const float* __restrict__ b_dil, float* __restrict__ g,
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
          v = x[((size_t)b * T + ts) * C + c] + step[((size_t)l * B + b) * C + c];
        }
      }
      As[kk][r] = v;
    }
#pragma unroll
    for (int q = 0; q < (BK * 2 * BNH) / NT; ++q) {
      const int e = tid + q * NT, kk = e / (2 * BNH), n = e % (2 * BNH);
      const int col = (n / BNH) * C + j0 + (n % BNH);
      Bs[kk][n] = w_dil[(((size_t)l * 3 + tap) * C + c0 + kk) * C2 + col];
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
      const float gate = acc[i][0][j] + b_dil[(size_t)l * C2 + col] + cond[crow + col];
      const float filt = acc[i][1][j] + b_dil[(size_t)l * C2 + C + col] + cond[crow + C + col];
      const float sig = 1.f / (1.f + expf(-gate));
      g[(size_t)R * C + col] = sig * tanhf(filt);
    }
  }
}

// Kernel B: out projection of layer l, residual update of x, skip sum.
__global__ void __launch_bounds__(NT)
out_kernel(float* __restrict__ x, float* __restrict__ skip, const float* __restrict__ g,
           const float* __restrict__ w_out, const float* __restrict__ b_out,
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
      As[kk][r] = R < BT ? g[(size_t)R * C + k0 + kk] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < (BK * 2 * BNH) / NT; ++q) {
      const int e = tid + q * NT, kk = e / (2 * BNH), n = e % (2 * BNH);
      const int col = (n / BNH) * C + j0 + (n % BNH);
      Bs[kk][n] = w_out[((size_t)l * C + k0 + kk) * C2 + col];
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

// x is updated in place, skip must start at zero, g is scratch [B*T, C].
int run_f32(float* x, float* skip, float* g, const float* step, const float* cond,
            const float* w_dil, const float* b_dil, const float* w_out,
            const float* b_out, int B, int T, int C, int L, const int* dil,
            cudaStream_t stream, int* n_launched) {
  if (C % BNH != 0 || C % BK != 0) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < L; ++l)
    if (dil[l] < 1) return (int)cudaErrorInvalidValue;
  const int BT = B * T;
  const dim3 grid((BT + BM - 1) / BM, C / BNH);
  for (int l = 0; l < L; ++l) {
    gate_kernel<<<grid, NT, 0, stream>>>(x, step, cond, w_dil, b_dil, g, B, T, C, l, dil[l]);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*n_launched;
    out_kernel<<<grid, NT, 0, stream>>>(x, skip, g, w_out, b_out, BT, C, l);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*n_launched;
  }
  return (int)cudaSuccess;
}

// The tensor-core bodies' rule: float32 or bfloat16 at C = 128 or 256,
// float32 also at C = 512, every dilation in [1, MAX_DIL].
bool tc_takes(int dtype, int C, int dmax) {
  return ((dtype == 1 && (C == 128 || C == 256)) ||
          (dtype == 0 && (C == 128 || C == 256 || C == 512))) &&
         dmax >= 1 && dmax <= tc::MAX_DIL;
}

// The shared memory of the widest float32 block a width runs at dmax: its
// smallest split whose tiles fit.
size_t tc32_smem(int C, int dmax) {
  if (C == 128) return tc::smem_bytes32<128>(dmax);
  if (C == 256) return tc::smem_bytes32<256>(dmax);
  const size_t two = tc::smem_bytes_wg<2>(dmax);
  return two <= tc::SMEM_LIMIT ? two : tc::smem_bytes_wg<4>(dmax);
}

}  // namespace

// What the tensor-core bodies take and how they would run it: returns 1 when
// they serve this type (0 float32, 1 bfloat16), width and largest dilation,
// and then fills out with the rows a block owns and the shared memory (bytes)
// a block takes at dmax; 0 otherwise.
extern "C" int diffnet_stack_tc_info(int dtype, int C, int dmax, int* out) {
  if (!tc_takes(dtype, C, dmax)) return 0;
  out[0] = tc::TM;
  if (dtype == 0)
    out[1] = (int)tc32_smem(C, dmax);
  else
    out[1] = (int)(C == 256 ? tc::smem_bytes<256>(dmax) : tc::smem_bytes<128>(dmax));
  return 1;
}

// How many tiles the float32 tensor-core body holds at once at width C,
// largest dilation dmax and column split `split` (out[0]: clusters of
// `split` blocks, blocks for split 1; 0 where its tiles do not fit a block
// at dmax): the wrapper's split rule reads it.
// Returns a cudaError_t code; cudaErrorInvalidValue for a shape or split the
// body does not take.
extern "C" int diffnet_stack_resident(int C, int dmax, int split, int* out) {
  out[0] = 0;
  if (!tc_takes(0, C, dmax) || !tc::split_takes(C, split)) return (int)cudaErrorInvalidValue;
  if (C == 256 && split == 1) return tc::resident<256, 1>(dmax, out);
  if (C == 256 && split == 2) return tc::resident<256, 2>(dmax, out);
  if (C == 256 && split == 4) return tc::resident<256, 4>(dmax, out);
  if (C == 128 && split == 1) return tc::resident<128, 1>(dmax, out);
  if (C == 512 && split == 2) return tc::resident<512, 2>(dmax, out);
  if (C == 512 && split == 4) return tc::resident<512, 4>(dmax, out);
  return (int)cudaErrorInvalidValue;
}

// path 1, the tensor-core bodies (dtype 0 float32 or 1 bfloat16 cond, w_dil
// and w_out; C = 128 or 256, float32 also 512; dilations up to MAX_DIL, and
// the split's tiles fit at the largest): x is x0, read only;
// skip needs no initial value; scratch is two [B,T,C] f32 buffers. split > 1
// (float32 only, split_takes) runs each 64-row tile on a cluster of that
// many blocks, each with C/split columns of each half.
// path 0, the SIMT body (dtype 0 only, C % 32 == 0, split 1): x [B,T,C] f32
// is updated in place, skip [B,T,C] f32 must start at zero, scratch is g
// [B*T, C] f32.
// A path or split that does not take the shape is refused, never swapped for
// another. report (three ints) is written by the code that ran: [0] the
// kernels it launched in this call, [1] which body it was (0 SIMT, 1 tensor
// cores), [2] the column split it ran. Returns a cudaError_t code.
extern "C" int diffnet_stack_run(int path, int dtype, int split, void* x, void* skip,
                                 void* scratch, const void* step, const void* cond,
                                 const void* w_dil, const void* b_dil,
                                 const void* w_out, const void* b_out,
                                 int B, int T, int C, int L, const int* dil,
                                 void* stream, int* report) {
  typedef __nv_bfloat16 bf16;
  cudaStream_t s = (cudaStream_t)stream;
  report[0] = 0;
  report[1] = -1;
  report[2] = 0;
  if (path == 1) {
    int dmax = 0;
    for (int l = 0; l < L; ++l) dmax = dil[l] > dmax ? dil[l] : dmax;
    if (!tc_takes(dtype, C, dmax) || !tc::split_takes(C, split) || (split > 1 && dtype != 0))
      return (int)cudaErrorInvalidValue;
    report[1] = dtype == 0 && C == 512 ? 2 : 1;
    report[2] = split;
#define STACK_TC(E, CH, S)                                                                  \
  return tc::run<E, CH, S>((const float*)x, (float*)scratch, (float*)skip,                  \
                           (const float*)step, (const E*)cond, (const E*)w_dil,             \
                           (const float*)b_dil, (const E*)w_out, (const float*)b_out, B, T, \
                           L, dil, s, report)
    if (dtype == 0 && C == 256 && split == 1) STACK_TC(float, 256, 1);
    if (dtype == 0 && C == 256 && split == 2) STACK_TC(float, 256, 2);
    if (dtype == 0 && C == 256 && split == 4) STACK_TC(float, 256, 4);
    if (dtype == 0 && C == 128 && split == 1) STACK_TC(float, 128, 1);
    if (dtype == 0 && C == 512 && split == 2) STACK_TC(float, 512, 2);
    if (dtype == 0 && C == 512 && split == 4) STACK_TC(float, 512, 4);
    if (dtype == 1 && C == 256) STACK_TC(bf16, 256, 1);
    if (dtype == 1 && C == 128) STACK_TC(bf16, 128, 1);
#undef STACK_TC
    return (int)cudaErrorInvalidValue;
  }
  if (path != 0 || dtype != 0 || split != 1) return (int)cudaErrorInvalidValue;
  report[1] = 0;
  report[2] = 1;
  return run_f32((float*)x, (float*)skip, (float*)scratch, (const float*)step,
                 (const float*)cond, (const float*)w_dil, (const float*)b_dil,
                 (const float*)w_out, (const float*)b_out, B, T, C, L, dil, s, report);
}

#ifdef STACK_PHASE_CLOCKS
// Copies the recorded clocks of the first n blocks ([n][6] int64) to the host.
extern "C" int diffnet_stack_read_clocks(long long* dst, int n) {
  if (n > tc::CLK_BLOCKS) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(dst, tc::g_clk, sizeof(long long) * n * tc::CLK_POINTS);
}
#endif
