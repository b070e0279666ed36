// Fused gated-resblock chains for one-pass vocoder synthesis at batch 1,
// Hopper (sm_90a), f32 in and out, products on the tensor cores.
//
// Replaces the three TPU kernels of vqvae_speech_tpu/ops/fused_resblock.py:
//   _chain_kernel_tiled (fused_block_chain_tiled)  -> fused_chain_tiled_f32
//   _chain_kernel_nc    (fused_block_chain_nc)     -> fused_chain_nc_f32
//   _chain_kernel       (fused_block_chain)        -> fused_chain_f32
// A chain is L gated resblocks over one stream x (T, C) with conditioning
// c (T, cin). For every layer l in order and every row t:
//
//   hf/hg = c[t] @ wfc/wgc[l] + bf/bg[l] + sum_j x[t + off(j,l)] @ wf/wg[l,j]
//   out   = tanh(hf) * sigmoid(hg)                                   (G)
//   skip[t] += out @ wskip[l] + bskip[l]                              (S)
//   x[t]  = (x[t] + out @ wres[l] + bres[l]) * sqrt(1/2)              (C)
//
// Causal chains read off = -(k-1-j) * d_l, non-causal ones
// off = (j - (k-1)/2) * d_l; a row outside [0, T) reads as zero at every
// layer (the per-layer zero padding of the convolutions).
//
// What bounds it on an H100: operations. A row of one layer costs
// 2*(k*C + cin)*2G + 2*G*(C + S) flops (0.61 MFLOP at the IAF student's
// k=3, C=128, G=256, S=128, cin=80; 3.6 MFLOP a 6-layer chain) against
// 4*(C + cin) bytes read and 4*(C + S) written once a chain: hundreds of
// flops a byte. Outside the tensor cores the card does 67 TFLOP/s in f32
// (NVIDIA's H100 SXM figure), 1.1 ms for a 20480-row student chain, and a
// scalar FMA loop reached 0.37 of that. So every product here runs on the
// tensor cores, by wgmma.mma_async.m64n128k8.f32.tf32.tf32.
//
// Error-compensated TF32. One TF32 product keeps 10 bits of each operand's
// mantissa, an error of the order of the chains' f32 tolerance after one
// layer. So each f32 operand is split into hi = tf32(a) and
// lo = tf32(a - hi), both rounded explicitly (cvt.rna; the hardware's own
// truncation of raw f32 bits would leave lo unable to compensate), and a
// product is three tensor-core products, A_hi B_lo and A_lo B_hi first,
// then A_hi B_hi, into one f32 accumulator: about 21 bits of each operand
// at a third of the TF32 rate (495 / 3 = 165 TFLOP/s of f32-equivalent
// work, 2.5x the rate outside the tensor cores).
//
// Operands. wgmma's TF32 form has no transposed operand: both must have the
// reduction index contiguous. The activations are the A operand: a thread
// reads its fragment from shared memory into registers and splits it
// there, so only one copy of A is staged. The weights are the B operand and
// are split AHEAD of time: prepare_chain_weights turns one chain's
// (L, k, C, G), (L, cin, G) and (L, G, C|S) arrays into
//   wgate_hi, wgate_lo (L, 2G, Kg)   rows [0, G) filter, [G, 2G) gate;
//                                    Kg = k*C8 + cin8, tap j at j*C8, the
//                                    conditioning at k*C8
//   wproj_hi, wproj_lo (L, C+S, G8)  rows [0, C) wres^T, [C, C+S) wskip^T
// (x8 = x rounded up to 8, the padding zero), once a weight set: 2 x 7.3 MB
// for a student chain (0.1 GB over the student's 7), 2 x 0.7 GB over
// FloWaveNet's 48 chains (the last block 2 x 23 MB a layer).
//
// One main loop (gemm_kernel). A block of two warpgroups owns a 128-row x
// 128-column output tile; each warpgroup owns 64 of the rows and both read
// the same weight tile, which halves the weight traffic from L2 against one
// warpgroup a block: a 64-row tile reads 2.4 MB of split student weights a
// layer for 117 MFLOP of TF32 work, 49 flops a byte where the card's
// tensor rate over its L2 rate is about 120. The reduction is cut into
// segments (a tap of x, the conditioning, or the gated output), each walked
// in 32-float chunks: one chunk is a 128-byte row of the 128-byte-swizzled
// layout wgmma reads, and four m64n128k8 steps of three products. Chunks
// reach shared memory by cp.async through a ring of 4 stages (18 KB of A,
// 2 x 16 KB of B a stage, 200 KB a block, so one block an SM): the loads
// of chunk i+2 are issued while chunk i is multiplied and the wgmma group
// of chunk i-1 drains (commit_group / wait_group 1); one block barrier a
// chunk. A copy outside [0, T) rows or past a segment's width is a
// cp.async of zero source bytes, which zero-fills: that is all the zero
// padding, window gathering and ragged-width handling there is, and causal
// and non-causal chains differ only in the offsets. TMA was left out: the
// tiles come from L2 (the weights of a layer are read by every row tile)
// and 12 cp.async a thread and chunk are not what the loop waits for.
//
// Around the loop, one C entry point enqueues a chain's launches on the
// caller's stream; the stream orders the layers, and each launch of the main
// loop is a programmatic dependent launch (its blocks may be scheduled
// during the tail of the launch before and wait there: 2% at T = 20480,
// 10-25% on the split path's short launches). Blocks on Hopper run in no
// order and a row tile is far smaller than the causal chain's 728-row
// history, so the TPU kernels' sequential grid with carried tails, and the
// halo windows of the non-causal one, do not carry over.
//  The row-tiled path, two launches a layer:
//  (1) gate: grid (row tiles, 64-column tiles of G). A block's 128 columns
//      are 64 filter and 64 gate columns of the same g, so tanh * sigmoid
//      is a register epilogue; the gated output goes to a (T, G) buffer.
//  (2) projection: grid (row tiles, 128-column tiles of [C | S]) over the
//      gated output, the residual and skip updates in the epilogue.
//      The gated tile is not kept in shared memory between the two: at 64 KB
//      a 64 rows it would hold a block to 64 rows a weight tile (L2-bound
//      at two fifths of the tensor rate) or to one 128-row block an SM with
//      a two-stage ring; through L2 it costs 2 x 21 MB a layer at T = 20480.
//  The split path, for chains whose row tiles cannot fill the card:
//  (0) one pre-pass for the conditioning product of ALL L layers, which does
//      not depend on x, tiled over rows, columns and splits of the cin
//      reduction, writing partial sums (FloWaveNet's late blocks have
//      T = 640 ... 80 rows against conditioning 1280 ... 10240 wide);
//  then per layer (1) the tap product split the same way, (2) glu_kernel:
//  bias + the partial sums in slice order, tanh * sigmoid, and (3) the
//  projection launch of the row-tiled path.
// x ping-pongs between the output buffer and one scratch buffer, ending in
// the output. Every output element is written by one thread in a fixed
// summation order: no atomics, results are bit-reproducible.
//
// Tiles and the tail. At T = 20480 a layer's gate launch is 160 x 4 = 640
// blocks on 132 SMs (4.85 waves, the last one 0.85 full), its projection
// 160 x 2 = 320 (2.4 waves): the tail costs about 3% and 20% of the two
// launches' time, 8% of a layer. T, C, G, S and cin need no multiple of a
// tile: rows past T and columns past G or C + S are zero-filled in shared
// memory and never stored.
//
// Where a block's time goes (scripts/profile_chain_kernel_cuda.py, H100,
// student width, T = 20480): a gate block takes 32 us, 23 of them its 15
// chunks (1.5 us a chunk; 1.2 with the loads left out, 1.0 with the
// products left out: the loop is bound by the 50 KB a chunk it pulls from
// L2, 5-6 TB/s over the card, before the tensor cores), 5 its epilogue
// (tanh and exp); a projection block 24 us, 11.5 its 8 chunks, 8 its
// epilogue, whose reads of x and skip meet every other block's in the
// same phase. A whole student chain runs at 170 TFLOP/s of TF32 work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // two warpgroups
constexpr int kBM = 128;                 // rows a block owns, 64 a warpgroup
constexpr int kBN = 128;                 // columns a block owns
constexpr int kBK = 32;                  // reduction floats a chunk
constexpr int kStages = 4;
// The tensor cores add into their f32 accumulator by truncation, an error
// that grows with the length of the chain of additions (measured on an
// H100: 2e-5 on unit-scale sums of 464 terms, four times the error of
// rounded f32 additions, and 1.4e-5 on a student chain against 3.6e-6 with
// the promotion). So after every kPromote chunks the accumulator is added
// into a running total with ordinary rounded f32 additions and started
// afresh (the next wgmma overwrites it). The wait this needs cost nothing
// measurable: the loop is bound by its loads. (-DCHAIN_PROMOTE=n is for
// scripts/profile_chain_kernel_cuda.py, which measures other intervals.)
#ifndef CHAIN_PROMOTE
#define CHAIN_PROMOTE 2
#endif
constexpr int kPromote = CHAIN_PROMOTE;
constexpr int kAStride = kBK + 4;        // floats; keeps fragment reads off bank conflicts
constexpr int kBBytes = kBN * kBK * 4;   // one of hi, lo
constexpr int kABytes = kBM * kAStride * 4;
constexpr int kStageBytes = 2 * kBBytes + kABytes;   // a multiple of 1024
constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + alignment slack
constexpr int kMaxTaps = 8;
constexpr int kMaxSegs = kMaxTaps + 1;
constexpr int kGluThreads = 256;
constexpr int kMaxDevices = 64;
constexpr float kSqrtHalf = 0.70710678118654752f;

static_assert(kStageBytes % 1024 == 0, "swizzled tiles need 1024-byte alignment");
static_assert(kSmemBytes <= 232448, "the ring must fit one Hopper block");

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int round_up(int a, int b) { return ceil_div(a, b) * b; }

__device__ __forceinline__ float sigmoidf_(float v) {
  return 1.f / (1.f + expf(-v));
}

// ---- PTX ----

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// hi = tf32(v) rounded to nearest (ties away), as a b32 pattern with the low
// 13 mantissa bits clear
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// The shared-memory descriptor of a K-major B tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), the leading
// offset unused (1), layout type 1 (B128). `addr` is 1024-byte aligned plus
// the 32 bytes a k8 step advances.
__device__ __forceinline__ uint64_t b_descriptor(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// d (64 x 128, f32) += a (64 x 8, tf32, this thread's register fragment) x
// b (128 x 8 K-major, tf32, shared memory); keep = 0 overwrites d instead
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t desc, int keep = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63},"
      "{%64,%65,%66,%67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(keep));
}

// ---- the main loop ----

// One segment of a product's reduction: rows src[t + off] (zero outside
// [0, T)) of `width` floats against the `width` rounded up to 8 reduction
// columns of B that start at kbase.
struct Seg {
  const float* src;
  int width;
  int off;
  int kbase;
  int vec;  // rows are 16-byte aligned: copy four floats at a time
};

enum Epilogue { kEpiGlu, kEpiPartial, kEpiProject, kEpiPlain };

// out tile = A @ B^T over the block's chunks. blockIdx.x: 128-row tile;
// blockIdx.y: column tile; blockIdx.z: layer * splits + split.
struct GemmArgs {
  Seg seg[kMaxSegs];
  int n_seg;
  int n_chunks;           // 32-float chunks over all segments
  int splits;             // the chunks are cut into this many runs ...
  int chunks_per_split;   // ... of this length
  const float* bhi;       // (layers, b_rows, ldb), hi and lo parts
  const float* blo;
  int ldb;
  int b_rows;
  int T;
  int G;                  // gate epilogues: the tile is 64 filter | 64 gate columns
  // kEpiGlu: gated[t, g] = tanh(f + bf[g]) * sigmoid(h + bg[g])
  const float* bf;
  const float* bg;
  float* gated;
  // kEpiPartial: part[z, t, :] = [f | h], raw sums
  float* part;
  // kEpiProject: columns [0, C) update x, [C, C + S) update skip
  const float* x_in;
  const float* bres;
  const float* bskip;
  float* x_out;
  float* skip;
  int C, S, first;
  // kEpiPlain: out[t, n] = the product, n < b_rows
  float* out;
};

// Stage `stage` <- chunk (seg s, floats [k0, k0 + 32)) of A and of both
// parts of B, as cp.async copies; a copy that is out of range reads zero
// bytes and zero-fills.
__device__ __forceinline__ void load_chunk(const GemmArgs& a, const float* bhi,
                                           const float* blo, uint32_t stage,
                                           int s, int k0, int t0, int n0,
                                           int n1, int lim0, int lim1) {
  const int tid = threadIdx.x;
  const int piece = tid % 8;
  const Seg seg = a.seg[s];
  const int width8 = round_up(seg.width, 8);
  const int kp = k0 + piece * 4;
  // B: 128 rows x 8 pieces of 16 bytes, hi and lo; piece p of row n lands
  // at chunk p ^ (n % 8) of the row (the 128-byte swizzle)
#pragma unroll
  for (int i = 0; i < kBN / 32; ++i) {
    const int nrow = tid / 8 + 32 * i;
    const int row = nrow < 64 ? n0 + nrow : n1 + nrow - 64;
    const bool ok = row < (nrow < 64 ? lim0 : lim1) && kp < width8;
    const size_t at = ok ? static_cast<size_t>(row) * a.ldb + seg.kbase + kp : 0;
    const uint32_t dst = stage + nrow * 128 + ((piece ^ (nrow & 7)) << 4);
    cp_async_16(dst, bhi + at, ok);
    cp_async_16(dst + kBBytes, blo + at, ok);
  }
  // A: 128 rows x 8 pieces
  const uint32_t a_s = stage + 2 * kBBytes;
#pragma unroll
  for (int i = 0; i < kBM / 32; ++i) {
    const int row = tid / 8 + 32 * i;
    const int t = t0 + row;
    const int ts = t + seg.off;
    const bool row_ok = t < a.T && ts >= 0 && ts < a.T;
    const float* src = seg.src + (row_ok ? static_cast<size_t>(ts) * seg.width : 0);
    const uint32_t dst = a_s + (row * kAStride + piece * 4) * 4;
    if (seg.vec) {
      const bool ok = row_ok && kp < seg.width;
      cp_async_16(dst, src + (ok ? kp : 0), ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = row_ok && kp + e < seg.width;
        cp_async_4(dst + 4 * e, src + (ok ? kp + e : 0), ok);
      }
    }
  }
}

// The products of one staged chunk for this warpgroup's 64 rows: four k8
// steps, each A_hi B_lo, A_lo B_hi, A_hi B_hi into acc, committed as one
// wgmma group. The fragment registers are this call's own, so that the
// caller can leave one group in flight.
__device__ __forceinline__ void mma_chunk(float (&acc)[64], uint32_t stage,
                                          const float* a_s, bool fresh) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int wg = threadIdx.x / 128;
  const int r = wg * 64 + warp * 16 + lane / 4, c = lane % 4;
  uint32_t hi[kBK / 8][4], lo[kBK / 8][4];
#pragma unroll
  for (int s = 0; s < kBK / 8; ++s) {
    // the m64k8 fragment: rows r and r + 8, reduction columns c and c + 4
    split_tf32(a_s[r * kAStride + 8 * s + c], hi[s][0], lo[s][0]);
    split_tf32(a_s[(r + 8) * kAStride + 8 * s + c], hi[s][1], lo[s][1]);
    split_tf32(a_s[r * kAStride + 8 * s + c + 4], hi[s][2], lo[s][2]);
    split_tf32(a_s[(r + 8) * kAStride + 8 * s + c + 4], hi[s][3], lo[s][3]);
  }
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < kBK / 8; ++s) {
    const uint64_t d_hi = b_descriptor(stage + 32 * s);
    const uint64_t d_lo = b_descriptor(stage + kBBytes + 32 * s);
#ifndef CHAIN_NO_PRODUCTS
    wgmma_m64n128k8(acc, hi[s], d_lo, (s > 0 || !fresh) ? 1 : 0);
    wgmma_m64n128k8(acc, lo[s], d_hi);
    wgmma_m64n128k8(acc, hi[s], d_hi);
#else   // keep the fragment loads and splits alive
    acc[s] += __uint_as_float(hi[s][0] ^ hi[s][1] ^ hi[s][2] ^ hi[s][3] ^
                              lo[s][0] ^ lo[s][1] ^ lo[s][2] ^ lo[s][3]) +
              static_cast<float>(d_hi ^ d_lo);
#endif
  }
  wgmma_commit();
}

// Measurement builds only (scripts/profile_chain_kernel.py compiles them
// into a library of their own). CHAIN_STAMPS: thread 0 of every block
// records the global timer at entry, after the first loads are issued, when
// the first chunk has landed, after the main loop and after the epilogue,
// and its SM. CHAIN_NO_LOADS / CHAIN_NO_PRODUCTS leave the ring's refills
// or the wgmma instructions out, for the time of the other side alone:
// their results are wrong.
#ifdef CHAIN_STAMPS
constexpr int kStampBlocks = 8192, kStampFields = 6;
__device__ unsigned long long g_stamps[4 * kStampBlocks * kStampFields];
#define CHAIN_STAMP(epi, field)                                              \
  if (threadIdx.x == 0) {                                                    \
    const int b_ = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z); \
    unsigned long long v_;                                                   \
    if ((field) == 5) { unsigned sm_; asm("mov.u32 %0, %%smid;" : "=r"(sm_)); v_ = sm_; } \
    else asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v_));              \
    if (b_ < kStampBlocks) g_stamps[((epi) * kStampBlocks + b_) * kStampFields + (field)] = v_; \
  }
#else
#define CHAIN_STAMP(epi, field)
#endif

// The loader's position in the reduction: the segment and the offset in it
// of the next chunk to load.
struct ChunkCursor {
  int seg, k0;
  __device__ __forceinline__ void advance(const GemmArgs& a) {
    k0 += kBK;
    if (k0 >= round_up(a.seg[seg].width, 8)) { ++seg; k0 = 0; }
  }
};

template <int EPI>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const __grid_constant__ GemmArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t ring = (raw + 1023) & ~1023u;   // shared-window address
  const unsigned char* ring_ptr = smem_raw + (ring - raw);

  const int tid = threadIdx.x;
  CHAIN_STAMP(EPI, 0)
  CHAIN_STAMP(EPI, 5)
  const int t0 = blockIdx.x * kBM;
  const int layer = blockIdx.z / a.splits, split = blockIdx.z % a.splits;
  constexpr bool kGate = EPI == kEpiGlu || EPI == kEpiPartial;
  // the tile's 128 columns as two runs of 64 rows of B
  const int n0 = blockIdx.y * (kGate ? 64 : kBN);
  const int n1 = kGate ? a.G + n0 : n0 + 64;
  const int lim0 = kGate ? a.G : a.b_rows;
  const int lim1 = kGate ? 2 * a.G : a.b_rows;
  const size_t b_layer = static_cast<size_t>(layer) * a.b_rows * a.ldb;
  const float* bhi = a.bhi + b_layer;
  const float* blo = a.blo + b_layer;

  const int c_begin = split * a.chunks_per_split;
  const int n = max(min(a.n_chunks, c_begin + a.chunks_per_split) - c_begin, 0);
  ChunkCursor cur = {0, 0};
  for (int i = 0; i < c_begin; ++i) cur.advance(a);
  // Programmatic dependent launch: the next launch on the stream may be
  // scheduled onto SMs that this one's tail leaves idle, and this block
  // touches no memory before everything earlier on the stream is complete
  // and visible.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  // acc is the tensor cores' accumulator, sum the running total: see
  // kPromote. 226-234 registers a thread, no spills.
  float acc[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = sum[i] = 0.f;

  // Chunks i and i + 1 are in flight when chunk i is awaited. Chunk i + 2
  // goes into the stage of chunk i - 2, whose wgmma group every thread saw
  // complete (wait_group 1 of iteration i - 1) before this iteration's
  // barrier. The loop is unrolled by two so that the fragment registers of
  // a group still in flight are not the ones being refilled.
  for (int p = 0; p < 2; ++p) {
    if (p < n) {
      load_chunk(a, bhi, blo, ring + p * kStageBytes, cur.seg, cur.k0, t0, n0,
                 n1, lim0, lim1);
      cur.advance(a);
    }
    cp_async_commit();
  }
  CHAIN_STAMP(EPI, 1)
#pragma unroll 1
  for (int i0 = 0; i0 < n; i0 += 2) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = i0 + u;
      if (i < n) {
        cp_async_wait<1>();
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        if (i == 0) { CHAIN_STAMP(EPI, 2) }
        const int slot = i % kStages;
        mma_chunk(acc, ring + slot * kStageBytes,
                  reinterpret_cast<const float*>(ring_ptr + slot * kStageBytes +
                                                 2 * kBBytes),
                  i % kPromote == 0);
        // the products are queued before the next loads' address arithmetic
        // (measured 5% faster than loads first)
#ifndef CHAIN_NO_LOADS
        if (i + 2 < n) {
          load_chunk(a, bhi, blo, ring + ((i + 2) % kStages) * kStageBytes,
                     cur.seg, cur.k0, t0, n0, n1, lim0, lim1);
          cur.advance(a);
        }
#endif
        cp_async_commit();
        if (i % kPromote == kPromote - 1 || i == n - 1) {
          wgmma_wait<0>();
#pragma unroll
          for (int e = 0; e < 64; ++e) sum[e] += acc[e];
        } else {
          wgmma_wait<1>();
        }
      }
    }
  }

  CHAIN_STAMP(EPI, 3)
  // sum[4 j + 2 h + e] is row r + 8 h, tile column 8 j + 2 c + e
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int r = t0 + (tid / 128) * 64 + warp * 16 + lane / 4, c = lane % 4;
  if (EPI == kEpiGlu || EPI == kEpiPartial) {
    float* part = nullptr;
    if (EPI == kEpiPartial)
      part = a.part + static_cast<size_t>(blockIdx.z) * a.T * 2 * a.G;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + 8 * j + 2 * c;
      if (col >= a.G) continue;
      float2 bf = make_float2(0.f, 0.f), bg = bf;
      if (EPI == kEpiGlu) {
        bf = *reinterpret_cast<const float2*>(a.bf + col);
        bg = *reinterpret_cast<const float2*>(a.bg + col);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = r + 8 * h;
        if (t >= a.T) continue;
        const float f0 = sum[4 * j + 2 * h], f1 = sum[4 * j + 2 * h + 1];
        const float g0 = sum[32 + 4 * j + 2 * h], g1 = sum[32 + 4 * j + 2 * h + 1];
        if (EPI == kEpiGlu) {
          *reinterpret_cast<float2*>(a.gated + static_cast<size_t>(t) * a.G + col) =
              make_float2(tanhf(f0 + bf.x) * sigmoidf_(g0 + bg.x),
                          tanhf(f1 + bf.y) * sigmoidf_(g1 + bg.y));
        } else {
          float* row = part + static_cast<size_t>(t) * 2 * a.G + col;
          *reinterpret_cast<float2*>(row) = make_float2(f0, f1);
          *reinterpret_cast<float2*>(row + a.G) = make_float2(g0, g1);
        }
      }
    }
  } else if (EPI == kEpiPlain) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * c;
      if (col >= a.b_rows) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = r + 8 * h;
        if (t >= a.T) continue;
        float* o = a.out + static_cast<size_t>(t) * a.b_rows + col;
        o[0] = sum[4 * j + 2 * h];
        if (col + 1 < a.b_rows) o[1] = sum[4 * j + 2 * h + 1];
      }
    }
  } else {
    // The residual and skip updates read what they add to. All the reads
    // go out before the first store: the compiler cannot tell that x_in,
    // x_out and skip do not overlap, and a load behind every store is one
    // L2 round trip after another (measured: 12.5 us of a 25.7 us block).
    float2 old[32];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * c;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = r + 8 * h;
        old[2 * j + h] = make_float2(0.f, 0.f);
        if (col >= a.b_rows || t >= a.T) continue;
        if (col < a.C)
          old[2 * j + h] = *reinterpret_cast<const float2*>(
              a.x_in + static_cast<size_t>(t) * a.C + col);
        else if (!a.first)
          old[2 * j + h] = *reinterpret_cast<const float2*>(
              a.skip + static_cast<size_t>(t) * a.S + col - a.C);
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * c;
      if (col >= a.b_rows) continue;
      const bool res = col < a.C;
      const float2 b = *reinterpret_cast<const float2*>(
          res ? a.bres + col : a.bskip + col - a.C);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = r + 8 * h;
        if (t >= a.T) continue;
        const float2 o = old[2 * j + h];
        const float vx = sum[4 * j + 2 * h] + b.x;
        const float vy = sum[4 * j + 2 * h + 1] + b.y;
        if (res)
          *reinterpret_cast<float2*>(a.x_out + static_cast<size_t>(t) * a.C +
                                     col) =
              make_float2((o.x + vx) * kSqrtHalf, (o.y + vy) * kSqrtHalf);
        else
          *reinterpret_cast<float2*>(a.skip + static_cast<size_t>(t) * a.S +
                                     col - a.C) =
              make_float2(o.x + vx, o.y + vy);
      }
    }
  }
  CHAIN_STAMP(EPI, 4)
}

// out[t, g] = tanh(hf) * sigmoid(hg), hf/hg = bias + the conditioning's
// partial sums + the taps' partial sums, each in slice order.
__global__ void __launch_bounds__(kGluThreads)
glu_kernel(const float* cpart, int c_splits, const float* gpart, int g_splits,
           const float* bf, const float* bg, float* out, int T, int G) {
  const int g4 = G / 4;
  const int idx = blockIdx.x * kGluThreads + threadIdx.x;
  if (idx >= T * g4) return;
  const int t = idx / g4, g = (idx - t * g4) * 4;
  float4 f = *reinterpret_cast<const float4*>(bf + g);
  float4 h = *reinterpret_cast<const float4*>(bg + g);
  const size_t at = static_cast<size_t>(t) * 2 * G + g;
  const size_t step = static_cast<size_t>(T) * 2 * G;
  auto add = [](float4& s, const float4 v) {
    s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
  };
  for (int s = 0; s < c_splits; ++s) {
    add(f, __ldg(reinterpret_cast<const float4*>(cpart + s * step + at)));
    add(h, __ldg(reinterpret_cast<const float4*>(cpart + s * step + at + G)));
  }
  for (int s = 0; s < g_splits; ++s) {
    add(f, __ldg(reinterpret_cast<const float4*>(gpart + s * step + at)));
    add(h, __ldg(reinterpret_cast<const float4*>(gpart + s * step + at + G)));
  }
  *reinterpret_cast<float4*>(out + static_cast<size_t>(t) * G + g) =
      make_float4(tanhf(f.x) * sigmoidf_(h.x), tanhf(f.y) * sigmoidf_(h.y),
                  tanhf(f.z) * sigmoidf_(h.z), tanhf(f.w) * sigmoidf_(h.w));
}

// ---- the weights' prepared form ----

// hi/lo[l, n, kk] of the gate matrix: row n < G is filter column n, row
// G + n gate column n; kk walks tap j's C channels at j * C8, then the
// conditioning's cin at k * C8; the padding is zero. Threads run along n,
// the sources' contiguous index.
__global__ void __launch_bounds__(256)
prepare_gate_kernel(const float* wf, const float* wg, const float* wfc,
                    const float* wgc, float* hi, float* lo, int L, int k, int C,
                    int G, int cin) {
  const int C8 = round_up(C, 8), Kg = k * C8 + round_up(cin, 8);
  const size_t total = static_cast<size_t>(L) * Kg * 2 * G;
  const size_t idx = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
  if (idx >= total) return;
  const int n = idx % (2 * G);
  const int kk = (idx / (2 * G)) % Kg;
  const int l = idx / (static_cast<size_t>(2 * G) * Kg);
  const bool gate = n >= G;
  const int col = gate ? n - G : n;
  float v = 0.f;
  if (kk < k * C8) {
    const int j = kk / C8, ch = kk % C8;
    if (ch < C)
      v = (gate ? wg : wf)[((static_cast<size_t>(l) * k + j) * C + ch) * G + col];
  } else if (kk - k * C8 < cin) {
    v = (gate ? wgc : wfc)[(static_cast<size_t>(l) * cin + kk - k * C8) * G + col];
  }
  uint32_t h, w;
  split_tf32(v, h, w);
  const size_t at = (static_cast<size_t>(l) * 2 * G + n) * Kg + kk;
  hi[at] = __uint_as_float(h);
  lo[at] = __uint_as_float(w);
}

// hi/lo[l, n, g] of the projection matrix: row n < C is wres[l, :, n], row
// C + n is wskip[l, :, n]; g >= G is zero.
__global__ void __launch_bounds__(256)
prepare_proj_kernel(const float* wres, const float* wskip, float* hi, float* lo,
                    int L, int C, int G, int S) {
  const int G8 = round_up(G, 8), N = C + S;
  const size_t total = static_cast<size_t>(L) * G8 * N;
  const size_t idx = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
  if (idx >= total) return;
  const int n = idx % N;
  const int g = (idx / N) % G8;
  const int l = idx / (static_cast<size_t>(N) * G8);
  float v = 0.f;
  if (g < G)
    v = n < C ? wres[(static_cast<size_t>(l) * G + g) * C + n]
              : wskip[(static_cast<size_t>(l) * G + g) * S + n - C];
  uint32_t h, w;
  split_tf32(v, h, w);
  const size_t at = (static_cast<size_t>(l) * N + n) * G8 + g;
  hi[at] = __uint_as_float(h);
  lo[at] = __uint_as_float(w);
}

// ---- host side ----

int chunks_of(int width) { return ceil_div(round_up(width, 8), kBK); }

bool rows_aligned(const float* p, int width) {
  return width % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int EPI>
cudaError_t launch_gemm(const GemmArgs& a, dim3 grid, cudaStream_t s) {
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  // the shared-memory opt-in is per kernel and device: asked for once each
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices || !allowed[dev]) {
    err = cudaFuncSetAttribute(gemm_kernel<EPI>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return err;
    if (dev >= 0 && dev < kMaxDevices) allowed[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, gemm_kernel<EPI>, a);
}

struct ChainArgs {
  const float* x;
  const float* c;
  const float* wgate_hi;  // the prepared form, see prepare_chain_weights
  const float* wgate_lo;
  const float* wproj_hi;
  const float* wproj_lo;
  const float* bf;
  const float* bg;
  const float* bres;
  const float* bskip;
  int T, C, G, S, cin, L, k;
  float* x_out;
  float* skip;
  float* scratch;  // chain_scratch_floats() floats
  int path;        // 0, or a path forced for tests and measurements
};

constexpr int kPathRows = 1, kPathSplit = 2;  // 0: the shapes decide

// How the split path cuts a chain: the reduction splits of the conditioning
// pre-pass and of a layer's tap product, chosen so that each launch has
// about two blocks an SM and no split is under a few chunks. A function of
// the shapes and the SM count alone.
struct SplitPlan {
  int c_splits, c_chunks;  // pre-pass: splits, chunks a split
  int g_splits, g_chunks;  // tap product of one layer
};

SplitPlan split_plan(int T, int C, int G, int cin, int L, int k, int sms) {
  const int tiles = ceil_div(T, kBM) * ceil_div(G, 64);
  auto cut = [&](int n_tiles, int n_chunks, int min_chunks, int* splits,
                 int* chunks) {
    int want = ceil_div(2 * sms, n_tiles);
    const int most = n_chunks / min_chunks > 1 ? n_chunks / min_chunks : 1;
    if (want > most) want = most;
    *chunks = ceil_div(n_chunks, want);
    *splits = ceil_div(n_chunks, *chunks);
  };
  SplitPlan p;
  cut(tiles * L, chunks_of(cin), 4, &p.c_splits, &p.c_chunks);
  cut(tiles, k * chunks_of(C), 2, &p.g_splits, &p.g_chunks);
  return p;
}

// The split path serves chains whose gate launch on the row-tiled path
// would have under half a block an SM (at G = 256 on 132 SMs: T <= 2048).
// Measured on an H100 with both paths forced (chip_smoke.py, ms): the
// row-tiled path is faster at 80 blocks and more (FloWaveNet's blocks 0 and
// 2, T = 10240 and 2560: 0.46-0.51 and 0.23-0.25 against 0.52-0.63 and
// 0.27-0.29; block 1 ties at 0.33-0.36; the student's T = 20480, 5119 and
// 4096: 1.32-1.42, 0.53-0.57 and 0.37-0.39 against 1.62-1.71, 0.59 and
// 0.54-0.61), the split path at 40 and fewer (blocks 3-7, T = 1280 ... 80:
// 0.22-0.25, 0.19-0.22, 0.19-0.22, 0.17-0.23, 0.20-0.25 against 0.25-0.28,
// 0.30-0.31, 0.43-0.48, 0.67-0.76, 1.15-1.28), where the conditioning is
// also the wider part of the reduction. A rule of the shapes and the SM
// count alone, so results are a function of the inputs.
bool takes_split_path(int T, int G, int sms, int path) {
  if (path == kPathRows) return false;
  if (path == kPathSplit) return true;
  return 2 * ceil_div(T, kBM) * ceil_div(G, 64) < sms;
}

int device_sms(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(err);
}

// Floats of scratch a chain needs: the (T, C) buffer x ping-pongs through,
// the gated output (T, G) and, on the split path, the partial sums of the
// pre-pass (L, c_splits, T, 2G) and of one layer's tap product (g_splits,
// T, 2G).
size_t chain_scratch_floats(int T, int C, int G, int cin, int L, int k, int sms,
                            int path) {
  size_t n = static_cast<size_t>(T) * C + static_cast<size_t>(T) * G;
  if (takes_split_path(T, G, sms, path)) {
    const SplitPlan p = split_plan(T, C, G, cin, L, k, sms);
    n += static_cast<size_t>(L) * p.c_splits * T * 2 * G +
         static_cast<size_t>(p.g_splits) * T * 2 * G;
  }
  return n;
}

// The gate product's arguments for layer l (l < 0: every layer, for the
// pre-pass): the taps of x_in when `taps`, the conditioning when `cond`.
GemmArgs gate_args(const ChainArgs& c, const int* offsets, int l,
                   const float* x_in, bool taps, bool cond) {
  GemmArgs a = {};
  const int C8 = round_up(c.C, 8);
  int n = 0, chunks = 0;
  if (taps) {
    for (int j = 0; j < c.k; ++j) {
      a.seg[n++] = Seg{x_in, c.C, offsets[l * c.k + j], j * C8,
                       rows_aligned(x_in, c.C)};
      chunks += chunks_of(c.C);
    }
  }
  if (cond) {
    a.seg[n++] = Seg{c.c, c.cin, 0, c.k * C8, rows_aligned(c.c, c.cin)};
    chunks += chunks_of(c.cin);
  }
  a.n_seg = n;
  a.n_chunks = chunks;
  a.splits = 1;
  a.chunks_per_split = chunks;
  a.ldb = c.k * C8 + round_up(c.cin, 8);
  a.b_rows = 2 * c.G;
  const size_t at = l < 0 ? 0 : static_cast<size_t>(l) * a.b_rows * a.ldb;
  a.bhi = c.wgate_hi + at;
  a.blo = c.wgate_lo + at;
  a.T = c.T;
  a.G = c.G;
  return a;
}

// The projection launch of layer l: the gated output against [wres | wskip],
// the residual and skip updates in the epilogue. Returns the layer's output
// buffer in *x_next.
cudaError_t launch_projection(const ChainArgs& c, int l, const float* x_in,
                              float* gated, cudaStream_t s,
                              const float** x_next) {
  GemmArgs a = {};
  a.seg[0] = Seg{gated, c.G, 0, 0, rows_aligned(gated, c.G)};
  a.n_seg = 1;
  a.n_chunks = a.chunks_per_split = chunks_of(c.G);
  a.splits = 1;
  a.ldb = round_up(c.G, 8);
  a.b_rows = c.C + c.S;
  const size_t at = static_cast<size_t>(l) * a.b_rows * a.ldb;
  a.bhi = c.wproj_hi + at;
  a.blo = c.wproj_lo + at;
  a.T = c.T;
  a.x_in = x_in;
  a.bres = c.bres + static_cast<size_t>(l) * c.C;
  a.bskip = c.bskip + static_cast<size_t>(l) * c.S;
  // ping-pong so that the last layer writes x_out
  a.x_out = ((c.L - 1 - l) % 2 == 0) ? c.x_out : c.scratch;
  a.skip = c.skip;
  a.C = c.C;
  a.S = c.S;
  a.first = (l == 0);
  *x_next = a.x_out;
  return launch_gemm<kEpiProject>(
      a, dim3(ceil_div(c.T, kBM), ceil_div(c.C + c.S, kBN)), s);
}

// The split path: one pre-pass for every layer's conditioning product, then
// per layer the tap product, the GLU and the projection, all on `s`.
int launch_chain_split(const ChainArgs& c, const int* offsets, int sms,
                       cudaStream_t s) {
  const SplitPlan p = split_plan(c.T, c.C, c.G, c.cin, c.L, c.k, sms);
  const size_t layer_part = static_cast<size_t>(c.T) * 2 * c.G;
  float* gated = c.scratch + static_cast<size_t>(c.T) * c.C;
  float* cpart = gated + static_cast<size_t>(c.T) * c.G;
  float* gpart = cpart + static_cast<size_t>(c.L) * p.c_splits * layer_part;
  const int row_tiles = ceil_div(c.T, kBM), col_tiles = ceil_div(c.G, 64);
  if (static_cast<int64_t>(c.L) * p.c_splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);

  GemmArgs pre = gate_args(c, offsets, -1, nullptr, false, true);
  pre.splits = p.c_splits;
  pre.chunks_per_split = p.c_chunks;
  pre.part = cpart;
  cudaError_t err = launch_gemm<kEpiPartial>(
      pre, dim3(row_tiles, col_tiles, c.L * p.c_splits), s);
  if (err != cudaSuccess) return static_cast<int>(err);

  const float* x_in = c.x;
  for (int l = 0; l < c.L; ++l) {
    GemmArgs taps = gate_args(c, offsets, l, x_in, true, false);
    taps.splits = p.g_splits;
    taps.chunks_per_split = p.g_chunks;
    taps.part = gpart;
    err = launch_gemm<kEpiPartial>(taps, dim3(row_tiles, col_tiles, p.g_splits),
                                   s);
    if (err != cudaSuccess) return static_cast<int>(err);
    glu_kernel<<<ceil_div(c.T * (c.G / 4), kGluThreads), kGluThreads, 0, s>>>(
        cpart + static_cast<size_t>(l) * p.c_splits * layer_part, p.c_splits,
        gpart, p.g_splits, c.bf + static_cast<size_t>(l) * c.G,
        c.bg + static_cast<size_t>(l) * c.G, gated, c.T, c.G);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch_projection(c, l, x_in, gated, s, &x_in);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// offsets: L * k row offsets, layer-major. On the row-tiled path two
// launches a layer on `s`; chains of few rows take the split path.
int launch_chain(const ChainArgs& c, const int* offsets, cudaStream_t s) {
  if (c.k < 1 || c.k > kMaxTaps || c.L < 1 || c.T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const int dev_err = device_sms(&sms);
  if (dev_err != 0) return dev_err;
  if (takes_split_path(c.T, c.G, sms, c.path))
    return launch_chain_split(c, offsets, sms, s);
  float* gated = c.scratch + static_cast<size_t>(c.T) * c.C;
  const float* x_in = c.x;
  for (int l = 0; l < c.L; ++l) {
    GemmArgs gate = gate_args(c, offsets, l, x_in, true, true);
    gate.bf = c.bf + static_cast<size_t>(l) * c.G;
    gate.bg = c.bg + static_cast<size_t>(l) * c.G;
    gate.gated = gated;
    cudaError_t err = launch_gemm<kEpiGlu>(
        gate, dim3(ceil_div(c.T, kBM), ceil_div(c.G, 64)), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch_projection(c, l, x_in, gated, s, &x_in);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

constexpr int kMaxLayers = 64;

// Causal chain with dilation k**l at layer l (the ClariNet convention).
int launch_causal(const ChainArgs& c, cudaStream_t s) {
  if (c.L > kMaxLayers || c.k > kMaxTaps)
    return static_cast<int>(cudaErrorInvalidValue);
  int offsets[kMaxLayers * kMaxTaps];
  int64_t d = 1;
  for (int l = 0; l < c.L; ++l) {
    if ((c.k - 1) * d > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
    for (int j = 0; j < c.k; ++j)
      offsets[l * c.k + j] = -static_cast<int>((c.k - 1 - j) * d);
    d *= c.k;
  }
  return launch_chain(c, offsets, s);
}

}  // namespace

// Floats of scratch a chain of these shapes needs on the current device
// (into *floats), and whether it takes the split path (into *split);
// `path` 0 lets the shapes decide, 1 forces the row-tiled path, 2 the
// split path. Returns 0 or a cudaError_t.
extern "C" int fused_chain_scratch_floats(int T, int C, int G, int cin, int L,
                                          int k, int path, size_t* floats,
                                          int* split) {
  int sms = 0;
  const int err = device_sms(&sms);
  if (err != 0) return err;
  *floats = chain_scratch_floats(T, C, G, cin, L, k, sms, path);
  *split = takes_split_path(T, G, sms, path) ? 1 : 0;
  return 0;
}

// Split and transpose one chain's weights (the layout of
// ops.fused_resblock.stack_block_weights) into the prepared form
// (wgate_* of L * 2G * (k*C8 + cin8) floats, wproj_* of L * (C+S) * G8), on
// `stream`. Returns 0 or a cudaError_t.
extern "C" int fused_chain_prepare_f32(const float* wf, const float* wg,
                                       const float* wfc, const float* wgc,
                                       const float* wres, const float* wskip,
                                       int C, int G, int S, int cin, int L,
                                       int k, float* wgate_hi, float* wgate_lo,
                                       float* wproj_hi, float* wproj_lo,
                                       void* stream) {
  const size_t gate = static_cast<size_t>(L) * 2 * G *
                      (k * round_up(C, 8) + round_up(cin, 8));
  const size_t proj = static_cast<size_t>(L) * (C + S) * round_up(G, 8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  prepare_gate_kernel<<<static_cast<unsigned>((gate + 255) / 256), 256, 0, s>>>(
      wf, wg, wfc, wgc, wgate_hi, wgate_lo, L, k, C, G, cin);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  prepare_proj_kernel<<<static_cast<unsigned>((proj + 255) / 256), 256, 0, s>>>(
      wres, wskip, wproj_hi, wproj_lo, L, C, G, S);
  return static_cast<int>(cudaGetLastError());
}

// out (M, N) = a (M, K) @ b^T, b given as its split parts b_hi, b_lo (N, K8)
// with K8 = K rounded up to 8: the main loop alone, for checks against a
// library product. Returns 0 or a cudaError_t.
extern "C" int fused_chain_matmul_f32(const float* a, const float* b_hi,
                                      const float* b_lo, int M, int N, int K,
                                      float* out, void* stream) {
  GemmArgs g = {};
  g.seg[0] = Seg{a, K, 0, 0, rows_aligned(a, K)};
  g.n_seg = 1;
  g.n_chunks = g.chunks_per_split = chunks_of(K);
  g.splits = 1;
  g.bhi = b_hi;
  g.blo = b_lo;
  g.ldb = round_up(K, 8);
  g.b_rows = N;
  g.T = M;
  g.out = out;
  return static_cast<int>(launch_gemm<kEpiPlain>(
      g, dim3(ceil_div(M, kBM), ceil_div(N, kBN)),
      static_cast<cudaStream_t>(stream)));
}

#ifdef CHAIN_STAMPS
// Copy out the stamps of the last launch of each epilogue kind:
// (4 kinds, 8192 blocks, 6 fields) unsigned 64-bit values.
extern "C" int fused_chain_read_stamps(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps)));
}
#endif

#define CHAIN_PARAMS                                                          \
  const float *x, const float *c, const float *wgate_hi,                      \
      const float *wgate_lo, const float *wproj_hi, const float *wproj_lo,    \
      const float *bf, const float *bg, const float *bres,                    \
      const float *bskip, int T, int C, int G, int S, int cin, int L, int k,  \
      int path
#define CHAIN_ARGS                                                            \
  ChainArgs { x, c, wgate_hi, wgate_lo, wproj_hi, wproj_lo, bf, bg, bres,     \
              bskip, T, C, G, S, cin, L, k, x_out, skip, scratch, path }

// Each entry point runs a whole chain on `stream`, on the prepared weights
// of fused_chain_prepare_f32, and returns cudaGetLastError() of the first
// launch that failed, or 0. Needs C, G, S multiples of 4, 16-byte aligned
// x, weights, biases and outputs, k <= 8, L <= 64, and
// fused_chain_scratch_floats() floats of scratch for the same `path`.

// The causal chain as the IAF student serves it (TPU: _chain_kernel_tiled).
extern "C" int fused_chain_tiled_f32(CHAIN_PARAMS, float* x_out, float* skip,
                                     float* scratch, void* stream) {
  return launch_causal(CHAIN_ARGS, static_cast<cudaStream_t>(stream));
}

// The causal chain over the whole T (TPU: _chain_kernel, one resident tile).
extern "C" int fused_chain_f32(CHAIN_PARAMS, float* x_out, float* skip,
                               float* scratch, void* stream) {
  return launch_causal(CHAIN_ARGS, static_cast<cudaStream_t>(stream));
}

// The non-causal chain with L dilations given (TPU: _chain_kernel_nc).
extern "C" int fused_chain_nc_f32(CHAIN_PARAMS, const int* dilations,
                                  float* x_out, float* skip, float* scratch,
                                  void* stream) {
  if (L < 1 || L > kMaxLayers || k < 1 || k > kMaxTaps)
    return static_cast<int>(cudaErrorInvalidValue);
  int offsets[kMaxLayers * kMaxTaps];
  for (int l = 0; l < L; ++l)
    for (int j = 0; j < k; ++j)
      offsets[l * k + j] = (j - (k - 1) / 2) * dilations[l];
  return launch_chain(CHAIN_ARGS, offsets, static_cast<cudaStream_t>(stream));
}
