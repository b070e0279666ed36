// Fused gated-resblock chains for one-pass vocoder synthesis at batch 1,
// Hopper (sm_90a), products on the tensor cores, in two forms: f32 in and
// out, and bf16 (x, c and the weights bf16, the biases and skip f32).
//
// Replaces the three TPU kernels of vqvae_speech_tpu/ops/fused_resblock.py,
// each at the two dtypes the JAX package runs them at:
//   _chain_kernel_tiled (fused_block_chain_tiled)  -> fused_chain_tiled_f32,
//                                                     fused_chain_tiled_bf16
//   _chain_kernel_nc    (fused_block_chain_nc)     -> fused_chain_nc_f32,
//                                                     fused_chain_nc_bf16
//   _chain_kernel       (fused_block_chain)        -> fused_chain_f32,
//                                                     fused_chain_bf16
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
// The bf16 form. At bf16 the JAX kernels compute another function: bf16
// operands with f32 sums (preferred_element_type=f32), the gated output
// rounded to bf16 before the projections, x carried between layers in bf16,
// skip in f32, the biases f32. A product of two bf16 values is exact in f32,
// so a product is ONE wgmma.mma_async.m64n128k16.f32.bf16.bf16, on weights
// prepared once in bf16. The rounding to bf16 is to nearest even
// (__floats2bfloat162_rn), as torch's and XLA's casts. The bf16 form has a
// kernel of its own, built for the card's balance at bf16: see "The bf16
// kernel" (namespace bf16, below). What follows up to there is the f32
// form's.
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
// FloWaveNet's 48 chains (the last block 2 x 23 MB a layer). The bf16 form
// keeps this layout, reduction index contiguous, without the split (wgate,
// wproj in bf16, half the bytes of one f32 part): the 128-byte-swizzled
// K-major tile is then the same bytes whatever the element type, so the
// descriptor (32 bytes a k16 step, as a k8 step of TF32) and the prepared
// weights' indexing are the f32 form's, and x, c and the gated output are
// read as they are stored, rows of contiguous channels.
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
#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;            // two warpgroups
constexpr int kBM = 128;                 // rows a block owns, 64 a warpgroup
constexpr int kBN = 128;                 // columns a block owns
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
// The bf16 form promotes after the same number of chunks: 128 reduction
// terms of one product, against 64 terms of three at f32.
constexpr int kPromote = CHAIN_PROMOTE;
constexpr int kBBytes = kBN * 128;       // one B part: 128 rows of 128 bytes

// The f32 form of the main loop. A chunk is one 128-byte row of the
// swizzled B tile: 32 floats. The A tile's rows are padded (36 floats) to
// keep the fragment reads off bank conflicts.
struct F32Form {
  using T = float;
  static constexpr int kBK = 32;         // reduction elements a chunk
  static constexpr int kParts = 2;       // B as hi and lo
  static constexpr int kAStride = kBK + 4;
};
template <class E>
struct Ring {
  static constexpr int kABytes = kBM * E::kAStride * sizeof(typename E::T);
  static constexpr int kStageBytes = E::kParts * kBBytes + kABytes;  // a multiple of 1024
  static constexpr int kSmemBytes = kStages * kStageBytes + 1024;    // + alignment slack
  static_assert(kStageBytes % 1024 == 0, "swizzled tiles need 1024-byte alignment");
  static_assert(kSmemBytes <= 232448, "the ring must fit one Hopper block");
};
constexpr int kMaxTaps = 8;
constexpr int kMaxSegs = kMaxTaps + 1;
constexpr int kGluThreads = 256;
constexpr int kMaxDevices = 64;
constexpr float kSqrtHalf = 0.70710678118654752f;

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

// d (64 x 128, f32) += a (64 x 16, bf16) x b (128 x 16), both K-major in
// shared memory (the 128-byte swizzle, descriptors as b_descriptor's);
// keep = 0 overwrites d instead
__device__ __forceinline__ void wgmma_m64n128k16_bf16_ss(float (&d)[64],
                                                         uint64_t a_desc,
                                                         uint64_t b_desc,
                                                         int keep) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63},"
      "%64, %65, p, 1, 1, 0, 0;\n"
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
      : "l"(a_desc), "l"(b_desc), "r"(keep));
}

// ---- the main loop ----

// One segment of a product's reduction: rows src[t + off] (zero outside
// [0, T)) of `width` elements against the `width` rounded up to 8 reduction
// columns of B that start at kbase.
struct Seg {
  const void* src;
  int width;
  int off;
  int kbase;
  int vec;  // rows are 16-byte aligned: copy 16 bytes at a time
};

enum Epilogue { kEpiGlu, kEpiPartial, kEpiProject, kEpiPlain };

// out tile = A @ B^T over the block's chunks. blockIdx.x: 128-row tile;
// blockIdx.y: column tile; blockIdx.z: layer * splits + split. The element
// type of A, B, the gated output and x is the form's (float or bf16); the
// biases, the partial sums, skip and the plain product are f32.
struct GemmArgs {
  Seg seg[kMaxSegs];
  int n_seg;
  int n_chunks;           // chunks over all segments
  int splits;             // the chunks are cut into this many runs ...
  int chunks_per_split;   // ... of this length
  const void* bhi;        // (layers, b_rows, ldb); f32: the hi and lo parts,
  const void* blo;        // bf16: bhi alone
  int ldb;
  int b_rows;
  int T;
  int G;                  // gate epilogues: the tile is 64 filter | 64 gate columns
  // kEpiGlu: gated[t, g] = tanh(f + bf[g]) * sigmoid(h + bg[g])
  const float* bf;
  const float* bg;
  void* gated;
  // kEpiPartial: part[z, t, :] = [f | h], raw sums
  float* part;
  // kEpiProject: columns [0, C) update x, [C, C + S) update skip
  const void* x_in;
  const float* bres;
  const float* bskip;
  void* x_out;
  float* skip;
  int C, S, first;
  // kEpiPlain: out[t, n] = the product, n < b_rows
  float* out;
};

// Stage `stage` <- chunk (seg s, elements [k0, k0 + kBK)) of A and of B (both
// parts), as cp.async copies; a copy that is out of range reads zero bytes
// and zero-fills.
template <class E>
__device__ __forceinline__ void load_chunk(const GemmArgs& a, const void* bhi,
                                           const void* blo, uint32_t stage,
                                           int s, int k0, int t0, int n0,
                                           int n1, int lim0, int lim1) {
  using T = typename E::T;
  constexpr int kPiece = 16 / sizeof(T);  // elements a 16-byte piece
  const int tid = threadIdx.x;
  const int piece = tid % 8;
  const Seg seg = a.seg[s];
  const int width8 = round_up(seg.width, 8);
  const int kp = k0 + piece * kPiece;
  // B: 128 rows x 8 pieces of 16 bytes (each part); piece p of row n lands
  // at chunk p ^ (n % 8) of the row (the 128-byte swizzle)
#pragma unroll
  for (int i = 0; i < kBN / 32; ++i) {
    const int nrow = tid / 8 + 32 * i;
    const int row = nrow < 64 ? n0 + nrow : n1 + nrow - 64;
    const bool ok = row < (nrow < 64 ? lim0 : lim1) && kp < width8;
    const size_t at = ok ? static_cast<size_t>(row) * a.ldb + seg.kbase + kp : 0;
    const uint32_t dst = stage + nrow * 128 + ((piece ^ (nrow & 7)) << 4);
    cp_async_16(dst, static_cast<const T*>(bhi) + at, ok);
    if (E::kParts == 2)
      cp_async_16(dst + kBBytes, static_cast<const T*>(blo) + at, ok);
  }
  // A: 128 rows x 8 pieces
  const uint32_t a_s = stage + E::kParts * kBBytes;
#pragma unroll
  for (int i = 0; i < kBM / 32; ++i) {
    const int row = tid / 8 + 32 * i;
    const int t = t0 + row;
    const int ts = t + seg.off;
    const bool row_ok = t < a.T && ts >= 0 && ts < a.T;
    const T* src = static_cast<const T*>(seg.src) +
                   (row_ok ? static_cast<size_t>(ts) * seg.width : 0);
    const uint32_t dst = a_s + (row * E::kAStride + piece * kPiece) * sizeof(T);
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

// The products of one staged chunk for this warpgroup's 64 rows, committed
// as one wgmma group: four k8 steps, each A_hi B_lo, A_lo B_hi, A_hi B_hi
// into acc. The fragment registers are this call's own, so that the caller
// can leave one group in flight.
template <class E>
__device__ __forceinline__ void mma_chunk(float (&acc)[64], uint32_t stage,
                                          const unsigned char* a_ptr, bool fresh) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int wg = threadIdx.x / 128;
  const int r = wg * 64 + warp * 16 + lane / 4, c = lane % 4;
  const float* a_s = reinterpret_cast<const float*>(a_ptr);
  uint32_t hi[E::kBK / 8][4], lo[E::kBK / 8][4];
#pragma unroll
  for (int s = 0; s < E::kBK / 8; ++s) {
    // the m64k8 fragment: rows r and r + 8, reduction columns c and c + 4
    split_tf32(a_s[r * E::kAStride + 8 * s + c], hi[s][0], lo[s][0]);
    split_tf32(a_s[(r + 8) * E::kAStride + 8 * s + c], hi[s][1], lo[s][1]);
    split_tf32(a_s[r * E::kAStride + 8 * s + c + 4], hi[s][2], lo[s][2]);
    split_tf32(a_s[(r + 8) * E::kAStride + 8 * s + c + 4], hi[s][3], lo[s][3]);
  }
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < E::kBK / 8; ++s) {
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
template <class E>
struct ChunkCursor {
  int seg, k0;
  __device__ __forceinline__ void advance(const GemmArgs& a) {
    k0 += E::kBK;
    if (k0 >= round_up(a.seg[seg].width, 8)) { ++seg; k0 = 0; }
  }
};

// A pair of adjacent elements of a (T, width) row-major array of the form's
// type, as floats / from floats.
template <class E>
__device__ __forceinline__ float2 load_pair(const void* base, size_t at) {
  return *reinterpret_cast<const float2*>(static_cast<const float*>(base) + at);
}

template <class E>
__device__ __forceinline__ void store_pair(void* base, size_t at, float x, float y) {
  *reinterpret_cast<float2*>(static_cast<float*>(base) + at) = make_float2(x, y);
}

template <int EPI, class E>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const __grid_constant__ GemmArgs a) {
  constexpr int kStageBytes = Ring<E>::kStageBytes;
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
  using T = typename E::T;
  const size_t b_layer = static_cast<size_t>(layer) * a.b_rows * a.ldb;
  const T* bhi = static_cast<const T*>(a.bhi) + b_layer;
  const T* blo = E::kParts == 2 ? static_cast<const T*>(a.blo) + b_layer : nullptr;

  const int c_begin = split * a.chunks_per_split;
  const int n = max(min(a.n_chunks, c_begin + a.chunks_per_split) - c_begin, 0);
  ChunkCursor<E> cur = {0, 0};
  for (int i = 0; i < c_begin; ++i) cur.advance(a);
  // Programmatic dependent launch: the next launch on the stream may be
  // scheduled onto SMs that this one's tail leaves idle, and this block
  // touches no memory before everything earlier on the stream is complete
  // and visible.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  // acc is the tensor cores' accumulator, sum the running total: see
  // kPromote. 226-234 registers a thread at f32, no spills.
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
      load_chunk<E>(a, bhi, blo, ring + p * kStageBytes, cur.seg, cur.k0, t0, n0,
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
        mma_chunk<E>(acc, ring + slot * kStageBytes,
                     ring_ptr + slot * kStageBytes + E::kParts * kBBytes,
                     i % kPromote == 0);
        // the products are queued before the next loads' address arithmetic
        // (measured 5% faster than loads first)
#ifndef CHAIN_NO_LOADS
        if (i + 2 < n) {
          load_chunk<E>(a, bhi, blo, ring + ((i + 2) % kStages) * kStageBytes,
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
          store_pair<E>(a.gated, static_cast<size_t>(t) * a.G + col,
                        tanhf(f0 + bf.x) * sigmoidf_(g0 + bg.x),
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
          old[2 * j + h] = load_pair<E>(a.x_in, static_cast<size_t>(t) * a.C + col);
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
          store_pair<E>(a.x_out, static_cast<size_t>(t) * a.C + col,
                        (o.x + vx) * kSqrtHalf, (o.y + vy) * kSqrtHalf);
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
// partial sums + the taps' partial sums, each in slice order; out in the
// form's type.
template <class E>
__global__ void __launch_bounds__(kGluThreads)
glu_kernel(const float* cpart, int c_splits, const float* gpart, int g_splits,
           const float* bf, const float* bg, void* out, int T, int G) {
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
  const size_t o = static_cast<size_t>(t) * G + g;
  store_pair<E>(out, o, tanhf(f.x) * sigmoidf_(h.x), tanhf(f.y) * sigmoidf_(h.y));
  store_pair<E>(out, o + 2, tanhf(f.z) * sigmoidf_(h.z), tanhf(f.w) * sigmoidf_(h.w));
}

// ---- the weights' prepared form ----

// The prepared value of one weight element: f32 splits into TF32 hi and lo
// parts, bf16 (moved as its 16-bit pattern) is copied as it is.
__device__ __forceinline__ void put_weight(float v, float* hi, float* lo, size_t at) {
  uint32_t h, w;
  split_tf32(v, h, w);
  hi[at] = __uint_as_float(h);
  lo[at] = __uint_as_float(w);
}

__device__ __forceinline__ void put_weight(unsigned short v, unsigned short* hi,
                                           unsigned short*, size_t at) {
  hi[at] = v;
}

// hi/lo[l, n, kk] of the gate matrix: row n < G is filter column n, row
// G + n gate column n; kk walks tap j's C channels at j * C8, then the
// conditioning's cin at k * C8; the padding is zero. Threads run along n,
// the sources' contiguous index.
template <typename S>
__global__ void __launch_bounds__(256)
prepare_gate_kernel(const S* wf, const S* wg, const S* wfc, const S* wgc, S* hi,
                    S* lo, int L, int k, int C, int G, int cin) {
  const int C8 = round_up(C, 8), Kg = k * C8 + round_up(cin, 8);
  const size_t total = static_cast<size_t>(L) * Kg * 2 * G;
  const size_t idx = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
  if (idx >= total) return;
  const int n = idx % (2 * G);
  const int kk = (idx / (2 * G)) % Kg;
  const int l = idx / (static_cast<size_t>(2 * G) * Kg);
  const bool gate = n >= G;
  const int col = gate ? n - G : n;
  S v = S(0);
  if (kk < k * C8) {
    const int j = kk / C8, ch = kk % C8;
    if (ch < C)
      v = (gate ? wg : wf)[((static_cast<size_t>(l) * k + j) * C + ch) * G + col];
  } else if (kk - k * C8 < cin) {
    v = (gate ? wgc : wfc)[(static_cast<size_t>(l) * cin + kk - k * C8) * G + col];
  }
  put_weight(v, hi, lo, (static_cast<size_t>(l) * 2 * G + n) * Kg + kk);
}

// hi/lo[l, n, g] of the projection matrix: row n < C is wres[l, :, n], row
// C + n is wskip[l, :, n]; g >= G is zero.
template <typename S>
__global__ void __launch_bounds__(256)
prepare_proj_kernel(const S* wres, const S* wskip, S* hi, S* lo, int L, int C,
                    int G, int S_) {
  const int G8 = round_up(G, 8), N = C + S_;
  const size_t total = static_cast<size_t>(L) * G8 * N;
  const size_t idx = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
  if (idx >= total) return;
  const int n = idx % N;
  const int g = (idx / N) % G8;
  const int l = idx / (static_cast<size_t>(N) * G8);
  S v = S(0);
  if (g < G)
    v = n < C ? wres[(static_cast<size_t>(l) * G + g) * C + n]
              : wskip[(static_cast<size_t>(l) * G + g) * S_ + n - C];
  put_weight(v, hi, lo, (static_cast<size_t>(l) * N + n) * G8 + g);
}

// ---- host side ----

template <class E>
int chunks_of(int width) { return ceil_div(round_up(width, 8), E::kBK); }

template <class E>
bool rows_aligned(const void* p, int width) {
  return (width * sizeof(typename E::T)) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int EPI, class E>
cudaError_t launch_gemm(const GemmArgs& a, dim3 grid, cudaStream_t s) {
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  // the shared-memory opt-in is per kernel and device: asked for once each
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices || !allowed[dev]) {
    err = cudaFuncSetAttribute(gemm_kernel<EPI, E>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Ring<E>::kSmemBytes);
    if (err != cudaSuccess) return err;
    if (dev >= 0 && dev < kMaxDevices) allowed[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Ring<E>::kSmemBytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, gemm_kernel<EPI, E>, a);
}

// x, c, x_out and the weights are of the form's element type; the f32 form
// has the weights' hi and lo parts, the bf16 form the weights alone (lo
// null). The scratch is laid out in floats alike in both forms.
struct ChainArgs {
  const void* x;
  const void* c;
  const void* wgate_hi;  // the prepared form, see prepare_chain_weights
  const void* wgate_lo;
  const void* wproj_hi;
  const void* wproj_lo;
  const float* bf;
  const float* bg;
  const float* bres;
  const float* bskip;
  int T, C, G, S, cin, L, k;
  void* x_out;
  float* skip;
  float* scratch;  // chain_scratch_floats() floats
  int path;        // 0, or a path forced for tests and measurements
};

constexpr int kPathRows = 1, kPathSplit = 2;  // 0: the shapes decide

// How the split path cuts a chain: the reduction splits of the conditioning
// pre-pass and of a layer's tap product, chosen so that each launch has
// about two blocks an SM and no split is under a few chunks. A function of
// the shapes, the form's chunk and the SM count alone.
struct SplitPlan {
  int c_splits, c_chunks;  // pre-pass: splits, chunks a split
  int g_splits, g_chunks;  // tap product of one layer
};

template <class E>
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
  cut(tiles * L, chunks_of<E>(cin), 4, &p.c_splits, &p.c_chunks);
  cut(tiles, k * chunks_of<E>(C), 2, &p.g_splits, &p.g_chunks);
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
// count alone, so results are a function of the inputs. The bf16 form has
// its own rule (bf16::takes_split_path).
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

// Floats of scratch an f32 chain needs: the (T, C) buffer x ping-pongs
// through, the gated output (T, G) and, on the split path, the partial sums
// of the pre-pass (L, c_splits, T, 2G) and of one layer's tap product
// (g_splits, T, 2G).
size_t chain_scratch_floats(int T, int C, int G, int cin, int L, int k, int sms,
                            int path) {
  size_t n = static_cast<size_t>(T) * C + static_cast<size_t>(T) * G;
  if (takes_split_path(T, G, sms, path)) {
    const SplitPlan p = split_plan<F32Form>(T, C, G, cin, L, k, sms);
    n += static_cast<size_t>(L) * p.c_splits * T * 2 * G +
         static_cast<size_t>(p.g_splits) * T * 2 * G;
  }
  return n;
}

// The gate product's arguments for layer l (l < 0: every layer, for the
// pre-pass): the taps of x_in when `taps`, the conditioning when `cond`.
template <class E>
GemmArgs gate_args(const ChainArgs& c, const int* offsets, int l,
                   const void* x_in, bool taps, bool cond) {
  GemmArgs a = {};
  const int C8 = round_up(c.C, 8);
  int n = 0, chunks = 0;
  if (taps) {
    for (int j = 0; j < c.k; ++j) {
      a.seg[n++] = Seg{x_in, c.C, offsets[l * c.k + j], j * C8,
                       rows_aligned<E>(x_in, c.C)};
      chunks += chunks_of<E>(c.C);
    }
  }
  if (cond) {
    a.seg[n++] = Seg{c.c, c.cin, 0, c.k * C8, rows_aligned<E>(c.c, c.cin)};
    chunks += chunks_of<E>(c.cin);
  }
  a.n_seg = n;
  a.n_chunks = chunks;
  a.splits = 1;
  a.chunks_per_split = chunks;
  a.ldb = c.k * C8 + round_up(c.cin, 8);
  a.b_rows = 2 * c.G;
  const size_t at = l < 0 ? 0 : static_cast<size_t>(l) * a.b_rows * a.ldb;
  using T = typename E::T;
  a.bhi = static_cast<const T*>(c.wgate_hi) + at;
  a.blo = E::kParts == 2 ? static_cast<const T*>(c.wgate_lo) + at : nullptr;
  a.T = c.T;
  a.G = c.G;
  return a;
}

// The projection launch of layer l: the gated output against [wres | wskip],
// the residual and skip updates in the epilogue. Returns the layer's output
// buffer in *x_next.
template <class E>
cudaError_t launch_projection(const ChainArgs& c, int l, const void* x_in,
                              void* gated, cudaStream_t s,
                              const void** x_next) {
  GemmArgs a = {};
  a.seg[0] = Seg{gated, c.G, 0, 0, rows_aligned<E>(gated, c.G)};
  a.n_seg = 1;
  a.n_chunks = a.chunks_per_split = chunks_of<E>(c.G);
  a.splits = 1;
  a.ldb = round_up(c.G, 8);
  a.b_rows = c.C + c.S;
  const size_t at = static_cast<size_t>(l) * a.b_rows * a.ldb;
  using T = typename E::T;
  a.bhi = static_cast<const T*>(c.wproj_hi) + at;
  a.blo = E::kParts == 2 ? static_cast<const T*>(c.wproj_lo) + at : nullptr;
  a.T = c.T;
  a.x_in = x_in;
  a.bres = c.bres + static_cast<size_t>(l) * c.C;
  a.bskip = c.bskip + static_cast<size_t>(l) * c.S;
  // ping-pong so that the last layer writes x_out
  a.x_out = ((c.L - 1 - l) % 2 == 0) ? c.x_out : static_cast<void*>(c.scratch);
  a.skip = c.skip;
  a.C = c.C;
  a.S = c.S;
  a.first = (l == 0);
  *x_next = a.x_out;
  return launch_gemm<kEpiProject, E>(
      a, dim3(ceil_div(c.T, kBM), ceil_div(c.C + c.S, kBN)), s);
}

// The split path: one pre-pass for every layer's conditioning product, then
// per layer the tap product, the GLU and the projection, all on `s`.
template <class E>
int launch_chain_split(const ChainArgs& c, const int* offsets, int sms,
                       cudaStream_t s) {
  const SplitPlan p = split_plan<E>(c.T, c.C, c.G, c.cin, c.L, c.k, sms);
  const size_t layer_part = static_cast<size_t>(c.T) * 2 * c.G;
  float* gated = c.scratch + static_cast<size_t>(c.T) * c.C;
  float* cpart = gated + static_cast<size_t>(c.T) * c.G;
  float* gpart = cpart + static_cast<size_t>(c.L) * p.c_splits * layer_part;
  const int row_tiles = ceil_div(c.T, kBM), col_tiles = ceil_div(c.G, 64);
  if (static_cast<int64_t>(c.L) * p.c_splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);

  GemmArgs pre = gate_args<E>(c, offsets, -1, nullptr, false, true);
  pre.splits = p.c_splits;
  pre.chunks_per_split = p.c_chunks;
  pre.part = cpart;
  cudaError_t err = launch_gemm<kEpiPartial, E>(
      pre, dim3(row_tiles, col_tiles, c.L * p.c_splits), s);
  if (err != cudaSuccess) return static_cast<int>(err);

  const void* x_in = c.x;
  for (int l = 0; l < c.L; ++l) {
    GemmArgs taps = gate_args<E>(c, offsets, l, x_in, true, false);
    taps.splits = p.g_splits;
    taps.chunks_per_split = p.g_chunks;
    taps.part = gpart;
    err = launch_gemm<kEpiPartial, E>(taps, dim3(row_tiles, col_tiles, p.g_splits),
                                      s);
    if (err != cudaSuccess) return static_cast<int>(err);
    glu_kernel<E><<<ceil_div(c.T * (c.G / 4), kGluThreads), kGluThreads, 0, s>>>(
        cpart + static_cast<size_t>(l) * p.c_splits * layer_part, p.c_splits,
        gpart, p.g_splits, c.bf + static_cast<size_t>(l) * c.G,
        c.bg + static_cast<size_t>(l) * c.G, gated, c.T, c.G);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch_projection<E>(c, l, x_in, gated, s, &x_in);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// offsets: L * k row offsets, layer-major. On the row-tiled path two
// launches a layer on `s`; chains of few rows take the split path.
template <class E>
int launch_chain(const ChainArgs& c, const int* offsets, cudaStream_t s) {
  if (c.k < 1 || c.k > kMaxTaps || c.L < 1 || c.T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const int dev_err = device_sms(&sms);
  if (dev_err != 0) return dev_err;
  if (takes_split_path(c.T, c.G, sms, c.path))
    return launch_chain_split<E>(c, offsets, sms, s);
  float* gated = c.scratch + static_cast<size_t>(c.T) * c.C;
  const void* x_in = c.x;
  for (int l = 0; l < c.L; ++l) {
    GemmArgs gate = gate_args<E>(c, offsets, l, x_in, true, true);
    gate.bf = c.bf + static_cast<size_t>(l) * c.G;
    gate.bg = c.bg + static_cast<size_t>(l) * c.G;
    gate.gated = gated;
    cudaError_t err = launch_gemm<kEpiGlu, E>(
        gate, dim3(ceil_div(c.T, kBM), ceil_div(c.G, 64)), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch_projection<E>(c, l, x_in, gated, s, &x_in);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

constexpr int kMaxLayers = 64;

// Causal chain with dilation k**l at layer l (the ClariNet convention).
template <class E>
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
  return launch_chain<E>(c, offsets, s);
}

// The non-causal chain with L dilations given.
template <class E>
int launch_noncausal(const ChainArgs& c, const int* dilations, cudaStream_t s) {
  if (c.L < 1 || c.L > kMaxLayers || c.k < 1 || c.k > kMaxTaps)
    return static_cast<int>(cudaErrorInvalidValue);
  int offsets[kMaxLayers * kMaxTaps];
  for (int l = 0; l < c.L; ++l)
    for (int j = 0; j < c.k; ++j)
      offsets[l * c.k + j] = (j - (c.k - 1) / 2) * dilations[l];
  return launch_chain<E>(c, offsets, s);
}

// out (M, N) = a (M, K) @ b^T through the main loop alone, b in the
// prepared layout (N, K rounded up to 8).
template <class E>
int launch_matmul(const void* a, const void* b_hi, const void* b_lo, int M,
                  int N, int K, float* out, cudaStream_t s) {
  GemmArgs g = {};
  g.seg[0] = Seg{a, K, 0, 0, rows_aligned<E>(a, K)};
  g.n_seg = 1;
  g.n_chunks = g.chunks_per_split = chunks_of<E>(K);
  g.splits = 1;
  g.bhi = b_hi;
  g.blo = b_lo;
  g.ldb = round_up(K, 8);
  g.b_rows = N;
  g.T = M;
  g.out = out;
  return static_cast<int>(launch_gemm<kEpiPlain, E>(
      g, dim3(ceil_div(M, kBM), ceil_div(N, kBN)), s));
}

template <typename S>
int prepare_chain_weights(const S* wf, const S* wg, const S* wfc, const S* wgc,
                          const S* wres, const S* wskip, int C, int G, int S_,
                          int cin, int L, int k, S* wgate_hi, S* wgate_lo,
                          S* wproj_hi, S* wproj_lo, cudaStream_t s) {
  const size_t gate = static_cast<size_t>(L) * 2 * G *
                      (k * round_up(C, 8) + round_up(cin, 8));
  const size_t proj = static_cast<size_t>(L) * (C + S_) * round_up(G, 8);
  prepare_gate_kernel<S><<<static_cast<unsigned>((gate + 255) / 256), 256, 0, s>>>(
      wf, wg, wfc, wgc, wgate_hi, wgate_lo, L, k, C, G, cin);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  prepare_proj_kernel<S><<<static_cast<unsigned>((proj + 255) / 256), 256, 0, s>>>(
      wres, wskip, wproj_hi, wproj_lo, L, C, G, S_);
  return static_cast<int>(cudaGetLastError());
}


// ---- The bf16 kernel: warp-specialised, on a TMA ring ----
//
// What bounds it on an H100. The student's chain at T = 20480 is 75 us of
// bf16 tensor work (989 TFLOP/s) and cuBLAS takes 0.23-0.28 ms for its bare
// products; what this kernel pays for is the traffic from L2 and the steps
// between the products. Measured on the card (the bare product through this
// loop, chunk = 64 bf16 of reduction over a 128 x 128 tile, 32 KB of A and
// B): with every SM pulling, the loads alone take 0.6 us a chunk (some
// 7 TB/s from L2), the products alone with the ring's handshake 0.87 us,
// of which the tensor work is 0.3 (four more wgmma a warpgroup cost 0.08 us
// each). So a chunk here is 128 elements (two sub-chunks of 64, 64 KB, a
// ring of three), which halves the fixed cost a chunk; the accumulator's
// promotion (kPromote, counted in sub-chunks of 64) is as at f32.
//
// The design. One block an SM, 384 threads. Warpgroup 2 is the producer:
// its thread 0 issues TMA copies into the ring, full and empty mbarriers
// between it and the consumers (setmaxnreg: 56 registers, the consumers
// 224). A is a box of 64 elements x 128 rows of x, c_up or the gated
// output, at a signed row coordinate: rows outside [0, T) come back zero,
// which is all the zero padding of the taps, causal or centred. B is two
// 64-row boxes of a 3-D map over (Kg or G8, rows, layer). Warpgroups 0 and
// 1 own 64 rows each of the 128-row tile and read the same B; both operands
// come from shared memory (the 128-byte swizzle TMA writes is the one the
// descriptors name). Rows TMA cannot take (not a 16-byte multiple, or an
// unaligned base: a rule of the shapes and pointers, decided at the launch)
// are copied by the producer's 128 threads instead.
//
// The work is phases of items, walked by every block (item = block, +=
// grid), a grid barrier between phases; the producer and the consumers walk
// the same sequence, so a chunk's stage and parity are a running count.
//   kGate:  (row tile, 64 filter + 64 gate columns) over the taps and the
//           conditioning, + the biases, tanh * sigmoid, rounded to bf16
//           into the gated output (T, G8);
//   kProj:  (row tile, 128 columns of [wres | wskip]) over the gated output,
//           the residual (x rounded to bf16) and skip updates.
// The row-tiled path is one cooperative launch a layer: kGate, a barrier,
// kProj. The split path (at most one row tile for 32 SMs: FloWaveNet's
// blocks 5-7, whose conditioning is 2560-10240 wide) is one cooperative
// launch a chain: kCondPart, the conditioning product of every layer cut
// over cin into about two items a block, writing partial sums; kReduce,
// their sums in split order with the gate biases; then per layer kGateCond
// (the taps + those sums) and kProj. Every output element is written by
// one thread in a fixed order: no atomics, results are bit-reproducible.
//
// The first design kept a row tile's gated output in shared memory and ran
// gate and projection as one item. Measured: the student's chain 0.85 ms
// (PR 9's two launches a layer: 0.73): one item a 128-row tile is 160 items
// at T = 20480, 1.2 waves on 132 SMs, and 40 at T = 5119, and the GLU and
// residual epilogues, a third of an item, ran with the tensor cores idle.
// The two phases keep four times the blocks busy; the gated output makes a
// round trip through L2 (10.5 MB at T = 20480).
//
// Two things ptxas needs, else it serialises every wgmma of the kernel
// (its warning C7518): the role and the warpgroup index from __shfl_sync,
// so that the wgmma are not taken for divergent code, and a wgmma wait
// after every product, before the grid barrier's divergent code.

namespace bf16 {

constexpr int kThreads = 384;          // two consumer warpgroups + the producer's
constexpr int kConsumerThreads = 256;
constexpr int kK = 64;                 // bf16 a sub-chunk: one 128-byte row
constexpr int kSub = 2;                // sub-chunks a chunk
constexpr int kChunk = kSub * kK;      // reduction elements a chunk (a ring stage)
constexpr int kTile = 128 * 128;       // one 128-row x 128-byte swizzled tile
constexpr int kStage = 2 * kSub * kTile;  // A and B of a chunk: 64 KB
constexpr int kMaxStages = 8;
constexpr int kBarBytes = 2 * kMaxStages * 8;
constexpr int kSmemMax = 232448;
// the deepest ring that fits a block: 3 stages of 64 KB
constexpr int kRingStages = (kSmemMax - kBarBytes - 1024) / kStage < kMaxStages
                                ? (kSmemMax - kBarBytes - 1024) / kStage
                                : kMaxStages;

// The phases' work: the gate product of a (row tile, 64 filter + 64 gate
// columns) tile, over the taps and the conditioning with the biases
// (kGate) or over the taps with the conditioning's sums (kGateCond), its
// GLU stored in bf16; the conditioning's partial sums (kCondPart) and
// their sums (kReduce); the projection of a (row tile, 128 columns) tile
// with the residual and skip updates (kProj); a bare product (kPlain).
enum Kind { kGate, kGateCond, kCondPart, kReduce, kProj, kPlain };
enum Path { kRows, kSplit, kMatmul };
// The A sources: the conditioning, the chain's input x, the two buffers x
// ping-pongs through (the scratch one and x_out), the gated output.
enum SrcId { kSrcC, kSrcX, kSrcXa, kSrcXb, kSrcGated, kNumSrc };

struct Src {
  const __nv_bfloat16* ptr;
  int width;  // elements of a row that are read
  int ld;     // elements from one row to the next
  int tma;    // 1: copied through the tensor map of the same index
};

struct Args {
  CUtensorMap map[kNumSrc];  // (width, rows) of each A source, boxes 64 x 128
  CUtensorMap wgate;         // (Kg, 2G, L), boxes 64 x 64 x 1; the matmul's b
  CUtensorMap wproj;         // (G8, C + S, L), boxes 64 x 64 x 1
  Src src[kNumSrc];
  const float *bf, *bg, *bres, *bskip;
  float* skip;
  float* part;     // split: (L, c_splits, T, 2G) partial sums
  float* condsum;  // split: (L, T, 2G) their sums and the gate biases
  float* out;      // matmul: (M, N)
  int T, C, G, S, cin, L, k, causal;
  int dil[kMaxLayers];
  int path, phase0, phase1;  // the launch runs phases [phase0, phase1)
  int manual;                // some A source is copied by the producer's threads
  int c_splits, c_chunks;    // split: the conditioning's reduction, cut
  int n_cols;                // matmul: N
};

// ---- PTX: mbarriers, TMA, fences ----

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// An arrival by the threads for which `pred` holds (a predicate inside the
// instruction, not a branch: the consumers' code stays warp-uniform, so
// that ptxas does not serialise their wgmma).
__device__ __forceinline__ void mbar_arrive(uint32_t bar, bool pred = true) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(bar),
      "r"(static_cast<int>(pred))
      : "memory");
}

// Spin until the phase of the given parity has completed; the loop is
// inside the asm for the same reason.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Generic-proxy writes made visible to the async proxy: st.shared to
// wgmma's reads of shared memory, st.global to TMA's reads.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// ---- the plan: phases, items, chunks. The producer and the consumers walk
// the same sequence, so a chunk's stage and parity are a running count. ----

// The scalars the loops read, copied once into registers. Read through the
// parameter block (whose address the TMA operands take), each would be read
// again after every barrier operation and every store, which the compiler
// cannot tell from writes to it.
struct Dims {
  int T, C, G, S, cin, L, k, causal, path, manual, tma;  // tma: bit i, source i
  int c_splits, c_chunks, n_cols;
  int NG, NP, n_taps, n_cond, n_proj, n_plain, C8, G8;
};

__device__ __forceinline__ Dims dims_of(const Args& a) {
  Dims d;
  d.T = a.T;
  d.C = a.C;
  d.G = a.G;
  d.S = a.S;
  d.cin = a.cin;
  d.L = a.L;
  d.k = a.k;
  d.causal = a.causal;
  d.path = a.path;
  d.manual = a.manual;
  d.tma = 0;
#pragma unroll
  for (int i = 0; i < kNumSrc; ++i) d.tma |= a.src[i].tma << i;
  d.c_splits = a.c_splits;
  d.c_chunks = a.c_chunks;
  d.n_cols = a.n_cols;
  d.NG = ceil_div(a.G, 64);
  d.NP = ceil_div(a.C + a.S, 128);
  d.n_taps = a.k * ceil_div(a.C, kChunk);
  d.n_cond = ceil_div(a.cin, kChunk);
  d.n_proj = ceil_div(a.G, kChunk);
  d.n_plain = ceil_div(a.src[kSrcX].width, kChunk);
  d.C8 = round_up(a.C, 8);
  d.G8 = round_up(a.G, 8);
  return d;
}

__device__ __forceinline__ void phase_of(const Dims& d, int p, int& kind, int& l) {
  l = 0;
  if (d.path == kMatmul) {
    kind = kPlain;
  } else if (d.path == kRows) {  // per layer: gate, projection
    l = p / 2;
    kind = p % 2 == 0 ? kGate : kProj;
  } else if (p == 0) {  // the conditioning of every layer, its sums, then per layer
    kind = kCondPart;
  } else if (p == 1) {
    kind = kReduce;
  } else {
    l = (p - 2) / 2;
    kind = p % 2 == 0 ? kGateCond : kProj;
  }
}

__device__ __forceinline__ int out_src(const Dims& d, int l) {
  return (d.L - 1 - l) % 2 == 0 ? kSrcXb : kSrcXa;  // the last layer writes x_out
}

__device__ __forceinline__ int in_src(const Dims& d, int l) {
  return l == 0 ? kSrcX : out_src(d, l - 1);
}

__device__ __forceinline__ int items_of(const Dims& d, int kind) {
  const int R = ceil_div(d.T, 128);
  switch (kind) {
    case kGate:
    case kGateCond: return R * d.NG;
    case kCondPart: return R * d.NG * d.L * d.c_splits;
    case kProj: return R * d.NP;
    case kPlain: return R * ceil_div(d.n_cols, 128);
    default: return 0;
  }
}

// ---- the producer ----

// Rows [row0, row0 + 128) x elements [col0, col0 + 64) of a source whose
// rows TMA cannot take, by the producer's 128 threads, a row each, into the
// 128-byte-swizzled tile at dst; zero outside [0, T) and past the width.
__device__ __forceinline__ void copy_rows(const Src& s, int T, uint32_t dst,
                                          int row0, int col0, int tid) {
  const int t = row0 + tid;
  const bool row_ok = t >= 0 && t < T;
  const unsigned short* src = reinterpret_cast<const unsigned short*>(s.ptr) +
                              (row_ok ? static_cast<size_t>(t) * s.ld : 0);
#pragma unroll 1
  for (int p = 0; p < 8; ++p) {
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c0 = col0 + 8 * p + 2 * e;
      const uint32_t lo = row_ok && c0 < s.width ? __ldg(src + c0) : 0;
      const uint32_t hi = row_ok && c0 + 1 < s.width ? __ldg(src + c0 + 1) : 0;
      w[e] = lo | (hi << 16);
    }
    const uint32_t at = dst + tid * 128 + ((p ^ (tid & 7)) << 4);
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(at), "r"(w[0]),
                 "r"(w[1]), "r"(w[2]), "r"(w[3])
                 : "memory");
  }
}

// One chunk into the next stage of the ring, as two sub-chunks of 64
// elements: A (rows row_a... of source src_a from element col_a; none when
// src_a < 0) and B's two 64-row boxes (rows b_row0 and b_row1 of layer
// `layer` of map_b, from element b_col). A sub-chunk past a segment reads
// zero A, so its products add nothing whatever B holds there.
__device__ __forceinline__ void load_chunk(const Args& a, const Dims& d, uint32_t& it,
                                           uint32_t ring, uint32_t bars, int tid,
                                           int src_a, int row_a, int col_a,
                                           const CUtensorMap* map_b, int b_col,
                                           int b_row0, int b_row1, int layer) {
  const int stage = it % kRingStages;
  const uint32_t full = bars + 8 * stage;
  mbar_wait(bars + 8 * (kMaxStages + stage), ((it / kRingStages) & 1) ^ 1);
  const uint32_t dst = ring + stage * kStage;
  const bool tma_a = src_a >= 0 && ((d.tma >> src_a) & 1);
  if (d.manual) {
    if (src_a >= 0 && !tma_a)
      for (int q = 0; q < kSub; ++q)
        copy_rows(a.src[src_a], d.T, dst + q * kTile, row_a, col_a + q * kK, tid);
    fence_async_shared();
    named_sync(1, 128);
  }
  if (tid == 0) {
    mbar_expect_tx(full, (tma_a ? kSub * kTile : 0) + kSub * kTile);
#pragma unroll
    for (int q = 0; q < kSub; ++q) {
      if (tma_a) tma_2d(dst + q * kTile, &a.map[src_a], full, col_a + q * kK, row_a);
      const uint32_t b = dst + (kSub + q) * kTile;
      tma_3d(b, map_b, full, b_col + q * kK, b_row0, layer);
      tma_3d(b + kTile / 2, map_b, full, b_col + q * kK, b_row1, layer);
    }
  }
  ++it;
}

// The gate product of row tile t0 and filter/gate columns [n0, n0 + 64) of
// layer l: the k taps of source x_src (none when x_src < 0), then the
// conditioning's chunks [c_first, c_last).
__device__ __forceinline__ void load_gate(const Args& a, const Dims& d, uint32_t& it,
                                          uint32_t ring, uint32_t bars, int tid, int t0,
                                          int n0, int l, int x_src, int c_first,
                                          int c_last) {
  if (x_src >= 0) {
    const int dil = a.dil[l];
    for (int j = 0; j < d.k; ++j) {
      const int off = d.causal ? -(d.k - 1 - j) * dil : (j - (d.k - 1) / 2) * dil;
      for (int k0 = 0; k0 < d.C; k0 += kChunk)
        load_chunk(a, d, it, ring, bars, tid, x_src, t0 + off, k0, &a.wgate,
                   j * d.C8 + k0, n0, d.G + n0, l);
    }
  }
  for (int i = c_first; i < c_last; ++i)
    load_chunk(a, d, it, ring, bars, tid, kSrcC, t0, i * kChunk, &a.wgate,
               d.k * d.C8 + i * kChunk, n0, d.G + n0, l);
}

__device__ void produce(const Args& a, uint32_t ring, uint32_t bars, int tid) {
  namespace cg = cooperative_groups;
  const Dims d = dims_of(a);
  const int p0 = a.phase0, p1 = a.phase1;
  uint32_t it = 0;
  for (int p = p0; p < p1; ++p) {
    int kind, l;
    phase_of(d, p, kind, l);
    if ((d.manual || tid == 0) && kind != kReduce) {
      const int items = items_of(d, kind);
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        if (kind == kGate || kind == kGateCond) {
          load_gate(a, d, it, ring, bars, tid, item / d.NG * 128, item % d.NG * 64, l,
                    in_src(d, l), 0, kind == kGate ? d.n_cond : 0);
        } else if (kind == kCondPart) {
          // item = ((row tile * NG + column tile) * L + layer) * c_splits + split
          const int s = item % d.c_splits, rest = item / d.c_splits;
          const int layer = rest % d.L, tile = rest / d.L;
          const int first = s * d.c_chunks;
          load_gate(a, d, it, ring, bars, tid, tile / d.NG * 128, tile % d.NG * 64, layer,
                    -1, first, min(d.n_cond, first + d.c_chunks));
        } else {  // kProj, kPlain: 128 columns against A from a source
          const bool proj = kind == kProj;
          const int np = proj ? d.NP : ceil_div(d.n_cols, 128);
          const int m = item % np, t0 = item / np * 128;
          for (int i = 0; i < (proj ? d.n_proj : d.n_plain); ++i)
            load_chunk(a, d, it, ring, bars, tid, proj ? kSrcGated : kSrcX, t0, i * kChunk,
                       proj ? &a.wproj : &a.wgate, i * kChunk, m * 128, m * 128 + 64,
                       proj ? l : 0);
        }
      }
    }
    if (p + 1 < p1) {
      cg::this_grid().sync();
      fence_async_global();
    }
  }
}

// ---- the consumers ----

// One product for this warpgroup's 64 rows: n chunks off the ring. The
// accumulator is promoted into `sum` every kPromote sub-chunks of 64 (see
// kPromote: 128 reduction terms by default, as at f32 64 terms of three
// products); a stage goes back to the producer once the products that read
// it are done, whatever kPromote.
__device__ __forceinline__ void product(float (&sum)[64], uint32_t& it, int n,
                                        uint32_t ring, uint32_t bars, int wg, int lane) {
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = sum[e] = 0.f;
  bool held = false;  // the previous chunk's stage is not yet released
  for (int i = 0; i < n; ++i, ++it) {
    const int stage = it % kRingStages;
    mbar_wait(bars + 8 * stage, (it / kRingStages) & 1);
    const uint32_t s_addr = ring + stage * kStage;
    bool done = false;  // every product of this chunk is complete
#pragma unroll
    for (int q = 0; q < kSub; ++q) {
      const int sc = i * kSub + q;
      const uint32_t a_addr = s_addr + q * kTile + wg * (kTile / 2);
      const uint32_t b_addr = s_addr + (kSub + q) * kTile;
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kK / 16; ++s)
        wgmma_m64n128k16_bf16_ss(acc, b_descriptor(a_addr + 32 * s),
                                 b_descriptor(b_addr + 32 * s),
                                 (s > 0 || sc % kPromote != 0) ? 1 : 0);
      wgmma_commit();
      if (sc % kPromote == kPromote - 1 || (i == n - 1 && q == kSub - 1)) {
        wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < 64; ++e) sum[e] += acc[e];
        done = q == kSub - 1;
      }
    }
    if (!done) wgmma_wait<1>();  // the previous chunk's products are done
    __syncwarp();
    if (held) mbar_arrive(bars + 8 * (kMaxStages + (it - 1) % kRingStages), lane == 0);
    if (done) mbar_arrive(bars + 8 * (kMaxStages + it % kRingStages), lane == 0);
    held = !done;
  }
  // Nothing is in flight here (the last chunk waited), but ptxas cannot
  // prove it, and would serialise every wgmma of the kernel for the grid
  // barrier's divergent code that follows some products.
  wgmma_wait<0>();
}

// tanh(f) * sigmoid(g) as the f32 kernels take it. (An exp2-based form in
// a third of the instructions, a few f32 ulps off, moved 1-2% of x off the
// exact chain at a few hundred rows, where the plain chain moves none.)
__device__ __forceinline__ float glu(float f, float g) {
  return tanhf(f) * sigmoidf_(g);
}

__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The biases of the 16 column pairs [n0 + 8 j + 2 c, +1] of a projection
// tile: bres below C, bskip from C on; zero past C + S.
__device__ __forceinline__ void project_biases(const Dims& d, const float* bres,
                                               const float* bskip, int n0, int c,
                                               float2 (&b)[16]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + 2 * c;
    b[j] = make_float2(0.f, 0.f);
    if (col < d.C)
      b[j] = *reinterpret_cast<const float2*>(bres + col);
    else if (col < d.C + d.S)
      b[j] = *reinterpret_cast<const float2*>(bskip + col - d.C);
  }
}

// The residual and skip updates from the projection's columns [n0, n0 +
// 128), rows r and r + 8 of this thread: columns < C update x (rounded to
// bf16), the rest skip (`first`: skip is written, not added to). Every read
// goes out before the first store, from L2 (another block of the launch may
// have written the line).
__device__ __forceinline__ void project_epilogue(const Dims& d, const float (&sum)[64],
                                                 const float2 (&b)[16],
                                                 const __nv_bfloat16* x_in,
                                                 __nv_bfloat16* x_out, float* skip,
                                                 bool first, int n0, int r, int c) {
  float2 old[32];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + 2 * c;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = r + 8 * h;
      old[2 * j + h] = make_float2(0.f, 0.f);
      if (col >= d.C + d.S || t >= d.T) continue;
      if (col < d.C) {
        const unsigned v = __ldcg(reinterpret_cast<const unsigned*>(
            x_in + static_cast<size_t>(t) * d.C + col));
        old[2 * j + h] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
      } else if (!first) {
        old[2 * j + h] = __ldcg(reinterpret_cast<const float2*>(
            skip + static_cast<size_t>(t) * d.S + col - d.C));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + 2 * c;
    if (col >= d.C + d.S) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = r + 8 * h;
      if (t >= d.T) continue;
      const float2 o = old[2 * j + h];
      const float vx = sum[4 * j + 2 * h] + b[j].x, vy = sum[4 * j + 2 * h + 1] + b[j].y;
      if (col < d.C)
        *reinterpret_cast<uint32_t*>(x_out + static_cast<size_t>(t) * d.C + col) =
            pack_bf16((o.x + vx) * kSqrtHalf, (o.y + vy) * kSqrtHalf);
      else
        *reinterpret_cast<float2*>(skip + static_cast<size_t>(t) * d.S + col - d.C) =
            make_float2(o.x + vx, o.y + vy);
    }
  }
}

__device__ void consume(const Args& a, uint32_t ring, uint32_t bars, int tid) {
  namespace cg = cooperative_groups;
  const Dims d = dims_of(a);
  // the warpgroup from a value the compiler knows is warp-uniform: it sets
  // the wgmma descriptors' rows
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int rr = wg * 64 + warp * 16 + lane / 4, c = lane % 4;  // tile row, column pair
  const float *const bf_all = a.bf, *const bg_all = a.bg;
  const float *const bres_all = a.bres, *const bskip_all = a.bskip;
  float* const skip = a.skip;
  float* const part_all = a.part;
  float* const condsum_all = a.condsum;
  float* const out = a.out;
  __nv_bfloat16* const gated_g = const_cast<__nv_bfloat16*>(a.src[kSrcGated].ptr);
  auto x_of = [&](int id) { return const_cast<__nv_bfloat16*>(a.src[id].ptr); };
  float sum[64];
  const int p0 = a.phase0, p1 = a.phase1;
  uint32_t it = 0;
  for (int p = p0; p < p1; ++p) {
    int kind, l;
    phase_of(d, p, kind, l);
    const float* bf = bf_all + static_cast<size_t>(l) * d.G;
    const float* bg = bg_all + static_cast<size_t>(l) * d.G;
    const float* bres = bres_all + static_cast<size_t>(l) * d.C;
    const float* bskip = bskip_all + static_cast<size_t>(l) * d.S;
    if (kind == kReduce) {
      // condsum[l, t, :] = the gate biases + the partial sums in split order
      const size_t per_layer = static_cast<size_t>(d.T) * 2 * d.G;
      const size_t n4 = d.L * per_layer / 4;
      const size_t step = static_cast<size_t>(gridDim.x) * kConsumerThreads;
      for (size_t e0 = static_cast<size_t>(blockIdx.x) * kConsumerThreads; e0 < n4;
           e0 += step) {  // a trip count the same for every thread
        const size_t e = e0 + tid;
        if (e >= n4) continue;
        const size_t at = 4 * e;
        const int layer = static_cast<int>(at / per_layer);
        const size_t rem = at - layer * per_layer;
        const int col = static_cast<int>(rem % (2 * d.G));
        float4 v =
            col < d.G ? *reinterpret_cast<const float4*>(bf_all + layer * d.G + col)
                      : *reinterpret_cast<const float4*>(bg_all + layer * d.G + col - d.G);
        const float* src = part_all + static_cast<size_t>(layer) * d.c_splits * per_layer + rem;
        for (int s = 0; s < d.c_splits; ++s) {
          const float4 w = __ldcg(reinterpret_cast<const float4*>(src + s * per_layer));
          v.x += w.x;
          v.y += w.y;
          v.z += w.z;
          v.w += w.w;
        }
        *reinterpret_cast<float4*>(condsum_all + at) = v;
      }
    } else {
      const int items = items_of(d, kind);
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        if (kind == kCondPart) {
          const int s = item % d.c_splits, rest = item / d.c_splits;
          const int layer = rest % d.L, tile = rest / d.L;
          const int n = tile % d.NG, t0 = tile / d.NG * 128;
          const int first = s * d.c_chunks;
          product(sum, it, min(d.n_cond, first + d.c_chunks) - first, ring, bars, wg, lane);
          float* part = part_all + (static_cast<size_t>(layer) * d.c_splits + s) * d.T * 2 * d.G;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = n * 64 + 8 * j + 2 * c;
            if (col >= d.G) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int t = t0 + rr + 8 * h;
              if (t >= d.T) continue;
              float* row = part + static_cast<size_t>(t) * 2 * d.G + col;
              *reinterpret_cast<float2*>(row) =
                  make_float2(sum[4 * j + 2 * h], sum[4 * j + 2 * h + 1]);
              *reinterpret_cast<float2*>(row + d.G) =
                  make_float2(sum[32 + 4 * j + 2 * h], sum[32 + 4 * j + 2 * h + 1]);
            }
          }
        } else if (kind == kGate || kind == kGateCond) {
          // the GLU of 64 columns into the gated output: the gate biases
          // (kGate) or the conditioning's sums, which hold them (kGateCond)
          const int n = item % d.NG, t0 = item / d.NG * 128;
          float2 f[16], g[16];  // in flight while the product runs
          const float* cs = condsum_all + static_cast<size_t>(l) * d.T * 2 * d.G;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int col = n * 64 + 8 * j + 2 * c, t = t0 + rr + 8 * h;
              f[2 * j + h] = g[2 * j + h] = make_float2(0.f, 0.f);
              if (col >= d.G || t >= d.T) continue;
              if (kind == kGate) {
                f[2 * j + h] = *reinterpret_cast<const float2*>(bf + col);
                g[2 * j + h] = *reinterpret_cast<const float2*>(bg + col);
              } else {
                const float* row = cs + static_cast<size_t>(t) * 2 * d.G + col;
                f[2 * j + h] = __ldcg(reinterpret_cast<const float2*>(row));
                g[2 * j + h] = __ldcg(reinterpret_cast<const float2*>(row + d.G));
              }
            }
          product(sum, it, d.n_taps + (kind == kGate ? d.n_cond : 0), ring, bars, wg, lane);
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int col = n * 64 + 8 * j + 2 * c, t = t0 + rr + 8 * h;
              if (col >= d.G || t >= d.T) continue;
              const float2 ff = f[2 * j + h], gg = g[2 * j + h];
              *reinterpret_cast<uint32_t*>(gated_g + static_cast<size_t>(t) * d.G8 + col) =
                  pack_bf16(glu(sum[4 * j + 2 * h] + ff.x, sum[32 + 4 * j + 2 * h] + gg.x),
                            glu(sum[4 * j + 2 * h + 1] + ff.y,
                                sum[32 + 4 * j + 2 * h + 1] + gg.y));
            }
        } else if (kind == kProj) {
          const int m = item % d.NP, t0 = item / d.NP * 128;
          float2 b[16];
          project_biases(d, bres, bskip, m * 128, c, b);
          product(sum, it, d.n_proj, ring, bars, wg, lane);
          project_epilogue(d, sum, b, x_of(in_src(d, l)), x_of(out_src(d, l)), skip, l == 0,
                           m * 128, t0 + rr, c);
        } else {  // kPlain
          const int np = ceil_div(d.n_cols, 128);
          const int m = item % np, t0 = item / np * 128;
          product(sum, it, d.n_plain, ring, bars, wg, lane);
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int col = m * 128 + 8 * j + 2 * c;
            if (col >= d.n_cols) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int t = t0 + rr + 8 * h;
              if (t >= d.T) continue;
              float* o = out + static_cast<size_t>(t) * d.n_cols + col;
              o[0] = sum[4 * j + 2 * h];
              if (col + 1 < d.n_cols) o[1] = sum[4 * j + 2 * h + 1];
            }
          }
        }
      }
    }
    if (p + 1 < p1) {
      fence_async_global();
      cg::this_grid().sync();
    }
  }
}

// One block an SM: warpgroups 0 and 1 multiply and run the epilogues,
// warpgroup 2 fills the ring (its thread 0 alone where every A source goes
// by TMA).
__global__ void __launch_bounds__(kThreads, 1) chain_kernel(const __grid_constant__ Args a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t bars = ring + kRingStages * kStage;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRingStages; ++s) {
      mbar_init(bars + 8 * s, 1);                 // full: the producer, + the bytes
      mbar_init(bars + 8 * (kMaxStages + s), 8);  // empty: each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Programmatic dependent launch (the row-tiled path): the next layer's
  // launch may be scheduled while this one drains, and no thread touches
  // global memory before the launch before it is complete and visible.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  // the role from a value the compiler knows is warp-uniform, so that the
  // consumers' wgmma is not taken for divergent code (and serialised)
  const int role = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (role == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    produce(a, ring, bars, threadIdx.x - kConsumerThreads);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    consume(a, ring, bars, threadIdx.x);
  }
}

// ---- host side ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's tensor-map encoder, fetched through the runtime (no link
// against libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Encoded maps, by their arguments: a chain call's host time was mostly
// its seven encodes, and the caching allocator hands back the same
// pointers call after call.
struct MapKey {
  const void* ptr;
  int width, rows, layers, ld, box_rows;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && width == o.width && rows == o.rows && layers == o.layers &&
           ld == o.ld && box_rows == o.box_rows;
  }
};
constexpr int kMapCache = 64;
MapKey g_map_keys[kMapCache];
CUtensorMap g_maps[kMapCache];
int g_map_next = 0;
std::mutex g_map_mutex;

// A (width, rows[, layers]) bf16 array, `ld` elements from row to row, in
// boxes of 64 elements x box_rows rows [x 1 layer], 128-byte swizzled; what
// a box holds past the array reads zero. False if it cannot be encoded.
bool encode(CUtensorMap* map, const void* ptr, int width, int rows, int layers, int ld,
            int box_rows) {
  const MapKey key = {ptr, width, rows, layers, ld, box_rows};
  std::lock_guard<std::mutex> lock(g_map_mutex);
  for (int i = 0; i < kMapCache; ++i)
    if (g_map_keys[i] == key) {
      *map = g_maps[i];
      return true;
    }
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(layers)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * 2,
                                 static_cast<cuuint64_t>(ld) * 2 * rows};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  if (fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, layers > 0 ? 3 : 2,
         const_cast<void*>(ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  g_map_keys[g_map_next] = key;
  g_maps[g_map_next] = *map;
  g_map_next = (g_map_next + 1) % kMapCache;
  return true;
}

// An A source: through TMA where its rows are 16-byte multiples on a
// 16-byte aligned base (a rule of the shapes and pointers), else copied by
// the producer's threads.
bool set_source(Args& a, int id, const void* ptr, int width, int ld, int rows) {
  a.src[id] = Src{static_cast<const __nv_bfloat16*>(ptr), width, ld, 0};
  if ((ld * 2) % 16 != 0 || reinterpret_cast<uintptr_t>(ptr) % 16 != 0) {
    a.manual = 1;
    return true;
  }
  a.src[id].tma = 1;
  return encode(&a.map[id], ptr, width, rows, 0, ld, 128);
}

// How the split path cuts the conditioning's reduction: about two items a
// block over the (row tile, gate column tile, layer) tiles.
void split_plan(int T, int G, int cin, int L, int sms, int* splits, int* chunks) {
  const int tiles = ceil_div(T, 128) * ceil_div(G, 64) * L;
  const int n = ceil_div(cin, kChunk);
  int want = ceil_div(2 * sms, tiles);
  if (want > n) want = n;
  *chunks = ceil_div(n, want);
  *splits = ceil_div(n, *chunks);
}

// The bf16 chain takes the split path at a few row tiles: at most one for
// 32 SMs (T <= 512 on 132 SMs). A rule of the shapes and the SM count alone.
bool takes_split_path(int T, int sms, int path) {
  if (path == kPathRows) return false;
  if (path == kPathSplit) return true;
  return 32 * ceil_div(T, 128) <= sms;
}

// Byte offsets in the scratch: x's other buffer (T, C), the gated output
// (T, G8) and, on the split path, the partial sums and their sums.
struct Scratch {
  size_t xa, gated, part, condsum, bytes;
};

Scratch scratch_layout(int T, int C, int G, int cin, int L, int sms, bool split) {
  auto up = [](size_t n) { return (n + 255) / 256 * 256; };
  Scratch s = {};
  s.bytes = up(static_cast<size_t>(T) * C * 2);
  s.gated = s.bytes;
  s.bytes += up(static_cast<size_t>(T) * round_up(G, 8) * 2);
  if (split) {
    int splits, chunks;
    split_plan(T, G, cin, L, sms, &splits, &chunks);
    s.part = s.bytes;
    s.bytes += up(static_cast<size_t>(L) * splits * T * 2 * G * 4);
    s.condsum = s.bytes;
    s.bytes += up(static_cast<size_t>(L) * T * 2 * G * 4);
  }
  return s;
}

int smem_bytes() { return kRingStages * kStage + kBarBytes + 1024; }

// The shared-memory opt-in and the blocks an SM holds (*per_sm, may be
// null), per device: asked for once each, before the first launch.
cudaError_t allow_smem(int* per_sm = nullptr) {
  static int blocks[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int n = dev >= 0 && dev < kMaxDevices ? blocks[dev] : 0;
  if (n == 0) {
    err = cudaFuncSetAttribute(chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemMax);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, chain_kernel, kThreads,
                                                          smem_bytes());
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorInvalidValue;
    if (dev >= 0 && dev < kMaxDevices) blocks[dev] = n;
  }
  if (per_sm != nullptr) *per_sm = n;
  return cudaSuccess;
}

cudaError_t launch(const Args& a, int blocks, bool cooperative, cudaStream_t s) {
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes();
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  if (cooperative) {
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
  } else {
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
  }
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, chain_kernel, a);
}

// A whole bf16 chain on `s`, as cooperative launches of one block an SM:
// one a layer on the row-tiled path (its gate phase, a grid barrier, its
// projection phase), one for the chain on the split path.
int launch_chain(const ChainArgs& c, const int* dil, bool causal, cudaStream_t s) {
  if (c.k < 1 || c.k > kMaxTaps || c.L < 1 || c.L > kMaxLayers || c.T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const int dev_err = device_sms(&sms);
  if (dev_err != 0) return dev_err;
  const bool split = takes_split_path(c.T, sms, c.path);
  Args a = {};
  a.T = c.T;
  a.C = c.C;
  a.G = c.G;
  a.S = c.S;
  a.cin = c.cin;
  a.L = c.L;
  a.k = c.k;
  a.causal = causal ? 1 : 0;
  for (int l = 0; l < c.L; ++l) a.dil[l] = dil[l];
  a.bf = c.bf;
  a.bg = c.bg;
  a.bres = c.bres;
  a.bskip = c.bskip;
  a.skip = c.skip;
  a.path = split ? kSplit : kRows;
  const Scratch sc = scratch_layout(c.T, c.C, c.G, c.cin, c.L, sms, split);
  unsigned char* base = reinterpret_cast<unsigned char*>(c.scratch);
  const int G8 = round_up(c.G, 8), Kg = c.k * round_up(c.C, 8) + round_up(c.cin, 8);
  bool ok = set_source(a, kSrcC, c.c, c.cin, c.cin, c.T) &&
            set_source(a, kSrcX, c.x, c.C, c.C, c.T) &&
            set_source(a, kSrcXa, base + sc.xa, c.C, c.C, c.T) &&
            set_source(a, kSrcXb, c.x_out, c.C, c.C, c.T) &&
            encode(&a.wgate, c.wgate_hi, Kg, 2 * c.G, c.L, Kg, 64) &&
            encode(&a.wproj, c.wproj_hi, G8, c.C + c.S, c.L, G8, 64) &&
            set_source(a, kSrcGated, base + sc.gated, c.G, G8, c.T);
  if (split) {
    split_plan(c.T, c.G, c.cin, c.L, sms, &a.c_splits, &a.c_chunks);
    a.part = reinterpret_cast<float*>(base + sc.part);
    a.condsum = reinterpret_cast<float*>(base + sc.condsum);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  int per_sm = 0;
  const cudaError_t err = allow_smem(&per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (split) {
    a.phase0 = 0;
    a.phase1 = 2 + 2 * c.L;
    return static_cast<int>(launch(a, sms * per_sm, true, s));
  }
  for (int l = 0; l < c.L; ++l) {
    a.phase0 = 2 * l;
    a.phase1 = 2 * l + 2;
    const cudaError_t e = launch(a, sms * per_sm, true, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// out (M, N) f32 = a (M, K) @ b^T, b (N, K8): the main loop alone.
int launch_matmul(const void* a_ptr, const void* b, int M, int N, int K, float* out,
                  cudaStream_t s) {
  if (M < 1 || N < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const int dev_err = device_sms(&sms);
  if (dev_err != 0) return dev_err;
  Args a = {};
  a.path = kMatmul;
  a.T = M;
  a.n_cols = N;
  a.out = out;
  a.phase0 = 0;
  a.phase1 = 1;
  if (!(set_source(a, kSrcX, a_ptr, K, K, M) &&
        encode(&a.wgate, b, round_up(K, 8), N, 1, round_up(K, 8), 64)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int items = ceil_div(M, 128) * ceil_div(N, 128);
  return static_cast<int>(launch(a, items < sms ? items : sms, false, s));
}

}  // namespace bf16

}  // namespace

// Floats of scratch a chain of these shapes needs on the current device, in
// the f32 form or (bf16 != 0) the bf16 one (into *floats), and whether it
// takes the split path (into *split); `path` 0 lets the shapes decide, 1
// forces the row-tiled path, 2 the split path. Returns 0 or a cudaError_t.
extern "C" int fused_chain_scratch_floats(int T, int C, int G, int cin, int L,
                                          int k, int path, int bf16,
                                          size_t* floats, int* split) {
  int sms = 0;
  const int err = device_sms(&sms);
  if (err != 0) return err;
  if (bf16) {
    const bool s = bf16::takes_split_path(T, sms, path);
    *floats = (bf16::scratch_layout(T, C, G, cin, L, sms, s).bytes + 3) / 4;
    *split = s ? 1 : 0;
  } else {
    *floats = chain_scratch_floats(T, C, G, cin, L, k, sms, path);
    *split = takes_split_path(T, G, sms, path) ? 1 : 0;
  }
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
  return prepare_chain_weights<float>(wf, wg, wfc, wgc, wres, wskip, C, G, S,
                                      cin, L, k, wgate_hi, wgate_lo, wproj_hi,
                                      wproj_lo, static_cast<cudaStream_t>(stream));
}

// The same for bf16 weights, transposed and not split (wgate of
// L * 2G * (k*C8 + cin8) bf16, wproj of L * (C+S) * G8). Returns 0 or a
// cudaError_t.
extern "C" int fused_chain_prepare_bf16(const void* wf, const void* wg,
                                        const void* wfc, const void* wgc,
                                        const void* wres, const void* wskip,
                                        int C, int G, int S, int cin, int L,
                                        int k, void* wgate, void* wproj,
                                        void* stream) {
  using U = unsigned short;
  return prepare_chain_weights<U>(
      static_cast<const U*>(wf), static_cast<const U*>(wg),
      static_cast<const U*>(wfc), static_cast<const U*>(wgc),
      static_cast<const U*>(wres), static_cast<const U*>(wskip), C, G, S, cin,
      L, k, static_cast<U*>(wgate), nullptr, static_cast<U*>(wproj), nullptr,
      static_cast<cudaStream_t>(stream));
}

// out (M, N) = a (M, K) @ b^T, b given as its split parts b_hi, b_lo (N, K8)
// with K8 = K rounded up to 8: the main loop alone, for checks against a
// library product. Returns 0 or a cudaError_t.
extern "C" int fused_chain_matmul_f32(const float* a, const float* b_hi,
                                      const float* b_lo, int M, int N, int K,
                                      float* out, void* stream) {
  return launch_matmul<F32Form>(a, b_hi, b_lo, M, N, K, out,
                                static_cast<cudaStream_t>(stream));
}

// out (M, N) f32 = a (M, K) @ b^T, a and b (N, K8) bf16: the bf16 main loop
// alone. Returns 0 or a cudaError_t.
extern "C" int fused_chain_matmul_bf16(const void* a, const void* b, int M,
                                       int N, int K, float* out, void* stream) {
  return bf16::launch_matmul(a, b, M, N, K, out, static_cast<cudaStream_t>(stream));
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
#define CHAIN_PARAMS_BF16                                                     \
  const void *x, const void *c, const void *wgate, const void *wproj,         \
      const float *bf, const float *bg, const float *bres,                    \
      const float *bskip, int T, int C, int G, int S, int cin, int L, int k,  \
      int path
#define CHAIN_ARGS_BF16                                                       \
  ChainArgs { x, c, wgate, nullptr, wproj, nullptr, bf, bg, bres,             \
              bskip, T, C, G, S, cin, L, k, x_out, skip, scratch, path }

// Each entry point runs a whole chain on `stream`, on the prepared weights
// of fused_chain_prepare_f32 (or _bf16), and returns cudaGetLastError() of
// the first launch that failed, or 0. Needs C, G, S multiples of 4, 16-byte
// aligned x, weights, biases and outputs, k <= 8, L <= 64, and
// fused_chain_scratch_floats() floats of scratch for the same `path`. The
// bf16 forms take x, c and the weights bf16 and write x_out bf16; the
// biases and skip are f32 in both.

// The causal chain as the IAF student serves it (TPU: _chain_kernel_tiled).
extern "C" int fused_chain_tiled_f32(CHAIN_PARAMS, float* x_out, float* skip,
                                     float* scratch, void* stream) {
  return launch_causal<F32Form>(CHAIN_ARGS, static_cast<cudaStream_t>(stream));
}

// The causal chain over the whole T (TPU: _chain_kernel, one resident tile).
extern "C" int fused_chain_f32(CHAIN_PARAMS, float* x_out, float* skip,
                               float* scratch, void* stream) {
  return launch_causal<F32Form>(CHAIN_ARGS, static_cast<cudaStream_t>(stream));
}

// The non-causal chain with L dilations given (TPU: _chain_kernel_nc).
extern "C" int fused_chain_nc_f32(CHAIN_PARAMS, const int* dilations,
                                  float* x_out, float* skip, float* scratch,
                                  void* stream) {
  return launch_noncausal<F32Form>(CHAIN_ARGS, dilations,
                                   static_cast<cudaStream_t>(stream));
}

namespace {

// The causal bf16 chain, dilation k**l at layer l.
int launch_causal_bf16(const ChainArgs& c, cudaStream_t s) {
  if (c.L < 1 || c.L > kMaxLayers || c.k < 1 || c.k > kMaxTaps)
    return static_cast<int>(cudaErrorInvalidValue);
  int dil[kMaxLayers];
  int64_t d = 1;
  for (int l = 0; l < c.L; ++l) {
    if ((c.k - 1) * d > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
    dil[l] = static_cast<int>(d);
    d *= c.k;
  }
  return bf16::launch_chain(c, dil, true, s);
}

}  // namespace

extern "C" int fused_chain_tiled_bf16(CHAIN_PARAMS_BF16, void* x_out,
                                      float* skip, float* scratch, void* stream) {
  return launch_causal_bf16(CHAIN_ARGS_BF16, static_cast<cudaStream_t>(stream));
}

extern "C" int fused_chain_bf16(CHAIN_PARAMS_BF16, void* x_out, float* skip,
                                float* scratch, void* stream) {
  return launch_causal_bf16(CHAIN_ARGS_BF16, static_cast<cudaStream_t>(stream));
}

extern "C" int fused_chain_nc_bf16(CHAIN_PARAMS_BF16, const int* dilations,
                                   void* x_out, float* skip, float* scratch,
                                   void* stream) {
  return bf16::launch_chain(CHAIN_ARGS_BF16, dilations, false,
                            static_cast<cudaStream_t>(stream));
}
