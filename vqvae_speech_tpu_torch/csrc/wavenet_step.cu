// Fused WaveNet GLU layer stack for one autoregressive decode step, Hopper
// (sm_90a), f32: ONE persistent cooperative launch a step.
//
// Replaces the TPU kernel vqvae_speech_tpu/ops/wavenet_step.py::_kernel
// (launched by fused_glu_stack_step). For every layer l in order, with x the
// layer's input (x = x0 at layer 0):
//
//   acc      = cond[l] + bias[l] + sum_{j<k-1} taps[l,j] @ wtap[l,j]
//              + x @ wtap[l,k-1]                                  (B, G)
//   h        = tanh(acc[:, :G/2]) * sigmoid(acc[:, G/2:])         (B, G/2)
//   s        = h @ wskip[l] + bskip[l]                            (B, S)
//   skip     = skip + s, or (skip + s) * sqrt(1/2) for l > 0 under legacy
//   x_all[l] = x
//   x        = (x + h @ wout[l] + bout[l]) * sqrt(1/2)
//
// and returns (x, skip, x_all). All sums are f32.
//
// What bounds it on an H100: bytes. One step streams every layer's weights
// once, 4*L*(k*C*G + G/2*(S+C)) bytes = 173 MB at the vctk_wavenet width
// (L=20, k=3, C=G=768, S=256), more than three times the 50 MB L2, for
// 2*B flops per weight element (B <= 32 a launch). At 3.35 TB/s that is
// 52 us a launch. A batch of more than 32 streams runs as groups of 32, one
// launch each (see Prepared): each group streams the weights again.
// The weight stream does not depend on the activations: only the (B, C) and
// (B, G/2) vectors carry the layer-to-layer dependency.
//
// What the design does about that.
//  * One kernel for the whole stack, launched with
//    cudaLaunchCooperativeKernel, one block of 256 threads an SM (the grid is
//    sized from the device's SM count and the occupancy query). The blocks
//    loop over the L layers and the two phases of each: the gate (a GEMV over
//    the k*C reduction rows of wtap, 64 column PAIRS (i, i + G/2) a tile so
//    the GLU needs no exchange) and the projection over the S + C columns of
//    [wskip | wout] (128 columns a tile). Phases are separated by
//    cooperative_groups' grid barrier, 2*L a step.
//  * A static map from block to weight slice: block b owns tile b % tiles and
//    reduction slice b / tiles of EVERY layer's gate, and likewise of every
//    layer's projection (6 x 22 = 132 gate slices of 108 rows and 8 x 16 =
//    128 projection slices of 24 rows at the vctk_wavenet width on 132 SMs).
//    So a block knows its whole weight stream at launch: L * (gate slice,
//    projection slice), cut into chunks of 16 rows x 128 columns.
//  * Loads that never stop at a barrier: the chunks pass through a ring of
//    16 stages (8 KB each) in shared memory, filled with cp.async 15 chunks
//    ahead of the one being multiplied, across phase and layer boundaries.
//    While a block waits at a barrier, the next phase's and the next layer's
//    slices are in flight or have landed; the barrier gates only the small
//    activation vectors.
//  * A warp owns 16 columns of the tile: it copies exactly what it
//    multiplies (its lanes are 8 rows x 4 float4s), so each warp runs its
//    own ring with cp.async.wait_group and __syncwarp, and a phase has ONE
//    block barrier (after its inputs are staged). A phase ends in three
//    shuffle steps over the 8 row groups that halve the live batch rows each
//    time. Batch rows are registers (acc[BT][4], BT = the group's B
//    rounded up to a power of two, at most 32).
//  * No last-block combine, no counters, no memsets. A phase's blocks write
//    their slice's partial sums to scratch and go to the barrier. The
//    consumers sum the slices, in a fixed order, while they stage their
//    inputs: the projection's blocks add cond and bias and apply the GLU for
//    their 24 rows of h; the next layer's gate blocks apply the residual
//    update for their rows of x (those of column tile 0 also write
//    x_all[l]); the skip sums of layer l-1 are made during layer l's
//    projection by the blocks that phase leaves idle (the projection's
//    partial sums alternate between two buffers for that). Blocks of
//    different column tiles recompute the same few activations with the same
//    sequence of operations, so they agree bit for bit.
//  * What a phase costs is a dependent chain, not bytes: the barrier, one
//    trip to L2 for the partial sums, the operations of a block that runs
//    8 warps on an SM built for 64. So the staging reads float4s (a quarter
//    of the operations), asks for all the slices of a sum before it adds
//    any (see sum_slices4), and the producer's address arithmetic sits at
//    the phase changes, not in the chunk loop.
//  * x, h's partial sums and skip are written by other SMs during the run:
//    they are read with ld.global.cg (L2) and written with __stcg, never
//    through the non-coherent path. Weights, biases, taps, cond and x0 are
//    read-only for the launch.
// Summation order is fixed (rows of a chunk in order within a lane, the
// shuffle tree, then the slices from the last to the first), so results are
// bit-reproducible run to run and differ from the plain PyTorch chain only
// by summation order. The grid barrier is cooperative_groups' own: a
// hand-rolled spin under a plain launch could deadlock when not all blocks
// are resident.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <new>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // 8 warps per block
constexpr int kWarps = kThreads / 32;
constexpr int kTileCols = 128;  // columns of a weight tile
constexpr int kPairs = 64;      // gate: a tile is 64 pairs (i, i + G/2)
constexpr int kChunkRows = 16;  // reduction rows per ring stage
constexpr int kWarpCols = kTileCols / kWarps;  // a warp owns 16 columns
// a stage holds each warp's 16 rows x 16 columns contiguously (1 KB)
constexpr int kWarpChunk = kChunkRows * kWarpCols;
constexpr int kChunkFloats = kWarps * kWarpChunk;
constexpr int kStages = 16;  // ring depth: 15 chunks (120 KB of weights) ahead
constexpr float kSqrtHalf = 0.70710678118654752f;
constexpr int kMaxBatch = 32;

// error codes of the plan, beside cudaError_t values (which are positive)
constexpr int kErrSharedMemory = -1;  // a slice's inputs do not fit
constexpr int kErrTooWide = -2;       // more column tiles than blocks

// One launch computes a GROUP of B <= kMaxBatch streams of a batch of Bs:
// x0, x_out and skip point at the group's first row; taps, cond and x_all
// at the group's first row of their first (layer, tap), with Bs rows from
// one (layer, tap) to the next.
struct StepArgs {
  const float* x0;     // (B, C)
  const float* taps;   // (L, k-1, Bs, C)
  const float* cond;   // (L, Bs, G)
  const float* wtap;   // (L, k, C, G)
  const float* bias;   // (L, G)
  const float* wskip;  // (L, G/2, S)
  const float* bskip;  // (L, S)
  const float* wout;   // (L, G/2, C)
  const float* bout;   // (L, C)
  float* x_out;        // (B, C)
  float* skip;         // (B, S)
  float* x_all;        // (L, Bs, C)
  float* part_gate;    // (splits_g, B, G)
  float* part_proj;    // (2, splits_p, B, S + C): by layer parity
  int L, k, B, C, G, S;
  int Bs;
  int legacy;
  // the static map from block to weight slice
  int tiles_g, splits_g, rows_g;
  int tiles_p, tiles_skip, splits_p, rows_p;
  // floats from one slice of the gate's / the projection's partial sums to
  // the next: B * G and B * (S + C)
  int step_g, step_p;
  // (grid, 2L, 4, 2) stamps of every phase of every block (phase start,
  // inputs staged, products done, partial sums stored), each the global
  // nanosecond timer and the SM's cycle counter; or null
  unsigned long long* stamps;
};

__device__ __forceinline__ float sigmoidf_(float v) {
  return 1.f / (1.f + expf(-v));
}

__device__ __forceinline__ void stamp(const StepArgs& a, int phase, int what) {
  if (a.stamps != nullptr && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
    unsigned long long* at =
        a.stamps +
        ((static_cast<int64_t>(blockIdx.x) * 2 * a.L + phase) * 4 + what) * 2;
    at[0] = t;
    at[1] = static_cast<unsigned long long>(clock64());
  }
}

// 16 bytes global -> shared, through L2 only; zero-fills when !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The projection's partial sums alternate between two buffers by layer
// parity, so layer l-1's stay readable through all of layer l.
__device__ __forceinline__ float* proj_partials(const StepArgs& a, int l) {
  return a.part_proj +
         (l & 1) * static_cast<int64_t>(a.splits_p) * a.step_p;
}

// partial-sum slices loaded together: the projection's (16 at the
// vctk_wavenet width) and, by each of two lanes, half of the gate's (11)
constexpr int kProjBatch = 16;
constexpr int kGateBatch = 12;

__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// Four float4 loads from L2 in one asm statement. A batch of __ldcg calls
// followed by the additions that use them came out of the compiler as load,
// add, load, add, ... through one register: sixteen trips to L2 in a row
// (read off the SASS; 2 us of a 4 us phase). Grouping the loads here and
// adding from the LAST slice to the first (sum_slices4) makes the first
// addition wait for the last load, and the batch goes out together at the
// batch sizes of 8 (the serving width); at 1 and 32 the assembler still
// reorders the loads and serialises them.
__device__ __forceinline__ void ldcg4x4(const float* p0, const float* p1,
                                        const float* p2, const float* p3,
                                        float4* t) {
  asm volatile(
      "ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%16];\n"
      "ld.global.cg.v4.f32 {%4, %5, %6, %7}, [%17];\n"
      "ld.global.cg.v4.f32 {%8, %9, %10, %11}, [%18];\n"
      "ld.global.cg.v4.f32 {%12, %13, %14, %15}, [%19];\n"
      : "=f"(t[0].x), "=f"(t[0].y), "=f"(t[0].z), "=f"(t[0].w), "=f"(t[1].x),
        "=f"(t[1].y), "=f"(t[1].z), "=f"(t[1].w), "=f"(t[2].x), "=f"(t[2].y),
        "=f"(t[2].z), "=f"(t[2].w), "=f"(t[3].x), "=f"(t[3].y), "=f"(t[3].z),
        "=f"(t[3].w)
      : "l"(p0), "l"(p1), "l"(p2), "l"(p3));
}

// Everything a block stages is read four floats at a time: a thread's
// stream of operations, which a block this thinly occupied runs at a few
// cycles each, is what a phase's staging costs, and a float4 quarters it.
//
// The sum of the partial-sum slices first, first + stride, ... below n of
// the float4 at p (slice s lies s * step floats on), batch by batch and
// within a batch from the last slice to the first. The
// kBatch loads of a batch have no condition (past the end they repeat the
// last slice and are dropped) and go out together: one trip to L2, not
// one a slice. Every caller runs this same sequence, so blocks that
// recompute a value agree bit for bit.
template <int kBatch>
__device__ __forceinline__ float4 sum_slices4(const float* p, int64_t step,
                                              int first, int stride, int n) {
  static_assert(kBatch % 4 == 0, "loads go out four at a time");
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = first; s0 < n; s0 += kBatch * stride) {
    float4 t[kBatch];
    const float* q[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      q[i] = p + min(s0 + i * stride, n - 1) * step;
#pragma unroll
    for (int i = 0; i < kBatch; i += 4)
      ldcg4x4(q[i], q[i + 1], q[i + 2], q[i + 3], t + i);
    // last slice first: the first addition needs the last load
#pragma unroll
    for (int i = kBatch - 1; i >= 0; --i) {
      const float4 w = add4(v, t[i]);
      if (s0 + i * stride < n) v = w;
    }
  }
  return v;
}

__device__ __forceinline__ float4 ldg4_scalar(const float* p) {
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

// The input of layer l >= 1 at (b, c .. c + 3), c a multiple of 4: layer
// l-1's residual update from its projection's partial sums. l = L gives the
// stack's output.
__device__ __forceinline__ float4 layer_input4(const StepArgs& a, int l, int b,
                                               int c) {
  const int C = a.C, W = a.S + a.C;
  const float4 xin =
      l == 1 ? ldg4_scalar(a.x0 + b * C + c)
             : __ldcg(reinterpret_cast<const float4*>(
                   a.x_all + (static_cast<int64_t>(l - 1) * a.Bs + b) * C + c));
  const float4 bo = ldg4_scalar(a.bout + static_cast<int64_t>(l - 1) * C + c);
  const float4 v = sum_slices4<kProjBatch>(
      proj_partials(a, l - 1) + static_cast<int64_t>(b) * W + a.S + c,
      a.step_p, 0, 1, a.splits_p);
  const float4 o = add4(xin, add4(v, bo));
  return make_float4(__fmul_rn(o.x, kSqrtHalf), __fmul_rn(o.y, kSqrtHalf),
                     __fmul_rn(o.z, kSqrtHalf), __fmul_rn(o.w, kSqrtHalf));
}

// Layer lp's skip update for the groups of four elements g0, g0 + stride,
// ... of (B, S): each group belongs to the same thread at every layer.
__device__ __forceinline__ void finish_skip(const StepArgs& a, int lp, int g0,
                                            int stride) {
  const int B = a.B, S = a.S, W = a.S + a.C;
  for (int g = g0; 4 * g < B * S; g += stride) {
    const int e = 4 * g, b = e / S, c = e - b * S;
    float4* sk = reinterpret_cast<float4*>(a.skip + e);
    const float4 bs = ldg4_scalar(a.bskip + static_cast<int64_t>(lp) * S + c);
    float4 old = make_float4(0.f, 0.f, 0.f, 0.f);
    if (lp > 0) old = __ldcg(sk);
    const float4 v = sum_slices4<kProjBatch>(
        proj_partials(a, lp) + static_cast<int64_t>(b) * W + c,
        a.step_p, 0, 1, a.splits_p);
    float4 o = add4(old, add4(v, bs));
    if (a.legacy && lp > 0)
      o = make_float4(o.x * kSqrtHalf, o.y * kSqrtHalf, o.z * kSqrtHalf,
                      o.w * kSqrtHalf);
    __stcg(sk, o);
  }
}

// in_s rows lie IS floats apart; at BT = 32 a pad keeps two rows read at
// once off the same banks.
template <int BT>
struct InStride {
  static constexpr int v = BT >= 32 ? BT + 4 : BT;
};

__device__ __forceinline__ void fma_row(float (&acc)[4], float v,
                                        const float4& w) {
  acc[0] = fmaf(v, w.x, acc[0]);
  acc[1] = fmaf(v, w.y, acc[1]);
  acc[2] = fmaf(v, w.z, acc[2]);
  acc[3] = fmaf(v, w.w, acc[3]);
}

// The warp's part of one ring stage (16 rows x its 16 columns) times the
// staged inputs of those rows: lane = (row group 0..7, float4 0..3), each
// lane takes rows group and group + 8. The warp reads 512 contiguous bytes
// at a time, so no two lanes meet on a bank.
template <int BT>
__device__ __forceinline__ void fma_chunk(const float* w_s, const float* in_s,
                                          float (&acc)[BT][4]) {
  constexpr int IS = InStride<BT>::v;
  const int lane = threadIdx.x & 31;
  const int rsub = lane >> 2, c4 = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = rsub + 8 * half;
    const float4 w4 =
        *reinterpret_cast<const float4*>(w_s + r * kWarpCols + c4 * 4);
    const float* in = in_s + r * IS;
    if constexpr (BT >= 4) {
#pragma unroll
      for (int b = 0; b < BT; b += 4) {
        const float4 i4 = *reinterpret_cast<const float4*>(in + b);
        fma_row(acc[b], i4.x, w4);
        fma_row(acc[b + 1], i4.y, w4);
        fma_row(acc[b + 2], i4.z, w4);
        fma_row(acc[b + 3], i4.w, w4);
      }
    } else if constexpr (BT == 2) {
      const float2 i2 = *reinterpret_cast<const float2*>(in);
      fma_row(acc[0], i2.x, w4);
      fma_row(acc[1], i2.y, w4);
    } else {
      fma_row(acc[0], in[0], w4);
    }
  }
}

// One step of the reduction over a warp's 8 row groups, between lanes
// `mask` apart. halve_rows: of the N live batch rows (slots base .. base +
// N - 1) each lane of a pair keeps one half and is sent its partner's sums
// for it, so a step moves N / 2 rows, not N. plain_rows adds all N both
// ways (for the steps left over when BT < 8).
template <int BT, int N>
__device__ __forceinline__ void halve_rows(float (&acc)[BT][4], int base,
                                           bool upper, int mask) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float lo = acc[base + i][j], hi = acc[base + i + N / 2][j];
      const float send = upper ? lo : hi, keep = upper ? hi : lo;
      acc[base + i][j] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
    }
}
template <int BT, int N>
__device__ __forceinline__ void plain_rows(float (&acc)[BT][4], int mask) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], mask);
}

// Sum the 8 row groups of a warp, in a fixed tree, and store batch row b's
// float4 to dst + b * ld + col. After the three steps the lane of row group
// g holds the total of batch row 8 * m + g in slot 8 * m (BT >= 8), or of
// row g % BT in slot 0.
template <int BT>
__device__ __forceinline__ void reduce_store(float (&acc)[BT][4], float* dst,
                                             int ld, int col, bool valid,
                                             int B) {
  const int lane = threadIdx.x & 31, rsub = lane >> 2;
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  if constexpr (BT >= 8) {
#pragma unroll
    for (int base = 0; base < BT; base += 8) {
      halve_rows<BT, 8>(acc, base, b4, 16);
      halve_rows<BT, 4>(acc, base, b3, 8);
      halve_rows<BT, 2>(acc, base, b2, 4);
      const int b = base + rsub;
      if (b < B && valid)
        __stcg(reinterpret_cast<float4*>(dst + static_cast<int64_t>(b) * ld +
                                         col),
               make_float4(acc[base][0], acc[base][1], acc[base][2],
                           acc[base][3]));
    }
  } else {
    bool owner;
    if constexpr (BT == 4) {
      plain_rows<BT, 4>(acc, 16);
      halve_rows<BT, 4>(acc, 0, b3, 8);
      halve_rows<BT, 2>(acc, 0, b2, 4);
      owner = !b4;
    } else if constexpr (BT == 2) {
      plain_rows<BT, 2>(acc, 16);
      plain_rows<BT, 2>(acc, 8);
      halve_rows<BT, 2>(acc, 0, b2, 4);
      owner = !b4 && !b3;
    } else {
      plain_rows<BT, 1>(acc, 16);
      plain_rows<BT, 1>(acc, 8);
      plain_rows<BT, 1>(acc, 4);
      owner = rsub == 0;
    }
    const int b = rsub & (BT - 1);
    if (owner && b < B && valid)
      __stcg(reinterpret_cast<float4*>(dst + static_cast<int64_t>(b) * ld + col),
             make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]));
  }
}

// A block's slice of the gate's reduction: rows r0 .. r0 + rows - 1 of the
// k * C, of which the first n_tap are history taps and the rest tap k-1,
// the layer's input; `padded` rows are staged (whole chunks).
struct GateSlice {
  int r0, rows, n_tap, padded;
  bool writes_x_all;  // column tile 0's blocks cover every (b, c) once
};

// Stage in_s[r][b] for the slice's rows r (reduction row r0 + r = j * C + c)
// at layer l: a warp takes a batch row, its lanes four rows each (r0, rows
// and n_tap are multiples of 4, so a group of four is of one kind). Rows
// past the slice and batch rows past B are zero.
template <int BT>
__device__ __forceinline__ void stage_gate(const StepArgs& a, int l,
                                           const GateSlice& gs, float* in_s) {
  constexpr int IS = InStride<BT>::v;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int B = a.B, Bs = a.Bs, C = a.C, k = a.k;
  for (int b = warp; b < BT; b += kWarps) {
    for (int r = 4 * lane; r < gs.padded; r += 128) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (b < B && r < gs.rows) {
        if (r < gs.n_tap) {
          const int rg = gs.r0 + r, j = rg / C, c = rg - j * C;
          v = ldg4_scalar(
              a.taps +
              ((static_cast<int64_t>(l) * (k - 1) + j) * Bs + b) * C + c);
        } else {
          const int c = gs.r0 + r - (k - 1) * C;
          v = l == 0 ? ldg4_scalar(a.x0 + b * C + c) : layer_input4(a, l, b, c);
          if (gs.writes_x_all)
            __stcg(reinterpret_cast<float4*>(
                       a.x_all + (static_cast<int64_t>(l) * Bs + b) * C + c),
                   v);
        }
      }
      float* d = in_s + r * IS + b;
      d[0] = v.x;
      d[IS] = v.y;
      d[2 * IS] = v.z;
      d[3 * IS] = v.w;
    }
  }
}

template <int BT>
__global__ void __launch_bounds__(kThreads, 1) step_kernel(const StepArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                 // [kStages][kWarps][16 rows][16 cols]
  float* in_s = smem + kStages * kChunkFloats; // [padded rows][IS]
  constexpr int IS = InStride<BT>::v;
  constexpr int kLogBT = BT == 1 ? 0 : BT == 2 ? 1 : BT == 4 ? 2
                       : BT == 8 ? 3 : BT == 16 ? 4 : 5;

  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int blk = blockIdx.x;
  const int B = a.B, C = a.C, G = a.G, Gh = G / 2, S = a.S, k = a.k, L = a.L;
  const int R = k * C;

  // this block's slice of every layer's gate and projection
  const bool act_g = blk < a.tiles_g * a.splits_g;
  const int tile_g = blk % a.tiles_g, split_g = blk / a.tiles_g;
  const int g_r0 = split_g * a.rows_g;
  const int g_rows = act_g ? min(a.rows_g, R - g_r0) : 0;
  const int ncg = (g_rows + kChunkRows - 1) / kChunkRows;
  // rows of the slice that are history taps (the rest are tap k-1)
  const int n_tap = max(0, min(g_rows, (k - 1) * C - g_r0));
  // The skip sums of layer l-1 are made during layer l's projection, by
  // the blocks that phase leaves idle (at the vctk_wavenet width 4 of 132;
  // the sums then cost the others nothing), or by all when none is idle.
  const int used_p = a.tiles_p * a.splits_p;
  const int idle_p = static_cast<int>(gridDim.x) - used_p;
  const bool skip_worker = idle_p == 0 || blk >= used_p;
  const int skip_g0 =
      (idle_p == 0 ? tid * static_cast<int>(gridDim.x) + blk
                   : tid * idle_p + blk - used_p);
  const int skip_stride = (idle_p == 0 ? gridDim.x : idle_p) * kThreads;
  const bool act_p = blk < a.tiles_p * a.splits_p;
  const int tile_p = blk % a.tiles_p, split_p = blk / a.tiles_p;
  const bool is_skip = tile_p < a.tiles_skip;
  const int p_cols = is_skip ? S : C;
  const int p_c0 = (is_skip ? tile_p : tile_p - a.tiles_skip) * kTileCols;
  const int p_r0 = split_p * a.rows_p;
  const int p_rows = act_p ? min(a.rows_p, Gh - p_r0) : 0;
  const int ncp = (p_rows + kChunkRows - 1) / kChunkRows;

  // A warp copies what it multiplies, its own 16 columns of every chunk, so
  // the warps share nothing of the ring and never wait for each other. The
  // two float4s this lane copies: rows lane / 4 and lane / 4 + 8, tile
  // columns q .. q + 3 (the columns it accumulates).
  const int q = warp * kWarpCols + (lane & 3) * 4, crow = lane >> 2;
  const int g_pair = tile_g * kPairs + (q & (kPairs - 1));
  const bool g_ok = g_pair < Gh;
  const int g_col = g_pair + (q >= kPairs ? Gh : 0);
  const int p_col = p_c0 + q;
  const bool p_ok = p_col < p_cols;
  const float* w_proj = is_skip ? a.wskip : a.wout;

  // The producer's cursor over this block's weight stream: the lane's
  // first float4 of the next chunk, the rows the phase's slice still holds
  // from there on, and the row pitch. A chunk costs two copies and two
  // additions; the arithmetic sits at the phase changes.
  int pl = 0, pphase = 0, prows = 0, pslot = 0, cslot = 0;
  int64_t ppitch = 0;
  bool pcols = false;
  const float* psrc = a.wtap;
  auto begin_phase = [&]() {
    if (pphase == 0) {
      psrc = a.wtap + (static_cast<int64_t>(pl) * R + g_r0 + crow) * G + g_col;
      prows = g_rows;
      ppitch = G;
      pcols = g_ok;
    } else {
      psrc = w_proj +
             (static_cast<int64_t>(pl) * Gh + p_r0 + crow) * p_cols + p_col;
      prows = p_rows;
      ppitch = p_cols;
      pcols = p_ok;
    }
  };
  auto next_phase = [&]() {  // on to the next phase in which it has rows
    do {
      if (pphase == 0) {
        pphase = 1;
      } else {
        pphase = 0;
        ++pl;
      }
      if (pl < L) begin_phase();
    } while (pl < L && prows <= 0);
  };
  float* const ring_lane =
      ring + warp * kWarpChunk + crow * kWarpCols + (lane & 3) * 4;
  auto enqueue = [&]() {  // one chunk, one commit group (empty past the end)
    if (pl < L) {
      float* dst = ring_lane + pslot * kChunkFloats;
      const bool ok0 = pcols && crow < prows, ok1 = pcols && crow + 8 < prows;
      cp_async16(dst, ok0 ? psrc : a.wtap, ok0);
      cp_async16(dst + 8 * kWarpCols, ok1 ? psrc + 8 * ppitch : a.wtap, ok1);
      psrc += kChunkRows * ppitch;
      prows -= kChunkRows;
      if (prows <= 0) next_phase();
    }
    cp_async_commit();
    pslot = pslot + 1 == kStages ? 0 : pslot + 1;
  };
  // The warp's part of the next chunk of the stream, landed: waits for it,
  // refills the stage the previous call handed out (the warp's lanes have
  // all left it) and returns this one. Warp-local: no block barrier.
  auto next_chunk = [&]() -> const float* {
    cp_async_wait<kStages - 2>();
    __syncwarp();
    enqueue();
    const float* w = ring + (cslot * kWarps + warp) * kWarpChunk;
    cslot = cslot + 1 == kStages ? 0 : cslot + 1;
    return w;
  };

  begin_phase();
  if (prows <= 0) next_phase();
#pragma unroll 1
  for (int i = 0; i < kStages - 1; ++i) enqueue();


  float acc[BT][4];
  for (int l = 0; l < L; ++l) {
    // ---- gate: acc = [taps | x] @ wtap[l], this block's rows and columns
    stamp(a, 2 * l, 0);
    if (ncg > 0) {
      const GateSlice gs = {g_r0, g_rows, n_tap, ncg * kChunkRows,
                            tile_g == 0};
      stage_gate<BT>(a, l, gs, in_s);
#pragma unroll
      for (int b = 0; b < BT; ++b)
        acc[b][0] = acc[b][1] = acc[b][2] = acc[b][3] = 0.f;
      __syncthreads();  // in_s is staged by all warps and read by all
      stamp(a, 2 * l, 1);
      for (int ci = 0; ci < ncg; ++ci)
        fma_chunk<BT>(next_chunk(), in_s + ci * kChunkRows * IS, acc);
      stamp(a, 2 * l, 2);
      reduce_store<BT>(acc, a.part_gate + static_cast<int64_t>(split_g) * a.step_g,
                       G, g_col, g_ok, B);
    }
    stamp(a, 2 * l, 3);
    grid.sync();

    // ---- projection: acc = h @ [wskip | wout][l]; h from the gate's
    // partial sums, in slice order, with cond, bias and the GLU
    stamp(a, 2 * l + 1, 0);
    if (ncp > 0) {
      // Four lanes share a group of four pairs of one batch row: each sums
      // the even or the odd slices of the filter or the gate half (a
      // quarter of the loads), two shuffles join them, and each lane then
      // finishes one pair.
      const int padded = ncp * kChunkRows;
      const int items = BT * ((padded + 31) >> 5);  // (batch row, 32 rows)
      const int sub = lane & 3, half = sub & 1, parity = sub >> 1;
      for (int it = warp; it < items; it += kWarps) {
        const int b = it & (BT - 1);
        const int r = ((it >> kLogBT) << 5) + ((lane >> 2) << 2);
        const bool in = r < padded, ok = in && b < B && r < p_rows;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 cb = v;
        if (ok) {
          const int col = half * Gh + p_r0 + r;
          const float4 cd =
              ldg4_scalar(a.cond + (static_cast<int64_t>(l) * a.Bs + b) * G + col);
          const float4 bs =
              ldg4_scalar(a.bias + static_cast<int64_t>(l) * G + col);
          cb = add4(cd, bs);
          v = sum_slices4<kGateBatch>(
              a.part_gate + static_cast<int64_t>(b) * G + col,
              a.step_g, parity, 2, a.splits_g);
        }
        // even slices + odd slices (either order gives the same bits)
        v.x = __fadd_rn(v.x, __shfl_xor_sync(0xffffffffu, v.x, 2));
        v.y = __fadd_rn(v.y, __shfl_xor_sync(0xffffffffu, v.y, 2));
        v.z = __fadd_rn(v.z, __shfl_xor_sync(0xffffffffu, v.z, 2));
        v.w = __fadd_rn(v.w, __shfl_xor_sync(0xffffffffu, v.w, 2));
        v = add4(v, cb);
        // this lane's pair: its own half and the neighbour's
        const float mine = sub == 0 ? v.x : sub == 1 ? v.y : sub == 2 ? v.z : v.w;
        const float4 o = make_float4(__shfl_xor_sync(0xffffffffu, v.x, 1),
                                     __shfl_xor_sync(0xffffffffu, v.y, 1),
                                     __shfl_xor_sync(0xffffffffu, v.z, 1),
                                     __shfl_xor_sync(0xffffffffu, v.w, 1));
        const float other = sub == 0 ? o.x : sub == 1 ? o.y : sub == 2 ? o.z : o.w;
        const float ga = half ? other : mine, gb = half ? mine : other;
        if (in)
          in_s[(r + sub) * IS + b] = ok ? tanhf(ga) * sigmoidf_(gb) : 0.f;
      }
#pragma unroll
      for (int b = 0; b < BT; ++b)
        acc[b][0] = acc[b][1] = acc[b][2] = acc[b][3] = 0.f;
      __syncthreads();
      stamp(a, 2 * l + 1, 1);
      for (int ci = 0; ci < ncp; ++ci)
        fma_chunk<BT>(next_chunk(), in_s + ci * kChunkRows * IS, acc);
      stamp(a, 2 * l + 1, 2);
      reduce_store<BT>(
          acc, proj_partials(a, l) + static_cast<int64_t>(split_p) * a.step_p,
          S + C, is_skip ? p_col : S + p_col, p_ok, B);
    }
    if (l > 0 && skip_worker) finish_skip(a, l - 1, skip_g0, skip_stride);
    stamp(a, 2 * l + 1, 3);
    grid.sync();
  }
  cp_async_wait<0>();

  // the last layer's skip and residual updates, spread over the grid
  const int g0 = tid * static_cast<int>(gridDim.x) + blk;
  const int stride = gridDim.x * kThreads;
  finish_skip(a, L - 1, g0, stride);
  for (int g = g0; 4 * g < B * C; g += stride) {
    const int e = 4 * g, b = e / C, c = e - b * C;
    __stcg(reinterpret_cast<float4*>(a.x_out + e), layer_input4(a, L, b, c));
  }
}

using StepKernel = void (*)(StepArgs);

// BT: the batch rounded up to a power of two, the kernel's register tile.
int batch_tile(int B) {
  int bt = 1;
  while (bt < B) bt *= 2;
  return bt;
}

StepKernel kernel_for(int bt) {
  switch (bt) {
    case 1: return step_kernel<1>;
    case 2: return step_kernel<2>;
    case 4: return step_kernel<4>;
    case 8: return step_kernel<8>;
    case 16: return step_kernel<16>;
    default: return step_kernel<32>;
  }
}

int in_stride(int bt) { return bt >= 32 ? bt + 4 : bt; }

int ceil_div(int a, int b) { return (a + b - 1) / b; }

struct Plan {
  StepKernel fn;
  int grid;
  size_t smem;
  size_t scratch_floats;
};

// The static map for these shapes on the current device: fills the map
// fields of `a` and the launch's grid and shared memory. Returns 0, a
// cudaError_t, or one of the kErr codes.
int make_plan(StepArgs* a, Plan* p) {
  const int L = a->L, k = a->k, B = a->B, C = a->C, G = a->G, S = a->S;
  if (L < 1 || k < 1 || B < 1 || B > kMaxBatch || G < 8 || G % 8 || C < 4 ||
      C % 4 || S < 4 || S % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(k) * C > INT32_MAX / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, coop = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);

  const int bt = batch_tile(B);
  p->fn = kernel_for(bt);
  const size_t ring_bytes = sizeof(float) * kStages * kChunkFloats;
  if (ring_bytes > static_cast<size_t>(max_smem)) return kErrSharedMemory;
  err = cudaFuncSetAttribute(p->fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             max_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, p->fn, kThreads,
                                                      ring_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return kErrSharedMemory;
  const int blocks = sms * per_sm;

  const int Gh = G / 2, R = k * C;
  a->tiles_g = ceil_div(Gh, kPairs);
  a->tiles_skip = ceil_div(S, kTileCols);
  a->tiles_p = a->tiles_skip + ceil_div(C, kTileCols);
  if (a->tiles_g > blocks || a->tiles_p > blocks) return kErrTooWide;
  // as many reduction slices as blocks allow, none under one chunk of rows
  int splits = blocks / a->tiles_g;
  if (splits > ceil_div(R, kChunkRows)) splits = ceil_div(R, kChunkRows);
  // slices of a multiple of four rows: the staging reads float4s
  a->rows_g = ceil_div(ceil_div(R, splits), 4) * 4;
  a->splits_g = ceil_div(R, a->rows_g);
  splits = blocks / a->tiles_p;
  if (splits > ceil_div(Gh, kChunkRows)) splits = ceil_div(Gh, kChunkRows);
  a->rows_p = ceil_div(ceil_div(Gh, splits), 4) * 4;
  a->splits_p = ceil_div(Gh, a->rows_p);

  const int used_g = a->tiles_g * a->splits_g, used_p = a->tiles_p * a->splits_p;
  p->grid = used_g > used_p ? used_g : used_p;
  const int rows = a->rows_g > a->rows_p ? a->rows_g : a->rows_p;
  const size_t in_floats = static_cast<size_t>(ceil_div(rows, kChunkRows)) *
                           kChunkRows * in_stride(bt);
  p->smem = ring_bytes + sizeof(float) * in_floats;
  if (p->smem > static_cast<size_t>(max_smem)) return kErrSharedMemory;
  // every block of a cooperative launch must be resident at once
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, p->fn, kThreads,
                                                      p->smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sms * per_sm < p->grid) return kErrSharedMemory;
  a->step_g = B * G;
  a->step_p = B * (S + C);
  p->scratch_floats = static_cast<size_t>(a->splits_g) * a->step_g +
                      2 * static_cast<size_t>(a->splits_p) * a->step_p;
  return 0;
}

// A batch of more than kMaxBatch streams runs as groups of kMaxBatch and a
// last group of the rest, one launch each, in order on one stream. Streams
// are independent through the whole stack, so the groups need nothing of
// each other; they share the scratch (a launch finishes with its partial
// sums before the next starts), and each group streams every weight again.
// Plan 0 is a full group's (the whole batch when there is one group), plan 1
// the last group's.
struct Prepared {
  StepArgs args[2];
  Plan plan[2];
  int groups;
};

int group_count(int B) { return ceil_div(B, kMaxBatch); }

}  // namespace

// Bytes of scratch one prepared step needs on the current device (a
// 16-byte multiple) into *bytes; returns 0, a cudaError_t, -1 when a
// block's slice of the inputs does not fit shared memory, or -2 when the
// widths give more column tiles than the device runs blocks.
extern "C" int wavenet_step_scratch_bytes(int L, int k, int B, int C, int G,
                                          int S, size_t* bytes) {
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  StepArgs a = {};
  a.L = L; a.k = k; a.B = B < kMaxBatch ? B : kMaxBatch; a.C = C; a.G = G;
  a.S = S; a.Bs = B;
  Plan p;
  const int err = make_plan(&a, &p);
  if (err != 0) return err;
  *bytes = (sizeof(float) * p.scratch_floats + 15) / 16 * 16;
  return 0;
}

// Plans the step for these shapes on the current device and binds the
// weights, outputs and scratch (wavenet_step_scratch_bytes of it). Returns
// a handle for wavenet_step_run and wavenet_step_release into *handle, and
// an error code as wavenet_step_scratch_bytes does. wtap, wskip, wout, the
// three outputs and scratch must be 16-byte aligned.
extern "C" int wavenet_step_prepare(const float* wtap, const float* bias,
                                    const float* wskip, const float* bskip,
                                    const float* wout, const float* bout,
                                    int L, int k, int B, int C, int G, int S,
                                    int legacy, float* x_out, float* skip,
                                    float* x_all, void* scratch,
                                    void** handle) {
  for (const void* p : {static_cast<const void*>(wtap),
                        static_cast<const void*>(wskip),
                        static_cast<const void*>(wout),
                        static_cast<const void*>(x_out),
                        static_cast<const void*>(skip),
                        static_cast<const void*>(x_all),
                        static_cast<const void*>(scratch)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  Prepared* h = new (std::nothrow) Prepared();
  if (h == nullptr) return static_cast<int>(cudaErrorMemoryAllocation);
  h->groups = group_count(B);
  for (int i = 0; i < 2; ++i) {
    StepArgs& a = h->args[i];
    a.wtap = wtap; a.bias = bias; a.wskip = wskip; a.bskip = bskip;
    a.wout = wout; a.bout = bout;
    a.x_out = x_out; a.skip = skip; a.x_all = x_all;
    a.L = L; a.k = k; a.C = C; a.G = G; a.S = S; a.legacy = legacy;
    a.B = i == 0 && h->groups > 1 ? kMaxBatch
                                  : B - (h->groups - 1) * kMaxBatch;
    a.Bs = B;
    const int err = make_plan(&a, &h->plan[i]);
    if (err != 0) {
      delete h;
      return err;
    }
    a.part_gate = static_cast<float*>(scratch);
    a.part_proj = a.part_gate + static_cast<size_t>(a.splits_g) * a.step_g;
  }
  *handle = h;
  return 0;
}

// One decode step through the whole stack on `stream`: ONE cooperative
// kernel launch a group of kMaxBatch streams (wavenet_step_describe's
// launches), no memset, no copy. Returns the first failed launch's
// cudaError_t, or 0. With `stamps` (grid * 2L * 4 * 2 uint64 on the
// device) every block of the FIRST group's launch also records when each
// of its phases starts, has its inputs staged, has its products done and
// has its partial sums stored: the global nanosecond timer (coarse, common
// to all SMs) and the SM's cycle counter (fine).
extern "C" int wavenet_step_run(void* handle, const float* x0,
                                const float* taps, const float* cond,
                                unsigned long long* stamps, void* stream) {
  Prepared* h = static_cast<Prepared*>(handle);
  for (int g = 0; g < h->groups; ++g) {
    const int i = g + 1 == h->groups ? 1 : 0;
    StepArgs a = h->args[i];
    const int64_t b0 = static_cast<int64_t>(g) * kMaxBatch;
    a.x0 = x0 + b0 * a.C;
    a.taps = taps + b0 * a.C;
    a.cond = cond + b0 * a.G;
    a.x_out += b0 * a.C;
    a.skip += b0 * a.S;
    a.x_all += b0 * a.C;
    a.stamps = g == 0 ? stamps : nullptr;
    void* params[] = {&a};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(h->plan[i].fn), dim3(h->plan[i].grid),
        dim3(kThreads), params, h->plan[i].smem,
        static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The first group's launch shape, for reports: blocks, bytes of shared
// memory a block, gate and projection slices (tiles x splits, rows a
// slice); then the launches a step (groups of kMaxBatch streams).
extern "C" void wavenet_step_describe(void* handle, int* out) {
  const Prepared* h = static_cast<const Prepared*>(handle);
  const StepArgs& a = h->args[0];
  out[0] = h->plan[0].grid;
  out[1] = static_cast<int>(h->plan[0].smem);
  out[2] = a.tiles_g; out[3] = a.splits_g; out[4] = a.rows_g;
  out[5] = a.tiles_p; out[6] = a.splits_p; out[7] = a.rows_p;
  out[8] = h->groups;
}

extern "C" void wavenet_step_release(void* handle) {
  delete static_cast<Prepared*>(handle);
}
