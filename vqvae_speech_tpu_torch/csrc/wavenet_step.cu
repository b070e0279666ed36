// Fused WaveNet GLU layer stack for one autoregressive decode step, Hopper
// (sm_90a), f32.
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
// What bounds it on an H100: one step streams every layer's weights once,
// 4*L*(k*C*G + G/2*(S+C)) bytes = 173 MB at the vctk_wavenet width
// (L=20, k=3, C=G=768, S=256), more than three times the 50 MB L2, while
// doing 2*B flops per weight element, i.e. at most 2*B/4 flops a byte. At
// B <= 8 that is far below the card's f32 rate per byte, so a step is bound
// by device-memory bandwidth: about 52 us at 3.35 TB/s.
//
// What the design does about that. The layers are sequential, the columns
// are not, so each layer is two kernels on the caller's stream (one C entry
// point launches all 2*L of them):
//  (a) glu_gate_kernel: block (t, s) owns 64 column PAIRS (i, i + G/2) of
//      the gate, so the GLU fuses into its epilogue, and one 96-row slice
//      of the k*C-row reduction. G/2 = 384 pairs alone would give 6 blocks;
//      splitting the reduction gives 6 x 24 = 144 blocks, which fills the
//      132 SMs. Each half-warp reads 64 consecutive columns of a weight row
//      as float4s (256 contiguous bytes), the B input rows of the slice sit
//      in shared memory, and the 8 warps' partial sums meet in shared memory
//      in a fixed order. Partials go to scratch; the LAST block of each
//      column tile to finish (an integer atomic counter, no float atomics)
//      sums the slices in slice order, adds cond and bias and writes h.
//  (b) glu_proj_kernel: the same scheme over the S + C columns of
//      [wskip | wout] with 24-row slices of the G/2-row reduction; the last
//      block of each column tile applies the skip update or the residual
//      update and writes the next layer's input into x_all[l + 1] (or x).
// Summation order is fixed, so results are bit-reproducible run to run and
// differ from the plain PyTorch chain only by summation order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // 8 warps per block
constexpr int kWarps = kThreads / 32;
constexpr int kPairsPerTile = 64; // gate: 64 pairs = 128 columns per tile
constexpr int kColsPerTile = 128; // projection: 128 columns per tile
constexpr int kRowsGate = 96;     // gate reduction rows per block
constexpr int kRowsProj = 24;     // projection reduction rows per block
constexpr int kBChunk = 8;        // batch rows per cross-warp reduction pass
constexpr float kSqrtHalf = 0.70710678118654752f;

__device__ __forceinline__ float sigmoidf_(float v) {
  return 1.f / (1.f + expf(-v));
}

// The 8 warps hold acc[BT][4] for the same 128 columns (lane*4 .. +3) over
// different rows; sum them in warp order and store row b's 128 values into
// out + b * out_stride (cols[q] maps the tile's column q to its global
// column, -1 where masked).
template <int BT>
__device__ __forceinline__ void reduce_warps(float (&acc)[BT][4],
                                             float (*red)[kBChunk][128],
                                             int B, float* out,
                                             int64_t out_stride,
                                             const int* cols) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int b0 = 0; b0 < BT; b0 += kBChunk) {
#pragma unroll
    for (int bb = 0; bb < kBChunk; ++bb) {
      if (b0 + bb < BT) {
        float4 v = make_float4(acc[b0 + bb][0], acc[b0 + bb][1],
                               acc[b0 + bb][2], acc[b0 + bb][3]);
        *reinterpret_cast<float4*>(&red[warp][bb][lane * 4]) = v;
      }
    }
    __syncthreads();
    for (int i = tid; i < kBChunk * 128; i += kThreads) {
      const int bb = i >> 7, q = i & 127, b = b0 + bb;
      if (b < B && cols[q] >= 0) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += red[w][bb][q];
        out[b * out_stride + cols[q]] = s;
      }
    }
    __syncthreads();
  }
}

// Each block stages the inputs of its reduction rows, in_s[r * BT + b]
// (zero for b >= B), then every warp walks rows warp, warp + 8, ... with
// each lane multiplying 4 columns (one float4 of the weight row).
template <int BT>
__device__ __forceinline__ void gemv_rows(const float* in_s, int rows,
                                          const float* w_rows, int64_t ldw,
                                          int col, bool valid,
                                          float (&acc)[BT][4]) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int b = 0; b < BT; ++b)
    acc[b][0] = acc[b][1] = acc[b][2] = acc[b][3] = 0.f;
  if (!valid) return;
  int r = warp;
  // four rows in flight per warp
  for (; r + 3 * kWarps < rows; r += 4 * kWarps) {
    float4 w4[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      w4[u] = __ldg(reinterpret_cast<const float4*>(
          w_rows + (r + u * kWarps) * ldw + col));
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* in = in_s + (r + u * kWarps) * BT;
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        const float v = in[b];
        acc[b][0] = fmaf(v, w4[u].x, acc[b][0]);
        acc[b][1] = fmaf(v, w4[u].y, acc[b][1]);
        acc[b][2] = fmaf(v, w4[u].z, acc[b][2]);
        acc[b][3] = fmaf(v, w4[u].w, acc[b][3]);
      }
    }
  }
  for (; r < rows; r += kWarps) {
    const float4 w4 =
        __ldg(reinterpret_cast<const float4*>(w_rows + r * ldw + col));
    const float* in = in_s + r * BT;
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      const float v = in[b];
      acc[b][0] = fmaf(v, w4.x, acc[b][0]);
      acc[b][1] = fmaf(v, w4.y, acc[b][1]);
      acc[b][2] = fmaf(v, w4.z, acc[b][2]);
      acc[b][3] = fmaf(v, w4.w, acc[b][3]);
    }
  }
}

// True in every thread of the block that finishes its column tile last.
// Every thread fences its own partial-sum stores before the block's
// arrival is counted, so the last block sees all of them.
__device__ __forceinline__ bool last_block_of_tile(int* counter, int n_splits) {
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(counter, 1) == n_splits - 1;
  __syncthreads();
  if (is_last) __threadfence();
  return is_last;
}

struct StepArgs {
  const float* taps;   // (L, k-1, B, C)
  const float* cond;   // (L, B, G)
  const float* wtap;   // (L, k, C, G)
  const float* bias;   // (L, G)
  const float* wskip;  // (L, G/2, S)
  const float* bskip;  // (L, S)
  const float* wout;   // (L, G/2, C)
  const float* bout;   // (L, C)
  float* x_out;        // (B, C)
  float* skip;         // (B, S), zeroed before layer 0
  float* x_all;        // (L, B, C); x_all[0] = x0 before layer 0
  float* part_gate;    // (splits_gate, B, G)
  float* h;            // (B, G/2)
  float* part_proj;    // (splits_proj, B, S + C)
  int* counters;       // (L, tiles_gate + tiles_proj), zeroed
  int L, k, B, C, G, S;
  int legacy;
};

template <int BT>
__global__ void __launch_bounds__(kThreads)
glu_gate_kernel(StepArgs a, int l, int* counters) {
  __shared__ __align__(16) float red[kWarps][kBChunk][128];
  __shared__ float in_s[kRowsGate * BT];
  __shared__ int cols[128];

  const int tid = threadIdx.x, lane = tid & 31;
  const int B = a.B, C = a.C, G = a.G, Gh = G / 2, k = a.k;
  const int R = k * C;
  const int tile = blockIdx.x, split = blockIdx.y;
  const int r0 = split * kRowsGate;
  const int rows = min(kRowsGate, R - r0);
  const float* x = a.x_all + static_cast<int64_t>(l) * B * C;

  // stage this slice's inputs: row r = j*C + c reads taps[l, j, b, c] for
  // j < k-1 and the layer input x[b, c] for j = k-1
  for (int i = tid; i < rows * BT; i += kThreads) {
    const int b = i / rows, rl = i - b * rows;
    float v = 0.f;
    if (b < B) {
      const int r = r0 + rl, j = r / C, c = r - j * C;
      v = j < k - 1
              ? a.taps[((static_cast<int64_t>(l) * (k - 1) + j) * B + b) * C + c]
              : x[b * C + c];
    }
    in_s[rl * BT + b] = v;
  }
  // lanes 0-15 take pairs' first columns, lanes 16-31 their partners
  const int pair = tile * kPairsPerTile + (lane & 15) * 4;
  const bool valid = pair < Gh;
  const int col = pair + ((lane >> 4) ? Gh : 0);
  if (tid < 128) {
    const int p = tile * kPairsPerTile + (tid & 63);
    cols[tid] = p < Gh ? p + ((tid >> 6) ? Gh : 0) : -1;
  }
  __syncthreads();

  float acc[BT][4];
  const float* w_rows = a.wtap + (static_cast<int64_t>(l) * R + r0) * G;
  gemv_rows<BT>(in_s, rows, w_rows, G, col, valid, acc);
  float* part = a.part_gate + static_cast<int64_t>(split) * B * G;
  reduce_warps<BT>(acc, red, B, part, G, cols);

  const int n_splits = gridDim.y;
  if (!last_block_of_tile(counters + tile, n_splits)) return;
  // combine the slices in slice order, add conditioning and bias, GLU
  for (int i = tid; i < B * kPairsPerTile; i += kThreads) {
    const int b = i / kPairsPerTile;
    const int p = tile * kPairsPerTile + (i - b * kPairsPerTile);
    if (p >= Gh) continue;
    float ga = 0.f, gb = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float* ps = a.part_gate + (static_cast<int64_t>(s) * B + b) * G;
      ga += __ldcg(ps + p);
      gb += __ldcg(ps + Gh + p);
    }
    const float* cd = a.cond + (static_cast<int64_t>(l) * B + b) * G;
    const float* bs = a.bias + static_cast<int64_t>(l) * G;
    ga += cd[p] + bs[p];
    gb += cd[Gh + p] + bs[Gh + p];
    a.h[b * Gh + p] = tanhf(ga) * sigmoidf_(gb);
  }
}

template <int BT>
__global__ void __launch_bounds__(kThreads)
glu_proj_kernel(StepArgs a, int l, int* counters) {
  __shared__ __align__(16) float red[kWarps][kBChunk][128];
  __shared__ float in_s[kRowsProj * BT];
  __shared__ int cols[128];

  const int tid = threadIdx.x, lane = tid & 31;
  const int B = a.B, C = a.C, Gh = a.G / 2, S = a.S;
  const int tiles_skip = (S + kColsPerTile - 1) / kColsPerTile;
  const int tile = blockIdx.x, split = blockIdx.y;
  const bool is_skip = tile < tiles_skip;
  const int ncols = is_skip ? S : C;
  const int c0 = (is_skip ? tile : tile - tiles_skip) * kColsPerTile;
  const int r0 = split * kRowsProj;
  const int rows = min(kRowsProj, Gh - r0);

  for (int i = tid; i < rows * BT; i += kThreads) {
    const int b = i / rows, rl = i - b * rows;
    in_s[rl * BT + b] = b < B ? a.h[b * Gh + r0 + rl] : 0.f;
  }
  const int col = c0 + lane * 4;
  const bool valid = col < ncols;
  if (tid < 128) {
    // global column in the concatenated [skip | out] space
    const int c = c0 + tid;
    cols[tid] = c < ncols ? (is_skip ? c : S + c) : -1;
  }
  __syncthreads();

  float acc[BT][4];
  const float* w = is_skip ? a.wskip + static_cast<int64_t>(l) * Gh * S
                           : a.wout + static_cast<int64_t>(l) * Gh * C;
  gemv_rows<BT>(in_s, rows, w + static_cast<int64_t>(r0) * ncols, ncols, col,
                valid, acc);
  float* part = a.part_proj + static_cast<int64_t>(split) * B * (S + C);
  reduce_warps<BT>(acc, red, B, part, S + C, cols);

  const int n_splits = gridDim.y;
  if (!last_block_of_tile(counters + tile, n_splits)) return;
  for (int i = tid; i < B * kColsPerTile; i += kThreads) {
    const int b = i / kColsPerTile;
    const int c = c0 + (i - b * kColsPerTile);
    if (c >= ncols) continue;
    const int gc = is_skip ? c : S + c;
    float v = 0.f;
    for (int s = 0; s < n_splits; ++s)
      v += __ldcg(a.part_proj + (static_cast<int64_t>(s) * B + b) * (S + C) + gc);
    if (is_skip) {
      const float sv = v + a.bskip[static_cast<int64_t>(l) * S + c];
      float* sk = a.skip + b * S + c;
      *sk = (a.legacy && l > 0) ? (*sk + sv) * kSqrtHalf : *sk + sv;
    } else {
      const float out = v + a.bout[static_cast<int64_t>(l) * C + c];
      const float xin = a.x_all[(static_cast<int64_t>(l) * B + b) * C + c];
      const float xn = (xin + out) * kSqrtHalf;
      if (l + 1 < a.L)
        a.x_all[(static_cast<int64_t>(l + 1) * B + b) * C + c] = xn;
      else
        a.x_out[b * C + c] = xn;
    }
  }
}

int tiles_gate(int G) { return (G / 2 + kPairsPerTile - 1) / kPairsPerTile; }
int tiles_proj(int C, int S) {
  return (S + kColsPerTile - 1) / kColsPerTile +
         (C + kColsPerTile - 1) / kColsPerTile;
}
int splits_gate(int k, int C) { return (k * C + kRowsGate - 1) / kRowsGate; }
int splits_proj(int G) { return (G / 2 + kRowsProj - 1) / kRowsProj; }

template <int BT>
int launch_layers(const StepArgs& a, cudaStream_t s) {
  const int tg = tiles_gate(a.G), tp = tiles_proj(a.C, a.S);
  const dim3 grid_gate(tg, splits_gate(a.k, a.C));
  const dim3 grid_proj(tp, splits_proj(a.G));
  for (int l = 0; l < a.L; ++l) {
    // layer l's counters: tg for the gate tiles, then tp for the projection
    int* counters = a.counters + static_cast<int64_t>(l) * (tg + tp);
    glu_gate_kernel<BT><<<grid_gate, kThreads, 0, s>>>(a, l, counters);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    glu_proj_kernel<BT><<<grid_proj, kThreads, 0, s>>>(a, l, counters + tg);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// Bytes of scratch the caller allocates for one call (16-byte multiple).
extern "C" size_t wavenet_step_scratch_bytes(int L, int k, int B, int C, int G,
                                             int S) {
  const size_t floats =
      static_cast<size_t>(splits_gate(k, C)) * B * G +
      static_cast<size_t>(B) * (G / 2) +
      static_cast<size_t>(splits_proj(G)) * B * (S + C);
  const size_t ints = static_cast<size_t>(L) * (tiles_gate(G) + tiles_proj(C, S));
  const size_t bytes = 4 * (floats + ints);
  return (bytes + 15) / 16 * 16;
}

// Runs the whole layer stack on `stream`; returns cudaGetLastError() of the
// first launch that failed, or 0. Supports 1 <= B <= 32.
extern "C" int wavenet_step_f32(const float* x0, const float* taps,
                                const float* cond, const float* wtap,
                                const float* bias, const float* wskip,
                                const float* bskip, const float* wout,
                                const float* bout, int L, int k, int B, int C,
                                int G, int S, int legacy, float* x_out,
                                float* skip, float* x_all, void* scratch,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  StepArgs a;
  a.taps = taps; a.cond = cond; a.wtap = wtap; a.bias = bias;
  a.wskip = wskip; a.bskip = bskip; a.wout = wout; a.bout = bout;
  a.x_out = x_out; a.skip = skip; a.x_all = x_all;
  a.L = L; a.k = k; a.B = B; a.C = C; a.G = G; a.S = S; a.legacy = legacy;
  float* f = static_cast<float*>(scratch);
  a.part_gate = f;
  f += static_cast<size_t>(splits_gate(k, C)) * B * G;
  a.h = f;
  f += static_cast<size_t>(B) * (G / 2);
  a.part_proj = f;
  f += static_cast<size_t>(splits_proj(G)) * B * (S + C);
  a.counters = reinterpret_cast<int*>(f);
  const size_t n_counters =
      static_cast<size_t>(L) * (tiles_gate(G) + tiles_proj(C, S));

  cudaError_t err = cudaMemsetAsync(a.counters, 0, n_counters * sizeof(int), s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(skip, 0, static_cast<size_t>(B) * S * sizeof(float), s);
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(x_all, x0, static_cast<size_t>(B) * C * sizeof(float),
                          cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 1) return launch_layers<1>(a, s);
  if (B <= 2) return launch_layers<2>(a, s);
  if (B <= 4) return launch_layers<4>(a, s);
  if (B <= 8) return launch_layers<8>(a, s);
  if (B <= 16) return launch_layers<16>(a, s);
  if (B <= 32) return launch_layers<32>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
