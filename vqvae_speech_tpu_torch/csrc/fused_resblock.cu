// Fused gated-resblock chains for one-pass vocoder synthesis at batch 1,
// Hopper (sm_90a), f32.
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
// layer (the per-layer zero padding of the convolutions). All sums are f32.
//
// What bounds it on an H100: operations. A row of one layer costs
// 2*(k*C + cin)*2G + 2*G*(C + S) flops (0.61 MFLOP at the IAF student's
// k=3, C=128, G=256, S=128, cin=80; 3.6 MFLOP a 6-layer chain) against
// 4*(C + cin) bytes read and 4*(C + S) written once a chain: hundreds of
// flops a byte, so the f32 rate outside the tensor cores (67 TFLOP/s) is
// the limit, 1.1 ms for a 20480-row student chain. The weights (0.95 MB a
// student layer, up to 21 MB a layer in the last FloWaveNet block) do not
// fit shared memory and stream from L2 in 16-row slices.
//
// What the design does about the TPU kernels' shape. The tiled TPU kernel
// walks time tiles in order and carries each layer's last (k-1)*d input
// rows in scratch; the non-causal one gathers overlapping windows with a
// halo and re-zeroes rows outside the sequence after every layer. Blocks on
// Hopper run in no order and a GPU-sized row tile is far smaller than the
// causal chain's 728-row history, so neither carries over. Instead one C
// entry point enqueues ONE launch a layer on the caller's stream, and the
// stream orders the layers. In a launch, a block owns 64 rows and every
// column:
//  (1) gate: for each 64-column slice of G, hf and hg accumulate in
//      registers (4 rows x 4 columns x 2 a thread) over the k tap segments
//      and the conditioning segment of the reduction. A tap's rows come
//      straight from the layer's input in global memory, predicated on
//      0 <= t + off < T, which is all the zero padding, window gathering
//      and re-zeroing there is: causal and non-causal chains differ only
//      in the offsets, and share this kernel. Input rows and weight
//      slices pass through shared memory, the next slice's global loads in
//      flight while the current one is multiplied. tanh*sigmoid runs in
//      the epilogue and the gated output stays in shared memory.
//  (2) projection: out @ wres and out @ wskip over the same rows, the
//      residual and skip updates in the epilogue.
// A layer updated in place would be read by neighbouring blocks while it is
// overwritten, so x ping-pongs between the output buffer and one scratch
// buffer, ending in the output. Every row of x and skip is written by one
// block in a fixed summation order: no atomics, results are
// bit-reproducible and independent of any tiling.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;         // rows a block owns
constexpr int kCols = 64;         // columns per pass
constexpr int kSlice = 16;        // reduction rows per shared-memory slice
constexpr int kRowStride = kRows + 4;  // transposed tiles: [reduction][row]
constexpr int kMaxTaps = 8;
constexpr float kSqrtHalf = 0.70710678118654752f;

struct LayerArgs {
  const float* x_in;   // (T, C) this layer's input
  const float* c;      // (T, cin)
  const float* wf;     // (k, C, G)
  const float* wg;
  const float* wfc;    // (cin, G)
  const float* wgc;
  const float* wres;   // (G, C)
  const float* wskip;  // (G, S)
  const float* bf;     // (G)
  const float* bg;
  const float* bres;   // (C)
  const float* bskip;  // (S)
  float* x_out;        // (T, C) the next layer's input
  float* skip;         // (T, S)
  int T, C, G, S, cin, k;
  int first;           // the chain's first layer writes skip, later ones add
  int off[kMaxTaps];
};

__device__ __forceinline__ float sigmoidf_(float v) {
  return 1.f / (1.f + expf(-v));
}

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Slice `ti` of the gate's reduction: k * tiles_x slices of the taps, then
// the conditioning's. Each thread fetches 4 input values (reduction index
// tid % 16, rows tid / 16 + 16 i) and one float4 of each weight matrix
// (reduction row tid / 16, columns g0 + 4 * (tid % 16) ..).
__device__ __forceinline__ void fetch_gate_slice(const LayerArgs& a, int ti,
                                                 int tiles_x, int t0, int g0,
                                                 float (&av)[4], float4& w0,
                                                 float4& w1) {
  const int tid = threadIdx.x;
  const int n_x = a.k * tiles_x;
  const float* src;
  const float* pf;
  const float* pg;
  int width, roff, k0;
  if (ti < n_x) {
    const int j = ti / tiles_x;
    k0 = (ti - j * tiles_x) * kSlice;
    src = a.x_in;
    width = a.C;
    roff = a.off[j];
    pf = a.wf + static_cast<size_t>(j) * a.C * a.G;
    pg = a.wg + static_cast<size_t>(j) * a.C * a.G;
  } else {
    k0 = (ti - n_x) * kSlice;
    src = a.c;
    width = a.cin;
    roff = 0;
    pf = a.wfc;
    pg = a.wgc;
  }
  const int kk = tid % kSlice;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + tid / kSlice + i * (kThreads / kSlice);
    const int ts = t + roff;
    const bool ok = t < a.T && ts >= 0 && ts < a.T && k0 + kk < width;
    av[i] = ok ? __ldg(src + static_cast<size_t>(ts) * width + k0 + kk) : 0.f;
  }
  const int row = k0 + tid / 16;
  const int col = g0 + (tid % 16) * 4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row < width && col < a.G) {
    const size_t at = static_cast<size_t>(row) * a.G + col;
    w0 = __ldg(reinterpret_cast<const float4*>(pf + at));
    w1 = __ldg(reinterpret_cast<const float4*>(pg + at));
  } else {
    w0 = zero;
    w1 = zero;
  }
}

// One float4 of a projection matrix w (G, N): reduction row k0 + tid / 16,
// columns n0 + 4 * (tid % 16) ..
__device__ __forceinline__ float4 fetch_proj_slice(const float* w, int G, int N,
                                                   int k0, int n0) {
  const int tid = threadIdx.x;
  const int row = k0 + tid / 16;
  const int col = n0 + (tid % 16) * 4;
  if (row < G && col < N)
    return __ldg(reinterpret_cast<const float4*>(
        w + static_cast<size_t>(row) * N + col));
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4& a,
                                       const float4& w) {
  const float ar[4] = {a.x, a.y, a.z, a.w};
  const float wr[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], wr[j], acc[i][j]);
}

// out_s (G rounded up to a slice, kRowStride) @ w (G, N) for the block's
// rows, 64 columns a pass; `residual` selects the epilogue.
__device__ __forceinline__ void project(const LayerArgs& a, const float* w,
                                        const float* bias, int N, bool residual,
                                        int t0, const float* out_s,
                                        float* w_s) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n_slices = ceil_div(a.G, kSlice);
  for (int n0 = 0; n0 < N; n0 += kCols) {
    float acc[4][4] = {};
    float4 w_next = fetch_proj_slice(w, a.G, N, 0, n0);
    for (int ti = 0; ti < n_slices; ++ti) {
      __syncthreads();
      *reinterpret_cast<float4*>(&w_s[(tid / 16) * kCols + (tid % 16) * 4]) =
          w_next;
      __syncthreads();
      if (ti + 1 < n_slices)
        w_next = fetch_proj_slice(w, a.G, N, (ti + 1) * kSlice, n0);
#pragma unroll
      for (int kk = 0; kk < kSlice; ++kk) {
        const float4 o4 = *reinterpret_cast<const float4*>(
            &out_s[(ti * kSlice + kk) * kRowStride + ty * 4]);
        const float4 w4 =
            *reinterpret_cast<const float4*>(&w_s[kk * kCols + tx * 4]);
        fma4x4(acc, o4, w4);
      }
    }
    const int col = n0 + tx * 4;
    if (col >= N) continue;
    const float4 b4 = *reinterpret_cast<const float4*>(bias + col);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty * 4 + i;
      if (t >= a.T) continue;
      const size_t at = static_cast<size_t>(t) * N + col;
      float4 v = make_float4(acc[i][0] + b4.x, acc[i][1] + b4.y,
                             acc[i][2] + b4.z, acc[i][3] + b4.w);
      if (residual) {
        const float4 x4 = *reinterpret_cast<const float4*>(a.x_in + at);
        v = make_float4((x4.x + v.x) * kSqrtHalf, (x4.y + v.y) * kSqrtHalf,
                        (x4.z + v.z) * kSqrtHalf, (x4.w + v.w) * kSqrtHalf);
        *reinterpret_cast<float4*>(a.x_out + at) = v;
      } else {
        if (!a.first) {
          const float4 s4 = *reinterpret_cast<const float4*>(a.skip + at);
          v = make_float4(s4.x + v.x, s4.y + v.y, s4.z + v.z, s4.w + v.w);
        }
        *reinterpret_cast<float4*>(a.skip + at) = v;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
chain_layer_kernel(const LayerArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;                        // [kSlice][kRowStride]
  float* w0_s = a_s + kSlice * kRowStride;  // [kSlice][kCols]
  float* w1_s = w0_s + kSlice * kCols;      // [kSlice][kCols]
  float* out_s = w1_s + kSlice * kCols;     // [G up to a slice][kRowStride]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int t0 = blockIdx.x * kRows;
  const int tiles_x = ceil_div(a.C, kSlice);
  const int n_slices = a.k * tiles_x + ceil_div(a.cin, kSlice);

  // the projection reads whole slices of out_s: rows past G must be finite
  const int g_pad = ceil_div(a.G, kSlice) * kSlice;
  for (int e = a.G * kRowStride + tid; e < g_pad * kRowStride; e += kThreads)
    out_s[e] = 0.f;

  // (1) gate
  for (int g0 = 0; g0 < a.G; g0 += kCols) {
    float accf[4][4] = {};
    float accg[4][4] = {};
    float av[4];
    float4 w0, w1;
    fetch_gate_slice(a, 0, tiles_x, t0, g0, av, w0, w1);
    for (int ti = 0; ti < n_slices; ++ti) {
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a_s[(tid % kSlice) * kRowStride + tid / kSlice +
            i * (kThreads / kSlice)] = av[i];
      *reinterpret_cast<float4*>(&w0_s[(tid / 16) * kCols + (tid % 16) * 4]) = w0;
      *reinterpret_cast<float4*>(&w1_s[(tid / 16) * kCols + (tid % 16) * 4]) = w1;
      __syncthreads();
      if (ti + 1 < n_slices)
        fetch_gate_slice(a, ti + 1, tiles_x, t0, g0, av, w0, w1);
#pragma unroll
      for (int kk = 0; kk < kSlice; ++kk) {
        const float4 x4 = *reinterpret_cast<const float4*>(
            &a_s[kk * kRowStride + ty * 4]);
        const float4 f4 =
            *reinterpret_cast<const float4*>(&w0_s[kk * kCols + tx * 4]);
        const float4 g4 =
            *reinterpret_cast<const float4*>(&w1_s[kk * kCols + tx * 4]);
        fma4x4(accf, x4, f4);
        fma4x4(accg, x4, g4);
      }
    }
    const int col = g0 + tx * 4;
    if (col < a.G) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float bf = a.bf[col + j], bg = a.bg[col + j];
        float4 o;
        o.x = tanhf(accf[0][j] + bf) * sigmoidf_(accg[0][j] + bg);
        o.y = tanhf(accf[1][j] + bf) * sigmoidf_(accg[1][j] + bg);
        o.z = tanhf(accf[2][j] + bf) * sigmoidf_(accg[2][j] + bg);
        o.w = tanhf(accf[3][j] + bf) * sigmoidf_(accg[3][j] + bg);
        *reinterpret_cast<float4*>(&out_s[(col + j) * kRowStride + ty * 4]) = o;
      }
    }
  }

  // (2) projections; project() synchronises before it first reads out_s
  project(a, a.wres, a.bres, a.C, true, t0, out_s, w0_s);
  project(a, a.wskip, a.bskip, a.S, false, t0, out_s, w0_s);
}

size_t smem_bytes(int G) {
  const size_t g_pad = static_cast<size_t>(ceil_div(G, kSlice)) * kSlice;
  return sizeof(float) *
         (kSlice * kRowStride + 2 * kSlice * kCols + g_pad * kRowStride);
}

struct ChainArgs {
  const float* x;
  const float* c;
  const float* wf;
  const float* wg;
  const float* wfc;
  const float* wgc;
  const float* wres;
  const float* wskip;
  const float* bf;
  const float* bg;
  const float* bres;
  const float* bskip;
  int T, C, G, S, cin, L, k;
  float* x_out;
  float* skip;
  float* scratch;  // (T, C), used when L > 1
};

// offsets: L * k row offsets, layer-major. One launch a layer on `s`.
int launch_chain(const ChainArgs& c, const int* offsets, cudaStream_t s) {
  if (c.k < 1 || c.k > kMaxTaps || c.L < 1 || c.T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(c.G);
  cudaError_t err = cudaFuncSetAttribute(
      chain_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = ceil_div(c.T, kRows);
  const float* x_in = c.x;
  for (int l = 0; l < c.L; ++l) {
    LayerArgs a;
    a.x_in = x_in;
    a.c = c.c;
    a.wf = c.wf + static_cast<size_t>(l) * c.k * c.C * c.G;
    a.wg = c.wg + static_cast<size_t>(l) * c.k * c.C * c.G;
    a.wfc = c.wfc + static_cast<size_t>(l) * c.cin * c.G;
    a.wgc = c.wgc + static_cast<size_t>(l) * c.cin * c.G;
    a.wres = c.wres + static_cast<size_t>(l) * c.G * c.C;
    a.wskip = c.wskip + static_cast<size_t>(l) * c.G * c.S;
    a.bf = c.bf + static_cast<size_t>(l) * c.G;
    a.bg = c.bg + static_cast<size_t>(l) * c.G;
    a.bres = c.bres + static_cast<size_t>(l) * c.C;
    a.bskip = c.bskip + static_cast<size_t>(l) * c.S;
    // ping-pong so that the last layer writes x_out
    a.x_out = ((c.L - 1 - l) % 2 == 0) ? c.x_out : c.scratch;
    a.skip = c.skip;
    a.T = c.T; a.C = c.C; a.G = c.G; a.S = c.S; a.cin = c.cin; a.k = c.k;
    a.first = (l == 0);
    for (int j = 0; j < kMaxTaps; ++j)
      a.off[j] = j < c.k ? offsets[l * c.k + j] : 0;
    chain_layer_kernel<<<grid, kThreads, smem, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    x_in = a.x_out;
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

// Bytes of dynamic shared memory a block needs at gate width G.
extern "C" size_t fused_chain_smem_bytes(int G) { return smem_bytes(G); }

#define CHAIN_PARAMS                                                          \
  const float *x, const float *c, const float *wf, const float *wg,           \
      const float *wfc, const float *wgc, const float *wres,                  \
      const float *wskip, const float *bf, const float *bg,                   \
      const float *bres, const float *bskip, int T, int C, int G, int S,      \
      int cin, int L, int k
#define CHAIN_ARGS                                                            \
  ChainArgs { x, c, wf, wg, wfc, wgc, wres, wskip, bf, bg, bres, bskip, T, C, \
              G, S, cin, L, k, x_out, skip, scratch }

// Each entry point runs a whole chain on `stream` and returns
// cudaGetLastError() of the first launch that failed, or 0. Needs
// C, G, S multiples of 4, 16-byte aligned pointers, k <= 8, L <= 64.

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
