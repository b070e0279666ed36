// Fused VQ codebook search for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel vqvae_speech_tpu/ops/vq.py::_vq_kernel (launched by
// _vq_search_pallas_fwd). For flat z (N, D) and codebook e (K, D) it computes
//
//   d[n, k]   = ||z_n||^2 + ||e_k||^2 - 2 z_n . e_k   (full formula, f32)
//   idx[n]    = argmin_k d[n, k]        (first index on an exact tie)
//   q[n, :]   = e[idx[n], :]            (a copy of the winning row)
//   counts[k] = #{n : idx[n] == k}      (exact: integer counts, N < 2^24)
//   dw[k, :]  = sum_{n : idx[n] == k} z[n, :]
//
// What bounds it on an H100: at the flagship K=44, D=64 one row costs 256 bytes
// of z read, 256 bytes of q written and ~2*K*D = 5.6k flops, about 11 flops a
// byte against the card's ~20 f32 (non-tensor-core) flops a byte, so the pass
// is close to memory-bound and, at the server's N=1536, launch-bound (this
// first version also recomputes ||e_k||^2 in every warp beside the dot,
// which doubles the FMAs but adds no memory traffic). The
// design reads z from device memory once per pass, keeps the distance matrix
// and the one-hot out of device memory entirely (the plain PyTorch chain
// writes and re-reads both), and never assumes the codebook fits in shared
// memory: codebook rows are read through L1/L2 as warp-wide broadcasts, so
// K=1000 (256 KB of codebook, more than a block's 227 KB of shared memory)
// runs on the same path.
//
// Two kernels, both on the caller's stream:
//  1. vq_argmin_kernel: one block per 32-row tile. The tile of z sits in
//     shared memory (row stride D+1, so lane-per-row reads hit distinct
//     banks); each of the 8 warps scans an interleaved eighth of the codes
//     with lane = row, then the 8 partial minima are merged with an explicit
//     (distance, index) tie-break, which reproduces argmin's first-index rule.
//  2. vq_stats_kernel: one block per (code, 32-column slice). The TPU kernel
//     carried counts/dw across its sequential grid; CUDA blocks run in no
//     order, so this deterministic second pass gathers, for its code, the
//     rows that chose it: each warp ballots 32 indices at a time and adds the
//     matching rows' columns in ascending row order, and the 16 warp partials
//     are summed in a fixed order. No atomics, so dw is bit-reproducible.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 32;     // rows per block in the argmin pass
constexpr int kArgminWarps = 8;   // warps per block in the argmin pass
constexpr int kStatsWarps = 16;   // warps per block in the stats pass

__global__ void vq_argmin_kernel(const float* __restrict__ z,
                                 const float* __restrict__ cb,
                                 int64_t n_rows, int K, int D,
                                 int32_t* __restrict__ idx_out,
                                 float* __restrict__ q_out) {
  extern __shared__ float smem[];
  float* zt = smem;                                   // kTileRows * (D + 1)
  float* part_d = zt + kTileRows * (D + 1);           // kArgminWarps * 32
  int* part_k = reinterpret_cast<int*>(part_d + kArgminWarps * kTileRows);
  int* best_k = part_k + kArgminWarps * kTileRows;    // kTileRows

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kTileRows;
  const int64_t left = n_rows - row0;
  const int rows = left < kTileRows ? static_cast<int>(left) : kTileRows;

  // coalesced load of the row tile; rows past N are zero-filled
  for (int i = tid; i < kTileRows * D; i += blockDim.x) {
    const int r = i / D, c = i - r * D;
    zt[r * (D + 1) + c] = r < rows ? z[(row0 + r) * D + c] : 0.f;
  }
  __syncthreads();

  const float* zr = zt + lane * (D + 1);
  float zsq = 0.f;
  for (int c = 0; c < D; ++c) zsq = fmaf(zr[c], zr[c], zsq);

  float best = __int_as_float(0x7f800000);  // +inf
  int arg = -1;
  for (int k = warp; k < K; k += kArgminWarps) {
    const float* e = cb + static_cast<int64_t>(k) * D;
    float dot = 0.f, esq = 0.f;
    for (int c = 0; c < D; ++c) {
      const float ev = __ldg(e + c);  // same address across the warp
      dot = fmaf(zr[c], ev, dot);
      esq = fmaf(ev, ev, esq);
    }
    const float d = zsq + esq - 2.f * dot;
    if (d < best || arg < 0) { best = d; arg = k; }   // ascending k: first wins
  }
  part_d[warp * kTileRows + lane] = best;
  part_k[warp * kTileRows + lane] = arg;
  __syncthreads();

  if (warp == 0) {
    float b = part_d[lane];
    int a = part_k[lane];
    for (int w = 1; w < kArgminWarps; ++w) {
      const int kw = part_k[w * kTileRows + lane];
      if (kw < 0) continue;                          // warp had no codes (K < 8)
      const float dv = part_d[w * kTileRows + lane];
      if (dv < b || (dv == b && kw < a)) { b = dv; a = kw; }
    }
    best_k[lane] = a;
    if (lane < rows) idx_out[row0 + lane] = a;
  }
  __syncthreads();

  for (int i = tid; i < rows * D; i += blockDim.x) {
    const int r = i / D, c = i - r * D;
    q_out[(row0 + r) * D + c] = cb[static_cast<int64_t>(best_k[r]) * D + c];
  }
}

__global__ void vq_stats_kernel(const float* __restrict__ z,
                                const int32_t* __restrict__ idx,
                                int64_t n_rows, int K, int D,
                                float* __restrict__ counts,
                                float* __restrict__ dw) {
  __shared__ float part[kStatsWarps][32];
  __shared__ int part_n[kStatsWarps];

  const int k = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.y * 32 + lane;

  float acc = 0.f;
  int n_match = 0;
  for (int64_t base = static_cast<int64_t>(warp) * 32; base < n_rows;
       base += kStatsWarps * 32) {
    const int64_t n = base + lane;
    const int mine = n < n_rows ? idx[n] : -1;
    unsigned mask = __ballot_sync(0xffffffffu, mine == k);
    n_match += __popc(mask);
    while (mask) {
      const int j = __ffs(mask) - 1;
      mask &= mask - 1;
      if (col < D) acc += z[(base + j) * D + col];
    }
  }
  part[warp][lane] = acc;
  if (lane == 0) part_n[warp] = n_match;
  __syncthreads();

  if (warp == 0) {
    float s = 0.f;
    int c = 0;
    for (int w = 0; w < kStatsWarps; ++w) { s += part[w][lane]; c += part_n[w]; }
    if (col < D) dw[static_cast<int64_t>(k) * D + col] = s;
    if (blockIdx.y == 0 && lane == 0) counts[k] = static_cast<float>(c);
  }
}

}  // namespace

extern "C" size_t vq_search_smem_bytes(int D) {
  return sizeof(float) * (kTileRows * (D + 1) + kArgminWarps * kTileRows) +
         sizeof(int) * (kArgminWarps * kTileRows + kTileRows);
}

// Launches both passes on `stream` and returns cudaGetLastError().
extern "C" int vq_search_f32(const float* z, const float* cb, int64_t n_rows,
                             int K, int D, int32_t* idx, float* q,
                             float* counts, float* dw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = vq_search_smem_bytes(D);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        vq_argmin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned tiles = static_cast<unsigned>((n_rows + kTileRows - 1) / kTileRows);
  vq_argmin_kernel<<<tiles, kArgminWarps * 32, smem, s>>>(z, cb, n_rows, K, D,
                                                          idx, q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>(K), static_cast<unsigned>((D + 31) / 32));
  vq_stats_kernel<<<grid, kStatsWarps * 32, 0, s>>>(z, idx, n_rows, K, D,
                                                    counts, dw);
  return static_cast<int>(cudaGetLastError());
}
