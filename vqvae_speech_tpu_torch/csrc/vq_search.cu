// Fused VQ codebook search for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel vqvae_speech_tpu/ops/vq.py::_vq_kernel (launched by
// _vq_search_pallas_fwd). For flat z (N, D) and codebook e (K, D) it computes
//
//   d[n, k]   = ||z_n||^2 + ||e_k||^2 - 2 z_n . e_k   (full formula, f32 FMAs)
//   idx[n]    = argmin_k d[n, k]        (first index on an exact tie)
//   q[n, :]   = e[idx[n], :]            (a copy of the winning row)
//   counts[k] = #{n : idx[n] == k}      (exact: integer counts, N < 2^24)
//   dw[k, :]  = sum_{n : idx[n] == k} z[n, :]
//
// What bounds it on an H100: at the flagship K=44, D=64 one row costs 256
// bytes of z read, 256 bytes of q written and 2*K*D = 5.6k flops, about 11
// flops a byte against the card's ~20 f32 (non-tensor-core) flops a byte: the
// bytes bound it, and below N ~ 10^4 the latency of one launch does. So the
// design is ONE launch that reads z once, keeps the codebook, the distances,
// the one-hot and the running statistics on chip, and spends its shared-memory
// reads sparingly:
//
//  * A persistent grid: blocks = ceil(tiles / ceil(tiles / SMs)), each block
//    walking a contiguous run of row tiles, the next tile's rows already in
//    flight to registers while the current one is searched. Tiles are 64 rows
//    (a thread owns 4), or 32 or 16 at D = 64 where that many tiles still get
//    an SM each (N <= 4224 and N <= 2112 on 132 SMs): a block's time is a
//    chain of phases that each shrink with its rows (at N = 1536: 10.4 us in
//    24 blocks of 64 rows, 8.0 us in 96 of 16).
//  * The codebook and ||e_k||^2 are staged in shared memory once a block (row
//    stride D+4 floats: float4 reads of 16 neighbouring rows then take the
//    least two wavefronts), ||z_n||^2 once a tile.
//  * D is a template parameter at 64 (the width every configuration of the
//    repository uses): a thread owns up to 4 rows x 3 codes, 12 independent
//    accumulators fed by 7 float4 shared-memory reads per 48 FMAs. Any other D
//    runs the same kernel with scalar reads (row stride D+1).
//  * Sixteen lanes share a row; their minima merge by shuffles with an
//    explicit (distance, index) tie-break. Each lane scans its codes in
//    ascending order, so the first index wins an exact tie, as argmin does.
//  * Statistics: the TPU kernel carried counts/dw across its sequential grid.
//    Here each block adds its rows into shared-memory counts/dw in ascending
//    row order (one warp a code: a ballot over the tile's indices picks the
//    rows) and writes its partial to a scratch buffer. The launch is
//    cooperative (every block resident: the grid is at most one block an SM),
//    so after ONE grid barrier the sum over the partials is spread over the
//    whole grid: block b owns a slice of the K*(D+1) elements, its threads
//    split the partials of an element into contiguous runs that are each
//    summed in block order (up to 16 loads in flight a thread), and the runs'
//    sums are added in run order. No float atomics, and the grid and the
//    split depend on (N, K, D, SM count) only: dw is bit-reproducible run to
//    run. (A first form, in which the last block to take a ticket summed up
//    to 32 partials alone, spent more time in that one SM's round trips to L2
//    than in the search.)
//
// The rule between one launch and two is on (K, D) alone, never a fallback.
// The search is ONE launch iff
//   (a) the staged codebook, one 64-row tile and the block's partial
//       statistics fit in a block's 232448 bytes of shared memory:
//       4 * (K * (2*D + P + 2) + 64 * (D + P + 2)) <= 232448, with P = 4 at
//       D = 64 and 1 otherwise (K <= 400 at D = 64), and
//   (b) a partial is at most 8192 floats, K * (D + 1) <= 8192 (K <= 126 at
//       D = 64). Every block writes its whole partial and the grid reads
//       them all back, which grows with K * blocks; with a large codebook a
//       second launch is cheaper (measured at N = 1536, K = 400: 27 us in
//       one launch, 20 us in two).
// Otherwise (K = 500, 1000 of the codebook-size experiments) the search
// kernel runs without the statistics, the codebook staged once or, when it
// does not fit (K > ~800 at D = 64), K-tiled through shared memory (16-row
// tiles when 64-row tiles would leave SMs empty), and the deterministic
// statistics pass of the first version follows as a second launch: one block
// per (code, 32-column slice) that ballots the indices and adds the matching
// rows in ascending order. A K-tiled block re-reads the codebook from L2 once
// a tile. A search of one block (N <= 64) writes its statistics straight out.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // 16 row groups x 16 code groups
constexpr int kCodesPerThread = 3;  // 48 codes a pass over the reduction
constexpr int kCodesPerPass = 16 * kCodesPerThread;
constexpr int kInFlight = 16;       // partial loads in flight a thread
constexpr int kMaxPartial = 8192;   // floats of statistics a block may carry
constexpr int kMaxSmem = 232448;    // bytes a Hopper block may use
constexpr int kStatsWarps = 16;     // warps per block in the stats pass

// -DVQ_STAMPS (scripts/time_vq_search_cuda.py builds such a probe library,
// never the one the port loads): thread 0 of every block of the one-launch
// kernel records the global nanosecond timer at each phase boundary into the
// buffer set by vq_search_set_stamps, kStampSlots words a block.
#ifdef VQ_STAMPS
constexpr int kStampSlots = 16;
__device__ long long* g_stamps = nullptr;
__device__ inline void stamp(int slot) {
  if (threadIdx.x == 0 && g_stamps != nullptr) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamps[static_cast<long long>(blockIdx.x) * kStampSlots + slot] = t;
  }
}
#define VQ_STAMP(slot) stamp(slot)
#else
#define VQ_STAMP(slot)
#endif

struct Plan {
  int fused;            // 1: one launch with the statistics
  int rpt;              // rows a thread owns: tiles of 16 * rpt rows
  int k_chunk;          // codes staged at a time
  int blocks;           // persistent grid
  int tiles_per_block;
  int smem;             // dynamic shared memory, bytes
  int64_t scratch;      // floats of scratch: the blocks' partials
};

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = n > 0 ? n : 132;
  }
  return cached[dev];
}

// Floats between two partials: K * D of dw, K of counts, padded to float4s.
__host__ __device__ inline int partial_stride(int K, int D) {
  return (K * (D + 1) + 3) / 4 * 4;
}

// Returns false when not even 16 rows and one code fit (D too wide).
bool make_plan(int64_t n_rows, int K, int D, Plan* p) {
  const int64_t pad = D == 64 ? 4 : 1;
  const int64_t dp = D + pad;
  const int sms = sm_count();
  const int64_t fused_bytes =
      4 * (static_cast<int64_t>(K) * (2 * D + pad + 2) + 64 * (dp + 2));
  p->fused = fused_bytes <= kMaxSmem &&
             static_cast<int64_t>(K) * (D + 1) <= kMaxPartial;
  if (p->fused) {
    // one block if 64 rows hold the search (no grid barrier then), else the
    // smallest tile that still gives every tile its own SM: a block's time
    // is a chain of phases that each shrink with its rows
    p->rpt = D != 64 || n_rows <= 64 ? 4
        : (n_rows + 15) / 16 <= sms ? 1 : (n_rows + 31) / 32 <= sms ? 2 : 4;
    p->k_chunk = K;
    p->smem = static_cast<int>(fused_bytes);
  } else {
    const int64_t tiles64 = (n_rows + 63) / 64;
    // 64-row tiles only if they fill the card and leave half the shared
    // memory to the codebook
    p->rpt = (tiles64 >= sms && 4 * 64 * (dp + 2) <= kMaxSmem / 2) ? 4 : 1;
    const int64_t tile_bytes = 4 * 16 * p->rpt * (dp + 2);
    int64_t chunk = (kMaxSmem - tile_bytes) / (4 * (dp + 1));
    if (chunk < 1) return false;
    if (chunk > K) chunk = K;
    if (chunk < K && chunk >= kCodesPerPass)
      chunk -= chunk % kCodesPerPass;
    p->k_chunk = static_cast<int>(chunk);
    p->smem = static_cast<int>(tile_bytes + 4 * chunk * (dp + 1));
  }
  const int64_t tile_rows = 16 * p->rpt;
  const int64_t tiles = (n_rows + tile_rows - 1) / tile_rows;
  const int64_t waves = (tiles + sms - 1) / sms;
  p->tiles_per_block = static_cast<int>(waves);
  p->blocks = static_cast<int>((tiles + waves - 1) / waves);
  p->scratch = p->fused && p->blocks > 1
      ? static_cast<int64_t>(p->blocks) * partial_stride(K, D) : 0;
  return true;
}

// 16 bytes global -> shared without passing through registers.
__device__ inline void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// DT: the embedding width at compile time (float4 shared-memory reads), or 0
// for any width at run time. RPT: rows a thread owns. FUSED: accumulate and
// reduce counts/dw (needs the whole codebook staged: k_chunk == K).
template <int DT, int RPT, bool FUSED>
__global__ void __launch_bounds__(kThreads, 1)
vq_search_kernel(const float* __restrict__ z, const float* __restrict__ cb,
                 int64_t n_rows, int K, int d_runtime, int k_chunk,
                 int tiles_per_block, int32_t* __restrict__ idx_out,
                 float* __restrict__ q_out, float* __restrict__ counts,
                 float* __restrict__ dw, float* __restrict__ scratch) {
  static_assert(DT % 4 == 0, "a templated width is whole float4s");
  constexpr int TR = 16 * RPT;
  constexpr int kPrefetch = DT > 0 ? TR * DT / kThreads : 1;
  const int D = DT > 0 ? DT : d_runtime;
  const int DP = DT > 0 ? DT + 4 : d_runtime + 1;

  extern __shared__ float4 smem4[];
  float* cb_s = reinterpret_cast<float*>(smem4);   // k_chunk * DP
  float* z_s = cb_s + static_cast<size_t>(k_chunk) * DP;   // TR * DP
  float* esq_s = z_s + TR * DP;                    // k_chunk
  float* zsq_s = esq_s + k_chunk;                  // TR
  int* idx_s = reinterpret_cast<int*>(zsq_s + TR); // TR
  float* dw_s = reinterpret_cast<float*>(idx_s + TR);   // K * D   (FUSED)
  float* cnt_s = dw_s + (FUSED ? K * D : 0);       // K       (FUSED)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cg = tid & 15;   // code group: codes cg, cg + 16, cg + 32 a pass
  const int rg = tid >> 4;   // row group: rows rg * RPT ..
  const bool staged_once = k_chunk >= K;

  VQ_STAMP(0);   // entry
  const int64_t tiles = (n_rows + TR - 1) / TR;
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * tiles_per_block;
  int64_t tile_end = tile0 + tiles_per_block;
  if (tile_end > tiles) tile_end = tiles;

  // stage codes [c0, c0 + kc) and their squared norms
  auto stage_codebook = [&](int c0, int kc) {
    if (DT > 0) {   // 16-byte copies, every one in flight before the wait
      constexpr int Q = DT > 0 ? DT / 4 : 1;
      for (int i = tid; i < kc * Q; i += kThreads) {
        const int r = i / Q, c = 4 * (i - r * Q);
        cp_async16(cb_s + r * DP + c, cb + static_cast<int64_t>(c0 + r) * D + c);
      }
      cp_async_wait_all();
    } else {
#pragma unroll 8
      for (int i = tid; i < kc * D; i += kThreads) {
        const int r = i / D, c = i - r * D;
        cb_s[r * DP + c] = cb[static_cast<int64_t>(c0 + r) * D + c];
      }
    }
    __syncthreads();
    for (int k = tid; k < kc; k += kThreads) {
      const float* e = cb_s + k * DP;
      float s = 0.f;
      for (int c = 0; c < D; ++c) s = fmaf(e[c], e[c], s);
      esq_s[k] = s;
    }
  };

  float nxt[kPrefetch];
  auto fetch = [&](int64_t tile) {   // DT only: a tile's rows to registers
    const int64_t row0 = tile * TR;
#pragma unroll
    for (int i = 0; i < kPrefetch; ++i) {
      const int e = tid + kThreads * i;
      const int64_t row = row0 + e / (DT > 0 ? DT : 1);
      nxt[i] = row < n_rows ? z[row0 * D + e] : 0.f;
    }
  };
  if (DT > 0 && tile0 < tile_end) fetch(tile0);   // in flight under the staging
  if (staged_once) stage_codebook(0, K);
  if (FUSED)
    for (int i = tid; i < K * (D + 1); i += kThreads) dw_s[i] = 0.f;
  VQ_STAMP(1);   // codebook staged

  for (int64_t tile = tile0; tile < tile_end; ++tile) {
    const int64_t row0 = tile * TR;
    const int64_t left = n_rows - row0;
    const int rows = left < TR ? static_cast<int>(left) : TR;

    // the tile of z into shared memory; rows past N are zero
    if (DT > 0) {
#pragma unroll
      for (int i = 0; i < kPrefetch; ++i) {
        const int e = tid + kThreads * i;
        const int r = e / (DT > 0 ? DT : 1), c = e - r * (DT > 0 ? DT : 1);
        z_s[r * DP + c] = nxt[i];
      }
    } else {
      for (int i = tid; i < TR * D; i += kThreads) {
        const int r = i / D, c = i - r * D;
        z_s[r * DP + c] = r < rows ? z[(row0 + r) * D + c] : 0.f;
      }
    }
    __syncthreads();
    if (tile == tile0) VQ_STAMP(2);   // first tile in shared memory
    if (DT > 0 && tile + 1 < tile_end) fetch(tile + 1);
    if (tid < TR) {
      const float* zr = z_s + tid * DP;
      float s = 0.f;
      if (DT > 0) {
#pragma unroll 4
        for (int c = 0; c < D; c += 4) {
          const float4 v = *reinterpret_cast<const float4*>(zr + c);
          s = fmaf(v.x, v.x, s); s = fmaf(v.y, v.y, s);
          s = fmaf(v.z, v.z, s); s = fmaf(v.w, v.w, s);
        }
      } else {
        for (int c = 0; c < D; ++c) s = fmaf(zr[c], zr[c], s);
      }
      zsq_s[tid] = s;
    }
    __syncthreads();
    if (tile == tile0) VQ_STAMP(3);   // its squared norms

    float zsq[RPT], best[RPT];
    int arg[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      zsq[i] = zsq_s[rg * RPT + i];
      best[i] = __int_as_float(0x7f800000);   // +inf
      arg[i] = 0x7fffffff;                    // no code seen yet
    }

    for (int c0 = 0; c0 < K; c0 += k_chunk) {
      const int kc = K - c0 < k_chunk ? K - c0 : k_chunk;
      if (!staged_once) {
        __syncthreads();             // the previous chunk's readers are done
        stage_codebook(c0, kc);
        __syncthreads();
      }
      for (int kb = 0; kb < kc; kb += kCodesPerPass) {
        float acc[RPT][kCodesPerThread];
        const float* e_row[kCodesPerThread];
#pragma unroll
        for (int j = 0; j < kCodesPerThread; ++j) {
          int k = kb + cg + 16 * j;
          if (k > kc - 1) k = kc - 1;          // clamped for the reads only
          e_row[j] = cb_s + k * DP;
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i][j] = 0.f;
        }
        const float* z_row = z_s + rg * RPT * DP;
        if (DT > 0) {
#pragma unroll 4
          for (int c = 0; c < D; c += 4) {
            float4 zv[RPT], ev[kCodesPerThread];
#pragma unroll
            for (int i = 0; i < RPT; ++i)
              zv[i] = *reinterpret_cast<const float4*>(z_row + i * DP + c);
#pragma unroll
            for (int j = 0; j < kCodesPerThread; ++j)
              ev[j] = *reinterpret_cast<const float4*>(e_row[j] + c);
#pragma unroll
            for (int i = 0; i < RPT; ++i)
#pragma unroll
              for (int j = 0; j < kCodesPerThread; ++j) {
                float a = acc[i][j];
                a = fmaf(zv[i].x, ev[j].x, a); a = fmaf(zv[i].y, ev[j].y, a);
                a = fmaf(zv[i].z, ev[j].z, a); a = fmaf(zv[i].w, ev[j].w, a);
                acc[i][j] = a;
              }
          }
        } else {
          for (int c = 0; c < D; ++c) {
            float zv[RPT], ev[kCodesPerThread];
#pragma unroll
            for (int i = 0; i < RPT; ++i) zv[i] = z_row[i * DP + c];
#pragma unroll
            for (int j = 0; j < kCodesPerThread; ++j) ev[j] = e_row[j][c];
#pragma unroll
            for (int i = 0; i < RPT; ++i)
#pragma unroll
              for (int j = 0; j < kCodesPerThread; ++j)
                acc[i][j] = fmaf(zv[i], ev[j], acc[i][j]);
          }
        }
#pragma unroll
        for (int j = 0; j < kCodesPerThread; ++j) {   // ascending k: first wins
          const int k = kb + cg + 16 * j;
          if (k < kc) {
            const float esq = esq_s[k];
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
              const float d = (zsq[i] + esq) - 2.f * acc[i][j];
              if (d < best[i] || arg[i] == 0x7fffffff) {
                best[i] = d;
                arg[i] = c0 + k;
              }
            }
          }
        }
      }
    }

    if (tile == tile0) VQ_STAMP(4);   // its distances
    // merge the 16 code groups of each row: smaller distance, then smaller
    // index (lane 0 of the 16 always holds a real code: K >= 1)
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, best[i], off);
        const int ok = __shfl_xor_sync(0xffffffffu, arg[i], off);
        if (od < best[i] || (od == best[i] && ok < arg[i])) {
          best[i] = od;
          arg[i] = ok;
        }
      }
      if (cg == 0) {
        const int r = rg * RPT + i;
        idx_s[r] = r < rows ? arg[i] : -1;
        if (r < rows) idx_out[row0 + r] = arg[i];
      }
    }
    __syncthreads();
    if (tile == tile0) VQ_STAMP(5);   // its indices

    // q = the winning rows, copied
    for (int i = tid; i < rows * D; i += kThreads) {
      const int r = i / D, c = i - r * D;
      const int k = idx_s[r];
      q_out[(row0 + r) * D + c] =
          staged_once ? cb_s[k * DP + c] : cb[static_cast<int64_t>(k) * D + c];
    }

    if (tile == tile0) VQ_STAMP(6);   // its quantized rows copied
    if (FUSED) {
      // one warp a code; the rows that chose it, in ascending order
      int mine[(TR + 31) / 32];
#pragma unroll
      for (int h = 0; h < (TR + 31) / 32; ++h)
        mine[h] = h * 32 + lane < TR ? idx_s[h * 32 + lane] : -1;
      for (int k = warp; k < K; k += kThreads / 32) {
        int n_match = 0;
#pragma unroll
        for (int h = 0; h < (TR + 31) / 32; ++h) {
          unsigned mask = __ballot_sync(0xffffffffu, mine[h] == k);
          n_match += __popc(mask);
          while (mask) {
            const int r = h * 32 + __ffs(mask) - 1;
            mask &= mask - 1;
            for (int c = lane; c < D; c += 32)
              dw_s[k * D + c] += z_s[r * DP + c];
          }
        }
        if (lane == 0 && n_match) cnt_s[k] += static_cast<float>(n_match);
      }
    }
    __syncthreads();   // z_s, idx_s are free for the next tile
    if (tile == tile0) VQ_STAMP(7);   // its statistics
  }
  VQ_STAMP(8);   // every tile done

  if (!FUSED) return;

  // ---- cross-block reduction of counts/dw, deterministic ----
  const int kd = K * D;
  const int P = kd + K;
  const int PS = partial_stride(K, D);
  const int blocks = gridDim.x;
  auto write_out = [&](int i, float v) {
    if (i < kd) dw[i] = v; else counts[i - kd] = v;
  };
  if (blocks == 1) {
    for (int i = tid; i < P; i += kThreads) write_out(i, dw_s[i]);
    return;
  }
  float* mine_part = scratch + static_cast<int64_t>(blockIdx.x) * PS;
  for (int i = tid; i < P; i += kThreads) mine_part[i] = dw_s[i];
  VQ_STAMP(9);   // partial written
  cooperative_groups::this_grid().sync();   // every partial is visible
  VQ_STAMP(10);  // past the grid barrier

  // this block's slice of the elements; kThreads of them at a time, the
  // threads left over splitting each element's partials into `runs`
  const int slice = (P + blocks - 1) / blocks;
  const int e0 = blockIdx.x * slice;
  const int e1 = e0 + slice < P ? e0 + slice : P;
  float* run_sum = reinterpret_cast<float*>(smem4);   // kThreads floats
  for (int base = e0; base < e1; base += kThreads) {
    const int n_e = e1 - base < kThreads ? e1 - base : kThreads;
    const int runs = kThreads / n_e;
    const int per_run = (blocks + runs - 1) / runs;
    const int e = tid % n_e, run = tid / n_e;
    float acc = 0.f;
    if (run < runs) {
      const int p1 = (run + 1) * per_run < blocks ? (run + 1) * per_run : blocks;
      const float* src = scratch + base + e;
      for (int p0 = run * per_run; p0 < p1; p0 += kInFlight) {
        float v[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u)   // past L1: other blocks wrote
          v[u] = p0 + u < p1
              ? __ldcg(src + static_cast<int64_t>(p0 + u) * PS) : 0.f;
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) acc += v[u];
      }
    }
    __syncthreads();
    run_sum[tid] = acc;
    __syncthreads();
    if (tid < n_e) {
      float total = 0.f;
      for (int r = 0; r < runs; ++r) total += run_sum[r * n_e + tid];
      write_out(base + tid, total);
    }
  }
  VQ_STAMP(11);  // its slice of the sums written
}

// The statistics as a second pass, for codebooks whose partial statistics do
// not fit on chip: one block per (code, 32-column slice).
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

template <int DT, int RPT, bool FUSED>
cudaError_t launch_search(const Plan& p, const float* z, const float* cb,
                          int64_t n_rows, int K, int D, int32_t* idx, float* q,
                          float* counts, float* dw, float* scratch,
                          cudaStream_t s) {
  auto kernel = vq_search_kernel<DT, RPT, FUSED>;
  if (p.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
  }
  if (FUSED) {   // the grid barrier needs every block resident
    int k_chunk = p.k_chunk, tiles_per_block = p.tiles_per_block;
    void* args[] = {&z, &cb, &n_rows, &K, &D, &k_chunk, &tiles_per_block,
                    &idx, &q, &counts, &dw, &scratch};
    return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                       dim3(p.blocks), dim3(kThreads), args,
                                       p.smem, s);
  }
  kernel<<<p.blocks, kThreads, p.smem, s>>>(z, cb, n_rows, K, D, p.k_chunk,
                                            p.tiles_per_block, idx, q, counts,
                                            dw, scratch);
  return cudaGetLastError();
}

}  // namespace

// out = {fused, device kernels a search, blocks, shared-memory bytes, scratch
// floats}; returns 0, or 1 when the embedding is too wide for a block.
extern "C" int vq_search_plan(int64_t n_rows, int K, int D, int64_t* out) {
  Plan p;
  if (!make_plan(n_rows, K, D, &p)) return 1;
  out[0] = p.fused;
  out[1] = p.fused ? 1 : 2;
  out[2] = p.blocks;
  out[3] = p.smem;
  out[4] = p.scratch;
  return 0;
}

#ifdef VQ_STAMPS
// Point the one-launch kernel's stamps at `buffer` (kStampSlots int64 words a
// block), or at nothing with a null pointer.
extern "C" int vq_search_set_stamps(long long* buffer) {
  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, &buffer, sizeof(buffer)));
}
#endif

// Launches the search on `stream` and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a width no block can hold). `scratch` holds
// vq_search_plan's count of floats (none for a two-launch or one-block
// search) and need not be initialised.
extern "C" int vq_search_f32(const float* z, const float* cb, int64_t n_rows,
                             int K, int D, int32_t* idx, float* q,
                             float* counts, float* dw, float* scratch,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Plan p;
  if (!make_plan(n_rows, K, D, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (p.fused) {
    if (D != 64)
      err = launch_search<0, 4, true>(p, z, cb, n_rows, K, D, idx, q, counts,
                                      dw, scratch, s);
    else if (p.rpt == 1)
      err = launch_search<64, 1, true>(p, z, cb, n_rows, K, D, idx, q, counts,
                                       dw, scratch, s);
    else if (p.rpt == 2)
      err = launch_search<64, 2, true>(p, z, cb, n_rows, K, D, idx, q, counts,
                                       dw, scratch, s);
    else
      err = launch_search<64, 4, true>(p, z, cb, n_rows, K, D, idx, q, counts,
                                       dw, scratch, s);
    return static_cast<int>(err);
  }
  if (D == 64)
    err = p.rpt == 4
        ? launch_search<64, 4, false>(p, z, cb, n_rows, K, D, idx, q, counts,
                                      dw, scratch, s)
        : launch_search<64, 1, false>(p, z, cb, n_rows, K, D, idx, q, counts,
                                      dw, scratch, s);
  else
    err = p.rpt == 4
        ? launch_search<0, 4, false>(p, z, cb, n_rows, K, D, idx, q, counts,
                                     dw, scratch, s)
        : launch_search<0, 1, false>(p, z, cb, n_rows, K, D, idx, q, counts,
                                     dw, scratch, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>(K), static_cast<unsigned>((D + 31) / 32));
  vq_stats_kernel<<<grid, kStatsWarps * 32, 0, s>>>(z, idx, n_rows, K, D,
                                                    counts, dw);
  return static_cast<int>(cudaGetLastError());
}
