// Fused masked Hamming matcher for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel orbslamm_tpu/ops/pallas/hamming.py
// (match_tables, body _match_kernel). Same contract: for 256-bit ORB
// descriptors A [N] and B [M] it takes D = popcount(a ^ b), masks an entry
// (A row or B column invalid, outside the per-column Chebyshev window,
// outside the epipolar band num^2 <= thr * max(lx^2 + ly^2, 1e-12), or
// lb - la outside [lvl_lo, lvl_hi]) and returns per row the best distance,
// the second best over the other columns and the argmin, and per column the
// best distance and argmin, without materialising [N, M].
//
// Ties follow the TPU kernel: the row argmin is the lowest column, the
// column argmin the earliest row, and a duplicate descriptor gives
// second == best. A masked entry never competes; where a row or column has
// no live entry its best (and second) is BIG = 1e9 (> 256), its argmin 0.
//
// What bounds it on the H100: at the main path's shapes (2048 x 2048 up to
// 2048 x 8192) a call reads well under 1 MB, so bandwidth is no limit. A
// 2048 x 8192 call does about 1.3e8 32-bit popcounts, a few tens of
// microseconds of integer issue across 132 SMs; launch latency and
// occupancy set the time. The design therefore splits the columns across
// blocks (grid.y) so that even N = 2048 fills the card, keeps each row's
// (best, second, arg) in registers, reduces columns first across a warp
// (shuffles), then in shared memory, and only then with one 64-bit global
// atomicMin per column and block. A tiny second kernel merges the column
// splits of each row and unpacks the column keys.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 32;   // one row per lane of a warp
constexpr int kLanes = 8;           // warps per block; each takes every 8th column
constexpr int kThreads = kRowsPerBlock * kLanes;
constexpr int kTileCols = 128;      // columns staged in shared memory at once
constexpr float kBig = 1e9f;
constexpr unsigned long long kNoKey = ~0ull;

// Per-row scalars, packed by the wrapper as [N, 8] f32:
//   x, y, level, line_x, line_y, line_z, valid (0/1), unused
// Per-column scalars, packed as [M, 8] f32:
//   x, y, level, radius, epipolar threshold, valid (0/1), unused, unused

__device__ __forceinline__ void merge_row(float& best, float& second, int& arg,
                                         float b2, float s2, int a2) {
  // combine two partial (best, second, arg) over disjoint column sets
  if (b2 < best || (b2 == best && a2 < arg)) {
    second = fminf(s2, best);
    best = b2;
    arg = a2;
  } else {
    second = fminf(second, b2);
  }
}

template <bool kWindow, bool kEpipolar>
__global__ void __launch_bounds__(kThreads)
match_partial_kernel(const uint32_t* __restrict__ desc_a,
                     const float* __restrict__ rows_a, int n,
                     const uint32_t* __restrict__ desc_b,
                     const float* __restrict__ cols_b, int m,
                     float lvl_lo, float lvl_hi, int tiles_per_split,
                     float* __restrict__ part_best,
                     float* __restrict__ part_second,
                     int* __restrict__ part_arg,
                     unsigned long long* __restrict__ col_key) {
  __shared__ __align__(16) uint32_t s_desc[kTileCols * 8];
  __shared__ __align__(16) float s_cols[kTileCols * 8];
  __shared__ unsigned long long s_key[kTileCols];
  __shared__ float s_best[kLanes][kRowsPerBlock];
  __shared__ float s_second[kLanes][kRowsPerBlock];
  __shared__ int s_arg[kLanes][kRowsPerBlock];

  const int tid = threadIdx.x;
  const int lane_row = tid % kRowsPerBlock;  // == lane id within the warp
  const int col_lane = tid / kRowsPerBlock;  // == warp id
  const int row = blockIdx.x * kRowsPerBlock + lane_row;
  const bool row_in = row < n;

  uint32_t a[8];
  float xa = 0.f, ya = 0.f, la = 0.f, lx = 0.f, ly = 0.f, lz = 0.f;
  bool va = false;
  if (row_in) {
#pragma unroll
    for (int w = 0; w < 8; ++w) a[w] = desc_a[row * 8 + w];
    const float* r = rows_a + row * 8;
    xa = r[0]; ya = r[1]; la = r[2]; lx = r[3]; ly = r[4]; lz = r[5];
    va = r[6] != 0.f;
  } else {
#pragma unroll
    for (int w = 0; w < 8; ++w) a[w] = 0u;
  }
  float den = 0.f;
  if (kEpipolar) den = fmaxf(__fadd_rn(__fmul_rn(lx, lx), __fmul_rn(ly, ly)), 1e-12f);

  float best = kBig, second = kBig;
  int arg = 0;

  const int n_tiles = (m + kTileCols - 1) / kTileCols;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int c0 = tile * kTileCols;
    for (int i = tid; i < kTileCols * 8; i += kThreads) {
      const int c = c0 + i / 8;
      s_desc[i] = c < m ? desc_b[c0 * 8 + i] : 0u;
      // out-of-range columns are staged as invalid: they never go live
      s_cols[i] = c < m ? cols_b[c0 * 8 + i] : 0.f;
    }
    for (int i = tid; i < kTileCols; i += kThreads) s_key[i] = kNoKey;
    __syncthreads();

    for (int cl = col_lane; cl < kTileCols; cl += kLanes) {
      const uint4* bd = reinterpret_cast<const uint4*>(s_desc + cl * 8);
      const uint4 b0 = bd[0], b1 = bd[1];
      const int d = __popc(a[0] ^ b0.x) + __popc(a[1] ^ b0.y) +
                    __popc(a[2] ^ b0.z) + __popc(a[3] ^ b0.w) +
                    __popc(a[4] ^ b1.x) + __popc(a[5] ^ b1.y) +
                    __popc(a[6] ^ b1.z) + __popc(a[7] ^ b1.w);
      const float4 p0 = reinterpret_cast<const float4*>(s_cols + cl * 8)[0];
      const float4 p1 = reinterpret_cast<const float4*>(s_cols + cl * 8)[1];
      bool live = va && p1.y != 0.f;
      if (kWindow) {
        live = live && fmaxf(fabsf(__fsub_rn(xa, p0.x)),
                             fabsf(__fsub_rn(ya, p0.y))) <= p0.w;
      }
      if (kEpipolar) {
        // no FMA contraction: the plain version rounds each product
        const float num = __fadd_rn(__fadd_rn(__fmul_rn(lx, p0.x),
                                              __fmul_rn(ly, p0.y)), lz);
        live = live && __fmul_rn(num, num) <= __fmul_rn(p1.x, den);
      }
      const float dl = __fsub_rn(p0.z, la);
      live = live && dl >= lvl_lo && dl <= lvl_hi;

      const int c = c0 + cl;
      if (live) {
        const float df = static_cast<float>(d);
        // columns arrive in increasing order: a tie keeps the lower column
        if (df < best) {
          second = best;
          best = df;
          arg = c;
        } else if (df < second) {
          second = df;
        }
      }
      if (__any_sync(0xffffffffu, live)) {
        unsigned long long key =
            live ? ((static_cast<unsigned long long>(d) << 32) |
                    static_cast<unsigned int>(row))
                 : kNoKey;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const unsigned long long o = __shfl_xor_sync(0xffffffffu, key, off);
          key = o < key ? o : key;
        }
        if (lane_row == 0) atomicMin(&s_key[cl], key);
      }
    }
    __syncthreads();
    for (int i = tid; i < kTileCols; i += kThreads) {
      const unsigned long long k = s_key[i];
      if (k != kNoKey && c0 + i < m) atomicMin(&col_key[c0 + i], k);
    }
    __syncthreads();
  }

  // merge the kLanes column lanes of each row, lanes in column order
  s_best[col_lane][lane_row] = best;
  s_second[col_lane][lane_row] = second;
  s_arg[col_lane][lane_row] = arg;
  __syncthreads();
  if (col_lane == 0 && row_in) {
    for (int l = 1; l < kLanes; ++l) {
      merge_row(best, second, arg, s_best[l][lane_row], s_second[l][lane_row],
                s_arg[l][lane_row]);
    }
    const int o = blockIdx.y * n + row;
    part_best[o] = best;
    part_second[o] = second;
    part_arg[o] = arg;
  }
}

__global__ void finalize_kernel(const float* __restrict__ part_best,
                                const float* __restrict__ part_second,
                                const int* __restrict__ part_arg, int n_split,
                                int n, int m,
                                const unsigned long long* __restrict__ col_key,
                                float* __restrict__ row_best,
                                float* __restrict__ row_second,
                                int* __restrict__ row_arg,
                                float* __restrict__ col_best,
                                int* __restrict__ col_arg) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    float best = part_best[i], second = part_second[i];
    int arg = part_arg[i];
    for (int s = 1; s < n_split; ++s) {
      merge_row(best, second, arg, part_best[s * n + i],
                part_second[s * n + i], part_arg[s * n + i]);
    }
    row_best[i] = best;
    row_second[i] = second;
    row_arg[i] = min(arg, m - 1);
  }
  if (i < m) {
    const unsigned long long k = col_key[i];
    col_best[i] = k == kNoKey ? kBig : static_cast<float>(k >> 32);
    col_arg[i] = k == kNoKey ? 0 : static_cast<int>(k & 0xffffffffull);
  }
}

template <bool kWindow, bool kEpipolar>
void launch_partial(dim3 grid, cudaStream_t stream, const uint32_t* da,
                    const float* ra, int n, const uint32_t* db,
                    const float* cb, int m, float lvl_lo, float lvl_hi,
                    int tiles_per_split, float* pb, float* ps, int* pa,
                    unsigned long long* key) {
  match_partial_kernel<kWindow, kEpipolar><<<grid, kThreads, 0, stream>>>(
      da, ra, n, db, cb, m, lvl_lo, lvl_hi, tiles_per_split, pb, ps, pa, key);
}

}  // namespace

extern "C" {

// Shape constants the wrapper needs to size the column split and scratch.
int hamming_rows_per_block() { return kRowsPerBlock; }
int hamming_tile_cols() { return kTileCols; }

// desc_a [n, 32] u8, rows_a [n, 8] f32, desc_b [m, 32] u8, cols_b [m, 8] f32;
// scratch part_* [n_split, n], col_key [m] u64; outputs row_* [n], col_* [m].
// Launches on `stream` and returns the launch's cudaError_t (0 = success).
int hamming_match_tables(const void* desc_a, const void* rows_a, int n,
                         const void* desc_b, const void* cols_b, int m,
                         float lvl_lo, float lvl_hi, int use_window,
                         int use_epipolar, int n_split, void* part_best,
                         void* part_second, void* part_arg, void* col_key,
                         void* row_best, void* row_second, void* row_arg,
                         void* col_best, void* col_arg, void* stream) {
  if (n < 1 || m < 1 || n_split < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(col_key, 0xFF,
                                    sizeof(unsigned long long) * m, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int n_tiles = (m + kTileCols - 1) / kTileCols;
  const int tiles_per_split = (n_tiles + n_split - 1) / n_split;
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, n_split);
  const auto* da = static_cast<const uint32_t*>(desc_a);
  const auto* ra = static_cast<const float*>(rows_a);
  const auto* db = static_cast<const uint32_t*>(desc_b);
  const auto* cb = static_cast<const float*>(cols_b);
  auto* pb = static_cast<float*>(part_best);
  auto* ps = static_cast<float*>(part_second);
  auto* pa = static_cast<int*>(part_arg);
  auto* key = static_cast<unsigned long long*>(col_key);
  if (use_window && use_epipolar) {
    launch_partial<true, true>(grid, st, da, ra, n, db, cb, m, lvl_lo, lvl_hi,
                               tiles_per_split, pb, ps, pa, key);
  } else if (use_window) {
    launch_partial<true, false>(grid, st, da, ra, n, db, cb, m, lvl_lo, lvl_hi,
                                tiles_per_split, pb, ps, pa, key);
  } else if (use_epipolar) {
    launch_partial<false, true>(grid, st, da, ra, n, db, cb, m, lvl_lo, lvl_hi,
                                tiles_per_split, pb, ps, pa, key);
  } else {
    launch_partial<false, false>(grid, st, da, ra, n, db, cb, m, lvl_lo,
                                 lvl_hi, tiles_per_split, pb, ps, pa, key);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int total = n > m ? n : m;
  finalize_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      pb, ps, pa, n_split, n, m, key, static_cast<float*>(row_best),
      static_cast<float*>(row_second), static_cast<int*>(row_arg),
      static_cast<float*>(col_best), static_cast<int*>(col_arg));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
