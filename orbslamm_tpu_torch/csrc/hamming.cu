// Fused masked Hamming matcher for Hopper (sm_90a), on the tensor cores.
//
// Replaces the Pallas TPU kernel orbslamm_tpu/ops/pallas/hamming.py
// (match_tables, body _match_kernel). Same contract: for 256-bit ORB
// descriptors A [N] and B [M] it takes D = Hamming(a, b), masks an entry
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
// What bounds it on the H100. Per call it reads (N + M) x 32 descriptor
// bytes plus a few scalars per row and column and writes 12 N + 8 M bytes:
// about 0.35 MB at 2048 x 4096, 0.1 us at 3.35 TB/s. The distance product
// is N M 256 bit ANDs and as many popcount additions. The tensor cores'
// 1-bit path (mma .b1 .and.popc, m16n8k256) issues at the int8 m16n8k32's
// rate on this card with 8 times the bit products per instruction, so at
// 8 x the int8 peak (1,979 TOP/s, 700 W) the product takes 0.27 us at
// 2048 x 4096, 0.14 us at 2048 x 2048 and 0.54 us at 2048 x 8192: it
// binds, a little above the bytes. At the int8 peak this kernel's int8
// product would take 8 times as long (1.1-4.3 us); the masks and
// reductions after it take more CUDA-core instructions than either.
// The first version of this kernel spent 8 popcounts per entry (16 a clock
// per SM) and its wrapper a dozen ATen launches per call. Measured (NVIDIA
// H100 80GB HBM3, 700 W; chip_smoke.py, PERF.md): this kernel's two
// launches take about 15 / 17 / 24 us of device time at 2048 x 2048 /
// 4096 / 8192 (window) and 15 us at 2048 x 2048 (epipolar), 1.6-2.6x less
// than the first version's, 0.9-2.3 % of the bound; a block alone runs
// one 128-column tile in about 1.7 us and spends about 3 us on its
// prologue, so latency within a warp, not instruction throughput, is what
// is left.
//
// What the design does about it:
// - Hamming = pop(a) + pop(b) - 2 <bits(a), bits(b)>, the TPU kernel's
//   formula, with the inner product exact in int32 from int8
//   mma.sync.m16n8k32 on 0/1 bits. k-step s of a descriptor is its 32-bit
//   word s, and the four bytes a lane feeds the tensor core are one nibble
//   spread by a multiply (expand4). A block's 32 rows are expanded once
//   into shared memory in fragment order; a column's bits are expanded in
//   registers by the one warp that uses them. Nothing of size [N, 256] or
//   [M, 256] reaches device memory; popcounts are taken once per
//   descriptor.
// - wgmma is not used: at these shapes the int8 product takes 1-4 us at
//   peak, below the epilogue plus a launch, and mma.sync keeps the
//   accumulator layout simple for the epilogue.
// - A block takes 32 rows (two m16 tiles) and walks its share of the
//   columns in tiles of 128; each of its 4 warps owns 32 columns of a tile.
//   The tiles (packed descriptors and column scalars) go through a
//   double-buffered shared-memory ring by cp.async, so the next tile's load
//   overlaps this tile's work; once it landed, each thread turns its column
//   into a popcount and a level (NaN where invalid, so it never goes live).
// - The masks come first: a warp evaluates window, epipolar band and octave
//   band for its 32 x 16 block of two n8 tiles, and where no entry is live
//   it skips the product and the keys (the bands are sparse: a feature has
//   a handful of candidates among thousands). Two n8 tiles share each A
//   fragment load, four independent mma chains.
// - Masks and reductions run on the accumulator fragments. Distances and
//   indices are packed into one u32 key, (d << 23) | index, so a min over
//   keys keeps the lowest index among equal distances whatever order the
//   entries arrive in (a fragment hands a lane its columns out of order);
//   a row keeps its two smallest keys, so a duplicate gives second ==
//   best. Rows merge across the quad's lanes, then across warps in shared
//   memory; columns reduce by shuffles over the 8 row groups of a warp. No
//   FMA in the epipolar band: its plain twin rounds each product.
// - Column keys are written per row tile and row pairs per column split
//   (no atomics, so no fill of the scratch before the call); a second,
//   small kernel merges them (8 row tiles read in parallel per column) and
//   decodes the tables. Measured against atomicMin into one column table
//   filled by a memset: 0.2-1.3 us more device time a call at the main
//   path's shapes, most of it the memset (PERF.md). The columns are split
//   across blocks (grid.y) so that the blocks fill the card's resident
//   slots (4 a SM) at N = 2048.
//
// Limits: N, M < 2^23 (the index field of a key); desc_a and desc_b
// 16-byte aligned with rows of 32 bytes; scalars float32 (level int32 or
// float32), valid as bytes (torch.bool).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 32;    // rows per block: two m16 tiles
constexpr int kCols = 128;   // columns per tile: 32 per warp, 4 n8 tiles
constexpr int kPair = 2;     // n8 tiles whose products are interleaved
constexpr uint32_t kNone = 0xFFFFFFFFu;  // no live entry
constexpr int kShift = 23;               // key = (d << kShift) | index
constexpr uint32_t kIndexMask = (1u << kShift) - 1u;
constexpr float kBig = 1e9f;
constexpr int kMergeCols = 32;  // finalize: columns per block
constexpr int kMergeWays = 8;   // finalize: row tiles read in parallel per column

enum Flags : int {
  kWindow = 1,
  kEpipolar = 2,
  kLevelAInt = 4,  // level_a is int32 (else float32)
  kLevelBInt = 8,  // level_b is int32 (else float32)
};

struct Params {
  const uint8_t* desc_a;    // [n, 32]
  const uint8_t* desc_b;    // [m, 32]
  const uint8_t* valid_a;   // [n] bool
  const uint8_t* valid_b;   // [m] bool
  const float* xy_a;        // [n, 2] or null
  const float* xy_b;        // [m, 2] or null
  const float* radius_b;    // [m] or null
  const void* level_a;      // [n] int32/float32 or null (0)
  const void* level_b;      // [m] int32/float32 or null (0)
  const float* lines_a;     // [n, 3] or null
  const float* epi_thr_b;   // [m] or null
  int n, m, n_pad, m_pad;
  float lvl_lo, lvl_hi;
  int flags;
  int n_split, tiles_per_split, row_tiles;
  uint32_t* part_col;       // [row_tiles, m_pad] column keys
  uint32_t* part_row_key;   // [n_split, n_pad] row best keys
  uint32_t* part_row_sec;   // [n_split, n_pad] row second-best keys
  float* row_best;
  float* row_second;
  int* row_arg;
  float* col_best;
  int* col_arg;
};

// One column tile in shared memory. desc, xy, radius, level and thr arrive
// by cp.async; pb (popcount) and lbf (level as float, NaN where the column
// is invalid or past m, so that it never goes live) are prepared from them.
struct __align__(16) Stage {
  uint4 desc[kCols * 2];   // packed descriptors, 32 bytes a column
  float xy[kCols * 2];
  float radius[kCols];
  uint32_t level[kCols];   // raw int32 or float32 bits
  float thr[kCols];
  uint32_t pb[kCols];
  float lbf[kCols];
};

__device__ __forceinline__ uint32_t expand4(uint32_t w) {
  // the low nibble's four bits, one per byte, as 0/1 bytes
  return ((w & 0xFu) * 0x00204081u) & 0x01010101u;
}

__device__ __forceinline__ void mma_u8(int (&c)[4], const uint4& a, uint32_t b0,
                                       uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool in) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool in) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// merge two (best key, second key) pairs over disjoint column sets: the
// two smallest of four distinct keys
__device__ __forceinline__ void merge_row(uint32_t& key, uint32_t& sec,
                                          uint32_t key2, uint32_t sec2) {
  const uint32_t hi = max(key, key2);
  key = min(key, key2);
  sec = min(min(sec, sec2), hi);
}

__device__ __forceinline__ float level_of(uint32_t raw, bool is_int) {
  return is_int ? static_cast<float>(static_cast<int>(raw)) : __uint_as_float(raw);
}

// Start the copies of column tile `tile` into `st` (thread tid takes column
// tid of the tile; a column past m is zero-filled). Returns the column's
// validity byte, which the prepare step consumes once the copies landed.
template <bool kWin, bool kEpi>
__device__ __forceinline__ uint8_t stage_tile(Stage& st, const Params& p, int tile,
                                              int tid) {
  const int c = tile * kCols + tid;
  const bool in = c < p.m;
  const int cs = in ? c : 0;  // a zero-size copy still names a valid address
  cp_async16(&st.desc[2 * tid], p.desc_b + cs * 32, in);
  cp_async16(&st.desc[2 * tid + 1], p.desc_b + cs * 32 + 16, in);
  if (kWin || kEpi) {
    cp_async4(&st.xy[2 * tid], p.xy_b + 2 * cs, in);
    cp_async4(&st.xy[2 * tid + 1], p.xy_b + 2 * cs + 1, in);
  }
  if (kWin) cp_async4(&st.radius[tid], p.radius_b + cs, in);
  if (kEpi) cp_async4(&st.thr[tid], p.epi_thr_b + cs, in);
  if (p.level_b != nullptr) {
    cp_async4(&st.level[tid], static_cast<const uint32_t*>(p.level_b) + cs, in);
  } else {
    st.level[tid] = 0u;  // 0 as int32 and as float32
  }
  cp_async_commit();
  return in ? p.valid_b[c] : 0;
}

// After this thread's copies of column tid landed: its popcount and its
// level as float, NaN where the column is invalid.
__device__ __forceinline__ void prepare_column(Stage& st, int tid, uint8_t valid,
                                               bool lb_int) {
  cp_async_wait_all();
  const uint4 w0 = st.desc[2 * tid], w1 = st.desc[2 * tid + 1];
  st.pb[tid] = __popc(w0.x) + __popc(w0.y) + __popc(w0.z) + __popc(w0.w) +
               __popc(w1.x) + __popc(w1.y) + __popc(w1.z) + __popc(w1.w);
  st.lbf[tid] = valid ? level_of(st.level[tid], lb_int) : __int_as_float(0x7fc00000);
}

template <bool kWin, bool kEpi>
__global__ void __launch_bounds__(kThreads, 4)
hamming_tiles_kernel(const Params p) {
  __shared__ Stage ring[2];
  __shared__ uint4 s_afrag[2][8][32];  // A fragments: [m16 tile][k-step][lane]
  __shared__ uint32_t s_key[kWarps][kRows];
  __shared__ uint32_t s_sec[kWarps][kRows];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row group of the fragment (0..7)
  const int t = lane & 3;   // lane within the quad (0..3)
  const int row0 = blockIdx.x * kRows;
  const bool lb_int = p.flags & kLevelBInt;

  const int n_tiles = (p.m + kCols - 1) / kCols;
  const int t_begin = blockIdx.y * p.tiles_per_split;
  const int t_end = min(t_begin + p.tiles_per_split, n_tiles);
  uint8_t v_cur = stage_tile<kWin, kEpi>(ring[0], p, t_begin, tid);

  // this lane's four rows: ri = 2 mt + h -> row0 + 16 mt + 8 h + g. Each
  // warp expands the A fragments of k-steps 2 warp and 2 warp + 1 into
  // shared memory, where all four warps read them.
  uint32_t pa_key[4];  // pop(a) << kShift
  float xa[4], ya[4], la[4], lx[4], ly[4], lz[4], den[4];
  uint32_t frag[2][2][4];  // [m16 tile][k-step of this warp][register]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ri = 2 * mt + h;
      const int r = row0 + 16 * mt + 8 * h + g;
      const bool ok = r < p.n;
      uint4 w0 = make_uint4(0, 0, 0, 0), w1 = w0;
      if (ok) {
        const uint4* src = reinterpret_cast<const uint4*>(p.desc_a + r * 32);
        w0 = __ldg(src);
        w1 = __ldg(src + 1);
      }
      const uint32_t w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      int pop = 0;
#pragma unroll
      for (int s = 0; s < 8; ++s) pop += __popc(w[s]);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        // reg 0/1: rows g / g+8, bytes 4t..4t+3; reg 2/3: bytes 16+4t..
        const uint32_t ws = (warp == 0) ? w[k] : (warp == 1) ? w[2 + k]
                          : (warp == 2) ? w[4 + k] : w[6 + k];
        frag[mt][k][h] = expand4(ws >> (4 * t));
        frag[mt][k][2 + h] = expand4(ws >> (16 + 4 * t));
      }
      pa_key[ri] = static_cast<uint32_t>(pop) << kShift;
      float lev = 0.f;
      if (p.level_a != nullptr && ok) {
        lev = (p.flags & kLevelAInt) ? static_cast<float>(static_cast<const int*>(p.level_a)[r])
                                     : static_cast<const float*>(p.level_a)[r];
      }
      // an invalid row never goes live: its level band compares NaN
      la[ri] = (ok && p.valid_a[r]) ? lev : __int_as_float(0x7fc00000);
      xa[ri] = ya[ri] = lx[ri] = ly[ri] = lz[ri] = 0.f;
      if (kWin && ok) {
        xa[ri] = p.xy_a[2 * r];
        ya[ri] = p.xy_a[2 * r + 1];
      }
      if (kEpi && ok) {
        lx[ri] = p.lines_a[3 * r];
        ly[ri] = p.lines_a[3 * r + 1];
        lz[ri] = p.lines_a[3 * r + 2];
      }
      den[ri] = fmaxf(__fadd_rn(__fmul_rn(lx[ri], lx[ri]), __fmul_rn(ly[ri], ly[ri])),
                      1e-12f);
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      s_afrag[mt][2 * warp + k][lane] =
          make_uint4(frag[mt][k][0], frag[mt][k][1], frag[mt][k][2], frag[mt][k][3]);
    }
  }

  uint32_t bkey[4] = {kNone, kNone, kNone, kNone};
  uint32_t bsec[4] = {kNone, kNone, kNone, kNone};

  prepare_column(ring[0], tid, v_cur, lb_int);
  __syncthreads();
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int buf = (tile - t_begin) & 1;
    const Stage& st = ring[buf];
    const bool more = tile + 1 < t_end;
    uint8_t v_next = 0;
    if (more) v_next = stage_tile<kWin, kEpi>(ring[buf ^ 1], p, tile + 1, tid);

#pragma unroll
    for (int j0 = 0; j0 < 4; j0 += kPair) {
      // this lane's columns 2t, 2t+1 of each n8 tile of the pair, and which
      // of its 16 entries are live: bit ((j * 2 + q) * 2 + mt) * 2 + h
      float xb[kPair][2], yb[kPair][2], rb[kPair][2], th[kPair][2], lb[kPair][2];
      uint32_t live = 0;
#pragma unroll
      for (int j = 0; j < kPair; ++j) {
        const int lc = 32 * warp + 8 * (j0 + j) + 2 * t;
        const float4 xy = *reinterpret_cast<const float4*>(&st.xy[2 * lc]);
        const float2 r2 = *reinterpret_cast<const float2*>(&st.radius[lc]);
        const float2 t2 = *reinterpret_cast<const float2*>(&st.thr[lc]);
        const float2 l2 = *reinterpret_cast<const float2*>(&st.lbf[lc]);
        xb[j][0] = xy.x; yb[j][0] = xy.y; xb[j][1] = xy.z; yb[j][1] = xy.w;
        rb[j][0] = r2.x; rb[j][1] = r2.y; th[j][0] = t2.x; th[j][1] = t2.y;
        lb[j][0] = l2.x; lb[j][1] = l2.y;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
#pragma unroll
          for (int ri = 0; ri < 4; ++ri) {
            const float dl = __fsub_rn(lb[j][q], la[ri]);
            bool ok = dl >= p.lvl_lo && dl <= p.lvl_hi;  // false for NaN
            if (kWin) {
              ok = ok && fmaxf(fabsf(__fsub_rn(xa[ri], xb[j][q])),
                               fabsf(__fsub_rn(ya[ri], yb[j][q]))) <= rb[j][q];
            }
            if (kEpi) {
              const float num = __fadd_rn(__fadd_rn(__fmul_rn(lx[ri], xb[j][q]),
                                                    __fmul_rn(ly[ri], yb[j][q])), lz[ri]);
              ok = ok && __fmul_rn(num, num) <= __fmul_rn(th[j][q], den[ri]);
            }
            live |= static_cast<uint32_t>(ok) << ((j * 2 + q) * 4 + ri);
          }
        }
      }
      if (!__any_sync(0xffffffffu, live != 0)) {
        // no live entry in the warp's 32 x 16 block: no product, no keys
        if (g == 0) {
#pragma unroll
          for (int j = 0; j < kPair; ++j) {
            const int lc = 32 * warp + 8 * (j0 + j) + 2 * t;
            *reinterpret_cast<uint2*>(p.part_col + static_cast<size_t>(blockIdx.x) * p.m_pad +
                                      tile * kCols + lc) = make_uint2(kNone, kNone);
          }
        }
        continue;
      }
      // B fragments: column cl + g of each n8 tile, k-step s = word s
      uint32_t wb[kPair][8];
#pragma unroll
      for (int j = 0; j < kPair; ++j) {
        const int col = 32 * warp + 8 * (j0 + j) + g;
        const uint4 b0 = st.desc[2 * col], b1 = st.desc[2 * col + 1];
        wb[j][0] = b0.x; wb[j][1] = b0.y; wb[j][2] = b0.z; wb[j][3] = b0.w;
        wb[j][4] = b1.x; wb[j][5] = b1.y; wb[j][6] = b1.z; wb[j][7] = b1.w;
      }
      int acc[kPair][2][4] = {};
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const uint4 a0 = s_afrag[0][s][lane];
        const uint4 a1 = s_afrag[1][s][lane];
#pragma unroll
        for (int j = 0; j < kPair; ++j) {
          const uint32_t lo = expand4(wb[j][s] >> (4 * t));
          const uint32_t hi = expand4(wb[j][s] >> (16 + 4 * t));
          mma_u8(acc[j][0], a0, lo, hi);
          mma_u8(acc[j][1], a1, lo, hi);
        }
      }
#pragma unroll
      for (int j = 0; j < kPair; ++j) {
        // the accumulator holds columns 2t and 2t+1 of the n8 tile
        const int lc = 32 * warp + 8 * (j0 + j) + 2 * t;
        const uint32_t c0 = static_cast<uint32_t>(tile * kCols + lc);
        const uint2 pb = *reinterpret_cast<const uint2*>(&st.pb[lc]);
        const uint32_t pbk[2] = {(pb.x << kShift) | c0, (pb.y << kShift) | (c0 + 1)};
        uint32_t ckey[2] = {kNone, kNone};
#pragma unroll
        for (int q = 0; q < 2; ++q) {
#pragma unroll
          for (int ri = 0; ri < 4; ++ri) {
            const int mt = ri >> 1, h = ri & 1;
            const uint32_t r = static_cast<uint32_t>(row0 + 16 * mt + 8 * h + g);
            const bool ok = (live >> ((j * 2 + q) * 4 + ri)) & 1u;
            // (pop(a) + pop(b) - 2 <a, b>) << kShift | column, then the
            // same distance with the row as index
            const uint32_t key = pa_key[ri] + pbk[q] -
                                 (static_cast<uint32_t>(acc[j][mt][2 * h + q]) << (kShift + 1));
            const uint32_t rk = ok ? key : kNone;
            const uint32_t hi = max(bkey[ri], rk);
            bkey[ri] = min(bkey[ri], rk);
            bsec[ri] = min(bsec[ri], hi);
            ckey[q] = min(ckey[q], ok ? (key ^ (c0 + q) ^ r) : kNone);
          }
        }
        // columns: min over the 8 row groups of the warp
#pragma unroll
        for (int q = 0; q < 2; ++q) {
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            ckey[q] = min(ckey[q], __shfl_xor_sync(0xffffffffu, ckey[q], off));
          }
        }
        if (g == 0) {
          // m_pad and the column are even: an aligned 8-byte store
          *reinterpret_cast<uint2*>(
              p.part_col + static_cast<size_t>(blockIdx.x) * p.m_pad + c0) =
              make_uint2(ckey[0], ckey[1]);
        }
      }
    }
    if (more) prepare_column(ring[buf ^ 1], tid, v_next, lb_int);
    __syncthreads();  // the next tile is ready and this one may be refilled
  }

  // rows: merge the quad's lanes, then the warps
#pragma unroll
  for (int ri = 0; ri < 4; ++ri) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const uint32_t k2 = __shfl_xor_sync(0xffffffffu, bkey[ri], off);
      const uint32_t s2 = __shfl_xor_sync(0xffffffffu, bsec[ri], off);
      merge_row(bkey[ri], bsec[ri], k2, s2);
    }
  }
  if (t == 0) {
#pragma unroll
    for (int ri = 0; ri < 4; ++ri) {
      const int lr = 16 * (ri >> 1) + 8 * (ri & 1) + g;
      s_key[warp][lr] = bkey[ri];
      s_sec[warp][lr] = bsec[ri];
    }
  }
  __syncthreads();
  if (tid < kRows) {
    uint32_t key = s_key[0][tid], sec = s_sec[0][tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) merge_row(key, sec, s_key[w][tid], s_sec[w][tid]);
    const size_t o = static_cast<size_t>(blockIdx.y) * p.n_pad + row0 + tid;
    p.part_row_key[o] = key;
    p.part_row_sec[o] = sec;
  }
}

// Blocks [0, col_blocks) merge the column keys of all row tiles, 32 columns
// a block with 8 row tiles read in parallel; the rest merge the row pairs
// of all column splits, one row a thread. Then both decode their tables.
__global__ void __launch_bounds__(kMergeCols * kMergeWays)
hamming_finalize_kernel(const Params p, int col_blocks) {
  __shared__ uint32_t s_min[kMergeWays][kMergeCols + 1];
  const int tid = threadIdx.x;
  if (blockIdx.x < col_blocks) {
    const int cx = tid % kMergeCols, ry = tid / kMergeCols;
    const int c = blockIdx.x * kMergeCols + cx;  // < m_pad
    uint32_t key = kNone;
    for (int r = ry; r < p.row_tiles; r += kMergeWays) {
      key = min(key, p.part_col[static_cast<size_t>(r) * p.m_pad + c]);
    }
    s_min[ry][cx] = key;
    __syncthreads();
    if (ry == 0 && c < p.m) {
#pragma unroll
      for (int w = 1; w < kMergeWays; ++w) key = min(key, s_min[w][cx]);
      p.col_best[c] = key == kNone ? kBig : static_cast<float>(key >> kShift);
      p.col_arg[c] = key == kNone ? 0 : static_cast<int>(key & kIndexMask);
    }
    return;
  }
  const int i = (blockIdx.x - col_blocks) * blockDim.x + tid;
  if (i >= p.n) return;
  uint32_t key = kNone, sec = kNone;
  for (int s = 0; s < p.n_split; ++s) {
    const size_t o = static_cast<size_t>(s) * p.n_pad + i;
    merge_row(key, sec, p.part_row_key[o], p.part_row_sec[o]);
  }
  p.row_best[i] = key == kNone ? kBig : static_cast<float>(key >> kShift);
  p.row_second[i] = sec == kNone ? kBig : static_cast<float>(sec >> kShift);
  p.row_arg[i] = key == kNone ? 0 : static_cast<int>(key & kIndexMask);
}

template <bool kWin, bool kEpi>
int blocks_per_sm() {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, hamming_tiles_kernel<kWin, kEpi>,
                                                kThreads, 0);
  return blocks;
}

}  // namespace

extern "C" {

// Tile shape, for the wrapper's scratch sizes: rows per block, columns per
// tile; and how many blocks of the tile kernel an SM holds at once (the
// least over the modes), for the column split.
int hamming_rows_per_block() { return kRows; }
int hamming_tile_cols() { return kCols; }
int hamming_blocks_per_sm() {
  const int a = blocks_per_sm<false, false>(), b = blocks_per_sm<true, false>();
  const int c = blocks_per_sm<false, true>(), d = blocks_per_sm<true, true>();
  return min(min(a, b), min(c, d));
}

// Inputs as the caller holds them (null where absent); flags: bit 0 window,
// bit 1 epipolar, bit 2 level_a int32, bit 3 level_b int32 (enum Flags). Scratch:
// part_col [ceil(n/32), m_pad] u32, part_row_key and part_row_sec
// [n_split, n_pad] u32 (n_pad, m_pad: n, m rounded up to 32 and 128).
// Launches the tile kernel and the finalize kernel on `stream` and returns
// the first cudaError_t (0 = success).
int hamming_match_tables(const void* desc_a, const void* desc_b, int n, int m,
                         const void* valid_a, const void* valid_b,
                         const void* xy_a, const void* xy_b, const void* radius_b,
                         const void* level_a, const void* level_b,
                         const void* lines_a, const void* epi_thr_b,
                         float lvl_lo, float lvl_hi, int flags, int n_split,
                         int tiles_per_split, void* part_col, void* part_row_key,
                         void* part_row_sec, void* row_best, void* row_second,
                         void* row_arg, void* col_best, void* col_arg,
                         void* stream) {
  if (n < 1 || m < 1 || n >= (1 << kShift) || m >= (1 << kShift) || n_split < 1 ||
      tiles_per_split < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int row_tiles = (n + kRows - 1) / kRows;
  const int col_tiles = (m + kCols - 1) / kCols;
  if (static_cast<long long>(n_split) * tiles_per_split < col_tiles ||
      static_cast<long long>(n_split - 1) * tiles_per_split >= col_tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool window = flags & kWindow, epipolar = flags & kEpipolar;
  Params p;
  p.desc_a = static_cast<const uint8_t*>(desc_a);
  p.desc_b = static_cast<const uint8_t*>(desc_b);
  p.valid_a = static_cast<const uint8_t*>(valid_a);
  p.valid_b = static_cast<const uint8_t*>(valid_b);
  p.xy_a = static_cast<const float*>(xy_a);
  p.xy_b = static_cast<const float*>(xy_b);
  p.radius_b = static_cast<const float*>(radius_b);
  p.level_a = level_a;
  p.level_b = level_b;
  p.lines_a = static_cast<const float*>(lines_a);
  p.epi_thr_b = static_cast<const float*>(epi_thr_b);
  p.n = n;
  p.m = m;
  p.n_pad = row_tiles * kRows;
  p.m_pad = col_tiles * kCols;
  p.lvl_lo = lvl_lo;
  p.lvl_hi = lvl_hi;
  p.flags = flags;
  p.n_split = n_split;
  p.tiles_per_split = tiles_per_split;
  p.row_tiles = row_tiles;
  p.part_col = static_cast<uint32_t*>(part_col);
  p.part_row_key = static_cast<uint32_t*>(part_row_key);
  p.part_row_sec = static_cast<uint32_t*>(part_row_sec);
  p.row_best = static_cast<float*>(row_best);
  p.row_second = static_cast<float*>(row_second);
  p.row_arg = static_cast<int*>(row_arg);
  p.col_best = static_cast<float*>(col_best);
  p.col_arg = static_cast<int*>(col_arg);

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(row_tiles, n_split);
  if (window && epipolar) {
    hamming_tiles_kernel<true, true><<<grid, kThreads, 0, st>>>(p);
  } else if (window) {
    hamming_tiles_kernel<true, false><<<grid, kThreads, 0, st>>>(p);
  } else if (epipolar) {
    hamming_tiles_kernel<false, true><<<grid, kThreads, 0, st>>>(p);
  } else {
    hamming_tiles_kernel<false, false><<<grid, kThreads, 0, st>>>(p);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int col_blocks = (m + kMergeCols - 1) / kMergeCols;
  const int row_blocks = (n + kMergeCols * kMergeWays - 1) / (kMergeCols * kMergeWays);
  hamming_finalize_kernel<<<col_blocks + row_blocks, kMergeCols * kMergeWays, 0, st>>>(
      p, col_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
