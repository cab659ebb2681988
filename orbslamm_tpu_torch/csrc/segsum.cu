// Sorted segment sum for Hopper (sm_90a): out[s, c] = the sum of vals[e, c]
// over the edges e of segment s, added in one order fixed by the segment
// plan and the tile size, with no atomics on values. Two launches on the
// same inputs give the same bits; so do two replays of a CUDA graph.
//
// Replaces no Pallas kernel. It is the port of the JAX package's
// scatter-free segment sum, orbslamm_tpu/ops/ba.py _make_sorted_segsum
// (bundle_adjust_cg(segsum="sorted")), which XLA compiles there: sort the
// static edge list once, then reduce each segment's sorted run. The port
// runs every float edge-to-node sum of its BA, pose-graph and global-BA
// solves through it because index_add_ on CUDA adds with atomics whose
// order, and so whose float rounding, changes from run to run. It does not
// carry over the JAX form's cumsum and boundary differences: a float cumsum
// on the card does not repeat itself either, and a long running sum loses
// the short segments' bits.
//
// Input, from the segment plan (ops/cuda/segsum.py), built once per solve
// from the solve's static edge list, all int32: perm [rows], the rows
// stably sorted by segment; ids [rows], the segment of each sorted row;
// bounds [n_seg + 1], segment s owning sorted rows bounds[s] ..
// bounds[s + 1]; counters [levels][count_stride], zero between launches.
// A sorted row p reads a[p] if p < split, else b[p - split] (the pose
// graph's pair plan sums both ends of its edges in one call, without a
// copy); values [*, width] and out [n_seg, width] float32, row-major; part
// [n_tiles][2][width] float32 scratch.
//
// Bound: bytes. Each value row is read once and each output row written
// once, plus perm and ids (8 bytes a row) and a few words per segment; there
// is one add per value. The tensor cores do not apply: an mma would round
// the float32 values to TF32 or bf16, and a sum has no products to share.
// Small calls (the pose graph's 417 edges) are bound by latency instead: a
// chain of dependent memory round trips, so the design keeps that chain
// short as well as the bytes in flight.
//
// One launch a call, over even tiles of the sorted rows. The grid is
// ceil(rows / T) tile blocks, T (a wrapper's choice from the width, the row
// count and the card's SM count) at most 256 rows and 32 KB of values, then
// ceil(n_seg / F) fill blocks, F = max(1, 2048 / width) segments: both counts
// come from the static shapes, never from the data, so no launch waits on a
// read back to the host and the LM and CG loops stay free of syncs. A tile
// block loads its perm and ids (a thread a row), then stages its gathered
// rows into shared memory with cp.async, every row's copy issued before the
// first wait: 16 bytes a copy where the width and the value pointers allow
// (width 36 is nine copies a row), else 8 or 4; the arithmetic moves the
// same 4, 2 or 1 floats at once. While the copies fly it marks the rows that
// begin a segment (a ballot a warp) and reads each group's segment bounds.
//
// Inside a tile: the rows are cut into tile-aligned groups of 8; a thread a
// (group, column chunk) adds the group's rows of one segment left to right
// from registers, so every thread works whatever the width. A run that is a
// whole segment piece goes out; a piece across groups adds its groups' sums
// in a pairwise tree over its group index q (q % 2d == 0 takes q + d, for d
// = 1, 2, 4, ...), a warp a column chunk with a lane a group (at most 32
// groups a tile), by shuffles. A piece wholly inside the tile is its
// segment's sum and goes straight to out.
//
// Across tiles: a tile holds at most two cut pieces, the one its first row
// continues (slot 0) and the one its last row begins (slot 1). The block
// writes each to part[tile][slot] and counts itself in, with one atomic
// (acquire-release) a piece, both at once, on the counter of the aligned
// chunk of 32 consecutive pieces that holds it. The block that completes a
// chunk adds its pieces (read through L2; a warp a column chunk, a lane a
// piece) in the same pairwise tree and writes the sum as the chunk's head,
// then counts itself in on the chunk of 32 heads above, and so on; the
// block that completes the top writes out[s]. Each completer sets its
// counter back to 0, so the next launch and a graph replay start clean.
// Because the chunks are aligned powers of two, the result is the pairwise
// tree over all of the segment's pieces, whichever block completes which
// chunk: two launches give the same bits. One counter per segment would
// make one block add a long segment's pieces alone; the chunks spread that
// over many blocks and leave short rounds on the tail.
//
// Empty segments: a fill block writes zeros to every segment of its range
// whose bounds are equal, so no tile spends a thread on one (the dense BA's
// (camera, point) pair plan is almost all empty segments).
//
// What this does about the first design (two launches of a warp per chunk
// of 32 rows, then a warp per segment over its chunks' partials in order):
// one launch, not two; a long segment's partials are added by many blocks in
// a tree of chunks, not walked by one warp (1730 partials of the 55,360
// padded edges on landmark 0); tiles of up to 32 KB staged by asynchronous
// copies, not 32 rows of scalar loads, 4 in flight a lane, and no column
// lanes idle at width 36; and no warp per empty segment.
//
// One plan's counters serve one sum at a time: a plan is not summed on two
// streams at once (the port's solves run on their device's current stream).
// Compiled with -O3 and no --use_fast_math: the kernel only adds, so no FMA
// contraction can change the order. The plain version in the same order is
// segment_sum_tiled_ref (ops/cuda/segsum.py); the tests and chip_smoke.py
// hold the kernel bitwise to it.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kChunk = 32;      // pieces per counted chunk: one warp's lanes
constexpr int kFill = 2048;     // floats of output a fill block covers
constexpr int kGroup = 8;       // rows a thread adds in order (tile-aligned groups)
constexpr int kMaxTile = 256;   // rows of a tile at most: 32 groups, one warp's lanes
constexpr int kMaxGroups = kMaxTile / kGroup;

struct Params {
  const float* a;
  const float* b;
  long long split;  // sorted row p reads a[p] if p < split, else b[p - split]
  const int* perm;
  const int* ids;
  const int* bounds;
  int* counters;
  int count_stride;  // counters of one level: 2 per tile at the smallest tile
  int rows, n_seg, width, tile, n_tiles, fill_ids;
  float* part;
  float* out;
};

// VW consecutive floats of a row, moved and added as one: float4 where the
// width and the value pointers allow 16 bytes, float2 for 8, else float.
template <int VW> struct V;
template <> struct V<1> {
  using T = float;
  __device__ static T add(T x, T y) { return x + y; }
  __device__ static T zero() { return 0.f; }
  __device__ static T down(T x, int d) { return __shfl_down_sync(0xffffffffu, x, d); }
};
template <> struct V<2> {
  using T = float2;
  __device__ static T add(T x, T y) { return make_float2(x.x + y.x, x.y + y.y); }
  __device__ static T zero() { return make_float2(0.f, 0.f); }
  __device__ static T down(T x, int d) {
    return make_float2(__shfl_down_sync(0xffffffffu, x.x, d), __shfl_down_sync(0xffffffffu, x.y, d));
  }
};
template <> struct V<4> {
  using T = float4;
  __device__ static T add(T x, T y) {
    return make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
  }
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static T down(T x, int d) {
    return make_float4(__shfl_down_sync(0xffffffffu, x.x, d), __shfl_down_sync(0xffffffffu, x.y, d),
                       __shfl_down_sync(0xffffffffu, x.z, d), __shfl_down_sync(0xffffffffu, x.w, d));
  }
};

// Threads as row lanes x column lanes: cw column chunks a row lane, rl_n row
// lanes; a thread with r >= rl_n idles.
struct Lanes {
  int cw, rl_n, r, c0;
  bool on;
};

__device__ __forceinline__ Lanes lanes(int chunks) {
  Lanes l;
  l.cw = chunks < kBlock ? chunks : kBlock;
  l.rl_n = kBlock / l.cw;
  l.r = threadIdx.x / l.cw;
  l.c0 = threadIdx.x - l.r * l.cw;
  l.on = l.r < l.rl_n;
  return l;
}

template <int VW>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (VW == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  } else if constexpr (VW == 2) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
  }
}

// Piece q of a segment whose first tile is t0: slot 1 of tile t0 (the piece
// its last row begins), slot 0 of every later tile (the piece its first row
// continues).
__device__ __forceinline__ float* piece(const Params& p, int t0, int q) {
  return p.part + (static_cast<long long>(t0 + q) * 2 + (q == 0 ? 1 : 0)) * p.width;
}

// Counts a block in on the counter of a chunk (its head and level) and
// returns whether it is the last of `count` to arrive; the last sets the
// counter back to 0. Called by one thread after a barrier: the atomic
// releases the block's stores before it (ordered by the barrier) and
// acquires the other blocks'.
__device__ __forceinline__ bool count_in(const Params& p, int level, int t0, int head,
                                         int count) {
  int* ctr = p.counters + static_cast<long long>(level) * p.count_stride + (t0 + head) * 2 +
             (head == 0 ? 1 : 0);
  int before;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(before) : "l"(ctr) : "memory");
  const bool last = before == count - 1;
  if (last) *ctr = 0;
  return last;
}

// The chunk of piece q (of m) at a level whose heads are pieces 0, stride,
// 2 stride, ...: its head and its count of heads.
struct Chunk {
  int head, count;
};
__device__ __forceinline__ Chunk chunk_of(int m, int q, int stride) {
  const int span = kChunk * stride;
  const int head = q / span * span;
  return {head, min(kChunk, (m - head + stride - 1) / stride)};
}

// The block holds piece q (of m) of segment s, written to part; with
// `counted` it has counted in at the first level already and is the last
// there. The block that
// completes a chunk adds it (a warp a column chunk, lane i holding head i,
// the pairwise tree by shuffles) and goes on to the level above; the one
// that completes the top writes out[s].
template <int VW>
__device__ void arrive(const Params& p, int s, int t0, int m, int q, bool counted, int* flag) {
  using Vt = typename V<VW>::T;
  const int nv = p.width / VW;
  const int lane = threadIdx.x % 32;
  int stride = 1;
  for (int level = 0;; ++level) {
    const int heads = (m + stride - 1) / stride;
    const Chunk ch = chunk_of(m, q, stride);
    if (ch.count > 1) {
      if (!(counted && level == 0)) {
        __syncthreads();
        if (threadIdx.x == 0) *flag = count_in(p, level, t0, ch.head, ch.count);
        __syncthreads();
        if (!*flag) return;
      }
      Vt* dst = reinterpret_cast<Vt*>(heads <= kChunk ? p.out + static_cast<long long>(s) * p.width
                                                      : piece(p, t0, ch.head));
      for (int c = threadIdx.x / 32; c < nv; c += kWarps) {
        Vt v = lane < ch.count
                   ? __ldcg(reinterpret_cast<const Vt*>(piece(p, t0, ch.head + lane * stride)) + c)
                   : V<VW>::zero();
        for (int d = 1; d < ch.count; d *= 2) {
          const Vt o = V<VW>::down(v, d);
          if ((lane & (2 * d - 1)) == 0 && lane + d < ch.count) v = V<VW>::add(v, o);
        }
        if (lane == 0) dst[c] = v;
      }
      if (heads <= kChunk) return;
    }
    // a chunk of one head: this block's own; go on up
    q = ch.head;
    stride *= kChunk;
  }
}

template <int VW>
__device__ void fill_empty(const Params& p, int z) {
  using Vt = typename V<VW>::T;
  const int nv = p.width / VW;
  const int s0 = z * p.fill_ids;
  const int s1 = min(s0 + p.fill_ids, p.n_seg);
  const Lanes l = lanes(nv);
  if (!l.on) return;
  for (int s = s0 + l.r; s < s1; s += l.rl_n) {
    if (__ldg(p.bounds + s) != __ldg(p.bounds + s + 1)) continue;
    Vt* o = reinterpret_cast<Vt*>(p.out + static_cast<long long>(s) * p.width);
    for (int c = l.c0; c < nv; c += l.cw) o[c] = V<VW>::zero();
  }
}

template <int VW>
__device__ void tile_sum(const Params& p, int t, unsigned char* smem) {
  using Vt = typename V<VW>::T;
  const int T = p.tile;
  const int W = p.width;
  const int nv = W / VW;
  const int a = t * T;
  const int b = min(a + T, p.rows);
  const int n_rows = b - a;
  const int ng = (n_rows + kGroup - 1) / kGroup;
  const int lane = threadIdx.x % 32;
  Vt* row = reinterpret_cast<Vt*>(smem);  // row k, chunk c: row[k * nv + c]
  int* perm_s = reinterpret_cast<int*>(reinterpret_cast<float*>(smem) + T * W);
  int* ids_s = perm_s + T;
  // per group j, tile-relative: the piece holding its first row [c0, e0),
  // the piece holding its last row [c1, e1); and per 32 rows, the rows that
  // begin a piece (bit i: row 32 w + i)
  __shared__ int sh_c0[kMaxGroups], sh_e0[kMaxGroups], sh_c1[kMaxGroups], sh_e1[kMaxGroups];
  __shared__ unsigned sh_heads[kMaxTile / 32];
  __shared__ int sh_max_nq, sh_flag, sh_first_gs, sh_first_ge, sh_last_gs, sh_last_ge;

  if (threadIdx.x == 0) sh_max_nq = 1;
  if (threadIdx.x < n_rows) {
    perm_s[threadIdx.x] = __ldg(p.perm + a + threadIdx.x);
    ids_s[threadIdx.x] = __ldg(p.ids + a + threadIdx.x);
  }
  __syncthreads();
  const Lanes l = lanes(nv);
  if (l.on) {
#pragma unroll 4
    for (int k = l.r; k < n_rows; k += l.rl_n) {
      const long long src_row = perm_s[k];
      const float* src = src_row < p.split ? p.a + src_row * W : p.b + (src_row - p.split) * W;
      for (int c = l.c0; c < nv; c += l.cw) {
        cp_async<VW>(reinterpret_cast<float*>(row + k * nv + c), src + c * VW);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  // while the values fly: the piece heads, and each group's pieces from the
  // segment bounds
  {
    const int k = threadIdx.x;  // kBlock == kMaxTile: a thread a row
    const unsigned m = __ballot_sync(
        0xffffffffu, k < n_rows && (k == 0 || ids_s[k] != ids_s[k - 1]));
    if (lane == 0) sh_heads[k / 32] = m;
  }
  if (threadIdx.x < ng) {
    const int j = threadIdx.x;
    const int k0 = j * kGroup;
    const int ke = min(k0 + kGroup, n_rows);
    const int s0 = ids_s[k0], s1 = ids_s[ke - 1];
    const int g0s = __ldg(p.bounds + s0), g0e = __ldg(p.bounds + s0 + 1);
    const int g1s = __ldg(p.bounds + s1), g1e = __ldg(p.bounds + s1 + 1);
    sh_c0[j] = max(g0s, a) - a;
    sh_e0[j] = min(g0e, b) - a;
    const int c1 = max(g1s, a) - a, e1 = min(g1e, b) - a;
    sh_c1[j] = c1;
    sh_e1[j] = e1;
    // a piece that begins in group j and leaves it spans this many groups
    if (c1 >= k0 && e1 > ke) atomicMax(&sh_max_nq, (e1 - 1) / kGroup - j + 1);
    if (j == 0) {
      sh_first_gs = g0s;
      sh_first_ge = g0e;
    }
    if (j == ng - 1) {
      sh_last_gs = g1s;
      sh_last_ge = g1e;
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const bool lo_cut = sh_first_gs < a;  // row 0 continues a segment of an earlier tile
  const bool hi_cut = sh_last_ge > b;   // the last row's segment goes on in a later tile
  // A piece's sum: straight to out if the tile holds its whole segment, else
  // to part[tile][slot].
  auto emit = [&](int p0, int p1, Vt v, int c) {
    const bool lo = p0 == 0 && lo_cut;
    const bool hi = p1 == n_rows && hi_cut;
    float* dst = !lo && !hi ? p.out + static_cast<long long>(ids_s[p0]) * W
                            : p.part + (static_cast<long long>(t) * 2 + (lo ? 0 : 1)) * W;
    reinterpret_cast<Vt*>(dst)[c] = v;
  };
  // Each group's runs of one segment, left to right, a thread a (group,
  // column chunk): a run that is a whole piece goes out; the run a piece
  // continues from an earlier group, and the run of a piece that begins in
  // the group and leaves it, wait at their first row for the tree below.
  if (l.on) {
    for (int j = l.r; j < ng; j += l.rl_n) {
      const int k0 = j * kGroup;
      const int n = min(kGroup, n_rows - k0);
      const int c0 = sh_c0[j], e1 = sh_e1[j];
      // the rows after the first that begin a run (a group's bits lie in one word)
      const unsigned starts =
          (sh_heads[k0 / 32] >> (k0 % 32)) & static_cast<unsigned>((1ull << n) - 2ull);
      auto finish = [&](int h, int e, Vt acc, int c) {
        if ((h == 0 && c0 < k0) || (e == n && e1 > k0 + n)) {
          row[(k0 + h) * nv + c] = acc;
        } else {
          emit(k0 + h, e == n ? e1 : k0 + e, acc, c);
        }
      };
      for (int c = l.c0; c < nv; c += l.cw) {
        Vt v[kGroup];  // the group's values in registers
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          if (i < n) v[i] = row[(k0 + i) * nv + c];
        }
        Vt acc = v[0];
        int h = 0;
#pragma unroll
        for (int i = 1; i < kGroup; ++i) {
          if (i < n) {
            if (starts >> i & 1u) {
              finish(h, i, acc, c);
              acc = v[i];
              h = i;
            } else {
              acc = V<VW>::add(acc, v[i]);
            }
          }
        }
        finish(h, n, acc, c);
      }
    }
  }
  // The pieces across groups: a warp a column chunk, lane j holding group
  // j's sums: s0 of the piece it continues (at its first row), s1 of the
  // piece that begins in it and leaves (at that piece's first row); the
  // pairwise tree over each piece's groups by shuffles (q % 2d == 0 takes q
  // + d, the sum of group q + d being its s0); group 0 of a piece sends it
  // out.
  if (sh_max_nq > 1) {
    __syncthreads();
    const int j = lane;
    const int k0 = j * kGroup;
    const int ke = min(k0 + kGroup, n_rows);
    bool has0 = false, has1 = false;
    int q0 = 0, n0 = 0, n1 = 0, c1 = 0;
    if (j < ng) {
      const int c0 = sh_c0[j];
      c1 = sh_c1[j];
      has0 = c0 < k0;
      if (has0) {
        q0 = j - c0 / kGroup;
        n0 = (sh_e0[j] - 1) / kGroup - c0 / kGroup + 1;
      }
      has1 = c1 >= k0 && sh_e1[j] > ke;
      if (has1) n1 = (sh_e1[j] - 1) / kGroup - j + 1;
    }
    for (int c = threadIdx.x / 32; c < nv; c += kWarps) {
      Vt s0 = has0 ? row[k0 * nv + c] : V<VW>::zero();
      Vt s1 = has1 ? row[c1 * nv + c] : V<VW>::zero();
      for (int d = 1; d < sh_max_nq; d *= 2) {
        const Vt o = V<VW>::down(s0, d);
        if (has1 && d < n1) {
          s1 = V<VW>::add(s1, o);
        } else if (has0 && (q0 & (2 * d - 1)) == 0 && q0 + d < n0) {
          s0 = V<VW>::add(s0, o);
        }
      }
      if (has1) emit(c1, sh_e1[j], s1, c);
    }
  }
  // the cut pieces (at most two): count both in at once, then complete
  // what this block completes
  if (!lo_cut && !hi_cut) return;
  const int s_first = ids_s[0], s_last = ids_s[n_rows - 1];
  const bool two = hi_cut && !(lo_cut && s_last == s_first);
  const int t_lo = sh_first_gs / T, m_lo = (sh_first_ge - 1) / T - t_lo + 1;
  const int t_hi = sh_last_gs / T, m_hi = (sh_last_ge - 1) / T - t_hi + 1;  // t_hi == t
  __shared__ bool sh_last[2];
  __syncthreads();
  if (threadIdx.x == 0 && lo_cut) {
    const Chunk ch = chunk_of(m_lo, t - t_lo, 1);
    sh_last[0] = ch.count == 1 || count_in(p, 0, t_lo, ch.head, ch.count);
  }
  if (threadIdx.x == 32 && two) {
    const Chunk ch = chunk_of(m_hi, 0, 1);
    sh_last[1] = ch.count == 1 || count_in(p, 0, t_hi, ch.head, ch.count);
  }
  __syncthreads();
  if (lo_cut && sh_last[0]) {
    arrive<VW>(p, s_first, t_lo, m_lo, t - t_lo, true, &sh_flag);
  }
  if (two && sh_last[1]) {
    arrive<VW>(p, s_last, t_hi, m_hi, 0, true, &sh_flag);
  }
}

template <int VW>
__global__ void __launch_bounds__(kBlock) segsum_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (static_cast<int>(blockIdx.x) < p.n_tiles) {
    tile_sum<VW>(p, blockIdx.x, smem);
  } else {
    fill_empty<VW>(p, blockIdx.x - p.n_tiles);
  }
}

}  // namespace

extern "C" {

// The constants the plain version and the wrapper share with the kernel.
int segsum_group_rows() { return kGroup; }
int segsum_chunk() { return kChunk; }
int segsum_max_tile() { return kMaxTile; }

// One launch on `stream`; returns its cudaError_t. kChunk <= tile <=
// kMaxTile rows; vec (1, 2 or 4 floats moved and added as one) divides width
// and aligns both value pointers; counters hold count_stride >= 2 ceil(rows
// / kChunk) ints a level, enough levels for ceil(rows / kChunk) pieces, all
// zero.
int segsum_launch(const void* a, const void* b, long long split, const void* perm,
                  const void* ids, const void* bounds, void* counters, int count_stride,
                  int rows, int n_seg, int width, int tile, int vec, void* part, void* out,
                  void* stream) {
  if (n_seg <= 0 || width <= 0) return 0;
  const size_t smem = static_cast<size_t>(tile) * width * sizeof(float) +
                      2 * static_cast<size_t>(tile) * sizeof(int);
  if (tile < kChunk || tile > kMaxTile || rows < 0 || (vec != 1 && vec != 2 && vec != 4) ||
      width % vec || smem > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.split = split;
  p.perm = static_cast<const int*>(perm);
  p.ids = static_cast<const int*>(ids);
  p.bounds = static_cast<const int*>(bounds);
  p.counters = static_cast<int*>(counters);
  p.count_stride = count_stride;
  p.rows = rows;
  p.n_seg = n_seg;
  p.width = width;
  p.tile = tile;
  p.n_tiles = (rows + tile - 1) / tile;
  p.fill_ids = width < kFill ? kFill / width : 1;
  p.part = static_cast<float*>(part);
  p.out = static_cast<float*>(out);
  const int grid = p.n_tiles + (n_seg + p.fill_ids - 1) / p.fill_ids;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    segsum_kernel<4><<<grid, kBlock, smem, st>>>(p);
  } else if (vec == 2) {
    segsum_kernel<2><<<grid, kBlock, smem, st>>>(p);
  } else {
    segsum_kernel<1><<<grid, kBlock, smem, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
