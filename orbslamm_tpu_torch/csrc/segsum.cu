// Sorted segment sum for Hopper (sm_90a): out[s, c] = the sum of vals[e, c]
// over the edges e of segment s, added in one order fixed by the segment
// plan, with no atomics. Two launches on the same inputs give the same bits.
//
// Replaces no Pallas kernel. It is the port of the JAX package's
// scatter-free segment sum, orbslamm_tpu/ops/ba.py _make_sorted_segsum
// (bundle_adjust_cg(segsum="sorted")), which XLA compiles there: sort the
// static edge list once, then reduce each segment's sorted run. The port
// runs every float edge-to-node sum of its BA, pose-graph and global-BA
// solves through it because index_add_ on CUDA adds with atomics whose
// order, and so whose float rounding, changes from run to run.
// It does not carry over the JAX form's cumsum and boundary differences: a
// float cumsum on the card does not repeat itself either, and a long
// running sum loses the short segments' bits.
//
// Input, from the segment plan (ops/cuda/segsum.py), built once per solve
// from the solve's static edge list, all int32: perm [E], the edges stably
// sorted by segment; each segment's run of perm cut into chunks of at most
// CHUNK rows, chunk c covering perm[chunk_lo[c] .. chunk_hi[c]) (chunks past
// the last are empty); chunk_start [n_seg + 1], segment s owning chunks
// chunk_start[s] .. chunk_start[s + 1]. vals [E, width] and out
// [n_seg, width] float32, row-major; part [n_chunks, width] float32
// scratch.
//
// Two launches of one kernel, a warp per group of rows. Pass 1: a warp per
// chunk adds the chunk's rows into part[c]. Pass 2: a warp per segment adds
// its chunks' partials, in chunk order, into out[s]. A segment with most of
// the edges (a keyframe's thousands of observations, or the padded edges
// that all point at landmark 0) is spread over many warps in pass 1, and
// the point or pair segments with a handful of edges or none take one
// chunk each. The lanes of a warp form rl row lanes of cw column lanes
// (cw = min(width, 32), rl = 32 / cw): row lane r adds rows r, r + rl, ...
// of the group in turn, a tree of fixed shape (register shuffles) adds the
// row lanes, and columns past cw take further rounds. Grid sizes come from
// the static sizes E and n_seg, never from the data, so no launch waits on
// a read back to the host.
//
// Bound: bytes. Each value row is read once and each output row written once,
// plus the plan's tables (4 bytes an edge, 12 a chunk, 4 a segment); there is
// one add per value, far below any compute limit. The gather through perm
// makes the reads irregular from row to row; within a row, neighbouring
// lanes read neighbouring floats.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kBlock = 256;
constexpr int kWarps = kBlock / kWarp;
constexpr int kChunk = 32;  // rows per chunk of pass 1 (the plan cuts so)

// out[g, :] = sum over k in [lo[g], hi[g]) of src[row(k), :], row(k) =
// perm[k], or k where perm is null; one warp per group g < n_groups.
__global__ void __launch_bounds__(kBlock) group_sum_kernel(
    const float* __restrict__ src, const int* __restrict__ perm, const int* __restrict__ lo,
    const int* __restrict__ hi, int n_groups, int width, float* __restrict__ out) {
  const long long g = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / kWarp;
  if (g >= n_groups) return;  // g is the same for the whole warp
  const int lane = threadIdx.x % kWarp;
  const int k0 = lo[g];
  const int k1 = hi[g];
  const int cw = width < kWarp ? width : kWarp;
  const int rl = kWarp / cw;
  const int r = lane / cw;  // row lane; r >= rl: an idle lane
  const int c0 = lane - r * cw;
  int top = 1;  // the smallest power of two >= rl
  while (top < rl) top <<= 1;
  for (int cb = 0; cb < width; cb += cw) {
    const int c = cb + c0;
    const bool mine = r < rl && c < width;
    float acc = 0.f;
    if (mine) {
#pragma unroll 4
      for (int k = k0 + r; k < k1; k += rl) {
        const long long row = perm ? perm[k] : k;
        acc += src[row * width + c];
      }
    }
    // every lane of the warp takes part in the shuffles
    for (int s = top >> 1; s >= 1; s >>= 1) {
      const float other = __shfl_down_sync(0xffffffffu, acc, s * cw);
      if (r < s && r + s < rl) acc += other;
    }
    if (r == 0 && c < width) out[g * width + c] = acc;
  }
}

}  // namespace

extern "C" {

// Rows per chunk of pass 1, for the plan.
int segsum_chunk_rows() { return kChunk; }

// Both passes on `stream`; returns the launches' cudaError_t. n_chunks is
// the plan's chunk count bound, n_seg + ceil(E / CHUNK).
int segsum_launch(const void* vals, const void* perm, const void* chunk_lo,
                  const void* chunk_hi, const void* chunk_start, int n_chunks, int n_seg,
                  int width, void* part, void* out, void* stream) {
  if (n_seg <= 0 || width <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_chunks > 0) {
    group_sum_kernel<<<(n_chunks + kWarps - 1) / kWarps, kBlock, 0, st>>>(
        static_cast<const float*>(vals), static_cast<const int*>(perm),
        static_cast<const int*>(chunk_lo), static_cast<const int*>(chunk_hi), n_chunks, width,
        static_cast<float*>(part));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int* cs = static_cast<const int*>(chunk_start);
  group_sum_kernel<<<(n_seg + kWarps - 1) / kWarps, kBlock, 0, st>>>(
      static_cast<const float*>(part), nullptr, cs, cs + 1, n_seg, width,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
