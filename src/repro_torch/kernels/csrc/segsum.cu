// Segment sums by atomic scatter-add: the sparse executor's hop primitive.
//
// Replaces the TPU kernels
//   segsum_ones  <- segment_sum_ones_pallas   out[p]    = sum_{e: seg[e]=p} w[e]
//   segsum_rows  <- segment_sum_rows_pallas   out[p, d] = sum_{e: seg[e]=p} rows[e, d]
// in src/repro/kernels/segsum_kernel.py, and
//   segment_hist <- segment_hist_pallas       out[p, d] = sum_{n: codes[n]=p} values[n, d]
// in src/repro/kernels/hist_kernel.py, which has segsum_rows' contract and
// launches its row scatter through the segsum_rows entry point.
// Ids outside [0, P) are dropped (the executors' padding convention, and
// the -1 padding of the histogram's callers).
//
// Bound on this card: bytes.  segsum_ones moves 8E + 4P bytes and
// segsum_rows (and segment_hist) 4E + 4ED + 4PD; each edge does one add.
// The TPU kernels recast the scatter as a one-hot contraction on the
// matrix unit, which costs O(E x P) and is why the JAX package caps the
// segment sums at 32k segments.  Here
// every element is one atomicAdd into device memory (resolved in L2), so
// the cost is O(E) or O(E x D) whatever P is, and there is no cap.
//
// Design: a grid-stride loop over edges (segsum_ones) or over (edge,
// column) pairs with the column fastest, so a warp reads contiguous row
// bytes (segsum_rows).  Offsets are 64-bit: dense-message hops of long
// chains reach hundreds of millions of cells.  Counts are integers in
// float32 below 2^24 per cell on the counting path, so the atomics give
// the exact sum in any order.  The histogram's values are any float32, so
// its sums round in the order the atomics land and are not bit-exact.
//
// The kernels allocate nothing and launch on the caller's stream; each
// entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;

__global__ void segsum_ones_kernel(const int32_t* __restrict__ seg,
                                   const float* __restrict__ w,
                                   float* __restrict__ out,
                                   int64_t n_edges, int64_t n_segments) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       e < n_edges; e += stride) {
    const int32_t s = seg[e];
    if (s >= 0 && (int64_t)s < n_segments) atomicAdd(out + s, w[e]);
  }
}

__global__ void segsum_rows_kernel(const int32_t* __restrict__ seg,
                                   const float* __restrict__ rows,
                                   float* __restrict__ out,
                                   int64_t n_edges, int64_t width,
                                   int64_t n_segments) {
  const int64_t total = n_edges * width;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int64_t e = i / width;
    const int64_t d = i - e * width;
    const int32_t s = seg[e];
    if (s >= 0 && (int64_t)s < n_segments)
      atomicAdd(out + (int64_t)s * width + d, rows[i]);
  }
}

int64_t grid_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return blocks < 1 ? 1 : blocks;
}

}  // namespace

extern "C" int segsum_ones(const void* seg, const void* w, void* out,
                           int64_t n_edges, int64_t n_segments,
                           void* stream) {
  segsum_ones_kernel<<<(unsigned)grid_for(n_edges), kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const int32_t*)seg, (const float*)w, (float*)out, n_edges,
      n_segments);
  return (int)cudaGetLastError();
}

extern "C" int segsum_rows(const void* seg, const void* rows, void* out,
                           int64_t n_edges, int64_t width,
                           int64_t n_segments, void* stream) {
  segsum_rows_kernel<<<(unsigned)grid_for(n_edges * width), kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const int32_t*)seg, (const float*)rows, (float*)out, n_edges, width,
      n_segments);
  return (int)cudaGetLastError();
}
