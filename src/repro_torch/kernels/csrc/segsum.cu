// Segment sums by scatter-add: the sparse executor's hop primitive.
//
// Replaces the TPU kernels
//   segsum_ones  <- segment_sum_ones_pallas   out[p]    = sum_{e: seg[e]=p} w[e]
//   segsum_rows  <- segment_sum_rows_pallas   out[p, d] += sum_{e: seg[e]=p} rows[e, d]
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
// segment sums at 32k segments.  Here the cost is O(E) or O(E x D)
// whatever P is, and there is no cap.
//
// segsum_ones (K1) fills an `out` its caller allocated uninitialised, in
// one of two regimes that the caller chooses (repro_torch.kernels.segsum
// .ones_plan, from E, P and the card's shared memory) and passes in:
//  * privatised, for few segments and many edges each: the entity
//    histograms, P = 1 to 27 segments over 100,000 rows at IMDb, where one
//    device atomic per edge piled 100,000 of them onto 1 to 27 addresses
//    (0.0256 to 0.1774 ms a call on an NVIDIA H100 80GB HBM3 at 700 W,
//    scripts/profile_k1_k4.py).  A zero kernel clears out, then thread t
//    keeps column t of a [P, 256] table in shared memory, alone, so it
//    adds with no atomics and no bank conflict (address p x 256 + t is in
//    bank t % 32); then each warp sums whole segments across the 256
//    columns and adds each non-zero sum into out once.  1 KB of shared
//    memory a segment.  What bounds it is the flush: every block's sums
//    land on the same P addresses, so the plan takes sqrt(E / 6P) blocks.
//  * direct, otherwise: the hops, P = 10.8M at IMDb, a 43 MB table.  The
//    bound is bytes (8E + 4P), but the work is writing the table as zeros
//    (at about the memory's rate) and then E random read-modify-writes
//    into it, which run about three times faster while the table is in
//    L2 than once it has fallen out (a 43 MB table does, on a card with
//    50 MB of L2).  A table of at most 12 MiB, or too few edges to pay
//    for slicing, is zeroed by the zero kernel and then scattered
//    (segsum_ones_direct_kernel); a larger one by one cooperative launch
//    in slices of at most 12 MiB (segsum_ones_sliced_kernel): phase k
//    zeroes slice k and scatters the edges of slice k - 1 while it is in
//    L2, a grid barrier between phases.  A barrier costs about what
//    50,000 edges gain, hence the plan's threshold.
// Both read ids and weights with 16-byte loads, four edges a thread, where
// both are 16-byte aligned, and one edge at a time otherwise (views at a
// 4-byte offset).  Ids outside [0, P) are dropped.  The zeros go out as
// 16-byte stores.  Counts are integer-valued floats below 2^24, so every
// order of the additions gives the exact sum.  ptxas (chip_smoke.py phase
// 2): segsum_ones_direct_kernel 24 registers, segsum_ones_sliced_kernel
// 52, segsum_ones_private_kernel 25, segsum_ones_zero_kernel 32; no
// spills.
// segsum_rows runs in one of two regimes, which the caller chooses
// (repro_torch.kernels.segsum.rows_plan, from E, D, P and the card's
// shared memory) and passes in:
//  * privatised, when every segment's partial sums fit in shared memory
//    (few segments, many edges each: the root combine, P = 27 at IMDb, 3
//    at VisualGenome).  A block owns a column tile of T = 4 x 2^k <= 1024
//    columns and a range of edges, stages the range's ids in shared memory
//    256 at a time, and streams the rows in with 16-byte loads, eight rows
//    in flight per thread.  Each thread owns four columns of the tile (a
//    slot) in one lane: with T = 1024 there is one lane and each thread is
//    the only writer of its columns; a narrower tile leaves 1024 / T lanes
//    that take turns over the edges, each with a [P, T] table of its own.
//    So no two threads ever add into one shared address and no atomics
//    are needed (one table shared by the lanes through shared-memory
//    float atomics, the first design, ran slower on an H100 than the
//    direct regime at bench_hist's shape).  The tables take 4 KB per
//    segment whatever T is.  At the end the block sums its lanes' tables
//    and adds each non-zero sum into out with one 16-byte vector
//    reduction (red.global.add.v4.f32).  Device-memory reductions fall
//    from E x D to about splits x P x D.
//  * direct, otherwise (many segments: the dense-message hops, and
//    bench_hist's 1,024 segments).  A group of 2^k <= 32 threads takes an
//    edge row, reads its id once, and walks the row's columns in steps of
//    four with int32 offsets, adding each non-zero quad into out with one
//    vector reduction; each thread keeps four rows' ids and then their
//    values in flight.  A row with an out-of-range id skips its loads.
// Both regimes take 16-byte loads and reductions when D % 4 == 0 and rows
// and out are 16-byte aligned, and otherwise the scalar path of the same
// kernel (4-byte loads and atomicAdd; the executors pass views at any
// offset).  No per-element division: offsets come from shifts and one
// 64-bit multiply per row.  Counts are integers in float32 below 2^24 per
// cell on the counting path, so any order of addition gives the exact sum;
// adding a partial sum of zero is skipped, which changes nothing but the
// sign of a zero.  The histogram's values are any float32, so its sums
// round in the order the additions land and are not bit-exact.
//
// hop_ids builds the sparse executor's segment ids on the card.  It
// replaces no TPU kernel: the JAX package computes the same int32
// arithmetic in XLA on its staged input packs.  For plan p of a group of
// b, edge e of n_p, with g = gather_p[e] (e where there is no gather):
//   code  = fold over the columns c: code * card_c + col_c[g or e]
//   seg[off_p + e]  = p * step + scatter_p[e] * mult + code
//   gidx[off_p + e] = p * gather_step + g        (dense hops only)
// The child entity's attribute columns are read at g, the edge's own
// attribute columns at e; with neither gather nor scatter it is the
// entity codes of a root or a histogram.  Per-plan pointers and offsets
// come from an int64 argument table: cards[n_cols], gathered[n_cols],
// then a row per plan of offset, edges, gather, scatter and n_cols
// column pointers (0 where a plan has no gather or scatter).  Every id is
// below b * step <= 2^31, so the int64 sums cast to the int32 ids the
// host's arithmetic gave, bit for bit.  Bound: bytes, 4 B a column read
// and 4 B (8 B with gidx) written an edge, plus gather and scatter.
// Grid: y over plans, x over a plan's edges; the child's columns are
// entity tables of 4 B a row (800 KB at VisualGenome), read at random
// from L2.
//
// The kernels allocate nothing and launch on the caller's stream; each
// entry point returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for a plan it cannot run.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlicedThreads = 1024;  // K1's sliced cooperative launch
constexpr int64_t kMaxBlocks = 132 * 32;
constexpr int kUnroll = 8;          // rows in flight per thread (privatised)
constexpr int kRows = 4;            // rows in flight per thread (direct)
constexpr int kMaxSlotsLog2 = 8;    // kThreads slots of 4 columns
constexpr int kMaxGroupLog2 = 5;    // a warp per row (direct)

// --- segsum_ones (K1) -----------------------------------------------------

// out[0, n) = 0 by the grid's threads `tid` of `nthreads`: 16-byte stores
// from the first 16-byte boundary, scalar ones around them.
__device__ __forceinline__ void zero_table(float* out, int64_t n,
                                           int64_t tid, int64_t nthreads) {
  const int64_t off = (int64_t)((16 - ((uintptr_t)out & 15)) & 15) / 4;
  const int64_t head = min(n, off);
  const int64_t quads = (n - head) / 4;
  float4* q = reinterpret_cast<float4*>(out + head);
  for (int64_t i = tid; i < quads; i += nthreads)
    q[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid < head) out[tid] = 0.f;
  for (int64_t i = head + 4 * quads + tid; i < n; i += nthreads) out[i] = 0.f;
}

// The edges of the grid's thread `tid` of `nthreads`, add(s, w) for each:
// four at a time (one 16-byte load of ids and one of weights) from quad
// `tid + start` where `vec` (then the tail of fewer than four), else one
// at a time.
template <typename Add>
__device__ __forceinline__ void for_edges(const int32_t* __restrict__ seg,
                                          const float* __restrict__ w,
                                          int64_t n_edges, bool vec,
                                          int64_t tid, int64_t nthreads,
                                          int64_t start, Add add) {
  int64_t e = tid;
  if (vec) {
    const int64_t quads = n_edges / 4;
    for (int64_t i = tid + start; i < quads; i += nthreads) {
      const int4 s = __ldcs(reinterpret_cast<const int4*>(seg) + i);
      const float4 v = __ldcs(reinterpret_cast<const float4*>(w) + i);
      add(s.x, v.x);
      add(s.y, v.y);
      add(s.z, v.z);
      add(s.w, v.w);
    }
    e = 4 * quads + tid;
  }
  for (; e < n_edges; e += nthreads) add(__ldcs(seg + e), __ldcs(w + e));
}

// Direct regime: each edge adds into out where it lands (a reduction
// resolved in L2); segsum_ones_zero_kernel ran before it on the stream.
__global__ void __launch_bounds__(kThreads)
segsum_ones_direct_kernel(const int32_t* __restrict__ seg,
                          const float* __restrict__ w, float* out,
                          int64_t n_edges, int32_t n_segments, bool vec) {
  for_edges(seg, w, n_edges, vec, (int64_t)blockIdx.x * kThreads + threadIdx.x,
            (int64_t)gridDim.x * kThreads, 0, [&](int32_t s, float v) {
              if (s >= 0 && s < n_segments) atomicAdd(out + s, v);
            });
}

// Direct regime over a table larger than L2 keeps: one cooperative launch
// (every block resident at once) zeroes out itself in `slices` slices of
// `slice` floats (a multiple of 4) and scatters slice by slice: in phase
// k it zeroes slice k and scatters the edges whose ids fall in slice
// k - 1, which the grid barrier closing phase k - 1 saw zeroed and which
// is still in L2.  Each thread keeps its first quad of edges in
// registers through the phases and reads any others again each phase.
// Blocks of kSlicedThreads, so that few blocks meet at each barrier.
__global__ void __launch_bounds__(kSlicedThreads)
segsum_ones_sliced_kernel(const int32_t* __restrict__ seg,
                          const float* __restrict__ w, float* out,
                          int64_t n_edges, int32_t n_segments, bool vec,
                          int64_t slices, int64_t slice) {
  const int64_t tid = (int64_t)blockIdx.x * kSlicedThreads + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * kSlicedThreads;
  int4 s0 = make_int4(-1, -1, -1, -1);
  float4 v0 = make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec && tid < n_edges / 4) {
    s0 = __ldcs(reinterpret_cast<const int4*>(seg) + tid);
    v0 = __ldcs(reinterpret_cast<const float4*>(w) + tid);
  }
  for (int64_t k = 0; k <= slices; ++k) {
    if (k < slices)
      zero_table(out + k * slice, min(slice, n_segments - k * slice), tid,
                 nthreads);
    if (k > 0) {
      const int64_t lo = (k - 1) * slice;
      const int64_t hi = min(lo + slice, (int64_t)n_segments);
      auto add = [&](int32_t s, float v) {
        if (s >= lo && s < hi) atomicAdd(out + s, v);
      };
      add(s0.x, v0.x);
      add(s0.y, v0.y);
      add(s0.z, v0.z);
      add(s0.w, v0.w);
      for_edges(seg, w, n_edges, vec, tid, nthreads, vec ? nthreads : 0,
                add);
    }
    if (k < slices) cooperative_groups::this_grid().sync();
  }
}

// Privatised regime: thread t keeps column t of a [n_segments, kThreads]
// table in shared memory (bank t % 32 whatever the segment), the only
// writer of its column, so no atomics; then each warp sums whole segments
// across the columns and adds each non-zero sum into out, which
// segsum_ones_zero_kernel zeroed before it on the stream, once.
__global__ void __launch_bounds__(kThreads)
segsum_ones_private_kernel(const int32_t* __restrict__ seg,
                           const float* __restrict__ w, float* out,
                           int64_t n_edges, int32_t n_segments, bool vec) {
  extern __shared__ float table[];
  const int t = threadIdx.x;
  float* mine = table + t;
  for (int p = 0; p < n_segments; ++p) mine[p * kThreads] = 0.f;
  for_edges(seg, w, n_edges, vec, (int64_t)blockIdx.x * kThreads + t,
            (int64_t)gridDim.x * kThreads, 0, [&](int32_t s, float v) {
              if (s >= 0 && s < n_segments) mine[s * kThreads] += v;
            });
  __syncthreads();
  const int lane = t & 31;
  for (int p = t >> 5; p < n_segments; p += kThreads / 32) {
    float sum = 0.f;
    for (int c = lane; c < kThreads; c += 32) sum += table[p * kThreads + c];
#pragma unroll
    for (int h = 16; h > 0; h /= 2)
      sum += __shfl_down_sync(0xffffffffu, sum, h);
    if (lane == 0 && sum != 0.f) atomicAdd(out + p, sum);
  }
}

__global__ void __launch_bounds__(kThreads)
segsum_ones_zero_kernel(float* out, int64_t n) {
  zero_table(out, n, (int64_t)blockIdx.x * kThreads + threadIdx.x,
             (int64_t)gridDim.x * kThreads);
}

// --- segsum_rows (K2) -----------------------------------------------------

// Four columns [p, p + 4) of a row, streamed (read once); on the scalar
// path only the first `left` of them exist.
__device__ __forceinline__ float4 load4(const float* p, bool vec, int left) {
  if (vec) return __ldcs(reinterpret_cast<const float4*>(p));
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (left > 0) v.x = __ldcs(p);
  if (left > 1) v.y = __ldcs(p + 1);
  if (left > 2) v.z = __ldcs(p + 2);
  if (left > 3) v.w = __ldcs(p + 3);
  return v;
}

// out[p, p + 4) += v in device memory, skipping zeros; one 16-byte
// reduction on the vector path.
__device__ __forceinline__ void red4(float* p, float4 v, bool vec, int left) {
  if (vec) {
    if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)
      atomicAdd(reinterpret_cast<float4*>(p), v);
    return;
  }
  if (left > 0 && v.x != 0.f) atomicAdd(p, v.x);
  if (left > 1 && v.y != 0.f) atomicAdd(p + 1, v.y);
  if (left > 2 && v.z != 0.f) atomicAdd(p + 2, v.z);
  if (left > 3 && v.w != 0.f) atomicAdd(p + 3, v.w);
}

// Privatised regime.  Grid (column tiles, edge splits); dynamic shared
// memory: one [n_segments, 1 << slots_log2] table of float4 partial sums
// per lane, kThreads x n_segments float4 in all.
__global__ void __launch_bounds__(kThreads)
rows_private_kernel(const int32_t* __restrict__ seg,
                    const float* __restrict__ rows, float* __restrict__ out,
                    int64_t n_edges, int32_t width, int32_t n_segments,
                    int32_t slots_log2, int64_t edges_per_block, bool vec) {
  extern __shared__ float4 acc[];
  __shared__ int32_t ids[kThreads];
  const int slots = 1 << slots_log2;
  const int slot = threadIdx.x & (slots - 1);
  const int lane = threadIdx.x >> slots_log2;
  const int lanes = kThreads >> slots_log2;
  const int table = n_segments << slots_log2;   // float4s in a lane's table
  const int col0 = (int)(blockIdx.x << (slots_log2 + 2));
  const int left = width - col0 - (slot << 2);
  const int64_t e_begin = (int64_t)blockIdx.y * edges_per_block;
  const int64_t e_end = min(n_edges, e_begin + edges_per_block);
  float4* mine = acc + lane * table + slot;

  for (int i = threadIdx.x; i < lanes * table; i += kThreads)
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int64_t base = e_begin; base < e_end; base += kThreads) {
    const int n = (int)min((int64_t)kThreads, e_end - base);
    if ((int)threadIdx.x < n) {
      const int32_t s = seg[base + threadIdx.x];
      ids[threadIdx.x] = (s >= 0 && s < n_segments) ? s : -1;
    }
    __syncthreads();   // ids staged (and, the first time, the tables zeroed)
    if (left > 0) {
      const float* src = rows + base * width + col0 + (slot << 2);
      for (int i0 = lane; i0 < n; i0 += kUnroll * lanes) {
        float4 v[kUnroll];
        int s[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * lanes;
          s[u] = i < n ? ids[i] : -1;
          v[u] = s[u] >= 0 ? load4(src + (int64_t)i * width, vec, left)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (s[u] < 0) continue;
          float4* a = mine + (s[u] << slots_log2);   // this thread's alone
          float4 t = *a;
          t.x += v[u].x;
          t.y += v[u].y;
          t.z += v[u].z;
          t.w += v[u].w;
          *a = t;
        }
      }
    }
    __syncthreads();   // ids read (and, the last time, the tables complete)
  }
  // sum the lanes' tables, in lane order, and add the sums into out
  for (int c = threadIdx.x; c < table; c += kThreads) {
    const int col = col0 + ((c & (slots - 1)) << 2);
    if (col >= width) continue;
    float4 sum = acc[c];
    for (int l = 1; l < lanes; ++l) {
      const float4 x = acc[l * table + c];
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    red4(out + (int64_t)(c >> slots_log2) * width + col, sum, vec,
         width - col);
  }
}

// Direct regime.  A group of 1 << group_log2 threads per edge row, a
// grid-stride loop over rows, kRows rows at a time so that their ids and
// then their values are in flight together.
__global__ void __launch_bounds__(kThreads)
rows_direct_kernel(const int32_t* __restrict__ seg,
                   const float* __restrict__ rows, float* __restrict__ out,
                   int64_t n_edges, int32_t width, int32_t n_segments,
                   int32_t group_log2, bool vec) {
  const int g = threadIdx.x & ((1 << group_log2) - 1);
  const int step = 4 << group_log2;
  const int64_t per_block = kThreads >> group_log2;
  const int64_t stride = (int64_t)gridDim.x * per_block;
  for (int64_t e0 = (int64_t)blockIdx.x * per_block
                    + (threadIdx.x >> group_log2);
       e0 < n_edges; e0 += kRows * stride) {
    int32_t s[kRows];
    const float* src[kRows];
    float* dst[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int64_t e = e0 + u * stride;
      s[u] = e < n_edges ? __ldg(seg + e) : -1;
      if (s[u] >= n_segments) s[u] = -1;
      src[u] = rows + e * width;
      dst[u] = out + (int64_t)max(s[u], 0) * width;
    }
    for (int c = g << 2; c < width; c += step) {
      float4 v[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        v[u] = s[u] >= 0 ? load4(src[u] + c, vec, width - c)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        if (s[u] >= 0) red4(dst[u] + c, v[u], vec, width - c);
    }
  }
}

// --- hop_ids ----------------------------------------------------------------

constexpr int kIdsMaxCols = 32;     // columns a plan's code folds
constexpr int kIdsRow = 4;          // offset, edges, gather, scatter

__global__ void __launch_bounds__(kThreads)
hop_ids_kernel(const int64_t* __restrict__ table, int64_t n_plans,
               int n_cols, int64_t step, int64_t mult, int64_t gather_step,
               int32_t* __restrict__ seg, int32_t* __restrict__ gidx) {
  __shared__ int64_t card[kIdsMaxCols];
  __shared__ bool at_gather[kIdsMaxCols];
  __shared__ const int32_t* col[kIdsMaxCols];
  __shared__ const int32_t* gather;
  __shared__ const int32_t* scatter;
  __shared__ int64_t off, n_edges;
  const int t = threadIdx.x;
  if (t < n_cols) {
    card[t] = table[t];
    at_gather[t] = table[n_cols + t] != 0;
  }
  const int64_t width = kIdsRow + n_cols;
  for (int64_t p = blockIdx.y; p < n_plans; p += gridDim.y) {
    const int64_t* row = table + 2 * n_cols + p * width;
    if (t == 0) {
      off = row[0];
      n_edges = row[1];
      gather = reinterpret_cast<const int32_t*>((uintptr_t)row[2]);
      scatter = reinterpret_cast<const int32_t*>((uintptr_t)row[3]);
    }
    if (t < n_cols)
      col[t] = reinterpret_cast<const int32_t*>((uintptr_t)row[kIdsRow + t]);
    __syncthreads();   // the plan's row (and the cards) staged
    for (int64_t e = (int64_t)blockIdx.x * kThreads + t; e < n_edges;
         e += (int64_t)gridDim.x * kThreads) {
      const int64_t g = gather ? (int64_t)__ldg(gather + e) : e;
      int64_t code = 0;
      for (int c = 0; c < n_cols; ++c)
        code = code * card[c] + __ldg(col[c] + (at_gather[c] ? g : e));
      int64_t id = p * step + code;
      if (scatter) id += (int64_t)__ldg(scatter + e) * mult;
      seg[off + e] = (int32_t)id;
      if (gidx) gidx[off + e] = (int32_t)(p * gather_step + g);
    }
    __syncthreads();   // every thread is done with the row
  }
}

int64_t grid_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return blocks < 1 ? 1 : blocks;
}

int log2_of(int64_t x) {   // log2 of a power of two, else -1
  if (x < 1 || (x & (x - 1))) return -1;
  int k = 0;
  while ((int64_t)1 << k < x) ++k;
  return k;
}

}  // namespace

// out[P] = segment sums of w[E] by seg[E] into an uninitialised out, in
// the regime the caller chose: 0 direct, 1 privatised, on `blocks`
// blocks.  `slices` 0: a zero kernel first, then the regime's kernel;
// `slices` >= 1 (direct only): one cooperative launch of
// segsum_ones_sliced_kernel in that many slices, its grid cut to the
// blocks the card holds at once.
extern "C" int segsum_ones(const void* seg, const void* w, void* out,
                           int64_t n_edges, int64_t n_segments, int regime,
                           int64_t blocks, int64_t slices, void* stream) {
  if (n_edges < 1 || n_segments < 1 || n_segments > INT32_MAX || blocks < 1
      || blocks > INT32_MAX || (regime != 0 && regime != 1) || slices < 0
      || (regime == 1 && slices > 0) || slices > n_segments)
    return (int)cudaErrorInvalidValue;
  const bool vec = (uintptr_t)seg % 16 == 0 && (uintptr_t)w % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t p32 = (int32_t)n_segments;
  const int32_t* s32 = (const int32_t*)seg;
  const float* wf = (const float*)w;
  float* o = (float*)out;
  if (slices > 0) {
    const void* fn = (const void*)segsum_ones_sliced_kernel;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fn, kSlicedThreads, 0);
    if (err != cudaSuccess) return (int)err;
    const int64_t most = (int64_t)per_sm * sms;
    if (most < 1) return (int)cudaErrorInvalidConfiguration;
    const unsigned grid = (unsigned)(blocks < most ? blocks : most);
    // a slice of whole quads, so that every slice stays 16-byte aligned
    int64_t slice = (n_segments + slices - 1) / slices;
    slice = (slice + 3) / 4 * 4;
    int64_t n_slices = (n_segments + slice - 1) / slice;
    void* args[] = {(void*)&s32,     (void*)&wf,  (void*)&o,
                    (void*)&n_edges, (void*)&p32, (void*)&vec,
                    (void*)&n_slices, (void*)&slice};
    return (int)cudaLaunchCooperativeKernel(fn, grid, kSlicedThreads, args,
                                            0, st);
  }
  segsum_ones_zero_kernel<<<(unsigned)grid_for((n_segments + 3) / 4),
                            kThreads, 0, st>>>(o, n_segments);
  if (regime == 1) {
    const int64_t smem = n_segments * kThreads * 4;
    if (smem > INT32_MAX) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          segsum_ones_private_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    segsum_ones_private_kernel<<<(unsigned)blocks, kThreads, (size_t)smem,
                                 st>>>(s32, wf, o, n_edges, p32, vec);
  } else {
    segsum_ones_direct_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        s32, wf, o, n_edges, p32, vec);
  }
  return (int)cudaGetLastError();
}

// out[P, D] += segment sums of rows[E, D] by seg[E], in the regime the
// caller chose: regime 1 (privatised) with `tile` columns per block
// (4 x 2^k <= 1024) over `blocks` edge splits, or regime 0 (direct) with
// `tile` threads per row (2^k <= 32) on `blocks` blocks.
extern "C" int segsum_rows(const void* seg, const void* rows, void* out,
                           int64_t n_edges, int64_t width,
                           int64_t n_segments, int regime, int64_t tile,
                           int64_t blocks, void* stream) {
  if (n_edges < 0 || width < 1 || width > (1 << 30) || n_segments < 1
      || n_segments > INT32_MAX || blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (n_edges == 0) return (int)cudaSuccess;
  const bool vec = width % 4 == 0 && (uintptr_t)rows % 16 == 0
                   && (uintptr_t)out % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (regime == 1) {
    const int slots_log2 = log2_of(tile / 4);
    const int64_t smem = n_segments * kThreads * (int64_t)sizeof(float4);
    if (tile % 4 || slots_log2 < 0 || slots_log2 > kMaxSlotsLog2
        || blocks > 65535 || smem > INT32_MAX)
      return (int)cudaErrorInvalidValue;
    // the staged ids are static shared memory beside the tables: past 48 KB
    // in all (12 segments and more) the launch needs the opt-in
    if (smem + kThreads * (int64_t)sizeof(int32_t) > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          rows_private_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    const int64_t per_block = (n_edges + blocks - 1) / blocks;
    const dim3 grid((unsigned)((width + tile - 1) / tile),
                    (unsigned)((n_edges + per_block - 1) / per_block));
    rows_private_kernel<<<grid, kThreads, (size_t)smem, st>>>(
        (const int32_t*)seg, (const float*)rows, (float*)out, n_edges,
        (int32_t)width, (int32_t)n_segments, slots_log2, per_block, vec);
  } else if (regime == 0) {
    const int group_log2 = log2_of(tile);
    if (group_log2 < 0 || group_log2 > kMaxGroupLog2 || blocks > INT32_MAX)
      return (int)cudaErrorInvalidValue;
    rows_direct_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        (const int32_t*)seg, (const float*)rows, (float*)out, n_edges,
        (int32_t)width, (int32_t)n_segments, group_log2, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The card's limits that the regime choice reads: 0 the number of SMs,
// 1 the shared memory a block can opt into, 2 the shared memory of an SM.
extern "C" int segsum_card(int what) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  const cudaDeviceAttr attr =
      what == 0 ? cudaDevAttrMultiProcessorCount
      : what == 1 ? cudaDevAttrMaxSharedMemoryPerBlockOptin
                  : cudaDevAttrMaxSharedMemoryPerMultiprocessor;
  if (cudaDeviceGetAttribute(&v, attr, dev) != cudaSuccess) return -1;
  return v;
}

// A hop group's segment ids (and, with `gidx`, its dense rows' gather
// indices) from the argument table at `table` (device memory, laid out
// as hop_ids_kernel reads it) for `n_plans` plans of at most `max_edges`
// edges, into int32 `seg` (and `gidx`, or null).
extern "C" int hop_ids(const void* table, int64_t n_plans, int64_t n_cols,
                       int64_t max_edges, int64_t step, int64_t mult,
                       int64_t gather_step, void* seg, void* gidx,
                       void* stream) {
  if (n_plans < 1 || n_cols < 0 || n_cols > kIdsMaxCols || max_edges < 1
      || step < 0 || mult < 0 || gather_step < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t y = n_plans < 65535 ? n_plans : 65535;
  int64_t x = (max_edges + kThreads - 1) / kThreads;
  const int64_t most = kMaxBlocks / y > 1 ? kMaxBlocks / y : 1;
  if (x > most) x = most;
  const dim3 grid((unsigned)x, (unsigned)y);
  hop_ids_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)table, n_plans, (int)n_cols, step, mult, gather_step,
      (int32_t*)seg, (int32_t*)gidx);
  return (int)cudaGetLastError();
}
