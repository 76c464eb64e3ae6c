// Superset Mobius transform of a batch of [2^k, D] stacks: the negative
// phase of the Mobius join.
//
// Replaces the TPU kernel mobius_pallas in
// src/repro/kernels/mobius_kernel.py, which computed T @ X with the dense
// transform matrix T on the matrix unit.  Here the transform is its k
// butterfly passes x[a] -= x[a | bit], applied in the order of
// repro_torch.core.mobius.superset_mobius: axis 0 of the (2,)*k view first,
// which is the highest bit of the flattened index.  Complete counts exceed
// 2^24 (an unconstrained corner counts a cross product of entity sets), so
// only the same sequence of float32 subtractions gives the same rounding;
// the result equals the plain version bit for bit.
//
// Input and output are [B, 2^k, D], contiguous, batch first: the batched
// negative phase needs no transpose around the call.
//
// Bound on this card: bytes, 8 * B * 2^k * D (each element read and written
// once; k subtractions per element).  Two paths, both with neighbouring
// threads on neighbouring columns, so every load and store of a warp is
// contiguous:
//  * k <= 5: one thread owns one (b, d) column in registers, the passes
//    unrolled at compile time: 1.16-1.21x the bound with 128 MB in on an
//    H100.
//  * k >= 6: a block of 256 threads owns a [2^k, C] tile of one stack (C =
//    32 columns, fewer where 2^k rows of 32 would pass 64 KB; 1 from k =
//    14 on).  The k passes go in rounds of at most 4: in a round each
//    thread takes one column's 16 rows that differ only in the round's
//    bits into registers and runs those passes there.  The first round
//    reads x, the last writes out, and the rounds between meet in dynamic
//    shared memory, a barrier apart: each element crosses shared memory
//    ceil(k / 4) - 1 times, not at every pass.  (A whole column a thread
//    would shrink blocks to 32 threads at k = 8 and to 1 at k = 13.)
// Every element sees the same subtractions in the same order on both
// paths: a pass's pairs are disjoint and read only the previous pass's
// values, and a round holds every row that its passes pair.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRegisterBits = 5;
constexpr int kTileCols = 32;              // columns of a tile at most
constexpr int kTileBytes = 64 * 1024;      // a tile's size where C > 1
constexpr int kRoundBits = 4;              // passes a round takes at most
constexpr int kMaxSmemBytes = 232448;      // one block's shared memory

template <int K>
__global__ void mobius_reg_kernel(const float* __restrict__ x,
                                  float* __restrict__ out, int64_t batch,
                                  int64_t width) {
  constexpr int R = 1 << K;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= batch * width) return;
  const int64_t b = t / width;
  const int64_t d = t - b * width;
  const int64_t base = b * R * width + d;
  float v[R];
#pragma unroll
  for (int a = 0; a < R; ++a) v[a] = x[base + a * width];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int bit = 1 << (K - 1 - i);
#pragma unroll
    for (int a = 0; a < R; ++a)
      if (!(a & bit)) v[a] = v[a] - v[a | bit];
  }
#pragma unroll
  for (int a = 0; a < R; ++a) out[base + a * width] = v[a];
}

// One round of R passes (bits lo + R - 1 down to lo) over a [2^k, cols]
// tile: each unit is one column's 2^R rows that differ only in those bits,
// taken into registers (from x in the first round, from the tile after),
// transformed, and put back (to out in the last round, to the tile before).
// A round's units are disjoint, so a round needs no barrier inside it.
template <int R>
__device__ __forceinline__ void mobius_round(
    const float* __restrict__ xb, float* __restrict__ ob, float* tile, int k,
    int lo, bool first, bool last, int64_t width, int cols, int log_cols,
    int64_t n_cols) {
  constexpr int G = 1 << R;
  const int units = (1 << (k - R)) << log_cols;
  for (int u = threadIdx.x; u < units; u += kThreads) {
    const int c = u & (cols - 1), g = u >> log_cols;
    const int base = ((g >> lo) << (lo + R)) | (g & ((1 << lo) - 1));
    const bool in = c < n_cols;
    float v[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int row = base + (j << lo);
      v[j] = first ? (in ? xb[(int64_t)row * width + c] : 0.f)
                   : tile[row * cols + c];
    }
#pragma unroll
    for (int i = R - 1; i >= 0; --i) {
#pragma unroll
      for (int j = 0; j < G; ++j)
        if (!(j & (1 << i))) v[j] = v[j] - v[j | (1 << i)];
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int row = base + (j << lo);
      if (!last)
        tile[row * cols + c] = v[j];
      else if (in)
        ob[(int64_t)row * width + c] = v[j];
    }
  }
}

// Block (b, tile): columns [tile * cols, tile * cols + cols) of stack b, all
// 2^k rows (k >= 6), as tile[row * cols + c] between rounds; cols is a
// power of two.  The k passes go in ceil(k / 4) rounds of at most 4 bits,
// highest bits first, a barrier between rounds.
__global__ void __launch_bounds__(kThreads)
    mobius_tile_kernel(const float* __restrict__ x, float* __restrict__ out,
                       int k, int64_t width, int cols, int64_t tiles) {
  extern __shared__ float tile[];
  const int64_t b = blockIdx.x / tiles;
  const int64_t d0 = (blockIdx.x - b * tiles) * cols;
  const int64_t offset = (b << k) * width + d0;
  const int64_t n_cols = width - d0 < cols ? width - d0 : cols;
  const int log_cols = __ffs(cols) - 1;
  int hi = k;
  for (int rounds = (k + kRoundBits - 1) / kRoundBits; rounds > 0;
       --rounds) {
    const int r = (hi + rounds - 1) / rounds, lo = hi - r;
    const bool first = hi == k, last = lo == 0;
    if (!first) __syncthreads();
    switch (r) {
#define ROUND_CASE(R)                                                        \
  case R:                                                                    \
    mobius_round<R>(x + offset, out + offset, tile, k, lo, first, last,       \
                    width, cols, log_cols, n_cols);                          \
    break;
      ROUND_CASE(1)
      ROUND_CASE(2)
      ROUND_CASE(3)
      ROUND_CASE(4)
#undef ROUND_CASE
    }
    hi = lo;
  }
}

template <int K>
void launch_reg(const float* x, float* out, int64_t batch, int64_t width,
                cudaStream_t stream) {
  const int64_t blocks = (batch * width + kThreads - 1) / kThreads;
  mobius_reg_kernel<K><<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, out, batch, width);
}

// Columns of a tile for 2^k rows: kTileCols, halved while the tile passes
// kTileBytes, at least 1.
int tile_cols(int k) {
  int cols = kTileCols;
  while (cols > 1 && ((int64_t)sizeof(float) << k) * cols > kTileBytes)
    cols >>= 1;
  return cols;
}

int launch_tile(const float* x, float* out, int64_t batch, int k,
                int64_t width, cudaStream_t stream) {
  static const cudaError_t allowed = cudaFuncSetAttribute(
      mobius_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmemBytes);
  if (allowed != cudaSuccess) return (int)allowed;
  const int cols = tile_cols(k);
  const int64_t tiles = (width + cols - 1) / cols;
  const size_t bytes = ((size_t)sizeof(float) << k) * cols;
  mobius_tile_kernel<<<(unsigned)(batch * tiles), kThreads, bytes, stream>>>(
      x, out, k, width, cols, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// Largest k the shared-memory path takes: one column of 2^k rows must fit
// a block's shared memory.
extern "C" int mobius_max_bits() {
  int k = 0;
  while ((int64_t)sizeof(float) << (k + 1) <= kMaxSmemBytes) ++k;
  return k;
}

extern "C" int mobius_batch(const void* x, void* out, int64_t batch, int k,
                            int64_t width, void* stream) {
  const float* xs = (const float*)x;
  float* os = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  static_assert(kMaxRegisterBits == 5, "register path covers k <= 5");
  switch (k) {
    case 0: launch_reg<0>(xs, os, batch, width, st); break;
    case 1: launch_reg<1>(xs, os, batch, width, st); break;
    case 2: launch_reg<2>(xs, os, batch, width, st); break;
    case 3: launch_reg<3>(xs, os, batch, width, st); break;
    case 4: launch_reg<4>(xs, os, batch, width, st); break;
    case 5: launch_reg<5>(xs, os, batch, width, st); break;
    default: {
      if (k < 0 || k > mobius_max_bits()) return (int)cudaErrorInvalidValue;
      return launch_tile(xs, os, batch, k, width, st);
    }
  }
  return (int)cudaGetLastError();
}
