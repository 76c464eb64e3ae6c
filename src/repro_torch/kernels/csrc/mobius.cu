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
// once; k subtractions per element).  One thread owns one (b, d) column:
// neighbouring threads take neighbouring d, so every load and store of a
// warp is contiguous.  For k <= 5 the column lives in registers (the passes
// are unrolled at compile time); above that it lives in shared memory,
// laid out so the threads of a warp hit different banks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRegisterBits = 5;
constexpr int kSmemBytes = 48 * 1024;

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

__global__ void mobius_smem_kernel(const float* __restrict__ x,
                                   float* __restrict__ out, int64_t batch,
                                   int k, int64_t width) {
  extern __shared__ float col[];
  const int r = 1 << k;
  const int lanes = blockDim.x;
  const int tid = threadIdx.x;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + tid;
  if (t >= batch * width) return;      // no block-wide barrier below
  const int64_t b = t / width;
  const int64_t d = t - b * width;
  const int64_t base = b * (int64_t)r * width + d;
  for (int a = 0; a < r; ++a) col[a * lanes + tid] = x[base + a * width];
  for (int i = 0; i < k; ++i) {
    const int bit = 1 << (k - 1 - i);
    for (int a = 0; a < r; ++a)
      if (!(a & bit))
        col[a * lanes + tid] = col[a * lanes + tid] - col[(a | bit) * lanes + tid];
  }
  for (int a = 0; a < r; ++a) out[base + a * width] = col[a * lanes + tid];
}

template <int K>
void launch_reg(const float* x, float* out, int64_t batch, int64_t width,
                cudaStream_t stream) {
  const int64_t blocks = (batch * width + kThreads - 1) / kThreads;
  mobius_reg_kernel<K><<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, out, batch, width);
}

}  // namespace

// Largest k the shared-memory path takes: one thread's column must fit.
extern "C" int mobius_max_bits() {
  int k = 0;
  while ((int64_t)sizeof(float) << (k + 1) <= kSmemBytes) ++k;
  return k;
}

extern "C" int mobius_batch(const void* x, void* out, int64_t batch, int k,
                            int64_t width, void* stream) {
  const float* xs = (const float*)x;
  float* os = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (k) {
    case 0: launch_reg<0>(xs, os, batch, width, st); break;
    case 1: launch_reg<1>(xs, os, batch, width, st); break;
    case 2: launch_reg<2>(xs, os, batch, width, st); break;
    case 3: launch_reg<3>(xs, os, batch, width, st); break;
    case 4: launch_reg<4>(xs, os, batch, width, st); break;
    case 5: launch_reg<5>(xs, os, batch, width, st); break;
    default: {
      if (k < 0 || k > mobius_max_bits()) return (int)cudaErrorInvalidValue;
      const int64_t col_bytes = (int64_t)sizeof(float) << k;
      int lanes = (int)(kSmemBytes / col_bytes);
      if (lanes > 128) lanes = 128;
      if (lanes > 32) lanes -= lanes % 32;
      const int64_t blocks = (batch * width + lanes - 1) / lanes;
      mobius_smem_kernel<<<(unsigned)blocks, lanes,
                           (size_t)(lanes * col_bytes), st>>>(
          xs, os, batch, k, width);
    }
  }
  static_assert(kMaxRegisterBits == 5, "register path covers k <= 5");
  return (int)cudaGetLastError();
}
