// Flash-attention forward (K6): the prefill's attention over one sequence.
//
// Replaces the TPU kernel flash_attention_pallas in
// src/repro/kernels/attention_kernel.py:
//   out[b,i,h,:] = sum_j softmax_j(q[b,i,h,:] . k[b,j,hk,:] / sqrt(hd))
//                  * v[b,j,hk,:]
// with hk = h / (H / Hkv) (grouped-query attention: the KV heads are read
// as they are, never repeated), the causal mask keeping key j <= query i
// (both counted from 0), masked logits -1e30, float32 accumulation, the
// probabilities rounded to v's type before the P.V product, and the output
// divided by max(l, 1e-30).  Keys at or past Skv never count, causal or
// not (the TPU kernel zeroes its padded keys when causal is false and so
// lets them into the normaliser; this kernel masks them).
//
// Bound on this card: operations.  At the prefill's shape (B=4, S=4096,
// H=16, Hkv=2, hd=128, causal) the two products are 2.75e11 flops against
// 151 MB of q/k/v/out, so the tensor cores' bf16 rate sets the bound.
//
// Design (simple first; no TMA, wgmma or warp specialisation yet):
//  * bf16 with hd a multiple of 16 (16/32/64/128): one CTA of 4 warps per
//    (64 query rows, head, batch).  The Q tile goes through shared memory
//    into mma.sync A fragments that stay in registers.  Each 64-key tile of
//    K and V is staged in shared memory (rows padded by 8 elements, so the
//    fragment loads are free of bank conflicts); S = Q K^T and O += P V run
//    on mma.sync m16n8k16 (bf16 in, float32 accumulate); V's B fragments
//    come from ldmatrix.trans.  The online softmax (running max m, the
//    normaliser l, the accumulator) lives in registers: S's accumulator
//    layout is P's A-fragment layout, so P never leaves the registers.
//  * float32, or bf16 with another hd <= 128: a CUDA-core kernel, 16 query
//    rows per CTA, one key per lane per 32-key tile staged in shared memory
//    as float32; the same online softmax with expf.
//  * Causal: key tiles wholly above the diagonal are never loaded, and the
//    query blocks are issued heaviest first.  Offsets are 64-bit.
//
// The kernels allocate nothing and launch on the caller's stream; the entry
// point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;

// ------------------------------------------------ tensor-core path ---------

constexpr int kMmaBQ = 64;   // query rows per CTA, 16 per warp
constexpr int kMmaBK = 64;   // keys per shared-memory tile

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r,
                                                  const void* smem) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy `kMmaBK` rows of HD bf16 (row stride `stride` elements) into shared
// memory with row stride HD + 8; rows at or past n_valid are zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* sm,
                                          const __nv_bfloat16* g,
                                          int64_t stride, int64_t n_valid) {
  constexpr int kVec = HD / 8;  // 16-byte vectors per row
  constexpr int LD = HD + 8;
  for (int i = threadIdx.x; i < kMmaBK * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_valid)
      v = *reinterpret_cast<const uint4*>(g + (int64_t)r * stride + c);
    *reinterpret_cast<uint4*>(sm + r * LD + c) = v;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, int64_t sq,
                     int64_t skv, int64_t n_heads, int64_t n_kv_heads,
                     int causal, float scale) {
  constexpr int LD = HD + 8;
  constexpr int KSTEPS = HD / 16;      // depth steps of S = Q K^T
  constexpr int DTILES = HD / 8;       // 8-column tiles of O
  constexpr int NTILES = kMmaBK / 8;   // 8-key tiles of S
  static_assert(kMmaBQ == 64 && kThreads == 128, "4 warps of 16 rows");
  static_assert(kMmaBQ <= kMmaBK, "the Q tile is staged in the K buffer");
  __shared__ __align__(16) __nv_bfloat16 ks[kMmaBK * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[kMmaBK * LD];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t n_qblocks = (sq + kMmaBQ - 1) / kMmaBQ;
  const int64_t q0 = (n_qblocks - 1 - (int64_t)blockIdx.x) * kMmaBQ;
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const int64_t hk = h / (n_heads / n_kv_heads);
  const int64_t q_stride = n_heads * HD, kv_stride = n_kv_heads * HD;
  const float scale2 = scale * kLog2e;   // softmax in base 2

  // Q tile -> shared (through the K buffer) -> A fragments for the loop.
  load_tile<HD>(ks, q + ((b * sq + q0) * n_heads + h) * HD, q_stride,
                sq - q0);
  __syncthreads();
  uint32_t qf[KSTEPS][4];
  const int r_lo = warp * 16 + g;   // this thread's rows: r_lo, r_lo + 8
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const __nv_bfloat16* p = ks + r_lo * LD + kk * 16 + 2 * t;
    qf[kk][0] = ld_u32(p);
    qf[kk][1] = ld_u32(p + 8 * LD);
    qf[kk][2] = ld_u32(p + 8);
    qf[kk][3] = ld_u32(p + 8 * LD + 8);
  }

  float acc[DTILES][4];
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m_row[2] = {kNegInf, kNegInf};   // running max, base-2 units
  float l_row[2] = {0.f, 0.f};           // this thread's share of l
  const int64_t row0 = q0 + r_lo;
  const int64_t kv_end =
      causal ? (skv < q0 + kMmaBQ ? skv : q0 + kMmaBQ) : skv;

  const __nv_bfloat16* kg = k + (b * skv * n_kv_heads + hk) * HD;
  const __nv_bfloat16* vg = v + (b * skv * n_kv_heads + hk) * HD;
  for (int64_t k0 = 0; k0 < kv_end; k0 += kMmaBK) {
    __syncthreads();   // the previous tile (or the Q tile) is consumed
    load_tile<HD>(ks, kg + k0 * kv_stride, kv_stride, skv - k0);
    load_tile<HD>(vs, vg + k0 * kv_stride, kv_stride, skv - k0);
    __syncthreads();

    float s[NTILES][4];
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const __nv_bfloat16* p = ks + (nt * 8 + g) * LD + kk * 16 + 2 * t;
        const uint32_t bf[2] = {ld_u32(p), ld_u32(p + 8)};
        mma_16816(s[nt], qf[kk], bf);
      }
    }

    // scale, mask, running max over this tile
    float mx[2] = {m_row[0], m_row[1]};
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t key = k0 + nt * 8 + 2 * t + (e & 1);
        const int64_t row = row0 + (e >> 1) * 8;
        float x = s[nt][e] * scale2;
        if (key >= skv || (causal && key > row)) x = kNegInf;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2f(m_row[i] - mx[i]);
      m_row[i] = mx[i];
      l_row[i] *= corr[i];
    }

    // P = exp(S - m): float32 into l, bf16 A fragments for P V
    uint32_t pf[kMmaBK / 16][4];
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
      const float p0 = exp2f(s[nt][0] - m_row[0]);
      const float p1 = exp2f(s[nt][1] - m_row[0]);
      const float p2 = exp2f(s[nt][2] - m_row[1]);
      const float p3 = exp2f(s[nt][3] - m_row[1]);
      l_row[0] += p0 + p1;
      l_row[1] += p2 + p3;
      pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);
      pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }
#pragma unroll
    for (int j = 0; j < kMmaBK / 16; ++j) {
#pragma unroll
      for (int dt = 0; dt < DTILES; ++dt) {
        uint32_t bf[2];
        ldmatrix_x2_trans(bf, vs + (j * 16 + (lane & 15)) * LD + dt * 8);
        mma_16816(acc[dt], pf[j], bf);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_row[i] += __shfl_xor_sync(0xffffffffu, l_row[i], 1);
    l_row[i] += __shfl_xor_sync(0xffffffffu, l_row[i], 2);
    l_row[i] = fmaxf(l_row[i], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t row = row0 + 8 * i;
    if (row >= sq) continue;
    __nv_bfloat16* o = out + ((b * sq + row) * n_heads + h) * HD + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt)
      *reinterpret_cast<uint32_t*>(o + dt * 8) =
          pack_bf16(acc[dt][2 * i] / l_row[i], acc[dt][2 * i + 1] / l_row[i]);
  }
}

// ---------------------------------------------------- CUDA-core path -------

constexpr int kSimtBQ = 16;    // query rows per CTA, 4 per warp
constexpr int kSimtBK = 32;    // keys per tile, one per lane
constexpr int kMaxHD = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out,
                      int64_t sq, int64_t skv, int64_t n_heads,
                      int64_t n_kv_heads, int hd, int causal, float scale) {
  constexpr int RPW = kSimtBQ / (kThreads / 32);   // rows per warp
  constexpr int CPL = kMaxHD / 32;                 // columns per lane
  __shared__ float qs[kSimtBQ][kMaxHD];
  __shared__ float ks[kSimtBK][kMaxHD + 1];        // +1: no bank conflicts
  __shared__ float vs[kSimtBK][kMaxHD];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t n_qblocks = (sq + kSimtBQ - 1) / kSimtBQ;
  const int64_t q0 = (n_qblocks - 1 - (int64_t)blockIdx.x) * kSimtBQ;
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const int64_t hk = h / (n_heads / n_kv_heads);

  for (int i = threadIdx.x; i < kSimtBQ * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    qs[r][d] = q0 + r < sq
                   ? to_f(q[((b * sq + q0 + r) * n_heads + h) * hd + d])
                   : 0.f;
  }

  float m[RPW], l[RPW], acc[RPW][CPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[i][c] = 0.f;
  }
  const int64_t kv_end =
      causal ? (skv < q0 + kSimtBQ ? skv : q0 + kSimtBQ) : skv;
  for (int64_t k0 = 0; k0 < kv_end; k0 += kSimtBK) {
    __syncthreads();
    for (int i = threadIdx.x; i < kSimtBK * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < skv) {
        const int64_t off = ((b * skv + k0 + r) * n_kv_heads + hk) * hd + d;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      ks[r][d] = kx;
      vs[r][d] = vx;
    }
    __syncthreads();
    const int64_t key = k0 + lane;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp * RPW + i;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qs[r][d], ks[lane][d], s);
      s *= scale;
      if (key >= skv || (causal && key > q0 + r)) s = kNegInf;
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float p = expf(s - m_new);
      const float corr = expf(m[i] - m_new);
      float ps = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
      const float pv = to_f(from_f<T>(p));   // probabilities in v's type
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[i][c] *= corr;
      for (int j = 0; j < kSimtBK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pv, j);
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int d = lane + 32 * c;
          if (d < hd) acc[i][c] = fmaf(pj, vs[j][d], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int64_t row = q0 + warp * RPW + i;
    if (row >= sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int d = lane + 32 * c;
      if (d < hd)
        out[((b * sq + row) * n_heads + h) * hd + d] =
            from_f<T>(acc[i][c] / li);
    }
  }
}

template <int HD>
void launch_mma(const void* q, const void* k, const void* v, void* out,
                int64_t batch, int64_t sq, int64_t skv, int64_t n_heads,
                int64_t n_kv_heads, int causal, float scale,
                cudaStream_t stream) {
  const dim3 grid((unsigned)((sq + kMmaBQ - 1) / kMmaBQ), (unsigned)n_heads,
                  (unsigned)batch);
  flash_mma_kernel<HD><<<grid, kThreads, 0, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, sq, skv, n_heads,
      n_kv_heads, causal, scale);
}

template <typename T>
void launch_simt(const void* q, const void* k, const void* v, void* out,
                 int64_t batch, int64_t sq, int64_t skv, int64_t n_heads,
                 int64_t n_kv_heads, int hd, int causal, float scale,
                 cudaStream_t stream) {
  const dim3 grid((unsigned)((sq + kSimtBQ - 1) / kSimtBQ),
                  (unsigned)n_heads, (unsigned)batch);
  flash_simt_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, sq, skv, n_heads,
      n_kv_heads, hd, causal, scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q [B, Sq, H, hd]; k, v [B, Skv, Hkv,
// hd]; out [B, Sq, H, hd]; all contiguous, Hkv | H, 1 <= hd <= 128, Sq and
// Skv >= 1; bf16 pointers 16-byte aligned.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int64_t batch, int64_t sq,
                               int64_t skv, int64_t n_heads,
                               int64_t n_kv_heads, int64_t hd, int causal,
                               int dtype, float scale, void* stream) {
  if (hd < 1 || hd > kMaxHD || n_kv_heads < 1 || n_heads % n_kv_heads != 0 ||
      sq < 1 || skv < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    switch (hd) {
      case 16: launch_mma<16>(q, k, v, out, batch, sq, skv, n_heads,
                              n_kv_heads, causal, scale, st); break;
      case 32: launch_mma<32>(q, k, v, out, batch, sq, skv, n_heads,
                              n_kv_heads, causal, scale, st); break;
      case 64: launch_mma<64>(q, k, v, out, batch, sq, skv, n_heads,
                              n_kv_heads, causal, scale, st); break;
      case 128: launch_mma<128>(q, k, v, out, batch, sq, skv, n_heads,
                                n_kv_heads, causal, scale, st); break;
      default:
        launch_simt<__nv_bfloat16>(q, k, v, out, batch, sq, skv, n_heads,
                                   n_kv_heads, (int)hd, causal, scale, st);
    }
  } else {
    launch_simt<float>(q, k, v, out, batch, sq, skv, n_heads, n_kv_heads,
                       (int)hd, causal, scale, st);
  }
  return (int)cudaGetLastError();
}
