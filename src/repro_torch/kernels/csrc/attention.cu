// Flash-attention forward (K6): the prefill's attention over one sequence.
//
// Replaces the TPU kernel flash_attention_pallas in
// src/repro/kernels/attention_kernel.py:
//   out[b,i,h,:] = sum_j softmax_j(q[b,i,h,:] . k[b,j,hk,:] / sqrt(hd))
//                  * v[b,j,hk,:]
// with hk = h / (H / Hkv) (grouped-query attention: the KV heads are read
// as they are, never repeated), the causal mask keeping key j <= query i
// (both counted from 0; with a query offset, query row i stands at
// position q_off + i and keeps key j <= q_off + i, as a shard of the
// sequence-parallel route does), masked logits -1e30, float32 accumulation, the
// probabilities rounded to v's type before the P.V product, and the output
// divided by max(l, 1e-30).  Keys at or past Skv never count, causal or
// not (the TPU kernel zeroes its padded keys when causal is false and so
// lets them into the normaliser; these kernels mask them by index).
//
// Bound on this card: operations.  At the prefill's shape (B=4, S=4096,
// H=16, Hkv=2, hd=128, causal) the two products are 2.75e11 flops against
// 151 MB of q/k/v/out: 0.278 ms at the tensor cores' 989 TFLOP/s bf16 rate,
// against 0.045 ms for the bytes at 3.35 TB/s.  At the long prefill's
// (B=1, S=32768) they are 4.4e12 flops, 4.45 ms.
//
// Routes, chosen here by dtype and hd:
//  * bf16, hd == 128 (the served models' head size): the Hopper kernel.
//    One CTA of three warpgroups per (128 query rows, head, batch), issued
//    heaviest query block first across all heads.  Warpgroup 0 is the
//    producer: it gives its registers away (setmaxnreg) and one of its
//    threads loads the Q tile once, then K and V in 128-key tiles through a
//    two-stage ring, all by TMA (cp.async.bulk.tensor over 4-D tensor maps
//    (hd, heads, seq, batch), so a box past the sequence's end is
//    zero-filled within its own sequence) on full/empty mbarriers, K and V
//    each with their own.  A tile of 128 rows x 128 dims is two boxes of 64
//    dims with 128-byte swizzle.  Warpgroups 1 and 2 are consumers of 64
//    query rows each: S = Q K^T is wgmma m64n128k16 with both operands in
//    shared memory (K-major), the online softmax runs in registers in base
//    2 with the scale folded in, masking only the tile that crosses the
//    diagonal or holds Skv's ragged end, and P goes from S's accumulator
//    straight into bf16 A fragments for O += P V, a wgmma with A in
//    registers and V (stored [key][dim], N-major for this product) read
//    through a transposed descriptor.  Tensor-core time is kept busy two
//    ways: each consumer issues S of tile t with P V of tile t - 1 and runs
//    tile t's softmax while P V is in flight, and the two consumers take
//    turns issuing (named barriers), so one's softmax overlaps the other's
//    products.  168 registers at launch, 40 for the producer and 232 for
//    each consumer after setmaxnreg; 165 KB of shared memory; no spills.
//  * bf16 with hd in {16, 32, 64, 192, 256}: one CTA of 4 warps per (64
//    query rows, head, batch), mma.sync m16n8k16.  Q, K and V tiles are
//    staged synchronously in dynamic shared memory (rows padded by 8
//    elements, so each ldmatrix's 8 rows fall in distinct banks; 64-key K/V
//    tiles, 32-key above hd 128), and every operand fragment comes from
//    there by ldmatrix (V transposed).  Q's fragments are held in registers
//    up to hd 64 and read again at each k-step above it: at hd 256 holding
//    them would take 64 registers a thread beside O's 128.  No spills: 72,
//    80 and 129 registers at hd 16, 32 and 64, 168 at 192, 237 at 256.
//    hd 192 is Nemotron-4-340B's head size; 256 is the widest that the TPU
//    kernel's padding to a multiple of 128 reaches in any registered config.
//    Up to 67.6 KB of shared memory (hd 256), so the limit is raised once
//    per instantiation.
//  * float32 at any hd up to 512, or bf16 with another hd: a CUDA-core
//    kernel, 16 query rows per CTA, one key per lane per 32-key tile staged
//    in dynamic shared memory as float32; the same online softmax with expf.
//    It is templated on a column budget of 128, 256 or 512 (the output
//    columns each lane keeps in registers); its tiles take 164 KB at hd 512.
//    It exists for the float32 check and the odd head sizes, not for speed.
//  * any dtype with hd above 512: the same CUDA-core kernel with the head
//    dim streamed.  Neither Q's rows nor a lane's output columns fit at
//    such widths, so each CTA owns one slice of at most 512 output columns
//    (sliced_width: the head dim cut into equal slices, rounded up to 32)
//    for its 16 query rows, and each score is summed over Q and K slices of
//    at most 512 dims staged in turn (the same fma order over d as the
//    unsliced kernel).  One CTA per (query block, output slice), head,
//    batch; the scores are recomputed once per output slice.  Simple and
//    right, not fast.
// Every route skips key tiles wholly above the diagonal when causal (the
// diagonal moved right by q_off).
//
// The kernels allocate nothing and launch on the caller's stream; the entry
// point returns cudaGetLastError() after its launch.  The tensor-map
// encoder is a driver function, fetched through the runtime's
// cudaGetDriverEntryPoint, so nothing beyond the runtime is linked.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;

// ------------------------- mma.sync path (bf16, hd 16/32/64/192/256) ----

constexpr int kMmaBQ = 64;   // query rows per CTA, 16 per warp

// Keys per shared-memory tile: 64, or 32 above hd 128, where O's
// accumulators (hd / 2 registers a thread) leave less room for S and P.
template <int HD>
__host__ __device__ constexpr int mma_bk() { return HD > 128 ? 32 : 64; }

// Dynamic shared memory of flash_mma_kernel<HD>: the Q, K and V tiles at
// row stride HD + 8 elements.
template <int HD>
__host__ __device__ constexpr int mma_smem_bytes() {
  return (kMmaBQ + 2 * mma_bk<HD>()) * (HD + 8) * 2;
}

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 bf16 matrices from shared memory, lanes 8i..8i+7 giving the row
// addresses of matrix i; `trans` transposes each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy ROWS rows of HD bf16 (row stride `stride` elements) into shared
// memory with row stride HD + 8; rows at or past n_valid are zero-filled.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* sm,
                                          const __nv_bfloat16* g,
                                          int64_t stride, int64_t n_valid) {
  constexpr int kVec = HD / 8;  // 16-byte vectors per row
  constexpr int LD = HD + 8;
  for (int i = threadIdx.x; i < ROWS * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_valid)
      v = *reinterpret_cast<const uint4*>(g + (int64_t)r * stride + c);
    *reinterpret_cast<uint4*>(sm + r * LD + c) = v;
  }
}

// One CTA of 4 warps per (64 query rows, head, batch); warp w owns rows
// 16w..16w+15.  Q, K and V tiles sit in dynamic shared memory (rows padded
// by 8 elements, so the 8 rows an ldmatrix reads fall in distinct banks).
template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, int64_t sq,
                     int64_t skv, int64_t n_heads, int64_t n_kv_heads,
                     int causal, int64_t q_off, float scale) {
  constexpr int BK = mma_bk<HD>();
  constexpr int LD = HD + 8;
  constexpr int KSTEPS = HD / 16;      // depth steps of S = Q K^T
  constexpr int DTILES = HD / 8;       // 8-column tiles of O
  constexpr int NTILES = BK / 8;       // 8-key tiles of S
  static_assert(kMmaBQ == 64 && kThreads == 128, "4 warps of 16 rows");
  static_assert(HD % 16 == 0 && BK % 16 == 0, "whole mma steps");
  extern __shared__ __align__(16) uint8_t mma_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* ks = qs + kMmaBQ * LD;
  __nv_bfloat16* vs = ks + BK * LD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t n_qblocks = (sq + kMmaBQ - 1) / kMmaBQ;
  const int64_t q0 = (n_qblocks - 1 - (int64_t)blockIdx.x) * kMmaBQ;
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const int64_t hk = h / (n_heads / n_kv_heads);
  const int64_t q_stride = n_heads * HD, kv_stride = n_kv_heads * HD;
  const float scale2 = scale * kLog2e;   // softmax in base 2

  load_tile<HD, kMmaBQ>(qs, q + ((b * sq + q0) * n_heads + h) * HD, q_stride,
                        sq - q0);
  // ldmatrix row addresses: this warp's 16 Q rows (A fragments), 16 keys
  // of K for two 8-key tiles (B fragments of S), 16 keys of V for two
  // 8-column tiles (B fragments of P V, transposed)
  const __nv_bfloat16* qa = qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  const __nv_bfloat16* ka = ks + ((lane & 7) + ((lane >> 4) << 3)) * LD +
                            ((lane >> 3) & 1) * 8;
  const __nv_bfloat16* va = vs + (lane & 15) * LD + (lane >> 4) * 8;

  // Up to hd 64 Q's fragments (hd / 4 registers) are held for the whole
  // loop; above it each k-step reads its fragment from shared memory.
  constexpr bool kHoldQ = HD <= 64;
  uint32_t q_held[kHoldQ ? KSTEPS : 1][4];
  if constexpr (kHoldQ) {
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) ldmatrix_x4(q_held[kk], qa + kk * 16);
  }

  float acc[DTILES][4];
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m_row[2] = {kNegInf, kNegInf};   // running max, base-2 units
  float l_row[2] = {0.f, 0.f};           // this thread's share of l
  // the position (row counted from q_off) of this thread's first row, and
  // + 8; keys below q_end can count
  const int64_t row0 = q_off + q0 + warp * 16 + g;
  const int64_t q_end = q_off + q0 + kMmaBQ;
  const int64_t kv_end = causal ? (skv < q_end ? skv : q_end) : skv;

  const __nv_bfloat16* kg = k + (b * skv * n_kv_heads + hk) * HD;
  const __nv_bfloat16* vg = v + (b * skv * n_kv_heads + hk) * HD;
  for (int64_t k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();   // the previous tile is consumed
    load_tile<HD, BK>(ks, kg + k0 * kv_stride, kv_stride, skv - k0);
    load_tile<HD, BK>(vs, vg + k0 * kv_stride, kv_stride, skv - k0);
    __syncthreads();

    float s[NTILES][4];
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t qf[4];
      if constexpr (kHoldQ) {
#pragma unroll
        for (int r = 0; r < 4; ++r) qf[r] = q_held[kk][r];
      } else {
        ldmatrix_x4(qf, qa + kk * 16);
      }
#pragma unroll
      for (int np = 0; np < NTILES / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, ka + np * 16 * LD + kk * 16);
        mma_16816(s[2 * np], qf, bf);
        mma_16816(s[2 * np + 1], qf, bf + 2);
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
    uint32_t pf[BK / 16][4];
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
    for (int j = 0; j < BK / 16; ++j) {
#pragma unroll
      for (int dp = 0; dp < DTILES / 2; ++dp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, va + j * 16 * LD + dp * 16);
        mma_16816(acc[2 * dp], pf[j], bf);
        mma_16816(acc[2 * dp + 1], pf[j], bf + 2);
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
    const int64_t row = row0 - q_off + 8 * i;
    if (row >= sq) continue;
    __nv_bfloat16* o = out + ((b * sq + row) * n_heads + h) * HD + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt)
      *reinterpret_cast<uint32_t*>(o + dt * 8) =
          pack_bf16(acc[dt][2 * i] / l_row[i], acc[dt][2 * i + 1] / l_row[i]);
  }
}

// ----------------------------------------- Hopper path (bf16, hd 128) ----

constexpr int kHD = 128;            // head dim of this path
constexpr int kBQ = 128;            // query rows per CTA, 64 per consumer
constexpr int kBK = 128;            // keys per K/V tile
constexpr int kStages = 2;          // depth of the K/V ring
constexpr int kBoxCols = 64;        // 128-byte swizzle: 64 bf16 per box row
constexpr int kBoxBytes = kBK * kBoxCols * 2;        // 16 KB
constexpr int kTileBytes = 2 * kBoxBytes;            // 128 rows x 128 dims
constexpr int kWsThreads = 384;     // producer + two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kSmemBytes =          // Q, the K and V rings, slack, mbarriers
    (1 + 2 * kStages) * kTileBytes + 1024 + 8 * (1 + 4 * kStages);
static_assert(kBQ == kBK, "Q, K and V tiles share one box shape");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// Arrive once and add `bytes` to the transaction count of this phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle.  K-major operands (Q,
// K): `lbo` is unused and `sbo` is the stride of 8-row groups (1 KB).
// N-major V: `lbo` is the stride between 64-column boxes, `sbo` that of
// 8-key groups.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo & 0x3FFFFu) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFFu) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Keep the compiler from moving reads of an accumulator above the wait.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define WG_ACC8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_ACC64                                                       \
  WG_ACC8(0), WG_ACC8(8), WG_ACC8(16), WG_ACC8(24), WG_ACC8(32),       \
      WG_ACC8(40), WG_ACC8(48), WG_ACC8(56)
#define WG_REGS64                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128, float32) = A B (+ d if accumulate): A 64 x 16 and B 16 x 128
// both from shared memory, K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC64
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B: A 64 x 16 in registers (the m16n8k16 A-fragment layout per
// warp), B 16 x 128 from shared memory, N-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// One tile of the online softmax, in registers.  S stays as the product
// wrote it (only wgmma defines its registers): the row maxima are taken on
// S itself and scaled into base-2 units (the scale is positive), and P =
// exp2(S * scale2 - m) is one fma and one exp2.  `mask` (a tile that
// crosses the diagonal or Skv's end) makes masked keys count as -1e30
// logits, i.e. P = 0.  Rescales l by the returned `corr`, adds P in
// float32 to l and writes P as bf16 A fragments (key step kk holds S's
// 8-key blocks 2kk and 2kk + 1).
template <bool kMask>
__device__ __forceinline__ void softmax_tile_impl(
    const float (&sc)[64], uint32_t (&pf)[8][4], float (&m_row)[2],
    float (&l_row)[2], float (&corr)[2], int k0, int skv, int causal,
    int row_lo, int t4, float scale2) {
  const auto masked = [&](int j, int e) {
    const int key = k0 + 8 * j + 2 * t4 + (e & 1);
    return kMask && (key >= skv || (causal && key > row_lo + 8 * (e >> 1)));
  };
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (!masked(j, e)) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
  }
  float neg_m[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m_row[i], mx[i] * scale2);
    corr[i] = exp2f(m_row[i] - m_new);
    m_row[i] = m_new;
    l_row[i] *= corr[i];
    neg_m[i] = -m_new;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[e] = masked(j, e) ? 0.f
                          : exp2f(fmaf(sc[4 * j + e], scale2, neg_m[e >> 1]));
    l_row[0] += p[0] + p[1];
    l_row[1] += p[2] + p[3];
    pf[j >> 1][(j & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
    pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
  }
}

__device__ __forceinline__ void softmax_tile(
    const float (&sc)[64], uint32_t (&pf)[8][4], float (&m_row)[2],
    float (&l_row)[2], float (&corr)[2], bool mask, int k0, int skv,
    int causal, int row_lo, int t4, float scale2) {
  if (mask)
    softmax_tile_impl<true>(sc, pf, m_row, l_row, corr, k0, skv, causal,
                            row_lo, t4, scale2);
  else
    softmax_tile_impl<false>(sc, pf, m_row, l_row, corr, k0, skv, causal,
                             row_lo, t4, scale2);
}

__device__ __forceinline__ void fence_frag(uint32_t (&pf)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(pf[kk][r])::"memory");
}

// S = Q K^T over hd in 8 steps of 16 (steps 0-3 in the first box), issued
// and committed as one group.
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t qa,
                                         uint32_t ks) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kHD / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    wgmma_ss(sc, smem_desc(qa + off, 16, 1024),
             smem_desc(ks + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// O += P V over 128 keys in 8 steps of 16 (2 KB of V each), one group.
__device__ __forceinline__ void issue_pv(float (&o)[64],
                                         uint32_t (&pf)[8][4], uint32_t vs) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma_rs(o, pf[kk], smem_desc(vs + kk * 2048, kBoxBytes, 1024));
  wgmma_commit();
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Named barriers over the two consumer warpgroups (256 threads).
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// Grid: one CTA per (query block, head, batch), flattened so that the
// first H*B CTAs take the last (heaviest, when causal) query block.
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ out, int sq, int skv,
                       int n_heads, int n_kv_heads, int n_hb, int causal,
                       int q_off, float scale) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle repeats every 1 KB: tiles start on 1 KB boundaries
  const uint32_t q_smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_smem = q_smem + kTileBytes;                // + s * tile
  const uint32_t v_smem = k_smem + kStages * kTileBytes;      // + s * tile
  const uint32_t q_full = v_smem + kStages * kTileBytes;      // mbarriers:
  const uint32_t k_full = q_full + 8;                         // + 8 * s
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;

  const int n_qblocks = (sq + kBQ - 1) / kBQ;
  const int hb = (int)(blockIdx.x % (unsigned)n_hb);
  const int q0 = (n_qblocks - 1 - (int)(blockIdx.x / (unsigned)n_hb)) * kBQ;
  const int h = hb % n_heads, b = hb / n_heads;
  const int hk = h / (n_heads / n_kv_heads);
  const int kv_end = causal ? min(skv, q_off + q0 + kBQ) : skv;
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, kConsumerWarps);
      mbar_init(v_empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, kTileBytes);
      tma_load(q_smem, &tq, q_full, 0, h, q0, b);
      tma_load(q_smem + kBoxBytes, &tq, q_full, kBoxCols, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const uint32_t round = (uint32_t)(t / kStages) & 1u;
        const uint32_t ks = k_smem + s * kTileBytes;
        const uint32_t vs = v_smem + s * kTileBytes;
        const int k0 = t * kBK;
        mbar_wait(k_empty + 8 * s, round ^ 1u);   // round 0 passes at once
        mbar_expect_tx(k_full + 8 * s, kTileBytes);
        tma_load(ks, &tk, k_full + 8 * s, 0, hk, k0, b);
        tma_load(ks + kBoxBytes, &tk, k_full + 8 * s, kBoxCols, hk, k0, b);
        mbar_wait(v_empty + 8 * s, round ^ 1u);
        mbar_expect_tx(v_full + 8 * s, kTileBytes);
        tma_load(vs, &tv, v_full + 8 * s, 0, hk, k0, b);
        tma_load(vs + kBoxBytes, &tv, v_full + 8 * s, kBoxCols, hk, k0, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = (threadIdx.x >> 7) - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int t4 = lane & 3;
    // positions (rows counted from q_off) of this thread's first row (and
    // + 8) and of this warpgroup's first row
    const int row_lo = q_off + q0 + cw * 64 + warp * 16 + (lane >> 2);
    const int row_min = q_off + q0 + cw * 64;
    const float scale2 = scale * kLog2e;           // softmax in base 2
    // this warpgroup's 64 rows of Q in both boxes
    const uint32_t qa = q_smem + cw * 64 * (kBoxCols * 2);
    const auto needs_mask = [&](int k0) {
      return k0 + kBK > skv || (causal && k0 + kBK - 1 > row_min);
    };

    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m_row[2] = {kNegInf, kNegInf};   // running max, base-2 units
    float l_row[2] = {0.f, 0.f};           // this thread's share of l
    float corr[2];
    float sc[64];
    uint32_t pf[8][4];

    const auto rescale_o = [&]() {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        o[4 * j + 0] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }
    };
    const auto release = [&](uint32_t bar) {   // this warp is done with it
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    const auto round_of = [](int t) {
      return (uint32_t)(t / kStages) & 1u;
    };

    // The two consumer warpgroups take turns issuing their products (named
    // barrier 1 + cw is this one's turn), so one's softmax runs while the
    // other's products do.  Within a warpgroup, tile 0's S and softmax come
    // first; then each step issues S of tile t and P V of tile t - 1
    // together and runs tile t's softmax while P V is in flight.  P
    // alternates between two register sets, so no register of an
    // in-flight product is written.
    const int my_turn = 1 + cw, other_turn = 2 - cw;
    const auto take_turn = [&]() { named_sync(my_turn); };
    const auto pass_turn = [&]() { named_arrive(other_turn); };
    uint32_t pg[8][4];
    const auto step = [&](int t, uint32_t (&p_prev)[8][4],
                          uint32_t (&p_next)[8][4]) {
      const int s = t % kStages, sp = (t - 1) % kStages;
      fence_acc(o);
      fence_frag(p_prev);
      mbar_wait(k_full + 8 * s, round_of(t));
      mbar_wait(v_full + 8 * sp, round_of(t - 1));
      take_turn();
      issue_qk(sc, qa, k_smem + s * kTileBytes);
      issue_pv(o, p_prev, v_smem + sp * kTileBytes);
      pass_turn();
      wgmma_wait<1>();                       // S of tile t is done
      fence_acc(sc);
      release(k_empty + 8 * s);
      softmax_tile(sc, p_next, m_row, l_row, corr, needs_mask(t * kBK),
                   t * kBK, skv, causal, row_lo, t4, scale2);
      wgmma_wait<0>();                       // P V of tile t - 1 is done
      fence_acc(o);
      release(v_empty + 8 * sp);
      rescale_o();
    };

    if (cw == 1) pass_turn();                // warpgroup 1 issues first
    mbar_wait(q_full, 0);
    mbar_wait(k_full, 0);
    take_turn();
    issue_qk(sc, qa, k_smem);
    pass_turn();
    wgmma_wait<0>();
    fence_acc(sc);
    release(k_empty);
    softmax_tile(sc, pf, m_row, l_row, corr, needs_mask(0), 0, skv, causal,
                 row_lo, t4, scale2);
    for (int t = 1; t < n_tiles; t += 2) {
      step(t, pf, pg);
      if (t + 1 < n_tiles) step(t + 1, pg, pf);
    }
    const int last = n_tiles - 1, sl = last % kStages;
    fence_acc(o);
    fence_frag(pf);
    fence_frag(pg);
    mbar_wait(v_full + 8 * sl, round_of(last));
    take_turn();
    if (last % 2 == 0)
      issue_pv(o, pf, v_smem + sl * kTileBytes);
    else
      issue_pv(o, pg, v_smem + sl * kTileBytes);
    if (cw == 0) pass_turn();   // warpgroup 1 passed its extra turn first
    wgmma_wait<0>();
    fence_acc(o);

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_row[i] += __shfl_xor_sync(0xffffffffu, l_row[i], 1);
      l_row[i] += __shfl_xor_sync(0xffffffffu, l_row[i], 2);
      l_row[i] = fmaxf(l_row[i], 1e-30f);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_lo - q_off + 8 * i;
      if (row >= sq) continue;
      __nv_bfloat16* dst =
          out + (((int64_t)b * sq + row) * n_heads + h) * kHD + 2 * t4;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16(
            o[4 * j + 2 * i] / l_row[i], o[4 * j + 2 * i + 1] / l_row[i]);
    }
  }
}

// ---------------------------------------------------- CUDA-core path -------

constexpr int kSimtBQ = 16;    // query rows per CTA, 4 per warp
constexpr int kSimtBK = 32;    // keys per tile, one per lane
constexpr int kMaxSimtHD = 512;   // the largest column budget below
constexpr int64_t kMaxRouteHD = INT32_MAX;   // the kernels take hd as an int

// Dynamic shared memory of the CUDA-core kernel at head dim hd: Q, K (row
// stride hd | 1, odd, so the lanes' rows fall in distinct banks) and V
// tiles as float32.
constexpr int simt_smem_bytes(int hd) {
  return (kSimtBQ * hd + kSimtBK * (hd | 1) + kSimtBK * hd) * 4;
}
static_assert(simt_smem_bytes(kMaxSimtHD) <= 232448,
              "the largest budget's tiles fit one CTA's shared memory");

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

// CB: the column budget (a multiple of 32, at least hd): each lane keeps
// CB / 32 output columns of each of its warp's rows in registers.
template <typename T, int CB>
__global__ void __launch_bounds__(kThreads)
    flash_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out,
                      int64_t sq, int64_t skv, int64_t n_heads,
                      int64_t n_kv_heads, int hd, int causal,
                      int64_t q_off, float scale) {
  constexpr int RPW = kSimtBQ / (kThreads / 32);   // rows per warp
  constexpr int CPL = CB / 32;                     // columns per lane
  extern __shared__ float simt_smem[];
  const int ldk = hd | 1;
  float* qs = simt_smem;                   // [kSimtBQ][hd]
  float* ks = qs + kSimtBQ * hd;           // [kSimtBK][ldk]
  float* vs = ks + kSimtBK * ldk;          // [kSimtBK][hd]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t n_qblocks = (sq + kSimtBQ - 1) / kSimtBQ;
  const int64_t q0 = (n_qblocks - 1 - (int64_t)blockIdx.x) * kSimtBQ;
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const int64_t hk = h / (n_heads / n_kv_heads);

  for (int i = threadIdx.x; i < kSimtBQ * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    qs[i] = q0 + r < sq
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
  const int64_t q_end = q_off + q0 + kSimtBQ;
  const int64_t kv_end = causal ? (skv < q_end ? skv : q_end) : skv;
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
      ks[r * ldk + d] = kx;
      vs[i] = vx;
    }
    __syncthreads();
    const int64_t key = k0 + lane;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp * RPW + i;
      float s = 0.f;
      for (int d = 0; d < hd; ++d)
        s = fmaf(qs[r * hd + d], ks[lane * ldk + d], s);
      s *= scale;
      if (key >= skv || (causal && key > q_off + q0 + r)) s = kNegInf;
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
          if (d < hd) acc[i][c] = fmaf(pj, vs[j * hd + d], acc[i][c]);
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

// The width of each output slice of the sliced kernel at head dim hd: hd
// cut into ceil(hd / kMaxSimtHD) equal parts, rounded up to a multiple of
// 32 (at most kMaxSimtHD); the last slice holds what is left.  Mirrored by
// head_slices in kernels/attention.py.
int sliced_width(int hd) {
  const int parts = (hd + kMaxSimtHD - 1) / kMaxSimtHD;
  const int per = (hd + parts - 1) / parts;
  return (per + 31) / 32 * 32;
}

// hd above kMaxSimtHD: one CTA per (16 query rows, output slice of width
// sw), head, batch.  Shared memory as the unsliced kernel at its largest
// budget: a Q slice [kSimtBQ][<= 512], a K slice [kSimtBK][(<= 512) | 1]
// and the V tile's columns of this CTA's slice [kSimtBK][<= 512].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_sliced_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out,
                        int64_t sq, int64_t skv, int64_t n_heads,
                        int64_t n_kv_heads, int hd, int sw, int n_slices,
                        int causal, int64_t q_off, float scale) {
  constexpr int RPW = kSimtBQ / (kThreads / 32);   // rows per warp
  constexpr int CPL = kMaxSimtHD / 32;             // columns per lane
  extern __shared__ float simt_smem[];
  float* qs = simt_smem;                           // [kSimtBQ][dw]
  float* ks = qs + kSimtBQ * kMaxSimtHD;           // [kSimtBK][dw | 1]
  float* vs = ks + kSimtBK * (kMaxSimtHD | 1);     // [kSimtBK][cw]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t n_qblocks = (sq + kSimtBQ - 1) / kSimtBQ;
  const int64_t qb = n_qblocks - 1 - (int64_t)blockIdx.x / n_slices;
  const int c0 = (int)(blockIdx.x % n_slices) * sw;
  const int cw = hd - c0 < sw ? hd - c0 : sw;
  const int64_t q0 = qb * kSimtBQ;
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const int64_t hk = h / (n_heads / n_kv_heads);

  float m[RPW], l[RPW], acc[RPW][CPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[i][c] = 0.f;
  }
  const int64_t q_end = q_off + q0 + kSimtBQ;
  const int64_t kv_end = causal ? (skv < q_end ? skv : q_end) : skv;
  for (int64_t k0 = 0; k0 < kv_end; k0 += kSimtBK) {
    float s[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i] = 0.f;
    for (int d0 = 0; d0 < hd; d0 += kMaxSimtHD) {
      const int dw = hd - d0 < kMaxSimtHD ? hd - d0 : kMaxSimtHD;
      const int ldk = dw | 1;
      __syncthreads();
      for (int i = threadIdx.x; i < kSimtBQ * dw; i += kThreads) {
        const int r = i / dw, d = i - r * dw;
        qs[i] = q0 + r < sq
                    ? to_f(q[((b * sq + q0 + r) * n_heads + h) * hd + d0 + d])
                    : 0.f;
      }
      for (int i = threadIdx.x; i < kSimtBK * dw; i += kThreads) {
        const int r = i / dw, d = i - r * dw;
        ks[r * ldk + d] =
            k0 + r < skv
                ? to_f(k[((b * skv + k0 + r) * n_kv_heads + hk) * hd + d0 + d])
                : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int r = warp * RPW + i;
        for (int d = 0; d < dw; ++d)
          s[i] = fmaf(qs[r * dw + d], ks[lane * ldk + d], s[i]);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kSimtBK * cw; i += kThreads) {
      const int r = i / cw, d = i - r * cw;
      const int64_t row = (b * skv + k0 + r) * n_kv_heads + hk;
      vs[i] = k0 + r < skv ? to_f(v[row * hd + c0 + d]) : 0.f;
    }
    __syncthreads();
    const int64_t key = k0 + lane;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp * RPW + i;
      float si = s[i] * scale;
      if (key >= skv || (causal && key > q_off + q0 + r)) si = kNegInf;
      float mx = si;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float p = expf(si - m_new);
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
          if (d < cw) acc[i][c] = fmaf(pj, vs[j * cw + d], acc[i][c]);
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
      if (d < cw)
        out[((b * sq + row) * n_heads + h) * hd + c0 + d] =
            from_f<T>(acc[i][c] / li);
    }
  }
}

// The launches set each kernel's dynamic shared-memory limit once (the
// function-local static of each instantiation), then launch on `stream`.
template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               int64_t batch, int64_t sq, int64_t skv, int64_t n_heads,
               int64_t n_kv_heads, int causal, int64_t q_off, float scale,
               cudaStream_t stream) {
  constexpr int kBytes = mma_smem_bytes<HD>();
  static const cudaError_t allowed = cudaFuncSetAttribute(
      flash_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBytes);
  if (allowed != cudaSuccess) return (int)allowed;
  const dim3 grid((unsigned)((sq + kMmaBQ - 1) / kMmaBQ), (unsigned)n_heads,
                  (unsigned)batch);
  flash_mma_kernel<HD><<<grid, kThreads, kBytes, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, sq, skv, n_heads,
      n_kv_heads, causal, q_off, scale);
  return (int)cudaGetLastError();
}

template <typename T, int CB>
int launch_simt(const void* q, const void* k, const void* v, void* out,
                int64_t batch, int64_t sq, int64_t skv, int64_t n_heads,
                int64_t n_kv_heads, int hd, int causal, int64_t q_off,
                float scale, cudaStream_t stream) {
  static const cudaError_t allowed = cudaFuncSetAttribute(
      flash_simt_kernel<T, CB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      simt_smem_bytes(CB));
  if (allowed != cudaSuccess) return (int)allowed;
  const dim3 grid((unsigned)((sq + kSimtBQ - 1) / kSimtBQ),
                  (unsigned)n_heads, (unsigned)batch);
  flash_simt_kernel<T, CB><<<grid, kThreads, simt_smem_bytes(hd), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, sq, skv, n_heads,
      n_kv_heads, hd, causal, q_off, scale);
  return (int)cudaGetLastError();
}

// The CUDA-core kernel at the smallest column budget that holds hd.
template <typename T>
int launch_simt_any(const void* q, const void* k, const void* v, void* out,
                    int64_t batch, int64_t sq, int64_t skv, int64_t n_heads,
                    int64_t n_kv_heads, int hd, int causal, int64_t q_off,
                    float scale, cudaStream_t stream) {
  if (hd <= 128)
    return launch_simt<T, 128>(q, k, v, out, batch, sq, skv, n_heads,
                               n_kv_heads, hd, causal, q_off, scale, stream);
  if (hd <= 256)
    return launch_simt<T, 256>(q, k, v, out, batch, sq, skv, n_heads,
                               n_kv_heads, hd, causal, q_off, scale, stream);
  return launch_simt<T, kMaxSimtHD>(q, k, v, out, batch, sq, skv, n_heads,
                                    n_kv_heads, hd, causal, q_off, scale,
                                    stream);
}

template <typename T>
int launch_sliced(const void* q, const void* k, const void* v, void* out,
                  int64_t batch, int64_t sq, int64_t skv, int64_t n_heads,
                  int64_t n_kv_heads, int hd, int causal, int64_t q_off,
                  float scale, cudaStream_t stream) {
  constexpr int kBytes = simt_smem_bytes(kMaxSimtHD);
  static const cudaError_t allowed = cudaFuncSetAttribute(
      flash_sliced_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBytes);
  if (allowed != cudaSuccess) return (int)allowed;
  const int sw = sliced_width(hd);
  const int n_slices = (hd + sw - 1) / sw;
  const int64_t blocks = (sq + kSimtBQ - 1) / kSimtBQ * n_slices;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)n_heads, (unsigned)batch);
  flash_sliced_kernel<T><<<grid, kThreads, kBytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, sq, skv, n_heads,
      n_kv_heads, hd, sw, n_slices, causal, q_off, scale);
  return (int)cudaGetLastError();
}

using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A bf16 [batch, seq, heads, 128] tensor as a 4-D map (hd, heads, seq,
// batch) with boxes of 64 dims x 1 head x 128 rows x 1 sequence: rows past
// `seq` read as zeros from within their own sequence.
bool make_map(EncodeTiledFn encode, CUtensorMap* map, const void* ptr,
              int64_t batch, int64_t seq, int64_t heads) {
  const cuuint64_t dims[4] = {(cuuint64_t)kHD, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)kHD * 2,
                                 (cuuint64_t)(heads * kHD * 2),
                                 (cuuint64_t)(seq * heads * kHD * 2)};
  const cuuint32_t box[4] = {(cuuint32_t)kBoxCols, 1u, (cuuint32_t)kBQ, 1u};
  const cuuint32_t elem_strides[4] = {1u, 1u, 1u, 1u};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int64_t batch, int64_t sq, int64_t skv, int64_t n_heads,
                 int64_t n_kv_heads, int causal, int64_t q_off, float scale,
                 cudaStream_t stream) {
  const int64_t n_hb = n_heads * batch;
  const int64_t blocks = (sq + kBQ - 1) / kBQ * n_hb;
  if (sq > INT32_MAX || skv > INT32_MAX || blocks > INT32_MAX ||
      q_off > INT32_MAX - sq - kBQ)
    return (int)cudaErrorInvalidValue;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map(encode, &tq, q, batch, sq, n_heads) ||
      !make_map(encode, &tk, k, batch, skv, n_kv_heads) ||
      !make_map(encode, &tv, v, batch, skv, n_kv_heads))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t allowed = cudaFuncSetAttribute(
      flash_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (allowed != cudaSuccess) return (int)allowed;
  flash_wgmma_kernel<<<(unsigned)blocks, kWsThreads, kSmemBytes, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)out, (int)sq, (int)skv, (int)n_heads,
      (int)n_kv_heads, (int)n_hb, causal, (int)q_off, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The kernel that flash_attention launches: 3 = the sliced CUDA-core
// kernel (hd above 512, either dtype), 2 = the Hopper kernel (bf16, hd
// 128), 1 = mma.sync (bf16, hd 16/32/64/192/256), 0 = the CUDA-core kernel
// (float32 at hd up to 512, bf16 at the others), -1 = none (invalid dtype,
// or hd outside [1, INT32_MAX]).
extern "C" int flash_attention_route(int64_t hd, int dtype) {
  if (hd < 1 || hd > kMaxRouteHD || (dtype != 0 && dtype != 1)) return -1;
  if (hd > kMaxSimtHD) return 3;
  if (dtype == 0) return 0;
  if (hd == kHD) return 2;
  return hd == 16 || hd == 32 || hd == 64 || hd == 192 || hd == 256 ? 1 : 0;
}

// dtype: 0 = float32, 1 = bfloat16.  q [B, Sq, H, hd]; k, v [B, Skv, Hkv,
// hd]; out [B, Sq, H, hd]; all contiguous, Hkv | H, 1 <= hd <= INT32_MAX,
// Sq and Skv >= 1; bf16 pointers 16-byte aligned.  q_off >= 0: the
// position of query row 0 under the causal mask (0: the rows start at the
// keys' start).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int64_t batch, int64_t sq,
                               int64_t skv, int64_t n_heads,
                               int64_t n_kv_heads, int64_t hd, int causal,
                               int64_t q_off, int dtype, float scale,
                               void* stream) {
  const int route = flash_attention_route(hd, dtype);
  if (route < 0 || n_kv_heads < 1 || n_heads % n_kv_heads != 0 || sq < 1 ||
      skv < 1 || q_off < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (route == 2)
    return launch_wgmma(q, k, v, out, batch, sq, skv, n_heads, n_kv_heads,
                        causal, q_off, scale, st);
  if (route == 3)
    return dtype == 1
               ? launch_sliced<__nv_bfloat16>(q, k, v, out, batch, sq, skv,
                                              n_heads, n_kv_heads, (int)hd,
                                              causal, q_off, scale, st)
               : launch_sliced<float>(q, k, v, out, batch, sq, skv, n_heads,
                                      n_kv_heads, (int)hd, causal, q_off,
                                      scale, st);
  if (route == 1) {
    switch (hd) {
#define MMA_CASE(D)                                                        \
  case D:                                                                  \
    return launch_mma<D>(q, k, v, out, batch, sq, skv, n_heads, n_kv_heads, \
                         causal, q_off, scale, st);
      MMA_CASE(16)
      MMA_CASE(32)
      MMA_CASE(64)
      MMA_CASE(192)
      MMA_CASE(256)
#undef MMA_CASE
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == 1)
    return launch_simt_any<__nv_bfloat16>(q, k, v, out, batch, sq, skv,
                                          n_heads, n_kv_heads, (int)hd,
                                          causal, q_off, scale, st);
  return launch_simt_any<float>(q, k, v, out, batch, sq, skv, n_heads,
                                n_kv_heads, (int)hd, causal, q_off, scale,
                                st);
}
