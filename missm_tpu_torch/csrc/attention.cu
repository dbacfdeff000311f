// Softmax self-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces two Pallas TPU kernels of missm_tpu/kernels/flash_attention.py:
//   K1  fused_attention_cls (_attn_kernel_packed_cls): bias-free attention of
//       the ViT towers, q [B, 257, 16*64]. Here K/V are not split into a CLS
//       row and 256 main keys: that split only fills the TPU's 128-wide lanes,
//       and on this card the k/v projections run over all 257 tokens at once.
//   K2  fused_attention(causal=True, kbias=...) (_attn_kernel_packed): the
//       text tower's causal attention with an additive key bias [B, 1, N]
//       (finfo(float32).min at padded keys), q [B, 77, 12*64].
// Both are the same kernel here, templated on CAUSAL and HAS_KBIAS. With
// WRITE_LSE (bias-free only: the K1 forward called for autograd) it also
// writes each row's log-sum-exp, f32 [B, H, N], which the backward kernel
// (attention_bwd.cu) uses to recompute P; eval never sets it.
//
// Math (as the Pallas kernels): s = (q . k) * hd^-0.5 in f32; s += kbias[key];
// then s = finfo(float32).min where key > query (causal). Softmax in f32 with
// the row sum taken over the unrounded exponentials; P is rounded to the input
// type only as an operand of P.V, which accumulates in f32. The output is
// divided by the row sum in f32 and written in the input type.
//
// Layout: q, k, v and out are [B, N, H*hd] (the projections' own layout, no
// head transposes); block (query tile, head, batch) reads its head's columns
// with the row pitch H*hd.
//
// What bounds it on this card: at the main path's shapes the function is
// memory-bound (K1 at B=64: ~135 MB moved for ~17 GFLOP, ~51 FLOP/byte, far
// below the H100's ~295 bf16 FLOP/byte). The design therefore reads each q
// row once and keeps the [N, N] scores on chip: one block per (64-query tile,
// head, batch) walks the keys in 64-key tiles with an online softmax (running
// max and sum), so scores never reach device memory and K/V re-reads of the
// other query tiles of the same head mostly hit L2. bf16 products run on the
// tensor cores through mma.sync m16n8k16 with f32 accumulators; f32 inputs
// take a CUDA-core path (4 threads per query row) that keeps full f32
// precision. No wgmma, TMA or cp.async pipelining yet: tiles are loaded with
// 16-byte vector loads between two barriers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kFMin = -3.4028234663852886e+38f;  // finfo(float32).min

template <bool CAUSAL, bool HAS_KBIAS>
__device__ __forceinline__ float masked_score(float s, float kb, int query,
                                              int key, int n) {
  if (HAS_KBIAS) s += kb;
  if (CAUSAL && key > query) s = kFMin;
  if (key >= n) s = -INFINITY;  // past the sequence: not a key at all
  return s;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, f32 accumulate)
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;       // query rows per block: 4 warps x 16 rows
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 128;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> packed bf16x2, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t join_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Rows [row0, row0 + kBK) of one head's [N, HD] slice (row pitch d) into
// shared memory with pitch LD; rows past n are zero.
template <int HD, int LD>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               int row0, int n, int d) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kBK * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * d + col);
    *reinterpret_cast<uint4*>(dst + r * LD + col) = val;
  }
}

template <int HD, bool CAUSAL, bool HAS_KBIAS, bool WRITE_LSE>
__global__ void __launch_bounds__(kThreads)
attention_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const float* __restrict__ kbias,
               __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int n,
               int h, float scale) {
  // Pitch HD + 8 puts the 8 rows x 4 column pairs a warp's fragment load
  // touches on 32 distinct banks.
  constexpr int LD = HD + 8;
  constexpr int kSteps = HD / 16;  // k-steps of Q.K^T
  constexpr int kSTiles = kBK / 8; // 8-key score tiles
  constexpr int kOTiles = HD / 8;  // 8-column output tiles
  __shared__ __align__(16) __nv_bfloat16 ks[kBK * LD];  // Q first, then K
  __shared__ __align__(16) __nv_bfloat16 vs[kBK * LD];
  __shared__ float kbs[kBK];

  const int d = h * HD;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const size_t base = (size_t)b * n * d + (size_t)head * HD;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row within the 8-row group
  const int t = lane & 3;   // fragment column pair
  const int q0 = blockIdx.x * kBQ;
  const int qi0 = q0 + warp * 16 + g;  // this thread's two query rows
  const int qi1 = qi0 + 8;

  // This warp's 16 query rows as A fragments, kept in registers.
  load_tile_bf16<HD, LD>(ks, q + base, q0, n, d);
  __syncthreads();
  uint32_t qf[kSteps][4];
  {
    const __nv_bfloat16* r0 = ks + (warp * 16 + g) * LD + 2 * t;
    const __nv_bfloat16* r1 = r0 + 8 * LD;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      qf[kk][0] = ld_pair(r0 + kk * 16);
      qf[kk][1] = ld_pair(r1 + kk * 16);
      qf[kk][2] = ld_pair(r0 + kk * 16 + 8);
      qf[kk][3] = ld_pair(r1 + kk * 16 + 8);
    }
  }

  float o[kOTiles][4];
#pragma unroll
  for (int j = 0; j < kOTiles; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running row maxima
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sums

  for (int k0 = 0; k0 < n; k0 += kBK) {
    __syncthreads();  // everyone is done with the previous tile (or with Q)
    load_tile_bf16<HD, LD>(ks, k + base, k0, n, d);
    load_tile_bf16<HD, LD>(vs, v + base, k0, n, d);
    if (HAS_KBIAS && threadIdx.x < kBK)
      kbs[threadIdx.x] =
          k0 + threadIdx.x < n ? kbias[(size_t)b * n + k0 + threadIdx.x] : 0.f;
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys per warp.
    float s[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kr = ks + (j * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
        mma_bf16(s[j], qf[kk], ld_pair(kr + kk * 16), ld_pair(kr + kk * 16 + 8));
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = j * 8 + 2 * t + (e & 1);
        const float kb = HAS_KBIAS ? kbs[kl] : 0.f;
        s[j][e] = masked_score<CAUSAL, HAS_KBIAS>(s[j][e] * scale, kb,
                                                 e < 2 ? qi0 : qi1, k0 + kl, n);
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    // The 4 threads of a fragment row hold its 64 scores between them.
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // Key 0 is in the first tile and is never masked to -inf, so the new
    // maxima are finite and the rescale factors are exp(finite or -inf).
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0);
    const float a1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int j = 0; j < kOTiles; ++j) {
      o[j][0] *= a0;
      o[j][1] *= a0;
      o[j][2] *= a1;
      o[j][3] *= a1;
    }
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
      s[j][0] = expf(s[j][0] - mn0);
      s[j][1] = expf(s[j][1] - mn0);
      s[j][2] = expf(s[j][2] - mn1);
      s[j][3] = expf(s[j][3] - mn1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }

    // O += P V: the score accumulators of two neighbouring 8-key tiles are
    // exactly the A fragment of one 16-key step.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vr = vs + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int j = 0; j < kOTiles; ++j) {
        const __nv_bfloat16* vc = vr + j * 8;
        const uint32_t b0 = join_bf16(vc[0], vc[LD]);
        const uint32_t b1 = join_bf16(vc[8 * LD], vc[9 * LD]);
        mma_bf16(o[j], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
  if (WRITE_LSE && t == 0) {
    float* row = lse + ((size_t)b * h + head) * n;
    if (qi0 < n) row[qi0] = m0 + logf(l0);
    if (qi1 < n) row[qi1] = m1 + logf(l1);
  }
#pragma unroll
  for (int j = 0; j < kOTiles; ++j) {
    const int col = j * 8 + 2 * t;
    if (qi0 < n)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)qi0 * d + col) =
          pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
    if (qi1 < n)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)qi1 * d + col) =
          pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, 4 threads per query row, full f32 products
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 32;  // query rows per block (128 threads)
constexpr int kF32Keys = 32;  // keys per tile

template <int HD, bool CAUSAL, bool HAS_KBIAS, bool WRITE_LSE>
__global__ void __launch_bounds__(kThreads)
attention_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ kbias,
              float* __restrict__ out, float* __restrict__ lse, int n, int h,
              float scale) {
  constexpr int R = HD / 4;  // dims per thread: part, part + 4, part + 8, ...
  __shared__ __align__(16) float ks[kF32Keys * HD];
  __shared__ __align__(16) float vs[kF32Keys * HD];
  __shared__ float kbs[kF32Keys];

  const int d = h * HD;
  const size_t base = (size_t)blockIdx.z * n * d + (size_t)blockIdx.y * HD;
  const int part = threadIdx.x & 3;
  const int qi = blockIdx.x * kF32Rows + (threadIdx.x >> 2);

  float qr[R], o[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    qr[i] = qi < n ? q[base + (size_t)qi * d + part + 4 * i] : 0.f;
    o[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < n; k0 += kF32Keys) {
    __syncthreads();
    for (int c = threadIdx.x; c < kF32Keys * HD / 4; c += kThreads) {
      const int r = c / (HD / 4);
      const int col = (c % (HD / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < n) {
        const size_t off = base + (size_t)(k0 + r) * d + col;
        kv = *reinterpret_cast<const float4*>(k + off);
        vv = *reinterpret_cast<const float4*>(v + off);
      }
      *reinterpret_cast<float4*>(ks + r * HD + col) = kv;
      *reinterpret_cast<float4*>(vs + r * HD + col) = vv;
    }
    if (HAS_KBIAS && threadIdx.x < kF32Keys)
      kbs[threadIdx.x] = k0 + threadIdx.x < n
                             ? kbias[(size_t)blockIdx.z * n + k0 + threadIdx.x]
                             : 0.f;
    __syncthreads();

    const int kn = min(kF32Keys, n - k0);
    for (int j = 0; j < kn; ++j) {
      float sp = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) sp = fmaf(qr[i], ks[j * HD + part + 4 * i], sp);
      // The four partial dots of a row; every lane of the quad ends with the
      // same bits (the pairwise adds commute).
      sp += __shfl_xor_sync(0xffffffffu, sp, 1);
      sp += __shfl_xor_sync(0xffffffffu, sp, 2);
      const float s = masked_score<CAUSAL, HAS_KBIAS>(
          sp * scale, HAS_KBIAS ? kbs[j] : 0.f, qi, k0 + j, n);
      if (s > m) {
        const float a = expf(m - s);
        l *= a;
#pragma unroll
        for (int i = 0; i < R; ++i) o[i] *= a;
        m = s;
      }
      const float p = expf(s - m);
      l += p;
#pragma unroll
      for (int i = 0; i < R; ++i) o[i] = fmaf(p, vs[j * HD + part + 4 * i], o[i]);
    }
  }
  if (qi < n) {
    const float inv = 1.f / l;
    if (WRITE_LSE && part == 0)
      lse[((size_t)blockIdx.z * h + blockIdx.y) * n + qi] = m + logf(l);
#pragma unroll
    for (int i = 0; i < R; ++i) out[base + (size_t)qi * d + part + 4 * i] = o[i] * inv;
  }
}

template <int HD, bool CAUSAL, bool HAS_KBIAS, bool WRITE_LSE>
void launch(const void* q, const void* k, const void* v, const void* kbias,
            void* out, float* lse, int b, int n, int h, int is_bf16,
            float scale, cudaStream_t stream) {
  if (is_bf16) {
    const dim3 grid((n + kBQ - 1) / kBQ, h, b);
    attention_bf16<HD, CAUSAL, HAS_KBIAS, WRITE_LSE><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(kbias),
        static_cast<__nv_bfloat16*>(out), lse, n, h, scale);
  } else {
    const dim3 grid((n + kF32Rows - 1) / kF32Rows, h, b);
    attention_f32<HD, CAUSAL, HAS_KBIAS, WRITE_LSE><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(kbias),
        static_cast<float*>(out), lse, n, h, scale);
  }
}

// The log-sum-exp is written only for bias-free attention (K1 under
// autograd); the causal path's backward is plain PyTorch.
template <int HD>
void launch_flags(const void* q, const void* k, const void* v,
                  const void* kbias, void* out, float* lse, int b, int n,
                  int h, int is_bf16, int causal, float scale,
                  cudaStream_t stream) {
  if (causal) {
    if (kbias) launch<HD, true, true, false>(q, k, v, kbias, out, lse, b, n, h, is_bf16, scale, stream);
    else launch<HD, true, false, false>(q, k, v, kbias, out, lse, b, n, h, is_bf16, scale, stream);
  } else if (kbias) {
    launch<HD, false, true, false>(q, k, v, kbias, out, lse, b, n, h, is_bf16, scale, stream);
  } else if (lse) {
    launch<HD, false, false, true>(q, k, v, kbias, out, lse, b, n, h, is_bf16, scale, stream);
  } else {
    launch<HD, false, false, false>(q, k, v, kbias, out, lse, b, n, h, is_bf16, scale, stream);
  }
}

}  // namespace

// q, k, v, out: [b, n, h * head_dim] contiguous, 16-byte aligned, bf16
// (is_bf16 = 1) or f32. kbias: [b, 1, n] f32 or null. lse: [b, h, n] f32
// written when not null (bias-free, non-causal only; cudaErrorInvalidValue
// otherwise). head_dim: a multiple of 16 up to 128. Launches on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for a head_dim it was
// not built for).
extern "C" int missm_attention_forward(const void* q, const void* k,
                                       const void* v, const void* kbias,
                                       void* out, void* lse, int b, int n,
                                       int h, int head_dim, int is_bf16,
                                       int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (l && (causal || kbias)) return static_cast<int>(cudaErrorInvalidValue);
  switch (head_dim) {
#define MISSM_HD(HD)                                                        \
  case HD:                                                                  \
    launch_flags<HD>(q, k, v, kbias, out, l, b, n, h, is_bf16, causal, scale, s); \
    break;
    MISSM_HD(16) MISSM_HD(32) MISSM_HD(48) MISSM_HD(64)
    MISSM_HD(80) MISSM_HD(96) MISSM_HD(112) MISSM_HD(128)
#undef MISSM_HD
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
