// Softmax self-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces two Pallas TPU kernels of missm_tpu/kernels/flash_attention.py:
//   K1  fused_attention_cls (_attn_kernel_packed_cls): bias-free attention of
//       the ViT towers, q [B, 257, 16*64]. Here K/V are not split into a CLS
//       row and 256 main keys: that split only fills the TPU's 128-wide lanes,
//       and on this card the k/v projections run over all 257 tokens at once.
//       The same bias-free kernel serves K2 unmasked (the audio tower,
//       [B, 593, 16*64]).
//   K2  fused_attention(causal=True, kbias=...) (_attn_kernel_packed): the
//       text tower's causal attention with an additive key bias [B, 1, N]
//       (finfo(float32).min at padded keys), q [B, 77, 12*64].
// Both are the same kernel here, templated on CAUSAL and HAS_KBIAS. With
// WRITE_LSE (bias-free only: the K1 forward called for autograd) it also
// writes each row's log-sum-exp, f32 [B, H, N], which the backward kernel
// (attention_bwd.cu) uses to recompute P; eval never sets it.
//
// Math (as the Pallas kernels): s = (q . k) * hd^-0.5 in f32; s += kbias[key];
// then s = finfo(float32).min where key > query (causal); keys past N are not
// keys (-inf). Softmax in f32 with the row sum taken over the unrounded
// exponentials; P is rounded to the input type only as an operand of P.V,
// which accumulates in f32. The output is divided by the row sum in f32 and
// written in the input type. The bf16 kernel takes the exponentials in base 2
// with log2(e) folded into the scale (exp2 of the same exponent); a masked
// score stays finfo.min, so a row whose every key is masked still weighs its
// computed keys alike instead of turning NaN.
//
// Layout: q, k, v and out are [B, N, H*hd] (the projections' own layout, no
// head transposes).
//
// What bounds it on this card: at the main path's shapes the function moves
// q, k, v and out once (K1 at B=64: 135 MB, 0.040 ms at 3.35 TB/s) for
// 4 N^2 hd FLOP a head (17 GFLOP, 0.018 ms at 989 TFLOP/s). Per 64 x 64 tile
// of scores a block also takes 4096 exponentials on the SFU (16 a clock an
// SM) and ~5 f32 instructions a score, about as long as the tile's two
// products at the tensor cores' peak. The bf16 kernel:
//   - one warpgroup (4 warps, wgmma's M of 64 rows) per 64-query tile walks
//     the keys in 64-key tiles with an online softmax (running max and sum);
//   - S = Q.K^T is wgmma m64nNk16 with Q and K in shared memory; O += P.V is
//     wgmma with P from S's accumulators as the register A operand and V
//     MN-major in shared memory (no transposed copy, no scalar gathers);
//   - Q, K and V arrive by TMA (hopper.cuh: a 3-D map over [B, N, H*hd],
//     zero-filled past N), K and V through a ring of kStages tile pairs whose
//     mbarriers complete on their bytes, so tile j + 1 lands while tile j is
//     computed;
//   - bias-free, the max is taken over the raw scores and the scale, with
//     log2(e), folds into one FFMA before a single-instruction exp2;
//   - the last key tile is as narrow as its keys (N mod 64 rounded up to 8,
//     wgmma's N step; P.V pads it to 16 keys with P = 0), causal tiles wholly
//     above a query tile's diagonal are not visited, the query tiles with a
//     ragged tail run after every full tile, and in a ragged tile the warps
//     without a live row skip the softmax. At N = 257 a head computes
//     320 x 264 scores (84,480; the old 64 x 64 grid 102,400) and takes
//     272 x 264 exponentials; kernels/attention.py::plan counts them.
// Measured against other designs on one card (PERF.md, section 6): two
// warpgroups sharing each K/V tile, a producer warp with full/empty
// barriers, the next tile's scores issued under the softmax, P.V or the
// scores overlapped in half tiles, and Q as a register operand were all
// slower or no faster: each added registers or barriers and lost more to
// occupancy (4 blocks of 108 registers an SM here) than it won.
// f32 inputs take a CUDA-core path (4 threads per query row) that keeps
// full f32 precision; it is the card's f32 reference in the checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kFMin = -3.4028234663852886e+38f;  // finfo(float32).min
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kThreads = 128;

template <bool CAUSAL, bool HAS_KBIAS>
__device__ __forceinline__ float masked_score(float s, float kb, int query,
                                              int key, int n) {
  if (HAS_KBIAS) s += kb;
  if (CAUSAL && key > query) s = kFMin;
  if (key >= n) s = -INFINITY;  // past the sequence: not a key at all
  return s;
}

// ---------------------------------------------------------------------------
// bf16: wgmma, TMA ring
// ---------------------------------------------------------------------------

constexpr int kRows = 64;    // query rows per block: one warpgroup
constexpr int kKeys = 64;    // keys per full tile
constexpr int kStages = 2;   // K/V tile pairs in flight

// Shared memory of the bf16 kernel: Q, kStages (K, V) pairs, the barriers,
// and 1024 bytes to align the tiles (kernels/attention.py::plan mirrors it).
template <int HD>
constexpr int smem_bytes() {
  return 1024 + (1 + 2 * kStages) * kRows * HD * 2 + 8 * (1 + kStages);
}

// Per-row state of the online softmax (two rows a thread), the output
// accumulator in wgmma's layout, and P of the current tile as P.V's
// register operand.
template <int HD>
struct RowState {
  float o[HD / 2];
  float m[2], l[2];  // running max (raw or log2 units), share of the sum
  uint32_t p[kKeys / 16][4];
};

// S = Q K^T for a tile of NK keys, issued (the caller commits and waits).
template <int HD, int NK>
__device__ __forceinline__ void issue_scores(float* s, uint32_t qs,
                                             uint32_t ks) {
  using T = Tiles<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss<NK>(s, T::kmajor(qs, kRows, kk), T::kmajor(ks, kKeys, kk), kk);
}

// O += P V for the tile of NK keys whose P is in st.p, issued.
template <int HD, int NK>
__device__ __forceinline__ void issue_pv(RowState<HD>& st, uint32_t vs) {
  using T = Tiles<HD>;
#pragma unroll
  for (int kk = 0; kk < (NK + 15) / 16; ++kk)
#pragma unroll
    for (int c = 0; c < T::kChunks; ++c)
      wgmma_rs<T::kCols>(st.o + c * T::kCols / 2, st.p[kk],
                         T::mnmajor(vs, kKeys, kk, c), 1);
}

// The online softmax over the NK scores of a tile (k0 its first key; LAST:
// the last tile, NK = N - k0 rounded up to 8, whose keys past N are
// masked; kb: the key bias of this thread's keys in log2 units): updates the
// running max and sum, rescales the output accumulator, and leaves P,
// rounded to bf16, in st.p. A warp with no live row leaves P = 0 and the
// state as it was.
template <int HD, int NK, bool LAST, bool CAUSAL, bool HAS_KBIAS>
__device__ __forceinline__ void softmax_tile(float* s, RowState<HD>& st,
                                             const float (*kb)[2], int k0,
                                             int r0, int n, bool live,
                                             float scale_log2) {
  const int t = threadIdx.x & 3;
  if (live) {
    // Bias-free, the max is taken over the raw scores and the scale folds
    // into the exponent, one FFMA a score: exp2(s c - m c), c = scale
    // log2(e). With a mask the scores go to log2 units first (c = 1), so
    // that a masked one can be held at finfo.min.
    constexpr bool kMasked = CAUSAL || HAS_KBIAS;
    const float c = kMasked ? 1.f : scale_log2;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        const int row = r0 + 8 * (e >> 1);
        float x = s[4 * j + e];
        if (kMasked) x *= scale_log2;
        // a key bias of finfo.min is -inf in log2 units: hold it at finfo.min
        if (HAS_KBIAS) x = fmaxf(x + kb[j][e & 1], kFMin);
        if (CAUSAL && key > row) x = kFMin;
        if (LAST && key >= n) x = -INFINITY;
        s[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float mc[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // the 4 threads of a fragment row hold its NK scores between them
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // key 0 is in the first tile and is never -inf, so the new max is
      // finite and the rescale factor is exp2(finite or -inf)
      const float mn = fmaxf(st.m[i], mx[i]);
      const float a = ex2((st.m[i] - mn) * c);
      st.m[i] = mn;
      mc[i] = mn * c;
      st.l[i] *= a;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        st.o[4 * j + 2 * i] *= a;
        st.o[4 * j + 2 * i + 1] *= a;
      }
    }
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * j + e] = ex2(fmaf(s[4 * j + e], c, -mc[e >> 1]));
        st.l[e >> 1] += s[4 * j + e];
      }
  } else {
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) s[i] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < (NK + 15) / 16; ++kk) acc_to_a<NK>(s, kk, st.p[kk]);
}

// One key tile of NK keys (k0 its first; LAST: the last tile, whose keys
// past N are masked): S = Q K^T, the softmax, O += P V, each product waited
// for before the next step.
template <int HD, int NK, bool LAST, bool CAUSAL, bool HAS_KBIAS>
__device__ __forceinline__ void fwd_tile(RowState<HD>& st, uint32_t qs,
                                         uint32_t ks, uint32_t vs,
                                         const float* kbias, int k0, int r0,
                                         int n, bool live, float scale_log2) {
  // the key bias is read before the product, so that it lands meanwhile
  float kb[NK / 8][2];
  if (HAS_KBIAS) {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * t + e;
        kb[j][e] = key < n ? kbias[key] * kLog2e : 0.f;
      }
  }
  float s[NK / 2];
  wgmma_fence();
  issue_scores<HD, NK>(s, qs, ks);
  wgmma_commit();
  wgmma_wait();
  fence_regs<NK / 2>(s);
  softmax_tile<HD, NK, LAST, CAUSAL, HAS_KBIAS>(s, st, kb, k0, r0, n, live,
                                                scale_log2);
  fence_regs<kKeys / 16>(st.p);
  fence_regs<HD / 2>(st.o);
  wgmma_fence();
  issue_pv<HD, NK>(st, vs);
  wgmma_commit();
  wgmma_wait();
  fence_regs<HD / 2>(st.o);
}

// The key tile j of a query tile: full, or the narrow last one.
template <int HD, bool CAUSAL, bool HAS_KBIAS>
__device__ __forceinline__ void fwd_tile_at(RowState<HD>& st, int j,
                                            int kfull, int tail, uint32_t qs,
                                            uint32_t ks, uint32_t vs,
                                            const float* kbias, int r0, int n,
                                            bool live, float scale_log2) {
  const int k0 = j * kKeys;
  if (j < kfull) {
    fwd_tile<HD, 64, false, CAUSAL, HAS_KBIAS>(st, qs, ks, vs, kbias, k0, r0,
                                               n, live, scale_log2);
    return;
  }
  switch (tail) {
#define MISSM_TAIL(NK)                                                       \
  case NK:                                                                   \
    fwd_tile<HD, NK, true, CAUSAL, HAS_KBIAS>(st, qs, ks, vs, kbias, k0, r0, \
                                              n, live, scale_log2);          \
    break;
    MISSM_TAIL(8) MISSM_TAIL(16) MISSM_TAIL(24) MISSM_TAIL(32)
    MISSM_TAIL(40) MISSM_TAIL(48) MISSM_TAIL(56) MISSM_TAIL(64)
#undef MISSM_TAIL
  }
}

// The output rows of this thread, divided by the row sums, and (WRITE_LSE)
// their log-sum-exp.
template <int HD, bool WRITE_LSE>
__device__ __forceinline__ void fwd_store(RowState<HD>& st,
                                          __nv_bfloat16* out, float* lse,
                                          int r0, int n, int h, int head,
                                          int b, float scale_log2) {
  using T = Tiles<HD>;
  const int t = threadIdx.x & 3;
  const int d = h * HD;
  const size_t base = (size_t)b * n * d + (size_t)head * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = st.l[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = r0 + 8 * i;
    if (row >= n) continue;
    if (WRITE_LSE && t == 0)
      lse[((size_t)b * h + head) * n + row] =
          (st.m[i] * scale_log2 + log2f(l)) * kLn2;  // bias-free: raw max
    const float inv = 1.f / l;
    __nv_bfloat16* orow = out + base + (size_t)row * d;
#pragma unroll
    for (int c = 0; c < T::kChunks; ++c)
#pragma unroll
      for (int j = 0; j < T::kCols / 8; ++j) {
        const float* o = st.o + c * T::kCols / 2 + 4 * j + 2 * i;
        *reinterpret_cast<uint32_t*>(orow + c * T::kCols + 8 * j + 2 * t) =
            pack_bf16(o[0] * inv, o[1] * inv);
      }
  }
}

template <int HD>
__device__ __forceinline__ void init_state(RowState<HD>& st) {
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) st.o[i] = 0.f;
  st.m[0] = st.m[1] = -INFINITY;
  st.l[0] = st.l[1] = 0.f;
}

// Block x: the query tiles with 64 live rows of every (head, batch), tile
// fastest, then the ragged tail tile of every (head, batch).
template <int HD, bool CAUSAL, bool HAS_KBIAS, bool WRITE_LSE>
__global__ void __launch_bounds__(kThreads)
attention_bf16(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const float* __restrict__ kbias,
               __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int n,
               int h, int nb, float scale_log2) {
  using T = Tiles<HD>;
  constexpr int kTile = kRows * HD * 2;  // bytes of a 64-row tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + (1 + 2 * kStages) * kTile);
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;  // kStages: K and V of tile j in stage j % kStages

  const int full_tiles = n / kRows;
  int tile, bh;
  if ((int)blockIdx.x < full_tiles * h * nb) {
    tile = blockIdx.x % full_tiles;
    bh = blockIdx.x / full_tiles;
  } else {
    tile = full_tiles;
    bh = blockIdx.x - full_tiles * h * nb;
  }
  const int head = bh % h;
  const int b = bh / h;
  const int q0 = tile * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = q0 + warp * 16 + (lane >> 2);  // this thread's rows r0, r0 + 8
  const bool live = q0 + warp * 16 < n;
  // keys this query tile sees: causal stops at its last row
  const int kend = CAUSAL ? min(n, q0 + kRows) : n;
  const int kfull = kend / kKeys;
  const int ntiles = kfull + (kend % kKeys ? 1 : 0);
  const int tail = ((kend % kKeys) + 7) / 8 * 8;
  const float* kb = HAS_KBIAS ? kbias + (size_t)b * n : nullptr;

  const uint32_t qs = smem_u32(smem);
  auto stage = [&](int j) { return smem + (1 + 2 * (j % kStages)) * kTile; };
  auto load = [&](int j) {
    uint64_t* bar = full + j % kStages;
    mbar_expect(bar, 2 * kTile);
    T::load(stage(j), kKeys, &tk, bar, head, j * kKeys, b);
    T::load(stage(j) + kTile, kKeys, &tv, bar, head, j * kKeys, b);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(bars + i, 1);
    mbar_fence_init();
    mbar_expect(qbar, kTile);
    T::load(smem, kRows, &tq, qbar, head, q0, b);
    for (int j = 0; j < min(kStages, ntiles); ++j) load(j);
  }
  __syncthreads();

  RowState<HD> st;
  init_state<HD>(st);
  mbar_wait(qbar, 0);
  for (int j = 0; j < ntiles; ++j) {
    mbar_wait(full + j % kStages, (j / kStages) & 1);
    const uint32_t ks = smem_u32(stage(j));
    fwd_tile_at<HD, CAUSAL, HAS_KBIAS>(st, j, kfull, tail, qs, ks, ks + kTile,
                                       kb, r0, n, live, scale_log2);
    __syncthreads();  // every warp is done with K_j and V_j
    if (threadIdx.x == 0 && j + kStages < ntiles) load(j + kStages);
  }
  fwd_store<HD, WRITE_LSE>(st, out, lse, r0, n, h, head, b, scale_log2);
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
int launch(const void* q, const void* k, const void* v, const void* kbias,
           void* out, float* lse, int b, int n, int h, int is_bf16,
           float scale, cudaStream_t stream) {
  if (!is_bf16) {
    const dim3 grid((n + kF32Rows - 1) / kF32Rows, h, b);
    attention_f32<HD, CAUSAL, HAS_KBIAS, WRITE_LSE><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(kbias),
        static_cast<float*>(out), lse, n, h, scale);
    return 0;
  }
  constexpr int kCols = Tiles<HD>::kCols;
  CUtensorMap tq, tk, tv;
  int rc = encode_rows(&tq, q, b, n, h * HD, kRows, kCols);
  if (!rc) rc = encode_rows(&tk, k, b, n, h * HD, kKeys, kCols);
  if (!rc) rc = encode_rows(&tv, v, b, n, h * HD, kKeys, kCols);
  auto kernel = attention_bf16<HD, CAUSAL, HAS_KBIAS, WRITE_LSE>;
  static unsigned long long attr_set = 0;
  if (!rc) rc = allow_smem(kernel, smem_bytes<HD>(), attr_set);
  if (rc) return rc;
  const int blocks = b * h * ((n + kRows - 1) / kRows);
  kernel<<<blocks, kThreads, smem_bytes<HD>(), stream>>>(
      tq, tk, tv, static_cast<const float*>(kbias),
      static_cast<__nv_bfloat16*>(out), lse, n, h, b, scale * kLog2e);
  return 0;
}

// The log-sum-exp is written only for bias-free attention (K1 under
// autograd); the causal path's backward is plain PyTorch.
template <int HD>
int launch_flags(const void* q, const void* k, const void* v,
                 const void* kbias, void* out, float* lse, int b, int n, int h,
                 int is_bf16, int causal, float scale, cudaStream_t stream) {
  if (causal) {
    if (kbias) return launch<HD, true, true, false>(q, k, v, kbias, out, lse, b, n, h, is_bf16, scale, stream);
    return launch<HD, true, false, false>(q, k, v, kbias, out, lse, b, n, h, is_bf16, scale, stream);
  }
  if (kbias) return launch<HD, false, true, false>(q, k, v, kbias, out, lse, b, n, h, is_bf16, scale, stream);
  if (lse) return launch<HD, false, false, true>(q, k, v, kbias, out, lse, b, n, h, is_bf16, scale, stream);
  return launch<HD, false, false, false>(q, k, v, kbias, out, lse, b, n, h, is_bf16, scale, stream);
}

}  // namespace

// q, k, v, out: [b, n, h * head_dim] contiguous, 16-byte aligned, bf16
// (is_bf16 = 1) or f32. kbias: [b, 1, n] f32 or null. lse: [b, h, n] f32
// written when not null (bias-free, non-causal only; cudaErrorInvalidValue
// otherwise). head_dim: a multiple of 16 up to 128. Launches on `stream` and
// returns the first error: of the tensor maps or the shared-memory attribute
// (bf16), else cudaGetLastError() (cudaErrorInvalidValue for a head_dim it
// was not built for).
extern "C" int missm_attention_forward(const void* q, const void* k,
                                       const void* v, const void* kbias,
                                       void* out, void* lse, int b, int n,
                                       int h, int head_dim, int is_bf16,
                                       int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (l && (causal || kbias)) return static_cast<int>(cudaErrorInvalidValue);
  int rc;
  switch (head_dim) {
#define MISSM_HD(HD)                                                        \
  case HD:                                                                  \
    rc = launch_flags<HD>(q, k, v, kbias, out, l, b, n, h, is_bf16, causal, \
                          scale, s);                                        \
    break;
    MISSM_HD(16) MISSM_HD(32) MISSM_HD(48) MISSM_HD(64)
    MISSM_HD(80) MISSM_HD(96) MISSM_HD(112) MISSM_HD(128)
#undef MISSM_HD
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return rc ? rc : static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of the bf16 kernel at head_dim (0 for a
// head_dim it was not built for): what kernels/attention.py::plan says.
extern "C" int missm_attention_forward_smem(int head_dim) {
  switch (head_dim) {
#define MISSM_HD(HD) \
  case HD:           \
    return smem_bytes<HD>();
    MISSM_HD(16) MISSM_HD(32) MISSM_HD(48) MISSM_HD(64)
    MISSM_HD(80) MISSM_HD(96) MISSM_HD(112) MISSM_HD(128)
#undef MISSM_HD
    default:
      return 0;
  }
}
