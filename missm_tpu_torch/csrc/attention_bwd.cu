// Softmax self-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels fused_attention_cls_bwd
// (_attn_bwd_kernel_packed_cls, K3) and fused_attention_bwd unmasked (K4,
// through fused_attention_ad) of missm_tpu/kernels/flash_attention.py: the
// gradient of the bias-free attention of attention.cu, q [B, 257, 16*64] (the
// ViT towers) and [B, 593, 16*64] (the audio tower). The TPU kernel takes K/V
// split into a CLS row and 256 main keys, and packs head pairs, only to fill
// its 128-wide lanes; here K/V come whole and each block works on one head.
//
// Math, with P = softmax(q k^T * scale) per (batch, head), scale = hd^-0.5:
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - D),  D = rowsum(dP P),
//   dQ = dS K * scale,  dK = dS^T Q * scale.
// D is computed as rowsum(dO O) from the forward's output O, the same sum
// up to O's rounding to the input type (exact in f32). P is recomputed in f32
// as exp(s * scale - lse) from the per-row log-sum-exp that the forward
// wrote (bf16: exp2 with log2(e) folded into the scale and the lse). Rounding
// points are the TPU kernel's: P is rounded to the input type only as the
// operand of dV, dS is computed in f32 and rounded to the input type before
// the dQ and dK products, all products accumulate in f32, the scale is
// applied to the f32 accumulator and each output is cast once.
//
// Layout: q, k, v, o, dO, dq, dk, dv are [B, N, H*hd] (no head transposes);
// lse and D are f32 [B, H, N].
//
// What bounds it on this card: at K3's shape (B=16, N=257, H=16, hd=64) the
// function moves 59 MB (q, k, v, dO read, dq, dk, dv written; 0.018 ms at
// 3.35 TB/s) for 5 products of 2 N^2 hd a head (10.8 GFLOP, 0.011 ms at 989
// TFLOP/s); per pair of 64 x 64 tiles a block also takes 4096 exponentials
// and the f32 work of P and dS, as long as the tiles' products at the tensor
// cores' peak. The bf16 design is two launches, each a warpgroup (wgmma's M
// of 64) per 64-row tile, wgmma products and a TMA ring of kStages streamed
// tile pairs (hopper.cuh):
//   1. dq:   per (64-query tile, head, batch): D = rowsum(dO O) for its rows
//            (written for launch 2), then over the key tiles S = Q K^T,
//            dP = dO V^T (both wgmma from shared memory), P, dS, and
//            dQ += dS K (dS from registers, K MN-major); K and V by TMA.
//   2. dkdv: per (64-key tile, head, batch): over the query tiles of BQ rows
//            S^T = K Q^T, dP^T = V dO^T, P^T, dS^T, dV += P^T dO and
//            dK += dS^T Q (the register operands from the accumulators, Q and
//            dO MN-major); Q and dO by TMA, each tile's lse and D read a tile
//            ahead and staged in shared memory.
// dQ takes its own pass, (a): it recomputes S and dP, 7 products where the
// function needs 5, and the backward stays deterministic. Folding dQ into
// launch 2, (b), takes f32 atomics into a [B, N, H*hd] scratch, a pass to
// zero it and one to convert it: the dQ pass costs 40 us of K3's 89 and 62
// of K4's 148 on one H100 (chip_smoke.py's device time, PERF.md section 6),
// while the SDPA backward that PyTorch runs spends 23 us of its 91 and 27
// of its 127 on its fill, D and conversion passes alone, before its main
// kernel. (b) is not built. Every
// ragged edge is cut as in attention.cu: the last key (launch 1) or query
// (launch 2) tile is as narrow as its rows (rounded up to 8), the tiles with
// a ragged tail run after every full tile, and warps without a live row skip
// the exponentials. f32 inputs take a CUDA-core path (4 threads per row)
// that keeps full f32 precision: the card's f32 reference in the checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 128;  // 4 warps: one warpgroup
constexpr int kTile = 64;      // rows of a bf16 block: wgmma's M
constexpr int kStages = 2;     // streamed tiles in flight
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// f32 D = rowsum(dO O), [B, H, N] (the bf16 dQ kernel computes its own rows')
// ---------------------------------------------------------------------------

// One thread per (batch, row, head) = r; its hd values of o and g start at
// r * hd (the [B, N, H, hd] layout).
template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_bwd_delta_f32(const float4* __restrict__ o,
                        const float4* __restrict__ g,
                        float* __restrict__ delta, int rows, int n, int h) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  const float4* orow = o + (size_t)r * (HD / 4);
  const float4* grow = g + (size_t)r * (HD / 4);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) {
    const float4 a = orow[i], b = grow[i];
    s += fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
  }
  const int head = r % h;
  const int row = (r / h) % n;
  const int b = r / (h * n);
  delta[((size_t)b * h + head) * n + row] = s;
}

// ---------------------------------------------------------------------------
// bf16: wgmma, TMA ring
// ---------------------------------------------------------------------------

// Query rows per step of the dK/dV walk: the register budget of dK, dV, S^T
// and dP^T (kernels/attention.py::plan mirrors it).
template <int HD>
__host__ __device__ constexpr int dkdv_rows() {
  return HD <= 64 ? 64 : 32;
}
// Shared memory of each bf16 kernel: the resident pair of 64-row tiles,
// kStages pairs of streamed tiles, (dkdv) lse and D for two steps, the
// barriers, and 1024 bytes to align the tiles.
template <int HD>
constexpr int dq_smem_bytes() {
  return 1024 + (2 + 2 * kStages) * kTile * HD * 2 + 8 * (1 + kStages);
}
template <int HD>
constexpr int dkdv_smem_bytes() {
  return 1024 + 2 * kTile * HD * 2 + 2 * kStages * dkdv_rows<HD>() * HD * 2 +
         2 * 2 * dkdv_rows<HD>() * 4 + 8 * (1 + kStages);
}

// Block x -> (tile, head, batch): the tiles with 64 live rows of every
// (head, batch), tile fastest, then the ragged tail tile of every one.
__device__ __forceinline__ void tile_of_block(int n, int h, int nb, int& tile,
                                              int& head, int& b) {
  const int full = n / kTile;
  int bh;
  if ((int)blockIdx.x < full * h * nb) {
    tile = blockIdx.x % full;
    bh = blockIdx.x / full;
  } else {
    tile = full;
    bh = blockIdx.x - full * h * nb;
  }
  head = bh % h;
  b = bh / h;
}

// One key tile of NK keys for the dQ walk (k0 its first; LAST: the last
// tile, NK = N - k0 rounded up to 8, whose keys past N get P = 0): S = Q K^T
// and dP = dO V^T, P = exp(S scale - lse), dS = P (dP - D), dQ += dS K.
template <int HD, int NK, bool LAST>
__device__ __forceinline__ void dq_tile(float* dq, uint32_t qs, uint32_t gs,
                                        uint32_t ks, uint32_t vs, int k0,
                                        int n, bool live, const float lse2[2],
                                        const float del[2], float scale_log2) {
  using T = Tiles<HD>;
  const int t = threadIdx.x & 3;
  float p[NK / 2], ds[NK / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss<NK>(p, T::kmajor(qs, kTile, kk), T::kmajor(ks, kTile, kk), kk);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss<NK>(ds, T::kmajor(gs, kTile, kk), T::kmajor(vs, kTile, kk), kk);
  wgmma_commit();
  wgmma_wait();
  fence_regs<NK / 2>(p);
  fence_regs<NK / 2>(ds);
  if (live) {
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        float pe = ex2(fmaf(p[4 * j + e], scale_log2, -lse2[e >> 1]));
        if (LAST && key >= n) pe = 0.f;
        ds[4 * j + e] = pe * (ds[4 * j + e] - del[e >> 1]);
      }
  } else {
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) ds[i] = 0.f;
  }
  // dQ += dS K (dS rounded to bf16 as the operand)
  constexpr int kSteps = (NK + 15) / 16;
  uint32_t a[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) acc_to_a<NK>(ds, kk, a[kk]);
  fence_regs<kSteps>(a);
  fence_regs<HD / 2>(dq);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
    for (int c = 0; c < T::kChunks; ++c)
      wgmma_rs<T::kCols>(dq + c * T::kCols / 2, a[kk],
                         T::mnmajor(ks, kTile, kk, c), 1);
  wgmma_commit();
  wgmma_wait();
  fence_regs<HD / 2>(dq);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_bf16(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tg,
                      const __nv_bfloat16* __restrict__ o,
                      const __nv_bfloat16* __restrict__ go,
                      const float* __restrict__ lse, float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dq, int n, int h, int nb,
                      float scale, float scale_log2) {
  using T = Tiles<HD>;
  constexpr int kBytes = kTile * HD * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + (2 + 2 * kStages) * kBytes);
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;

  int tile, head, b;
  tile_of_block(n, h, nb, tile, head, b);
  const int q0 = tile * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows r0 and r0 + 8
  const bool live = q0 + warp * 16 < n;
  const int kfull = n / kTile;
  const int ntiles = kfull + (n % kTile ? 1 : 0);
  const int tail = ((n % kTile) + 7) / 8 * 8;

  auto stage = [&](int j) { return smem + (2 + 2 * (j % kStages)) * kBytes; };
  auto issue = [&](int j) {
    uint64_t* bar = full + j % kStages;
    mbar_expect(bar, 2 * kBytes);
    T::load(stage(j), kTile, &tk, bar, head, j * kTile, b);
    T::load(stage(j) + kBytes, kTile, &tv, bar, head, j * kTile, b);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(bars + i, 1);
    mbar_fence_init();
    mbar_expect(qbar, 2 * kBytes);
    T::load(smem, kTile, &tq, qbar, head, q0, b);
    T::load(smem + kBytes, kTile, &tg, qbar, head, q0, b);
    for (int j = 0; j < min(kStages, ntiles); ++j) issue(j);
  }
  __syncthreads();

  // D = rowsum(dO O) for rows r0, r0 + 8 (the quad splits each row's HD/2
  // column pairs), written for the dK/dV launch; lse in log2 units. Rows
  // past n: Q and dO are zero there, and with lse = D = 0 so is dS.
  const int d = h * HD;
  const size_t base = (size_t)b * n * d + (size_t)head * HD;
  const size_t stat = ((size_t)b * h + head) * n;
  float lse2[2], del[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    float acc = 0.f;
    if (row < n) {
      const __nv_bfloat162* orow =
          reinterpret_cast<const __nv_bfloat162*>(o + base + (size_t)row * d);
      const __nv_bfloat162* grow =
          reinterpret_cast<const __nv_bfloat162*>(go + base + (size_t)row * d);
#pragma unroll
      for (int c = t; c < HD / 2; c += 4) {
        const float2 x = __bfloat1622float2(orow[c]);
        const float2 y = __bfloat1622float2(grow[c]);
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    del[i] = acc;
    lse2[i] = row < n ? lse[stat + row] * kLog2e : 0.f;
    if (row < n && t == 0) delta[stat + row] = acc;
  }

  float dqa[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dqa[i] = 0.f;
  mbar_wait(qbar, 0);
  const uint32_t qs = smem_u32(smem);
  const uint32_t gs = qs + kBytes;
  for (int j = 0; j < ntiles; ++j) {
    mbar_wait(full + j % kStages, (j / kStages) & 1);
    const uint32_t ks = smem_u32(stage(j));
    const uint32_t vs = ks + kBytes;
    const int k0 = j * kTile;
    if (j < kfull) {
      dq_tile<HD, 64, false>(dqa, qs, gs, ks, vs, k0, n, live, lse2, del,
                             scale_log2);
    } else {
      switch (tail) {
#define MISSM_TAIL(NK)                                                 \
  case NK:                                                             \
    dq_tile<HD, NK, true>(dqa, qs, gs, ks, vs, k0, n, live, lse2, del, \
                          scale_log2);                                 \
    break;
        MISSM_TAIL(8) MISSM_TAIL(16) MISSM_TAIL(24) MISSM_TAIL(32)
        MISSM_TAIL(40) MISSM_TAIL(48) MISSM_TAIL(56) MISSM_TAIL(64)
#undef MISSM_TAIL
      }
    }
    __syncthreads();  // every warp is done with stage j
    if (threadIdx.x == 0 && j + kStages < ntiles) issue(j + kStages);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= n) continue;
    __nv_bfloat16* drow = dq + base + (size_t)row * d;
#pragma unroll
    for (int c = 0; c < T::kChunks; ++c)
#pragma unroll
      for (int j = 0; j < T::kCols / 8; ++j) {
        const float* x = dqa + c * T::kCols / 2 + 4 * j + 2 * i;
        *reinterpret_cast<uint32_t*>(drow + c * T::kCols + 8 * j + 2 * t) =
            pack_bf16(x[0] * scale, x[1] * scale);
      }
  }
}

// One query tile of NQ queries for the dK/dV walk (Q and dO tiles of BQ
// rows): S^T = K Q^T and dP^T = V dO^T, P^T = exp(S^T scale - lse[query]),
// dS^T = P^T (dP^T - D[query]), dV += P^T dO, dK += dS^T Q; lse2s and dels
// hold the tile's log2-unit lse (+inf past n, so that P = 0 there) and D.
template <int HD, int BQ, int NQ>
__device__ __forceinline__ void dkdv_tile(float* dk, float* dv, uint32_t ks,
                                          uint32_t vs, uint32_t qs, uint32_t gs,
                                          const float* lse2s, const float* dels,
                                          bool live, float scale_log2) {
  using T = Tiles<HD>;
  const int t = threadIdx.x & 3;
  float p[NQ / 2], ds[NQ / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss<NQ>(p, T::kmajor(ks, kTile, kk), T::kmajor(qs, BQ, kk), kk);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss<NQ>(ds, T::kmajor(vs, kTile, kk), T::kmajor(gs, BQ, kk), kk);
  wgmma_commit();
  wgmma_wait();
  fence_regs<NQ / 2>(p);
  fence_regs<NQ / 2>(ds);
  if (live) {
#pragma unroll
    for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        p[4 * j + e] = ex2(fmaf(p[4 * j + e], scale_log2, -lse2s[col]));
        ds[4 * j + e] = p[4 * j + e] * (ds[4 * j + e] - dels[col]);
      }
  } else {
#pragma unroll
    for (int i = 0; i < NQ / 2; ++i) p[i] = ds[i] = 0.f;
  }
  // dV += P^T dO, dK += dS^T Q (each rounded to bf16 as the operand)
  constexpr int kSteps = (NQ + 15) / 16;
  uint32_t a[kSteps][4], c4[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    acc_to_a<NQ>(p, kk, a[kk]);
    acc_to_a<NQ>(ds, kk, c4[kk]);
  }
  fence_regs<kSteps>(a);
  fence_regs<kSteps>(c4);
  fence_regs<HD / 2>(dv);
  fence_regs<HD / 2>(dk);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
    for (int c = 0; c < T::kChunks; ++c) {
      wgmma_rs<T::kCols>(dv + c * T::kCols / 2, a[kk],
                         T::mnmajor(gs, BQ, kk, c), 1);
      wgmma_rs<T::kCols>(dk + c * T::kCols / 2, c4[kk],
                         T::mnmajor(qs, BQ, kk, c), 1);
    }
  wgmma_commit();
  wgmma_wait();
  fence_regs<HD / 2>(dv);
  fence_regs<HD / 2>(dk);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_bf16(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tg,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int n, int h, int nb,
                        float scale, float scale_log2) {
  using T = Tiles<HD>;
  constexpr int BQ = dkdv_rows<HD>();
  constexpr int kBytes = kTile * HD * 2;  // a resident K or V tile
  constexpr int kQBytes = BQ * HD * 2;    // a streamed Q or dO tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  float* stats =
      reinterpret_cast<float*>(smem + 2 * kBytes + 2 * kStages * kQBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(stats + 2 * 2 * BQ);
  uint64_t* kbar = bars;
  uint64_t* full = bars + 1;

  int tile, head, b;
  tile_of_block(n, h, nb, tile, head, b);
  const int k0 = tile * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int r0 = k0 + warp * 16 + (lane >> 2);  // this thread's keys r0, r0 + 8
  const bool live = k0 + warp * 16 < n;
  const int qfull = n / BQ;
  const int ntiles = qfull + (n % BQ ? 1 : 0);
  const int tail = ((n % BQ) + 7) / 8 * 8;
  const size_t stat = ((size_t)b * h + head) * n;

  auto stage = [&](int j) {
    return smem + 2 * kBytes + 2 * (j % kStages) * kQBytes;
  };
  auto issue = [&](int j) {
    uint64_t* bar = full + j % kStages;
    mbar_expect(bar, 2 * kQBytes);
    T::load(stage(j), BQ, &tq, bar, head, j * BQ, b);
    T::load(stage(j) + kQBytes, BQ, &tg, bar, head, j * BQ, b);
  };
  // lse (log2 units; +inf past n) and D of query tile j, read by threads
  // below BQ: fetched a tile ahead, stored into stats buffer j & 1 before
  // the barrier that precedes tile j
  float lse_next = INFINITY, del_next = 0.f;
  auto fetch_stats = [&](int j) {
    const int q = j * BQ + threadIdx.x;
    lse_next = INFINITY;
    del_next = 0.f;
    if (threadIdx.x < BQ && j < ntiles && q < n) {
      lse_next = lse[stat + q] * kLog2e;
      del_next = delta[stat + q];
    }
  };
  auto stage_stats = [&](int j) {
    if (threadIdx.x < BQ) {
      float* buf = stats + (j & 1) * 2 * BQ;
      buf[threadIdx.x] = lse_next;
      buf[BQ + threadIdx.x] = del_next;
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(bars + i, 1);
    mbar_fence_init();
    mbar_expect(kbar, 2 * kBytes);
    T::load(smem, kTile, &tk, kbar, head, k0, b);
    T::load(smem + kBytes, kTile, &tv, kbar, head, k0, b);
    for (int j = 0; j < min(kStages, ntiles); ++j) issue(j);
  }
  fetch_stats(0);
  stage_stats(0);
  __syncthreads();

  float dka[HD / 2], dva[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;
  mbar_wait(kbar, 0);
  const uint32_t ks = smem_u32(smem);
  const uint32_t vs = ks + kBytes;
  for (int j = 0; j < ntiles; ++j) {
    mbar_wait(full + j % kStages, (j / kStages) & 1);
    const uint32_t qs = smem_u32(stage(j));
    const uint32_t gs = qs + kQBytes;
    const float* buf = stats + (j & 1) * 2 * BQ;
    fetch_stats(j + 1);  // lands while tile j is computed
    if (j < qfull) {
      dkdv_tile<HD, BQ, BQ>(dka, dva, ks, vs, qs, gs, buf, buf + BQ, live,
                            scale_log2);
    } else {
      switch (tail) {
#define MISSM_TAIL(NQ)                                                      \
  case NQ:                                                                  \
    if (NQ <= BQ)                                                           \
      dkdv_tile<HD, BQ, (NQ <= BQ ? NQ : 8)>(dka, dva, ks, vs, qs, gs, buf, \
                                             buf + BQ, live, scale_log2);   \
    break;
        MISSM_TAIL(8) MISSM_TAIL(16) MISSM_TAIL(24) MISSM_TAIL(32)
        MISSM_TAIL(40) MISSM_TAIL(48) MISSM_TAIL(56) MISSM_TAIL(64)
#undef MISSM_TAIL
      }
    }
    stage_stats(j + 1);
    __syncthreads();  // every warp is done with stage j and stats j & 1
    if (threadIdx.x == 0 && j + kStages < ntiles) issue(j + kStages);
  }

  const int d = h * HD;
  const size_t base = (size_t)b * n * d + (size_t)head * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < T::kChunks; ++c)
#pragma unroll
      for (int j = 0; j < T::kCols / 8; ++j) {
        const int idx = c * T::kCols / 2 + 4 * j + 2 * i;
        const size_t off = base + (size_t)row * d + c * T::kCols + 8 * j + 2 * t;
        *reinterpret_cast<uint32_t*>(dk + off) =
            pack_bf16(dka[idx] * scale, dka[idx + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + off) =
            pack_bf16(dva[idx], dva[idx + 1]);
      }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, 4 threads per row, full f32 products
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 32;  // rows per block (128 threads)
constexpr int kF32Cols = 32;  // rows of the other side per tile

// Rows [row0, row0 + kF32Cols) of one head's slice of x and y into shared
// memory (pitch HD); rows past n are zero.
template <int HD>
__device__ __forceinline__ void load_pair_f32(float* xs, float* ys,
                                              const float* x, const float* y,
                                              int row0, int n, int d) {
  for (int c = threadIdx.x; c < kF32Cols * HD / 4; c += kThreads) {
    const int r = c / (HD / 4);
    const int col = (c % (HD / 4)) * 4;
    float4 xv = make_float4(0.f, 0.f, 0.f, 0.f), yv = xv;
    if (row0 + r < n) {
      const size_t off = (size_t)(row0 + r) * d + col;
      xv = *reinterpret_cast<const float4*>(x + off);
      yv = *reinterpret_cast<const float4*>(y + off);
    }
    *reinterpret_cast<float4*>(xs + r * HD + col) = xv;
    *reinterpret_cast<float4*>(ys + r * HD + col) = yv;
  }
}

// The four partial dots of a row; every lane of the quad ends with the same
// bits (the pairwise adds commute).
__device__ __forceinline__ float quad_sum(float s) {
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  return s;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ go,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, float* __restrict__ dk,
                       float* __restrict__ dv, int n, int h, float scale) {
  constexpr int R = HD / 4;  // dims per thread: part, part + 4, part + 8, ...
  __shared__ __align__(16) float qs[kF32Cols * HD];
  __shared__ __align__(16) float gs[kF32Cols * HD];
  __shared__ float lses[kF32Cols];
  __shared__ float dels[kF32Cols];

  const int d = h * HD;
  const size_t base = (size_t)blockIdx.z * n * d + (size_t)blockIdx.y * HD;
  const size_t stat = ((size_t)blockIdx.z * h + blockIdx.y) * n;
  const int part = threadIdx.x & 3;
  const int ki = blockIdx.x * kF32Rows + (threadIdx.x >> 2);

  float kr[R], vr[R], dka[R], dva[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const size_t off = base + (size_t)ki * d + part + 4 * i;
    kr[i] = ki < n ? k[off] : 0.f;
    vr[i] = ki < n ? v[off] : 0.f;
    dka[i] = dva[i] = 0.f;
  }

  for (int q0 = 0; q0 < n; q0 += kF32Cols) {
    __syncthreads();
    load_pair_f32<HD>(qs, gs, q + base, go + base, q0, n, d);
    if (threadIdx.x < kF32Cols) {
      const int qi = q0 + threadIdx.x;
      lses[threadIdx.x] = qi < n ? lse[stat + qi] : 0.f;
      dels[threadIdx.x] = qi < n ? delta[stat + qi] : 0.f;
    }
    __syncthreads();

    const int qn = min(kF32Cols, n - q0);  // only queries that exist
    for (int j = 0; j < qn; ++j) {
      const float* qj = qs + j * HD + part;
      const float* gj = gs + j * HD + part;
      float sp = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        sp = fmaf(kr[i], qj[4 * i], sp);
        dp = fmaf(vr[i], gj[4 * i], dp);
      }
      sp = quad_sum(sp);
      dp = quad_sum(dp);
      const float p = ki < n ? expf(sp * scale - lses[j]) : 0.f;
      const float ds = p * (dp - dels[j]);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        dva[i] = fmaf(p, gj[4 * i], dva[i]);
        dka[i] = fmaf(ds, qj[4 * i], dka[i]);
      }
    }
  }
  if (ki < n) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const size_t off = base + (size_t)ki * d + part + 4 * i;
      dk[off] = dka[i] * scale;
      dv[off] = dva[i];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ go,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     int n, int h, float scale) {
  constexpr int R = HD / 4;
  __shared__ __align__(16) float ks[kF32Cols * HD];
  __shared__ __align__(16) float vs[kF32Cols * HD];

  const int d = h * HD;
  const size_t base = (size_t)blockIdx.z * n * d + (size_t)blockIdx.y * HD;
  const size_t stat = ((size_t)blockIdx.z * h + blockIdx.y) * n;
  const int part = threadIdx.x & 3;
  const int qi = blockIdx.x * kF32Rows + (threadIdx.x >> 2);

  float qr[R], gr[R], dqa[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const size_t off = base + (size_t)qi * d + part + 4 * i;
    qr[i] = qi < n ? q[off] : 0.f;
    gr[i] = qi < n ? go[off] : 0.f;
    dqa[i] = 0.f;
  }
  const float lse_i = qi < n ? lse[stat + qi] : 0.f;
  const float del_i = qi < n ? delta[stat + qi] : 0.f;

  for (int k0 = 0; k0 < n; k0 += kF32Cols) {
    __syncthreads();
    load_pair_f32<HD>(ks, vs, k + base, v + base, k0, n, d);
    __syncthreads();

    const int kn = min(kF32Cols, n - k0);  // only keys that exist
    for (int j = 0; j < kn; ++j) {
      const float* kj = ks + j * HD + part;
      const float* vj = vs + j * HD + part;
      float sp = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        sp = fmaf(qr[i], kj[4 * i], sp);
        dp = fmaf(gr[i], vj[4 * i], dp);
      }
      sp = quad_sum(sp);
      dp = quad_sum(dp);
      const float p = expf(sp * scale - lse_i);
      const float ds = p * (dp - del_i);
#pragma unroll
      for (int i = 0; i < R; ++i) dqa[i] = fmaf(ds, kj[4 * i], dqa[i]);
    }
  }
  if (qi < n) {
#pragma unroll
    for (int i = 0; i < R; ++i)
      dq[base + (size_t)qi * d + part + 4 * i] = dqa[i] * scale;
  }
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const void* g, const float* lse, float* delta, void* dq,
                void* dk, void* dv, int b, int n, int h, float scale,
                cudaStream_t stream) {
  using Tb = __nv_bfloat16;
  constexpr int kCols = Tiles<HD>::kCols;
  constexpr int BQ = dkdv_rows<HD>();
  const int d = h * HD;
  CUtensorMap tq, tk, tv, tg, tq2, tg2;
  int rc = encode_rows(&tq, q, b, n, d, kTile, kCols);
  if (!rc) rc = encode_rows(&tk, k, b, n, d, kTile, kCols);
  if (!rc) rc = encode_rows(&tv, v, b, n, d, kTile, kCols);
  if (!rc) rc = encode_rows(&tg, g, b, n, d, kTile, kCols);
  if (!rc) rc = encode_rows(&tq2, q, b, n, d, BQ, kCols);
  if (!rc) rc = encode_rows(&tg2, g, b, n, d, BQ, kCols);
  auto dq_kernel = attention_bwd_dq_bf16<HD>;
  auto dkdv_kernel = attention_bwd_dkdv_bf16<HD>;
  static unsigned long long dq_attr = 0, dkdv_attr = 0;
  if (!rc) rc = allow_smem(dq_kernel, dq_smem_bytes<HD>(), dq_attr);
  if (!rc) rc = allow_smem(dkdv_kernel, dkdv_smem_bytes<HD>(), dkdv_attr);
  if (rc) return rc;
  const int blocks = b * h * ((n + kTile - 1) / kTile);
  const float scale_log2 = scale * kLog2e;
  dq_kernel<<<blocks, kThreads, dq_smem_bytes<HD>(), stream>>>(
      tq, tk, tv, tg, static_cast<const Tb*>(o), static_cast<const Tb*>(g),
      lse, delta, static_cast<Tb*>(dq), n, h, b, scale, scale_log2);
  rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  dkdv_kernel<<<blocks, kThreads, dkdv_smem_bytes<HD>(), stream>>>(
      tq2, tk, tv, tg2, lse, delta, static_cast<Tb*>(dk), static_cast<Tb*>(dv),
      n, h, b, scale, scale_log2);
  return 0;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* g, const float* lse, float* delta, void* dq, void* dk,
           void* dv, int b, int n, int h, int is_bf16, float scale,
           cudaStream_t stream) {
  if (is_bf16)
    return launch_bf16<HD>(q, k, v, o, g, lse, delta, dq, dk, dv, b, n, h,
                           scale, stream);
  const int rows = b * n * h;
  const dim3 delta_grid((rows + kThreads - 1) / kThreads);
  attention_bwd_delta_f32<HD><<<delta_grid, kThreads, 0, stream>>>(
      static_cast<const float4*>(o), static_cast<const float4*>(g), delta,
      rows, n, h);
  const dim3 grid((n + kF32Rows - 1) / kF32Rows, h, b);
  attention_bwd_dkdv_f32<HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(g), lse, delta,
      static_cast<float*>(dk), static_cast<float*>(dv), n, h, scale);
  attention_bwd_dq_f32<HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(g), lse, delta,
      static_cast<float*>(dq), n, h, scale);
  return 0;
}

}  // namespace

// q, k, v, o (the forward's output), g (dO), dq, dk, dv: [b, n, h *
// head_dim] contiguous, 16-byte aligned, all bf16 (is_bf16 = 1) or all f32.
// lse: [b, h, n] f32 from the forward; delta: [b, h, n] f32 scratch.
// head_dim: a multiple of 16 up to 128. Launches two kernels (bf16) or three
// (f32) on `stream` and returns the first error: of the tensor maps, the
// shared-memory attributes or the first launch (bf16), else
// cudaGetLastError() (cudaErrorInvalidValue for a head_dim it was not built
// for).
extern "C" int missm_attention_backward(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* g, const void* lse,
                                        void* delta, void* dq, void* dk,
                                        void* dv, int b, int n, int h,
                                        int head_dim, int is_bf16, float scale,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  int rc;
  switch (head_dim) {
#define MISSM_HD(HD)                                                      \
  case HD:                                                                \
    rc = launch<HD>(q, k, v, o, g, l, dl, dq, dk, dv, b, n, h, is_bf16,   \
                    scale, s);                                            \
    break;
    MISSM_HD(16) MISSM_HD(32) MISSM_HD(48) MISSM_HD(64)
    MISSM_HD(80) MISSM_HD(96) MISSM_HD(112) MISSM_HD(128)
#undef MISSM_HD
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return rc ? rc : static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of the bf16 dQ (which = 0) or dK/dV (which = 1)
// kernel at head_dim (0 for a head_dim it was not built for): what
// kernels/attention.py::plan says.
extern "C" int missm_attention_backward_smem(int head_dim, int which) {
  switch (head_dim) {
#define MISSM_HD(HD) \
  case HD:           \
    return which ? dkdv_smem_bytes<HD>() : dq_smem_bytes<HD>();
    MISSM_HD(16) MISSM_HD(32) MISSM_HD(48) MISSM_HD(64)
    MISSM_HD(80) MISSM_HD(96) MISSM_HD(112) MISSM_HD(128)
#undef MISSM_HD
    default:
      return 0;
  }
}
