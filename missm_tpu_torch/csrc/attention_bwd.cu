// Softmax self-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel fused_attention_cls_bwd
// (_attn_bwd_kernel_packed_cls, missm_tpu/kernels/flash_attention.py): the
// gradient of the bias-free attention of the ViT towers (K1's forward in
// attention.cu), q [B, 257, 16*64]. The TPU kernel takes K/V split into a CLS
// row and 256 main keys, and packs head pairs, only to fill its 128-wide
// lanes; here K/V come whole and each block works on one head.
//
// Math, with P = softmax(q k^T * scale) per (batch, head), scale = hd^-0.5:
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - D),  D = rowsum(dP P),
//   dQ = dS K * scale,  dK = dS^T Q * scale.
// D is computed as rowsum(dO O) from the forward's output O, the same sum
// up to O's rounding to the input type (exact in f32). P is recomputed in f32
// as exp(s * scale - lse) from the per-row log-sum-exp that the forward
// wrote. Rounding points are the TPU kernel's: P is rounded to the input
// type only as the operand of dV, dS is computed in f32 and rounded to the
// input type before the dQ and dK products, all products accumulate in f32,
// the scale is applied to the f32 accumulator and each output is cast once.
//
// Layout: q, k, v, o, dO, dq, dk, dv are [B, N, H*hd] (no head transposes);
// lse and D are f32 [B, H, N].
//
// What bounds it on this card: at the main path's shape (B=16, N=257, H=16,
// hd=64) the function moves ~68 MB (q, k, v, o, dO read, dq, dk, dv written)
// for ~10.8 GFLOP of useful products, ~160 FLOP/byte, below the H100's ~295
// bf16 FLOP/byte: memory-bound. The design keeps the [N, N] scores on chip
// and is deterministic (no atomics), at the price of recomputing S and dP:
//   1. delta:  D = rowsum(dO O), one thread per (batch, row, head).
//   2. dkdv:   one block per (64-key tile, head, batch) walks the query
//              tiles: S^T, P^T, dV += P^T dO, dP^T, dS^T, dK += dS^T Q.
//   3. dq:     one block per (64-query tile, head, batch) walks the key
//              tiles: S, P, dP, dS, dQ += dS K.
// bf16 products run on the tensor cores through mma.sync m16n8k16 with f32
// accumulators. Every product's operands come from row-major tiles: an A
// operand from registers (fragments of K/V or Q/dO rows, or the f32
// accumulators of S^T/dS^T repacked), a B operand either read as row pairs
// (B[d][row] = X[row][d]) or gathered as column pairs (B[row][d] =
// X[row][d]), so no transposed copy is ever made. f32 inputs take a
// CUDA-core path (4 threads per row) that keeps full f32 precision. No wgmma,
// TMA or cp.async pipelining yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kTile = 64;      // rows of a bf16 block: 4 warps x 16 rows

// ---------------------------------------------------------------------------
// helpers (as in attention.cu)
// ---------------------------------------------------------------------------

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

// Rows [row0, row0 + ROWS) of one head's [N, HD] slice (row pitch d) into
// shared memory with pitch LD; rows past n are zero.
template <int HD, int LD, int ROWS>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               int row0, int n, int d) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * d + col);
    *reinterpret_cast<uint4*>(dst + r * LD + col) = val;
  }
}

// A fragments (16 rows x HD, k-steps of 16) of rows [r, r + 16) of a
// shared-memory tile with pitch LD; lane (g, t) holds rows r + g, r + g + 8.
template <int HD, int LD>
__device__ __forceinline__ void load_a_frags(uint32_t f[HD / 16][4],
                                             const __nv_bfloat16* tile, int r,
                                             int g, int t) {
  const __nv_bfloat16* r0 = tile + (r + g) * LD + 2 * t;
  const __nv_bfloat16* r1 = r0 + 8 * LD;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    f[kk][0] = ld_pair(r0 + kk * 16);
    f[kk][1] = ld_pair(r1 + kk * 16);
    f[kk][2] = ld_pair(r0 + kk * 16 + 8);
    f[kk][3] = ld_pair(r1 + kk * 16 + 8);
  }
}

// acc[j] (16 x 8, 8-row tile j of a ROWS-row tile X) += A . X^T over HD:
// B[d][row] = X[row][d], read as row pairs.
template <int HD, int LD, int NT>
__device__ __forceinline__ void mma_rows(float acc[NT][4],
                                         const uint32_t a[HD / 16][4],
                                         const __nv_bfloat16* tile, int g,
                                         int t) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const __nv_bfloat16* xr = tile + (j * 8 + g) * LD + 2 * t;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      mma_bf16(acc[j], a[kk], ld_pair(xr + kk * 16), ld_pair(xr + kk * 16 + 8));
  }
}

// out[j] (16 x 8, columns 8j.. of HD) += W . X, W given as the f32
// accumulators w[2 * ROWS / 16][4] of a 16 x ROWS product (rounded to bf16
// here), X a ROWS x HD shared-memory tile: B[row][d] = X[row][d], gathered
// as column pairs.
template <int HD, int LD, int ROWS>
__device__ __forceinline__ void mma_cols(float out[HD / 8][4],
                                         const float w[ROWS / 8][4],
                                         const __nv_bfloat16* tile, int g,
                                         int t) {
#pragma unroll
  for (int kk = 0; kk < ROWS / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(w[2 * kk][0], w[2 * kk][1]);
    a[1] = pack_bf16(w[2 * kk][2], w[2 * kk][3]);
    a[2] = pack_bf16(w[2 * kk + 1][0], w[2 * kk + 1][1]);
    a[3] = pack_bf16(w[2 * kk + 1][2], w[2 * kk + 1][3]);
    const __nv_bfloat16* xr = tile + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const __nv_bfloat16* xc = xr + j * 8;
      const uint32_t b0 = join_bf16(xc[0], xc[LD]);
      const uint32_t b1 = join_bf16(xc[8 * LD], xc[9 * LD]);
      mma_bf16(out[j], a, b0, b1);
    }
  }
}

// ---------------------------------------------------------------------------
// 1. D = rowsum(dO O), f32 [B, H, N]
// ---------------------------------------------------------------------------

__device__ __forceinline__ float dot_chunk(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(x[i]);
    const float2 fy = __bfloat1622float2(y[i]);
    s = fmaf(fx.x, fy.x, s);
    s = fmaf(fx.y, fy.y, s);
  }
  return s;
}

__device__ __forceinline__ float dot_chunk(float4 a, float4 b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}

// One thread per (batch, row, head) = r; its hd values of o and g start at
// r * hd (the [B, N, H, hd] layout). VEC: uint4 (8 bf16) or float4.
template <int HD, typename VEC, int PER>
__global__ void __launch_bounds__(kThreads)
attention_bwd_delta(const VEC* __restrict__ o, const VEC* __restrict__ g,
                    float* __restrict__ delta, int rows, int n, int h) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  constexpr int kVecs = HD / PER;
  const VEC* orow = o + (size_t)r * kVecs;
  const VEC* grow = g + (size_t)r * kVecs;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) s += dot_chunk(orow[i], grow[i]);
  const int head = r % h;
  const int row = (r / h) % n;
  const int b = r / (h * n);
  delta[((size_t)b * h + head) * n + row] = s;
}

// ---------------------------------------------------------------------------
// 2./3. bf16: tensor cores
// ---------------------------------------------------------------------------

// dK, dV for one (64-key tile, head, batch). Each warp owns 16 keys and
// keeps their K and V rows as A fragments; BQ queries per step.
template <int HD, int BQ>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_bf16(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ go,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int n, int h,
                        float scale) {
  constexpr int LD = HD + 8;  // conflict-free fragment reads (attention.cu)
  constexpr int kSteps = HD / 16;
  constexpr int kQTiles = BQ / 8;  // 8-query tiles of S^T
  constexpr int kDTiles = HD / 8;  // 8-column tiles of dK, dV
  __shared__ __align__(16) __nv_bfloat16 xs[kTile * LD];  // K, then Q tiles
  __shared__ __align__(16) __nv_bfloat16 ys[kTile * LD];  // V, then dO tiles
  __shared__ float lses[BQ];
  __shared__ float dels[BQ];

  const int d = h * HD;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const size_t base = (size_t)b * n * d + (size_t)head * HD;
  const size_t stat = ((size_t)b * h + head) * n;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k0 = blockIdx.x * kTile;
  const int ki0 = k0 + warp * 16 + g;  // this thread's two key rows
  const int ki1 = ki0 + 8;

  load_tile_bf16<HD, LD, kTile>(xs, k + base, k0, n, d);
  load_tile_bf16<HD, LD, kTile>(ys, v + base, k0, n, d);
  __syncthreads();
  uint32_t kf[kSteps][4], vf[kSteps][4];
  load_a_frags<HD, LD>(kf, xs, warp * 16, g, t);
  load_a_frags<HD, LD>(vf, ys, warp * 16, g, t);

  float dka[kDTiles][4], dva[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int q0 = 0; q0 < n; q0 += BQ) {
    __syncthreads();  // everyone is done with the previous tile (or K/V)
    load_tile_bf16<HD, LD, BQ>(xs, q + base, q0, n, d);
    load_tile_bf16<HD, LD, BQ>(ys, go + base, q0, n, d);
    if (threadIdx.x < BQ) {
      const int qi = q0 + threadIdx.x;
      lses[threadIdx.x] = qi < n ? lse[stat + qi] : INFINITY;
      dels[threadIdx.x] = qi < n ? delta[stat + qi] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T, then P^T = exp(S^T scale - lse[query]) in f32; keys and
    // queries past n get P = 0 (zero-filled rows would give exp(-lse)).
    float p[kQTiles][4];
    mma_rows<HD, LD, kQTiles>(p, kf, xs, g, t);
#pragma unroll
    for (int j = 0; j < kQTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = j * 8 + 2 * t + (e & 1);
        const int key = e < 2 ? ki0 : ki1;
        const float pe = expf(p[j][e] * scale - lses[ql]);
        p[j][e] = (key < n && q0 + ql < n) ? pe : 0.f;
      }
    // dV += P^T dO (P^T rounded to bf16 as the operand)
    mma_cols<HD, LD, BQ>(dva, p, ys, g, t);
    // dP^T = V dO^T; dS^T = P^T (dP^T - D[query]) in f32
    float ds[kQTiles][4];
    mma_rows<HD, LD, kQTiles>(ds, vf, ys, g, t);
#pragma unroll
    for (int j = 0; j < kQTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[j][e] = p[j][e] * (ds[j][e] - dels[j * 8 + 2 * t + (e & 1)]);
    // dK += dS^T Q (dS^T rounded to bf16 as the operand)
    mma_cols<HD, LD, BQ>(dka, ds, xs, g, t);
  }

#pragma unroll
  for (int j = 0; j < kDTiles; ++j) {
    const int col = j * 8 + 2 * t;
    if (ki0 < n) {
      const size_t off = base + (size_t)ki0 * d + col;
      *reinterpret_cast<uint32_t*>(dk + off) =
          pack_bf16(dka[j][0] * scale, dka[j][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off) = pack_bf16(dva[j][0], dva[j][1]);
    }
    if (ki1 < n) {
      const size_t off = base + (size_t)ki1 * d + col;
      *reinterpret_cast<uint32_t*>(dk + off) =
          pack_bf16(dka[j][2] * scale, dka[j][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + off) = pack_bf16(dva[j][2], dva[j][3]);
    }
  }
}

// dQ for one (64-query tile, head, batch). Each warp owns 16 queries and
// keeps their Q and dO rows as A fragments; 64 keys per step.
template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ go,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dq, int n, int h,
                      float scale) {
  constexpr int LD = HD + 8;
  constexpr int kSteps = HD / 16;
  constexpr int kKTiles = kTile / 8;  // 8-key tiles of S
  constexpr int kDTiles = HD / 8;
  __shared__ __align__(16) __nv_bfloat16 xs[kTile * LD];  // Q, then K tiles
  __shared__ __align__(16) __nv_bfloat16 ys[kTile * LD];  // dO, then V tiles

  const int d = h * HD;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const size_t base = (size_t)b * n * d + (size_t)head * HD;
  const size_t stat = ((size_t)b * h + head) * n;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * kTile;
  const int qi0 = q0 + warp * 16 + g;  // this thread's two query rows
  const int qi1 = qi0 + 8;

  load_tile_bf16<HD, LD, kTile>(xs, q + base, q0, n, d);
  load_tile_bf16<HD, LD, kTile>(ys, go + base, q0, n, d);
  __syncthreads();
  uint32_t qf[kSteps][4], gf[kSteps][4];
  load_a_frags<HD, LD>(qf, xs, warp * 16, g, t);
  load_a_frags<HD, LD>(gf, ys, warp * 16, g, t);
  // rows past n: Q and dO are zero, so with lse = D = 0 their dS is 0
  const float lse0 = qi0 < n ? lse[stat + qi0] : 0.f;
  const float lse1 = qi1 < n ? lse[stat + qi1] : 0.f;
  const float del0 = qi0 < n ? delta[stat + qi0] : 0.f;
  const float del1 = qi1 < n ? delta[stat + qi1] : 0.f;

  float dqa[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j)
    dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();
    load_tile_bf16<HD, LD, kTile>(xs, k + base, k0, n, d);
    load_tile_bf16<HD, LD, kTile>(ys, v + base, k0, n, d);
    __syncthreads();

    // S = Q K^T, P = exp(S scale - lse) in f32, 0 for keys past n
    float p[kKTiles][4];
    mma_rows<HD, LD, kKTiles>(p, qf, xs, g, t);
#pragma unroll
    for (int j = 0; j < kKTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        const float pe = expf(p[j][e] * scale - (e < 2 ? lse0 : lse1));
        p[j][e] = key < n ? pe : 0.f;
      }
    // dP = dO V^T; dS = P (dP - D[query]) in f32
    float ds[kKTiles][4];
    mma_rows<HD, LD, kKTiles>(ds, gf, ys, g, t);
#pragma unroll
    for (int j = 0; j < kKTiles; ++j) {
      ds[j][0] = p[j][0] * (ds[j][0] - del0);
      ds[j][1] = p[j][1] * (ds[j][1] - del0);
      ds[j][2] = p[j][2] * (ds[j][2] - del1);
      ds[j][3] = p[j][3] * (ds[j][3] - del1);
    }
    // dQ += dS K (dS rounded to bf16 as the operand)
    mma_cols<HD, LD, kTile>(dqa, ds, xs, g, t);
  }

#pragma unroll
  for (int j = 0; j < kDTiles; ++j) {
    const int col = j * 8 + 2 * t;
    if (qi0 < n)
      *reinterpret_cast<uint32_t*>(dq + base + (size_t)qi0 * d + col) =
          pack_bf16(dqa[j][0] * scale, dqa[j][1] * scale);
    if (qi1 < n)
      *reinterpret_cast<uint32_t*>(dq + base + (size_t)qi1 * d + col) =
          pack_bf16(dqa[j][2] * scale, dqa[j][3] * scale);
  }
}

// ---------------------------------------------------------------------------
// 2./3. f32: CUDA cores, 4 threads per row, full f32 products
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
void launch(const void* q, const void* k, const void* v, const void* o,
            const void* g, const float* lse, float* delta, void* dq, void* dk,
            void* dv, int b, int n, int h, int is_bf16, float scale,
            cudaStream_t stream) {
  const int rows = b * n * h;
  const dim3 delta_grid((rows + kThreads - 1) / kThreads);
  if (is_bf16) {
    using T = __nv_bfloat16;
    attention_bwd_delta<HD, uint4, 8><<<delta_grid, kThreads, 0, stream>>>(
        static_cast<const uint4*>(o), static_cast<const uint4*>(g), delta,
        rows, n, h);
    constexpr int BQ = HD <= 64 ? 64 : 32;  // register budget of the dK/dV warp
    const dim3 grid((n + kTile - 1) / kTile, h, b);
    attention_bwd_dkdv_bf16<HD, BQ><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,
        static_cast<T*>(dk), static_cast<T*>(dv), n, h, scale);
    attention_bwd_dq_bf16<HD><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,
        static_cast<T*>(dq), n, h, scale);
  } else {
    attention_bwd_delta<HD, float4, 4><<<delta_grid, kThreads, 0, stream>>>(
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
  }
}

}  // namespace

// q, k, v, o (the forward's output), g (dO), dq, dk, dv: [b, n, h *
// head_dim] contiguous, 16-byte aligned, all bf16 (is_bf16 = 1) or all f32.
// lse: [b, h, n] f32 from the forward; delta: [b, h, n] f32 scratch.
// head_dim: a multiple of 16 up to 128. Launches three kernels on `stream`
// and returns cudaGetLastError() (cudaErrorInvalidValue for a head_dim it
// was not built for).
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
  switch (head_dim) {
#define MISSM_HD(HD)                                                        \
  case HD:                                                                  \
    launch<HD>(q, k, v, o, g, l, dl, dq, dk, dv, b, n, h, is_bf16, scale, s); \
    break;
    MISSM_HD(16) MISSM_HD(32) MISSM_HD(48) MISSM_HD(64)
    MISSM_HD(80) MISSM_HD(96) MISSM_HD(112) MISSM_HD(128)
#undef MISSM_HD
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
