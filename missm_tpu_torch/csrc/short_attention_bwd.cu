// Backward of softmax attention within tiny instances (T <= 32 tokens) for
// Hopper (sm_90a), plain C interface.
//
// Replaces K4 of missm_tpu/kernels/flash_attention.py in block-diagonal
// mode: fused_attention_bwd(q, k, v, g, H, block_diag=T)
// (_attn_bwd_kernel_packed with _block_diag_mask_f32), the gradient of the
// video tower's temporal attention (fused_attention_ad's _fa_bwd, reached
// through missm_tpu/ops/attention.py::short_attention). As in the forward
// (short_attention.cu), the TPU packs 128/T instances into one 128-token row
// and masks the scores outside each T-block to finfo(float32).min, which
// leaves exactly zero weight across instances; so the packed gradient is the
// per-instance gradient, and each [T, hd] instance is taken as it is.
//
// Math (as _attn_bwd_kernel_packed, which the TPU runs at head dim 64), per
// (instance, head), scale = hd^-0.5:
//   s = (q . k) * scale in f32;  P = exp(s - max) / sum, in f32;
//   dV = round(P)^T dO;  dP = dO V^T;  D = rowsum(dP * P) over the unrounded
//   P;  dS = round(P * (dP - D));  dQ = dS K * scale;  dK = dS^T Q * scale;
// every product accumulated in f32, each gradient rounded once to the input
// type. round() is the rounding to the input type (none for f32).
//
// Layout: q, k, v, dO and the gradients are [M, T, H*hd] (the projections'
// own layout, instance-major), contiguous.
//
// What bounds it on this card: bytes. At the video tower's train shape
// (M = 8*257 instances of T=8, H=16, hd=64, bf16) it reads q, k, v, dO and
// writes dq, dk, dv, 235.8 MB, for 1.3 GFLOP, about 6 FLOP per byte; the
// H100 needs ~295 before its tensor cores are the limit, and T*T*hd = 4 K
// multiply-adds per product and (instance, head) is no work for a tensor
// core tile. So the products run on the CUDA cores in f32, and the design
// reads each input once and writes each output once, with 16-byte accesses.
// One warp per (instance, head), no block barrier, no atomics:
//   1. stage the T x hd slices of q, k, v and dO in the warp's shared memory;
//   2. query rows, 4 lanes to a row (hd/4 dims each, interleaved so that a
//      quad reads neighbouring words), 8 rows per pass: the T scores and the
//      T entries of dP in registers, P, D and dS, then dQ's row, staged in a
//      fifth tile; round(P) and dS go to two [T, T] f32 arrays;
//   3. key rows, the lanes re-assigned the same way: dK and dV are sums over
//      the queries, taken in order from the two arrays, so the result is
//      deterministic. They go back through the k and v slots, which step 3
//      no longer reads;
//   4. dQ, dK and dV leave with 16-byte stores.
// Consecutive warps take consecutive heads of one instance, so a block reads
// and writes whole rows of the [M, T, H*hd] tensors.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanesPerRow = 4;                    // lanes sharing a row
constexpr int kRowsPerPass = 32 / kLanesPerRow;    // rows per warp pass
constexpr int kMaxT = 32;
constexpr int kMaxWarps = 8;                       // warps per block
constexpr int kSharedBudget = 96 * 1024;           // bytes per block, soft cap
constexpr int kTiles = 5;                          // q, k, v, dO, dQ

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to E and back: the value a product with an E operand sees.
template <typename E>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename E>
__device__ __forceinline__ E from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Shared-memory row pitch in elements: hd plus 16 bytes, which keeps every
// row 16-byte aligned and puts the 8 rows of a pass on distinct banks.
template <typename E, int HD>
__host__ __device__ constexpr int pitch() {
  return HD + 16 / static_cast<int>(sizeof(E));
}

// Bytes of one warp's shared memory: the five tiles, then round(P) and dS
// as [t, t] f32 each, rounded up to keep the next warp's tiles 16-byte
// aligned.
template <typename E, int HD>
__host__ __device__ int warp_bytes(int t) {
  const int tiles = kTiles * t * pitch<E, HD>() * static_cast<int>(sizeof(E));
  return tiles + (2 * t * t * 4 + 15) / 16 * 16;
}

template <typename E, int HD, int TMAX>
__global__ void __launch_bounds__(kMaxWarps * 32)
short_attention_bwd(const E* __restrict__ q, const E* __restrict__ k,
                    const E* __restrict__ v, const E* __restrict__ g,
                    E* __restrict__ dq, E* __restrict__ dk,
                    E* __restrict__ dv, int pairs, int t, int h,
                    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = pitch<E, HD>();
  constexpr int R = HD / kLanesPerRow;        // dims per lane
  constexpr int C = 16 / sizeof(E);           // elements per 16-byte chunk
  constexpr int kChunks = HD / C;             // chunks per row

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * (blockDim.x >> 5) + warp;
  if (pair >= pairs) return;  // the whole warp; no block barrier below
  const int m = pair / h;
  const int head = pair - m * h;
  const int d = h * HD;
  const size_t base = (size_t)m * t * d + (size_t)head * HD;

  E* qs = reinterpret_cast<E*>(smem + (size_t)warp * warp_bytes<E, HD>(t));
  E* ks = qs + t * LD;
  E* vs = ks + t * LD;
  E* gs = vs + t * LD;
  E* dqs = gs + t * LD;
  float* ps = reinterpret_cast<float*>(dqs + t * LD);  // round(P) [t, t]
  float* dss = ps + t * t;                             // dS [t, t]

  for (int c = lane; c < t * kChunks; c += 32) {
    const int r = c / kChunks;
    const int col = (c - r * kChunks) * C;
    const size_t off = base + (size_t)r * d + col;
    *reinterpret_cast<uint4*>(qs + r * LD + col) =
        *reinterpret_cast<const uint4*>(q + off);
    *reinterpret_cast<uint4*>(ks + r * LD + col) =
        *reinterpret_cast<const uint4*>(k + off);
    *reinterpret_cast<uint4*>(vs + r * LD + col) =
        *reinterpret_cast<const uint4*>(v + off);
    *reinterpret_cast<uint4*>(gs + r * LD + col) =
        *reinterpret_cast<const uint4*>(g + off);
  }
  __syncwarp();

  const int part = lane & (kLanesPerRow - 1);

  // query rows: P, D, dS and dQ
  for (int r0 = 0; r0 < t; r0 += kRowsPerPass) {
    const int r = r0 + lane / kLanesPerRow;
    const bool active = r < t;
    const int rr = active ? r : t - 1;  // idle lanes still join the shuffles
    float qr[R], gr[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      qr[i] = to_f32(qs[rr * LD + part + 4 * i]);
      gr[i] = to_f32(gs[rr * LD + part + 4 * i]);
    }

    float s[TMAX], dp[TMAX];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < TMAX; ++j) {
      if (j < t) {  // t is the same for the whole warp
        float sp = 0.f, gp = 0.f;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          sp = fmaf(qr[i], to_f32(ks[j * LD + part + 4 * i]), sp);
          gp = fmaf(gr[i], to_f32(vs[j * LD + part + 4 * i]), gp);
        }
        // the quad's four partial dots; every lane ends with the same bits
        sp += __shfl_xor_sync(0xffffffffu, sp, 1);
        sp += __shfl_xor_sync(0xffffffffu, sp, 2);
        gp += __shfl_xor_sync(0xffffffffu, gp, 1);
        gp += __shfl_xor_sync(0xffffffffu, gp, 2);
        s[j] = sp * scale;
        dp[j] = gp;
        mx = fmaxf(mx, s[j]);
      }
    }

    float l = 0.f;
#pragma unroll
    for (int j = 0; j < TMAX; ++j) {
      if (j < t) {
        s[j] = expf(s[j] - mx);
        l += s[j];
      }
    }
    float dsum = 0.f;  // D = rowsum(dP * P), P unrounded
#pragma unroll
    for (int j = 0; j < TMAX; ++j) {
      if (j < t) {
        s[j] = s[j] / l;
        dsum = fmaf(dp[j], s[j], dsum);
      }
    }

    float acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TMAX; ++j) {
      if (j < t) {
        const float ds = round_to<E>(s[j] * (dp[j] - dsum));
#pragma unroll
        for (int i = 0; i < R; ++i)
          acc[i] = fmaf(ds, to_f32(ks[j * LD + part + 4 * i]), acc[i]);
        if (active && (j & (kLanesPerRow - 1)) == part) {
          ps[r * t + j] = round_to<E>(s[j]);
          dss[r * t + j] = ds;
        }
      }
    }
    if (active) {
#pragma unroll
      for (int i = 0; i < R; ++i)
        dqs[r * LD + part + 4 * i] = from_f32<E>(acc[i] * scale);
    }
  }
  __syncwarp();  // P, dS and every read of k and v done

  // key rows: dK and dV, sums over the queries in order
  for (int j0 = 0; j0 < t; j0 += kRowsPerPass) {
    const int j = j0 + lane / kLanesPerRow;
    if (j < t) {  // no shuffles below
      float gk[R], gv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) gk[i] = gv[i] = 0.f;
      for (int r = 0; r < t; ++r) {
        const float p = ps[r * t + j];
        const float ds = dss[r * t + j];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          gv[i] = fmaf(p, to_f32(gs[r * LD + part + 4 * i]), gv[i]);
          gk[i] = fmaf(ds, to_f32(qs[r * LD + part + 4 * i]), gk[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        ks[j * LD + part + 4 * i] = from_f32<E>(gk[i] * scale);
        vs[j * LD + part + 4 * i] = from_f32<E>(gv[i]);
      }
    }
  }
  __syncwarp();

  for (int c = lane; c < t * kChunks; c += 32) {
    const int r = c / kChunks;
    const int col = (c - r * kChunks) * C;
    const size_t off = base + (size_t)r * d + col;
    *reinterpret_cast<uint4*>(dq + off) =
        *reinterpret_cast<const uint4*>(dqs + r * LD + col);
    *reinterpret_cast<uint4*>(dk + off) =
        *reinterpret_cast<const uint4*>(ks + r * LD + col);
    *reinterpret_cast<uint4*>(dv + off) =
        *reinterpret_cast<const uint4*>(vs + r * LD + col);
  }
}

template <typename E, int HD, int TMAX>
int launch(const void* q, const void* k, const void* v, const void* g,
           void* dq, void* dk, void* dv, int pairs, int t, int h, float scale,
           cudaStream_t stream) {
  const int per_warp = warp_bytes<E, HD>(t);
  int warps = kMaxWarps;
  while (warps > 1 && warps * per_warp > kSharedBudget) warps >>= 1;
  const int bytes = warps * per_warp;
  auto kernel = short_attention_bwd<E, HD, TMAX>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (pairs + warps - 1) / warps;
  kernel<<<blocks, warps * 32, bytes, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const E*>(g), static_cast<E*>(dq),
      static_cast<E*>(dk), static_cast<E*>(dv), pairs, t, h, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, int HD>
int launch_t(const void* q, const void* k, const void* v, const void* g,
             void* dq, void* dk, void* dv, int pairs, int t, int h,
             float scale, cudaStream_t stream) {
  // T <= 8: the video tower's 8 frames, with 8 score registers per lane
  if (t <= 8)
    return launch<E, HD, 8>(q, k, v, g, dq, dk, dv, pairs, t, h, scale,
                            stream);
  return launch<E, HD, kMaxT>(q, k, v, g, dq, dk, dv, pairs, t, h, scale,
                              stream);
}

}  // namespace

// q, k, v, g (the output's cotangent) and dq, dk, dv: [m, t, h * head_dim]
// contiguous, 16-byte aligned, bf16 (is_bf16 = 1) or f32; 1 <= t <= 32;
// head_dim a multiple of 16 up to 128. The gradient of attention within each
// of the m instances. Launches on `stream` and returns the CUDA error of the
// launch (cudaErrorInvalidValue for a t or head_dim it was not built for).
extern "C" int missm_short_attention_backward(
    const void* q, const void* k, const void* v, const void* g, void* dq,
    void* dk, void* dv, int m, int t, int h, int head_dim, int is_bf16,
    float scale, void* stream) {
  if (t < 1 || t > kMaxT || m < 0 || h < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long pairs = static_cast<long long>(m) * h;
  if (pairs == 0) return 0;
  if (pairs > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int p = static_cast<int>(pairs);
  switch (head_dim) {
#define MISSM_HD(HD)                                                        \
  case HD:                                                                  \
    return is_bf16 ? launch_t<__nv_bfloat16, HD>(q, k, v, g, dq, dk, dv, p, \
                                                 t, h, scale, s)            \
                   : launch_t<float, HD>(q, k, v, g, dq, dk, dv, p, t, h,   \
                                         scale, s);
    MISSM_HD(16) MISSM_HD(32) MISSM_HD(48) MISSM_HD(64)
    MISSM_HD(80) MISSM_HD(96) MISSM_HD(112) MISSM_HD(128)
#undef MISSM_HD
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
