// Softmax attention within tiny instances (T <= 32 tokens) for Hopper
// (sm_90a), plain C interface.
//
// Replaces K2 mode c of missm_tpu/kernels/flash_attention.py:
// fused_attention(..., block_diag=T) (_attn_kernel_packed with
// _block_diag_mask_f32), which the video tower's temporal attention reaches
// through missm_tpu/ops/attention.py::short_attention. The TPU kernel packs
// 128/T instances into one 128-token row and masks the scores outside each
// T-block to finfo(float32).min, because a T=8 instance alone would fill 8 of
// the matrix unit's 128 lanes. exp(finfo.min - max) is exactly 0 in f32, so
// the packed function is per-instance attention; here each instance is taken
// as it is, with no packing and no mask.
//
// Math (as the TPU's pair-packed kernel, which it runs at head dim 64):
// s = (q . k) * hd^-0.5 in f32; m = the row max; e = exp(s - m) in f32, the
// row sum taken over the unrounded e; e rounded to the input type only as the
// operand of P.V, which accumulates in f32; the result divided by the f32 row
// sum and rounded once to the input type.
//
// Layout: q, k, v and out are [M, T, H*hd] (the projections' own layout,
// instance-major), contiguous.
//
// What bounds it on this card: bytes. At the video tower's shape (M = 16*257
// instances of T=8, H=16, hd=64, bf16) it moves 269.5 MB for 1.1 GFLOP, about
// 4 FLOP per byte, where the H100 needs ~295 before its tensor cores are the
// limit. T*T*hd = 4 K multiply-adds per (instance, head) is no work for a
// tensor core tile, so the products run on the CUDA cores in f32. The design
// reads each input once and writes the output once, with 16-byte accesses:
// one warp per (instance, head) stages its T x hd slices of q, k and v in
// shared memory; 4 lanes share a query row (hd/4 dims each, interleaved so
// that the quad reads neighbouring words), 8 query rows per pass; the T
// scores of a row stay in registers; the output goes back through the q slot
// and leaves with 16-byte stores. Consecutive warps take consecutive heads of
// one instance, so a block reads whole rows of the [M, T, H*hd] tensors.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanesPerRow = 4;                    // lanes sharing a query row
constexpr int kRowsPerPass = 32 / kLanesPerRow;    // query rows per warp pass
constexpr int kMaxT = 32;
constexpr int kMaxWarps = 8;                       // warps per block
constexpr int kSharedBudget = 96 * 1024;           // bytes per block, soft cap

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to E and back: the operand P.V sees.
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
// row 16-byte aligned and puts the 8 query rows of a pass on distinct banks.
template <typename E, int HD>
__host__ __device__ constexpr int pitch() {
  return HD + 16 / static_cast<int>(sizeof(E));
}

template <typename E, int HD, int TMAX>
__global__ void __launch_bounds__(kMaxWarps * 32)
short_attention(const E* __restrict__ q, const E* __restrict__ k,
                const E* __restrict__ v, E* __restrict__ out, int pairs,
                int t, int h, float scale) {
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

  E* qs = reinterpret_cast<E*>(smem) + (size_t)warp * 3 * t * LD;
  E* ks = qs + t * LD;
  E* vs = ks + t * LD;

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
  }
  __syncwarp();

  const int part = lane & (kLanesPerRow - 1);
  for (int r0 = 0; r0 < t; r0 += kRowsPerPass) {
    const int r = r0 + lane / kLanesPerRow;
    const bool active = r < t;
    const int rr = active ? r : t - 1;  // idle lanes still join the shuffles
    float qr[R];
#pragma unroll
    for (int i = 0; i < R; ++i) qr[i] = to_f32(qs[rr * LD + part + 4 * i]);

    float s[TMAX];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < TMAX; ++j) {
      if (j < t) {  // t is the same for the whole warp
        float sp = 0.f;
#pragma unroll
        for (int i = 0; i < R; ++i)
          sp = fmaf(qr[i], to_f32(ks[j * LD + part + 4 * i]), sp);
        // the quad's four partial dots; every lane ends with the same bits
        sp += __shfl_xor_sync(0xffffffffu, sp, 1);
        sp += __shfl_xor_sync(0xffffffffu, sp, 2);
        s[j] = sp * scale;
        mx = fmaxf(mx, s[j]);
      }
    }

    float o[R];
#pragma unroll
    for (int i = 0; i < R; ++i) o[i] = 0.f;
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < TMAX; ++j) {
      if (j < t) {
        const float e = expf(s[j] - mx);
        l += e;
        const float p = round_to<E>(e);
#pragma unroll
        for (int i = 0; i < R; ++i)
          o[i] = fmaf(p, to_f32(vs[j * LD + part + 4 * i]), o[i]);
      }
    }
    __syncwarp();  // every lane has read its q row before any is overwritten
    if (active) {
#pragma unroll
      for (int i = 0; i < R; ++i)
        qs[r * LD + part + 4 * i] = from_f32<E>(o[i] / l);
    }
  }
  __syncwarp();

  for (int c = lane; c < t * kChunks; c += 32) {
    const int r = c / kChunks;
    const int col = (c - r * kChunks) * C;
    *reinterpret_cast<uint4*>(out + base + (size_t)r * d + col) =
        *reinterpret_cast<const uint4*>(qs + r * LD + col);
  }
}

template <typename E, int HD, int TMAX>
int launch(const void* q, const void* k, const void* v, void* out, int pairs,
           int t, int h, float scale, cudaStream_t stream) {
  const int per_warp = 3 * t * pitch<E, HD>() * static_cast<int>(sizeof(E));
  int warps = kMaxWarps;
  while (warps > 1 && warps * per_warp > kSharedBudget) warps >>= 1;
  const int bytes = warps * per_warp;
  auto kernel = short_attention<E, HD, TMAX>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (pairs + warps - 1) / warps;
  kernel<<<blocks, warps * 32, bytes, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<E*>(out), pairs, t, h, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, int HD>
int launch_t(const void* q, const void* k, const void* v, void* out,
             int pairs, int t, int h, float scale, cudaStream_t stream) {
  // T <= 8: the video tower's 8 frames, with 8 score registers per lane
  if (t <= 8) return launch<E, HD, 8>(q, k, v, out, pairs, t, h, scale, stream);
  return launch<E, HD, kMaxT>(q, k, v, out, pairs, t, h, scale, stream);
}

}  // namespace

// q, k, v, out: [m, t, h * head_dim] contiguous, 16-byte aligned, bf16
// (is_bf16 = 1) or f32; 1 <= t <= 32; head_dim a multiple of 16 up to 128.
// Attention runs within each of the m instances. Launches on `stream` and
// returns the CUDA error of the launch (cudaErrorInvalidValue for a t or
// head_dim it was not built for).
extern "C" int missm_short_attention_forward(const void* q, const void* k,
                                             const void* v, void* out, int m,
                                             int t, int h, int head_dim,
                                             int is_bf16, float scale,
                                             void* stream) {
  if (t < 1 || t > kMaxT || m < 0 || h < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long pairs = static_cast<long long>(m) * h;
  if (pairs == 0) return 0;
  if (pairs > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int p = static_cast<int>(pairs);
  switch (head_dim) {
#define MISSM_HD(HD)                                                       \
  case HD:                                                                 \
    return is_bf16 ? launch_t<__nv_bfloat16, HD>(q, k, v, out, p, t, h,    \
                                                 scale, s)                 \
                   : launch_t<float, HD>(q, k, v, out, p, t, h, scale, s);
    MISSM_HD(16) MISSM_HD(32) MISSM_HD(48) MISSM_HD(64)
    MISSM_HD(80) MISSM_HD(96) MISSM_HD(112) MISSM_HD(128)
#undef MISSM_HD
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
