// Fused LayerNorm -> linear for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel K5 of missm_tpu/kernels/ln_linear.py,
// _ln_linear_fwd_pallas (bodies _ln_linear_kernel, _ln_linear_kernel_b): the
// pre-LN block's ln2 -> fc1 boundary,
//   y = R( R((x - mean) * rstd * gamma + beta) . W  (+ b) ),
// x [M, D], gamma and beta [D], W [D, F] stored (in, out), b [F], where R
// rounds to x's type (bf16; nothing for f32). mean and the mean of the squared
// deviation are f32 (two passes, as the TPU kernel), the products accumulate
// in f32 and the bias is added in f32 before the single rounding. gamma, beta
// and b may each be bf16 or f32 (frozen leaves cast to bf16 arrive as bf16).
//
// What bounds it on this card: at the flagship image shape [16448, 1024] ->
// 4096 the function does 138 GFLOP on 177 MB of inputs and output, about 780
// FLOP per byte, so like any large GEMM it is bound by the tensor cores
// (0.14 ms at 989 TFLOP/s). What the fusion saves is the [M, D] normalised
// activation that an unfused LayerNorm writes and the GEMM reads back (67 MB
// at that shape): each block here takes its rows' statistics first, then
// normalises every x chunk as it enters shared memory, so the normalised
// copy never reaches device memory.
//
// Design (a first, simple kernel: no wgmma, TMA or cp.async pipelining; tiles
// are loaded with 16-byte vector loads between two barriers):
//  - bf16: a block of 4 warps computes a 64 x 128 tile of y (warps 2 x 2,
//    each 32 x 64) on mma.sync m16n8k16 with f32 accumulators, 32 of D per
//    step. W's (in, out) layout puts the K index on rows, so the mma's "col"
//    B fragments come from shared memory through ldmatrix .trans.
//  - f32: CUDA cores, a 64 x 64 tile per block of 256 threads, 4 x 4 outputs
//    per thread, full f32 FMAs.
//  - Statistics: each block takes its 64 rows' mean and rstd before its K
//    loop, one warp per row at a time. The F / tile blocks of one row tile
//    each read those rows again; they run close together and mostly hit L2.
//  - Ragged M: M need only be a multiple of 8 (a train microbatch's 16 * 77 =
//    1232 text rows); rows past M are zero in shared memory and not stored.
//  - The bias is a template flag.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Element i of a parameter vector (gamma, beta or the bias) as f32.
__device__ __forceinline__ float vec_at(const void* p, int i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

// Mean and rstd = 1 / sqrt(mean((x - mean)^2) + eps) of rows [row0, row0 +
// rows) of x [m, d], one warp per row at a time, into mean_s / rstd_s. Rows
// past m get 0 and 0.
template <typename T, int THREADS>
__device__ void row_stats(const T* __restrict__ x, int row0, int rows, int m,
                          int d, float eps, float* mean_s, float* rstd_s) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += THREADS / 32) {
    const int row = row0 + r;
    float mean = 0.f, rstd = 0.f;
    if (row < m) {
      const T* xr = x + (size_t)row * d;
      float s = 0.f;
      for (int i = lane; i < d; i += 32) s += to_f32(xr[i]);
      mean = warp_sum(s) / d;
      float v = 0.f;
      for (int i = lane; i < d; i += 32) {
        const float e = to_f32(xr[i]) - mean;
        v = fmaf(e, e, v);
      }
      rstd = 1.f / sqrtf(warp_sum(v) / d + eps);
    }
    if (lane == 0) {
      mean_s[r] = mean;
      rstd_s[r] = rstd;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, f32 accumulate)
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kBM = 64;          // rows of y per block
constexpr int kBN = 128;         // columns of y per block
constexpr int kBK = 32;          // depth per step
constexpr int kLDA = kBK + 8;    // 40: the A-fragment loads hit 32 banks
constexpr int kLDB = kBN + 8;    // 136: ldmatrix's 8 rows on distinct banks

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory, each transposed: lanes 8j to
// 8j + 7 give the row addresses of matrix j, and every lane receives, of
// each matrix, elements [2(lane % 4)] and [2(lane % 4) + 1] of column
// lane / 4 (the lower row in the low half).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Two floats -> packed bf16x2, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <bool HAS_BIAS>
__global__ void __launch_bounds__(kThreads)
ln_linear_bf16(const __nv_bfloat16* __restrict__ x, const void* __restrict__ gamma,
               const void* __restrict__ beta, const __nv_bfloat16* __restrict__ w,
               const void* __restrict__ bias, __nv_bfloat16* __restrict__ y, int m,
               int d, int f, int vec_bf16, int bias_bf16, float eps) {
  __shared__ __align__(16) __nv_bfloat16 as[kBM * kLDA];  // normalised x
  __shared__ __align__(16) __nv_bfloat16 bs[kBK * kLDB];  // W rows
  __shared__ float mean_s[kBM], rstd_s[kBM];

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row within the 8-row group
  const int t = lane & 3;   // fragment column pair
  const int wm = warp >> 1; // the warp's 32 rows
  const int wn = warp & 1;  // the warp's 64 columns

  row_stats<__nv_bfloat16, kThreads>(x, m0, kBM, m, d, eps, mean_s, rstd_s);

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kBK) {
    __syncthreads();  // the statistics are in; everyone is done with the last tile
    // x[64, 32], normalised in f32 and rounded to bf16 on its way in
    for (int c = threadIdx.x; c < kBM * kBK / 8; c += kThreads) {
      const int r = c / (kBK / 8);
      const int col = (c % (kBK / 8)) * 8;
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < m) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * d + k0 + col);
        const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&raw);
        const float mu = mean_s[r], rs = rstd_s[r];
        uint32_t o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = k0 + col + 2 * i;
          const float lo = ((__bfloat162float(xv[2 * i]) - mu) * rs) *
                               vec_at(gamma, k, vec_bf16) + vec_at(beta, k, vec_bf16);
          const float hi = ((__bfloat162float(xv[2 * i + 1]) - mu) * rs) *
                               vec_at(gamma, k + 1, vec_bf16) +
                           vec_at(beta, k + 1, vec_bf16);
          o[i] = pack_bf16(lo, hi);
        }
        packed = make_uint4(o[0], o[1], o[2], o[3]);
      }
      *reinterpret_cast<uint4*>(as + r * kLDA + col) = packed;
    }
    // W[32, 128] as it is stored
    for (int c = threadIdx.x; c < kBK * kBN / 8; c += kThreads) {
      const int r = c / (kBN / 8);
      const int col = (c % (kBN / 8)) * 8;
      *reinterpret_cast<uint4*>(bs + r * kLDB + col) =
          *reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * f + n0 + col);
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const __nv_bfloat16* r0 = as + (wm * 32 + mt * 16 + g) * kLDA + ks * 16 + 2 * t;
        a[mt][0] = ld_pair(r0);
        a[mt][1] = ld_pair(r0 + 8 * kLDA);
        a[mt][2] = ld_pair(r0 + 8);
        a[mt][3] = ld_pair(r0 + 8 * kLDA + 8);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        // matrices: k rows 0-7 / 8-15 of column tile 2np, then of 2np + 1
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, bs + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLDB +
                   wn * 64 + np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int row = m0 + wm * 32 + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = n0 + wn * 64 + nt * 8 + 2 * t;
      float b0 = 0.f, b1 = 0.f;
      if (HAS_BIAS) {
        b0 = vec_at(bias, col, bias_bf16);
        b1 = vec_at(bias, col + 1, bias_bf16);
      }
      if (row < m)
        *reinterpret_cast<uint32_t*>(y + (size_t)row * f + col) =
            pack_bf16(acc[mt][nt][0] + b0, acc[mt][nt][1] + b1);
      if (row + 8 < m)
        *reinterpret_cast<uint32_t*>(y + (size_t)(row + 8) * f + col) =
            pack_bf16(acc[mt][nt][2] + b0, acc[mt][nt][3] + b1);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, full f32 products
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;
constexpr int kF32BM = 64;
constexpr int kF32BN = 64;
constexpr int kF32BK = 16;

template <bool HAS_BIAS>
__global__ void __launch_bounds__(kF32Threads)
ln_linear_f32(const float* __restrict__ x, const void* __restrict__ gamma,
              const void* __restrict__ beta, const float* __restrict__ w,
              const void* __restrict__ bias, float* __restrict__ y, int m, int d,
              int f, int vec_bf16, int bias_bf16, float eps) {
  __shared__ __align__(16) float as[kF32BK][kF32BM + 4];  // normalised x, k-major
  __shared__ __align__(16) float bs[kF32BK][kF32BN];
  __shared__ float mean_s[kF32BM], rstd_s[kF32BM];

  const int n0 = blockIdx.x * kF32BN;
  const int m0 = blockIdx.y * kF32BM;
  const int tx = threadIdx.x & 15;  // columns 4 tx .. 4 tx + 3
  const int ty = threadIdx.x >> 4;  // rows 4 ty .. 4 ty + 3

  row_stats<float, kF32Threads>(x, m0, kF32BM, m, d, eps, mean_s, rstd_s);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kF32BK) {
    __syncthreads();
    {  // x[64, 16]: one float4 per thread, normalised, stored k-major
      const int r = threadIdx.x >> 2;
      const int kc = (threadIdx.x & 3) * 4;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (m0 + r < m) {
        const float4 raw =
            *reinterpret_cast<const float4*>(x + (size_t)(m0 + r) * d + k0 + kc);
        const float in[4] = {raw.x, raw.y, raw.z, raw.w};
        const float mu = mean_s[r], rs = rstd_s[r];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = k0 + kc + i;
          v[i] = ((in[i] - mu) * rs) * vec_at(gamma, k, vec_bf16) +
                 vec_at(beta, k, vec_bf16);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) as[kc + i][r] = v[i];
    }
    {  // W[16, 64]: one float4 per thread
      const int r = threadIdx.x >> 4;
      const int nc = (threadIdx.x & 15) * 4;
      *reinterpret_cast<float4*>(&bs[r][nc]) =
          *reinterpret_cast<const float4*>(w + (size_t)(k0 + r) * f + n0 + nc);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kF32BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      y[(size_t)row * f + col] =
          acc[i][j] + (HAS_BIAS ? vec_at(bias, col, bias_bf16) : 0.f);
    }
  }
}

template <bool HAS_BIAS>
void launch(const void* x, const void* gamma, const void* beta, const void* w,
            const void* bias, void* y, int m, int d, int f, int is_bf16,
            int vec_bf16, int bias_bf16, float eps, cudaStream_t stream) {
  if (is_bf16) {
    const dim3 grid(f / kBN, (m + kBM - 1) / kBM);
    ln_linear_bf16<HAS_BIAS><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), gamma, beta,
        static_cast<const __nv_bfloat16*>(w), bias, static_cast<__nv_bfloat16*>(y),
        m, d, f, vec_bf16, bias_bf16, eps);
  } else {
    const dim3 grid(f / kF32BN, (m + kF32BM - 1) / kF32BM);
    ln_linear_f32<HAS_BIAS><<<grid, kF32Threads, 0, stream>>>(
        static_cast<const float*>(x), gamma, beta, static_cast<const float*>(w),
        bias, static_cast<float*>(y), m, d, f, vec_bf16, bias_bf16, eps);
  }
}

}  // namespace

// x [m, d], w [d, f] and y [m, f]: contiguous, 16-byte aligned, bf16
// (is_bf16 = 1) or f32. gamma, beta [d] and bias [f] (or null): contiguous,
// bf16 (vec_bf16 / bias_bf16 = 1) or f32. d and f multiples of 128, any m >
// 0. Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for shapes it does not take).
extern "C" int missm_ln_linear_forward(const void* x, const void* gamma,
                                       const void* beta, const void* w,
                                       const void* bias, void* y, int m, int d,
                                       int f, int is_bf16, int vec_bf16,
                                       int bias_bf16, float eps, void* stream) {
  if (m <= 0 || d <= 0 || f <= 0 || d % 128 || f % 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bias)
    launch<true>(x, gamma, beta, w, bias, y, m, d, f, is_bf16, vec_bf16, bias_bf16, eps, s);
  else
    launch<false>(x, gamma, beta, w, bias, y, m, d, f, is_bf16, vec_bf16, bias_bf16, eps, s);
  return static_cast<int>(cudaGetLastError());
}
