// The MLP backward's input gradient, fused, for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel K6, missm_tpu/kernels/mlp_bwd.py::mlp_bwd_dx
// (body _kernel): for a quick_gelu MLP h -> quick_gelu(h W1) W2 with the fc1
// pre-activation `wide` saved,
//   dh = R( R((dy . W2^T) * qg'(wide)) . W1^T ),
//   qg'(x) = s (1 + 1.702 x (1 - s)), s = sigmoid(1.702 x),
// dy [M, D], wide [M, FF], W1 [D, FF], W2 [FF, D] (both stored (in, out)),
// R rounding to dy's type. The first product and the derivative are f32,
// dwide is rounded once to dy's type, the second product accumulates in f32.
//
// What bounds it on this card: at the probe's shape [16448, 1024, 4096] the
// function does 4 M D FF = 276 GFLOP on 219 MB, so it is bound by the tensor
// cores (0.28 ms at 989 TFLOP/s). The fusion keeps the [M, FF] dwide (135 MB
// in bf16 at that shape) out of device memory.
//
// The design problem: a block's output rows need every FF chunk of dwide, and
// each dwide tile needs the whole D of dy, so the TPU kernel carried an f32
// [bm, D] accumulator across its FF loop in VMEM (256 rows x 1024 = 1 MB).
// Here 64 rows of it at D = 1024 are already 256 KB, more than a block's 227
// KB of shared memory. The options were (1) fewer rows per block, (2) D split
// across blocks, each recomputing the [bm, bf] dwide tile (the first product
// once per split: 1.5x the FLOP at two splits, 2.5x at four), or (3) FF
// split across blocks with a second pass that sums the f32 partials in a
// fixed order. (2) pays in FLOP and (3) in device memory, the round trip the
// kernel exists to avoid, and neither shrinks a block's accumulator. So this
// kernel takes (1): a block owns BM = 32 rows and all of D, its accumulator
// lives in registers (8 warps, each owning D / 8 columns: 32 x 128 f32 = 128
// registers a thread at D = 1024), and nothing crosses blocks (no atomics,
// deterministic). What it pays: every block streams all of W1 and W2 once
// (16 MB at D = 1024, FF = 4096), mostly from L2, for only 32 rows.
//
// Per FF chunk of BF columns (a first, simple kernel: no wgmma, TMA or
// cp.async pipelining):
//  1. W2[f0:f0+BF, :] and W1[:, f0:f0+BF] into shared memory (dy's BM rows
//     were loaded once, before the loop);
//  2. the [BM, BF] f32 dwide tile on mma.sync m16n8k16: each warp takes one
//     16 x 8 tile over its share of D (the tiles split D between warps when
//     there are fewer than 8 of them), four accumulators in turn;
//  3. the partial tiles summed in a fixed order, times qg'(wide) in f32,
//     rounded to bf16 into shared memory: dwide never leaves the chip;
//  4. each warp adds dwide . W1[its columns, chunk]^T to its accumulator.
// Both products read B fragments as contiguous pairs: W2's rows hold D and
// W1's rows hold FF, which are the K index of each product. Rows past M are
// zero in dy and dwide and are not stored. (BM, BF) is a template choice
// (32 x 32 by default; 16 and 32 each at D = 1024 for the probe's sweep).
//
// f32: CUDA cores, 8 rows and 16 FF columns per step, full f32 FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// g * quick_gelu'(x), in f32.
__device__ __forceinline__ float times_qgelu_grad(float g, float x) {
  const float s = 1.f / (1.f + expf(-1.702f * x));
  return g * (s * (1.f + 1.702f * x * (1.f - s)));
}

// A-fragment of rows [row, row + 16), columns [k, k + 16) of a row-major
// bf16 tile with row pitch ld.
__device__ __forceinline__ void load_a(uint32_t a[4], const __nv_bfloat16* base,
                                       int ld, int g, int t) {
  const __nv_bfloat16* r0 = base + g * ld + 2 * t;
  a[0] = ld_pair(r0);
  a[1] = ld_pair(r0 + 8 * ld);
  a[2] = ld_pair(r0 + 8);
  a[3] = ld_pair(r0 + 8 * ld + 8);
}

// Shared-memory layout of the bf16 kernel, in bytes.
template <int BM, int BF, int D>
struct Layout {
  static constexpr int kLdD = D + 8;   // dy and W2 rows: fragment loads on 32 banks
  static constexpr int kLdF = BF + 8;  // W1 rows and dwide rows, the same
  static constexpr int kTiles = (BM / 16) * (BF / 8);  // 16 x 8 dwide tiles
  static constexpr int kSplit = kWarps / kTiles;       // warps sharing a tile's D
  static constexpr size_t kDy = 0;
  static constexpr size_t kW2 = kDy + (size_t)BM * kLdD * 2;
  static constexpr size_t kW1 = kW2 + (size_t)BF * kLdD * 2;
  static constexpr size_t kDw = kW1 + (size_t)D * kLdF * 2;
  static constexpr size_t kRed = kDw + (size_t)BM * kLdF * 2;
  static constexpr size_t kBytes = kRed + (size_t)kSplit * BM * BF * 4;
  static_assert(kTiles * kSplit == kWarps, "tiles must divide the warps");
  static_assert((D / 16) % kSplit == 0, "D must split evenly");
  static_assert(kBytes <= 232448, "more than a block's shared memory");
};

template <int BM, int BF, int D>
__global__ void __launch_bounds__(kThreads, 1)
mlp_bwd_dx_bf16(const __nv_bfloat16* __restrict__ dy,
                const __nv_bfloat16* __restrict__ wide,
                const __nv_bfloat16* __restrict__ w1,
                const __nv_bfloat16* __restrict__ w2,
                __nv_bfloat16* __restrict__ out, int m, int ff) {
  using L = Layout<BM, BF, D>;
  constexpr int MT = BM / 16;     // 16-row tiles
  constexpr int NT = D / 64;      // 8-column output tiles per warp (D / 8 columns)
  constexpr int kSteps = D / 16 / L::kSplit;  // first-product k-steps per warp
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* dys = reinterpret_cast<__nv_bfloat16*>(smem + L::kDy);
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem + L::kW2);
  __nv_bfloat16* w1s = reinterpret_cast<__nv_bfloat16*>(smem + L::kW1);
  __nv_bfloat16* dws = reinterpret_cast<__nv_bfloat16*>(smem + L::kDw);
  float* red = reinterpret_cast<float*>(smem + L::kRed);

  const int m0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int d0 = warp * (D / 8);  // this warp's output columns
  const int tile = warp % L::kTiles;
  const int part = warp / L::kTiles;  // which share of D for the dwide tile
  const int tm = tile / (BF / 8);
  const int tn = tile % (BF / 8);

  // dy's BM rows, once; rows past m are zero
  for (int c = threadIdx.x; c < BM * D / 8; c += kThreads) {
    const int r = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < m) v = *reinterpret_cast<const uint4*>(dy + (size_t)(m0 + r) * D + col);
    *reinterpret_cast<uint4*>(dys + r * L::kLdD + col) = v;
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int f0 = 0; f0 < ff; f0 += BF) {
    __syncthreads();  // dy is in; everyone is done with the last chunk
    for (int c = threadIdx.x; c < BF * D / 8; c += kThreads) {
      const int r = c / (D / 8);
      const int col = (c % (D / 8)) * 8;
      *reinterpret_cast<uint4*>(w2s + r * L::kLdD + col) =
          *reinterpret_cast<const uint4*>(w2 + (size_t)(f0 + r) * D + col);
    }
    for (int c = threadIdx.x; c < D * BF / 8; c += kThreads) {
      const int r = c / (BF / 8);
      const int col = (c % (BF / 8)) * 8;
      *reinterpret_cast<uint4*>(w1s + r * L::kLdF + col) =
          *reinterpret_cast<const uint4*>(w1 + (size_t)r * ff + f0 + col);
    }
    __syncthreads();

    // this warp's 16 x 8 dwide tile over its share of D
    {
      float c4[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) c4[i][0] = c4[i][1] = c4[i][2] = c4[i][3] = 0.f;
      const __nv_bfloat16* ar = dys + tm * 16 * L::kLdD;
      const __nv_bfloat16* br = w2s + (tn * 8 + g) * L::kLdD + 2 * t;
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const int k = (part * kSteps + s) * 16;
        uint32_t a[4];
        load_a(a, ar + k, L::kLdD, g, t);
        mma_bf16(c4[s & 3], a, ld_pair(br + k), ld_pair(br + k + 8));
      }
      float* rp = red + part * BM * BF + (tm * 16 + g) * BF + tn * 8 + 2 * t;
      rp[0] = (c4[0][0] + c4[1][0]) + (c4[2][0] + c4[3][0]);
      rp[1] = (c4[0][1] + c4[1][1]) + (c4[2][1] + c4[3][1]);
      rp[8 * BF] = (c4[0][2] + c4[1][2]) + (c4[2][2] + c4[3][2]);
      rp[8 * BF + 1] = (c4[0][3] + c4[1][3]) + (c4[2][3] + c4[3][3]);
    }
    __syncthreads();

    // dwide = (sum of the parts) * qg'(wide), rounded once to bf16
    for (int i = threadIdx.x; i < BM * BF; i += kThreads) {
      const int r = i / BF;
      const int c = i % BF;
      float v = 0.f;
      if (m0 + r < m) {
#pragma unroll
        for (int p = 0; p < L::kSplit; ++p) v += red[p * BM * BF + i];
        v = times_qgelu_grad(
            v, __bfloat162float(wide[(size_t)(m0 + r) * ff + f0 + c]));
      }
      dws[r * L::kLdF + c] = __float2bfloat16(v);
    }
    __syncthreads();

    // acc[:, d0 : d0 + D / 8] += dwide . W1[d0 : d0 + D / 8, chunk]^T
#pragma unroll
    for (int ks = 0; ks < BF / 16; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        load_a(a[mt], dws + mt * 16 * L::kLdF + ks * 16, L::kLdF, g, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* br = w1s + (d0 + nt * 8 + g) * L::kLdF + ks * 16 + 2 * t;
        const uint32_t b0 = ld_pair(br);
        const uint32_t b1 = ld_pair(br + 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int row = m0 + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = d0 + nt * 8 + 2 * t;
      if (row < m)
        *reinterpret_cast<uint32_t*>(out + (size_t)row * D + col) =
            pack_bf16(acc[mt][nt][0], acc[mt][nt][1]);
      if (row + 8 < m)
        *reinterpret_cast<uint32_t*>(out + (size_t)(row + 8) * D + col) =
            pack_bf16(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

template <int BM, int BF, int D>
int launch_bf16(const void* dy, const void* wide, const void* w1, const void* w2,
                void* out, int m, int ff, cudaStream_t stream) {
  using L = Layout<BM, BF, D>;
  if (ff % BF) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = mlp_bwd_dx_bf16<BM, BF, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(m + BM - 1) / BM, kThreads, L::kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(dy), static_cast<const __nv_bfloat16*>(wide),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<__nv_bfloat16*>(out), m, ff);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, full f32 products
// ---------------------------------------------------------------------------

constexpr int kF32BM = 8;   // rows per block
constexpr int kF32BF = 16;  // FF columns per step
constexpr int kF32Cols = 4; // output columns per thread: tid + 256 j

// Shared memory: dy [8][d], W2 chunk [16][d + 1], W1 chunk [d][17], dwide
// [8][16], all f32.
size_t f32_smem_bytes(int d) {
  return sizeof(float) * ((size_t)kF32BM * d + (size_t)kF32BF * (d + 1) +
                          (size_t)d * (kF32BF + 1) + kF32BM * kF32BF);
}

__global__ void __launch_bounds__(kThreads)
mlp_bwd_dx_f32(const float* __restrict__ dy, const float* __restrict__ wide,
               const float* __restrict__ w1, const float* __restrict__ w2,
               float* __restrict__ out, int m, int d, int ff) {
  extern __shared__ __align__(16) float fsm[];
  float* dys = fsm;                              // [8][d]
  float* w2s = dys + kF32BM * d;                 // [16][d + 1]
  float* w1s = w2s + kF32BF * (d + 1);           // [d][17]
  float* dws = w1s + (size_t)d * (kF32BF + 1);   // [8][16]
  const int m0 = blockIdx.x * kF32BM;

  for (int i = threadIdx.x; i < kF32BM * d; i += kThreads) {
    const int r = i / d;
    dys[i] = m0 + r < m ? dy[(size_t)m0 * d + i] : 0.f;
  }
  float acc[kF32BM][kF32Cols];
#pragma unroll
  for (int r = 0; r < kF32BM; ++r)
#pragma unroll
    for (int j = 0; j < kF32Cols; ++j) acc[r][j] = 0.f;

  for (int f0 = 0; f0 < ff; f0 += kF32BF) {
    __syncthreads();
    for (int i = threadIdx.x; i < kF32BF * d; i += kThreads) {
      const int r = i / d;
      w2s[r * (d + 1) + i % d] = w2[(size_t)f0 * d + i];
    }
    for (int i = threadIdx.x; i < d * kF32BF; i += kThreads) {
      const int r = i / kF32BF;
      const int c = i % kF32BF;
      w1s[r * (kF32BF + 1) + c] = w1[(size_t)r * ff + f0 + c];
    }
    __syncthreads();
    {  // dwide [8][16]: two threads per element, the even and odd k
      const int o = threadIdx.x >> 1;
      const int half = threadIdx.x & 1;
      const int r = o / kF32BF;
      const int c = o % kF32BF;
      float s = 0.f;
      for (int k = half; k < d; k += 2)
        s = fmaf(dys[r * d + k], w2s[c * (d + 1) + k], s);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      if (half == 0)
        dws[o] = m0 + r < m
                     ? times_qgelu_grad(s, wide[(size_t)(m0 + r) * ff + f0 + c])
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kF32BF; ++c) {
#pragma unroll
      for (int j = 0; j < kF32Cols; ++j) {
        const int col = threadIdx.x + kThreads * j;
        if (col >= d) break;
        const float b = w1s[col * (kF32BF + 1) + c];
#pragma unroll
        for (int r = 0; r < kF32BM; ++r) acc[r][j] = fmaf(dws[r * kF32BF + c], b, acc[r][j]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kF32BM; ++r) {
    if (m0 + r >= m) break;
#pragma unroll
    for (int j = 0; j < kF32Cols; ++j) {
      const int col = threadIdx.x + kThreads * j;
      if (col < d) out[(size_t)(m0 + r) * d + col] = acc[r][j];
    }
  }
}

int launch_f32(const void* dy, const void* wide, const void* w1, const void* w2,
               void* out, int m, int d, int ff, cudaStream_t stream) {
  if (ff % kF32BF) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = f32_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_bwd_dx_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  mlp_bwd_dx_f32<<<(m + kF32BM - 1) / kF32BM, kThreads, bytes, stream>>>(
      static_cast<const float*>(dy), static_cast<const float*>(wide),
      static_cast<const float*>(w1), static_cast<const float*>(w2),
      static_cast<float*>(out), m, d, ff);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dy [m, d], wide [m, ff], w1 [d, ff], w2 [ff, d] and out [m, d]: contiguous,
// 16-byte aligned, all bf16 (is_bf16 = 1) or all f32; d one of 128, 256,
// 512, 768, 1024. bf16 takes the tile (bm, bf) = (32, 32) at every d, and
// (16, 32), (32, 16) and (16, 16) at d = 1024; ff a multiple of bf (of 16 for
// f32, which ignores bm and bf). Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for what it was not built for).
extern "C" int missm_mlp_bwd_dx(const void* dy, const void* wide, const void* w1,
                                const void* w2, void* out, int m, int d, int ff,
                                int is_bf16, int bm, int bf, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || ff <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (!is_bf16) {
    if (d != 128 && d != 256 && d != 512 && d != 768 && d != 1024)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_f32(dy, wide, w1, w2, out, m, d, ff, s);
  }
  const int key = d * 10000 + bm * 100 + bf;
  switch (key) {
    case 128 * 10000 + 3232: return launch_bf16<32, 32, 128>(dy, wide, w1, w2, out, m, ff, s);
    case 256 * 10000 + 3232: return launch_bf16<32, 32, 256>(dy, wide, w1, w2, out, m, ff, s);
    case 512 * 10000 + 3232: return launch_bf16<32, 32, 512>(dy, wide, w1, w2, out, m, ff, s);
    case 768 * 10000 + 3232: return launch_bf16<32, 32, 768>(dy, wide, w1, w2, out, m, ff, s);
    case 1024 * 10000 + 3232: return launch_bf16<32, 32, 1024>(dy, wide, w1, w2, out, m, ff, s);
    case 1024 * 10000 + 1632: return launch_bf16<16, 32, 1024>(dy, wide, w1, w2, out, m, ff, s);
    case 1024 * 10000 + 3216: return launch_bf16<32, 16, 1024>(dy, wide, w1, w2, out, m, ff, s);
    case 1024 * 10000 + 1616: return launch_bf16<16, 16, 1024>(dy, wide, w1, w2, out, m, ff, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
