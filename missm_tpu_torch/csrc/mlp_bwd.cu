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
// [bm, D] accumulator across its FF loop in VMEM. On this card wgmma takes 64
// rows, and 64 rows of f32 at D = 1024 are 256 KB, the whole register file of
// an SM. The first design (4.68-4.70 ms, 6 % of the bound, 1.9x the cuBLAS
// chain) fell back to blocks of 32 rows on mma.sync with synchronous tile
// loads: every one of its 514 blocks streamed all of W1 and W2 (16.8 MB), 8.6
// GB from L2.
//
// The bf16 kernel now splits D across a thread block cluster instead: a
// cluster of C blocks owns R = 128 rows, and block c owns the D / C output
// columns [c D / C, (c + 1) D / C) (NOUT = 128 or 256, wgmma's N). A block has
// two consumer warpgroups (64 rows each, NOUT / 2 f32 accumulators a thread)
// and a producer warpgroup whose one thread feeds a ring of stages by TMA
// (128B swizzle, zero rows past M), its registers handed to the consumers
// (setmaxnreg). Each FF step of C * 64 columns:
//  1. block c computes its own [128, 64] chunk of dwide, dy . W2[chunk]^T over
//     the whole D (wgmma m64n64k16, dy and W2 K-major as stored, a stage each
//     64 of D);
//  2. multiplies it by qg'(wide) in f32, the wide tile read by TMA and from
//     shared memory at the accumulator's own positions, and rounds it once;
//  3. writes it, swizzled as wgmma's A, into its own slot of its dwide step
//     buffer [128, C * 64], and copies each warpgroup's 64 rows into the same
//     slot of every other block of the cluster (a bulk copy to distributed
//     shared memory that completes on the peer's barrier);
//  4. once the C slots have landed, adds dwide . W1[own columns, step]^T to
//     its accumulator (wgmma m64nNOUTk16, W1 K-major as stored, a stage a
//     64-column chunk), and tells every block that its warpgroup has read the
//     step, so that the next step may overwrite it.
// Nothing is computed twice, dwide never leaves the cluster, and there are no
// atomics: the result is the same on every run. The dwide buffer is single:
// a block writes step s + 1 only after every block's warpgroup has read step
// s, which it has by the time its own step s + 1 chunk is ready. Per cluster,
// W1 and W2 are read once for 128 rows (2.2 GB from L2 at the probe's shape
// against 8.6 GB); dy's rows are read by each block of the cluster once a
// step. The cluster ends with a barrier, so that no block leaves while a peer
// may still write to it. `tile` = (R, C): (128, C) with D / C in {128, 256};
// kernels/mlp_bwd.py::plan gives the grid, cluster, waves, stages and shared
// memory. The default is C = D / 128: at D = 1024 clusters of 8, 15 of them
// at a time on the card (a cluster stays within a GPC), 9 waves. With 256
// output columns a block (C = D / 256) each consumer thread holds 128
// accumulators beside step 1's 32, and ptxas, which allocates this kernel
// at most 168 registers a thread in spite of setmaxnreg, spills them: that
// tile is built for the probe's sweep and is 2x slower.
//
// What bounds it now (PERF.md section 6, PR 9): not the tensor cores (about
// 16 % of their peak) and not L2 (about 4 GB a call at 2.5 TB/s) but the
// latency of step 1: its stages are small products (64 columns, 1 MFLOP)
// on 24 KB each, three stages fit beside the 128 KB dwide buffer at C = 8,
// and each step waits for the cluster's exchange before step 4. Measured
// and dropped, no faster in one call on the card: L2 eviction hints on the
// loads; the cluster barrier waits at CTA scope; dwide staged in registers
// before the write.
//
// f32: CUDA cores, 8 rows and 16 FF columns per step, full f32 FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;  // the f32 kernel

// g * quick_gelu'(x), in f32.
__device__ __forceinline__ float times_qgelu_grad(float g, float x) {
  const float s = 1.f / (1.f + expf(-1.702f * x));
  return g * (s * (1.f + 1.702f * x * (1.f - s)));
}

// ---------------------------------------------------------------------------
// bf16: a cluster of blocks on wgmma, TMA ring, dwide in distributed shared
// memory
// ---------------------------------------------------------------------------

constexpr int kRows = 128;        // R: rows a cluster owns
constexpr int kBK = 64;           // depth of a stage, columns of a dwide chunk
constexpr int kBf16Threads = 384; // two consumer warpgroups and a producer
constexpr int kMaxStages = 4;
constexpr int kSmemLimit = 232448;
constexpr int kChunk = kRows * kBK * 2;  // a [128, 64] bf16 tile: 16 KB

// A stage holds a dy tile [128, 64] and a W2 tile [64, 64] (step 1) or a W1
// tile [NOUT, 64] (step 4).
__host__ __device__ constexpr int stage_bytes(int nout) {
  return nout * kBK * 2 > kChunk + 64 * kBK * 2 ? nout * kBK * 2
                                                 : kChunk + 64 * kBK * 2;
}
// The dwide step buffer, the wide tile, the ring, and the barriers (a full
// and an empty one a stage, the wide tile's two, and each consumer
// warpgroup's two for the dwide step), 1024-aligned.
constexpr int smem_bytes(int cluster, int nout, int stages) {
  return 1024 + cluster * kChunk + kChunk + stages * stage_bytes(nout) +
         8 * (2 * stages + 2 + 4);
}
int stages_for(int cluster, int nout) {
  int s = kMaxStages;
  while (s >= 2 && smem_bytes(cluster, nout, s) > kSmemLimit) --s;
  return s;
}

template <int NOUT>
__global__ void __launch_bounds__(kBf16Threads, 1)
mlp_bwd_dx_bf16(const __grid_constant__ CUtensorMap tdy,
                const __grid_constant__ CUtensorMap twide,
                const __grid_constant__ CUtensorMap tw1,
                const __grid_constant__ CUtensorMap tw2,
                __nv_bfloat16* __restrict__ out, int m, int d, int ff,
                int cluster, int stages) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  uint8_t* dwide = smem;                        // cluster x [128, 64]
  uint8_t* wide_s = dwide + cluster * kChunk;   // [128, 64]
  uint8_t* ring = wide_s + kChunk;
  constexpr int kStage = stage_bytes(NOUT);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * kStage);
  uint64_t* empty = full + stages;
  uint64_t* wide_full = empty + stages;
  uint64_t* wide_empty = wide_full + 1;
  uint64_t* dw_full = wide_empty + 1;   // [2]: a consumer warpgroup each
  uint64_t* dw_empty = dw_full + 2;     // [2]

  const uint32_t rank = cluster_rank();
  const int m0 = (blockIdx.x / cluster) * kRows;
  const int d0 = (int)rank * NOUT;
  const int step_cols = cluster * kBK;
  const int steps = ff / step_cols;
  const int ksteps = d / kBK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 2);
    }
    mbar_init(wide_full, 1);
    mbar_init(wide_empty, 256);  // every consumer thread
    for (int w = 0; w < 2; ++w) {
      mbar_init(dw_full + w, 1);
      mbar_init(dw_empty + w, cluster);  // that warpgroup of every block
    }
    mbar_fence_init();
  }
  __syncthreads();
  cluster_sync();  // every block's barriers exist before any peer uses them

  if (warp >= 8) {
    // producer warpgroup: one thread streams, per step, the wide tile, D / 64
    // (dy, W2) stages and C W1 stages
    regs_dealloc<40>();
    if (threadIdx.x == 256) {
      int it = 0;
      auto next = [&](uint32_t bytes) {
        const int s = it % stages;
        if (it >= stages) mbar_wait(empty + s, (it / stages - 1) & 1);
        mbar_expect(full + s, bytes);
        ++it;
        return s;
      };
      for (int step = 0; step < steps; ++step) {
        const int f0 = step * step_cols + (int)rank * kBK;
        if (step > 0) mbar_wait(wide_empty, (step - 1) & 1);
        mbar_expect(wide_full, kChunk);
        tma_load(wide_s, &twide, wide_full, f0, m0, 0);
        for (int kt = 0; kt < ksteps; ++kt) {
          const int s = next(kChunk + 64 * kBK * 2);
          tma_load(ring + s * kStage, &tdy, full + s, kt * kBK, m0, 0);
          tma_load(ring + s * kStage + kChunk, &tw2, full + s, kt * kBK, f0, 0);
        }
        for (int q = 0; q < cluster; ++q) {
          const int s = next(NOUT * kBK * 2);
          tma_load(ring + s * kStage, &tw1, full + s, step * step_cols + q * kBK,
                   d0, 0);
        }
      }
    }
    __syncwarp();
    cluster_sync();
    return;
  }

  regs_alloc<232>();
  const int wg = warp >> 2;
  const int t = lane & 3;
  const int r0 = wg * 64 + (warp & 3) * 16 + (lane >> 2);  // rows r0, r0 + 8
  const bool leader = (warp & 3) == 0 && lane == 0;
  const uint32_t ring_u = smem_u32(ring);
  const uint32_t dwide_u = smem_u32(dwide);
  float acc[NOUT / 2];
  int it = 0;
  for (int step = 0; step < steps; ++step) {
    // 1. this block's dwide chunk, dy . W2[chunk]^T over the whole D
    float p[32];
    for (int kt = 0; kt < ksteps; ++kt, ++it) {
      const int s = it % stages;
      mbar_wait(full + s, (it / stages) & 1);
      const uint32_t st = ring_u + s * kStage;
      fence_regs<32>(p);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<64>(p, kmajor128(st + wg * 64 * 128, kk),
                     kmajor128(st + kChunk, kk), kt > 0 || kk > 0);
      wgmma_commit();
      // this stage's products stay in flight; the last stage's are done
      wgmma_wait_n<1>();
      if (kt > 0 && leader) mbar_arrive(empty + (it - 1) % stages);
    }
    wgmma_wait();
    fence_regs<32>(p);
    if (leader) mbar_arrive(empty + (it - 1) % stages);
    // 2. times qg'(wide), rounded once, into this block's slot (once every
    // block's warpgroup has read the last step)
    mbar_wait(wide_full, step & 1);
    if (step > 0) mbar_wait_cluster(dw_empty + wg, (step - 1) & 1);
    uint8_t* slot = dwide + rank * kChunk;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t off = swz128(r0 + 8 * h, j) + 4 * t;
        const uint32_t x = *reinterpret_cast<const uint32_t*>(wide_s + off);
        *reinterpret_cast<uint32_t*>(slot + off) = pack_bf16(
            times_qgelu_grad(p[4 * j + 2 * h], __uint_as_float(x << 16)),
            times_qgelu_grad(p[4 * j + 2 * h + 1],
                             __uint_as_float(x & 0xffff0000u)));
      }
    mbar_arrive(wide_empty);
    // 3. then into the same slot of every peer
    fence_async_smem();
    bar_sync(1 + wg, 128);
    if (leader) {
      mbar_expect(dw_full + wg, (cluster - 1) * kChunk / 2);
      for (int q = 0; q < cluster; ++q)
        if (q != (int)rank)
          copy_to_peer(slot + wg * kChunk / 2, kChunk / 2, dw_full + wg, q);
    }
    mbar_wait(dw_full + wg, step & 1);
    // 4. acc += dwide step . W1[own columns, step]^T
    for (int q = 0; q < cluster; ++q, ++it) {
      const int s = it % stages;
      mbar_wait(full + s, (it / stages) & 1);
      const uint32_t st = ring_u + s * kStage;
      const uint32_t a = dwide_u + q * kChunk + wg * kChunk / 2;
      fence_regs<NOUT / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<NOUT>(acc, kmajor128(a, kk), kmajor128(st, kk),
                       step > 0 || q > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait_n<1>();
      if (q > 0 && leader) mbar_arrive(empty + (it - 1) % stages);
    }
    wgmma_wait();
    fence_regs<NOUT / 2>(acc);
    if (leader) mbar_arrive(empty + (it - 1) % stages);
    if (leader)
      for (int q = 0; q < cluster; ++q) mbar_arrive_cluster(dw_empty + wg, q);
  }

#pragma unroll
  for (int j = 0; j < NOUT / 8; ++j) {
    const int col = d0 + 8 * j + 2 * t;
    const int row = m0 + r0;
    if (row < m)
      *reinterpret_cast<uint32_t*>(out + (size_t)row * d + col) =
          pack_bf16(acc[4 * j], acc[4 * j + 1]);
    if (row + 8 < m)
      *reinterpret_cast<uint32_t*>(out + (size_t)(row + 8) * d + col) =
          pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
  cluster_sync();  // no block leaves while a peer may still write to it
}

template <int NOUT>
int launch_bf16(const void* dy, const void* wide, const void* w1,
                const void* w2, void* out, int m, int d, int ff, int cluster,
                cudaStream_t stream) {
  const int stages = stages_for(cluster, NOUT);
  if (stages < 2 || ff % (cluster * kBK)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tdy, twide, tw1, tw2;
  int rc = encode_rows(&tdy, dy, 1, m, d, kRows, kBK);
  if (!rc) rc = encode_rows(&twide, wide, 1, m, ff, kRows, kBK);
  if (!rc) rc = encode_rows(&tw1, w1, 1, d, ff, NOUT, kBK);
  if (!rc) rc = encode_rows(&tw2, w2, 1, ff, d, 64, kBK);
  auto kernel = mlp_bwd_dx_bf16<NOUT>;
  static unsigned long long attr_set = 0;
  if (!rc) rc = allow_smem(kernel, kSmemLimit, attr_set);
  if (rc) return rc;
  return launch_cluster(kernel, (m + kRows - 1) / kRows * cluster,
                        kBf16Threads, smem_bytes(cluster, NOUT, stages), stream,
                        cluster, tdy, twide, tw1, tw2,
                        static_cast<__nv_bfloat16*>(out), m, d, ff, cluster,
                        stages);
}

// The output columns a block owns at width d in clusters of `cluster`
// blocks: 128 or 256, else 0 (not built).
int nout_for(int d, int cluster) {
  if (cluster < 1 || cluster > 8 || d % cluster) return 0;
  const int n = d / cluster;
  return n == 128 || n == 256 ? n : 0;
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
// 16-byte aligned, all bf16 (is_bf16 = 1) or all f32. bf16 takes the tile
// (bm, bf) = (rows, cluster) = (128, C) with d / C 128 or 256 and ff a
// multiple of 64 C; f32 (which ignores bm and bf) d one of 128, 256, 512,
// 768, 1024 and ff a multiple of 16. Launches on `stream` and returns the
// first error: of the tensor maps, the shared-memory attribute or the launch
// (bf16), else cudaGetLastError() (cudaErrorInvalidValue for what it was not
// built for).
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
  const int nout = bm == kRows ? nout_for(d, bf) : 0;
  int rc;
  if (nout == 256)
    rc = launch_bf16<256>(dy, wide, w1, w2, out, m, d, ff, bf, s);
  else if (nout == 128)
    rc = launch_bf16<128>(dy, wide, w1, w2, out, m, d, ff, bf, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return rc ? rc : static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of the bf16 launch at width d with the tile
// (rows, cluster), 0 for a tile it was not built for or that does not fit:
// what kernels/mlp_bwd.py::plan says.
extern "C" int missm_mlp_bwd_smem(int d, int rows, int cluster) {
  const int nout = rows == kRows ? nout_for(d, cluster) : 0;
  if (!nout) return 0;
  const int stages = stages_for(cluster, nout);
  return stages >= 2 ? smem_bytes(cluster, nout, stages) : 0;
}

// How many clusters of `cluster` blocks of the bf16 kernel with NOUT = nout
// (128 or 256) and `smem` bytes the card runs at once: what
// kernels/mlp_bwd.py::ACTIVE_CLUSTERS says for an H100.
extern "C" int missm_mlp_bwd_active_clusters(int nout, int cluster, int smem) {
  if (nout != 128 && nout != 256) return -static_cast<int>(cudaErrorInvalidValue);
  return nout == 256
             ? active_clusters(mlp_bwd_dx_bf16<256>, kBf16Threads, smem, cluster)
             : active_clusters(mlp_bwd_dx_bf16<128>, kBf16Threads, smem, cluster);
}
