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
// at that shape).
//
// What held the first design back (1.50-1.52 ms at that shape, 9 % of the
// bound, 6x F.layer_norm + F.linear): mma.sync on 64 x 128 tiles of one
// 4-warp block, 32 of D a step loaded with plain 16-byte loads between two
// barriers (no ring, no asynchronous copy), and statistics taken by every
// column block of a row tile, two passes each before the main loop read the
// rows a third time: 96 reads of the 33.7 MB x (3.2 GB from L2) for one
// product; gamma and beta read from device memory per element through a
// branch on their type.
//
// The bf16 kernel now:
//  - one block owns a row tile of 128 rows: two consumer warpgroups (64 rows
//    each, wgmma's M) and a producer warpgroup, its registers handed to the
//    consumers (setmaxnreg). One producer thread keeps a ring of `stages`
//    stages in flight by TMA, each the raw x tile [128, 64] and the W tile
//    [64, BN] (128B swizzle, zero rows past M, both kept in L2 with an
//    evict-last policy: later column tiles read them again); three producer
//    warps bring each column tile's bias into shared memory as f32;
//  - the block walks the column tiles of its row tile (BN = 256 or 128 wide),
//    so a row tile's statistics are taken once: a cluster of G blocks shares
//    the row tile (block g takes the column tiles g, g + G, ...), each block
//    takes the statistics of 128 / G of its rows (two passes over each row
//    held in registers, one warp two rows) and writes them into the shared
//    memory of every block of the cluster (distributed shared memory, then a
//    cluster barrier);
//  - each consumer thread reads its rows of the raw x tile with ldmatrix
//    from the swizzled stage, normalises them in f32 ((x rstd - mean rstd)
//    gamma + beta, two FMAs, gamma and beta held in shared memory as f32),
//    rounds once to bf16 and issues wgmma m64nBNk16 with A from registers and
//    W MN-major as stored (one product spans the BN / 64 swizzled chunks, the
//    descriptor's leading offset the chunk stride): the normalised activation
//    never leaves the registers. A stage's products stay in flight while the
//    next stage is normalised (two register operands, wgmma.wait_group 1);
//  - the epilogue adds the bias in f32, rounds once and stages the tile in
//    shared memory as the output map's swizzled boxes; TMA stores it (rows
//    past M are not written, an evict-first policy keeps y from pushing x out
//    of L2) while the next column tile's products run.
// kernels/ln_linear.py::plan picks BN and G for the fewest waves of clusters
// (from the card's active-cluster counts) times column tiles a block, and
// the stages that fit beside the staging tile (G = 1, BN = 256, 3 stages at
// the eval image shape: 129 blocks of 16 column tiles; the ragged train text
// [1232, 768] -> 3072 takes BN = 128, G = 8); missm_ln_linear_plan says the
// same.
//
// What bounds it now (PERF.md section 6, PR 9): the (x, W) stages, 1.6 GB
// from L2 at the eval image shape (x read once per column tile, W once per
// row tile); variants of this kernel that skip the products and the
// normalisation take about as long as F.layer_norm + F.linear. Measured and
// dropped, each slower or no faster in one call on the card: two blocks on
// neighbouring row tiles sharing each W tile by TMA multicast (halves W's
// L2 traffic, but each stage then waits for both blocks' consumers); separate
// x and W rings (x released once normalised) with deeper rings; two
// stages; four stages without the staging tile (stores straight from the
// accumulators);
// 128-wide tiles at the eval image shape; one producer warp instead of a
// warpgroup without setmaxnreg; the products waited for each stage. ptxas
// allocates the kernel at most 168 registers a thread (in spite of
// setmaxnreg), a few short of the 256-wide tile's consumers (128
// accumulators and two register operands of 16): it spills 16 bytes.
//
//  - f32: CUDA cores, a 64 x 64 tile per block of 256 threads, 4 x 4 outputs
//    per thread, full f32 FMAs; each block takes its 64 rows' statistics.
//  - Ragged M: M need only be a multiple of 8 (a train microbatch's 16 * 77 =
//    1232 text rows); rows past M are zero (bf16: TMA's fill) and not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float to_f32(float v) { return v; }

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
// bf16: wgmma with the normalised x as the register operand, TMA ring
// ---------------------------------------------------------------------------

constexpr int kBM = 128;         // rows of a row tile: two consumer warpgroups
constexpr int kBK = 64;          // depth of a stage: one 128-byte swizzled row
constexpr int kConsumerThreads = 256;
constexpr int kThreads = kConsumerThreads + 128;  // + the producer warpgroup
constexpr int kMaxStages = 4;  // 3 fit beside the staging tile at BN = 256
constexpr int kMaxCluster = 8;
constexpr int kSmemLimit = 232448;

__host__ __device__ constexpr int stage_bytes(int bn) {
  return kBM * kBK * 2 + kBK * bn * 2;
}

// The aligned ring, the output staging tile [128, BN], gamma and beta as
// f32, the row tile's mean and rstd, the bias of two column tiles as f32,
// and the barriers: a full and an empty one a stage and a full and an empty
// one a bias buffer (kernels/ln_linear.py::plan mirrors it).
constexpr int smem_bytes(int d, int bn, int stages) {
  return 1024 + stages * stage_bytes(bn) + kBM * bn * 2 + 8 * d + 8 * kBM +
         8 * bn + 8 * (2 * stages + 4);
}

// A cluster is `groups` blocks sharing a row tile: block g walks the column
// tiles g, g + groups, ...
struct Plan {
  int bn, groups, stages, smem;  // smem 0: the launch does not fit
};

// Clusters of g blocks (one an SM) that an H100 runs at once, from
// cudaOccupancyMaxActiveClusters on the card (missm_ln_linear_active_clusters):
// a cluster stays within a GPC, so clusters of 3, 4, 6 and 8 leave SMs idle.
// Sizes 5 and 7 are not taken.
constexpr int kActive[kMaxCluster + 1] = {0, 132, 66, 39, 30, 0, 17, 0, 15};

// The column tile width and groups that finish soonest: the fewest waves
// of clusters times the column tiles a block walks, times their width
// (ties: the wider tile, the fewer groups); then the most stages that fit,
// at least 2.
Plan plan_for(int m, int d, int f) {
  Plan p = {0, 0, 0, 0};
  long best = -1;
  const int row_tiles = (m + kBM - 1) / kBM;
  for (int bn = 256; bn >= 128; bn -= 128) {
    if (f % bn) continue;
    const int cols = f / bn;
    for (int g = 1; g <= kMaxCluster && g <= cols; ++g) {
      if (!kActive[g]) continue;
      const long waves = (row_tiles + kActive[g] - 1) / kActive[g];
      const long cost = waves * ((cols + g - 1) / g) * bn;
      if (best < 0 || cost < best) {
        best = cost;
        p.bn = bn;
        p.groups = g;
      }
    }
  }
  int stages = kMaxStages;
  while (stages >= 2 && smem_bytes(d, p.bn, stages) > kSmemLimit) --stages;
  p.stages = stages;
  p.smem = stages >= 2 ? smem_bytes(d, p.bn, stages) : 0;
  return p;
}

__device__ __forceinline__ float lo_bf16(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// (x rs + c) g + b on a bf16 pair (c = -mean rs: x - mean scaled in one
// FMA), rounded back to a bf16 pair; gb = (g_k, g_k+1, b_k, b_k+1).
__device__ __forceinline__ uint32_t normalise(uint32_t raw, float rs, float c,
                                              float4 gb) {
  return pack_bf16(fmaf(fmaf(lo_bf16(raw), rs, c), gb.x, gb.z),
                   fmaf(fmaf(hi_bf16(raw), rs, c), gb.y, gb.w));
}

// Mean and rstd of two rows of x [m, d] (rows past m: 0 and 0), one warp:
// both rows' loads are issued before either is summed, and rows up to
// d = 1024 are read once (in registers for both passes).
__device__ __forceinline__ void two_row_stats(const __nv_bfloat16* x, int row0,
                                              int row1, int m, int d,
                                              float eps, float mean[2],
                                              float rstd[2]) {
  constexpr int kVec = 4;  // uint4 a lane: 1024 columns a row
  const int lane = threadIdx.x & 31;
  const int rows[2] = {row0, row1};
  uint4 v[2][kVec];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int c = lane + 32 * i;
      v[r][i] = rows[r] < m && c < d / 8
                    ? reinterpret_cast<const uint4*>(x + (size_t)rows[r] * d)[c]
                    : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)rows[r] * d);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const uint32_t w[4] = {v[r][i].x, v[r][i].y, v[r][i].z, v[r][i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) s += lo_bf16(w[j]) + hi_bf16(w[j]);
    }
    if (rows[r] < m)
      for (int c = lane + 32 * kVec; c < d / 8; c += 32) {
        const uint4 u = xr[c];
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) s += lo_bf16(w[j]) + hi_bf16(w[j]);
      }
    const float mu = warp_sum(s) / d;
    float var = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (lane + 32 * i >= d / 8) break;
      const uint32_t w[4] = {v[r][i].x, v[r][i].y, v[r][i].z, v[r][i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float a = lo_bf16(w[j]) - mu, b = hi_bf16(w[j]) - mu;
        var = fmaf(a, a, fmaf(b, b, var));
      }
    }
    if (rows[r] < m)
      for (int c = lane + 32 * kVec; c < d / 8; c += 32) {
        const uint4 u = xr[c];
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float a = lo_bf16(w[j]) - mu, b = hi_bf16(w[j]) - mu;
          var = fmaf(a, a, fmaf(b, b, var));
        }
      }
    mean[r] = rows[r] < m ? mu : 0.f;
    rstd[r] = rows[r] < m ? 1.f / sqrtf(warp_sum(var) / d + eps) : 0.f;
  }
}

// One stage of a consumer warpgroup: its 64 rows of the raw x tile at xs
// (ldmatrix, this lane's row lrow and 8-column half lhalf) normalised into
// the register operand a, then acc (+)= a . W issued and committed (W MN-major
// after the x tile). gb4[k / 2] holds gamma and beta of columns k, k + 1.
template <int BN>
__device__ __forceinline__ void stage_products(float* acc, uint32_t (&a)[4][4],
                                               uint32_t xs, const float4* gb4,
                                               int k0, int lrow, int lhalf,
                                               const float rs[2],
                                               const float c[2], bool first) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t raw[4];
    ldmatrix_x4(raw, xs + swz128(lrow, 2 * kk + lhalf));
    const int k2 = (k0 + 16 * kk) / 2 + t;
    const float4 lo = gb4[k2], hi = gb4[k2 + 4];
    a[kk][0] = normalise(raw[0], rs[0], c[0], lo);
    a[kk][1] = normalise(raw[1], rs[1], c[1], lo);
    a[kk][2] = normalise(raw[2], rs[0], c[0], hi);
    a[kk][3] = normalise(raw[3], rs[1], c[1], hi);
  }
  fence_regs<4>(a);
  fence_regs<BN / 2>(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<BN>(acc, a[kk], mnmajor128(xs + kBM * kBK * 2, kBK, kk),
                 !first || kk > 0);
  wgmma_commit();
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
ln_linear_bf16(const __grid_constant__ CUtensorMap tx,
               const __grid_constant__ CUtensorMap tw,
               const __grid_constant__ CUtensorMap ty,
               const __nv_bfloat16* __restrict__ x,
               const void* __restrict__ gamma, const void* __restrict__ beta,
               const void* __restrict__ bias, int m, int d, int f, int stages,
               int groups, int vec_bf16, int bias_bf16, float eps) {
  constexpr int kXBytes = kBM * kBK * 2;
  constexpr int kStage = stage_bytes(BN);
  constexpr int kOutBytes = 64 * BN * 2;  // a consumer warpgroup's output
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  uint8_t* out_s = smem + stages * kStage;                 // [2][64, BN]
  float4* gb4 = reinterpret_cast<float4*>(out_s + 2 * kOutBytes);
  float* stats = reinterpret_cast<float*>(gb4 + d / 2);   // mean, rstd
  float* bias_s = stats + 2 * kBM;                          // [2][BN]
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_s + 2 * BN);
  uint64_t* empty = full + stages;
  uint64_t* bias_full = empty + stages;  // [2]
  uint64_t* bias_empty = bias_full + 2;  // [2]

  const uint32_t rank = cluster_rank();
  const int g = (int)rank;  // this block's column group
  const int m0 = (blockIdx.x / groups) * kBM;
  const int tiles = (f / BN - g + groups - 1) / groups;
  const int ksteps = d / kBK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool has_bias = bias != nullptr;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 2);  // one arrival a consumer warpgroup
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(bias_full + i, 96);  // the producer warpgroup's other warps
      mbar_init(bias_empty + i, 2);
    }
    mbar_fence_init();
  }
  for (int i = threadIdx.x; i < d / 2; i += kThreads)
    gb4[i] = make_float4(vec_at(gamma, 2 * i, vec_bf16),
                         vec_at(gamma, 2 * i + 1, vec_bf16),
                         vec_at(beta, 2 * i, vec_bf16),
                         vec_at(beta, 2 * i + 1, vec_bf16));
  __syncthreads();
  cluster_sync();  // every block of the cluster runs: its shared memory exists

  if (warp >= kConsumerThreads / 32) {
    // producer warpgroup: one thread streams (x, W) stages through the ring,
    // the other three warps the bias of each column tile as f32
    regs_dealloc<24>();
    cluster_arrive();
    if (threadIdx.x == kConsumerThreads) {
      // x and W are read again by later column tiles: kept in L2
      const uint64_t keep = policy_evict_last();
      int it = 0;
      for (int i = 0; i < tiles; ++i) {
        const int n0 = (g + i * groups) * BN;
        for (int kt = 0; kt < ksteps; ++kt, ++it) {
          const int s = it % stages;
          if (it >= stages) mbar_wait(empty + s, (it / stages - 1) & 1);
          uint8_t* st = smem + s * kStage;
          mbar_expect(full + s, kStage);
          tma_load_hint(st, &tx, full + s, kt * kBK, m0, 0, keep);
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            tma_load_hint(st + kXBytes + c * kBK * 128, &tw, full + s,
                          n0 + 64 * c, kt * kBK, 0, keep);
        }
      }
    } else if (warp > kConsumerThreads / 32 && has_bias) {
      const int tid = threadIdx.x - kConsumerThreads - 32;
      for (int i = 0; i < tiles; ++i) {
        const int n0 = (g + i * groups) * BN;
        if (i >= 2) mbar_wait(bias_empty + (i & 1), ((i >> 1) - 1) & 1);
        for (int c = tid; c < BN; c += 96)
          bias_s[(i & 1) * BN + c] = vec_at(bias, n0 + c, bias_bf16);
        mbar_arrive(bias_full + (i & 1));
      }
    }
    __syncwarp();
    cluster_wait();
    return;
  }

  regs_alloc<240>();
  {
    // consumers: this block's share of the row tile's statistics, two rows
    // a warp at a time, into every block of the cluster
    const int share = (kBM + groups - 1) / groups;
    const int r_begin = min(kBM, g * share);
    const int r_end = min(kBM, r_begin + share);
    for (int r = r_begin + warp; r < r_end; r += 16) {
      const int r1 = min(r + 8, r_end - 1);  // a repeat where the share ends
      float mean[2], rstd[2];
      two_row_stats(x, m0 + r, m0 + r1, m, d, eps, mean, rstd);
      if (lane < groups) {
        st_cluster(mapa(smem_u32(stats + r), lane), mean[0]);
        st_cluster(mapa(smem_u32(stats + kBM + r), lane), rstd[0]);
        st_cluster(mapa(smem_u32(stats + r1), lane), mean[1]);
        st_cluster(mapa(smem_u32(stats + kBM + r1), lane), rstd[1]);
      }
    }
  }
  cluster_arrive();
  cluster_wait();

  const int wg = warp >> 2;
  const int t = lane & 3;
  const int rw = (warp & 3) * 16 + (lane >> 2);  // rows rw, rw + 8 of the warpgroup's 64
  const int r0 = wg * 64 + rw;
  const float rs[2] = {stats[kBM + r0], stats[kBM + r0 + 8]};
  const float c[2] = {-stats[r0] * rs[0], -stats[r0 + 8] * rs[1]};
  // the row whose address this lane gives ldmatrix, and its 8-column half
  const int lrow = wg * 64 + (warp & 3) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lhalf = lane >> 4;
  const bool leader = (warp & 3) == 0 && lane == 0;
  const uint32_t ring = smem_u32(smem);
  uint8_t* out_wg = out_s + wg * kOutBytes;
  int it = 0;
  for (int i = 0; i < tiles; ++i) {
    const int n0 = (g + i * groups) * BN;
    float acc[BN / 2];
    uint32_t a0[4][4], a1[4][4];  // the operands of two stages in flight
    for (int kt = 0; kt < ksteps; ++kt, ++it) {
      const int s = it % stages;
      mbar_wait(full + s, (it / stages) & 1);
      const uint32_t xs = ring + s * kStage;
      // stage kt's products stay in flight while stage kt + 1 is normalised
      if (kt & 1) {
        stage_products<BN>(acc, a1, xs, gb4, kt * kBK, lrow, lhalf, rs, c, false);
        wgmma_wait_n<1>();
        fence_regs<4>(a0);
      } else {
        stage_products<BN>(acc, a0, xs, gb4, kt * kBK, lrow, lhalf, rs, c, kt == 0);
        wgmma_wait_n<1>();
        fence_regs<4>(a1);
      }
      // stage kt - 1's products are complete (and every warp of the
      // warpgroup has issued them, so its ldmatrix reads are done)
      if (kt > 0 && leader) mbar_arrive(empty + (it - 1) % stages);
    }
    wgmma_wait();
    fence_regs<BN / 2>(acc);
    if (leader) mbar_arrive(empty + (it - 1) % stages);

    // epilogue: + bias in f32, rounded once, staged swizzled as the output
    // map's boxes and stored by TMA (rows past m are not written) while the
    // next tile's products run
    if (has_bias) mbar_wait(bias_full + (i & 1), (i >> 1) & 1);
    if (leader) bulk_wait<true>();  // the last tile's store has read out_wg
    bar_sync(1 + wg, 128);
    const float* bt = bias_s + (i & 1) * BN;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 b = has_bias ? *reinterpret_cast<const float2*>(bt + 8 * j + 2 * t)
                                : make_float2(0.f, 0.f);
      uint8_t* chunk = out_wg + (j / 8) * 64 * 128 + 4 * t;
      *reinterpret_cast<uint32_t*>(chunk + swz128(rw, j % 8)) =
          pack_bf16(acc[4 * j] + b.x, acc[4 * j + 1] + b.y);
      *reinterpret_cast<uint32_t*>(chunk + swz128(rw + 8, j % 8)) =
          pack_bf16(acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y);
    }
    fence_async_smem();
    bar_sync(1 + wg, 128);
    if (leader) {
      if (has_bias) mbar_arrive(bias_empty + (i & 1));
      // y is written once: evicted first, so that it does not push x out
      const uint64_t once = policy_evict_first();
#pragma unroll
      for (int q = 0; q < BN / 64; ++q)
        tma_store_hint(&ty, out_wg + q * 64 * 128, n0 + 64 * q, m0 + 64 * wg,
                       0, once);
      bulk_commit();
    }
  }
  if (leader) bulk_wait<false>();
}

template <int BN>
int launch_bf16(const void* x, const void* gamma, const void* beta,
                const void* w, const void* bias, void* y, int m, int d, int f,
                int vec_bf16, int bias_bf16, float eps, const Plan& p,
                cudaStream_t stream) {
  CUtensorMap tx, tw, ty;
  int rc = encode_rows(&tx, x, 1, m, d, kBM, kBK);
  if (!rc) rc = encode_rows(&tw, w, 1, d, f, kBK, 64);
  if (!rc) rc = encode_rows(&ty, y, 1, m, f, 64, 64);
  auto kernel = ln_linear_bf16<BN>;
  static unsigned long long attr_set = 0;
  if (!rc) rc = allow_smem(kernel, kSmemLimit, attr_set);
  if (rc) return rc;
  const int grid = (m + kBM - 1) / kBM * p.groups;
  return launch_cluster(kernel, grid, kThreads, p.smem, stream, p.groups, tx,
                        tw, ty, static_cast<const __nv_bfloat16*>(x), gamma,
                        beta, bias, m, d, f, p.stages, p.groups, vec_bf16,
                        bias_bf16, eps);
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
void launch_f32(const void* x, const void* gamma, const void* beta,
                const void* w, const void* bias, void* y, int m, int d, int f,
                int vec_bf16, int bias_bf16, float eps, cudaStream_t stream) {
  const dim3 grid(f / kF32BN, (m + kF32BM - 1) / kF32BM);
  ln_linear_f32<HAS_BIAS><<<grid, kF32Threads, 0, stream>>>(
      static_cast<const float*>(x), gamma, beta, static_cast<const float*>(w),
      bias, static_cast<float*>(y), m, d, f, vec_bf16, bias_bf16, eps);
}

}  // namespace

// x [m, d], w [d, f] and y [m, f]: contiguous, 16-byte aligned, bf16
// (is_bf16 = 1) or f32. gamma, beta [d] and bias [f] (or null): contiguous,
// bf16 (vec_bf16 / bias_bf16 = 1) or f32. d and f multiples of 128, any m >
// 0. Launches on `stream` and returns the first error: of the tensor maps,
// the shared-memory attribute or the launch (bf16), else cudaGetLastError()
// (cudaErrorInvalidValue for shapes it does not take).
extern "C" int missm_ln_linear_forward(const void* x, const void* gamma,
                                       const void* beta, const void* w,
                                       const void* bias, void* y, int m, int d,
                                       int f, int is_bf16, int vec_bf16,
                                       int bias_bf16, float eps, void* stream) {
  if (m <= 0 || d <= 0 || f <= 0 || d % 128 || f % 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const Plan p = plan_for(m, d, f);
    if (!p.smem) return static_cast<int>(cudaErrorInvalidValue);
    const int rc =
        p.bn == 256
            ? launch_bf16<256>(x, gamma, beta, w, bias, y, m, d, f, vec_bf16, bias_bf16, eps, p, s)
            : launch_bf16<128>(x, gamma, beta, w, bias, y, m, d, f, vec_bf16, bias_bf16, eps, p, s);
    return rc ? rc : static_cast<int>(cudaGetLastError());
  }
  if (bias)
    launch_f32<true>(x, gamma, beta, w, bias, y, m, d, f, vec_bf16, bias_bf16, eps, s);
  else
    launch_f32<false>(x, gamma, beta, w, bias, y, m, d, f, vec_bf16, bias_bf16, eps, s);
  return static_cast<int>(cudaGetLastError());
}

// What the bf16 launch at [m, d] -> f computes, into out[4]: the column
// tile width, the cluster (groups), the stages and the dynamic shared memory
// (0 where it does not fit): what kernels/ln_linear.py::plan says. Returns
// out[3].
extern "C" int missm_ln_linear_plan(int m, int d, int f, int* out) {
  const Plan p = plan_for(m, d, f);
  out[0] = p.bn;
  out[1] = p.groups;
  out[2] = p.stages;
  out[3] = p.smem;
  return p.smem;
}

// The dynamic shared memory of the bf16 launch at [m, d] -> f.
extern "C" int missm_ln_linear_smem(int m, int d, int f) {
  return plan_for(m, d, f).smem;
}

// How many clusters of `groups` blocks of the bf16 kernel with column tiles
// of bn (128 or 256) and `smem` bytes the card runs at once: what
// kernels/ln_linear.py::ACTIVE_CLUSTERS says for an H100.
extern "C" int missm_ln_linear_active_clusters(int bn, int groups, int smem) {
  if (bn != 128 && bn != 256) return -static_cast<int>(cudaErrorInvalidValue);
  return bn == 256 ? active_clusters(ln_linear_bf16<256>, kThreads, smem, groups)
                   : active_clusters(ln_linear_bf16<128>, kThreads, smem, groups);
}
