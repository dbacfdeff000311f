// Whole-row attention forwards of the two TPU timing probes, for Hopper
// (sm_90a), plain C interface.
//
// Replaces the four Pallas TPU kernels of scripts/:
//   P1  attn_probe.py:47 make_fused(group): softmax(q k^T hd^-0.5) v per
//       head-major slice [B*H, N, hd], the softmax over the whole row, keys
//       past N (the TPU pads 257 to 264) carrying no weight.
//   P2  ablation_probe.py:84 make_tower_bhne(group): the same on
//       [B, H, N, hd], which is P1's layout with B*H slices.
//   P3  ablation_probe.py:152 make_tower_scratch(): the same on
//       [B, N, H*hd], one program per batch row over all H heads, each
//       head's slices staged into scratch.
//   P4  ablation_probe.py:210 make_tower_packed_debug(mode): the production
//       kernel's rounding order (exp(s - m) rounded to the input type
//       unnormalised, P.V divided by the row sum afterwards) on [B, N, H*hd],
//       with the knock-outs noexp (e = s - m, den = sum(s - m)), dotsonly
//       (e = s, den = 1) and nostage (full, the operands not staged).
// The head-pair packing of P4 (two 64-wide heads under a lane mask in one
// 128-lane row) only fills the TPU's lanes: each head's result is its own
// softmax attention, so here every block works on one head.
//
// Math: s = (q . k) * hd^-0.5 in f32, then per row m = max(s) and e as the
// mode says. P1-P3 divide before rounding: p = (e / sum(e)) rounded to the
// input type; P4 rounds e and divides P.V by den in f32. P.V accumulates in
// f32; the output has the input type.
//
// Layout: q, k, v and out are [B, N, H*hd]; slice (b, head) is rows of
// pitch H*hd starting at column head*hd. The head-major [G, N, hd] of P1
// and P2 is the same with H = 1.
//
// Design. Every block keeps the full [rows, N] f32 score rows of its query
// tile in shared memory, so the row max and sum are exact before P.V, as
// the TPU kernels have them; this is what lets noexp's sum(s - m) exist at
// all (an online softmax cannot rescale it). bf16 products run on the
// tensor cores (mma.sync m16n8k16, f32 accumulators; one warp per 16 query
// rows). The C fragment of Q K^T that a thread holds is exactly the part
// of P it later needs as an A fragment of P V, so each thread stores its
// own scores (one float4 per 8-key tile) and reads back no other thread's:
// no barrier or shuffle across a row beyond the quad that shares it. Per
// query tile: S = Q K^T key tile by key tile into shared memory while each
// thread keeps its rows' running max; the quad's max; for P1-P3 a pass
// over the stored scores for the row sums; then O = P V key tile by key
// tile, e computed from the stored score as it becomes the A fragment (and,
// for P4, summed there). f32 inputs take a CUDA-core path (4 threads per
// query row, the row's scores in shared memory) that keeps full f32
// precision.
//   - The whole-row kernel (P1, P2, P4): one block per (query tile, slice).
//     K and V tiles of 64 keys pass through shared memory between two
//     barriers (staged), or, for nostage, the mma fragments load straight
//     from device memory. Query rows per block are a template parameter
//     (16, 32, 64 or 128), P1's sweep; the scores take rows * N16 * 4
//     bytes (N16 = N rounded up to 16), 68 KB at 64 rows and N = 257.
//   - The batch-row kernel (P3): one block per batch row, B blocks, as the
//     TPU's grid (B,). It loops over the H heads, stages each head's whole
//     [N, hd] K and V into shared memory, then walks the head's query tiles
//     of 64 rows. At B = 64 it fills at most 64 of the card's 132 SMs.
//
// What bounds it on this card: at the probes' shapes (1024 slices of
// [257, 64]) the function moves 134.7 MB (q, k, v read once, out written
// once) and does 17.3 GFLOP: 0.040 ms at 3.35 TB/s against 0.018 ms at 989
// TFLOP/s, so bytes. The score rows never reach device memory; K and V are
// re-read once per query tile of their slice, mostly from L2. No wgmma, TMA
// or cp.async pipelining yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

enum Mode { kFull = 0, kNoExp = 1, kDotsOnly = 2 };

constexpr int kHD = 64;             // the probes' head dim (ViT-L/14)
constexpr int kLD = kHD + 8;        // shared-memory pitch of a bf16 tile row
constexpr int kKeys = 64;           // keys per bf16 K/V tile
constexpr int kSteps = kHD / 16;    // k-steps of Q.K^T
constexpr int kOTiles = kHD / 8;    // 8-column output tiles
constexpr int kF32Rows = 32;        // f32: query rows per block (128 threads)
constexpr int kF32Keys = 32;        // f32: keys per staged K/V tile
constexpr int kR = kHD / 4;         // f32: dims per thread
constexpr int kMaxSmem = 232448;    // a block's shared memory on sm_90
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> packed bf16x2 (round to nearest even), the lower column in
// the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t join_bf16(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// The bf16 pair at (row, col), col even, of a [rows, *] source with pitch
// ld: a staged tile in shared memory (SMEM; rows past the data were stored
// as zeros) or device memory, where rows at or past `valid` read as zero.
template <bool SMEM>
__device__ __forceinline__ uint32_t pair_at(const bf16* src, int row, int col,
                                            int ld, int valid) {
  if (!SMEM && row >= valid) return 0u;
  return *reinterpret_cast<const uint32_t*>(src + (size_t)row * ld + col);
}

// One bf16 element's bits, as pair_at.
template <bool SMEM>
__device__ __forceinline__ uint16_t bits_at(const bf16* src, int row, int col,
                                            int ld, int valid) {
  if (!SMEM && row >= valid) return 0;
  return reinterpret_cast<const uint16_t*>(src)[(size_t)row * ld + col];
}

// Rows [row0, row0 + rows) of one [n, kHD] slice (row pitch d) into shared
// memory with pitch kLD; rows at or past n are zero.
__device__ void load_rows(bf16* dst, const bf16* src, int row0, int rows,
                          int n, int d) {
  constexpr int kChunks = kHD / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < rows * kChunks; c += blockDim.x) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * d + col);
    *reinterpret_cast<uint4*>(dst + r * kLD + col) = val;
  }
}

// A fragments of this warp's query rows r0 and r0 + 8 of `src`.
template <bool SMEM>
__device__ void q_frags(uint32_t qf[kSteps][4], const bf16* src, int r0,
                        int ld, int valid) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const int col = kk * 16 + 2 * t;
    qf[kk][0] = pair_at<SMEM>(src, r0, col, ld, valid);
    qf[kk][1] = pair_at<SMEM>(src, r0 + 8, col, ld, valid);
    qf[kk][2] = pair_at<SMEM>(src, r0, col + 8, ld, valid);
    qf[kk][3] = pair_at<SMEM>(src, r0 + 8, col + 8, ld, valid);
  }
}

// e of one score at column col: exp(s - m), s - m or s as MODE says below
// n, 0 at or past n.
template <int MODE>
__device__ __forceinline__ float weight(float s, float m, int col, int n) {
  if (col >= n) return 0.f;
  return MODE == kFull ? expf(s - m) : MODE == kNoExp ? s - m : s;
}

__device__ __forceinline__ void quad_max(float& a, float& b) {
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    a = fmaxf(a, __shfl_xor_sync(kAll, a, off));
    b = fmaxf(b, __shfl_xor_sync(kAll, b, off));
  }
}

__device__ __forceinline__ void quad_sum(float& a, float& b) {
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    a += __shfl_xor_sync(kAll, a, off);
    b += __shfl_xor_sync(kAll, b, off);
  }
}

// Score storage: the C fragment of one 8-key tile of Q K^T (rows g and
// g + 8, columns 2t and 2t + 1) is exactly what this thread later needs of
// P as an A fragment of P V, so each thread stores its own 4 scores of each
// tile as one float4 at wsc[tile * 32 + lane] (a warp's 16 rows x ns keys)
// and reads back nothing of any other thread's.

// Scaled scores of this warp's 16 query rows against keys [k0, k0 + kKeys)
// below ns into wsc, -inf at keys at or past n, and the running row maxima
// m0 (row g) and m1 (row g + 8) of this thread's columns. `src` holds key
// k0 of K as its row 0.
template <bool SMEM>
__device__ void score_tile(const uint32_t qf[kSteps][4], const bf16* src,
                           int ld, int valid, float4* wsc, int k0, int n,
                           int ns, float scale, float& m0, float& m1) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
    if (k0 + j * 8 < ns) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
        mma_bf16(s, qf[kk],
                 pair_at<SMEM>(src, j * 8 + g, kk * 16 + 2 * t, ld, valid),
                 pair_at<SMEM>(src, j * 8 + g, kk * 16 + 2 * t + 8, ld, valid));
      const int col = k0 + j * 8 + 2 * t;
      const float4 v = make_float4(col < n ? s[0] * scale : -INFINITY,
                                   col + 1 < n ? s[1] * scale : -INFINITY,
                                   col < n ? s[2] * scale : -INFINITY,
                                   col + 1 < n ? s[3] * scale : -INFINITY);
      wsc[((k0 >> 3) + j) * 32 + lane] = v;
      m0 = fmaxf(m0, fmaxf(v.x, v.y));
      m1 = fmaxf(m1, fmaxf(v.z, v.w));
    }
  }
}

// The row sums l0, l1 of e over all nt stored tiles, for the kernels that
// divide before rounding P.
template <int MODE>
__device__ void row_sums(const float4* wsc, int nt, float m0, float m1, int n,
                         float& l0, float& l1) {
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  l0 = l1 = 0.f;
  for (int tile = 0; tile < nt; ++tile) {
    const float4 v = wsc[tile * 32 + lane];
    const int col = tile * 8 + 2 * t;
    l0 += weight<MODE>(v.x, m0, col, n) + weight<MODE>(v.y, m0, col + 1, n);
    l1 += weight<MODE>(v.z, m1, col, n) + weight<MODE>(v.w, m1, col + 1, n);
  }
  quad_sum(l0, l1);
}

// O += P V over keys [k0, k0 + kKeys) below ns for this warp's 16 rows.
// P = e rounded to bf16, e from the stored scores; AFTER adds e to this
// thread's row sums l0, l1, else P = e / d0 (row g) or e / d1 (row g + 8).
// `src` holds key k0 of V as its row 0.
template <int MODE, bool AFTER, bool SMEM>
__device__ void pv_tile(float o[kOTiles][4], const float4* wsc, float m0,
                        float m1, float d0, float d1, float& l0, float& l1,
                        const bf16* src, int ld, int valid, int k0, int n,
                        int ns) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    const int key = k0 + kk * 16;
    if (key < ns) {
      const float4 lo = wsc[(key >> 3) * 32 + lane];       // keys key + 2t..
      const float4 hi = wsc[((key >> 3) + 1) * 32 + lane]; // keys key + 8 + 2t..
      const int c = key + 2 * t;
      float e[8] = {weight<MODE>(lo.x, m0, c, n), weight<MODE>(lo.y, m0, c + 1, n),
                    weight<MODE>(lo.z, m1, c, n), weight<MODE>(lo.w, m1, c + 1, n),
                    weight<MODE>(hi.x, m0, c + 8, n), weight<MODE>(hi.y, m0, c + 9, n),
                    weight<MODE>(hi.z, m1, c + 8, n), weight<MODE>(hi.w, m1, c + 9, n)};
      if (AFTER) {
        l0 += (e[0] + e[1]) + (e[4] + e[5]);
        l1 += (e[2] + e[3]) + (e[6] + e[7]);
      } else {
        e[0] /= d0; e[1] /= d0; e[4] /= d0; e[5] /= d0;
        e[2] /= d1; e[3] /= d1; e[6] /= d1; e[7] /= d1;
      }
      uint32_t a[4];
      a[0] = pack_bf16(e[0], e[1]);
      a[1] = pack_bf16(e[2], e[3]);
      a[2] = pack_bf16(e[4], e[5]);
      a[3] = pack_bf16(e[6], e[7]);
      const int kr = kk * 16 + 2 * t;
#pragma unroll
      for (int j = 0; j < kOTiles; ++j) {
        const int col = j * 8 + g;
        const uint32_t b0 = join_bf16(bits_at<SMEM>(src, kr, col, ld, valid),
                                      bits_at<SMEM>(src, kr + 1, col, ld, valid));
        const uint32_t b1 = join_bf16(bits_at<SMEM>(src, kr + 8, col, ld, valid),
                                      bits_at<SMEM>(src, kr + 9, col, ld, valid));
        mma_bf16(o[j], a, b0, b1);
      }
    }
  }
}

// This warp's output rows r0 and r0 + 8 of `out` (row 0 = the tile's first
// query, pitch d), each divided by its den, where the row is below `valid`.
__device__ void store_rows(bf16* out, const float o[kOTiles][4], int r0,
                           int valid, int d, float den0, float den1) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < kOTiles; ++j) {
    const int col = j * 8 + 2 * t;
    if (r0 < valid)
      *reinterpret_cast<uint32_t*>(out + (size_t)r0 * d + col) =
          pack_bf16(o[j][0] / den0, o[j][1] / den0);
    if (r0 + 8 < valid)
      *reinterpret_cast<uint32_t*>(out + (size_t)(r0 + 8) * d + col) =
          pack_bf16(o[j][2] / den1, o[j][3] / den1);
  }
}

// One query tile's three phases after its scores, for this warp: the row
// maxima, the sums (before-normalising kernels), P V from `v_tile(k0)`
// (which stages or points at key k0 of V and returns (src, ld, valid)), the
// output. Shared by the whole-row and the batch-row kernels.
template <int MODE, bool AFTER, bool SMEM, typename VTile>
__device__ void finish_tile(const float4* wsc, float m0, float m1, int n,
                            int ns, VTile v_tile, bf16* out, int r0,
                            int valid, int d) {
  if (MODE != kDotsOnly) quad_max(m0, m1);
  float d0 = 1.f, d1 = 1.f;
  if (!AFTER) row_sums<MODE>(wsc, ns >> 3, m0, m1, n, d0, d1);
  float l0 = 0.f, l1 = 0.f;
  float o[kOTiles][4];
#pragma unroll
  for (int j = 0; j < kOTiles; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  for (int k0 = 0; k0 < ns; k0 += kKeys) {
    const bf16* src;
    int ld, left;
    v_tile(k0, src, ld, left);
    pv_tile<MODE, AFTER, SMEM>(o, wsc, m0, m1, d0, d1, l0, l1, src, ld, left,
                               k0, n, ns);
  }
  if (AFTER && MODE != kDotsOnly) {
    quad_sum(l0, l1);
  } else {
    l0 = l1 = 1.f;
  }
  store_rows(out, o, r0, valid, d, l0, l1);
}

// ---------------------------------------------------------------------------
// bf16: the whole-row kernel (P1, P2, P4) and the batch-row kernel (P3)
// ---------------------------------------------------------------------------

// Shared memory: the scores, WARPS x [ns / 8 tiles x 32 lanes] float4, then
// (STAGED) one bf16 tile of max(BQ, kKeys) rows for Q, then each K tile,
// then each V tile.
template <int WARPS, int MODE, bool AFTER, bool STAGED>
__global__ void __launch_bounds__(WARPS * 32)
rows_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, bf16* __restrict__ out, int n, int h,
          float scale) {
  constexpr int BQ = WARPS * 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ns = (n + 15) & ~15;  // keys rounded up to whole 16-key steps
  float4* sc = reinterpret_cast<float4*>(smem);
  bf16* buf = reinterpret_cast<bf16*>(sc + WARPS * (ns >> 3) * 32);

  const int d = h * kHD;
  const size_t base =
      (size_t)(blockIdx.y / h) * n * d + (size_t)(blockIdx.y % h) * kHD;
  const int warp = threadIdx.x >> 5;
  const int r0 = warp * 16 + ((threadIdx.x & 31) >> 2);  // tile row
  const int q0 = blockIdx.x * BQ;
  float4* wsc = sc + warp * (ns >> 3) * 32;

  uint32_t qf[kSteps][4];
  if (STAGED) {
    load_rows(buf, q + base, q0, BQ, n, d);
    __syncthreads();
    q_frags<true>(qf, buf, r0, kLD, 0);
  } else {
    q_frags<false>(qf, q + base + (size_t)q0 * d, r0, d, n - q0);
  }

  float m0 = -INFINITY, m1 = -INFINITY;
  for (int k0 = 0; k0 < ns; k0 += kKeys) {
    if (STAGED) {
      __syncthreads();  // every warp is done with the previous tile (or Q)
      load_rows(buf, k + base, k0, kKeys, n, d);
      __syncthreads();
      score_tile<true>(qf, buf, kLD, 0, wsc, k0, n, ns, scale, m0, m1);
    } else {
      score_tile<false>(qf, k + base + (size_t)k0 * d, d, n - k0, wsc, k0, n,
                        ns, scale, m0, m1);
    }
  }
  auto v_tile = [&](int k0, const bf16*& src, int& ld, int& left) {
    if (STAGED) {
      __syncthreads();
      load_rows(buf, v + base, k0, kKeys, n, d);
      __syncthreads();
      src = buf;
      ld = kLD;
      left = 0;
    } else {
      src = v + base + (size_t)k0 * d;
      ld = d;
      left = n - k0;
    }
  };
  finish_tile<MODE, AFTER, STAGED>(wsc, m0, m1, n, ns, v_tile,
                                   out + base + (size_t)q0 * d, r0, n - q0, d);
}

// Shared memory: the scores of 4 warps as rows_bf16's, the head's K and V
// [nk, kLD] bf16 (nk = N rounded up to whole key tiles, zero past N), a Q
// tile [64, kLD].
__global__ void __launch_bounds__(128, 1)
scratch_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ out, int n, int h,
             float scale) {
  constexpr int BQ = 64;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ns = (n + 15) & ~15;
  const int nk = (n + kKeys - 1) / kKeys * kKeys;
  float4* sc = reinterpret_cast<float4*>(smem);
  bf16* ks = reinterpret_cast<bf16*>(sc + 4 * (ns >> 3) * 32);
  bf16* vs = ks + nk * kLD;
  bf16* qs = vs + nk * kLD;

  const int d = h * kHD;
  const int warp = threadIdx.x >> 5;
  const int r0 = warp * 16 + ((threadIdx.x & 31) >> 2);
  float4* wsc = sc + warp * (ns >> 3) * 32;

  for (int head = 0; head < h; ++head) {
    const size_t base = (size_t)blockIdx.x * n * d + (size_t)head * kHD;
    __syncthreads();  // every warp is done with the previous head
    load_rows(ks, k + base, 0, nk, n, d);
    load_rows(vs, v + base, 0, nk, n, d);
    for (int q0 = 0; q0 < n; q0 += BQ) {
      __syncthreads();  // K and V staged; every warp is done with qs
      load_rows(qs, q + base, q0, BQ, n, d);
      __syncthreads();
      uint32_t qf[kSteps][4];
      q_frags<true>(qf, qs, r0, kLD, 0);
      float m0 = -INFINITY, m1 = -INFINITY;
      for (int k0 = 0; k0 < ns; k0 += kKeys)
        score_tile<true>(qf, ks + k0 * kLD, kLD, 0, wsc, k0, n, ns, scale, m0,
                         m1);
      auto v_tile = [&](int k0, const bf16*& src, int& ld, int& left) {
        src = vs + k0 * kLD;
        ld = kLD;
        left = 0;
      };
      finish_tile<kFull, false, true>(wsc, m0, m1, n, ns, v_tile,
                                      out + base + (size_t)q0 * d, r0, n - q0,
                                      d);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, the quad of 4 threads of a query row splitting hd
// ---------------------------------------------------------------------------

// Rows [row0, row0 + rows) of one [n, kHD] f32 slice (pitch d) into shared
// memory with pitch kHD; rows at or past n are zero.
__device__ void load_rows_f32(float* dst, const float* src, int row0, int rows,
                              int n, int d) {
  constexpr int kChunks = kHD / 4;
  for (int c = threadIdx.x; c < rows * kChunks; c += blockDim.x) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n)
      val = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * d + col);
    *reinterpret_cast<float4*>(dst + r * kHD + col) = val;
  }
}

// Scaled scores of this thread's query row against keys [k0, k0 + kn) of
// `src` (key k0 as its row 0, pitch ld), written by part 0 into row[k0 + j].
__device__ void scores_f32(const float qr[kR], const float* src, int ld,
                           int kn, float* row, int k0, float scale) {
  const int part = threadIdx.x & 3;
  for (int j = 0; j < kn; ++j) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kR; ++i)
      s = fmaf(qr[i], src[(size_t)j * ld + part + 4 * i], s);
    // every lane of the quad ends with the same bits (the adds commute)
    s += __shfl_xor_sync(kAll, s, 1);
    s += __shfl_xor_sync(kAll, s, 2);
    if (part == 0) row[k0 + j] = s * scale;
  }
}

// One score row of n keys, by the quad of its 4 threads (`part` of them):
// e as MODE says (weight) in place, and den = sum(e) (1 for dotsonly).
// Without AFTER the row ends as p = e / den and den is 1.
template <int MODE, bool AFTER>
__device__ float softmax_quad(float* row, int n, int part) {
  float m = -INFINITY;
  if (MODE != kDotsOnly) {
    for (int c = part; c < n; c += 4) m = fmaxf(m, row[c]);
    m = fmaxf(m, __shfl_xor_sync(kAll, m, 1));
    m = fmaxf(m, __shfl_xor_sync(kAll, m, 2));
  }
  float sum = 0.f;
  for (int c = part; c < n; c += 4) {
    const float e = weight<MODE>(row[c], m, c, n);
    row[c] = e;
    sum += e;
  }
  if (MODE == kDotsOnly) return 1.f;
  sum += __shfl_xor_sync(kAll, sum, 1);
  sum += __shfl_xor_sync(kAll, sum, 2);
  if (AFTER) return sum;
  for (int c = part; c < n; c += 4) row[c] = row[c] / sum;
  return 1.f;
}

// o += P V over keys [k0, k0 + kn): P from row[k0 + j], V from `src`.
__device__ void pv_f32(float o[kR], const float* row, const float* src, int ld,
                       int kn, int k0) {
  const int part = threadIdx.x & 3;
  for (int j = 0; j < kn; ++j) {
    const float p = row[k0 + j];
#pragma unroll
    for (int i = 0; i < kR; ++i)
      o[i] = fmaf(p, src[(size_t)j * ld + part + 4 * i], o[i]);
  }
}

// Shared memory: scores [32, sp] f32, then (STAGED) a K/V tile [32, kHD].
template <int MODE, bool AFTER, bool STAGED>
__global__ void __launch_bounds__(128)
rows_f32(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, float* __restrict__ out, int n, int h,
         float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int sp = ((n + 31) & ~31) + 4;  // 4 mod 32: a warp's rows on distinct banks
  float* sc = reinterpret_cast<float*>(smem);
  float* buf = sc + kF32Rows * sp;

  const int d = h * kHD;
  const size_t base =
      (size_t)(blockIdx.y / h) * n * d + (size_t)(blockIdx.y % h) * kHD;
  const int part = threadIdx.x & 3;
  const int qi = blockIdx.x * kF32Rows + (threadIdx.x >> 2);
  float* row = sc + (threadIdx.x >> 2) * sp;

  float qr[kR], o[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    qr[i] = qi < n ? q[base + (size_t)qi * d + part + 4 * i] : 0.f;
    o[i] = 0.f;
  }
  for (int k0 = 0; k0 < n; k0 += kF32Keys) {
    const int kn = min(kF32Keys, n - k0);
    if (STAGED) {
      __syncthreads();
      load_rows_f32(buf, k + base, k0, kF32Keys, n, d);
      __syncthreads();
      scores_f32(qr, buf, kHD, kn, row, k0, scale);
    } else {
      scores_f32(qr, k + base + (size_t)k0 * d, d, kn, row, k0, scale);
    }
  }
  __syncwarp();
  const float den = softmax_quad<MODE, AFTER>(row, n, part);
  __syncwarp();
  for (int k0 = 0; k0 < n; k0 += kF32Keys) {
    const int kn = min(kF32Keys, n - k0);
    if (STAGED) {
      __syncthreads();
      load_rows_f32(buf, v + base, k0, kF32Keys, n, d);
      __syncthreads();
      pv_f32(o, row, buf, kHD, kn, k0);
    } else {
      pv_f32(o, row, v + base + (size_t)k0 * d, d, kn, k0);
    }
  }
  if (qi < n) {
#pragma unroll
    for (int i = 0; i < kR; ++i)
      out[base + (size_t)qi * d + part + 4 * i] = o[i] / den;
  }
}

// Shared memory: scores [32, sp] f32, the head's K and V [n, kHD] f32.
__global__ void __launch_bounds__(128)
scratch_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ out, int n, int h,
            float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int sp = ((n + 31) & ~31) + 4;
  float* sc = reinterpret_cast<float*>(smem);
  float* ks = sc + kF32Rows * sp;
  float* vs = ks + n * kHD;

  const int d = h * kHD;
  const int part = threadIdx.x & 3;
  float* row = sc + (threadIdx.x >> 2) * sp;

  for (int head = 0; head < h; ++head) {
    const size_t base = (size_t)blockIdx.x * n * d + (size_t)head * kHD;
    __syncthreads();  // every thread is done with the previous head
    load_rows_f32(ks, k + base, 0, n, n, d);
    load_rows_f32(vs, v + base, 0, n, n, d);
    __syncthreads();
    for (int q0 = 0; q0 < n; q0 += kF32Rows) {
      const int qi = q0 + (threadIdx.x >> 2);
      float qr[kR], o[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        qr[i] = qi < n ? q[base + (size_t)qi * d + part + 4 * i] : 0.f;
        o[i] = 0.f;
      }
      __syncwarp();  // the quad is done reading the previous tile's row
      scores_f32(qr, ks, kHD, n, row, 0, scale);
      __syncwarp();
      softmax_quad<kFull, false>(row, n, part);
      __syncwarp();
      pv_f32(o, row, vs, kHD, n, 0);
      if (qi < n) {
#pragma unroll
        for (int i = 0; i < kR; ++i)
          out[base + (size_t)qi * d + part + 4 * i] = o[i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int WARPS, int MODE, bool AFTER, bool STAGED>
cudaError_t launch_rows_bf16(const void* q, const void* k, const void* v,
                             void* out, int b, int n, int h, float scale,
                             cudaStream_t stream) {
  constexpr int BQ = WARPS * 16;
  constexpr int kBufRows = BQ > kKeys ? BQ : kKeys;
  const size_t ns = (n + 15) & ~15;
  const size_t bytes = (size_t)BQ * ns * sizeof(float) +
                       (STAGED ? (size_t)kBufRows * kLD * sizeof(bf16) : 0);
  auto kernel = rows_bf16<WARPS, MODE, AFTER, STAGED>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BQ - 1) / BQ, b * h);
  kernel<<<grid, WARPS * 32, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), n, h, scale);
  return cudaGetLastError();
}

template <int MODE, bool AFTER, bool STAGED>
cudaError_t launch_rows_f32(const void* q, const void* k, const void* v,
                            void* out, int b, int n, int h, float scale,
                            cudaStream_t stream) {
  const size_t sp = ((n + 31) & ~31) + 4;
  const size_t bytes = (size_t)kF32Rows * sp * sizeof(float) +
                       (STAGED ? (size_t)kF32Keys * kHD * sizeof(float) : 0);
  auto kernel = rows_f32<MODE, AFTER, STAGED>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kF32Rows - 1) / kF32Rows, b * h);
  kernel<<<grid, 128, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), n, h, scale);
  return cudaGetLastError();
}

}  // namespace

// The whole-row kernel (P1, P2, P4). q, k, v, out: [b, n, h * head_dim]
// contiguous, 16-byte aligned, bf16 (is_bf16 = 1) or f32; head-major input
// passes h = 1. mode: 0 full, 1 noexp, 2 dotsonly. norm_after: 0 divides
// before rounding P (P1, P2), 1 after P.V (P4). staged: 1 stages the
// operands through shared memory, 0 (P4 nostage) loads them from device
// memory. rows: query rows per block, 16, 32, 64 or 128 for bf16 full
// normalise-before staged (P1's sweep), else 64 for bf16 and 32 for f32.
// Built variants: full before staged (P1, P2); full, noexp and dotsonly
// after staged, and full after unstaged (P4). Launches on `stream` and
// returns cudaGetLastError(), or cudaErrorInvalidValue for a variant, head
// dim or size it does not take (the scores must fit in shared memory).
extern "C" int missm_probe_rows_attention(const void* q, const void* k,
                                          const void* v, void* out, int b,
                                          int n, int h, int head_dim,
                                          int is_bf16, int mode, int norm_after,
                                          int staged, int rows, float scale,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim != kHD || n < 1 || b < 1 || h < 1 || (long)b * h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
#define MISSM_ARGS q, k, v, out, b, n, h, scale, s
  if (is_bf16) {
    if (mode == kFull && !norm_after && staged) {
      switch (rows) {
        case 16: err = launch_rows_bf16<1, kFull, false, true>(MISSM_ARGS); break;
        case 32: err = launch_rows_bf16<2, kFull, false, true>(MISSM_ARGS); break;
        case 64: err = launch_rows_bf16<4, kFull, false, true>(MISSM_ARGS); break;
        case 128: err = launch_rows_bf16<8, kFull, false, true>(MISSM_ARGS); break;
        default: break;
      }
    } else if (rows == 64 && norm_after && staged) {
      if (mode == kFull) err = launch_rows_bf16<4, kFull, true, true>(MISSM_ARGS);
      if (mode == kNoExp) err = launch_rows_bf16<4, kNoExp, true, true>(MISSM_ARGS);
      if (mode == kDotsOnly)
        err = launch_rows_bf16<4, kDotsOnly, true, true>(MISSM_ARGS);
    } else if (rows == 64 && norm_after && mode == kFull) {
      err = launch_rows_bf16<4, kFull, true, false>(MISSM_ARGS);
    }
  } else if (rows == kF32Rows) {
    if (mode == kFull && !norm_after && staged)
      err = launch_rows_f32<kFull, false, true>(MISSM_ARGS);
    else if (norm_after && staged && mode == kFull)
      err = launch_rows_f32<kFull, true, true>(MISSM_ARGS);
    else if (norm_after && staged && mode == kNoExp)
      err = launch_rows_f32<kNoExp, true, true>(MISSM_ARGS);
    else if (norm_after && staged && mode == kDotsOnly)
      err = launch_rows_f32<kDotsOnly, true, true>(MISSM_ARGS);
    else if (norm_after && mode == kFull)
      err = launch_rows_f32<kFull, true, false>(MISSM_ARGS);
  }
#undef MISSM_ARGS
  return static_cast<int>(err);
}

// The batch-row kernel (P3): one block per batch row b of q, k, v, out
// [b, n, h * head_dim] (contiguous, 16-byte aligned, bf16 or f32), looping
// over the h heads; P1's whole-row softmax and rounding. Returns as
// missm_probe_rows_attention (a head's K and V must fit in shared memory).
extern "C" int missm_probe_scratch_attention(const void* q, const void* k,
                                             const void* v, void* out, int b,
                                             int n, int h, int head_dim,
                                             int is_bf16, float scale,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim != kHD || n < 1 || b < 1 || h < 1 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (is_bf16) {
    const size_t ns = (n + 15) & ~15;
    const size_t nk = (n + kKeys - 1) / kKeys * kKeys;
    const size_t bytes = 64 * ns * sizeof(float) +
                         (2 * nk + 64) * kLD * sizeof(bf16);
    err = allow_smem(scratch_bf16, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    scratch_bf16<<<b, 128, bytes, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), n, h, scale);
  } else {
    const size_t sp = ((n + 31) & ~31) + 4;
    const size_t bytes = (kF32Rows * sp + 2 * (size_t)n * kHD) * sizeof(float);
    err = allow_smem(scratch_f32, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    scratch_f32<<<b, 128, bytes, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), n, h, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
