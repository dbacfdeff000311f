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
//       [B, N, H*hd], each head's slices staged into scratch.
//   P4  ablation_probe.py:210 make_tower_packed_debug(mode): the production
//       kernel's rounding order (exp(s - m) rounded to the input type
//       unnormalised, P.V divided by the row sum afterwards) on [B, N, H*hd],
//       with the knock-outs noexp (e = s - m, den = sum(s - m)), dotsonly
//       (e = s, den = 1) and nostage (full, each head's operands read as
//       the input lays them out instead of through a re-layout).
// The head-pair packing of P4 (two 64-wide heads under a lane mask in one
// 128-lane row) only fills the TPU's lanes: each head's result is its own
// softmax attention, so here every block works on one head.
//
// Math: s = (q . k) * hd^-0.5 in f32, then per row m = max(s) and e as the
// mode says. P1-P3 divide before rounding: p = (e / sum(e)) rounded to the
// input type; P4 rounds e and divides P.V by den in f32. P.V accumulates in
// f32; the output has the input type. The bf16 kernels take exp(s - m) as
// one exp2 with log2(e) folded into the scale.
//
// Layout: q, k, v and out are [B, N, H*hd]; slice (b, head) is rows of
// pitch H*hd starting at column head*hd. The head-major [G, N, hd] of P1
// and P2 is the same with H = 1.
//
// What bounds it on this card: at the probes' shapes (1024 slices of
// [257, 64]) the function moves 134.7 MB (q, k, v read once, out written
// once: 0.0402 ms at 3.35 TB/s) and does 17.3 GFLOP (0.0175 ms at 989
// TFLOP/s), so bytes. The score rows never reach device memory.
//
// Design of the bf16 kernels (csrc/hopper.cuh: TMA, mbarriers, wgmma).
// Every query row's max (and, for P1-P3, its sum) is exact before any P,
// as the TPU kernels have them: that is what lets noexp's sum(s - m) exist
// at all (an online softmax cannot rescale it). Here it is had by two
// passes over the keys, not by keeping the row:
//   - One warpgroup (4 warps, wgmma's M of 64 rows) per 64-query tile. Q
//     arrives by TMA into a swizzled K-major tile and stays for both
//     passes.
//   - The statistics pass: S = Q K^T (wgmma m64nNk16, K K-major in shared
//     memory) one 64-key tile at a time, the last as narrow as its keys
//     (N mod 64 rounded up to 8: 8 keys at N = 257). Each thread keeps the
//     running max of its columns of its two rows and, for P1-P3, the sum of
//     exp2(s c - m c) rescaled as the max grows (c = scale log2(e), one ex2
//     a score); the quad that shares a row merges them at the end.
//     dotsonly (e = s, den = 1) needs no statistics and skips the pass.
//   - The output pass: S again, P from the accumulators in registers (e as
//     the mode says, over the sum for P1-P3, rounded to bf16: wgmma's
//     accumulator layout is the A fragment layout), O += P V with P as the
//     register A operand and V MN-major in shared memory; a narrow last
//     tile pads P.V to 16 keys with P = 0. P4 sums den here.
//   - A warp whose 16 rows all lie past N takes no exponential (its P is 0).
// The price is S computed twice (4 N^2 hd FLOP a head become 6, still under
// the byte bound) and, in the whole-row kernel, K read twice from L2. What
// it buys: no score row in shared memory, so blocks are small and many.
// The whole-row kernel (P1, P2, P4 full, noexp, dotsonly): grid (query
// tiles x slices), the ragged query tiles after every full one. The
// slice's K tiles for the statistics pass and then its (K, V) pairs for
// the output pass stream through one ring of kStages 64-key tiles whose
// mbarriers complete on their bytes. Shared memory: 1024 (alignment) +
// 8 KB Q + 4 x 8 KB ring + 40 of barriers = 42,024 bytes whatever N is, so
// five blocks an SM by shared memory and N has no limit. ROWS = 128 runs two
// warpgroups a block sharing the ring (50,216 bytes).
// The batch-row kernel (P3): what sets it apart from P2 is its staging, a
// head's whole K and V landing in shared memory once for all of the head's
// query tiles. One block per (batch, head): TMA brings the head's K and V
// (rows rounded up to 16, zero past N) in 16-row boxes, and the block's
// warpgroups walk the head's 64-query tiles against them (warpgroup w takes
// tiles w, w + WGS, ...), each with two Q buffers so that its next tile
// lands while this one runs. Two warpgroups: 1024 + 2 x 2 x 8 KB Q +
// 2 x 2 KB x ceil(N / 16) K and V + 40 of barriers = 103,464 bytes at
// N = 257, two blocks (16 warps) an SM, up to N = 768; one warpgroup to
// N = 832. kernels/probe_attention.py::plan mirrors every figure, and
// missm_probe_attention_smem exports them.
// Registers: 106 a thread in the whole-row kernel (four blocks an SM, so
// registers bind before shared memory), 112 in the batch-row kernel (two
// blocks of two warpgroups an SM).
// Measured against other designs on one card in one call and dropped:
// keeping the row instead of the second pass, each thread storing its own
// float4 of scores per 8-key group (64 x N x 4 bytes a warpgroup, 67,584 at
// N = 257) and reading back only its own for P.V, one pass over K and one
// over V: at most two blocks an SM by shared memory, and slower; the same
// with the next tile's products issued before this tile's scores are kept,
// slower still; rings of 2, 3 and 6 tiles; a register cap for five blocks
// an SM (spills) or four; the statistics pass taking two key tiles a
// commit group, or issuing tile j + 1's products before folding tile j's
// (more registers, fewer blocks); the ragged query tiles launched first.
// Each was slower or no faster.
// nostage (P4): the TPU arm slices q, k and v straight from the input
// block, which sits in VMEM (on chip) as the full arm's does, instead of
// first copying each head into a scratch of its own layout; what it knocks
// out is that re-layout. full's counterpart here is TMA landing each head's
// tile as a swizzled K-major box for wgmma, so nostage lands every tile as
// the input holds it: a TMA box without swizzle, each token row its head's
// 64 columns as 128 contiguous bytes, no padding, no copy per head. wgmma
// cannot read that (its no-swizzle layout wants each 8-row x 16-byte core
// matrix contiguous, its 128B layout the XOR pattern), so the products are
// mma.sync m16n8k16, a warp per 16 query rows of the block's 64. The rest
// is the whole-row kernel's: the two passes, the ring of kStages tiles
// (K tiles, then (K, V) pairs) and its shared memory, 42,024 bytes whatever
// N is, so no N limit; full's softmax (s in f32 times hd^-0.5, m the row's
// max from the statistics pass, e = exp(s - m) rounded to bf16 as P, P.V in
// f32 over den in f32). No operand comes from device memory: every fragment
// is read from the tiles in shared memory. The rows' 128-byte pitch puts a
// column of every row in the same four banks, so ldmatrix (the eight
// 16-byte rows of one matrix all at one column) would conflict 8 ways on
// every read. Each lane reads 16 bytes of its own instead: the contraction
// of S = Q K^T runs over the 64 columns in an order of its own (k-step kk
// takes columns 16 t + 4 kk .. 16 t + 4 kk + 3 of quad lane t), so lane
// (g, t) needs columns 16 t .. 16 t + 15 of its key, and the eight lanes of
// a quarter warp read eight different columns: no conflict. For P.V lane
// (g, t) brings columns 8 g .. 8 g + 7 of keys 2t, 2t + 1, 2t + 8 and
// 2t + 9 and pairs them into B fragments with byte permutes (output column
// 8 g + j is n-group j's column g); four lanes share a column in each of
// those loads, a 4-way conflict. Measured against it on one card in one
// call and dropped: V read without conflict (4-byte loads, each lane's
// words in an order rotated by t, rotated back in registers), slower; the
// kernel is bound by its instructions more than by its shared-memory reads.
// f32 inputs take a CUDA-core path (4 threads per query row, the row's
// scores in shared memory) that keeps full f32 precision: the card's f32
// reference in the checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

typedef __nv_bfloat16 bf16;

enum Mode { kFull = 0, kNoExp = 1, kDotsOnly = 2 };

constexpr int kHD = 64;                  // the probes' head dim (ViT-L/14)
constexpr int kKeys = 64;                // keys per full K/V tile
constexpr int kQRows = 64;               // query rows per warpgroup
constexpr int kStages = 4;               // ring tiles in flight
constexpr int kBox = 16;                 // rows per TMA box of P3's K and V
constexpr int kTile = kQRows * kHD * 2;  // bytes of a 64-row bf16 tile
constexpr int kF32Rows = 32;             // f32: query rows per block
constexpr int kF32Keys = 32;             // f32: keys per staged K/V tile
constexpr int kR = kHD / 4;              // f32: dims per thread
constexpr int kMaxSmem = 232448;         // a block's shared memory on sm_90
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kAll = 0xffffffffu;

// Dynamic shared memory of each bf16 kernel (kernels/probe_attention.py::
// plan computes the same): the whole-row kernel with WGS warpgroups, the
// batch-row kernel with WGS warpgroups, the nostage kernel (the whole-row
// kernel's one-warpgroup figure: Q, the ring, the barriers).
int rows_smem(int wgs) {
  return 1024 + (wgs + kStages) * kTile + 8 * (1 + kStages);
}
int scratch_smem(int wgs, int n) {
  return 1024 + 2 * wgs * kTile +
         2 * ((n + kBox - 1) / kBox) * kBox * kHD * 2 + 8 * (1 + 2 * wgs);
}
int nostage_smem() { return rows_smem(1); }

// e of one score at column col: exp(s - m), s - m or s as MODE says below
// n, 0 at or past n (the f32 and nostage kernels).
template <int MODE>
__device__ __forceinline__ float weight(float s, float m, int col, int n) {
  if (col >= n) return 0.f;
  return MODE == kFull ? expf(s - m) : MODE == kNoExp ? s - m : s;
}

__device__ __forceinline__ void quad_max(float& a) {
  a = fmaxf(a, __shfl_xor_sync(kAll, a, 1));
  a = fmaxf(a, __shfl_xor_sync(kAll, a, 2));
}

__device__ __forceinline__ void quad_sum(float& a) {
  a += __shfl_xor_sync(kAll, a, 1);
  a += __shfl_xor_sync(kAll, a, 2);
}

// ---------------------------------------------------------------------------
// bf16: wgmma, TMA
// ---------------------------------------------------------------------------

// This thread's two rows (r, r + 8): the running max of the raw scores of
// its columns and, for the kernels that divide before rounding, the sum of
// exp2((s - m) c) over them.
struct Stats {
  float m[2], l[2];
};

// The 128 threads of warpgroup wg meet (named barrier 1 + wg).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// S = Q K^T for the NK keys of the K tile at ks (Q at qs), waited for.
template <int NK>
__device__ __forceinline__ void scores(float* s, uint32_t qs, uint32_t ks) {
  using T = Tiles<kHD>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kHD / 16; ++kk)
    wgmma_ss<NK>(s, T::kmajor(qs, kQRows, kk), T::kmajor(ks, kKeys, kk), kk);
  wgmma_commit();
  wgmma_wait();
  fence_regs<NK / 2>(s);
}

// The statistics pass over the NK keys from k0 (LAST: the narrow last tile,
// whose keys at or past n are not keys): a live warp folds the tile's scores
// into st, the max and (SUM) the sum of exp2(s c - m c), c = scale log2(e).
template <int NK, bool LAST, bool SUM>
__device__ __forceinline__ void stats_tile(uint32_t qs, uint32_t ks, int k0,
                                           int n, bool live, float c,
                                           Stats& st) {
  float s[NK / 2];
  scores<NK>(s, qs, ks);
  if (!live) return;
  const int t = threadIdx.x & 3;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (LAST && k0 + 8 * j + 2 * t + (e & 1) >= n) s[4 * j + e] = -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float mn = fmaxf(st.m[i], mx[i]);
    if (SUM) {
      // while every key of this thread's so far is masked its max is -inf:
      // take 0 as the reference then, so that no exponent is -inf - -inf
      const float ref = mn == -INFINITY ? 0.f : mn * c;
      float l = st.l[i] * ex2(fmaf(st.m[i], c, -ref));
#pragma unroll
      for (int j = 0; j < NK / 8; ++j)
        l += ex2(fmaf(s[4 * j + 2 * i], c, -ref)) +
             ex2(fmaf(s[4 * j + 2 * i + 1], c, -ref));
      st.l[i] = l;
    }
    st.m[i] = mn;
  }
}

// The output pass over the NK keys from k0: S again, then O += P V (the V
// tile at vs, MN-major) with P = e rounded to bf16. From y = a s + b[row],
// e = exp2(y) (full) or y (noexp, dotsonly) at keys below n, 0 past them;
// (DEN) e is added to den; then e is multiplied by f[row]. A warp without a
// live row multiplies by P = 0; a narrow tile pads P.V to 16 keys with
// P = 0.
template <int NK, bool LAST, int MODE, bool DEN>
__device__ __forceinline__ void out_tile(float* o, uint32_t qs, uint32_t ks,
                                         uint32_t vs, int k0, int n, bool live,
                                         float a, const float b[2],
                                         const float f[2], float den[2]) {
  constexpr int KS = (NK + 15) / 16;
  float s[NK / 2];
  scores<NK>(s, qs, ks);
  uint32_t p[KS][4];
  if (live) {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e >> 1;
        const float y = fmaf(s[4 * j + e], a, b[row]);
        float x = MODE == kFull ? ex2(y) : y;
        if (LAST && k0 + 8 * j + 2 * t + (e & 1) >= n) x = 0.f;
        if (DEN) den[row] += x;
        s[4 * j + e] = x * f[row];
      }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) acc_to_a<NK>(s, kk, p[kk]);
  } else {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) p[kk][0] = p[kk][1] = p[kk][2] = p[kk][3] = 0u;
  }
  fence_regs<KS>(p);
  fence_regs<kHD / 2>(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_rs<kHD>(o, p[kk], Tiles<kHD>::mnmajor(vs, kKeys, kk, 0), 1);
  wgmma_commit();
  wgmma_wait();
  fence_regs<kHD / 2>(o);
}

#define MISSM_TAILS(X) X(8) X(16) X(24) X(32) X(40) X(48) X(56) X(64)

// Key tile j of either pass: one of the kfull full tiles, or the narrow
// last one of `tail` keys (N mod 64 rounded up to 8).
template <bool SUM>
__device__ __forceinline__ void stats_at(int j, int kfull, int tail,
                                         uint32_t qs, uint32_t ks, int n,
                                         bool live, float c, Stats& st) {
  const int k0 = j * kKeys;
  if (j < kfull) {
    stats_tile<kKeys, false, SUM>(qs, ks, k0, n, live, c, st);
    return;
  }
  switch (tail) {
#define MISSM_TAIL(NK)                                         \
  case NK:                                                     \
    stats_tile<NK, true, SUM>(qs, ks, k0, n, live, c, st);     \
    break;
    MISSM_TAILS(MISSM_TAIL)
#undef MISSM_TAIL
  }
}

template <int MODE, bool DEN>
__device__ __forceinline__ void out_at(int j, int kfull, int tail, float* o,
                                       uint32_t qs, uint32_t ks, uint32_t vs,
                                       int n, bool live, float a,
                                       const float b[2], const float f[2],
                                       float den[2]) {
  const int k0 = j * kKeys;
  if (j < kfull) {
    out_tile<kKeys, false, MODE, DEN>(o, qs, ks, vs, k0, n, live, a, b, f,
                                      den);
    return;
  }
  switch (tail) {
#define MISSM_TAIL(NK)                                                       \
  case NK:                                                                   \
    out_tile<NK, true, MODE, DEN>(o, qs, ks, vs, k0, n, live, a, b, f, den); \
    break;
    MISSM_TAILS(MISSM_TAIL)
#undef MISSM_TAIL
  }
}

// The row's max (and, SUM, its sum of exp2(s c - m c)) from the four
// threads of the quad that holds the row.
template <bool SUM>
__device__ __forceinline__ void merge_stats(Stats& st, float c) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float m = st.m[i];
    quad_max(m);
    if (SUM) {
      float l = st.l[i] * ex2(fmaf(st.m[i], c, -m * c));
      quad_sum(l);
      st.l[i] = l;
    }
    st.m[i] = m;
  }
}

// What the output pass needs from the row statistics: y = a s + b[row] is
// the exponent (full) or e itself (noexp, dotsonly), P is e times f[row] (1
// / the row sum for the kernels that divide before rounding, else 1).
template <int MODE, bool SUM>
__device__ __forceinline__ void pv_terms(const Stats& st, float scale, float c,
                                         float& a, float b[2], float f[2]) {
  a = MODE == kFull ? c : scale;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    b[i] = MODE == kDotsOnly ? 0.f : -st.m[i] * a;
    f[i] = SUM ? 1.f / st.l[i] : 1.f;
  }
}

// This thread's output rows r0 and r0 + 8 of slice (b, head), divided by
// den, where the row is below n.
__device__ __forceinline__ void store_out(bf16* out, const float* o, int r0,
                                          int n, int h, int head, int b,
                                          const float den[2]) {
  const int t = threadIdx.x & 3;
  const int d = h * kHD;
  bf16* base = out + (size_t)b * n * d + (size_t)head * kHD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= n) continue;
    bf16* orow = base + (size_t)row * d;
#pragma unroll
    for (int j = 0; j < kHD / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
          pack_bf16(o[4 * j + 2 * i] / den[i], o[4 * j + 2 * i + 1] / den[i]);
  }
}

// One warpgroup's 64-query tile, both passes: ktile(j) / vtile(j) wait for
// key tile j of K / V and return its shared address; done(j) is called
// after the statistics pass's tile j (i = j) and after the output pass's
// tile j (i = nkt + j), when the block may reuse what it read.
template <int MODE, bool AFTER, typename KTile, typename VTile, typename Done>
__device__ __forceinline__ void query_tile(uint32_t qs, KTile ktile,
                                           VTile vtile, Done done, bf16* out,
                                           int qw, int n, int h, int head,
                                           int b, float scale) {
  constexpr bool SUM = !AFTER;
  constexpr bool DEN = AFTER && MODE != kDotsOnly;
  constexpr bool STATS = MODE != kDotsOnly;  // dotsonly needs no max
  const int warp = (threadIdx.x >> 5) & 3;
  const int r0 = qw + warp * 16 + ((threadIdx.x & 31) >> 2);
  const bool live = qw + warp * 16 < n;
  const int nkt = (n + kKeys - 1) / kKeys;
  const int kfull = n / kKeys;
  const int tail = (n % kKeys + 7) / 8 * 8;
  const float c = scale * kLog2e;
  Stats st = {{-INFINITY, -INFINITY}, {0.f, 0.f}};
  for (int j = 0; STATS && j < nkt; ++j) {
    stats_at<SUM>(j, kfull, tail, qs, ktile(j), n, live, c, st);
    done(j);
  }
  if (STATS && live) merge_stats<SUM>(st, c);
  float a, bb[2], f[2];
  pv_terms<MODE, SUM>(st, scale, c, a, bb, f);
  float o[kHD / 2];
#pragma unroll
  for (int i = 0; i < kHD / 2; ++i) o[i] = 0.f;
  float den[2] = {0.f, 0.f};
  for (int j = 0; j < nkt; ++j) {
    const uint32_t ks = ktile(nkt + j);
    out_at<MODE, DEN>(j, kfull, tail, o, qs, ks, vtile(j), n, live, a, bb, f,
                      den);
    done(nkt + j);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (DEN)
      quad_sum(den[i]);
    else
      den[i] = 1.f;
  }
  store_out(out, o, r0, n, h, head, b, den);
}

// The whole-row kernel (P1, P2, P4 full, noexp, dotsonly). Block x: the
// query tiles of WGS x 64 rows with every row live of every slice, tile
// fastest, then the ragged last tile of every slice. The ring carries the
// statistics pass's K tiles, then the output pass's (K, V) pairs. Shared
// memory: Q (WGS tiles), the ring, the barriers.
template <int WGS, int MODE, bool AFTER>
__global__ void __launch_bounds__(WGS * 128)
rows_bf16(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
          int n, int h, int slices, float scale) {
  using T = Tiles<kHD>;
  constexpr int BQ = WGS * kQRows;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  uint8_t* ring = smem + WGS * kTile;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(ring + kStages * kTile);
  uint64_t* full = qbar + 1;  // kStages: ring tile i in stage i % kStages

  const int full_tiles = n / BQ;
  int tile, slice;
  if ((int)blockIdx.x < full_tiles * slices) {
    tile = blockIdx.x % full_tiles;
    slice = blockIdx.x / full_tiles;
  } else {
    tile = full_tiles;
    slice = blockIdx.x - full_tiles * slices;
  }
  const int head = slice % h;
  const int b = slice / h;
  const int q0 = tile * BQ;
  const int wg = threadIdx.x >> 7;
  const int nkt = (n + kKeys - 1) / kKeys;
  // the ring: K_0 .. K_{nkt-1} for the statistics pass (none for
  // dotsonly), then K_0, V_0, K_1, V_1, .. for the output pass
  const int pairs0 = MODE == kDotsOnly ? 0 : nkt;
  const int total = pairs0 + 2 * nkt;

  auto stage = [&](int i) { return ring + (i % kStages) * kTile; };
  auto load = [&](int i) {
    uint64_t* bar = full + i % kStages;
    const bool is_v = i >= pairs0 && (i - pairs0) % 2;
    const int key_tile = i < pairs0 ? i : (i - pairs0) / 2;
    mbar_expect(bar, kTile);
    T::load(stage(i), kKeys, is_v ? &tv : &tk, bar, head, key_tile * kKeys, b);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(qbar + i, 1);
    mbar_fence_init();
    // a warpgroup whose rows all lie past N loads no Q (its warps are dead)
    const int nq = min(WGS, (n - q0 + kQRows - 1) / kQRows);
    mbar_expect(qbar, nq * kTile);
    for (int w = 0; w < nq; ++w)
      T::load(smem + w * kTile, kQRows, &tq, qbar, head, q0 + w * kQRows, b);
    for (int i = 0; i < min(kStages, total); ++i) load(i);
  }
  __syncthreads();

  // ring index of K tile j (j < nkt: statistics pass, else output pass
  // tile j - nkt)
  auto k_index = [&](int j) { return j < nkt ? j : pairs0 + 2 * (j - nkt); };
  auto wait = [&](int i) {
    mbar_wait(full + i % kStages, (i / kStages) & 1);
    return smem_u32(stage(i));
  };
  auto release = [&](int i) {
    if (threadIdx.x == 0 && i + kStages < total) load(i + kStages);
  };
  auto done = [&](int j) {
    __syncthreads();  // every warp is done with the tiles of step j
    release(k_index(j));
    if (j >= nkt) release(k_index(j) + 1);
  };
  mbar_wait(qbar, 0);
  query_tile<MODE, AFTER>(
      smem_u32(smem + wg * kTile), [&](int j) { return wait(k_index(j)); },
      [&](int j) { return wait(pairs0 + 2 * j + 1); }, done, out,
      q0 + wg * kQRows, n, h, head, b, scale);
}

// The batch-row kernel (P3): block x is (batch x / h, head x % h). Shared
// memory: two Q tiles per warpgroup (its query tile and the next one), the
// head's K and V (16-row boxes, rows past N zero), the barriers.
template <int WGS>
__global__ void __launch_bounds__(WGS * 128)
scratch_bf16(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
             int n, int h, float scale) {
  using T = Tiles<kHD>;
  constexpr int kBoxBytes = kBox * kHD * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  const int nb = (n + kBox - 1) / kBox;  // boxes of K, and of V
  uint8_t* ks = smem + 2 * WGS * kTile;
  uint8_t* vs = ks + nb * kBoxBytes;
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(vs + nb * kBoxBytes);
  uint64_t* qbar = kvbar + 1;  // 2 WGS: Q buffer 2 w + r % 2, round r of w

  const int head = blockIdx.x % h;
  const int b = blockIdx.x / h;
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int nqt = (n + kQRows - 1) / kQRows;
  const int nkt = (n + kKeys - 1) / kKeys;

  // warpgroup w's query tile of round r is w + r WGS, in buffer 2 w + r % 2
  auto load_q = [&](int w, int r) {
    const int buf = 2 * w + r % 2;
    mbar_expect(qbar + buf, kTile);
    T::load(smem + buf * kTile, kQRows, &tq, qbar + buf, head,
            (w + r * WGS) * kQRows, b);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + 2 * WGS; ++i) mbar_init(kvbar + i, 1);
    mbar_fence_init();
    mbar_expect(kvbar, 2 * nb * kBoxBytes);
    for (int i = 0; i < nb; ++i) {
      T::load(ks + i * kBoxBytes, kBox, &tk, kvbar, head, i * kBox, b);
      T::load(vs + i * kBoxBytes, kBox, &tv, kvbar, head, i * kBox, b);
    }
    for (int w = 0; w < WGS; ++w)
      for (int r = 0; r < 2; ++r)
        if (w + r * WGS < nqt) load_q(w, r);
  }
  __syncthreads();

  mbar_wait(kvbar, 0);
  for (int r = 0; wg + r * WGS < nqt; ++r) {
    const int buf = 2 * wg + r % 2;
    mbar_wait(qbar + buf, (r / 2) & 1);
    // after the last product that reads this Q tile, the buffer takes the
    // tile two rounds on
    auto done = [&](int j) {
      if (j != 2 * nkt - 1) return;
      warpgroup_sync(wg);
      if (tid == 0 && wg + (r + 2) * WGS < nqt) load_q(wg, r + 2);
    };
    query_tile<kFull, false>(
        smem_u32(smem + buf * kTile),
        [&](int j) { return smem_u32(ks + (j < nkt ? j : j - nkt) * kTile); },
        [&](int j) { return smem_u32(vs + j * kTile); }, done, out,
        (wg + r * WGS) * kQRows, n, h, head, b, scale);
  }
}

// ---------------------------------------------------------------------------
// bf16 nostage (P4): mma.sync on the tiles as the input lays them out
// ---------------------------------------------------------------------------

constexpr int kRowBytes = kHD * 2;  // one token row of a head in a tile

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 lds16(const uint8_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// Columns 16 t .. 16 t + 15 of row `row` of a tile, as 8 words of two bf16.
// A lane of odd g reads the upper 16 bytes first, so that the 8 lanes of a
// quarter warp (g = 2i, 2i + 1; t = 0..3) read 8 different 16-byte columns
// in each load.
__device__ __forceinline__ void row_words(const uint8_t* tile, int row, int g,
                                          int t, uint32_t w[8]) {
  const uint8_t* p = tile + row * kRowBytes + 32 * t;
  const int odd = g & 1;
  const uint4 x = lds16(p + 16 * odd);
  const uint4 y = lds16(p + 16 * (odd ^ 1));
  const uint4 lo = odd ? y : x;
  const uint4 hi = odd ? x : y;
  w[0] = lo.x, w[1] = lo.y, w[2] = lo.z, w[3] = lo.w;
  w[4] = hi.x, w[5] = hi.y, w[6] = hi.z, w[7] = hi.w;
}

// S for the 8 keys from k8 of the K tile at kt against the warp's 16 query
// rows (qw: row_words of rows g and g + 8). k-step kk contracts columns
// 16 t + 4 kk .. 16 t + 4 kk + 3 of every quad lane t: words 2 kk and
// 2 kk + 1 of row_words, in both operands. s[0], s[1]: row g, keys
// k8 + 2t, k8 + 2t + 1; s[2], s[3]: row g + 8.
__device__ __forceinline__ void group_scores(float s[4],
                                             const uint32_t qw[2][8],
                                             const uint8_t* kt, int k8, int g,
                                             int t) {
  uint32_t kw[8];
  row_words(kt, k8 + g, g, t, kw);
  s[0] = s[1] = s[2] = s[3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kHD / 16; ++kk) {
    const uint32_t a[4] = {qw[0][2 * kk], qw[1][2 * kk], qw[0][2 * kk + 1],
                           qw[1][2 * kk + 1]};
    mma_bf16(s, a, kw[2 * kk], kw[2 * kk + 1]);
  }
}

// The statistics pass over the `keys` keys from k0 (8 at a time) in the K
// tile at kt (LAST: the last tile, keys < 64, whose keys at or past n are
// left out): m, the running max of this thread's raw scores of rows g and
// g + 8.
template <bool LAST>
__device__ __forceinline__ void nostage_max(float m[2],
                                            const uint32_t qw[2][8],
                                            const uint8_t* kt, int k0,
                                            int keys, int n, int g, int t) {
#pragma unroll
  for (int k8 = 0; k8 < kKeys; k8 += 8) {
    if (LAST && k8 >= keys) break;
    float s[4];
    group_scores(s, qw, kt, k8, g, t);
    const int col = k0 + k8 + 2 * t;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      m[e >> 1] = fmaxf(m[e >> 1],
                        !LAST || col + (e & 1) < n ? s[e] : -INFINITY);
  }
}

// The output pass over the `keys` keys from k0 (16 at a time; LAST as
// above, a narrow last step's second 8 keys carrying P = 0): S again,
// e = exp(s - m) of the scaled score against m, the row's scaled max
// (weight<kFull> in the last tile; a full tile has no key to leave out and
// skips its column test, whose branch around expf slowed the loop
// measurably), added to den, P = e rounded to bf16 (the accumulators of two
// 8-key groups are the A fragment of one 16-key step), then O += P V with
// V from the tile at vt. Lane
// (g, t) brings columns 8 g .. 8 g + 7 of keys 2t, 2t + 1, 2t + 8, 2t + 9;
// n-group j's B fragment is column 8 g + j of those four, paired by byte
// permutes, so o[j] holds output columns 16 t + j (o[j][0], o[j][2]) and
// 16 t + 8 + j (o[j][1], o[j][3]).
template <bool LAST>
__device__ __forceinline__ void nostage_pv(float o[kHD / 8][4], float den[2],
                                           const uint32_t qw[2][8],
                                           const uint8_t* kt,
                                           const uint8_t* vt, int k0,
                                           int keys, int n, float scale,
                                           const float m[2], int g, int t) {
#pragma unroll
  for (int k16 = 0; k16 < kKeys; k16 += 16) {
    if (LAST && k16 >= keys) break;
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    group_scores(s[0], qw, kt, k16, g, t);
    if (!LAST || k16 + 8 < keys) group_scores(s[1], qw, kt, k16 + 8, g, t);
    uint32_t a[4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = k0 + k16 + 8 * half + 2 * t;
      float e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = s[half][i] * scale;
        e[i] = LAST ? weight<kFull>(x, m[i >> 1], col + (i & 1), n)
                    : expf(x - m[i >> 1]);
        den[i >> 1] += e[i];
      }
      a[2 * half] = pack_bf16(e[0], e[1]);
      a[2 * half + 1] = pack_bf16(e[2], e[3]);
    }
    const uint8_t* vr = vt + (k16 + 2 * t) * kRowBytes + 16 * g;
    const uint4 v0 = lds16(vr), v1 = lds16(vr + kRowBytes),
                v2 = lds16(vr + 8 * kRowBytes), v3 = lds16(vr + 9 * kRowBytes);
    const uint32_t r0[4] = {v0.x, v0.y, v0.z, v0.w};
    const uint32_t r1[4] = {v1.x, v1.y, v1.z, v1.w};
    const uint32_t r2[4] = {v2.x, v2.y, v2.z, v2.w};
    const uint32_t r3[4] = {v3.x, v3.y, v3.z, v3.w};
#pragma unroll
    for (int j = 0; j < kHD / 8; ++j) {
      const uint32_t sel = j & 1 ? 0x7632u : 0x5410u;  // high or low halves
      mma_bf16(o[j], a, __byte_perm(r0[j >> 1], r1[j >> 1], sel),
               __byte_perm(r2[j >> 1], r3[j >> 1], sel));
    }
  }
}

// One block per (64-query tile x, slice y), a warp per 16 query rows.
// Shared memory as the whole-row kernel's with one warpgroup: Q, the ring
// (the statistics pass's K tiles, then the output pass's (K, V) pairs),
// the barriers; every tile as the input lays it out.
__global__ void __launch_bounds__(128)
nostage_bf16(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
             int n, int h, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  uint8_t* ring = smem + kTile;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(ring + kStages * kTile);
  uint64_t* full = qbar + 1;  // kStages: ring tile i in stage i % kStages

  const int head = blockIdx.y % h;
  const int b = blockIdx.y / h;
  const int q0 = blockIdx.x * kQRows;
  const int nkt = (n + kKeys - 1) / kKeys;
  const int total = 3 * nkt;  // K_0 .. K_{nkt-1}, then K_0, V_0, K_1, ..

  auto stage = [&](int i) { return ring + (i % kStages) * kTile; };
  auto load = [&](int i) {
    uint64_t* bar = full + i % kStages;
    const bool is_v = i >= nkt && (i - nkt) % 2;
    const int key_tile = i < nkt ? i : (i - nkt) / 2;
    mbar_expect(bar, kTile);
    tma_load(stage(i), is_v ? &tv : &tk, bar, head * kHD, key_tile * kKeys,
             b);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(qbar + i, 1);
    mbar_fence_init();
    mbar_expect(qbar, kTile);
    tma_load(smem, &tq, qbar, head * kHD, q0, b);
    for (int i = 0; i < min(kStages, total); ++i) load(i);
  }
  __syncthreads();

  auto wait = [&](int i) {
    mbar_wait(full + i % kStages, (i / kStages) & 1);
    return static_cast<const uint8_t*>(stage(i));
  };
  // every warp is done with ring tile i: its stage takes tile i + kStages
  auto release = [&](int i) {
    if (threadIdx.x == 0 && i + kStages < total) load(i + kStages);
  };
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const bool live = warp * 16 < n - q0;  // else no row of the warp is below n
  mbar_wait(qbar, 0);
  uint32_t qw[2][8];
  row_words(smem, warp * 16 + g, g, t, qw[0]);
  row_words(smem, warp * 16 + g + 8, g, t, qw[1]);

  float m[2] = {-INFINITY, -INFINITY};
  for (int j = 0; j < nkt; ++j) {
    const uint8_t* kt = wait(j);
    const int keys = min(kKeys, n - j * kKeys);
    if (live && keys == kKeys)
      nostage_max<false>(m, qw, kt, j * kKeys, keys, n, g, t);
    else if (live)
      nostage_max<true>(m, qw, kt, j * kKeys, keys, n, g, t);
    __syncthreads();
    release(j);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    quad_max(m[i]);
    m[i] *= scale;  // scale > 0: the max of the scaled scores
  }
  float o[kHD / 8][4];
#pragma unroll
  for (int j = 0; j < kHD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float den[2] = {0.f, 0.f};
  for (int j = 0; j < nkt; ++j) {
    const uint8_t* kt = wait(nkt + 2 * j);
    const uint8_t* vt = wait(nkt + 2 * j + 1);
    const int keys = min(kKeys, n - j * kKeys);
    if (live && keys == kKeys)
      nostage_pv<false>(o, den, qw, kt, vt, j * kKeys, keys, n, scale, m, g,
                        t);
    else if (live)
      nostage_pv<true>(o, den, qw, kt, vt, j * kKeys, keys, n, scale, m, g,
                       t);
    __syncthreads();
    release(nkt + 2 * j);
    release(nkt + 2 * j + 1);
  }
  quad_sum(den[0]);
  quad_sum(den[1]);
  const int d = h * kHD;
  bf16* base = out + (size_t)b * n * d + (size_t)head * kHD + 16 * t;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    if (row >= n) continue;
    uint32_t w[2][4];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[c][j] = pack_bf16(o[2 * j][2 * i + c] / den[i],
                            o[2 * j + 1][2 * i + c] / den[i]);
    uint4* dst = reinterpret_cast<uint4*>(base + (size_t)row * d);
    dst[0] = make_uint4(w[0][0], w[0][1], w[0][2], w[0][3]);
    dst[1] = make_uint4(w[1][0], w[1][1], w[1][2], w[1][3]);
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

// Sets the shared-memory attribute of `kernel` once per device, to the most
// a block may have (a launch's bytes vary with N), after checking that a
// launch of `bytes` fits. Returns a cudaError_t.
template <typename Kernel>
int prepare(Kernel kernel, int bytes, unsigned long long& done) {
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  return allow_smem(kernel, kMaxSmem, done);
}

// Warpgroups a block of the batch-row kernel runs: two while they fit.
int scratch_wgs(int n) { return scratch_smem(2, n) <= kMaxSmem ? 2 : 1; }

template <int WGS, int MODE, bool AFTER>
int launch_rows_bf16(const void* q, const void* k, const void* v, void* out,
                     int b, int n, int h, float scale, cudaStream_t stream) {
  auto kernel = rows_bf16<WGS, MODE, AFTER>;
  static unsigned long long attr_set = 0;
  const int bytes = rows_smem(WGS);
  const int d = h * kHD;
  CUtensorMap tq, tk, tv;
  int rc = prepare(kernel, bytes, attr_set);
  if (!rc) rc = encode_rows(&tq, q, b, n, d, kQRows, kHD);
  if (!rc) rc = encode_rows(&tk, k, b, n, d, kKeys, kHD);
  if (!rc) rc = encode_rows(&tv, v, b, n, d, kKeys, kHD);
  if (rc) return rc;
  const int slices = b * h;
  const int blocks = slices * ((n + WGS * kQRows - 1) / (WGS * kQRows));
  kernel<<<blocks, WGS * 128, bytes, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), n, h, slices, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int WGS>
int launch_scratch_bf16(const void* q, const void* k, const void* v,
                        void* out, int b, int n, int h, float scale,
                        cudaStream_t stream) {
  auto kernel = scratch_bf16<WGS>;
  static unsigned long long attr_set = 0;
  const int bytes = scratch_smem(WGS, n);
  const int d = h * kHD;
  CUtensorMap tq, tk, tv;
  int rc = prepare(kernel, bytes, attr_set);
  if (!rc) rc = encode_rows(&tq, q, b, n, d, kQRows, kHD);
  if (!rc) rc = encode_rows(&tk, k, b, n, d, kBox, kHD);
  if (!rc) rc = encode_rows(&tv, v, b, n, d, kBox, kHD);
  if (rc) return rc;
  kernel<<<b * h, WGS * 128, bytes, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), n, h, scale);
  return static_cast<int>(cudaGetLastError());
}

// A map over x = [b, n, d] bf16 whose box is kKeys rows of one head's kHD
// columns, landed without swizzle: box row r at r * kRowBytes, as the input
// lays the head's rows out. Returns a cudaError_t.
int encode_unswizzled(CUtensorMap* map, const void* x, int b, int n, int d) {
  EncodeTiled encode = encoder();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)b};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)n * d * 2};
  const cuuint32_t box[3] = {kHD, kKeys, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

int launch_nostage_bf16(const void* q, const void* k, const void* v,
                        void* out, int b, int n, int h, float scale,
                        cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const int bytes = nostage_smem();
  const int d = h * kHD;
  CUtensorMap tq, tk, tv;
  int rc = prepare(nostage_bf16, bytes, attr_set);
  if (!rc) rc = encode_unswizzled(&tq, q, b, n, d);
  if (!rc) rc = encode_unswizzled(&tk, k, b, n, d);
  if (!rc) rc = encode_unswizzled(&tv, v, b, n, d);
  if (rc) return rc;
  const dim3 grid((n + kQRows - 1) / kQRows, b * h);
  nostage_bf16<<<grid, 128, bytes, stream>>>(tq, tk, tv,
                                             static_cast<bf16*>(out), n, h,
                                             scale);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, bool AFTER, bool STAGED>
int launch_rows_f32(const void* q, const void* k, const void* v, void* out,
                    int b, int n, int h, float scale, cudaStream_t stream) {
  auto kernel = rows_f32<MODE, AFTER, STAGED>;
  static unsigned long long attr_set = 0;
  const int sp = ((n + 31) & ~31) + 4;
  const int bytes = (kF32Rows * sp + (STAGED ? kF32Keys * kHD : 0)) * 4;
  const int rc = prepare(kernel, bytes, attr_set);
  if (rc) return rc;
  const dim3 grid((n + kF32Rows - 1) / kF32Rows, b * h);
  kernel<<<grid, 128, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), n, h, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_scratch_f32(const void* q, const void* k, const void* v, void* out,
                       int b, int n, int h, float scale, cudaStream_t stream) {
  static unsigned long long attr_set = 0;
  const int sp = ((n + 31) & ~31) + 4;
  const int bytes = (kF32Rows * sp + 2 * n * kHD) * 4;
  const int rc = prepare(scratch_f32, bytes, attr_set);
  if (rc) return rc;
  scratch_f32<<<b, 128, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), n, h, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The whole-row kernel (P1, P2, P4). q, k, v, out: [b, n, h * head_dim]
// contiguous, 16-byte aligned, bf16 (is_bf16 = 1) or f32; head-major input
// passes h = 1. mode: 0 full, 1 noexp, 2 dotsonly. norm_after: 0 divides
// before rounding P (P1, P2), 1 after P.V (P4). staged: 1 stages the
// operands through shared memory, 0 (P4 nostage) reads them as the input
// lays them out (bf16: in shared memory, unswizzled; f32: from device
// memory). rows: query rows per block, 64 or 128 for bf16 full
// normalise-before staged (P1's sweep), else 64 for bf16 and 32 for f32.
// Built variants: full before staged (P1, P2); full, noexp and dotsonly
// after staged, and full after unstaged (P4). Launches on `stream` and
// returns the first error: of the shared-memory attribute or the tensor
// maps, else cudaGetLastError(); cudaErrorInvalidValue for a variant, head
// dim or size it does not take (f32: the scores must fit in shared
// memory).
extern "C" int missm_probe_rows_attention(const void* q, const void* k,
                                          const void* v, void* out, int b,
                                          int n, int h, int head_dim,
                                          int is_bf16, int mode, int norm_after,
                                          int staged, int rows, float scale,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim != kHD || n < 1 || b < 1 || h < 1 || (long)b * h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int rc = static_cast<int>(cudaErrorInvalidValue);
#define MISSM_ARGS q, k, v, out, b, n, h, scale, s
  if (is_bf16) {
    if (!staged) {
      if (mode == kFull && norm_after && rows == 64)
        rc = launch_nostage_bf16(MISSM_ARGS);
    } else if (mode == kFull && !norm_after) {
      if (rows == 64) rc = launch_rows_bf16<1, kFull, false>(MISSM_ARGS);
      if (rows == 128) rc = launch_rows_bf16<2, kFull, false>(MISSM_ARGS);
    } else if (norm_after && rows == 64) {
      if (mode == kFull) rc = launch_rows_bf16<1, kFull, true>(MISSM_ARGS);
      if (mode == kNoExp) rc = launch_rows_bf16<1, kNoExp, true>(MISSM_ARGS);
      if (mode == kDotsOnly)
        rc = launch_rows_bf16<1, kDotsOnly, true>(MISSM_ARGS);
    }
  } else if (rows == kF32Rows) {
    if (mode == kFull && !norm_after && staged)
      rc = launch_rows_f32<kFull, false, true>(MISSM_ARGS);
    else if (norm_after && staged && mode == kFull)
      rc = launch_rows_f32<kFull, true, true>(MISSM_ARGS);
    else if (norm_after && staged && mode == kNoExp)
      rc = launch_rows_f32<kNoExp, true, true>(MISSM_ARGS);
    else if (norm_after && staged && mode == kDotsOnly)
      rc = launch_rows_f32<kDotsOnly, true, true>(MISSM_ARGS);
    else if (norm_after && mode == kFull)
      rc = launch_rows_f32<kFull, true, false>(MISSM_ARGS);
  }
#undef MISSM_ARGS
  return rc;
}

// The batch-row kernel (P3) on q, k, v, out [b, n, h * head_dim]
// (contiguous, 16-byte aligned, bf16 or f32): bf16, one block per (batch,
// head) with two warpgroups while they fit, else one; f32, one block per
// batch row looping over the h heads. P1's whole-row softmax and rounding.
// Returns as missm_probe_rows_attention (a head's K and V must fit in
// shared memory).
extern "C" int missm_probe_scratch_attention(const void* q, const void* k,
                                             const void* v, void* out, int b,
                                             int n, int h, int head_dim,
                                             int is_bf16, float scale,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim != kHD || n < 1 || b < 1 || h < 1 || (long)b * h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!is_bf16) return launch_scratch_f32(q, k, v, out, b, n, h, scale, s);
  if (scratch_wgs(n) == 2)
    return launch_scratch_bf16<2>(q, k, v, out, b, n, h, scale, s);
  return launch_scratch_bf16<1>(q, k, v, out, b, n, h, scale, s);
}

// The dynamic shared memory a bf16 launch at N = n asks for: kernel 0 the
// whole-row kernel at `rows` query rows a block (64 or 128), 1 the
// batch-row kernel, 2 the nostage kernel (n and rows unused); 0 for another
// kernel. What kernels/probe_attention.py::plan says.
extern "C" int missm_probe_attention_smem(int kernel, int n, int rows) {
  switch (kernel) {
    case 0: return rows == 64 || rows == 128 ? rows_smem(rows / 64) : 0;
    case 1: return scratch_smem(scratch_wgs(n), n);
    case 2: return nostage_smem();
    default: return 0;
  }
}
