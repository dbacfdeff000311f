// Hopper (sm_90a) building blocks shared by the attention kernels
// (attention.cu, attention_bwd.cu, probe_attention.cu) and the GEMM-shaped
// ones (ln_linear.cu, mlp_bwd.cu): mbarriers, TMA tile loads, wgmma
// shared-memory descriptors, the wgmma forms the kernels issue, warp roles
// and thread block clusters. Plain C interface code only: no PyTorch
// headers.
//
// Tiles. A tile is `rows` rows of one head's [N, HD] slice of a [B, N, H*HD]
// bf16 tensor, brought into shared memory by TMA as HD / kCols chunks of
// [rows, kCols] (chunk c at c * rows * kRowBytes), each swizzled as wgmma
// reads it: 128-byte rows with the 128B swizzle when HD is a multiple of 64
// (the main path's HD = 64), else 32-byte rows (16 columns) with the 32B
// swizzle. The tensor map is 3-D over [B, N, H*HD], so TMA zero-fills the rows
// past N of each batch element and no tile reaches into the next sample.
//
// wgmma reads a tile either K-major (its rows are wgmma's M or N, its columns
// the reduction: Q, K in Q.K^T) or MN-major (its rows are the reduction, its
// columns wgmma's N: V in P.V). An MN-major product is issued once per chunk
// (N = kCols), so no descriptor spans two chunks.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <utility>

namespace hopper {

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda that the process has loaded (the
// runtime does not export it; linking libcuda would tie the build to a stub).
inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// A map over x = [b, n, d] bf16 whose box is `rows` rows by `cols` columns
// (cols = 64: 128B swizzle; cols = 16: 32B swizzle). Returns a cudaError_t.
inline int encode_rows(CUtensorMap* map, const void* x, int b, int n, int d,
                       int rows, int cols) {
  EncodeTiled encode = encoder();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)b};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)n * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory beyond 48 KB needs the attribute before the launch.
// `done` is the caller's own flag for this kernel (a static in the launcher
// template instance that launches it), a bit per device: the attribute is set
// once per kernel and device and holds for the process, so the later calls
// make no API call. Returns the error.
template <typename Kernel>
inline int allow_smem(Kernel kernel, int bytes, unsigned long long& done) {
  int device = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (bit && (done & bit)) return 0;
  rc = cudaFuncSetAttribute(kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc == cudaSuccess) done |= bit;
  return static_cast<int>(rc);
}

// ---------------------------------------------------------------------------
// device: barriers and copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory rounded up to 1024 bytes (the 128B swizzle's
// period); the launch allocates 1024 bytes more than the kernel uses.
__device__ __forceinline__ uint8_t* align_smem(uint8_t* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The calling thread arrives and the phase completes once `bytes` more have
// landed.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Waits for the phase of parity `phase` to complete. A phase that never
// completes (a copy that cannot land) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int phase) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 25)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(phase)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// L2 eviction policies for the cache-hinted copies: data read again soon
// (evict last) and data streamed out once (evict first).
__device__ __forceinline__ uint64_t policy_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t policy_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

// tma_load with an L2 eviction policy.
__device__ __forceinline__ void tma_load_hint(void* dst, const CUtensorMap* map,
                                              uint64_t* bar, int c0, int c1,
                                              int c2, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes.L2::cache_hint [%0], [%1, {%2, %3, %4}], [%5], "
      "%6;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

// The tile at `src` in shared memory to the box at (c0, c1, c2) of the map's
// tensor (rows past its end are not written), in this thread's bulk group,
// with an L2 eviction policy.
__device__ __forceinline__ void tma_store_hint(const CUtensorMap* map,
                                               const void* src, int c0,
                                               int c1, int c2,
                                               uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group.L2::cache_hint "
      "[%0, {%1, %2, %3}], [%4], %5;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(src)), "l"(policy)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Until this thread's bulk groups have read their shared memory (READ) or
// completed.
template <bool READ>
__device__ __forceinline__ void bulk_wait() {
  if (READ)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// device: tiles and wgmma descriptors
// ---------------------------------------------------------------------------

template <int HD>
struct Tiles {
  static constexpr int kCols = HD % 64 == 0 ? 64 : 16;  // columns per chunk
  static constexpr int kRowBytes = 2 * kCols;
  static constexpr int kChunks = HD / kCols;
  static constexpr uint64_t kLayout = kCols == 64 ? 1 : 3;  // 128B : 32B

  static __device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                                  uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
           (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
           (kLayout << 62);
  }
  // K-major operand: columns [16 kk, 16 kk + 16) of a tile of `rows` rows.
  static __device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows,
                                                    int kk) {
    const uint32_t col = kk * 16;
    return desc(tile + (col / kCols) * rows * kRowBytes + (col % kCols) * 2,
                16, 8 * kRowBytes);
  }
  // MN-major operand: rows [16 kk, 16 kk + 16) of chunk c.
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows,
                                                     int kk, int c) {
    return desc(tile + c * rows * kRowBytes + kk * 16 * kRowBytes,
                rows * kRowBytes, 8 * kRowBytes);
  }
  // TMA of the tile of `rows` rows from row0 of head `head`, batch b; the
  // barrier expects rows * HD * 2 bytes for it.
  static __device__ __forceinline__ void load(uint8_t* tile, int rows,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int head,
                                              int row0, int b) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      tma_load(tile + c * rows * kRowBytes, map, bar, head * HD + c * kCols,
               row0, b);
  }
};

// ---------------------------------------------------------------------------
// device: wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pins registers in place around asynchronous wgmma: no read or write of
// them moves across this point. Every accumulator and register operand is
// pinned before wgmma_fence (so its writes precede the products) and every
// accumulator after wgmma_wait (so its reads follow them).
template <int R>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (*a)[4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// 2^x on the SFU in one instruction (subnormal results flush to 0; the
// exponentials of a softmax are summed against at least one 1).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats -> packed bf16x2, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The register A operand of k-step kk (16 columns) from the f32 accumulator
// of an m64nN product, rounded to bf16: in wgmma's accumulator layout the
// entries of two neighbouring 8-column groups are exactly the A fragment of
// one 16-column step. Columns at or past N (a narrow last tile) are zero.
template <int N>
__device__ __forceinline__ void acc_to_a(const float* acc, int kk,
                                         uint32_t a[4]) {
  a[0] = pack_bf16(acc[8 * kk + 0], acc[8 * kk + 1]);
  a[1] = pack_bf16(acc[8 * kk + 2], acc[8 * kk + 3]);
  if (16 * kk + 8 < N) {
    a[2] = pack_bf16(acc[8 * kk + 4], acc[8 * kk + 5]);
    a[3] = pack_bf16(acc[8 * kk + 6], acc[8 * kk + 7]);
  } else {
    a[2] = a[3] = 0u;
  }
}

// D[64 x N] (+)= A . B, both operands K-major in shared memory; acc = 0
// overwrites D. One warpgroup; D in wgmma's accumulator layout (per warp w,
// lane (g, t): d[4j + e] is row 16w + g + 8 (e >> 1), column 8j + 2t + (e & 1)).
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int acc);
// D[64 x N] (+)= A . B, A from registers (acc_to_a), B MN-major in shared
// memory.
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t a[4],
                                         uint64_t b, int acc);

template <>
__device__ __forceinline__ void wgmma_ss<8>(float* d, uint64_t a, uint64_t b,
                                            int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<16>(float* d, uint64_t a, uint64_t b,
                                            int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<24>(float* d, uint64_t a, uint64_t b,
                                            int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, %12, %13, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float* d, uint64_t a, uint64_t b,
                                            int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<40>(float* d, uint64_t a, uint64_t b,
                                            int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, %20, %21, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<48>(float* d, uint64_t a, uint64_t b,
                                            int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<56>(float* d, uint64_t a, uint64_t b,
                                            int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %30, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27}, %28, %29, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t a, uint64_t b,
                                            int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t a[4],
                                            uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t a[4],
                                            uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}


template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t a, uint64_t b,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<256>(float* d, uint64_t a, uint64_t b,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t a[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float* d, const uint32_t a[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// ---------------------------------------------------------------------------
// device: the GEMM kernels' parts (ln_linear.cu, mlp_bwd.cu): register
// hand-over, pipelined waits, named barriers, ldmatrix, thread block clusters
// ---------------------------------------------------------------------------

// Registers handed from a producer warpgroup to the consumers: all four
// warps of a warpgroup execute it together.
template <int R>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Waits until at most N committed wgmma groups of the warp are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait_n() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// A barrier over `count` threads (a multiple of 32) under id (1-15).
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The calling thread's arrival on a local barrier.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Generic-proxy writes to shared memory made visible to the async proxy
// (wgmma operands, bulk copies), and the converse.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Four 8 x 8 bf16 matrices; lanes 8j to 8j + 7 give the row addresses of
// matrix j, and lane l receives of each matrix elements 2 (l % 4) and
// 2 (l % 4) + 1 of row l / 4.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The byte offset of 16-byte chunk `chunk` (0-7) of row `row` in a tile of
// 128-byte rows with the 128B swizzle (the tile 1024-byte aligned).
__device__ __forceinline__ uint32_t swz128(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// The 128B-swizzled K-major descriptor of columns [16 kk, 16 kk + 16) of a
// tile of 128-byte rows (any number of rows, 8-row groups 1024 bytes apart).
__device__ __forceinline__ uint64_t kmajor128(uint32_t tile, int kk) {
  return Tiles<64>::desc(tile + kk * 32, 16, 1024);
}
// The 128B-swizzled MN-major descriptor of rows [16 kk, 16 kk + 16) of a
// tile of 64-column chunks, each `rows` rows of 128 bytes: one product of
// N up to 256 spans the chunks, `rows` * 128 bytes apart.
__device__ __forceinline__ uint64_t mnmajor128(uint32_t tile, int rows,
                                               int kk) {
  return Tiles<64>::desc(tile + kk * 16 * 128, rows * 128, 1024);
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster arrives, then waits: shared
// memory written before it by any of them is visible after it to all.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// The two halves of cluster_sync, for a thread that has work between them.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address in block `rank`'s shared memory of the local address `addr`.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}

// One arrival on the barrier at local address `bar` of block `rank`,
// releasing at cluster scope what the thread wrote before it.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    uint32_t rank) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          mapa(smem_u32(bar), rank))
      : "memory");
}

// mbar_wait, acquiring at cluster scope (arrivals from other blocks).
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int phase) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 25)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(phase)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from local shared memory at `src` to the same
// offset in block `rank`'s, completing on that block's barrier `bar`.
__device__ __forceinline__ void copy_to_peer(const void* src, uint32_t bytes,
                                             uint64_t* bar, uint32_t rank) {
  const uint32_t s = smem_u32(src);
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(mapa(s, rank)),
      "r"(s), "r"(bytes), "r"(mapa(smem_u32(bar), rank))
      : "memory");
}

// ---------------------------------------------------------------------------
// host: cluster launch
// ---------------------------------------------------------------------------

// How many clusters of `cluster` blocks of `threads` threads and `smem`
// bytes of dynamic shared memory the card runs at once
// (cudaOccupancyMaxActiveClusters); a negative cudaError_t on failure.
template <typename... Params>
inline int active_clusters(void (*kernel)(Params...), int threads, int smem,
                           int cluster) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (rc == cudaSuccess) rc = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return rc == cudaSuccess ? n : -static_cast<int>(rc);
}

// Launches kernel<<<grid, threads, smem, stream>>>(args...) in clusters of
// `cluster` blocks along x (grid a multiple of it). Returns the error.
template <typename... Params, typename... Args>
inline int launch_cluster(void (*kernel)(Params...), int grid, int threads,
                          int smem, cudaStream_t stream, int cluster,
                          Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...));
}

}  // namespace hopper
