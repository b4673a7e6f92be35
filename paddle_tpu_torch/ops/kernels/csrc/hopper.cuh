// Hopper (sm_90a) primitives shared by the bf16 kernels on wgmma fed by
// TMA: the GEMM engine of the fused blocks (wgmma_bf16.cuh, #10-#13) and
// the attention kernels (attn_wgmma.cuh, #2, #4, #5 and #6).
//
// - mbarriers: init, arrive, arrive with an expected transaction count, a
//   wait on a phase's parity that traps after kHangCycles (a barrier that
//   never completes ends the launch with an error rather than hanging the
//   card).
// - TMA: a 3-d tiled load of a tensor map's box into shared memory, and a
//   1-d bulk copy, each completing on an mbarrier; a 3-d tiled store of a
//   box from shared memory, waited on by bulk group; the host side builds
//   the maps (cuTensorMapEncodeTiled, fetched through the runtime: no
//   -lcuda) with the 128-byte swizzle and zero fill outside the tensor.
// - wgmma: the shared-memory matrix descriptor with the 128-byte swizzle,
//   the fence / commit / wait of a warpgroup, and wgmma.mma_async
//   m64nNk16 (N 64 or 128) bf16 x bf16 -> fp32 in its two forms: SS (A and
//   B from shared memory, each K-major or, by the transpose bits that
//   16-bit operands allow, MN-major) and RS (A from registers, B from
//   shared memory).
//
// Operand tiles in shared memory are slabs of 64 bf16 columns (128 bytes a
// row) written by TMA with the 128-byte swizzle, rows one after the other,
// each slab starting on 1024 bytes. Element (r, c) of a slab lies at
// r * 128 + ((c / 8) ^ (r % 8)) * 16 + (c % 8) * 2 (`swz`). Read through a
// descriptor:
// - K-major (k along the slab's columns; m or n along its rows): 8 rows of
//   128 bytes form a swizzle atom, SBO the stride of atoms along m or n
//   (1024), LBO unused; a 16-deep step is 32 bytes on within the slab.
// - MN-major (m or n along the slab's columns; k along its rows): one row
//   a k, SBO the stride of 8-deep groups along k (1024), LBO the stride
//   from one 64-wide slab to the next along m or n; a 16-deep step is 2048
//   bytes on.
//
// The accumulator of m64nNk16 (fp32): thread `tid` of the warpgroup holds
// d[4 j + 2 h + u] = C(16 (tid / 32) + (tid % 32) / 4 + 8 h,
// 8 j + 2 (tid % 4) + u), j < N / 8. An RS A operand (64 x 16, bf16) is
// four registers of bf16 pairs in the same rows and columns, so the
// accumulator's columns 16 s .. 16 s + 15, d[8 s .. 8 s + 7], become the A
// operand of step s as the pairs (d[8 s], d[8 s + 1]), (d[8 s + 2],
// d[8 s + 3]), (d[8 s + 4], d[8 s + 5]), (d[8 s + 6], d[8 s + 7]): an fp32
// intermediate goes back into a product with no data movement.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

using bf16 = __nv_bfloat16;

constexpr long long kHangCycles = 1LL << 34;  // ~9 s: a lost barrier traps
constexpr int kSlabCols = 64;                 // bf16 columns of a slab
constexpr int kSlabRowBytes = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of element (r, c) of a swizzled slab, c < 64
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * kSlabRowBytes + (((c >> 3) ^ (r & 7)) << 4) +
                    ((c & 7) << 1));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// until the phase of parity `parity` has completed; traps after
// kHangCycles, so that a barrier that never completes ends the launch
// with an error rather than hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity))
    if (clock64() - t0 > kHangCycles) __trap();
}

// orders this thread's generic-proxy writes to shared memory before later
// reads of it by the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// box (c0 inner, c1 outer, c2 plane) of `map` into dst, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// the box at src (shared memory, the map's swizzled layout) into box (c0
// inner, c1 outer, c2 plane) of `map`, elements outside the tensor
// skipped; in the bulk group of this thread's next bulk_commit
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// closes this thread's bulk group of the stores issued since the last one
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// until at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// until at most N of this thread's bulk groups are still in flight
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;" ::"n"(N) : "memory");
}

// `bytes` (a multiple of 16) from src (16-byte aligned) into dst,
// completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets (PTX ISA, "Matrix Descriptor
// Format"; layout type 1 in bits 62-63); see the note at the top.
__device__ __forceinline__ uint64_t desc(uint32_t saddr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// the descriptor of the matrix `bytes` (a multiple of 16) past the one d
// describes: its start address field, 14 bits of address / 16, takes the
// sum without a carry, shared memory being under 256 KB
__device__ __forceinline__ uint64_t desc_at(uint64_t d, uint32_t bytes) {
  return d + (bytes >> 4);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// tells the compiler the accumulators change here (wgmma writes them
// asynchronously): no read of them moves across
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HOPPER_D32(o)                                                       \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),           \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7]),       \
      "+f"(d[o + 8]), "+f"(d[o + 9]), "+f"(d[o + 10]), "+f"(d[o + 11]),     \
      "+f"(d[o + 12]), "+f"(d[o + 13]), "+f"(d[o + 14]), "+f"(d[o + 15]),   \
      "+f"(d[o + 16]), "+f"(d[o + 17]), "+f"(d[o + 18]), "+f"(d[o + 19]),   \
      "+f"(d[o + 20]), "+f"(d[o + 21]), "+f"(d[o + 22]), "+f"(d[o + 23]),   \
      "+f"(d[o + 24]), "+f"(d[o + 25]), "+f"(d[o + 26]), "+f"(d[o + 27]),   \
      "+f"(d[o + 28]), "+f"(d[o + 29]), "+f"(d[o + 30]), "+f"(d[o + 31])

// d (+)= A B over one 16-deep step, m64nNk16, bf16 in, fp32 accumulation,
// A and B from shared memory (descriptors da, db); TA / TB: A / B
// MN-major; accumulate 0: d = A B
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  static_assert(N == 64 || N == 128, "N 64 or 128");
  if constexpr (N == 64) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, %36;\n"
        "}\n"
        : HOPPER_D32(0)
        : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, %68;\n"
        "}\n"
        : HOPPER_D32(0), HOPPER_D32(32)
        : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
  }
}

// The same with A from registers: a[4], bf16 pairs in the accumulator's
// rows and columns (see the note at the top); TB: B MN-major
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  static_assert(N == 64 || N == 128, "N 64 or 128");
  if constexpr (N == 64) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
        "}\n"
        : HOPPER_D32(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate), "n"(TB));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
        "}\n"
        : HOPPER_D32(0), HOPPER_D32(32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate), "n"(TB));
  }
}

#undef HOPPER_D32

// the card's SM count, read once
inline int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        count <= 0)
      count = 132;
  }
  return count;
}

// An operand in device memory: `planes` row-major [outer][inner] bf16
// matrices one after the other (inner a multiple of 8, the base on 16
// bytes: TMA's stride and address rules).
struct Operand {
  const void* p;
  int64_t inner, outer;
  int planes;
};

using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, fetched once through the runtime
inline EncodeFn encode_fn() {
  static const EncodeFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeFn>(f)
               : nullptr;
  }();
  return fn;
}

// the map of `o` with boxes of 64 inner x box_outer, one plane a box,
// the 128-byte swizzle and zero fill outside the matrix
inline cudaError_t make_map(CUtensorMap* map, const Operand& o,
                            int box_outer) {
  const EncodeFn fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  if (o.inner % 8 != 0 || reinterpret_cast<uintptr_t>(o.p) % 16 != 0 ||
      o.planes < 1)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)o.inner, (cuuint64_t)o.outer,
                              (cuuint64_t)o.planes};
  const cuuint64_t strides[2] = {(cuuint64_t)o.inner * 2,
                                 (cuuint64_t)(o.inner * o.outer * 2)};
  const cuuint32_t box[3] = {(cuuint32_t)kSlabCols, (cuuint32_t)box_outer,
                             1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(o.p), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
