// A bf16 matrix product engine for Hopper (sm_90a): wgmma.mma_async fed by
// TMA, for the bf16 instances of the fused blocks: the FFN block
// (ffn_block.cu's ffn_block_fwd_bf16 and ffn_block_bwd_bf16, all six of
// their products) and the attention block (attention_block.cu's
// attention_block_fwd_bf16 and attention_block_bwd_bf16: x Wqkv, ctx Wo,
// ctx^T g, g Wo^T, x^T dqkv and dqkv Wqkv^T, each in one of the FFN's six
// operand layouts).
//
// Replaces, on the bf16 path: paddle_tpu/ops/pallas/ffn_block.py
// `_fwd_impl` and `_bwd_impl` and the dense products of
// paddle_tpu/ops/pallas/attention_block.py `_fwd_impl` and `_bwd_impl`
// (with ffn_block.cu and attention_block.cu, which run their products
// here), whose products the TPU computes in fp32 on upcast bf16 operands.
//
// What bounds it on an H100: operations. At x [64, 256, 512], F 2048 the
// forward runs 103.1 G flops of products as this engine runs them and the
// backward 274.9 G (an operand kept as two bf16 planes counts twice) on
// 2.2-3.2 MB a product of weights and 16-134 MB of activations: far above
// the 295 flops a byte at which the bf16 tensor cores (989 TFLOP/s) meet
// the memory (3.35 TB/s). Only wgmma reaches that rate; mma.sync does not.
//
// What the design does about it:
// - Every operand in shared memory is bf16 and arrives by TMA, in 64-deep
//   slabs with the 128-byte swizzle. The FFN's fp32 intermediates h and dh
//   live in device memory as two bf16 planes, hi = bf16_rn(v) and lo =
//   bf16_rn(v - hi) (v - hi is exact in fp32; hi + lo is within 2^-17 of
//   v), written by the epilogue of the product that makes them. A product
//   with a planed operand runs two wgmmas a 16-deep step (hi and lo) into
//   one fp32 accumulator; two bf16 operands run one. Each product of two
//   bf16 values is exact in fp32, as after the TPU kernel's upcast. No
//   thread widens or splits an operand in the main loop.
// - The shared-memory descriptors read each operand as it lies in device
//   memory: K-major (k contiguous) or MN-major (m or n contiguous), by
//   wgmma's transpose bits, which 16-bit operands allow. So x^T dh, h^T g,
//   g W2^T and dh W1^T need no transposing pass.
// - A block computes a 128 x 128 tile of C: two consumer warpgroups each
//   issue wgmma.mma_async.m64n128k16 on 64 rows; one producer warp keeps
//   TMA loads in flight into a ring of 192 KB behind mbarriers (a full
//   barrier a stage, which TMA's transaction count completes, and an empty
//   barrier that the 8 consumer warps release after their wgmmas on it have
//   retired): 6 stages of two single-plane slabs, 4 where a planed operand
//   doubles its slab. One block an SM.
// - The accumulation: a chain of wgmmas into one fp32 accumulator loses
//   bits as it grows (against float64 on an H100: 1.4-3.2e-6 of the
//   largest row-by-column sum of |products| at a depth of 32768, where
//   torch.matmul's fp32 product reads 1.5e-8; chip_smoke.py's
//   `_ffn_layouts`). So each group of 4 slabs (256 deep) goes into a
//   fresh accumulator, added to the running sum in fp32 once its wgmmas
//   have retired (1.9-3.0e-8 at 32768). A thread holds the two, 128 fp32
//   values, in the 224 registers one block an SM leaves it, without
//   setmaxnreg.
// - Epilogues, through shared memory: the accumulators' fragments go into
//   the ring (free once both warpgroups' wgmmas have retired) as rows of
//   C, which each warpgroup then writes in 16-byte chunks of whole rows,
//   rows past m and chunks past n skipped: bias + ReLU into the h planes;
//   the ReLU mask (hi + lo > 0, read from the h planes) into the dh planes
//   over h in place, each thread reading the mask of exactly the chunks
//   it then writes, all of them before its first store; hi/lo planes
//   alone (the attention block's qkv and dctx); bias (or none) to bf16;
//   fp32 to a workspace of k slices, or unsplit to C (the attention
//   block's qkv for its forward's fp32 scores).
// - A weight gradient (dW2 = h^T g, dW1 = x^T dh: 64 tiles over 16384-32768
//   rows) is split along k into slices of whole slabs, as many as keep
//   the card's SMs in one wave, each written in fp32 to the workspace and
//   summed in their fixed order by tile_mma.cuh's sum_slices_kernel,
//   rounded once: no atomics, two launches give the same bits. Column sums
//   of the planes (db1) sum hi + lo in fp32 in a fixed order, like
//   tile_mma::colsum.
// - Ragged edges come from TMA's zero fill on loads (n not a multiple of
//   128, d or f a multiple of 8 but not of 64) and from the skipped chunks.
// - The tensor maps are built on the host by cuTensorMapEncodeTiled,
//   fetched through cudaGetDriverEntryPoint (no -lcuda), and passed as
//   `const __grid_constant__` kernel parameters: a CUDA graph that
//   captures a launch captures its maps by value, and its replays keep
//   the addresses the maps hold. The dynamic shared memory attribute is
//   set once a process for each library, at a kernel's first launch,
//   which run_steps makes eagerly before it captures.
// What it still leaves: the [N, F] planes go through device memory (about
// 0.08 ms each way at x [64, 256, 512], F 2048); the grid does not persist,
// so a block's epilogue does not overlap its next tile's products, and the
// last wave of a product may leave SMs idle.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tile_mma.cuh"

namespace wgmma_bf16 {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128, kBN = 128, kBK = 64;  // block tile, slab depth
constexpr int kConsumers = 256;                // two warpgroups
constexpr int kThreads = kConsumers + 32;      // and one producer warp
constexpr int kTileBytes = kBM * kBK * 2;      // one plane of a slab: 16 KB
constexpr int kHalfBytes = kTileBytes / 2;     // 64 rows (or columns)
constexpr int kRingBytes = 192 * 1024;         // one block an SM
constexpr int kGroup = 4;  // slabs a fresh accumulator takes (256 deep)

enum Epilogue {
  kHidden = 0,  // relu(. + bias[j]) into hi/lo planes
  kMask = 1,    // kept where the planes at C hold hi + lo > 0, into them
  kBias = 2,    // . (+ bias[j] where bias is given) rounded to bf16
  kF32 = 3,     // fp32, slice s of k at c + s * m * n
  kSplit = 4,   // . into hi/lo planes
};

// ring stages: 6 of two single-plane operands, 4 with a planed one
template <int PA, int PB>
constexpr int kStages = kRingBytes / ((PA + PB) * kTileBytes);

template <int PA, int PB>
constexpr size_t kSmemBytes =
    (size_t)kStages<PA, PB> * (PA + PB) * kTileBytes + 1024;  // + alignment

struct Args {
  int64_t m, n, k;
  int64_t k_chunk;  // depth of one slice (whole slabs)
  void* c;          // bf16 (planes) or fp32, by the epilogue
  int64_t ldc;
  int64_t plane;    // elements from the hi plane to the lo plane
  const bf16* bias;
};

using hopper::desc;
using hopper::fence_acc;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;
using hopper::tma_load;
using hopper::wg_commit;
using hopper::wg_fence;
using hopper::wg_wait;

// d += A B over one 16-deep step, m64n128k16, bf16 in, fp32 accumulation;
// TA / TB: A / B MN-major
template <int TA, int TB>
__device__ __forceinline__ void mma(float (&d)[64], uint64_t da,
                                    uint64_t db, int accumulate) {
  hopper::wgmma_ss<128, TA, TB>(d, da, db, accumulate);
}

// C = op(A) op(B) [epilogue] on a 128 x 128 tile a block. A is [m, k]: the
// map `ma` holds it K-major ([m][k], box 64 x 128) or, TA, MN-major ([k][m],
// box 64 x 64, two boxes a slab); B is [k, n]: K-major ([n][k]) or, TB,
// MN-major ([k][n]). PA, PB: planes of each (1, or 2 for hi and lo, the
// map's third dimension). Slice blockIdx.z of k (k_chunk deep) when split.
// G: slabs a fresh accumulator takes (0: one for the whole slice, a
// test's control).
template <bool TA, bool TB, int PA, int PB, int EPI, int G>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap ma,
                const __grid_constant__ CUtensorMap mb, const Args p) {
  constexpr int S = kStages<PA, PB>;
  constexpr uint32_t kStageBytes = (PA + PB) * kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  // the 128-byte swizzle repeats every 1024 bytes: the ring starts on one
  uint8_t* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int64_t m0 = (int64_t)blockIdx.y * kBM, n0 = (int64_t)blockIdx.x * kBN;
  const int64_t kbeg = (int64_t)blockIdx.z * p.k_chunk;
  const int64_t kend = kbeg + p.k_chunk < p.k ? kbeg + p.k_chunk : p.k;
  const int slabs = kbeg < kend ? (int)((kend - kbeg + kBK - 1) / kBK) : 0;

  if (tid >= kConsumers) {
    // the producer warp: one thread keeps the ring full
    if (tid == kConsumers) {
      for (int it = 0; it < slabs; ++it) {
        const int s = it % S;
        if (it >= S) mbar_wait(&empty[s], ((it / S) - 1) & 1);
        mbar_expect_tx(&full[s], kStageBytes);
        const int k0 = (int)(kbeg + (int64_t)it * kBK);
        uint8_t* sa = ring + s * kStageBytes;
        uint8_t* sb = sa + PA * kTileBytes;
#pragma unroll
        for (int pl = 0; pl < PA; ++pl) {
          if (TA) {
            tma_load(sa + pl * kTileBytes, &ma, &full[s], (int)m0, k0, pl);
            tma_load(sa + pl * kTileBytes + kHalfBytes, &ma, &full[s],
                     (int)m0 + 64, k0, pl);
          } else {
            tma_load(sa + pl * kTileBytes, &ma, &full[s], k0, (int)m0, pl);
          }
        }
#pragma unroll
        for (int pl = 0; pl < PB; ++pl) {
          if (TB) {
            tma_load(sb + pl * kTileBytes, &mb, &full[s], (int)n0, k0, pl);
            tma_load(sb + pl * kTileBytes + kHalfBytes, &mb, &full[s],
                     (int)n0 + 64, k0, pl);
          } else {
            tma_load(sb + pl * kTileBytes, &mb, &full[s], k0, (int)n0, pl);
          }
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg computes rows 64 wg .. 64 wg + 63. Each
  // group of G slabs goes into a fresh accumulator t (its first
  // wgmma does not read t), added to the running sum d in fp32 once the
  // group's wgmmas have retired: a wgmma chain's fp32 sums lose bits over
  // thousands of terms.
  const int wg = tid / 128;
  constexpr int kG = G > 0 ? G : 1 << 30;  // G 0: one group for all
  float d[64], t[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = t[i] = 0.f;
  int released = 0;  // slabs whose stage this warp has given back
  for (int it = 0; it < slabs; ++it) {
    const int s = it % S;
    mbar_wait(&full[s], (it / S) & 1);
    const uint32_t sa = smem_u32(ring + s * kStageBytes);
    const uint32_t sb = sa + PA * kTileBytes;
    const bool fresh = it % kG == 0;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int pa = 0; pa < PA; ++pa) {
        // A K-major: this warpgroup's 64 rows of 128 bytes, 32 bytes a
        // step; MN-major: its 64-column half, 16 rows of 128 bytes a step
        const uint64_t da =
            TA ? desc(sa + pa * kTileBytes + wg * kHalfBytes + kk * 2048,
                      kHalfBytes, 1024)
               : desc(sa + pa * kTileBytes + wg * kHalfBytes + kk * 32, 16,
                      1024);
#pragma unroll
        for (int pb = 0; pb < PB; ++pb) {
          const uint64_t db =
              TB ? desc(sb + pb * kTileBytes + kk * 2048, kHalfBytes, 1024)
                 : desc(sb + pb * kTileBytes + kk * 32, 16, 1024);
          mma<TA, TB>(t, da, db, !(fresh && kk == 0 && pa == 0 && pb == 0));
        }
      }
    }
    wg_commit();
    const bool group_end = (it + 1) % kG == 0 || it + 1 == slabs;
    int upto = it;
    if (group_end) {
      wg_wait<0>();  // this group's wgmmas have retired
      upto = it + 1;
    } else {
      wg_wait<1>();  // the previous slab's wgmmas have retired
    }
    for (; released < upto; ++released)
      if (tid % 32 == 0) mbar_arrive(&empty[released % S]);
    if (group_end) {
      fence_acc(t);
#pragma unroll
      for (int i = 0; i < 64; ++i) d[i] += t[i];
    }
  }
  fence_acc(d);

  // The epilogue goes through shared memory, so that C is written (and
  // the mask read) in whole 16-byte chunks of whole rows. Every load of
  // the ring has landed and every wgmma of both warpgroups has retired
  // past this barrier: the ring becomes each warpgroup's staging tile,
  // 64 rows of C, padded by 16 (bf16) or 32 (fp32) bytes so that the
  // fragments' stores hit distinct banks.
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
  constexpr int kEB = EPI == kF32 ? 4 : 2;  // bytes of an element of C
  constexpr int kPitch = kBN * kEB + (EPI == kF32 ? 32 : 16);
  constexpr int kPlanes =
      EPI == kHidden || EPI == kMask || EPI == kSplit ? 2 : 1;
  static_assert(2 * kPlanes * 64 * kPitch <= kRingBytes, "staging fits");
  uint8_t* stage = ring + wg * kPlanes * 64 * kPitch;
  // d[4 j + 2 h + u] is C(r + 8 h, 8 j + 2 q + u) of this warpgroup's
  // 64 x 128, r = 16 warp + lane / 4, q = lane % 4
  const int lane = tid % 32, warp = (tid / 32) % 4;
  const int r0 = 16 * warp + lane / 4, q2 = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int cl = 8 * j + q2;
    float e0 = 0.f, e1 = 0.f;
    if constexpr (EPI == kHidden || EPI == kBias) {
      const int64_t col = n0 + cl;
      if (p.bias != nullptr && col < p.n) {
        e0 = __bfloat162float(p.bias[col]);
        e1 = __bfloat162float(p.bias[col + 1]);  // n is even
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = d[4 * j + 2 * h] + e0, v1 = d[4 * j + 2 * h + 1] + e1;
      uint8_t* at = stage + (r0 + 8 * h) * kPitch + cl * kEB;
      if constexpr (EPI == kF32) {
        *reinterpret_cast<float2*>(at) = make_float2(v0, v1);
      } else {
        if constexpr (EPI == kHidden) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(at) = hi;
        if constexpr (kPlanes == 2) {
          const float2 hf = __bfloat1622float2(hi);
          *reinterpret_cast<__nv_bfloat162*>(at + 64 * kPitch) =
              __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
        }
      }
    }
  }
  asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");

  // staging -> C, 16 bytes a thread a step, a row's chunks on neighbouring
  // threads; rows past m and chunks past n (a multiple of 8) are skipped
  constexpr int kChunks = kBN * kEB / 16;      // of a row
  constexpr int kSteps = 64 * kChunks / 128;   // of a thread
  constexpr int kPerChunk = 16 / kEB;          // elements
  const int ltid = tid % 128;
  const int64_t mbase = m0 + 64 * wg;
  auto chunk_at = [&](int st, int64_t& off) {
    const int i = ltid + st * 128, r = i / kChunks, ch = i % kChunks;
    const int64_t row = mbase + r, col = n0 + ch * kPerChunk;
    off = row * p.ldc + col;
    return row < p.m && col < p.n ? r * kPitch + ch * 16 : -1;
  };
  if constexpr (EPI == kF32) {
    float* c = static_cast<float*>(p.c) + (int64_t)blockIdx.z * p.m * p.n;
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      int64_t off;
      const int sat = chunk_at(st, off);
      if (sat >= 0)
        *reinterpret_cast<uint4*>(c + off) =
            *reinterpret_cast<const uint4*>(stage + sat);
    }
  } else {
    bf16* c = static_cast<bf16*>(p.c);
    // kMask: each thread reads the mask of exactly the chunks it then
    // writes, all of them before its first store (dh goes over h)
    uint32_t keep[kSteps];
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      keep[st] = 0xffu;
      if constexpr (EPI == kMask) {
        int64_t off;
        if (chunk_at(st, off) >= 0) {
          const uint4 hi = *reinterpret_cast<const uint4*>(c + off);
          const uint4 lo = *reinterpret_cast<const uint4*>(c + p.plane + off);
          const uint32_t hw[4] = {hi.x, hi.y, hi.z, hi.w};
          const uint32_t lw[4] = {lo.x, lo.y, lo.z, lo.w};
          uint32_t bits = 0;
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            // a bf16 is the high half of its fp32
            if (__uint_as_float(hw[w] << 16) + __uint_as_float(lw[w] << 16) >
                0.f)
              bits |= 1u << (2 * w);
            if (__uint_as_float(hw[w] & 0xffff0000u) +
                    __uint_as_float(lw[w] & 0xffff0000u) >
                0.f)
              bits |= 2u << (2 * w);
          }
          keep[st] = bits;
        }
      }
    }
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      int64_t off;
      const int sat = chunk_at(st, off);
      if (sat < 0) continue;
#pragma unroll
      for (int pl = 0; pl < kPlanes; ++pl) {
        uint4 v = *reinterpret_cast<const uint4*>(stage + pl * 64 * kPitch +
                                                  sat);
        if constexpr (EPI == kMask) {
          uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            w[e] &= ((keep[st] >> (2 * e)) & 1u ? 0x0000ffffu : 0u) |
                    ((keep[st] >> (2 * e + 1)) & 1u ? 0xffff0000u : 0u);
        }
        *reinterpret_cast<uint4*>(c + pl * p.plane + off) = v;
      }
    }
  }
}

using hopper::make_map;
using hopper::Operand;

// the kernel's dynamic shared memory limit, set once a process in each
// library built from this header. Internal linkage: a template's
// function-local static is otherwise one object across every loaded
// library (GNU unique symbols), and a second library holding the same
// instance (ffn_block.cu and attention_block.cu both do) would launch its
// own copy of the kernel without the attribute.
namespace {
template <bool TA, bool TB, int PA, int PB, int EPI, int G>
cudaError_t smem_attr() {
  static const cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<TA, TB, PA, PB, EPI, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes<PA, PB>);
  return err;
}
}  // namespace

// C [m, n] = op(A) op(B) with epilogue EPI. a, b: A [m, k] and B [k, n] as
// they lie (see gemm_kernel: TA, TB pick MN-major), with PA, PB planes;
// c, ldc, plane (hi to lo, for planed C) and bias as the epilogue reads
// them. kF32 with `ws` (ws_floats values): when the tile grid fills less
// than the card, split along k into at most 16 slices of whole slabs, none
// shallower than 512, into ws, summed in order into c as bf16 (the
// weight gradients); kF32 without ws writes fp32 C unsplit. G: slabs a
// fresh accumulator takes (0: one for the whole slice, a test's control).
template <bool TA, bool TB, int PA, int PB, int EPI, int G = kGroup>
inline cudaError_t gemm(const Operand& a, const Operand& b, int64_t m,
                        int64_t n, int64_t k, void* c, int64_t ldc,
                        int64_t plane, const bf16* bias, float* ws,
                        int64_t ws_floats, cudaStream_t st) {
  if (m <= 0 || n <= 0 || k <= 0 || n % 8 != 0 || ldc % 8 != 0 ||
      plane % 8 != 0 || reinterpret_cast<uintptr_t>(c) % 16 != 0 ||
      a.planes != PA || b.planes != PB ||
      (EPI == kHidden && bias == nullptr) ||
      (a.inner != (TA ? m : k)) || (a.outer != (TA ? k : m)) ||
      (b.inner != (TB ? n : k)) || (b.outer != (TB ? k : n)))
    return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  cudaError_t err = make_map(&ma, a, TA ? 64 : kBM);
  if (err != cudaSuccess) return err;
  if ((err = make_map(&mb, b, TB ? 64 : kBN)) != cudaSuccess) return err;
  if ((err = smem_attr<TA, TB, PA, PB, EPI, G>()) != cudaSuccess) return err;
  const int64_t tiles = ((m + kBM - 1) / kBM) * ((n + kBN - 1) / kBN);
  int64_t splits = 1;
  if (EPI == kF32 && ws != nullptr && ldc == n) {
    splits = tile_mma::sm_count() / tiles;  // one wave
    splits = tile_mma::imin(splits, 16);
    splits = tile_mma::imin(splits, k / 512);
    splits = tile_mma::imin(splits, ws_floats / (m * n));
    if (splits < 1) splits = 1;
  }
  Args p = {};
  p.m = m;
  p.n = n;
  p.k = k;
  p.k_chunk = ((k + splits - 1) / splits + kBK - 1) / kBK * kBK;
  splits = (k + p.k_chunk - 1) / p.k_chunk;
  const bool to_ws = EPI == kF32 && ws != nullptr;
  p.c = to_ws ? static_cast<void*>(ws) : c;
  p.ldc = to_ws ? n : ldc;
  p.plane = plane;
  p.bias = bias;
  const dim3 grid((unsigned)((n + kBN - 1) / kBN),
                  (unsigned)((m + kBM - 1) / kBM), (unsigned)splits);
  constexpr size_t smem = kSmemBytes<PA, PB>;
  gemm_kernel<TA, TB, PA, PB, EPI, G><<<grid, kThreads, smem, st>>>(ma, mb,
                                                                    p);
  if ((err = cudaGetLastError()) != cudaSuccess || !to_ws) return err;
  const int64_t mn = m * n;
  const int64_t blocks =
      tile_mma::imin((mn + tile_mma::kThreads - 1) / tile_mma::kThreads, 4096);
  tile_mma::sum_slices_kernel<bf16>
      <<<(unsigned)blocks, tile_mma::kThreads, 0, st>>>(
          ws, static_cast<bf16*>(c), mn, (int)splits);
  return cudaGetLastError();
}

// out[j] = sum over rows i of (hi[i, j] + lo[i, j]), each term in fp32,
// in a fixed order (tile_mma::colsum's chunks, then its total pass),
// rounded once to bf16
__global__ void __launch_bounds__(tile_mma::kThreads)
    colsum_planes_chunks_kernel(const bf16* __restrict__ a,
                                float* __restrict__ ws, int64_t rows,
                                int64_t cols, int64_t plane, int64_t chunk) {
  constexpr int kCols = tile_mma::kSumCols, kLanes = tile_mma::kSumLanes;
  __shared__ float part[kLanes][kCols + 1];
  const int lane_c = threadIdx.x % kCols, lane_r = threadIdx.x / kCols;
  const int64_t col = (int64_t)blockIdx.x * kCols + lane_c;
  const int64_t r0 = (int64_t)blockIdx.y * chunk;
  const int64_t r1 = tile_mma::imin(rows, r0 + chunk);
  float s = 0.f;
  if (col < cols)
    for (int64_t r = r0 + lane_r; r < r1; r += kLanes) {
      const int64_t at = r * cols + col;
      s += __bfloat162float(a[at]) + __bfloat162float(a[plane + at]);
    }
  part[lane_r][lane_c] = s;
  __syncthreads();
  if (lane_r == 0 && col < cols) {
    float t = 0.f;
    for (int l = 0; l < kLanes; ++l) t += part[l][lane_c];
    ws[blockIdx.y * cols + col] = t;
  }
}

inline cudaError_t colsum_planes(const bf16* a, bf16* out, int64_t rows,
                                 int64_t cols, float* ws, int64_t ws_floats,
                                 cudaStream_t s) {
  if (rows <= 0 || cols <= 0 || ws == nullptr || ws_floats < cols)
    return cudaErrorInvalidValue;
  int64_t chunk = 128;
  while (chunk < rows && (rows + chunk - 1) / chunk * cols > ws_floats)
    chunk *= 2;
  const int64_t chunks = (rows + chunk - 1) / chunk;
  if (chunks > 65535) return cudaErrorInvalidValue;
  colsum_planes_chunks_kernel<<<
      dim3((unsigned)((cols + tile_mma::kSumCols - 1) / tile_mma::kSumCols),
           (unsigned)chunks),
      tile_mma::kThreads, 0, s>>>(a, ws, rows, cols, rows * cols, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tile_mma::colsum_total_kernel<bf16>
      <<<(unsigned)((cols + tile_mma::kThreads - 1) / tile_mma::kThreads),
         tile_mma::kThreads, 0, s>>>(ws, out, cols, chunks);
  return cudaGetLastError();
}

}  // namespace wgmma_bf16
