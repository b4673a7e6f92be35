// A tiled matrix product on Hopper's tensor cores (sm_90a), in split
// TF32 (split_tf32.cuh), with the deterministic column sum: the products
// of the attention block's forward and backward and of the FFN block's
// forward and backward in fp32 (the bias and ReLU of its hidden, the
// output's bias and the ReLU's mask on dh are epilogues here). The fused
// blocks' bf16 instances run their products on wgmma_bf16.cuh, which
// takes the slices' sum (sum_slices_kernel) and the column sum from here,
// each in fp32 and rounded once to bf16.
//
//   C = op(A) op(B)  [relu(. + bias[j]) | . + bias[j] |
//                     kept where mask(i, j) > 0]
//
// op(A) is [m, k]: A(i, kk) = a[i * lda + kk], or a[kk * lda + i] when A
// is transposed; op(B) is [k, n]: B(kk, j) = b[kk * ldb + j], or
// b[j * ldb + kk] when B is transposed. Leading dimensions let a product
// read a column slice of a wider row (one head's v inside a [rows, 3D] qkv
// buffer). A batch of products runs over blockIdx.z: batch z takes the
// offsets (z / inner) * outer_stride + (z % inner) * inner_stride of each
// operand, so a [B, H] grid of per-head products can address heads inside
// token rows. A product whose tile grid is too small to fill the card and
// whose depth is large (a weight gradient: [512, 1536] over 16384 rows) is
// split along k into slices that write their partial products to a
// workspace; a second pass sums the slices in their fixed order. No
// atomics: two launches give identical bits. The epilogues (a template
// parameter, so the product without one compiles as if they did not
// exist) take an unsplit, unbatched product whose A is not transposed:
// kBiasRelu gives max(c + bias[j], 0); kBias c + bias[j]; kMask keeps c
// where mask(i, j) = mask[i * ldm + j] > 0, else 0. A block stages its
// whole tile of the mask in shared memory before any of its threads writes
// C, so the mask may be C itself (dh written over h in place).
//
// What bounds it on an H100: operations. The attention block's backward
// runs six of these products at the training shape (B*T 16384, D 512):
// 94.5 GFLOP, 1.41 ms on the fp32 units (67 TFLOP/s), 0.57 ms on the
// tensor cores in split TF32 (three TF32 products for each fp32 one at
// 495 TFLOP/s); the FFN block's backward five (F 2048): 171.8 GFLOP,
// 2.56 ms and 1.04 ms.
//
// What the design does about it: a block of 8 warps computes a 128 x 128
// tile of C (128 x 64 where n <= 64, as for one head's context), each warp
// a 64 x 32 (32 x 32) sub-tile as mma.sync.m16n8k8 fragments, holding its
// B fragments of an 8-deep step and streaming its A fragments, so that a
// thread fits in 128 registers and two blocks share an SM (at most 112 KB
// of shared memory each): the second block's products hide the first's
// barriers and operand splitting. 32-deep
// slices of A and B come through a two-stage ring filled by cp.async with
// 16-byte copies (4-byte ones where a row start is not 16-byte aligned),
// each slice kept in the operand's own layout, as it lies in device
// memory, and split once as it lands by the threads that copied it: big
// halves in place, small halves into a second buffer. A slice whose rows
// run along k is padded by 4 floats a row and one whose rows run along m
// or n by 8, so that both ways of reading a fragment hit 32 distinct
// banks; a transposed operand is read with the transposed fragment
// pattern (load_a_t, load_b_t), not transposed in memory: cp.async lands
// 16 bytes only in the source's own order. Each 8-deep step's three
// products go into a fresh fragment added to the running sum in fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "split_tf32.cuh"

namespace tile_mma {

using split_tf32::OpA;
using split_tf32::OpB;
using bf16 = __nv_bfloat16;

enum Epilogue {
  kNone = 0,
  kBiasRelu = 1,  // max(. + bias[j], 0)
  kMask = 2,      // kept where mask(i, j) > 0, else 0
  kBias = 3,      // . + bias[j]
};

__host__ __device__ inline int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

constexpr int kBM = 128;  // rows of C a block computes
constexpr int kBK = 32;   // depth of one staged slice
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename E>
__device__ __forceinline__ E from_f(float x) {
  if constexpr (std::is_same<E, float>::value)
    return x;
  else
    return __float2bfloat16_rn(x);
}

// a, b, bias and c point at fp32 values.
struct Params {
  int64_t m, n, k;
  const void* a;
  int64_t lda;
  const void* b;
  int64_t ldb;
  void* c;
  int64_t ldc;
  int inner;  // batch z -> (z / inner, z % inner)
  int64_t a_outer, a_inner, b_outer, b_inner, c_outer, c_inner;
  int splits;       // > 1: slice s of k writes c + s * m * n (ldc == n)
  int64_t k_chunk;  // depth of one slice
  int vec_a, vec_b;  // 16-byte copies of A, B (set by gemm)
  const void* bias;  // [n], kBiasRelu and kBias
  const float* mask;  // mask(i, j) = mask[i * ldm + j], kMask
  int64_t ldm;
  int vec_m;  // 16-byte copies of the mask (set by gemm)
};

// c's epilogue, e the element's bias or mask
template <int EPI>
__device__ __forceinline__ float epilogue(float c, float e) {
  if constexpr (EPI == kBiasRelu) return fmaxf(c + e, 0.f);
  if constexpr (EPI == kMask) return e > 0.f ? c : 0.f;
  if constexpr (EPI == kBias) return c + e;
  return c;
}

// The staged slice of one operand: ROWS x COLS floats in the operand's
// own layout, rows padded to LD.
template <int ROWS, int COLS, bool ALONG_K>
struct Slice {
  static constexpr int kRows = ROWS, kCols = COLS;
  static constexpr int LD = COLS + (ALONG_K ? 4 : 8);
  static constexpr int kFloats = ROWS * LD;
};

// rows x cols of the fp32 slice at g (row stride ld), of which rows <
// nrows and columns < ncols exist: the rest is zero-filled. `vec`: every
// row start 16-byte aligned, so whole 16-byte chunks are copied.
template <class S>
__device__ __forceinline__ void load_slice(float* s, const float* g,
                                           int64_t ld, int64_t nrows,
                                           int64_t ncols, bool vec, int tid) {
  constexpr int kChunks = S::kCols / 4;
  static_assert(S::kRows * kChunks % kThreads == 0, "whole rounds");
#pragma unroll
  for (int n = 0; n < S::kRows * kChunks / kThreads; ++n) {
    const int i = tid + n * kThreads;
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const int valid =
        r < nrows ? (int)imin(4, ncols - c > 0 ? ncols - c : 0) : 0;
    const float* src = valid > 0 ? g + r * ld + c : g;
    float* dst = s + r * S::LD + c;
    if (vec) {
      split_tf32::cp16n(dst, src, 4 * valid);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_tf32::cp4(dst + e, e < valid ? src + e : g, e < valid);
    }
  }
}

template <bool TA, bool TB, int BN>
struct Tiles {
  // A [BM][BK] along k, or [BK][BM] when transposed; B [BK][BN], or
  // [BN][BK] when transposed
  using A = Slice<TA ? kBK : kBM, TA ? kBM : kBK, !TA>;
  using B = Slice<TB ? BN : kBK, TB ? kBK : BN, TB>;
  static constexpr int WARPS_N = BN / 32, WARPS_M = 8 / WARPS_N;
  static constexpr int WM = kBM / WARPS_M;  // a warp: WM x 32 of C
  static constexpr size_t kSmem =
      sizeof(float) * 3 * (A::kFloats + B::kFloats);
};

template <bool TA, bool TB, int BN, int EPI>
__global__ void __launch_bounds__(kThreads, 2) mma_kernel(Params p) {
  using T = Tiles<TA, TB, BN>;
  using SA = typename T::A;
  using SB = typename T::B;
  constexpr int MT = T::WM / 16, NT = 4;  // fragments of a warp's sub-tile
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;  // stage st: A, then B
  // the slices' small halves
  float* alo = ring + 2 * (SA::kFloats + SB::kFloats);
  float* blo = alo + SA::kFloats;

  const int tid = threadIdx.x;
  const int lane = tid % 32, gr = lane / 4, tc = lane % 4, warp = tid / 32;
  const int wm = warp / T::WARPS_N * T::WM, wn = warp % T::WARPS_N * 32;
  const int64_t m0 = (int64_t)blockIdx.y * kBM;
  const int64_t n0 = (int64_t)blockIdx.x * BN;
  int64_t kbeg = 0, kend = p.k;
  const float* a = static_cast<const float*>(p.a);
  const float* b = static_cast<const float*>(p.b);
  float* c = static_cast<float*>(p.c);
  if (p.splits > 1) {
    const int s = blockIdx.z;
    kbeg = s * p.k_chunk;
    kend = imin(p.k, kbeg + p.k_chunk);
    c += (int64_t)s * p.m * p.n;
  } else {
    const int zo = blockIdx.z / p.inner, zi = blockIdx.z % p.inner;
    a += zo * p.a_outer + zi * p.a_inner;
    b += zo * p.b_outer + zi * p.b_inner;
    c += zo * p.c_outer + zi * p.c_inner;
  }

  auto fetch = [&](int64_t k0, int st) {
    float* as = ring + st * (SA::kFloats + SB::kFloats);
    float* bs = as + SA::kFloats;
    if (TA)
      load_slice<SA>(as, a + k0 * p.lda + m0, p.lda, kend - k0, p.m - m0,
                     p.vec_a, tid);
    else
      load_slice<SA>(as, a + m0 * p.lda + k0, p.lda, p.m - m0, kend - k0,
                     p.vec_a, tid);
    if (TB)
      load_slice<SB>(bs, b + n0 * p.ldb + k0, p.ldb, p.n - n0, kend - k0,
                     p.vec_b, tid);
    else
      load_slice<SB>(bs, b + k0 * p.ldb + n0, p.ldb, kend - k0, p.n - n0,
                     p.vec_b, tid);
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int nslices = kbeg < kend ? (int)((kend - kbeg + kBK - 1) / kBK) : 0;
  if (nslices > 0) fetch(kbeg, 0);
  split_tf32::cp_commit();
  for (int it = 0; it < nslices; ++it) {
    const int st = it & 1;
    if (it + 1 < nslices) fetch(kbeg + (int64_t)(it + 1) * kBK, st ^ 1);
    split_tf32::cp_commit();
    split_tf32::cp_wait<1>();  // this slice has landed
    float* as = ring + st * (SA::kFloats + SB::kFloats);
    float* bs = as + SA::kFloats;
    // the fragments' source: each slice split in place (big halves) with
    // its small halves beside it
    split_tf32::split_rows<SA::kCols, SA::kRows, kThreads, SA::LD>(as, alo,
                                                                   tid);
    split_tf32::split_rows<SB::kCols, SB::kRows, kThreads, SB::LD>(bs, blo,
                                                                   tid);
    const float* ahi = as;
    const float* bhi = bs;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      // the warp's B fragments held, its A fragments streamed: 16 + 8
      // registers beside the 4 MT x 4 accumulator
      OpB bf[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = wn + j * 8;
        if (TB) {
          const int at = col * SB::LD + kk;
          bf[j] = split_tf32::load_b_t(bhi + at, blo + at, SB::LD, gr, tc);
        } else {
          const int at = kk * SB::LD + col;
          bf[j] = split_tf32::load_b(bhi + at, blo + at, SB::LD, gr, tc);
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int row = wm + i * 16;
        OpA af;
        if (TA) {
          const int at = kk * SA::LD + row;
          af = split_tf32::load_a_t(ahi + at, alo + at, SA::LD, gr, tc);
        } else {
          const int at = row * SA::LD + kk;
          af = split_tf32::load_a_split(ahi + at, alo + at, SA::LD, gr, tc);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) split_tf32::mma3(acc[i][j], af, bf[j]);
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }
  split_tf32::cp_wait<0>();

  // kMask: the block's tile of the mask, staged whole in the ring (free
  // since the loop's last barrier) before any thread stores to C, which
  // it may be
  using SM = Slice<kBM, BN, false>;
  static_assert(SM::kFloats <= 2 * (SA::kFloats + SB::kFloats), "fits");
  if constexpr (EPI == kMask) {
    load_slice<SM>(ring, p.mask + m0 * p.ldm + n0, p.ldm, p.m - m0,
                   p.n - n0, p.vec_m, tid);
    split_tf32::cp_commit();
    split_tf32::cp_wait<0>();
    __syncthreads();
  }

  const float* bias = static_cast<const float*>(p.bias);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm + i * 16 + gr + h * 8;
      const int64_t row = m0 + r;
      if (row >= p.m) continue;
      // the epilogue's operand of each element of this row
      float e[NT][2] = {};
      if constexpr (EPI != kNone) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int cl = wn + j * 8 + 2 * tc + u;
            e[j][u] = EPI == kMask        ? ring[r * SM::LD + cl]
                      : n0 + cl < p.n ? bias[n0 + cl]
                                      : 0.f;
          }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int64_t col = n0 + wn + j * 8 + 2 * tc;
        if (col < p.n)
          c[row * p.ldc + col] = epilogue<EPI>(acc[i][j][2 * h], e[j][0]);
        if (col + 1 < p.n)
          c[row * p.ldc + col + 1] =
              epilogue<EPI>(acc[i][j][2 * h + 1], e[j][1]);
      }
    }
}

// c[idx] = sum over s of ws[s * mn + idx], in the order of s, rounded
// once to EC
template <typename EC>
__global__ void __launch_bounds__(kThreads)
    sum_slices_kernel(const float* __restrict__ ws, EC* __restrict__ c,
                      int64_t mn, int splits) {
  for (int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x; idx < mn;
       idx += (int64_t)gridDim.x * kThreads) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += ws[sp * mn + idx];
    c[idx] = from_f<EC>(s);
  }
}

using hopper::sm_count;

template <bool TA, bool TB, int BN, int EPI>
cudaError_t launch(const Params& p, int batches, cudaStream_t s) {
  using T = Tiles<TA, TB, BN>;
  const cudaError_t err = cudaFuncSetAttribute(
      mma_kernel<TA, TB, BN, EPI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((p.n + BN - 1) / BN),
                  (unsigned)((p.m + kBM - 1) / kBM),
                  (unsigned)(p.splits > 1 ? p.splits : batches));
  mma_kernel<TA, TB, BN, EPI><<<grid, kThreads, T::kSmem, s>>>(p);
  return cudaGetLastError();
}

template <bool TA, bool TB, int EPI>
cudaError_t by_width(const Params& p, int batches, cudaStream_t s) {
  return p.n <= 64 ? launch<TA, TB, 64, EPI>(p, batches, s)
                   : launch<TA, TB, 128, EPI>(p, batches, s);
}

inline Params params(int64_t m, int64_t n, int64_t k, const void* a,
                     int64_t lda, const void* b, int64_t ldb, void* c,
                     int64_t ldc) {
  Params p = {};
  p.m = m;
  p.n = n;
  p.k = k;
  p.a = a;
  p.lda = lda;
  p.b = b;
  p.ldb = ldb;
  p.c = c;
  p.ldc = ldc;
  p.inner = 1;
  p.splits = 1;
  return p;
}

// whether every row start (and batch offset) of an fp32 operand is
// 16-byte aligned
inline int aligned16(const void* x, int64_t ld, int64_t outer,
                     int64_t inner) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && ld % 4 == 0 &&
         outer % 4 == 0 && inner % 4 == 0;
}

// One product C = op(A) op(B) with epilogue EPI (an epilogue takes an A
// that is not transposed: rows of C are rows of A), `batches` of them
// over the strides in p. An unbatched product with no epilogue and a
// contiguous C whose tile grid fills less than two blocks a
// multiprocessor is split along k when `ws` (ws_floats values) can hold
// the slices: at most 16 slices, none shallower than 512, summed in
// their fixed order.
template <bool TA, bool TB, int EPI>
inline cudaError_t gemm(Params p, int batches, float* ws, int64_t ws_floats,
                        cudaStream_t s) {
  static_assert(EPI == kNone || !TA, "an epilogue takes rows of A");
  if (p.m <= 0 || p.n <= 0 || p.k <= 0 || batches <= 0 ||
      (EPI != kNone && batches != 1) ||
      (EPI == kMask && p.mask == nullptr) ||
      ((EPI == kBiasRelu || EPI == kBias) && p.bias == nullptr))
    return cudaErrorInvalidValue;
  p.vec_a = aligned16(p.a, p.lda, p.a_outer, p.a_inner);
  p.vec_b = aligned16(p.b, p.ldb, p.b_outer, p.b_inner);
  p.vec_m = aligned16(p.mask, p.ldm, 0, 0);
  const int64_t bn = p.n <= 64 ? 64 : 128;
  const int64_t tiles = ((p.m + kBM - 1) / kBM) * ((p.n + bn - 1) / bn);
  int64_t splits = 1;
  if (EPI == kNone && batches == 1 && p.ldc == p.n && ws != nullptr) {
    splits = (2 * sm_count() + tiles - 1) / tiles;
    splits = imin(splits, 16);
    splits = imin(splits, p.k / 512);
    splits = imin(splits, ws_floats / (p.m * p.n));
  }
  if (splits < 2) return by_width<TA, TB, EPI>(p, batches, s);
  p.k_chunk = ((p.k + splits - 1) / splits + kBK - 1) / kBK * kBK;
  p.splits = (int)((p.k + p.k_chunk - 1) / p.k_chunk);
  float* c = static_cast<float*>(p.c);
  p.c = ws;
  cudaError_t err = by_width<TA, TB, EPI>(p, 1, s);
  if (err != cudaSuccess) return err;
  const int64_t mn = p.m * p.n;
  const int64_t blocks = imin((mn + kThreads - 1) / kThreads, 4096);
  sum_slices_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(ws, c, mn,
                                                                 p.splits);
  return cudaGetLastError();
}

// out[j] = sum over rows i of a[i * cols + j], deterministic, in fp32 and
// rounded once to EO. Pass 1: each block sums 32 columns over a chunk of
// rows (8 row lanes of 32 threads, then the 8 lane sums in order) into
// ws[chunk * cols + j]; pass 2 sums the chunks in order.
constexpr int kSumCols = 32;
constexpr int kSumLanes = kThreads / kSumCols;

template <typename EI>
__global__ void __launch_bounds__(kThreads)
    colsum_chunks_kernel(const EI* __restrict__ a, float* __restrict__ ws,
                         int64_t rows, int64_t cols, int64_t chunk) {
  __shared__ float part[kSumLanes][kSumCols + 1];
  const int lane_c = threadIdx.x % kSumCols, lane_r = threadIdx.x / kSumCols;
  const int64_t col = (int64_t)blockIdx.x * kSumCols + lane_c;
  const int64_t r0 = (int64_t)blockIdx.y * chunk;
  const int64_t r1 = imin(rows, r0 + chunk);
  float s = 0.f;
  if (col < cols)
    for (int64_t r = r0 + lane_r; r < r1; r += kSumLanes)
      s += to_f(a[r * cols + col]);
  part[lane_r][lane_c] = s;
  __syncthreads();
  if (lane_r == 0 && col < cols) {
    float t = 0.f;
    for (int l = 0; l < kSumLanes; ++l) t += part[l][lane_c];
    ws[blockIdx.y * cols + col] = t;
  }
}

template <typename EO>
__global__ void __launch_bounds__(kThreads)
    colsum_total_kernel(const float* __restrict__ ws, EO* __restrict__ out,
                        int64_t cols, int64_t chunks) {
  const int64_t col = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (col >= cols) return;
  float t = 0.f;
  for (int64_t ch = 0; ch < chunks; ++ch) t += ws[ch * cols + col];
  out[col] = from_f<EO>(t);
}

// The column sums of a [rows, cols] a into out [cols], through ws
// (ws_floats values, at least cols): chunks of 128 rows or, where ws
// cannot hold a row of sums for each, of a power of two more.
template <typename EI, typename EO>
inline cudaError_t colsum(const EI* a, EO* out, int64_t rows, int64_t cols,
                          float* ws, int64_t ws_floats, cudaStream_t s) {
  if (rows <= 0 || cols <= 0 || ws == nullptr || ws_floats < cols)
    return cudaErrorInvalidValue;
  int64_t chunk = 128;
  while (chunk < rows && (rows + chunk - 1) / chunk * cols > ws_floats)
    chunk *= 2;
  const int64_t chunks = (rows + chunk - 1) / chunk;
  if (chunks > 65535) return cudaErrorInvalidValue;
  colsum_chunks_kernel<EI>
      <<<dim3((unsigned)((cols + kSumCols - 1) / kSumCols), (unsigned)chunks),
         kThreads, 0, s>>>(a, ws, rows, cols, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  colsum_total_kernel<EO>
      <<<(unsigned)((cols + kThreads - 1) / kThreads), kThreads, 0, s>>>(
          ws, out, cols, chunks);
  return cudaGetLastError();
}

}  // namespace tile_mma
