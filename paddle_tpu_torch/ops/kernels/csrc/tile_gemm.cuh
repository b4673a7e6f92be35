// A tiled fp32 SIMT matrix product for Hopper (sm_90a), shared by the
// fused-block kernels (attention_block.cu, ffn_block.cu), with the
// deterministic column sum those kernels' bias grads need.
//
//   C = alpha * op(A) op(B)  [+ bias] [relu] [* (mask > 0)]
//
// op(A) is [m, k]: A(i, kk) = a[i * lda + kk], or a[kk * lda + i] when A
// is transposed; op(B) is [k, n]: B(kk, j) = b[kk * ldb + j], or
// b[j * ldb + kk] when B is transposed. Leading dimensions let a product
// read a column slice of a wider row (one head's q, k or v inside a
// [rows, 3D] qkv buffer). A batch of products runs over blockIdx.z: batch
// z takes the offsets (z / inner) * outer_stride + (z % inner) *
// inner_stride of each operand, so a [B, H] grid of per-head products can
// address heads inside token rows.
//
// What bounds it on an H100: operations. Each block computes a 128 x 128
// tile of C from 8-deep slices of A and B staged in shared memory (two
// buffers, the next slice loaded into registers while the current one is
// multiplied), and each of its 256 threads keeps an 8 x 8 sub-tile of C in
// registers: 64 fused multiply-adds for every 16 values it reads from
// shared memory. It runs on the fp32 units (67 TFLOP/s), not the tensor
// cores; TF32 or bf16 wgmma is the later step for speed.
//
// A product whose tile grid is too small to fill the card and whose depth
// is large (a weight gradient: [512, 1536] over 16384 rows) is split along
// k into slices that write their partial products to a workspace; a second
// pass sums the slices in their fixed order. The result is deterministic:
// no atomics, the same order on every run.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tile_gemm {

__host__ __device__ inline int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

constexpr int kBM = 128;  // rows of C a block computes
constexpr int kBN = 128;  // columns of C a block computes
constexpr int kBK = 8;    // depth of one shared-memory slice
constexpr int kPad = 4;   // keeps the transposing stores conflict-free
constexpr int kThreads = 256;

enum Epilogue {
  kNone = 0,
  kBias = 1,      // + bias[j]
  kBiasRelu = 2,  // max(. + bias[j], 0)
  kMask = 3,      // kept where mask(i, j) > 0, else 0
};

struct Params {
  int64_t m, n, k;
  const float* a;
  int64_t lda;
  const float* b;
  int64_t ldb;
  float* c;
  int64_t ldc;
  float alpha;
  const float* bias;  // [n]
  const float* mask;  // mask(i, j) = mask[i * ldm + j]
  int64_t ldm;
  int inner;  // batch z -> (z / inner, z % inner)
  int64_t a_outer, a_inner, b_outer, b_inner, c_outer, c_inner;
  int splits;       // > 1: slice s of k writes c + s * m * n (ldc == n)
  int64_t k_chunk;  // depth of one slice
};

template <bool TA, bool TB, int EPI>
__global__ void __launch_bounds__(kThreads) gemm_kernel(Params p) {
  __shared__ __align__(16) float as[2][kBK][kBM + kPad];
  __shared__ __align__(16) float bs[2][kBK][kBN + kPad];

  const int tid = threadIdx.x;
  const int64_t m0 = (int64_t)blockIdx.y * kBM;
  const int64_t n0 = (int64_t)blockIdx.x * kBN;
  int64_t kbeg = 0, kend = p.k;
  const float* a = p.a;
  const float* b = p.b;
  float* c = p.c;
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

  // each thread stages 4 values of each slice; the index order follows
  // the operand's contiguous dimension, so a warp reads neighbours
  float ra[4], rb[4];
  auto a_at = [&](int j, int& kk, int& mm) {
    const int i = tid + j * kThreads;
    if (TA) {
      mm = i % kBM;
      kk = i / kBM;
    } else {
      kk = i % kBK;
      mm = i / kBK;
    }
  };
  auto b_at = [&](int j, int& kk, int& nn) {
    const int i = tid + j * kThreads;
    if (TB) {
      kk = i % kBK;
      nn = i / kBK;
    } else {
      nn = i % kBN;
      kk = i / kBN;
    }
  };
  auto load = [&](int64_t k0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int kk, mm, nn;
      a_at(j, kk, mm);
      const int64_t gk = k0 + kk, gm = m0 + mm;
      ra[j] = (gk < kend && gm < p.m)
                  ? (TA ? a[gk * p.lda + gm] : a[gm * p.lda + gk])
                  : 0.f;
      b_at(j, kk, nn);
      const int64_t hk = k0 + kk, gn = n0 + nn;
      rb[j] = (hk < kend && gn < p.n)
                  ? (TB ? b[gn * p.ldb + hk] : b[hk * p.ldb + gn])
                  : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int kk, mm, nn;
      a_at(j, kk, mm);
      as[buf][kk][mm] = ra[j];
      b_at(j, kk, nn);
      bs[buf][kk][nn] = rb[j];
    }
  };

  // thread (ty, tx) owns rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, and
  // the columns likewise with tx: each reads four float4s a step
  const int tx = tid % 16, ty = tid / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (kbeg < kend) {
    load(kbeg);
    store(0);
  }
  __syncthreads();
  int buf = 0;
  for (int64_t k0 = kbeg; k0 < kend; k0 += kBK) {
    const bool more = k0 + kBK < kend;
    if (more) load(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[buf][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&as[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&bs[buf][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // the other buffer's readers finished before the last barrier
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= p.m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col >= p.n) continue;
      float v = p.alpha * acc[i][j];
      if (EPI == kBias || EPI == kBiasRelu) v += p.bias[col];
      if (EPI == kBiasRelu) v = fmaxf(v, 0.f);
      if (EPI == kMask && !(p.mask[row * p.ldm + col] > 0.f)) v = 0.f;
      c[row * p.ldc + col] = v;
    }
  }
}

// c[idx] = sum over s of ws[s * mn + idx], in the order of s
__global__ void __launch_bounds__(kThreads)
    sum_slices_kernel(const float* __restrict__ ws, float* __restrict__ c,
                      int64_t mn, int splits) {
  for (int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x; idx < mn;
       idx += (int64_t)gridDim.x * kThreads) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += ws[sp * mn + idx];
    c[idx] = s;
  }
}

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

template <bool TA, bool TB, int EPI>
cudaError_t launch(Params p, int batches, cudaStream_t s) {
  const dim3 grid((unsigned)((p.n + kBN - 1) / kBN),
                  (unsigned)((p.m + kBM - 1) / kBM),
                  (unsigned)(p.splits > 1 ? p.splits : batches));
  gemm_kernel<TA, TB, EPI><<<grid, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

// The products the fused blocks take; another combination is refused.
inline cudaError_t dispatch(bool ta, bool tb, int epi, const Params& p,
                            int batches, cudaStream_t s) {
  if (!ta && !tb && epi == kNone) return launch<false, false, kNone>(p, batches, s);
  if (!ta && !tb && epi == kBias) return launch<false, false, kBias>(p, batches, s);
  if (!ta && !tb && epi == kBiasRelu)
    return launch<false, false, kBiasRelu>(p, batches, s);
  if (ta && !tb && epi == kNone) return launch<true, false, kNone>(p, batches, s);
  if (!ta && tb && epi == kNone) return launch<false, true, kNone>(p, batches, s);
  if (!ta && tb && epi == kMask) return launch<false, true, kMask>(p, batches, s);
  return cudaErrorInvalidValue;
}

inline Params params(int64_t m, int64_t n, int64_t k, const float* a,
                     int64_t lda, const float* b, int64_t ldb, float* c,
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
  p.alpha = 1.f;
  p.inner = 1;
  p.splits = 1;
  return p;
}

// One product C = op(A) op(B) with epilogue `epi`, `batches` of them over
// the strides in p. An unbatched product with no epilogue and a contiguous
// C whose tile grid fills less than two blocks a multiprocessor is split
// along k when `ws` (ws_floats values) can hold the slices: at most 16
// slices, none shallower than 512.
inline cudaError_t gemm(bool ta, bool tb, int epi, Params p, int batches,
                        float* ws, int64_t ws_floats, cudaStream_t s) {
  if (p.m <= 0 || p.n <= 0 || p.k <= 0 || batches <= 0 ||
      (epi == kMask && p.mask == nullptr) ||
      ((epi == kBias || epi == kBiasRelu) && p.bias == nullptr))
    return cudaErrorInvalidValue;
  const int64_t tiles = ((p.m + kBM - 1) / kBM) * ((p.n + kBN - 1) / kBN);
  int64_t splits = 1;
  if (batches == 1 && epi == kNone && p.ldc == p.n && ws != nullptr) {
    splits = (2 * sm_count() + tiles - 1) / tiles;
    splits = imin(splits, 16);
    splits = imin(splits, p.k / 512);
    splits = imin(splits, ws_floats / (p.m * p.n));
  }
  if (splits < 2) return dispatch(ta, tb, epi, p, batches, s);
  p.k_chunk = ((p.k + splits - 1) / splits + kBK - 1) / kBK * kBK;
  p.splits = (int)((p.k + p.k_chunk - 1) / p.k_chunk);
  float* c = p.c;
  p.c = ws;
  cudaError_t err = dispatch(ta, tb, epi, p, 1, s);
  if (err != cudaSuccess) return err;
  const int64_t mn = p.m * p.n;
  const int64_t blocks = imin((mn + kThreads - 1) / kThreads, 4096);
  sum_slices_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(ws, c, mn,
                                                          p.splits);
  return cudaGetLastError();
}

// out[j] = sum over rows i of a[i * cols + j], deterministic. Pass 1: each
// block sums 32 columns over a chunk of rows (8 row lanes of 32 threads,
// then the 8 lane sums in order) into ws[chunk * cols + j]; pass 2 sums
// the chunks in order.
constexpr int kSumCols = 32;
constexpr int kSumLanes = kThreads / kSumCols;

__global__ void __launch_bounds__(kThreads)
    colsum_chunks_kernel(const float* __restrict__ a, float* __restrict__ ws,
                         int64_t rows, int64_t cols, int64_t chunk) {
  __shared__ float part[kSumLanes][kSumCols + 1];
  const int lane_c = threadIdx.x % kSumCols, lane_r = threadIdx.x / kSumCols;
  const int64_t col = (int64_t)blockIdx.x * kSumCols + lane_c;
  const int64_t r0 = (int64_t)blockIdx.y * chunk;
  const int64_t r1 = imin(rows, r0 + chunk);
  float s = 0.f;
  if (col < cols)
    for (int64_t r = r0 + lane_r; r < r1; r += kSumLanes) s += a[r * cols + col];
  part[lane_r][lane_c] = s;
  __syncthreads();
  if (lane_r == 0 && col < cols) {
    float t = 0.f;
    for (int l = 0; l < kSumLanes; ++l) t += part[l][lane_c];
    ws[blockIdx.y * cols + col] = t;
  }
}

__global__ void __launch_bounds__(kThreads)
    colsum_total_kernel(const float* __restrict__ ws, float* __restrict__ out,
                        int64_t cols, int64_t chunks) {
  const int64_t col = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (col >= cols) return;
  float t = 0.f;
  for (int64_t ch = 0; ch < chunks; ++ch) t += ws[ch * cols + col];
  out[col] = t;
}

inline cudaError_t colsum(const float* a, float* out, int64_t rows,
                          int64_t cols, float* ws, int64_t ws_floats,
                          cudaStream_t s) {
  if (rows <= 0 || cols <= 0 || ws == nullptr || ws_floats < cols)
    return cudaErrorInvalidValue;
  int64_t chunk = 128;
  while (chunk < rows && (rows + chunk - 1) / chunk * cols > ws_floats)
    chunk *= 2;
  const int64_t chunks = (rows + chunk - 1) / chunk;
  if (chunks > 65535) return cudaErrorInvalidValue;
  colsum_chunks_kernel<<<dim3((unsigned)((cols + kSumCols - 1) / kSumCols),
                              (unsigned)chunks),
                         kThreads, 0, s>>>(a, ws, rows, cols, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  colsum_total_kernel<<<(unsigned)((cols + kThreads - 1) / kThreads), kThreads,
                        0, s>>>(ws, out, cols, chunks);
  return cudaGetLastError();
}

}  // namespace tile_gemm
