// A tiled fp32 SIMT matrix product for Hopper (sm_90a): the FFN block's
// forward (ffn_block.cu), the last of the port's kernels whose products
// run outside the tensor cores (the others take tile_mma.cuh's split-TF32
// product).
//
//   C = alpha * op(A) op(B)  [+ bias] [relu]
//
// op(A) is [m, k]: A(i, kk) = a[i * lda + kk], or a[kk * lda + i] when A
// is transposed; op(B) is [k, n]: B(kk, j) = b[kk * ldb + j], or
// b[j * ldb + kk] when B is transposed. The FFN forward takes the two
// products without transposes, one with the bias, one with the bias and
// the ReLU; the kernel's other forms (transposes, batches over blockIdx.z,
// slices along k) are not instantiated.
//
// What bounds it on an H100: operations. Each block computes a 128 x 128
// tile of C from 8-deep slices of A and B staged in shared memory (two
// buffers, the next slice loaded into registers while the current one is
// multiplied), and each of its 256 threads keeps an 8 x 8 sub-tile of C in
// registers: 64 fused multiply-adds for every 16 values it reads from
// shared memory. It runs on the fp32 units (67 TFLOP/s), not the tensor
// cores; moving the FFN forward onto tile_mma.cuh is the next step, and
// then this file goes.
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
  kBias = 1,      // + bias[j]
  kBiasRelu = 2,  // max(. + bias[j], 0)
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
      c[row * p.ldc + col] = v;
    }
  }
}

template <bool TA, bool TB, int EPI>
cudaError_t launch(Params p, int batches, cudaStream_t s) {
  const dim3 grid((unsigned)((p.n + kBN - 1) / kBN),
                  (unsigned)((p.m + kBM - 1) / kBM),
                  (unsigned)(p.splits > 1 ? p.splits : batches));
  gemm_kernel<TA, TB, EPI><<<grid, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

// The products the FFN forward takes; another combination is refused.
inline cudaError_t dispatch(int epi, const Params& p, cudaStream_t s) {
  if (epi == kBias) return launch<false, false, kBias>(p, 1, s);
  if (epi == kBiasRelu) return launch<false, false, kBiasRelu>(p, 1, s);
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

// One product C = A B + bias [relu] (epilogue `epi`) on stream s.
inline cudaError_t gemm(int epi, const Params& p, cudaStream_t s) {
  if (p.m <= 0 || p.n <= 0 || p.k <= 0 || p.bias == nullptr)
    return cudaErrorInvalidValue;
  return dispatch(epi, p, s);
}

}  // namespace tile_gemm
