// Fused softmax cross-entropy, forward and backward, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/xent.py `xent_forward` (`_fwd_kernel`)
// and `xent_backward` (`_bwd_kernel`), the Pallas TPU kernels behind
// `softmax_with_cross_entropy` and its grad with hard labels (routed
// from ops/nn_ops.py).
//
// Computes, per row of logits x [N, V] (fp32 or bf16, fp32 arithmetic)
// with an int64 label:
//   forward:  lse = log sum_j exp(x_j)
//             loss = (1-eps)(lse - x[lab]) + eps(lse - mean_j x_j)
//             (eps == 0: lse - x[lab]); loss = 0 where lab == ignore.
//   backward: dx_j = (exp(x_j - lse) - (1-eps)[j == lab] - eps/V) * g,
//             lse recomputed; a zero row where lab == ignore; dx in the
//             logits' type, g fp32.
// A label outside [0, V) picks 0 and matches no column, as the TPU
// kernel's `cols == lab` compare does; it is not read.
//
// What bounds it on an H100: bytes. At the training slice's shape
// [16384, 32000] fp32 the forward reads 2.1 GB and writes 131 KB (0.63 ms
// at 3.35 TB/s); the backward reads and writes 2.1 GB each (1.25 ms).
// One exp and a few adds per element is about 0.5 operations a byte,
// far below the ~20 a byte at which fp32 arithmetic would take over.
//
// What the design does about it: one block per row. Each thread keeps a
// running (max, sum of exp) pair and the running row sum over a strided
// slice of the row, so the forward reads the row from device memory once
// and keeps no [N, V] intermediate; the pairs merge with warp shuffles,
// then through shared memory. The backward makes the same first pass for
// lse and a second pass that writes dx; the second pass re-reads the row,
// which the L2 cache (50 MB) mostly serves. An ignored row of the
// backward is written as zeros without reading x. Any N and V are taken
// (no N % 32 or V % 128 tiling condition as on the TPU).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Folds one element into the running (max m, sum of exp(x - m)) pair
// with one exp. A -inf element adds nothing.
__device__ __forceinline__ void push(float& m, float& s, float xi) {
  if (xi > m) {
    s = s * expf(m - xi) + 1.f;
    m = xi;
  } else if (xi != -INFINITY) {
    s += expf(xi - m);
  }
}

// Folds another thread's pair into (m, s). A pair whose max is -inf
// holds nothing and leaves the other as it is.
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  if (m2 == -INFINITY) return;
  if (m == -INFINITY) {
    m = m2;
    s = s2;
    return;
  }
  const float mx = fmaxf(m, m2);
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

// The (max, sum of exp) pair and the plain sum of one row, over the
// whole block; every thread gets the results. `red` holds 3 * 33 floats.
template <typename T>
__device__ void row_stats(const T* __restrict__ xr, int v, float* red,
                          float& m_out, float& s_out, float& sum_out) {
  float m = -INFINITY, s = 0.f, tot = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < v; i += blockDim.x) {
    const float xi = to_f(xr[i]);
    push(m, s, xi);
    tot += xi;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    merge(m, s, m2, s2);
    tot += __shfl_xor_sync(0xffffffffu, tot, o);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (lane == 0) {
    red[warp] = m;
    red[33 + warp] = s;
    red[66 + warp] = tot;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < nwarps ? red[lane] : -INFINITY;
    s = lane < nwarps ? red[33 + lane] : 0.f;
    tot = lane < nwarps ? red[66 + lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
      const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
      merge(m, s, m2, s2);
      tot += __shfl_xor_sync(0xffffffffu, tot, o);
    }
    if (lane == 0) {
      red[32] = m;
      red[65] = s;
      red[98] = tot;
    }
  }
  __syncthreads();
  m_out = red[32];
  s_out = red[65];
  sum_out = red[98];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    xent_fwd_kernel(const T* __restrict__ x, const int64_t* __restrict__ lab,
                    float* __restrict__ loss, float* __restrict__ lse_out,
                    int v, float eps, int64_t ignore) {
  __shared__ float red[99];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * v;
  float m, s, tot;
  row_stats(xr, v, red, m, s, tot);
  if (threadIdx.x == 0) {
    const float lse = m + logf(s);
    const int64_t l = lab[row];
    const float picked = (l >= 0 && l < v) ? to_f(xr[l]) : 0.f;
    float out = lse - picked;
    if (eps != 0.f) out = (1.f - eps) * out + eps * (lse - tot / v);
    loss[row] = l == ignore ? 0.f : out;
    lse_out[row] = lse;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    xent_bwd_kernel(const T* __restrict__ x, const int64_t* __restrict__ lab,
                    const float* __restrict__ g, T* __restrict__ dx, int v,
                    float eps, int64_t ignore) {
  __shared__ float red[99];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * v;
  T* dxr = dx + row * v;
  const int64_t l = lab[row];
  if (l == ignore) {
    for (int i = threadIdx.x; i < v; i += blockDim.x) dxr[i] = from_f<T>(0.f);
    return;
  }
  float m, s, tot;
  row_stats(xr, v, red, m, s, tot);
  const float lse = m + logf(s);
  const float gr = g[row];
  const float hit = 1.f - eps;
  const float uniform = eps != 0.f ? eps / v : 0.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < v; i += blockDim.x) {
    const float p = expf(to_f(xr[i]) - lse);
    const float t = (i == l ? hit : 0.f) + uniform;
    dxr[i] = from_f<T>((p - t) * gr);
  }
}

}  // namespace

// x: [n, v] device pointer, fp32 (bf16 when `bf16` is nonzero); lab:
// int64 [n]; loss, lse: fp32 [n]. Launches on `stream` and returns
// cudaGetLastError() of the launch.
extern "C" int xent_fwd(const void* x, const void* lab, void* loss, void* lse,
                        int64_t n, int v, float eps, int64_t ignore, int bf16,
                        void* stream) {
  const dim3 grid((unsigned)n);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* lb = static_cast<const int64_t*>(lab);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  if (bf16) {
    xent_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), lb, lo, ls, v, eps, ignore);
  } else {
    xent_fwd_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), lb, lo, ls, v, eps, ignore);
  }
  return (int)cudaGetLastError();
}

// x, dx: [n, v] of the same type (fp32, or bf16 when `bf16` is nonzero);
// lab: int64 [n]; g: fp32 [n].
extern "C" int xent_bwd(const void* x, const void* lab, const void* g,
                        void* dx, int64_t n, int v, float eps, int64_t ignore,
                        int bf16, void* stream) {
  const dim3 grid((unsigned)n);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* lb = static_cast<const int64_t*>(lab);
  const float* gr = static_cast<const float*>(g);
  if (bf16) {
    xent_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), lb, gr,
        static_cast<__nv_bfloat16*>(dx), v, eps, ignore);
  } else {
    xent_bwd_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), lb, gr, static_cast<float*>(dx), v,
        eps, ignore);
  }
  return (int)cudaGetLastError();
}
