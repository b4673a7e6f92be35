// Flash-attention backward for Hopper (sm_90a), fp32: two kernels, the
// FlashAttention-2 recipe.
//
// Replaces: paddle_tpu/ops/pallas/attention.py `_flash_bwd_impl`, its
// `_bwd_dq_kernel` (dq, a grid over query tiles) and `_bwd_dkv_kernel`
// (dk and dv, a grid over key tiles), the backward of `flash_attention`
// (routed from ops/nn_ops.py `attention` for T > 512, d in {64, 128, 256}).
//
// Inputs: q, dO [BH, tq, D]; k, v [BH, tk, D]; the forward's per-row
// logsumexp lse [BH, tq] (flash_attention.cu); delta = rowsum(dO * O)
// [BH, tq], which the caller computes, as the JAX package does outside its
// kernels. Both kernels recompute P = exp(scale q k^T - lse) tile by tile
// and take ds = P * (dO v^T - delta); then dq = scale ds k,
// dk = scale ds^T q, dv = P^T dO.
//
// The gradient is that of the port's forward (`reference_attention`), in
// which a masked score is filled with -FLT_MAX:
// - a masked entry passes no gradient to its score: ds = 0;
// - under causal masking with tq > tk, query rows i < tq - tk see no key.
//   The forward gives them the uniform average of v, so their P is 1/tk
//   on every key (dv gets dO / tk), and their dq and their share of dk
//   are 0. Their lse (-FLT_MAX) cannot give that: exp(s - lse) would read
//   1, not 1/tk, so such rows are found by index, not through lse.
//
// What bounds them on an H100: operations. At the training shape
// [16, 8, 1024, 64] the dq kernel does three products (S, dP, ds k) and the
// dk/dv kernel four (S, dP, P^T dO, ds^T q), 2*BH*tq*tk*D flops each:
// 52 and 69 GFLOP on 168 and 201 MB, some 300 flops a byte, far above the
// 20 at which fp32 outside the tensor cores (67 TFLOP/s) meets the memory
// (3.35 TB/s).
//
// What the design does about it: no [tq, tk] matrix exists; each block
// keeps its own tiles in shared memory and accumulates its output tile in
// registers in fp32 (no TF32: the port's gradient parity is fp32).
// - dq: one block per (bh, R-row query tile) holds Q, dO, lse and delta,
//   streams 32-key tiles of K and V, and accumulates dq.
// - dk/dv: one block per (bh, R-row key tile) holds K and V, streams
//   32-row query tiles of Q, dO, lse and delta, and accumulates dk and dv.
//   Every block writes only its own tile, so no atomics are needed and the
//   result does not depend on the order blocks run in.
// A warp computes the scores of one row against 32 keys (one per lane,
// the key rows padded to D + 1 floats so the lanes hit distinct banks);
// for the products each thread owns one output column of R / (256 / D)
// rows. Causal tiles that no row of the block can see are skipped
// (R = 64, or 32 at D = 256 to stay within registers and shared memory:
// 2048 blocks at the training shape). This is the simple SIMT form;
// wgmma on bf16 tiles is the next step for speed.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBS = 32;  // streamed rows per tile

// resident rows per block: 32 at D = 256 to stay within registers and
// shared memory
template <int D>
struct Tile {
  static constexpr int R = D == 256 ? 32 : 64;
};

// P and ds of one (query qi, key kj) entry, from its score s (scaled),
// dp = dO_qi . v_kj and the query row's lse and delta.
__device__ __forceinline__ void p_and_ds(float s, float dp, float lse,
                                         float delta, int qi, int kj, int tq,
                                         int tk, int causal, float& p,
                                         float& ds) {
  const int offset = tk - tq;
  if (qi >= tq || kj >= tk) {  // tile padding
    p = 0.f;
    ds = 0.f;
  } else if (causal && kj > qi + offset) {
    p = qi + offset < 0 ? 1.f / tk : 0.f;  // a row that sees no key
    ds = 0.f;
  } else {
    p = expf(s - lse);
    ds = p * (dp - delta);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int tq, int tk, float scale,
                        int causal) {
  constexpr int R = Tile<D>::R;
  extern __shared__ float smem[];
  float* qs = smem;                    // [R][D]
  float* gs = qs + R * D;              // [R][D]
  float* ks = gs + R * D;              // [kBS][D + 1]
  float* vs = ks + kBS * (D + 1);      // [kBS][D + 1]
  float* dss = vs + kBS * (D + 1);     // [R][kBS + 1]
  float* lse_s = dss + R * (kBS + 1);  // [R]
  float* dl_s = lse_s + R;             // [R]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * R;
  const int tid = threadIdx.x;
  const float* qb = q + (int64_t)bh * tq * D;
  const float* gb = g + (int64_t)bh * tq * D;
  const float* kb = k + (int64_t)bh * tk * D;
  const float* vb = v + (int64_t)bh * tk * D;

  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D;
    const bool in = q0 + r < tq;
    const int64_t at = (int64_t)(q0 + r) * D + i % D;
    qs[i] = in ? qb[at] : 0.f;
    gs[i] = in ? gb[at] : 0.f;
  }
  if (tid < R) {
    const bool in = q0 + tid < tq;
    lse_s[tid] = in ? lse[(int64_t)bh * tq + q0 + tid] : 0.f;
    dl_s[tid] = in ? delta[(int64_t)bh * tq + q0 + tid] : 0.f;
  }

  // keys past the last row's horizon are masked for every row: ds = 0
  int kend = tk;
  if (causal) kend = max(0, min(tk, q0 + R + tk - tq));
  const int ntiles = (kend + kBS - 1) / kBS;

  constexpr int kRowStride = kThreads / D;
  constexpr int kRows = R / kRowStride;
  const int col = tid % D, r0 = tid / D;
  float acc[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) acc[j] = 0.f;

  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();  // previous tile's readers are done
    for (int i = tid; i < kBS * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int key = kt * kBS + r;
      const bool in = key < tk;
      ks[r * (D + 1) + c] = in ? kb[(int64_t)key * D + c] : 0.f;
      vs[r * (D + 1) + c] = in ? vb[(int64_t)key * D + c] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < R * kBS; i += kThreads) {
      const int r = i / kBS, c = i % kBS;
      const float* qr = qs + r * D;
      const float* gr = gs + r * D;
      const float* kr = ks + c * (D + 1);
      const float* vr = vs + c * (D + 1);
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int e = 0; e < D; ++e) {
        s += qr[e] * kr[e];
        dp += gr[e] * vr[e];
      }
      float p, ds;
      p_and_ds(s * scale, dp, lse_s[r], dl_s[r], q0 + r, kt * kBS + c, tq,
               tk, causal, p, ds);
      dss[r * (kBS + 1) + c] = ds;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const float* dr = dss + (r0 + j * kRowStride) * (kBS + 1);
      float a = acc[j];
#pragma unroll 8
      for (int c = 0; c < kBS; ++c) a += dr[c] * ks[c * (D + 1) + col];
      acc[j] = a;
    }
  }
  float* dqb = dq + (int64_t)bh * tq * D;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int r = r0 + j * kRowStride;
    if (q0 + r < tq) dqb[(int64_t)(q0 + r) * D + col] = acc[j] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ g,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int tq, int tk, float scale, int causal) {
  constexpr int R = Tile<D>::R;
  extern __shared__ float smem[];
  float* ks = smem;                    // [R][D + 1]
  float* vs = ks + R * (D + 1);        // [R][D + 1]
  float* qs = vs + R * (D + 1);        // [kBS][D]
  float* gs = qs + kBS * D;            // [kBS][D]
  float* ps = gs + kBS * D;            // [kBS][R + 1]
  float* dss = ps + kBS * (R + 1);     // [kBS][R + 1]
  float* lse_s = dss + kBS * (R + 1);  // [kBS]
  float* dl_s = lse_s + kBS;           // [kBS]

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * R;
  const int tid = threadIdx.x;
  const int offset = tk - tq;
  const float* qb = q + (int64_t)bh * tq * D;
  const float* gb = g + (int64_t)bh * tq * D;
  const float* kb = k + (int64_t)bh * tk * D;
  const float* vb = v + (int64_t)bh * tk * D;

  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const bool in = k0 + r < tk;
    const int64_t at = (int64_t)(k0 + r) * D + c;
    ks[r * (D + 1) + c] = in ? kb[at] : 0.f;
    vs[r * (D + 1) + c] = in ? vb[at] : 0.f;
  }

  constexpr int kRowStride = kThreads / D;
  constexpr int kRows = R / kRowStride;
  const int col = tid % D, r0 = tid / D;
  float dk_acc[kRows], dv_acc[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  for (int qt = 0; qt < tq; qt += kBS) {
    // under causal masking a query tile adds nothing here when its last
    // row cannot reach key k0 and none of its rows is fully masked
    if (causal && qt + kBS - 1 + offset < k0 && qt + offset >= 0) continue;
    __syncthreads();  // previous tile's readers are done
    for (int i = tid; i < kBS * D; i += kThreads) {
      const int r = i / D;
      const bool in = qt + r < tq;
      const int64_t at = (int64_t)(qt + r) * D + i % D;
      qs[i] = in ? qb[at] : 0.f;
      gs[i] = in ? gb[at] : 0.f;
    }
    if (tid < kBS) {
      const bool in = qt + tid < tq;
      lse_s[tid] = in ? lse[(int64_t)bh * tq + qt + tid] : 0.f;
      dl_s[tid] = in ? delta[(int64_t)bh * tq + qt + tid] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < kBS * R; i += kThreads) {
      const int r = i / R, c = i % R;
      const float* qr = qs + r * D;
      const float* gr = gs + r * D;
      const float* kr = ks + c * (D + 1);
      const float* vr = vs + c * (D + 1);
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int e = 0; e < D; ++e) {
        s += qr[e] * kr[e];
        dp += gr[e] * vr[e];
      }
      float p, ds;
      p_and_ds(s * scale, dp, lse_s[r], dl_s[r], qt + r, k0 + c, tq, tk,
               causal, p, ds);
      ps[r * (R + 1) + c] = p;
      dss[r * (R + 1) + c] = ds;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int key = r0 + j * kRowStride;
      float a = dk_acc[j], b = dv_acc[j];
#pragma unroll 8
      for (int r = 0; r < kBS; ++r) {
        a += dss[r * (R + 1) + key] * qs[r * D + col];
        b += ps[r * (R + 1) + key] * gs[r * D + col];
      }
      dk_acc[j] = a;
      dv_acc[j] = b;
    }
  }
  float* dkb = dk + (int64_t)bh * tk * D;
  float* dvb = dv + (int64_t)bh * tk * D;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int key = r0 + j * kRowStride;
    if (k0 + key < tk) {
      dkb[(int64_t)(k0 + key) * D + col] = dk_acc[j] * scale;
      dvb[(int64_t)(k0 + key) * D + col] = dv_acc[j];
    }
  }
}

struct Args {
  const float *q, *k, *v, *g, *lse, *delta;
  float *dq, *dk, *dv;
  int64_t bh;
  int tq, tk;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int D>
int launch_dq(const Args& a) {
  constexpr int R = Tile<D>::R;
  const size_t bytes = sizeof(float) * (2 * R * D + 2 * kBS * (D + 1) +
                                        R * (kBS + 1) + 2 * R);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.tq + R - 1) / R, (unsigned)a.bh);
  flash_bwd_dq_kernel<D><<<grid, kThreads, bytes, a.stream>>>(
      a.q, a.k, a.v, a.g, a.lse, a.delta, a.dq, a.tq, a.tk, a.scale,
      a.causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const Args& a) {
  constexpr int R = Tile<D>::R;
  const size_t bytes = sizeof(float) * (2 * R * (D + 1) + 2 * kBS * D +
                                        2 * kBS * (R + 1) + 2 * kBS);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.tk + R - 1) / R, (unsigned)a.bh);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, bytes, a.stream>>>(
      a.q, a.k, a.v, a.g, a.lse, a.delta, a.dk, a.dv, a.tq, a.tk, a.scale,
      a.causal);
  return (int)cudaGetLastError();
}

template <int (*F64)(const Args&), int (*F128)(const Args&),
          int (*F256)(const Args&)>
int by_head_dim(const Args& a, int d) {
  if (a.tq < 1 || a.tk < 1) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 64:
      return F64(a);
    case 128:
      return F128(a);
    case 256:
      return F256(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* g,
               const void* lse, const void* delta, int64_t bh, int tq, int tk,
               float scale, int causal, void* stream) {
  Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.g = static_cast<const float*>(g);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.bh = bh;
  a.tq = tq;
  a.tk = tk;
  a.scale = scale;
  a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// All pointers fp32 device pointers, contiguous: q, g (dO), dq [bh, tq, d];
// k, v, dk, dv [bh, tk, d]; lse, delta [bh, tq]. d in {64, 128, 256}.
// Each returns cudaGetLastError() of its launch (or of the shared-memory
// attribute call); 1 (cudaErrorInvalidValue) for a shape the kernels do not
// take.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* g,
                                      const void* lse, const void* delta,
                                      void* dq, int64_t bh, int tq, int tk,
                                      int d, float scale, int causal,
                                      void* stream) {
  Args a = make_args(q, k, v, g, lse, delta, bh, tq, tk, scale, causal,
                     stream);
  a.dq = static_cast<float*>(dq);
  return by_head_dim<launch_dq<64>, launch_dq<128>, launch_dq<256>>(a, d);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* g,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int64_t bh, int tq,
                                       int tk, int d, float scale, int causal,
                                       void* stream) {
  Args a = make_args(q, k, v, g, lse, delta, bh, tq, tk, scale, causal,
                     stream);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  return by_head_dim<launch_dkv<64>, launch_dkv<128>, launch_dkv<256>>(a, d);
}
