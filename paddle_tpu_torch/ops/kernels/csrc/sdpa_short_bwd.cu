// Short-sequence attention backward for Hopper (sm_90a), fp32.
//
// Replaces: paddle_tpu/ops/pallas/attention.py `_sdpa_short_bwd_impl`
// (the backward of `sdpa_short`, routed from ops/nn_ops.py `attention` for
// tq == tk, 256 < T <= 512, d in {64, 128}).
//
// Computes, from q, k, v, dO [BH, T, D] and the probabilities P [BH, T, T]
// that the forward saved (sdpa_short.cu), with no exp:
//   dv = P^T dO;  dP = dO v^T;  ds = P * (dP - rowsum(dP * P));
//   dq = scale ds k;  dk = scale ds^T q.
// P is fp32 here (the TPU kernel saves bf16): the port's inputs are fp32,
// and a bf16 P moves dq by up to 8e-3 against fp32, far outside the
// port's 1e-5 gradient parity.
//
// What bounds it on an H100: operations. At the training shape
// [32, 8, 512, 64] the function is four products, 2*BH*T*T*D flops each
// (34 GFLOP), on 268 MB of P plus 168 MB of the rest: about 80 flops a
// byte, above the 20 at which fp32 outside the tensor cores (67 TFLOP/s)
// meets the memory (3.35 TB/s).
//
// What the design does about it: the TPU kernel does a whole head in one
// program from VMEM; a Hopper block cannot hold a [T, T] tile, and dq
// needs whole rows of ds while dk and dv need whole columns, so the work
// is split in two grids that each write only their own tiles (no atomics,
// no [T, T] scratch):
// 1. dq: one block per (bh, 16-row query tile) keeps the tile's dP rows
//    (16 x T fp32, at most 32 KB) in shared memory, streaming 32-key tiles
//    of V; one warp per row then takes rowsum(dP * P) reading the row of P
//    once, coalesced, and turns dP into ds in place; 32-key tiles of K
//    stream through for dq. It writes each row's rowsum to a [BH, T]
//    scratch for the second grid.
// 2. dk/dv: one block per (bh, 64-key tile) keeps V, streams 32-row query
//    tiles of Q, dO, P and the rowsums, recomputes that tile of dP
//    (cheaper than a [T, T] ds round trip through memory), and accumulates
//    dk and dv in registers.
// The function's four products become five. Causal tiles whose P is 0
// are skipped. This is the simple SIMT form; wgmma on bf16 tiles is the
// next step for speed.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 16;     // query rows per dq block
constexpr int kBK = 32;     // keys per streamed tile in the dq grid
constexpr int kBS = 32;     // query rows per streamed tile in the dk/dv grid
constexpr int kR = 64;      // keys per dk/dv block
constexpr int kMaxT = 512;  // dP row tile held in shared memory

template <int D>
__global__ void __launch_bounds__(kThreads)
    sdpa_bwd_dq_kernel(const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ p,
                       const float* __restrict__ g,
                       float* __restrict__ dq, float* __restrict__ rowsum,
                       int t, float scale, int causal) {
  extern __shared__ float smem[];
  float* gs = smem;               // [kBQ][D]
  float* dps = gs + kBQ * D;      // [kBQ][kMaxT]: dP, then ds
  float* kv = dps + kBQ * kMaxT;  // [kBK][D + 1]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const float* kb = k + (int64_t)bh * t * D;
  const float* vb = v + (int64_t)bh * t * D;
  const float* gb = g + (int64_t)bh * t * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    gs[i] = q0 + r < t ? gb[(int64_t)(q0 + r) * D + i % D] : 0.f;
  }
  // P is 0 past the tile's last row under causal masking
  int kend = t;
  if (causal) kend = min(t, q0 + kBQ);
  const int ntiles = (kend + kBK - 1) / kBK;
  const int ncols = ntiles * kBK;

  // pass 1: dP = dO v^T
  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int key = kt * kBK + r;
      kv[r * (D + 1) + c] = key < t ? vb[(int64_t)key * D + c] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < kBQ * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const float* gr = gs + r * D;
      const float* vr = kv + c * (D + 1);
      float dp = 0.f;
#pragma unroll 16
      for (int e = 0; e < D; ++e) dp += gr[e] * vr[e];
      dps[r * kMaxT + kt * kBK + c] = dp;
    }
  }
  __syncthreads();

  // pass 2: one warp per row: rowsum(dP * P), then ds = P (dP - rowsum)
  const int lane = tid & 31, warp = tid >> 5;
  for (int r = warp; r < kBQ; r += kThreads / 32) {
    float* dr = dps + r * kMaxT;
    if (q0 + r >= t) {  // tile padding
      for (int c = lane; c < ncols; c += 32) dr[c] = 0.f;
      continue;
    }
    const float* pr = p + ((int64_t)bh * t + q0 + r) * t;
    float sum = 0.f;
    for (int c = lane; c < ncols; c += 32)
      if (c < t) sum += dr[c] * pr[c];
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int c = lane; c < ncols; c += 32)
      dr[c] = c < t ? pr[c] * (dr[c] - sum) : 0.f;
    if (lane == 0) rowsum[(int64_t)bh * t + q0 + r] = sum;
  }

  // pass 3: dq = scale ds k; thread owns column `col` of rows r0 + j*stride
  constexpr int kRowStride = kThreads / D;
  constexpr int kRows = kBQ / kRowStride;
  const int col = tid % D, r0 = tid / D;
  float acc[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) acc[j] = 0.f;
  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int key = kt * kBK + r;
      kv[r * (D + 1) + c] = key < t ? kb[(int64_t)key * D + c] : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < kBK; ++c) {
      const float kk = kv[c * (D + 1) + col];
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        acc[j] += dps[(r0 + j * kRowStride) * kMaxT + kt * kBK + c] * kk;
    }
  }
  float* dqb = dq + (int64_t)bh * t * D;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int r = r0 + j * kRowStride;
    if (q0 + r < t) dqb[(int64_t)(q0 + r) * D + col] = acc[j] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    sdpa_bwd_dkv_kernel(const float* __restrict__ q,
                        const float* __restrict__ v,
                        const float* __restrict__ p,
                        const float* __restrict__ g,
                        const float* __restrict__ rowsum,
                        float* __restrict__ dk, float* __restrict__ dv, int t,
                        float scale, int causal) {
  extern __shared__ float smem[];
  float* vs = smem;                 // [kR][D + 1]
  float* qs = vs + kR * (D + 1);    // [kBS][D]
  float* gs = qs + kBS * D;         // [kBS][D]
  float* ps = gs + kBS * D;         // [kBS][kR + 1]
  float* dss = ps + kBS * (kR + 1);  // [kBS][kR + 1]
  float* rs = dss + kBS * (kR + 1);  // [kBS]

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kR;
  const int tid = threadIdx.x;
  const float* qb = q + (int64_t)bh * t * D;
  const float* vb = v + (int64_t)bh * t * D;
  const float* gb = g + (int64_t)bh * t * D;
  const float* pb = p + (int64_t)bh * t * t;

  for (int i = tid; i < kR * D; i += kThreads) {
    const int r = i / D, c = i % D;
    vs[r * (D + 1) + c] = k0 + r < t ? vb[(int64_t)(k0 + r) * D + c] : 0.f;
  }

  constexpr int kRowStride = kThreads / D;
  constexpr int kRows = kR / kRowStride;
  const int col = tid % D, r0 = tid / D;
  float dk_acc[kRows], dv_acc[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  // under causal masking, query rows before k0 have P = 0 on this tile
  const int qstart = causal ? k0 / kBS * kBS : 0;
  for (int qt = qstart; qt < t; qt += kBS) {
    __syncthreads();  // previous tile's readers are done
    for (int i = tid; i < kBS * D; i += kThreads) {
      const int r = i / D;
      const bool in = qt + r < t;
      const int64_t at = (int64_t)(qt + r) * D + i % D;
      qs[i] = in ? qb[at] : 0.f;
      gs[i] = in ? gb[at] : 0.f;
    }
    if (tid < kBS)
      rs[tid] = qt + tid < t ? rowsum[(int64_t)bh * t + qt + tid] : 0.f;
    __syncthreads();
    for (int i = tid; i < kBS * kR; i += kThreads) {
      const int r = i / kR, c = i % kR;
      const int qi = qt + r, kj = k0 + c;
      float pv = 0.f, ds = 0.f;
      if (qi < t && kj < t) {
        const float* gr = gs + r * D;
        const float* vr = vs + c * (D + 1);
        float dp = 0.f;
#pragma unroll 16
        for (int e = 0; e < D; ++e) dp += gr[e] * vr[e];
        pv = pb[(int64_t)qi * t + kj];
        ds = pv * (dp - rs[r]);
      }
      ps[r * (kR + 1) + c] = pv;
      dss[r * (kR + 1) + c] = ds;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int key = r0 + j * kRowStride;
      float a = dk_acc[j], b = dv_acc[j];
#pragma unroll 8
      for (int r = 0; r < kBS; ++r) {
        a += dss[r * (kR + 1) + key] * qs[r * D + col];
        b += ps[r * (kR + 1) + key] * gs[r * D + col];
      }
      dk_acc[j] = a;
      dv_acc[j] = b;
    }
  }
  float* dkb = dk + (int64_t)bh * t * D;
  float* dvb = dv + (int64_t)bh * t * D;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int key = r0 + j * kRowStride;
    if (k0 + key < t) {
      dkb[(int64_t)(k0 + key) * D + col] = dk_acc[j] * scale;
      dvb[(int64_t)(k0 + key) * D + col] = dv_acc[j];
    }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* p,
           const float* g, float* dq, float* dk, float* dv, float* rowsum,
           int64_t bh, int t, float scale, int causal, cudaStream_t s) {
  const size_t dq_bytes =
      sizeof(float) * (kBQ * D + kBQ * kMaxT + kBK * (D + 1));
  const size_t dkv_bytes = sizeof(float) * (kR * (D + 1) + 2 * kBS * D +
                                            2 * kBS * (kR + 1) + kBS);
  cudaError_t err = cudaFuncSetAttribute(
      sdpa_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dq_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(sdpa_bwd_dkv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dkv_bytes);
  if (err != cudaSuccess) return (int)err;
  sdpa_bwd_dq_kernel<D>
      <<<dim3((t + kBQ - 1) / kBQ, (unsigned)bh), kThreads, dq_bytes, s>>>(
          k, v, p, g, dq, rowsum, t, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sdpa_bwd_dkv_kernel<D>
      <<<dim3((t + kR - 1) / kR, (unsigned)bh), kThreads, dkv_bytes, s>>>(
          q, v, p, g, rowsum, dk, dv, t, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, g (dO), dq, dk, dv: fp32 device pointers, contiguous
// [bh, t, d], t <= 512, d in {64, 128}; p: fp32 [bh, t, t]; rowsum: fp32
// [bh, t] scratch that the first grid writes and the second reads. Returns
// cudaGetLastError() of the launches (or of the shared-memory attribute
// calls); 1 (cudaErrorInvalidValue) for a shape the kernel does not take.
extern "C" int sdpa_short_bwd(const void* q, const void* k, const void* v,
                              const void* p, const void* g, void* dq,
                              void* dk, void* dv, void* rowsum, int64_t bh,
                              int t, int d, float scale, int causal,
                              void* stream) {
  if (t < 1 || t > kMaxT) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* pf = static_cast<const float*>(p);
  const float* gf = static_cast<const float*>(g);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  float* rf = static_cast<float*>(rowsum);
  switch (d) {
    case 64:
      return launch<64>(qf, kf, vf, pf, gf, dqf, dkf, dvf, rf, bh, t, scale,
                        causal, s);
    case 128:
      return launch<128>(qf, kf, vf, pf, gf, dqf, dkf, dvf, rf, bh, t, scale,
                         causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
