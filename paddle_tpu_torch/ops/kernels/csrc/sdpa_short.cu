// Short-sequence fused attention forward for Hopper (sm_90a), fp32.
//
// Replaces: paddle_tpu/ops/pallas/attention.py `_sdpa_short_fwd_impl`
// (the Pallas TPU kernel behind `sdpa_short`, routed from
// ops/nn_ops.py `attention` for tq == tk, 256 < T <= 512, d in {64, 128}).
// Given somewhere to write them, it also saves the normalized
// probabilities P [BH, T, T] that the backward kernel
// (sdpa_short_bwd.cu) reads, as `_sdpa_short_fwd_impl(save_p=True)`
// does; the inference path passes none. P is saved in fp32, not the TPU
// kernel's bf16: the port's inputs are fp32 and its gradient parity is
// held to 1e-5, which a bf16 P (2^-8 relative) would break.
//
// Computes out = softmax(scale * q k^T [+ causal mask]) v for q, k, v
// [BH, T, D], tq == tk. The causal mask is `_causal_mask` (query i sees
// keys <= i); masked scores take -FLT_MAX as in `reference_attention`.
//
// What bounds it on an H100: operations. At the slice's shape
// [8, 8, 512, 64] it does 4*BH*T*T*D = 4.3 GFLOP on 33.5 MB of inputs
// and outputs, about 128 flops a byte; in fp32 outside the tensor cores
// (67 TFLOP/s) the arithmetic takes longer than the bytes (3.35 TB/s).
//
// What the design does about it: one block per (bh, 16-row query tile)
// keeps the tile's whole score row (16 x T fp32, at most 32 KB) in
// shared memory, so the scores never touch device memory and the
// softmax needs no online rescaling: pass 1 streams 32-key tiles of K
// through shared memory and writes scores, pass 2 takes each row's max
// and exponentials with one warp per row, pass 3 streams V tiles and
// accumulates the product in registers. Causal tiles past the query
// tile's last row are skipped. This is the simple SIMT form; wgmma on
// bf16 tiles is the next step for speed.
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 16;     // query rows per block
constexpr int kBK = 32;     // keys per shared-memory tile
constexpr int kMaxT = 512;  // score row held in shared memory

template <int D>
__global__ void __launch_bounds__(kThreads)
    sdpa_short_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ p_out, int t, float scale,
                      int causal) {
  extern __shared__ float smem[];
  constexpr int kTile = kBK * (D + 1);  // padded: conflict-free columns
  float* qs = smem;                     // [kBQ][D]
  float* ss = qs + kBQ * D;             // [kBQ][kMaxT]
  float* kv = ss + kBQ * kMaxT;         // [kBK][D + 1]
  float* inv_l = kv + kTile;            // [kBQ]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const float* qb = q + (int64_t)bh * t * D;
  const float* kb = k + (int64_t)bh * t * D;
  const float* vb = v + (int64_t)bh * t * D;
  float* ob = o + (int64_t)bh * t * D;

  // keys a causal tile can see end at its last query row
  int kend = t;
  if (causal) kend = min(t, q0 + kBQ);
  const int ntiles = (kend + kBK - 1) / kBK;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    qs[i] = q0 + r < t ? qb[(int64_t)(q0 + r) * D + i % D] : 0.f;
  }

  // pass 1: scores
  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int key = kt * kBK + r;
      kv[r * (D + 1) + c] = key < t ? kb[(int64_t)key * D + c] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < kBQ * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const float* qr = qs + r * D;
      const float* kr = kv + c * (D + 1);
      float s = 0.f;
#pragma unroll 16
      for (int e = 0; e < D; ++e) s += qr[e] * kr[e];
      const int key = kt * kBK + c;
      s *= scale;
      if (key >= t) s = -INFINITY;  // tile padding, not a key
      else if (causal && key > q0 + r) s = -FLT_MAX;
      ss[r * kMaxT + key] = s;
    }
  }
  __syncthreads();

  // pass 2: softmax numerators, one warp per row
  const int lane = tid & 31, warp = tid >> 5;
  const int ncols = ntiles * kBK;
  for (int r = warp; r < kBQ; r += kThreads / 32) {
    float* sr = ss + r * kMaxT;
    float m = -INFINITY;
    for (int c = lane; c < ncols; c += 32) m = fmaxf(m, sr[c]);
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int c = lane; c < ncols; c += 32) {
      const float p = expf(sr[c] - m);
      sr[c] = p;
      l += p;
    }
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    const float il = 1.f / l;
    if (lane == 0) inv_l[r] = il;
    if (p_out != nullptr && q0 + r < t) {
      // skipped causal tiles hold masked keys: their probability is 0
      float* pr = p_out + ((int64_t)bh * t + q0 + r) * t;
      for (int c = lane; c < t; c += 32) pr[c] = c < ncols ? sr[c] * il : 0.f;
    }
  }

  // pass 3: out = p v; thread owns column `col` of rows r0 + j*rstride
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
      kv[r * (D + 1) + c] = key < t ? vb[(int64_t)key * D + c] : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < kBK; ++c) {
      const float vv = kv[c * (D + 1) + col];
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        acc[j] += ss[(r0 + j * kRowStride) * kMaxT + kt * kBK + c] * vv;
    }
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int r = r0 + j * kRowStride;
    if (q0 + r < t) ob[(int64_t)(q0 + r) * D + col] = acc[j] * inv_l[r];
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o,
           float* p, int64_t bh, int t, float scale, int causal,
           cudaStream_t s) {
  const size_t bytes =
      sizeof(float) * (kBQ * D + kBQ * kMaxT + kBK * (D + 1) + kBQ);
  cudaError_t err = cudaFuncSetAttribute(
      sdpa_short_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t + kBQ - 1) / kBQ, (unsigned)bh);
  sdpa_short_kernel<D><<<grid, kThreads, bytes, s>>>(q, k, v, o, p, t, scale,
                                                     causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: fp32 device pointers, contiguous [bh, t, d], t <= 512,
// d in {64, 128}; p: fp32 [bh, t, t], or null to skip it. Returns cudaGetLastError() of the launch (or of the
// shared-memory attribute call); 1 (cudaErrorInvalidValue) for a shape
// the kernel does not take.
extern "C" int sdpa_short_fwd(const void* q, const void* k, const void* v,
                              void* o, void* p, int64_t bh, int t, int d,
                              float scale, int causal, void* stream) {
  if (t < 1 || t > kMaxT) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  float* pf = static_cast<float*>(p);
  switch (d) {
    case 64:
      return launch<64>(qf, kf, vf, of, pf, bh, t, scale, causal, s);
    case 128:
      return launch<128>(qf, kf, vf, of, pf, bh, t, scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
