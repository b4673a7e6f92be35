// Flash-attention forward for Hopper (sm_90a), fp32.
//
// Replaces: paddle_tpu/ops/pallas/attention.py `_flash_fwd_impl` /
// `_fwd_kernel` (the Pallas TPU kernel behind `flash_attention`, routed
// from ops/nn_ops.py `attention` for T > 512, d in {64, 128, 256}). Like
// the TPU kernel it also writes the per-row logsumexp that the backward
// kernels (flash_attention_bwd.cu) read, when given somewhere to write
// it; the inference path passes none and writes only the output.
//
// Computes out = softmax(scale * q k^T [+ causal mask]) v for q [BH, tq, D],
// k, v [BH, tk, D]. Causal masking is bottom-right aligned: query i sees
// keys <= i + tk - tq. Masked scores take -FLT_MAX, as in
// `reference_attention`, so a fully masked row (tq > tk) yields the
// uniform average of v instead of NaN; its logsumexp, -FLT_MAX + log(tk),
// rounds to -FLT_MAX.
//
// What bounds it on an H100: operations. At the slice's shape
// [8, 8, 1024, 64] it does 4*BH*tq*tk*D = 17.2 GFLOP on 67 MB of inputs
// and outputs, about 256 flops a byte; in fp32 outside the tensor cores
// (67 TFLOP/s) the arithmetic takes longer than the bytes (3.35 TB/s).
//
// What the design does about it: the [tq, tk] score matrix never exists.
// One block per (bh, 32-row query tile) streams 32-key tiles of K and V
// through shared memory and carries the online-softmax state (row max m,
// denominator l, and the 32 x D accumulator in registers) in fp32 across
// the tiles. Each warp owns four query rows for the softmax update, with
// one key per lane; each thread owns one output column of D/8 rows for
// the product. Causal tiles wholly past a query tile's last visible key
// are skipped. Blocks are independent (a TPU grid step could carry state
// to the next one; a Hopper block cannot), so the key loop lives inside
// the block. This is the simple SIMT form; wgmma on bf16 tiles is the
// next step for speed.
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 32;  // query rows per block
constexpr int kBK = 32;  // keys per tile: one per lane in the softmax step

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int tq, int tk, float scale,
                     int causal) {
  extern __shared__ float smem[];
  float* qs = smem;                   // [kBQ][D]
  float* ks = qs + kBQ * D;           // [kBK][D + 1], padded
  float* vs = ks + kBK * (D + 1);     // [kBK][D]
  float* ss = vs + kBK * D;           // [kBQ][kBK + 1]
  float* m_s = ss + kBQ * (kBK + 1);  // [kBQ] running max
  float* l_s = m_s + kBQ;             // [kBQ] running denominator
  float* c_s = l_s + kBQ;             // [kBQ] this tile's correction

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int offset = tk - tq;
  const float* qb = q + (int64_t)bh * tq * D;
  const float* kb = k + (int64_t)bh * tk * D;
  const float* vb = v + (int64_t)bh * tk * D;
  float* ob = o + (int64_t)bh * tq * D;

  // With no fully masked row in the tile, keys past the last row's
  // horizon add exp(-FLT_MAX - m) = 0 and can be skipped.
  int kend = tk;
  if (causal && q0 + offset >= 0) kend = min(tk, q0 + kBQ + offset);
  const int ntiles = (kend + kBK - 1) / kBK;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    qs[i] = q0 + r < tq ? qb[(int64_t)(q0 + r) * D + i % D] : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  constexpr int kRowStride = kThreads / D;
  constexpr int kRows = kBQ / kRowStride;
  const int col = tid % D, r0 = tid / D;
  float acc[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) acc[j] = 0.f;

  const int lane = tid & 31, warp = tid >> 5;
  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();  // previous tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int key = kt * kBK + r;
      const bool in = key < tk;
      ks[r * (D + 1) + c] = in ? kb[(int64_t)key * D + c] : 0.f;
      vs[r * D + c] = in ? vb[(int64_t)key * D + c] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < kBQ * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const float* qr = qs + r * D;
      const float* kr = ks + c * (D + 1);
      float s = 0.f;
#pragma unroll 16
      for (int e = 0; e < D; ++e) s += qr[e] * kr[e];
      const int key = kt * kBK + c;
      s *= scale;
      if (key >= tk) s = -INFINITY;  // tile padding, not a key
      else if (causal && key > q0 + r + offset) s = -FLT_MAX;
      ss[r * (kBK + 1) + c] = s;
    }
    __syncthreads();
    // online-softmax update: warp `warp` owns rows 4*warp .. 4*warp+3
    for (int r = warp; r < kBQ; r += kThreads / 32) {
      const float s = ss[r * (kBK + 1) + lane];
      float mx = s;
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p = expf(s - m_new);
      float sum = p;
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      ss[r * (kBK + 1) + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);  // 0 on the first tile
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int r = r0 + j * kRowStride;
      const float* pr = ss + r * (kBK + 1);
      float a = acc[j] * c_s[r];
#pragma unroll 8
      for (int c = 0; c < kBK; ++c) a += pr[c] * vs[c * D + col];
      acc[j] = a;
    }
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int r = r0 + j * kRowStride;
    if (q0 + r < tq) ob[(int64_t)(q0 + r) * D + col] = acc[j] / l_s[r];
  }
  if (lse != nullptr && tid < kBQ && q0 + tid < tq)
    lse[(int64_t)bh * tq + q0 + tid] = m_s[tid] + logf(l_s[tid]);
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int64_t bh, int tq, int tk, float scale, int causal,
           cudaStream_t s) {
  const size_t bytes = sizeof(float) * (kBQ * D + kBK * (D + 1) + kBK * D +
                                        kBQ * (kBK + 1) + 3 * kBQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((tq + kBQ - 1) / kBQ, (unsigned)bh);
  flash_fwd_kernel<D><<<grid, kThreads, bytes, s>>>(q, k, v, o, lse, tq, tk,
                                                    scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: fp32 device pointers, contiguous [bh, tq, d]; k, v: [bh, tk, d];
// lse: fp32 [bh, tq], or null to skip it; d in {64, 128, 256}. Returns cudaGetLastError() of the launch (or of
// the shared-memory attribute call); 1 (cudaErrorInvalidValue) for a
// shape the kernel does not take.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   int64_t bh, int tq, int tk, int d,
                                   float scale, int causal, void* stream) {
  if (tq < 1 || tk < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  switch (d) {
    case 64:
      return launch<64>(qf, kf, vf, of, lf, bh, tq, tk, scale, causal, s);
    case 128:
      return launch<128>(qf, kf, vf, of, lf, bh, tq, tk, scale, causal, s);
    case 256:
      return launch<256>(qf, kf, vf, of, lf, bh, tq, tk, scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
