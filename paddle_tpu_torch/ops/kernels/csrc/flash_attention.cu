// Flash-attention forward for Hopper (sm_90a), fp32 in and out, with both
// products on the tensor cores in split TF32.
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
// [8, 8, 1024, 64] it does 4*BH*tq*tk*D = 17.2 GFLOP of products on 67 MB
// of inputs and outputs: 0.26 ms on the fp32 units (67 TFLOP/s), 0.10 ms
// on the tensor cores in split TF32 (three TF32 products for each fp32
// one at 495 TFLOP/s), against 0.02 ms for the bytes.
//
// What the design does about it: the split-TF32 online-softmax body of
// flash_fwd.cuh (which sdpa_short.cu also instantiates): one block per
// (bh, 64 query rows), 4 warps of 16 rows, both products on
// mma.sync.m16n8k8 in split TF32, K and V through a two-stage cp.async
// ring split as they land, the softmax on the accumulator fragments and P
// fed straight back as the A operand of P v; causal tiles past a block's
// or a warp's last visible key are skipped.
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_fwd.cuh"

// q, o: fp32 device pointers, contiguous [bh, tq, d], 16-byte aligned
// (cp.async and float2 stores); k, v: [bh, tk, d]; lse: fp32 [bh, tq], or
// null to skip it; d in {64, 128, 256}. Returns cudaGetLastError() of the
// launch (or of the shared-memory attribute call); 1
// (cudaErrorInvalidValue) for a shape the kernel does not take.
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
      return flash_fwd::launch<64, false>(qf, kf, vf, of, lf, nullptr, bh, tq,
                                          tk, scale, causal, s);
    case 128:
      return flash_fwd::launch<128, false>(qf, kf, vf, of, lf, nullptr, bh,
                                           tq, tk, scale, causal, s);
    case 256:
      return flash_fwd::launch<256, false>(qf, kf, vf, of, lf, nullptr, bh,
                                           tq, tk, scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
