// Flash-attention forward for Hopper (sm_90a), fp32 or bf16 in and out,
// with both products on the tensor cores: in split TF32 for fp32 inputs,
// in bf16 with P split into two bf16 parts for bf16 inputs.
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
// In bf16 the same work is 17.2 GFLOP at 989 TFLOP/s, 0.017 ms, on 34 MB,
// 0.010 ms: still the products.
//
// What the design does about it: the online-softmax body of
// flash_fwd.cuh (which sdpa_short.cu also instantiates): one block per
// (bh, 64 query rows), 4 warps of 16 rows, both products on mma.sync
// (m16n8k8 in split TF32; m16n8k16 in bf16), K and V through a two-stage cp.async
// ring split as they land, the softmax on the accumulator fragments and P
// fed straight back as the A operand of P v; causal tiles past a block's
// or a warp's last visible key are skipped.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_fwd.cuh"

namespace {

template <typename E>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int64_t bh, int tq, int tk, int d, float scale, int causal,
        void* stream) {
  if (tq < 1 || tk < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const E* qe = static_cast<const E*>(q);
  const E* ke = static_cast<const E*>(k);
  const E* ve = static_cast<const E*>(v);
  E* oe = static_cast<E*>(o);
  float* lf = static_cast<float*>(lse);
  switch (d) {
    case 64:
      return flash_fwd::launch<64, false>(qe, ke, ve, oe, lf, nullptr, bh,
                                          tq, tk, scale, causal, s);
    case 128:
      return flash_fwd::launch<128, false>(qe, ke, ve, oe, lf, nullptr, bh,
                                           tq, tk, scale, causal, s);
    case 256:
      return flash_fwd::launch<256, false>(qe, ke, ve, oe, lf, nullptr, bh,
                                           tq, tk, scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: device pointers, contiguous [bh, tq, d], 16-byte aligned (cp.async
// and pair stores); k, v: [bh, tk, d]; fp32 (flash_attention_fwd) or bf16
// (flash_attention_fwd_bf16); lse: fp32 [bh, tq], or null to skip it; d in
// {64, 128, 256}. Returns cudaGetLastError() of the launch (or of the
// shared-memory attribute call); 1 (cudaErrorInvalidValue) for a shape the
// kernel does not take.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   int64_t bh, int tq, int tk, int d,
                                   float scale, int causal, void* stream) {
  return fwd<float>(q, k, v, o, lse, bh, tq, tk, d, scale, causal, stream);
}

extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int64_t bh, int tq, int tk, int d,
                                        float scale, int causal,
                                        void* stream) {
  return fwd<__nv_bfloat16>(q, k, v, o, lse, bh, tq, tk, d, scale, causal,
                            stream);
}
