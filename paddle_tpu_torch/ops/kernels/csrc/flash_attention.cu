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
// What the design does about it: in fp32 (and in bf16 at d 256) the
// online-softmax body of flash_fwd.cuh (which sdpa_short.cu also
// instantiates): one block per (bh, 64 query rows), 4 warps of 16 rows,
// both products on mma.sync (m16n8k8 in split TF32; m16n8k16 in bf16), K
// and V through a two-stage cp.async ring split as they land, the softmax
// on the accumulator fragments and P fed straight back as the A operand of
// P v; causal tiles past a block's or a warp's last visible key are
// skipped. In bf16 at d 64 and 128 the Hopper design of attn_wgmma.cuh:
// a persistent block an SM walking (bh, 128 query rows) items, two
// consumer warpgroups on wgmma.mma_async fed by TMA through a ring of K
// and V tiles (128 keys at d 64), S = q k^T SS, P's hi/lo planes as the
// register A operand of O += P v. d 256 stays on flash_fwd.cuh's body by design: its output
// accumulator (128 fp32 a thread for 64 rows) beside S, P's planes and a
// fresh 64-column accumulator needs more than the 168 registers a
// consumer thread gets; that is a dispatch by d, not a fallback.
//
// `attn_wgmma_form_bf16` runs one of attn_wgmma.cuh's operand forms alone
// (a 64 x N x 128 product), for a check of its layouts against float64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_wgmma.cuh"
#include "flash_fwd.cuh"

namespace {

int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int64_t bh, int tq, int tk, int d, float scale, int causal,
        void* stream) {
  if (tq < 1 || tk < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qe = static_cast<const float*>(q);
  const float* ke = static_cast<const float*>(k);
  const float* ve = static_cast<const float*>(v);
  float* oe = static_cast<float*>(o);
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
  return fwd(q, k, v, o, lse, bh, tq, tk, d, scale, causal, stream);
}

// The same in bf16: d 64 and 128 on attn_wgmma.cuh (q, k, v and o on 16
// bytes, TMA's rule), d 256 on flash_fwd.cuh's body.
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int64_t bh, int tq, int tk, int d,
                                        float scale, int causal,
                                        void* stream) {
  using bf16 = __nv_bfloat16;
  if (tq < 1 || tk < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* qe = static_cast<const bf16*>(q);
  const bf16* ke = static_cast<const bf16*>(k);
  const bf16* ve = static_cast<const bf16*>(v);
  bf16* oe = static_cast<bf16*>(o);
  float* lf = static_cast<float*>(lse);
  switch (d) {
    case 64:
      return (int)attn_wgmma::fwd<64>(qe, ke, ve, oe, lf, bh, tq, tk, scale,
                                      causal, s);
    case 128:
      return (int)attn_wgmma::fwd<128>(qe, ke, ve, oe, lf, bh, tq, tk, scale,
                                       causal, s);
    case 256:
      return flash_fwd::launch<256, false>(qe, ke, ve, oe, lf, nullptr, bh,
                                           tq, tk, scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// C [64, n] fp32 = A B in operand form `form` of attn_wgmma.cuh (0: SS
// K-major, 1: SS MN-major, 2: RS planes of an fp32 A; n 64 or 128): a
// bf16 [64][128] (form 0), [128][64] (form 1) or fp32 [64][128] (form 2);
// b bf16 [n][128] (form 0) or [128][n]. Returns the launch's error; 1 for
// a form or n it does not take.
extern "C" int attn_wgmma_form_bf16(int form, int n, const void* a,
                                    const void* b, void* c, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* cf = static_cast<float*>(c);
  namespace aw = attn_wgmma;
  switch (form * 1000 + n) {
    case 64: return (int)aw::form<64, 0>(a, b, cf, s);
    case 128: return (int)aw::form<128, 0>(a, b, cf, s);
    case 1064: return (int)aw::form<64, 1>(a, b, cf, s);
    case 1128: return (int)aw::form<128, 1>(a, b, cf, s);
    case 2064: return (int)aw::form<64, 2>(a, b, cf, s);
    case 2128: return (int)aw::form<128, 2>(a, b, cf, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
