// Short-sequence fused attention forward for Hopper (sm_90a), fp32 or bf16
// in and out, both products on the tensor cores (split TF32 on mma.sync
// for fp32; bf16 on wgmma with P split into two bf16 parts for bf16).
//
// Replaces: paddle_tpu/ops/pallas/attention.py `_sdpa_short_fwd_impl`
// (the Pallas TPU kernel behind `sdpa_short`, routed from
// ops/nn_ops.py `attention` for tq == tk, 256 < T <= 512, d in {64, 128}).
// Given somewhere to write them, it also saves the normalized
// probabilities P [BH, T, T] that the backward kernel
// (sdpa_short_bwd.cu) reads, as `_sdpa_short_fwd_impl(save_p=True)`
// does; the inference path passes none. P is saved in the input's type:
// bf16 for bf16 inputs, as the TPU kernel saves it, and fp32 for fp32
// inputs, where the TPU kernel still saves bf16: the port's fp32 gradient
// parity is held to 1e-5, which a bf16 P (2^-8 relative) would break.
//
// Computes out = softmax(scale * q k^T [+ causal mask]) v for q, k, v
// [BH, T, D], tq == tk. The causal mask is `_causal_mask` (query i sees
// keys <= i); masked scores take -FLT_MAX as in `reference_attention`.
//
// What bounds it on an H100: operations. At the serving shape
// [8, 8, 512, 64] it does 4*BH*T*T*D = 4.3 GFLOP of products on 33.5 MB
// of inputs and outputs: 0.064 ms on the fp32 units (67 TFLOP/s), 0.026 ms
// on the tensor cores in split TF32 (three TF32 products for each fp32
// one at 495 TFLOP/s), against 0.010 ms for the bytes. With P at the
// training shape [32, 8, 512, 64], the 268 MB of P make the bytes the
// bound: 0.12 ms for 402 MB, against 0.10 ms for the products in split
// TF32. In bf16 at the training shape with P, the bytes: 201 MB (a bf16
// P of 134 MB), 0.060 ms, against 0.017 ms for the two products at 989
// TFLOP/s.
//
// What the design does about it: the TPU kernel holds a whole [T, T]
// score block per head in VMEM; a Hopper block cannot. So this streams
// keys with an online softmax, by dtype and d:
// - fp32 (d 64, 128): the flash forward's body (flash_fwd.cuh, shared with
//   flash_attention.cu) at tq == tk: one block per (bh, 64 query rows), 4
//   warps of 16 rows, an online softmax over 32-key (D 64) or 16-key (D
//   128) tiles streamed through a cp.async ring, both products on
//   mma.sync.m16n8k8 in split TF32, the scores never leaving registers.
//   With P asked for, one more sweep over the K tiles after the key loop
//   recomputes S (a third product) and writes P = exp(S - m) / l with the
//   final row max and denominator.
// - bf16 (d 64, 128): #2's Hopper design (attn_wgmma.cuh `fwd_kernel`) at
//   tq == tk, where #2's causal offset tk - tq is 0: wgmma.mma_async fed
//   by TMA through an mbarrier ring, a persistent block an SM walking
//   (bh, 128 query rows) items in two consumer warpgroups, P's hi/lo
//   planes in P v. Without P it is #2's own kernel with no lse. With P,
//   two grids: #2's kernel writing its lse into the caller's scratch,
//   then attn_wgmma.cuh `p_kernel` on the same items and ring (K tiles
//   alone), which recomputes S = q k^T and writes P = ex2(S c - lse log2e)
//   with the row's final max and sum, staged as bf16 by each warp and
//   written by TMA stores (2-byte stores where T % 8 != 0, P's rows then
//   lying off 16 bytes); tiles past a warpgroup's causal horizon are
//   written as zeros without a product. Of the two orders that give P
//   normalized by the final statistics, this one (rather than a
//   statistics pass, then one pass forming the normalized P for both P v
//   and the store) keeps the key loop #2's, so the output is the same bits
//   with and without P and #2's timing carries over; it costs a third
//   product, S again.
// In both the output does not change with P.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_wgmma.cuh"
#include "flash_fwd.cuh"

namespace {

constexpr int kMaxT = 512;

// fp32: flash_fwd.cuh's body, with P or without
template <int D>
int launch(const float* q, const float* k, const float* v, float* o,
           float* p, float*, int64_t bh, int t, float scale, int causal,
           cudaStream_t s) {
  return p != nullptr
             ? flash_fwd::launch<D, true>(q, k, v, o, nullptr, p, bh, t, t,
                                          scale, causal, s)
             : flash_fwd::launch<D, false>(q, k, v, o, nullptr, nullptr, bh,
                                           t, t, scale, causal, s);
}

// bf16: attn_wgmma.cuh's forward, with P (lse the scratch it goes
// through) or without
template <int D>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
           const __nv_bfloat16* v, __nv_bfloat16* o, __nv_bfloat16* p,
           float* lse, int64_t bh, int t, float scale, int causal,
           cudaStream_t s) {
  if (p != nullptr && lse == nullptr) return (int)cudaErrorInvalidValue;
  return (int)(p != nullptr
                   ? attn_wgmma::fwd_with_p<D>(q, k, v, o, p, lse, bh, t,
                                               scale, causal, s)
                   : attn_wgmma::fwd<D>(q, k, v, o, nullptr, bh, t, t, scale,
                                        causal, s));
}

template <typename E>
int fwd(const void* q, const void* k, const void* v, void* o, void* p,
        void* lse, int64_t bh, int t, int d, float scale, int causal,
        void* stream) {
  if (t < 1 || t > kMaxT) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const E* qe = static_cast<const E*>(q);
  const E* ke = static_cast<const E*>(k);
  const E* ve = static_cast<const E*>(v);
  E* oe = static_cast<E*>(o);
  E* pe = static_cast<E*>(p);
  float* lf = static_cast<float*>(lse);
  switch (d) {
    case 64:
      return launch<64>(qe, ke, ve, oe, pe, lf, bh, t, scale, causal, s);
    case 128:
      return launch<128>(qe, ke, ve, oe, pe, lf, bh, t, scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: device pointers, contiguous [bh, t, d], 16-byte aligned,
// 1 <= t <= 512, d in {64, 128}; p: [bh, t, t] (4-byte aligned in fp32,
// 2-byte in bf16; any t), or null to skip it; all fp32 (sdpa_short_fwd) or
// all bf16 (sdpa_short_fwd_bf16); lse: with P in bf16, an fp32 [bh, t]
// scratch (#2's lse, from which P is formed), else unread. Returns
// cudaGetLastError() of the launch (or of the shared-memory attribute
// call); 1 (cudaErrorInvalidValue) for a shape the kernel does not take.
extern "C" int sdpa_short_fwd(const void* q, const void* k, const void* v,
                              void* o, void* p, void* lse, int64_t bh, int t,
                              int d, float scale, int causal, void* stream) {
  return fwd<float>(q, k, v, o, p, lse, bh, t, d, scale, causal, stream);
}

extern "C" int sdpa_short_fwd_bf16(const void* q, const void* k,
                                   const void* v, void* o, void* p,
                                   void* lse, int64_t bh, int t, int d,
                                   float scale, int causal, void* stream) {
  return fwd<__nv_bfloat16>(q, k, v, o, p, lse, bh, t, d, scale, causal,
                            stream);
}
