// Short-sequence attention backward for Hopper (sm_90a), fp32 or bf16 in
// and out, every product on the tensor cores (split TF32 for fp32; bf16,
// with dS split into two bf16 parts, for bf16).
//
// Replaces: paddle_tpu/ops/pallas/attention.py `_sdpa_short_bwd_impl`
// (the backward of `sdpa_short`, routed from ops/nn_ops.py `attention` for
// tq == tk, 256 < T <= 512, d in {64, 128}).
//
// Computes, from q, k, v, dO [BH, T, D] and the probabilities P [BH, T, T]
// that the forward saved (sdpa_short.cu), with no exp:
//   dv = P^T dO;  dP = dO v^T;  ds = P * (dP - rowsum(dP * P));
//   dq = scale ds k;  dk = scale ds^T q.
// P comes in the inputs' type. For fp32 inputs it is fp32 (the TPU kernel
// saves bf16): a bf16 P moves dq by up to 8e-3 against fp32, far outside
// the port's 1e-5 gradient parity. For bf16 inputs it is bf16, as on the
// TPU.
//
// What bounds it on an H100: operations. At the training shape
// [32, 8, 512, 64] the function is four products, 2*BH*T*T*D flops each
// (34.4 GFLOP), on 268 MB of P plus 235 MB of the rest: 0.52 ms on the
// fp32 units (67 TFLOP/s), 0.21 ms on the tensor cores in split TF32
// (three TF32 products for each fp32 one at 495 TFLOP/s), against 0.15 ms
// for the bytes.
//
// What the design does about it: the TPU kernel does a whole head in one
// program from VMEM; a Hopper block cannot hold a [T, T] tile, and dq
// needs whole rows of ds while dk and dv need whole columns. So this runs
// the attention stages of attn_bwd_from_p.cuh, the same code as the
// attention block's backward (attention_block.cu), on contiguous
// [BH, T, D] rows: one grid for dq per 64-row query tile streaming keys,
// one for dk and dv per 64-key tile streaming queries, each on
// mma.sync.m16n8k8 in split TF32, P read from device memory beside the
// products, tiles where a causal P is 0 skipped, no atomics. Neither holds
// a T-wide row of dP, so the dq grid takes delta = rowsum(dP P), as the
// TPU kernel takes it, in a first sweep over the key tiles that forms dP
// and sums dP P into each row. So the function's four products become six
// (dP, then dP and dq, then dP^T, dv and dk), 51.5 GFLOP at the training
// shape, and P is read three times. The kernel is a function of (q, k, v,
// P, dO) with no scratch but delta: it does not take the forward's
// output, which the TPU kernel does not take either.
//
// In bf16 (`sdpa_short_bwd_bf16`) the same function runs on the Hopper
// design of attn_wgmma.cuh: two grids of two consumer warpgroups each on
// wgmma.mma_async fed by TMA, dq with delta = rowsum(dP P) from two sweeps
// over 128-key tiles, dk and dv from 64-row query tiles, P's tiles read by
// TMA where T % 8 == 0 and gathered by the producer warp into the same
// swizzled layout at any other T, dS split into two bf16 planes in
// registers for dS k and dS^T q. What bounds it at [32, 8, 512, 64]: the
// function's 34.4 GFLOP at 989 TFLOP/s take 0.035 ms, its bytes (134 MB of
// P, 117 MB of the rest) 0.075 ms; as run P is read three times (once from
// L2) and the products are 68.7 GFLOP.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_bwd_from_p.cuh"
#include "attn_wgmma.cuh"

namespace {

constexpr int kMaxT = 512;

namespace ab = attn_bwd_from_p;

// delta from rowsum(dP P) inside the stages (a.o.base stays null)
template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* p, const void* g, void* dq, void* dk,
                   void* dv, void* rowsum, int bh, int t, float scale,
                   int causal, cudaStream_t st) {
  const int64_t head = (int64_t)t * D;
  ab::Args<float> a;
  a.q = {static_cast<const float*>(q), head, 0, D};
  a.k = {static_cast<const float*>(k), head, 0, D};
  a.v = {static_cast<const float*>(v), head, 0, D};
  a.g = {static_cast<const float*>(g), head, 0, D};
  a.o = {nullptr, head, 0, D};
  a.dq = {static_cast<float*>(dq), head, 0, D};
  a.dk = {static_cast<float*>(dk), head, 0, D};
  a.dv = {static_cast<float*>(dv), head, 0, D};
  a.p = static_cast<const float*>(p);
  a.delta = static_cast<float*>(rowsum);
  a.heads = 1;
  a.t = t;
  a.dh = D;
  a.scale = scale;
  a.causal = causal;
  return ab::run<D>(a, (unsigned)bh, st);
}

}  // namespace

// q, k, v, g (dO), dq, dk, dv: fp32 device pointers, contiguous
// [bh, t, d], 16-byte aligned, t <= 512, d in {64, 128}; p: fp32
// [bh, t, t] (any t: its rows need not be 16-byte aligned); rowsum: fp32
// scratch of at least [bh, t]. Returns the first CUDA error of the
// launches (or of the shared-memory attribute calls); 1
// (cudaErrorInvalidValue) for a shape the kernels do not take.
extern "C" int sdpa_short_bwd(const void* q, const void* k, const void* v,
                              const void* p, const void* g, void* dq,
                              void* dk, void* dv, void* rowsum, int64_t bh,
                              int t, int d, float scale, int causal,
                              void* stream) {
  if (t < 1 || t > kMaxT || bh < 1 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return (int)launch<64>(q, k, v, p, g, dq, dk, dv, rowsum, (int)bh, t,
                             scale, causal, s);
    case 128:
      return (int)launch<128>(q, k, v, p, g, dq, dk, dv, rowsum, (int)bh, t,
                              scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The same in bf16, on attn_wgmma.cuh: q, k, v, g, dq, dk, dv and p bf16,
// each on 16 bytes (TMA's rule); rowsum fp32 [bh, t rounded up to 128].
extern "C" int sdpa_short_bwd_bf16(const void* q, const void* k,
                                   const void* v, const void* p,
                                   const void* g, void* dq, void* dk,
                                   void* dv, void* rowsum, int64_t bh, int t,
                                   int d, float scale, int causal,
                                   void* stream) {
  using bf16 = __nv_bfloat16;
  if (t < 1 || t > kMaxT) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *qe = static_cast<const bf16*>(q), *ke = static_cast<const bf16*>(k),
             *ve = static_cast<const bf16*>(v), *pe = static_cast<const bf16*>(p),
             *ge = static_cast<const bf16*>(g);
  bf16 *dqe = static_cast<bf16*>(dq), *dke = static_cast<bf16*>(dk),
       *dve = static_cast<bf16*>(dv);
  float* rs = static_cast<float*>(rowsum);
  switch (d) {
    case 64:
      return (int)attn_wgmma::bwd<64>(qe, ke, ve, pe, ge, dqe, dke, dve, rs,
                                      bh, t, scale, causal, s);
    case 128:
      return (int)attn_wgmma::bwd<128>(qe, ke, ve, pe, ge, dqe, dke, dve, rs,
                                       bh, t, scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
