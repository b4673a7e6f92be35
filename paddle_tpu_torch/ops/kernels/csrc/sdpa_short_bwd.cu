// Short-sequence attention backward for Hopper (sm_90a), fp32 in and out,
// every product on the tensor cores in split TF32.
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
// products, tiles where a causal P is 0 skipped, no atomics. Those stages
// take rowsum(dP * P) as rowsum(dO * O) with O = P v, so neither holds a
// T-wide row of dP. O is computed here first, by one batched split-TF32
// product over the heads (tile_mma.cuh) into a [BH, T, D] scratch that the
// caller allocates: the kernel stays a function of (q, k, v, P, dO), and
// does not take the forward's output, which the TPU kernel does not take
// either. The other way, a first sweep of the dq grid over the key tiles
// summing dP * P, costs the same product and saves the scratch (33.5 MB at
// the training shape), but needs a second loop in the shared stages that
// the attention block does not run; the product is one call to tested
// code. So the function's four products become six (O, dP and dq, then
// dP^T, dv and dk), 51.5 GFLOP at the training shape, and P is read three
// times.
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_bwd_from_p.cuh"
#include "tile_mma.cuh"

namespace {

constexpr int kMaxT = 512;

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* p, const float* g, float* dq, float* dk,
                   float* dv, float* rowsum, float* o, int bh, int t,
                   float scale, int causal, cudaStream_t st) {
  namespace ab = attn_bwd_from_p;
  namespace tm = tile_mma;
  const int64_t head = (int64_t)t * D;
  // O = P v, one product per head: P [T, T] times v [T, D]
  tm::Params pv = tm::params(t, D, t, p, t, v, D, o, D);
  pv.a_outer = (int64_t)t * t;
  pv.b_outer = head;
  pv.c_outer = head;
  cudaError_t err = tm::gemm(false, false, pv, bh, nullptr, 0, st);
  if (err != cudaSuccess) return err;
  ab::Args a;
  a.q = {q, head, 0, D};
  a.k = {k, head, 0, D};
  a.v = {v, head, 0, D};
  a.g = {g, head, 0, D};
  a.o = {o, head, 0, D};
  a.dq = {dq, head, 0, D};
  a.dk = {dk, head, 0, D};
  a.dv = {dv, head, 0, D};
  a.p = p;
  a.delta = rowsum;
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
// [bh, t] and o: fp32 [bh, t, d], 16-byte aligned, scratch. Returns the
// first CUDA error of the launches (or of the shared-memory attribute
// calls); 1 (cudaErrorInvalidValue) for a shape the kernels do not take.
extern "C" int sdpa_short_bwd(const void* q, const void* k, const void* v,
                              const void* p, const void* g, void* dq,
                              void* dk, void* dv, void* rowsum, void* o,
                              int64_t bh, int t, int d, float scale,
                              int causal, void* stream) {
  if (t < 1 || t > kMaxT || bh < 1 || bh > 65535)
    return (int)cudaErrorInvalidValue;
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
  float* of = static_cast<float*>(o);
  switch (d) {
    case 64:
      return (int)launch<64>(qf, kf, vf, pf, gf, dqf, dkf, dvf, rf, of,
                             (int)bh, t, scale, causal, s);
    case 128:
      return (int)launch<128>(qf, kf, vf, pf, gf, dqf, dkf, dvf, rf, of,
                              (int)bh, t, scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
