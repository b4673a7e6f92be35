// The whole position-wise MLP sub-layer for Hopper (sm_90a), in fp32 and in
// bf16: forward and backward.
//
// Replaces: paddle_tpu/ops/pallas/ffn_block.py `_fwd_impl` (forward) and
// `_bwd_impl` (backward), the Pallas TPU kernels behind the `ffn_block` op
// that models/transformer.py builds for every FFN of a training program
// when PADDLE_TPU_FUSE_ATTN_BLOCK=1.
//
// For x [N, D] (N = B*T token rows), W1 [D, F], b1 [F], W2 [F, D], b2 [D]:
//   forward   out = relu(x W1 + b1) W2 + b2;
//   backward  h = relu(x W1 + b1) recomputed;  dW2 = h^T g;  db2 = sum g;
//             dh = (g W2^T) [h > 0];  dW1 = x^T dh;  db1 = sum dh;
//             dx = dh W1^T.
// [h > 0] is the ReLU's mask [x W1 + b1 > 0]: h is positive exactly where
// its pre-activation is.
//
// What bounds it on an H100: operations. At the training shape (N 16384,
// D 512, F 2048) the forward is 69 GFLOP and the backward 172 GFLOP on
// 75 MB and 147 MB of inputs and outputs: over 900 flops a byte, far above
// the 20 at which fp32 outside the tensor cores (67 TFLOP/s) meets the
// memory (3.35 TB/s). On the fp32 units the forward takes 1.03 ms and the
// backward 2.56 ms; on the tensor cores in split TF32 (three TF32
// products for each fp32 one at 495 TFLOP/s) 0.42 ms and 1.04 ms.
//
// What the design does about it: the TPU kernel keeps W1 and W2 (8 MiB of
// fp32 here) resident in VMEM and the [T, F] hidden on chip; a Hopper
// block has 227 KB of shared memory. So each entry point runs its products
// in sequence on the caller's stream, on the tensor cores in split TF32
// through tile_mma.cuh, with the hidden [N, F] (134 MB) in device memory
// from the caller's allocator.
// - Both entry points compute the hidden relu(x W1 + b1) with one helper
//   (`hidden`: tile_mma.cuh's bias + ReLU epilogue), so the backward's
//   recompute has the forward's bits and every ReLU unit takes the same
//   mask in both.
// - Forward: the hidden, then out = h W2 + b2 (the bias epilogue).
// - Backward: the hidden recomputed, then four products, tile_mma.cuh's
//   epilogue doing the ReLU's mask on dh. dh is written over h in place (a
//   block of the mask product stages its tile of h in shared memory before
//   it writes any of dh), so the backward holds one [N, F] buffer. The
//   weight gradients are one product over all N rows each, split along
//   the rows into slices summed in a fixed order, and db1, db2 tile_mma.cuh's
//   column sum in a fixed order: deterministic, no atomics.
// - bf16 (the `_bf16` entry points, as AMP calls the op: it is on the
//   WHITE list): x, the weights, the biases and g are bf16 in memory and
//   every product computes in fp32, as the TPU kernel upcasts them; the
//   hidden h and dh stay fp32 in device memory; out and dx are rounded
//   once to bf16, and the weight and bias gradients are fp32 sums (the
//   row slices and column chunks in a fixed order) rounded once to bf16.
//   Per product (tile_mma.cuh's element types): x W1 and g W2^T take two
//   bf16 operands, h W2 and dh W1^T an fp32 and a bf16 one, x^T dh a bf16
//   and an fp32 one, h^T g an fp32 and a bf16 one.
// Writing the hidden and reading it back costs about 0.08 ms of HBM time
// against the forward's 1.03 ms fp32 bound; keeping it on chip needs one
// kernel for both products with an output accumulator of [64-128 rows,
// D] in registers, and wgmma: the later steps for speed.
#include "split_tf32.cuh"
#include "tile_mma.cuh"

namespace {

namespace tm = tile_mma;
using tm::bf16;

#define RETURN_IF(err)                           \
  do {                                           \
    const cudaError_t e_ = (err);                \
    if (e_ != cudaSuccess) return (int)e_;       \
  } while (0)

// h [n, f] = relu(x W1 + b1) in fp32: the forward's hidden and the
// backward's recompute, one code path so that the two have the same bits
template <typename E>
cudaError_t hidden(const E* x, const E* w1, const E* b1, float* h,
                   int64_t n, int d, int f, cudaStream_t st) {
  tm::Params p = tm::params(n, f, d, x, d, w1, f, h, f);
  p.bias = b1;
  return tm::gemm<false, false, tm::kBiasRelu, E, E, float>(p, 1, nullptr, 0,
                                                            st);
}

template <typename E>
int fwd(const void* x, const void* w1, const void* b1, const void* w2,
        const void* b2, void* out, void* h, int64_t n, int d, int f,
        void* stream) {
  if (n < 1 || d < 1 || f < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* hf = static_cast<float*>(h);
  RETURN_IF(hidden(static_cast<const E*>(x), static_cast<const E*>(w1),
                   static_cast<const E*>(b1), hf, n, d, f, st));
  // out = h W2 + b2
  tm::Params p = tm::params(n, d, f, hf, f, w2, d, out, d);
  p.bias = b2;
  return (int)tm::gemm<false, false, tm::kBias, float, E, E>(p, 1, nullptr,
                                                             0, st);
}

template <typename E>
int bwd(const void* x, const void* w1, const void* b1, const void* w2,
        const void* g, void* dx, void* dw1, void* db1, void* dw2, void* db2,
        void* h, void* ws, int64_t ws_floats, int64_t n, int d, int f,
        void* stream) {
  if (n < 1 || d < 1 || f < 1 || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const E* xe = static_cast<const E*>(x);
  const E* ge = static_cast<const E*>(g);
  float* hf = static_cast<float*>(h);
  float* wsf = static_cast<float*>(ws);
  // h = relu(x W1 + b1), recomputed
  RETURN_IF(hidden(xe, static_cast<const E*>(w1), static_cast<const E*>(b1),
                   hf, n, d, f, st));
  // dW2 = h^T g; db2 = sum g
  RETURN_IF((tm::gemm<true, false, tm::kNone, float, E, E>(
      tm::params(f, d, n, hf, f, ge, d, dw2, d), 1, wsf, ws_floats, st)));
  RETURN_IF(tm::colsum(ge, static_cast<E*>(db2), n, d, wsf, ws_floats, st));
  // dh = (g W2^T) [h > 0], over h
  tm::Params p = tm::params(n, f, d, ge, d, w2, d, hf, f);
  p.mask = hf;
  p.ldm = f;
  RETURN_IF((tm::gemm<false, true, tm::kMask, E, E, float>(p, 1, nullptr, 0,
                                                           st)));
  // dW1 = x^T dh; db1 = sum dh; dx = dh W1^T
  RETURN_IF((tm::gemm<true, false, tm::kNone, E, float, E>(
      tm::params(d, f, n, xe, d, hf, f, dw1, f), 1, wsf, ws_floats, st)));
  RETURN_IF(tm::colsum(static_cast<const float*>(hf), static_cast<E*>(db1),
                       n, f, wsf, ws_floats, st));
  return (int)tm::gemm<false, true, tm::kNone, float, E, E>(
      tm::params(n, d, f, hf, f, w1, f, dx, d), 1, nullptr, 0, st);
}

}  // namespace

// Forward. x, out [n, d]; w1 [d, f]; b1 [f]; w2 [f, d]; b2 [d]: device
// pointers, contiguous, fp32 (`ffn_block_fwd`) or bf16
// (`ffn_block_fwd_bf16`, 16-byte aligned); h [n, f]: fp32 scratch. Returns
// the first CUDA error of the launches, or 1 (cudaErrorInvalidValue) for a
// shape the kernels do not take.
extern "C" int ffn_block_fwd(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* out,
                             void* h, int64_t n, int d, int f, void* stream) {
  return fwd<float>(x, w1, b1, w2, b2, out, h, n, d, f, stream);
}

extern "C" int ffn_block_fwd_bf16(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, void* out, void* h,
                                  int64_t n, int d, int f, void* stream) {
  return fwd<bf16>(x, w1, b1, w2, b2, out, h, n, d, f, stream);
}

// Backward. x, g (the output's cotangent), dx [n, d]; w1, dw1 [d, f]; b1,
// db1 [f]; w2, dw2 [f, d]; db2 [d]: device pointers, contiguous, 16-byte
// aligned, fp32 (`ffn_block_bwd`) or bf16 (`ffn_block_bwd_bf16`).
// Scratch, fp32: h [n, f]; ws (ws_floats values, at least f) for the
// weight gradients' row slices and the column sums. Returns as
// ffn_block_fwd.
extern "C" int ffn_block_bwd(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* g, void* dx,
                             void* dw1, void* db1, void* dw2, void* db2,
                             void* h, void* ws, int64_t ws_floats, int64_t n,
                             int d, int f, void* stream) {
  return bwd<float>(x, w1, b1, w2, g, dx, dw1, db1, dw2, db2, h, ws,
                    ws_floats, n, d, f, stream);
}

extern "C" int ffn_block_bwd_bf16(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* g, void* dx, void* dw1,
                                  void* db1, void* dw2, void* db2, void* h,
                                  void* ws, int64_t ws_floats, int64_t n,
                                  int d, int f, void* stream) {
  return bwd<bf16>(x, w1, b1, w2, g, dx, dw1, db1, dw2, db2, h, ws,
                   ws_floats, n, d, f, stream);
}
