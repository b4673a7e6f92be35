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
// products for each fp32 one at 495 TFLOP/s) 0.42 ms and 1.04 ms. In bf16
// the same 69 and 172 GFLOP take 0.069 ms and 0.174 ms at 989 TFLOP/s;
// as run (h and dh as two bf16 terms) they are 103.1 and 274.9 GFLOP.
//
// What the design does about it: the TPU kernel keeps W1 and W2 (8 MiB of
// fp32 here) resident in VMEM and the [T, F] hidden on chip; a Hopper
// block has 227 KB of shared memory. So each entry point runs its products
// in sequence on the caller's stream, with the hidden [N, F] (134 MB) in
// device memory from the caller's allocator.
// - Both entry points compute the hidden relu(x W1 + b1) with one helper
//   (`hidden`, `hidden_bf16`: a bias + ReLU epilogue), so the backward's
//   recompute has the forward's bits and every ReLU unit takes the same
//   mask in both.
// - Forward: the hidden, then out = h W2 + b2 (the bias epilogue).
// - Backward: the hidden recomputed, then four products, an epilogue
//   doing the ReLU's mask on dh. dh is written over h in place, so the
//   backward holds one [N, F] buffer. The weight gradients are one product
//   over all N rows each, split along the rows into slices summed in a
//   fixed order, and db1, db2 column sums in a fixed order: deterministic,
//   no atomics.
// - fp32 (`ffn_block_fwd`, `ffn_block_bwd`): the products on the tensor
//   cores in split TF32 through tile_mma.cuh, h and dh fp32; a block of the
//   mask product stages its tile of h in shared memory before it writes
//   any of dh.
// - bf16 (the `_bf16` entry points, as AMP calls the op: it is on the
//   WHITE list): x, the weights, the biases and g are bf16 in memory and
//   every product computes on their exact values with fp32 accumulation,
//   as the TPU kernel upcasts them; out and dx are rounded once to bf16,
//   and the weight and bias gradients are fp32 sums (the row slices and
//   column chunks in a fixed order) rounded once to bf16. The products run
//   on wgmma fed by TMA through wgmma_bf16.cuh, which keeps the fp32 h and
//   dh in the same scratch as two bf16 planes, hi [N, F] then lo [N, F]
//   (hi + lo within 2^-17 of the value), each product with a planed
//   operand running hi and lo into one fp32 accumulator. Each product
//   reads its operands as they lie: x W1 (x K-major, W1 MN-major), h W2
//   (planed h K-major, W2 MN-major), h^T g (planed h and g MN-major),
//   g W2^T (g and W2 K-major), x^T dh (x and planed dh MN-major), dh W1^T
//   (planed dh and W1 K-major). The ReLU mask of dh is hi + lo > 0, read
//   from the h planes by the thread that then writes the dh planes there.
// Writing the hidden and reading it back costs about 0.08 ms of HBM time
// each way; keeping it on chip needs one kernel for both products with an
// output accumulator of [64-128 rows, D] in registers: a later step.
#include "split_tf32.cuh"
#include "tile_mma.cuh"
#include "wgmma_bf16.cuh"

namespace {

namespace tm = tile_mma;
namespace wg = wgmma_bf16;
using tm::bf16;

#define RETURN_IF(err)                           \
  do {                                           \
    const cudaError_t e_ = (err);                \
    if (e_ != cudaSuccess) return (int)e_;       \
  } while (0)

// h [n, f] = relu(x W1 + b1) in fp32: the forward's hidden and the
// backward's recompute, one code path so that the two have the same bits
cudaError_t hidden(const float* x, const float* w1, const float* b1,
                   float* h, int64_t n, int d, int f, cudaStream_t st) {
  tm::Params p = tm::params(n, f, d, x, d, w1, f, h, f);
  p.bias = b1;
  return tm::gemm<false, false, tm::kBiasRelu>(p, 1, nullptr, 0, st);
}

int fwd(const void* x, const void* w1, const void* b1, const void* w2,
        const void* b2, void* out, void* h, int64_t n, int d, int f,
        void* stream) {
  if (n < 1 || d < 1 || f < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* hf = static_cast<float*>(h);
  RETURN_IF(hidden(static_cast<const float*>(x),
                   static_cast<const float*>(w1),
                   static_cast<const float*>(b1), hf, n, d, f, st));
  // out = h W2 + b2
  tm::Params p = tm::params(n, d, f, hf, f, w2, d, out, d);
  p.bias = b2;
  return (int)tm::gemm<false, false, tm::kBias>(p, 1, nullptr, 0, st);
}

int bwd(const void* x, const void* w1, const void* b1, const void* w2,
        const void* g, void* dx, void* dw1, void* db1, void* dw2, void* db2,
        void* h, void* ws, int64_t ws_floats, int64_t n, int d, int f,
        void* stream) {
  if (n < 1 || d < 1 || f < 1 || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xe = static_cast<const float*>(x);
  const float* ge = static_cast<const float*>(g);
  float* hf = static_cast<float*>(h);
  float* wsf = static_cast<float*>(ws);
  // h = relu(x W1 + b1), recomputed
  RETURN_IF(hidden(xe, static_cast<const float*>(w1),
                   static_cast<const float*>(b1), hf, n, d, f, st));
  // dW2 = h^T g; db2 = sum g
  RETURN_IF((tm::gemm<true, false, tm::kNone>(
      tm::params(f, d, n, hf, f, ge, d, dw2, d), 1, wsf, ws_floats, st)));
  RETURN_IF(tm::colsum(ge, static_cast<float*>(db2), n, d, wsf, ws_floats,
                       st));
  // dh = (g W2^T) [h > 0], over h
  tm::Params p = tm::params(n, f, d, ge, d, w2, d, hf, f);
  p.mask = hf;
  p.ldm = f;
  RETURN_IF((tm::gemm<false, true, tm::kMask>(p, 1, nullptr, 0, st)));
  // dW1 = x^T dh; db1 = sum dh; dx = dh W1^T
  RETURN_IF((tm::gemm<true, false, tm::kNone>(
      tm::params(d, f, n, xe, d, hf, f, dw1, f), 1, wsf, ws_floats, st)));
  RETURN_IF(tm::colsum(static_cast<const float*>(hf),
                       static_cast<float*>(db1), n, f, wsf, ws_floats, st));
  return (int)tm::gemm<false, true, tm::kNone>(
      tm::params(n, d, f, hf, f, w1, f, dx, d), 1, nullptr, 0, st);
}


// h planes [2][n, f] = relu(x W1 + b1) as hi / lo bf16: the bf16 forward's
// hidden and the backward's recompute, one code path so that the two have
// the same bits
cudaError_t hidden_bf16(const bf16* x, const bf16* w1, const bf16* b1,
                        bf16* h, int64_t n, int d, int f, cudaStream_t st) {
  return wg::gemm<false, true, 1, 1, wg::kHidden>(
      {x, d, n, 1}, {w1, f, d, 1}, n, f, d, h, f, n * f, b1, nullptr, 0, st);
}

int fwd_bf16(const void* x, const void* w1, const void* b1, const void* w2,
             const void* b2, void* out, void* h, int64_t n, int d, int f,
             void* stream) {
  if (n < 1 || d < 1 || f < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* hp = static_cast<bf16*>(h);
  RETURN_IF(hidden_bf16(static_cast<const bf16*>(x),
                        static_cast<const bf16*>(w1),
                        static_cast<const bf16*>(b1), hp, n, d, f, st));
  // out = h W2 + b2
  return (int)wg::gemm<false, true, 2, 1, wg::kBias>(
      {hp, f, n, 2}, {w2, d, f, 1}, n, d, f, out, d, 0,
      static_cast<const bf16*>(b2), nullptr, 0, st);
}

int bwd_bf16(const void* x, const void* w1, const void* b1, const void* w2,
             const void* g, void* dx, void* dw1, void* db1, void* dw2,
             void* db2, void* h, void* ws, int64_t ws_floats, int64_t n,
             int d, int f, void* stream) {
  if (n < 1 || d < 1 || f < 1 || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xe = static_cast<const bf16*>(x);
  const bf16* ge = static_cast<const bf16*>(g);
  bf16* hp = static_cast<bf16*>(h);
  float* wsf = static_cast<float*>(ws);
  // h = relu(x W1 + b1), recomputed
  RETURN_IF(hidden_bf16(xe, static_cast<const bf16*>(w1),
                        static_cast<const bf16*>(b1), hp, n, d, f, st));
  // dW2 = h^T g; db2 = sum g
  RETURN_IF((wg::gemm<true, true, 2, 1, wg::kF32>(
      {hp, f, n, 2}, {ge, d, n, 1}, f, d, n, dw2, d, 0, nullptr, wsf,
      ws_floats, st)));
  RETURN_IF(tm::colsum(ge, static_cast<bf16*>(db2), n, d, wsf, ws_floats, st));
  // dh = (g W2^T) [h > 0], over h
  RETURN_IF((wg::gemm<false, false, 1, 1, wg::kMask>(
      {ge, d, n, 1}, {w2, d, f, 1}, n, f, d, hp, f, n * f, nullptr, nullptr,
      0, st)));
  // dW1 = x^T dh; db1 = sum dh; dx = dh W1^T
  RETURN_IF((wg::gemm<true, true, 1, 2, wg::kF32>(
      {xe, d, n, 1}, {hp, f, n, 2}, d, f, n, dw1, f, 0, nullptr, wsf,
      ws_floats, st)));
  RETURN_IF(wg::colsum_planes(hp, static_cast<bf16*>(db1), n, f, wsf,
                              ws_floats, st));
  return (int)wg::gemm<false, false, 2, 1, wg::kBias>(
      {hp, f, n, 2}, {w1, f, d, 1}, n, d, f, dx, d, 0, nullptr, nullptr, 0,
      st);
}

}  // namespace

// Forward. x, out [n, d]; w1 [d, f]; b1 [f]; w2 [f, d]; b2 [d]: device
// pointers, contiguous, fp32 (`ffn_block_fwd`) or bf16
// (`ffn_block_fwd_bf16`, 16-byte aligned); h [n, f]: fp32 scratch, whose
// 4 bytes an element the bf16 instance takes as the hidden's hi and lo
// planes, [n, f] bf16 each, hi first. Returns the first CUDA error of the
// launches, or 1 (cudaErrorInvalidValue) for a shape the kernels do not
// take.
extern "C" int ffn_block_fwd(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* out,
                             void* h, int64_t n, int d, int f, void* stream) {
  return fwd(x, w1, b1, w2, b2, out, h, n, d, f, stream);
}

extern "C" int ffn_block_fwd_bf16(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, void* out, void* h,
                                  int64_t n, int d, int f, void* stream) {
  return fwd_bf16(x, w1, b1, w2, b2, out, h, n, d, f, stream);
}

// Backward. x, g (the output's cotangent), dx [n, d]; w1, dw1 [d, f]; b1,
// db1 [f]; w2, dw2 [f, d]; db2 [d]: device pointers, contiguous, 16-byte
// aligned, fp32 (`ffn_block_bwd`) or bf16 (`ffn_block_bwd_bf16`).
// Scratch, fp32: h [n, f] (hi and lo bf16 planes in the bf16 instance, as
// in ffn_block_fwd; it ends holding dh); ws (ws_floats values, at least f)
// for the weight gradients' row slices and the column sums. Returns as
// ffn_block_fwd.
extern "C" int ffn_block_bwd(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* g, void* dx,
                             void* dw1, void* db1, void* dw2, void* db2,
                             void* h, void* ws, int64_t ws_floats, int64_t n,
                             int d, int f, void* stream) {
  return bwd(x, w1, b1, w2, g, dx, dw1, db1, dw2, db2, h, ws, ws_floats, n,
             d, f, stream);
}

extern "C" int ffn_block_bwd_bf16(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* g, void* dx, void* dw1,
                                  void* db1, void* dw2, void* db2, void* h,
                                  void* ws, int64_t ws_floats, int64_t n,
                                  int d, int f, void* stream) {
  return bwd_bf16(x, w1, b1, w2, g, dx, dw1, db1, dw2, db2, h, ws,
                  ws_floats, n, d, f, stream);
}

namespace {

template <bool TA, bool TB, int PA, int PB, int EPI = wg::kF32>
int product(const void* a, const void* b, void* c, int64_t m, int64_t n,
            int64_t k, int group, cudaStream_t st) {
  if (group != 0 && group != wg::kGroup) return (int)cudaErrorInvalidValue;
  const wg::Operand oa = TA ? wg::Operand{a, m, k, PA}
                            : wg::Operand{a, k, m, PA};
  const wg::Operand ob = TB ? wg::Operand{b, n, k, PB}
                            : wg::Operand{b, k, n, PB};
  const int64_t plane = EPI == wg::kSplit ? m * n : 0;
  return group == 0 ? (int)wg::gemm<TA, TB, PA, PB, EPI, 0>(
                          oa, ob, m, n, k, c, n, plane, nullptr, nullptr, 0,
                          st)
                    : (int)wg::gemm<TA, TB, PA, PB, EPI>(
                          oa, ob, m, n, k, c, n, plane, nullptr, nullptr, 0,
                          st);
}

}  // namespace

// The bf16 engine's test entry (bf16_planes.py `product_bf16`), built
// with the FFN block: one of its products' operand layouts alone, unsplit,
// into fp32 C
// [m, n] (for tests against float64): 0 x W1 (A [m][k], B [k][n]), 1 h W2
// (A two planes [m][k]), 2 h^T g (A two planes [k][m], B [k][n]), 3 g W2^T
// (A [m][k], B [n][k]), 4 x^T dh (A [k][m], B two planes [k][n]), 5 dh W1^T
// (A two planes [m][k], B [n][k]); 6 as 0 into C's bytes as two bf16
// planes [m, n], hi then lo (the attention block's qkv and dctx); planes
// lie hi then lo. The attention block's products take layouts 0 (x Wqkv),
// 1 (ctx Wo), 2 (ctx^T g), 3 (g Wo^T), 4 (x^T dqkv) and 5 (dqkv Wqkv^T).
// `group`: 64-deep slabs a fresh accumulator takes, the kernels'
// wgmma_bf16::kGroup or 0 (one accumulator for all of k, a control).
// Returns as ffn_block_fwd.
extern "C" int wgmma_product_bf16(int layout, const void* a, const void* b,
                                  void* c, int64_t m, int64_t n, int64_t k,
                                  int group, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (layout) {
    case 0: return product<false, true, 1, 1>(a, b, c, m, n, k, group, st);
    case 1: return product<false, true, 2, 1>(a, b, c, m, n, k, group, st);
    case 2: return product<true, true, 2, 1>(a, b, c, m, n, k, group, st);
    case 3: return product<false, false, 1, 1>(a, b, c, m, n, k, group, st);
    case 4: return product<true, true, 1, 2>(a, b, c, m, n, k, group, st);
    case 5: return product<false, false, 2, 1>(a, b, c, m, n, k, group, st);
    case 6:
      return product<false, true, 1, 1, wg::kSplit>(a, b, c, m, n, k, group,
                                                    st);
    default: return (int)cudaErrorInvalidValue;
  }
}
