// The whole self-attention sub-layer for Hopper (sm_90a), in fp32 and in
// bf16: forward and backward.
//
// Replaces: paddle_tpu/ops/pallas/attention_block.py `_fwd_impl` (forward,
// optionally saving P) and `_bwd_impl` (backward from the saved P), the
// Pallas TPU kernels behind the `attention_block` op that
// models/transformer.py builds for every self-attention sub-layer of a
// training program when PADDLE_TPU_FUSE_ATTN_BLOCK=1.
//
// Forward, for x [B, T, D], Wqkv [D, 3D], Wo [D, D], H heads of Dh = D / H:
//   qkv = x Wqkv;  P = softmax(scale q k^T [causal: query i sees keys <= i])
//   per head;  ctx = P v (heads merged);  out = ctx Wo.
// With somewhere to write it, the forward also saves the normalized P
// [B, H, T, T], in fp32 (the TPU kernel saves bf16; the port's gradients
// are held to 1e-5, which a bf16 P would break). Masked scores take
// -FLT_MAX, as in `attention_block_reference`.
// Backward, from x, Wqkv, Wo, the saved P and the output's cotangent g:
//   qkv = x Wqkv and ctx = P v recomputed;  dWo = ctx^T g;  dctx = g Wo^T;
//   per head dv = P^T dctx, dP = dctx v^T, dS = P (dP - delta) with no
//   exp, delta = rowsum(dP P) = rowsum(dctx ctx), dq = scale dS k,
//   dk = scale dS^T q;  dWqkv = x^T dqkv;  dx = dqkv Wqkv^T.
//
// What bounds it on an H100: operations. At the training shape (B 64, T
// 256, D 512, H 8) the forward is 43 GFLOP and the backward 116 GFLOP on
// about 70 MB (forward) and 240 MB (backward) of inputs and outputs: over
// 400 flops a byte, far above the 20 at which fp32 outside the tensor
// cores (67 TFLOP/s) meets the memory (3.35 TB/s). On the fp32 units the
// forward takes 0.64 ms and the backward 1.73 ms; on the tensor cores in
// split TF32 (three TF32 products for each fp32 one at 495 TFLOP/s) 0.26
// and 0.70 ms. In bf16 the same 43 and 116 GFLOP take 0.043 and 0.117 ms
// at 989 TFLOP/s, which only wgmma reaches; as the bf16 instances run
// them (an operand kept as two bf16 planes counting twice, two planed
// ones or a split-TF32 one three times) they are 68.7 and 231.9 GFLOP.
//
// What the design does about it: the TPU kernel holds the whole [D, 3D]
// weight (3 MiB of fp32 here) and a row's qkv in VMEM for each program; a
// Hopper block has 227 KB of shared memory. So each entry point runs its
// stages in sequence on the caller's stream, with the intermediates (qkv
// [B*T, 3D], ctx and dctx [B*T, D], dqkv [B*T, 3D]) in device memory from
// the caller's allocator.
// - fp32 (`attention_block_fwd`, `attention_block_bwd`): every product on
//   the tensor cores in split TF32 (split_tf32.cuh). Forward: qkv = x Wqkv
//   and out = ctx Wo through tile_mma.cuh; the attention stage is
//   flash_fwd.cuh's online-softmax body, which #2 and #5 also run: one
//   block per (64 query rows, b*H + h), q, k and v read in place inside
//   the qkv rows (head h at columns h Dh, D + h Dh and 2D + h Dh of rows 3D
//   apart) and each head's columns of ctx written, rows D apart. Dh up to
//   64 runs on the body's D-64 instance, up to 128 on its D-128 one, the
//   columns past Dh zero-filled as they land. With somewhere to write it,
//   the body's P sweep writes P after the key loop and leaves the output
//   alone: out is the same bits with P and without, so the primal launch
//   and the grad op's recompute agree exactly. Backward: the six dense
//   products (qkv, ctx = P v per head, dWo, dctx, dWqkv, dx) through
//   tile_mma.cuh, a weight gradient one product over all B*T rows split
//   along the rows into slices summed in a fixed order; the attention
//   stages are the two grids of attn_bwd_from_p.cuh, which sdpa_short_bwd.cu
//   also runs, reading the saved P instead of recomputing it: dq (with
//   delta) per 64-row query tile, streaming keys, then dk and dv per
//   64-key tile, streaming queries, delta = rowsum(dctx ctx), equal to
//   rowsum(dP P) since ctx = P v is recomputed from the same P.
// - bf16 (the `_bf16` entry points, as AMP calls the op: it is on the
//   WHITE list): x, Wqkv, Wo and g are bf16 in memory and every product
//   computes on their exact values in fp32, as the TPU kernel upcasts
//   them; the saved P is fp32 (the TPU kernel saves bf16; on
//   Transformer-base's width its VMEM gate refuses the kernel and the JAX
//   package differentiates `attention_block_reference`, whose P is fp32);
//   out and dx are rounded once to bf16, the weight gradients are fp32
//   sums of row slices in a fixed order rounded once to bf16. The six
//   dense products run on wgmma fed by TMA (wgmma_bf16.cuh), each in one
//   of the FFN block's operand layouts, read as they lie. The fp32
//   intermediates live in their fp32 scratch's bytes as two bf16 planes,
//   hi [rows, cols] then lo (hi + lo within 2^-17 of the value), written
//   by the epilogue or the stage that makes them, except the forward's
//   qkv: the scores q k^T must stay exact in fp32 (planed q and k put P
//   2-6e-6 from float64, over the 1e-6 it is held to), so the forward
//   writes qkv in fp32 and runs the attention stage's fp32 split-TF32
//   body on it, whose store writes ctx as planes (the same bytes as an
//   fp32 store; a split pass would read and write them again). Forward:
//   qkv = x Wqkv (fp32), the stage, out = ctx Wo. Backward: qkv = x Wqkv
//   and dctx = g Wo^T into planes; the two grids of attn_bwd_from_p.cuh
//   on planes (mma.sync.m16n8k16, hi hi + hi lo + lo hi a step, the saved
//   P and dS split into planes), whose first grid also recomputes ctx = P
//   v into planes and delta = rowsum(dctx ctx); then dWo = ctx^T g, dWqkv =
//   x^T dqkv and dx = dqkv Wqkv^T.
// Dh is any multiple of 8 up to 128 (the backward's stages round it up to
// 32, 64 or 128 and zero-fill the rest). No atomics: two launches give
// identical bits. What it still leaves: the intermediates go through
// device memory (qkv, ctx, dctx and dqkv, 16-50 MB each at the training
// shape); the bf16 attention stages run on mma.sync, whose rate is about
// a third of wgmma's, the forward's in split TF32; the backward reads the
// saved fp32 P (134 MB at the training shape) twice in its first grid and
// once in its second.
#include "attn_bwd_from_p.cuh"
#include "flash_fwd.cuh"
#include "split_bf16.cuh"
#include "split_tf32.cuh"
#include "tile_mma.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int kMaxT = 512;   // the op's limit (the reference's P block)
constexpr int kMaxDh = 128;  // head width

struct Shape {
  int t, d, h, dh;
  int64_t rows;  // B * T
  float scale;
  int causal;
};

bool bad_shape(int b, int t, int d, int h) {
  return b < 1 || t < 1 || t > kMaxT || h < 1 || d % h != 0 ||
         (d / h) % 8 != 0 || d / h > kMaxDh;
}

Shape shape(int b, int t, int d, int h, float scale, int causal) {
  Shape s;
  s.t = t;
  s.d = d;
  s.h = h;
  s.dh = d / h;
  s.rows = (int64_t)b * t;
  s.scale = scale;
  s.causal = causal;
  return s;
}

#define RETURN_IF(err)                           \
  do {                                           \
    const cudaError_t e_ = (err);                \
    if (e_ != cudaSuccess) return (int)e_;       \
  } while (0)

// the backward's attention stages (attn_bwd_from_p.cuh) on the rows of
// qkv and dqkv: head (b, h) at columns h Dh, D + h Dh and 2D + h Dh of
// token rows 3D apart, and of ctx and dctx D apart. fp32 (E float): ctx is
// the recomputed forward's output, read for delta; planes (E
// split_bf16::planes): every view is two bf16 planes, and the first grid
// writes ctx = P v itself
template <typename E>
cudaError_t attention_stages(const E* qkv, const float* p, E* ctx,
                             const E* dctx, E* dqkv, float* delta,
                             const Shape& s, cudaStream_t st) {
  namespace ab = attn_bwd_from_p;
  constexpr bool kPlanes = attn_mma::Mma<E>::kPlanes == 2;
  const int64_t d = s.d, d3 = 3 * d, dh = s.dh, t = s.t;
  // elements from a hi plane to its lo plane
  const int64_t p3 = kPlanes ? s.rows * d3 : 0, p1 = kPlanes ? s.rows * d : 0;
  const ab::Rows<const E> q = {qkv, t * d3, dh, (int)d3, p3};
  const ab::Rows<E> dq = {dqkv, t * d3, dh, (int)d3, p3};
  ab::Args<E> a;
  a.q = q;
  a.k = q;
  a.k.base += d;
  a.v = q;
  a.v.base += 2 * d;
  a.g = {dctx, t * d, dh, (int)d, p1};
  a.o = {ctx, t * d, dh, (int)d, p1};
  a.dq = dq;
  a.dk = dq;
  a.dk.base += d;
  a.dv = dq;
  a.dv.base += 2 * d;
  a.p = p;
  a.delta = delta;
  a.heads = s.h;
  a.t = s.t;
  a.dh = s.dh;
  a.scale = s.scale;
  a.causal = s.causal;
  const unsigned bh = (unsigned)(s.rows / s.t * s.h);
  return s.dh <= 32   ? ab::run<32>(a, bh, st)
         : s.dh <= 64 ? ab::run<64>(a, bh, st)
                      : ab::run<128>(a, bh, st);
}

// the forward's attention stage on flash_fwd.cuh's D-wide fp32 body: q, k
// and v read in place from the rows of qkv (head (b, h) at columns h Dh, D
// + h Dh and 2D + h Dh of rows 3D apart), each head's columns of ctx
// written (rows D apart; kPlanes: as two bf16 planes in ctx's bytes, hi
// [B*T, D] then lo), and P [B*H, T, T] where p is not null
template <int D, bool kPlanes = false>
cudaError_t attention_stage(const float* qkv, float* ctx, float* p,
                            const Shape& s, cudaStream_t st) {
  namespace ff = flash_fwd;
  const int64_t d = s.d, d3 = 3 * d, t = s.t;
  ff::Layout lay = {};
  for (int i = 0; i < 4; ++i) {  // q, k, v; ctx
    lay.outer[i] = t * (i < 3 ? d3 : d);
    lay.inner[i] = s.dh;
    lay.ld[i] = (int)(i < 3 ? d3 : d);
  }
  lay.heads = s.h;
  lay.dh = s.dh;
  lay.plane = kPlanes ? s.rows * d : 0;
  const int64_t bh = s.rows / s.t * s.h;
  const float *q = qkv, *k = qkv + d, *v = qkv + 2 * d;
  return (cudaError_t)(
      p != nullptr
          ? ff::launch<D, true, true, kPlanes>(q, k, v, ctx, nullptr, p, bh,
                                               s.t, s.t, s.scale, s.causal,
                                               lay, st)
          : ff::launch<D, false, true, kPlanes>(q, k, v, ctx, nullptr, p,
                                                bh, s.t, s.t, s.scale,
                                                s.causal, lay, st));
}

// fp32: every product in split TF32 (tile_mma.cuh)
int fwd(const void* x, const void* wqkv, const void* wo, void* out, void* p,
        void* qkv, void* ctx, int b, int t, int d, int h, float scale,
        int causal, void* stream) {
  namespace tm = tile_mma;
  if (bad_shape(b, t, d, h)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Shape s = shape(b, t, d, h, scale, causal);
  float* qkvf = static_cast<float*>(qkv);
  float* ctxf = static_cast<float*>(ctx);
  RETURN_IF((tm::gemm<false, false, tm::kNone>(
      tm::params(s.rows, 3 * d, d, x, d, wqkv, 3 * d, qkvf, 3 * d), 1,
      nullptr, 0, st)));
  float* pf = static_cast<float*>(p);
  RETURN_IF(s.dh <= 64 ? attention_stage<64>(qkvf, ctxf, pf, s, st)
                       : attention_stage<128>(qkvf, ctxf, pf, s, st));
  return (int)tm::gemm<false, false, tm::kNone>(
      tm::params(s.rows, d, d, ctxf, d, wo, d, out, d), 1, nullptr, 0, st);
}

int bwd(const void* x, const void* wqkv, const void* wo, const void* p,
        const void* g, void* dx, void* dwqkv, void* dwo, void* qkv,
        void* ctx, void* dctx, void* dqkv, void* rowsum, void* ws,
        int64_t ws_floats, int b, int t, int d, int h, float scale,
        int causal, void* stream) {
  namespace tm = tile_mma;
  if (bad_shape(b, t, d, h)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Shape s = shape(b, t, d, h, scale, causal);
  const int dh = s.dh;
  const float* pf = static_cast<const float*>(p);
  float* qkvf = static_cast<float*>(qkv);
  float* ctxf = static_cast<float*>(ctx);
  float* dctxf = static_cast<float*>(dctx);
  float* dqkvf = static_cast<float*>(dqkv);
  float* wsf = static_cast<float*>(ws);
  // qkv = x Wqkv
  RETURN_IF((tm::gemm<false, false, tm::kNone>(
      tm::params(s.rows, 3 * d, d, x, d, wqkv, 3 * d, qkvf, 3 * d), 1,
      nullptr, 0, st)));
  // ctx = P v, one product per (b, h): P [T, T] times v [T, Dh] (row
  // stride 3D inside qkv), into the head's columns of ctx
  tm::Params pv = tm::params(t, dh, t, pf, t, qkvf + 2 * d, 3 * d, ctxf, d);
  pv.inner = h;
  pv.a_outer = (int64_t)h * t * t;
  pv.a_inner = (int64_t)t * t;
  pv.b_outer = (int64_t)t * 3 * d;
  pv.b_inner = dh;
  pv.c_outer = (int64_t)t * d;
  pv.c_inner = dh;
  RETURN_IF((tm::gemm<false, false, tm::kNone>(
      pv, b * h, nullptr, 0, st)));
  // dWo = ctx^T g; dctx = g Wo^T
  RETURN_IF((tm::gemm<true, false, tm::kNone>(
      tm::params(d, d, s.rows, ctxf, d, g, d, dwo, d), 1, wsf, ws_floats,
      st)));
  RETURN_IF((tm::gemm<false, true, tm::kNone>(
      tm::params(s.rows, d, d, g, d, wo, d, dctxf, d), 1, nullptr, 0, st)));
  // dq, dk, dv into dqkv, delta into rowsum
  float* delta = static_cast<float*>(rowsum);
  RETURN_IF(attention_stages<float>(qkvf, pf, ctxf, dctxf, dqkvf, delta, s,
                                    st));
  // dWqkv = x^T dqkv; dx = dqkv Wqkv^T
  RETURN_IF((tm::gemm<true, false, tm::kNone>(
      tm::params(d, 3 * d, s.rows, x, d, dqkvf, 3 * d, dwqkv, 3 * d), 1, wsf,
      ws_floats, st)));
  return (int)tm::gemm<false, true, tm::kNone>(
      tm::params(s.rows, d, 3 * d, dqkvf, 3 * d, wqkv, 3 * d, dx, d), 1,
      nullptr, 0, st);
}

namespace wg = wgmma_bf16;
using planes = split_bf16::planes;

// bf16. Forward: qkv = x Wqkv in fp32 (x K-major, Wqkv MN-major), the
// attention stage on it writing ctx as planes, out = ctx Wo (planed ctx
// K-major, Wo MN-major) rounded to bf16
int fwd_bf16(const void* x, const void* wqkv, const void* wo, void* out,
             void* p, void* qkv, void* ctx, int b, int t, int d, int h,
             float scale, int causal, void* stream) {
  if (bad_shape(b, t, d, h)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Shape s = shape(b, t, d, h, scale, causal);
  const int64_t n = s.rows, d3 = 3 * (int64_t)d;
  float* qkvf = static_cast<float*>(qkv);
  RETURN_IF((wg::gemm<false, true, 1, 1, wg::kF32>(
      {x, d, n, 1}, {wqkv, d3, d, 1}, n, d3, d, qkvf, d3, 0, nullptr,
      nullptr, 0, st)));
  float* pf = static_cast<float*>(p);
  float* ctxf = static_cast<float*>(ctx);
  RETURN_IF((s.dh <= 64 ? attention_stage<64, true>(qkvf, ctxf, pf, s, st)
                        : attention_stage<128, true>(qkvf, ctxf, pf, s, st)));
  return (int)wg::gemm<false, true, 2, 1, wg::kBias>(
      {ctx, d, n, 2}, {wo, d, d, 1}, n, d, d, out, d, 0, nullptr, nullptr,
      0, st);
}

// bf16. Backward: qkv = x Wqkv and dctx = g Wo^T (g and Wo K-major) into
// planes; the attention stages on planes (ctx = P v and delta, then dq,
// dk, dv into dqkv's planes); dWo = ctx^T g and dWqkv = x^T dqkv (both
// operands MN-major) in fp32 row slices summed in a fixed order; dx =
// dqkv Wqkv^T (planed dqkv and Wqkv K-major)
int bwd_bf16(const void* x, const void* wqkv, const void* wo, const void* p,
             const void* g, void* dx, void* dwqkv, void* dwo, void* qkv,
             void* ctx, void* dctx, void* dqkv, void* rowsum, void* ws,
             int64_t ws_floats, int b, int t, int d, int h, float scale,
             int causal, void* stream) {
  if (bad_shape(b, t, d, h) || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Shape s = shape(b, t, d, h, scale, causal);
  const int64_t n = s.rows, d3 = 3 * (int64_t)d;
  float* wsf = static_cast<float*>(ws);
  // qkv = x Wqkv; dctx = g Wo^T
  RETURN_IF((wg::gemm<false, true, 1, 1, wg::kSplit>(
      {x, d, n, 1}, {wqkv, d3, d, 1}, n, d3, d, qkv, d3, n * d3, nullptr,
      nullptr, 0, st)));
  RETURN_IF((wg::gemm<false, false, 1, 1, wg::kSplit>(
      {g, d, n, 1}, {wo, d, d, 1}, n, d, d, dctx, d, n * d, nullptr,
      nullptr, 0, st)));
  // ctx = P v and delta into rowsum, then dq, dk, dv into dqkv
  RETURN_IF(attention_stages<planes>(
      static_cast<const planes*>(qkv), static_cast<const float*>(p),
      static_cast<planes*>(ctx), static_cast<const planes*>(dctx),
      static_cast<planes*>(dqkv), static_cast<float*>(rowsum), s, st));
  // dWo = ctx^T g; dWqkv = x^T dqkv; dx = dqkv Wqkv^T
  RETURN_IF((wg::gemm<true, true, 2, 1, wg::kF32>(
      {ctx, d, n, 2}, {g, d, n, 1}, d, d, n, dwo, d, 0, nullptr, wsf,
      ws_floats, st)));
  RETURN_IF((wg::gemm<true, true, 1, 2, wg::kF32>(
      {x, d, n, 1}, {dqkv, d3, n, 2}, d, d3, n, dwqkv, d3, 0, nullptr, wsf,
      ws_floats, st)));
  return (int)wg::gemm<false, false, 2, 1, wg::kBias>(
      {dqkv, d3, n, 2}, {wqkv, d3, d, 1}, n, d, d3, dx, d, 0, nullptr,
      nullptr, 0, st);
}

}  // namespace

// Forward. x [B*T, D], wqkv [D, 3D], wo [D, D], out [B*T, D]: device
// pointers, contiguous, 16-byte aligned, fp32 (`attention_block_fwd`) or
// bf16 (`attention_block_fwd_bf16`); p: fp32 [B, H, T, T] (8-byte
// aligned), or null to skip it; qkv [B*T, 3D] and ctx [B*T, D]: fp32
// scratch, 16-byte aligned (the bf16 instance keeps ctx in its bytes as
// two bf16 planes [B*T, D], hi then lo). T <= 512; D / H a multiple of 8
// up to 128.
// Returns the first CUDA error of the launches, or 1
// (cudaErrorInvalidValue) for a shape the kernels do not take.
extern "C" int attention_block_fwd(const void* x, const void* wqkv,
                                   const void* wo, void* out, void* p,
                                   void* qkv, void* ctx, int b, int t, int d,
                                   int h, float scale, int causal,
                                   void* stream) {
  return fwd(x, wqkv, wo, out, p, qkv, ctx, b, t, d, h, scale, causal,
             stream);
}

extern "C" int attention_block_fwd_bf16(const void* x, const void* wqkv,
                                        const void* wo, void* out, void* p,
                                        void* qkv, void* ctx, int b, int t,
                                        int d, int h, float scale,
                                        int causal, void* stream) {
  return fwd_bf16(x, wqkv, wo, out, p, qkv, ctx, b, t, d, h, scale, causal,
                  stream);
}

// Backward. x, g (the output's cotangent), dx [B*T, D]; wqkv, dwqkv [D,
// 3D]; wo, dwo [D, D]: device pointers, contiguous, 16-byte aligned, fp32
// (`attention_block_bwd`) or bf16 (`attention_block_bwd_bf16`); p [B, H,
// T, T] as the forward saved it, fp32. Scratch, fp32: qkv, dqkv [B*T, 3D];
// ctx, dctx [B*T, D] (the bf16 instance keeps each as two bf16 planes in
// its bytes, hi then lo); rowsum [B*H, T] (delta); ws (ws_floats values)
// for the weight gradients' row slices (the bf16 instance needs it; the
// fp32 one takes null). Returns as attention_block_fwd.
extern "C" int attention_block_bwd(
    const void* x, const void* wqkv, const void* wo, const void* p,
    const void* g, void* dx, void* dwqkv, void* dwo, void* qkv, void* ctx,
    void* dctx, void* dqkv, void* rowsum, void* ws, int64_t ws_floats, int b,
    int t, int d, int h, float scale, int causal, void* stream) {
  return bwd(x, wqkv, wo, p, g, dx, dwqkv, dwo, qkv, ctx, dctx, dqkv, rowsum,
             ws, ws_floats, b, t, d, h, scale, causal, stream);
}

extern "C" int attention_block_bwd_bf16(
    const void* x, const void* wqkv, const void* wo, const void* p,
    const void* g, void* dx, void* dwqkv, void* dwo, void* qkv, void* ctx,
    void* dctx, void* dqkv, void* rowsum, void* ws, int64_t ws_floats, int b,
    int t, int d, int h, float scale, int causal, void* stream) {
  return bwd_bf16(x, wqkv, wo, p, g, dx, dwqkv, dwo, qkv, ctx, dctx, dqkv,
                  rowsum, ws, ws_floats, b, t, d, h, scale, causal, stream);
}
