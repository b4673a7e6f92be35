// The whole self-attention sub-layer for Hopper (sm_90a), fp32: forward
// and backward.
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
// cores (67 TFLOP/s) meets the memory (3.35 TB/s). The backward takes
// 1.73 ms on the fp32 units, 0.70 ms on the tensor cores in split TF32
// (three TF32 products for each fp32 one at 495 TFLOP/s).
//
// What the design does about it: the TPU kernel holds the whole [D, 3D]
// weight (3 MiB of fp32 here) and a row's qkv in VMEM for each program; a
// Hopper block has 227 KB of shared memory. So each entry point runs its
// stages in sequence on the caller's stream, with the intermediates (qkv
// [B*T, 3D], ctx and dctx [B*T, D], dqkv [B*T, 3D]) in device memory from
// the caller's allocator.
// - Forward: the projections are the shared SIMT product of tile_gemm.cuh;
//   the attention stage takes one block per (batch*head, 16-row query
//   tile) with the tile's whole score row (16 x T, T <= 512) in shared
//   memory, and reads q, k and v in place from the qkv rows, with no
//   transpose pass.
// - Backward: every product runs on the tensor cores in split TF32
//   (split_tf32.cuh). The six dense products (qkv, ctx = P v per head,
//   dWo, dctx, dWqkv, dx: 94.5 of the 116 GFLOP) go through tile_mma.cuh;
//   a weight gradient is one product over all B*T rows, split along the
//   rows into slices summed in a fixed order. The attention stages are
//   the two grids of attn_bwd_from_p.cuh, which sdpa_short_bwd.cu also
//   runs, reading the saved P instead of recomputing it: dq (with delta)
//   per 64-row query tile, streaming keys, then dk and dv per 64-key tile,
//   streaming queries. delta is taken as rowsum(dctx ctx), equal to
//   rowsum(dP P) since ctx = P v is recomputed from the same P: so neither
//   grid holds a T-wide row of dP. Here they read q, k and v inside the
//   qkv rows and write each head's columns of dqkv; no atomics, so two
//   launches give identical bits.
// Dh is any multiple of 8 up to 128 (the backward's stages round it up to
// 32, 64 or 128 and zero-fill the rest). Keeping qkv and ctx out of device
// memory, the forward on the tensor cores and wgmma are the later steps for
// speed.
#include <float.h>
#include <math.h>

#include "attn_bwd_from_p.cuh"
#include "tile_gemm.cuh"
#include "tile_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 16;      // query rows per block (forward)
constexpr int kBK = 32;      // keys per streamed shared-memory tile
constexpr int kMaxT = 512;   // score row held in shared memory
constexpr int kMaxDh = 128;  // head width
constexpr int kAccQ = kBQ * kMaxDh / kThreads;  // output values a thread

struct Shape {
  int t, d, h, dh;
  int64_t rows;  // B * T
  float scale;
  int causal;
};

// the row of token (b, i) of a [B*T, width] buffer, at column `col`
__device__ __forceinline__ int64_t at(int b, int t, int i, int width,
                                      int col) {
  return ((int64_t)b * t + i) * width + col;
}

// Forward attention stage: ctx (and P) from qkv. Block (query tile, b*H+h).
__global__ void __launch_bounds__(kThreads)
    attn_fwd_kernel(const float* __restrict__ qkv, float* __restrict__ ctx,
                    float* __restrict__ p_out, Shape s) {
  extern __shared__ float smem[];
  const int dh = s.dh, t = s.t, d3 = 3 * s.d;
  const int ts = (t + kBK - 1) / kBK * kBK;  // score row stride
  float* qs = smem;              // [kBQ][dh]
  float* ss = qs + kBQ * dh;     // [kBQ][ts]
  float* kv = ss + kBQ * ts;     // [kBK][dh + 1]
  float* inv_l = kv + kBK * (dh + 1);  // [kBQ]

  const int bh = blockIdx.y, b = bh / s.h, hh = bh % s.h;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int qcol = hh * dh, kcol = s.d + hh * dh, vcol = 2 * s.d + hh * dh;

  int kend = t;
  if (s.causal) kend = min(t, q0 + kBQ);
  const int ntiles = (kend + kBK - 1) / kBK;

  for (int i = tid; i < kBQ * dh; i += kThreads) {
    const int r = i / dh, c = i - r * dh;
    qs[i] = q0 + r < t ? qkv[at(b, t, q0 + r, d3, qcol + c)] : 0.f;
  }

  // pass 1: scores
  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();
    for (int i = tid; i < kBK * dh; i += kThreads) {
      const int r = i / dh, c = i - r * dh;
      const int key = kt * kBK + r;
      kv[r * (dh + 1) + c] = key < t ? qkv[at(b, t, key, d3, kcol + c)] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < kBQ * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const float* qr = qs + r * dh;
      const float* kr = kv + c * (dh + 1);
      float acc = 0.f;
#pragma unroll 8
      for (int e = 0; e < dh; ++e) acc = fmaf(qr[e], kr[e], acc);
      const int key = kt * kBK + c;
      float sc = acc * s.scale;
      if (key >= t) sc = -INFINITY;  // tile padding, not a key
      else if (s.causal && key > q0 + r) sc = -FLT_MAX;
      ss[r * ts + key] = sc;
    }
  }
  __syncthreads();

  // pass 2: softmax numerators, one warp per row
  const int lane = tid & 31, warp = tid >> 5;
  const int ncols = ntiles * kBK;
  for (int r = warp; r < kBQ; r += kThreads / 32) {
    float* sr = ss + r * ts;
    float m = -INFINITY;
    for (int c = lane; c < ncols; c += 32) m = fmaxf(m, sr[c]);
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int c = lane; c < ncols; c += 32) {
      const float e = expf(sr[c] - m);
      sr[c] = e;
      l += e;
    }
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    const float il = 1.f / l;
    if (lane == 0) inv_l[r] = il;
    if (p_out != nullptr && q0 + r < t) {
      // skipped causal tiles hold masked keys: their probability is 0
      float* pr = p_out + ((int64_t)bh * t + q0 + r) * t;
      for (int c = lane; c < t; c += 32) pr[c] = c < ncols ? sr[c] * il : 0.f;
    }
  }

  // pass 3: ctx = p v; output value tid + j * kThreads of the tile
  float acc[kAccQ];
#pragma unroll
  for (int j = 0; j < kAccQ; ++j) acc[j] = 0.f;
  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();
    for (int i = tid; i < kBK * dh; i += kThreads) {
      const int r = i / dh, c = i - r * dh;
      const int key = kt * kBK + r;
      kv[r * (dh + 1) + c] = key < t ? qkv[at(b, t, key, d3, vcol + c)] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kAccQ; ++j) {
      const int idx = tid + j * kThreads;
      if (idx >= kBQ * dh) continue;
      const int r = idx / dh, c = idx - r * dh;
      const float* sr = ss + r * ts + kt * kBK;
      float a = acc[j];
#pragma unroll 8
      for (int cc = 0; cc < kBK; ++cc) a = fmaf(sr[cc], kv[cc * (dh + 1) + c], a);
      acc[j] = a;
    }
  }
#pragma unroll
  for (int j = 0; j < kAccQ; ++j) {
    const int idx = tid + j * kThreads;
    if (idx >= kBQ * dh) continue;
    const int r = idx / dh, c = idx - r * dh;
    if (q0 + r < t) ctx[at(b, t, q0 + r, s.d, qcol + c)] = acc[j] * inv_l[r];
  }
}

size_t fwd_smem(const Shape& s) {
  const int ts = (s.t + kBK - 1) / kBK * kBK;
  return sizeof(float) *
         (kBQ * s.dh + kBQ * ts + kBK * (s.dh + 1) + kBQ);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

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

using tile_gemm::gemm;
using tile_gemm::kNone;
using tile_gemm::params;

#define RETURN_IF(err)                           \
  do {                                           \
    const cudaError_t e_ = (err);                \
    if (e_ != cudaSuccess) return (int)e_;       \
  } while (0)

// the backward's attention stages (attn_bwd_from_p.cuh) on the rows of
// qkv and dqkv: head (b, h) at columns h Dh, D + h Dh and 2D + h Dh of
// token rows 3D apart, and of ctx and dctx D apart
cudaError_t attention_stages(const float* qkv, const float* p,
                             const float* ctx, const float* dctx, float* dqkv,
                             float* delta, const Shape& s, cudaStream_t st) {
  namespace ab = attn_bwd_from_p;
  const int64_t d = s.d, d3 = 3 * d, dh = s.dh, t = s.t;
  const ab::Rows<const float> q = {qkv, t * d3, dh, (int)d3};
  const ab::Rows<float> dq = {dqkv, t * d3, dh, (int)d3};
  ab::Args a;
  a.q = q;
  a.k = q;
  a.k.base += d;
  a.v = q;
  a.v.base += 2 * d;
  a.g = {dctx, t * d, dh, (int)d};
  a.o = {ctx, t * d, dh, (int)d};
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

}  // namespace

// Forward. x [B*T, D], wqkv [D, 3D], wo [D, D], out [B*T, D]: fp32 device
// pointers, contiguous; p: fp32 [B, H, T, T], or null to skip it; qkv
// [B*T, 3D] and ctx [B*T, D]: scratch. T <= 512; D / H a multiple of 8 up
// to 128. Returns the first CUDA error of the launches, or 1
// (cudaErrorInvalidValue) for a shape the kernels do not take.
extern "C" int attention_block_fwd(const void* x, const void* wqkv,
                                   const void* wo, void* out, void* p,
                                   void* qkv, void* ctx, int b, int t, int d,
                                   int h, float scale, int causal,
                                   void* stream) {
  if (bad_shape(b, t, d, h)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Shape s = shape(b, t, d, h, scale, causal);
  const float* xf = static_cast<const float*>(x);
  float* qkvf = static_cast<float*>(qkv);
  float* ctxf = static_cast<float*>(ctx);
  RETURN_IF(gemm(false, false, kNone,
                 params(s.rows, 3 * d, d, xf, d,
                        static_cast<const float*>(wqkv), 3 * d, qkvf, 3 * d),
                 1, nullptr, 0, st));
  const size_t bytes = fwd_smem(s);
  RETURN_IF(allow_smem(attn_fwd_kernel, bytes));
  attn_fwd_kernel<<<dim3((t + kBQ - 1) / kBQ, b * h), kThreads, bytes, st>>>(
      qkvf, ctxf, static_cast<float*>(p), s);
  RETURN_IF(cudaGetLastError());
  return (int)gemm(false, false, kNone,
                   params(s.rows, d, d, ctxf, d,
                          static_cast<const float*>(wo), d,
                          static_cast<float*>(out), d),
                   1, nullptr, 0, st);
}

// Backward. x, g (the output's cotangent), dx [B*T, D]; wqkv, dwqkv [D,
// 3D]; wo, dwo [D, D]; p [B, H, T, T] as the forward saved it: fp32 device
// pointers, contiguous, 16-byte aligned. Scratch: qkv, dqkv [B*T, 3D];
// ctx, dctx [B*T, D]; rowsum [B*H, T] (delta); ws (ws_floats values) for
// the weight gradients' row slices, or null. Returns as
// attention_block_fwd.
extern "C" int attention_block_bwd(
    const void* x, const void* wqkv, const void* wo, const void* p,
    const void* g, void* dx, void* dwqkv, void* dwo, void* qkv, void* ctx,
    void* dctx, void* dqkv, void* rowsum, void* ws, int64_t ws_floats, int b,
    int t, int d, int h, float scale, int causal, void* stream) {
  namespace tm = tile_mma;
  if (bad_shape(b, t, d, h)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Shape s = shape(b, t, d, h, scale, causal);
  const int dh = s.dh;
  const float* xf = static_cast<const float*>(x);
  const float* wqkvf = static_cast<const float*>(wqkv);
  const float* pf = static_cast<const float*>(p);
  const float* gf = static_cast<const float*>(g);
  float* qkvf = static_cast<float*>(qkv);
  float* ctxf = static_cast<float*>(ctx);
  float* dctxf = static_cast<float*>(dctx);
  float* dqkvf = static_cast<float*>(dqkv);
  float* wsf = static_cast<float*>(ws);
  // qkv = x Wqkv
  RETURN_IF(tm::gemm(false, false,
                     tm::params(s.rows, 3 * d, d, xf, d, wqkvf, 3 * d, qkvf,
                                3 * d),
                     1, nullptr, 0, st));
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
  RETURN_IF(tm::gemm(false, false, pv, b * h, nullptr, 0, st));
  // dWo = ctx^T g; dctx = g Wo^T
  RETURN_IF(tm::gemm(true, false,
                     tm::params(d, d, s.rows, ctxf, d, gf, d,
                                static_cast<float*>(dwo), d),
                     1, wsf, ws_floats, st));
  RETURN_IF(tm::gemm(false, true,
                     tm::params(s.rows, d, d, gf, d,
                                static_cast<const float*>(wo), d, dctxf, d),
                     1, nullptr, 0, st));
  // dq, dk, dv into dqkv, delta into rowsum
  float* delta = static_cast<float*>(rowsum);
  RETURN_IF(attention_stages(qkvf, pf, ctxf, dctxf, dqkvf, delta, s, st));
  // dWqkv = x^T dqkv; dx = dqkv Wqkv^T
  RETURN_IF(tm::gemm(true, false,
                     tm::params(d, 3 * d, s.rows, xf, d, dqkvf, 3 * d,
                                static_cast<float*>(dwqkv), 3 * d),
                     1, wsf, ws_floats, st));
  return (int)tm::gemm(false, true,
                       tm::params(s.rows, d, 3 * d, dqkvf, 3 * d, wqkvf,
                                  3 * d, static_cast<float*>(dx), d),
                       1, nullptr, 0, st);
}
