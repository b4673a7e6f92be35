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
//   per head dv = P^T dctx, dP = dctx v^T, dS = P (dP - rowsum(dP P))
//   with no exp, dq = scale dS k, dk = scale dS^T q;
//   dWqkv = x^T dqkv;  dx = dqkv Wqkv^T.
//
// What bounds it on an H100: operations. At the training shape (B 64, T
// 256, D 512, H 8) the forward is 43 GFLOP and the backward 116 GFLOP on
// about 70 MB (forward) and 240 MB (backward) of inputs and outputs: over
// 400 flops a byte, far above the 20 at which fp32 outside the tensor
// cores (67 TFLOP/s) meets the memory (3.35 TB/s).
//
// What the design does about it: the TPU kernel holds the whole [D, 3D]
// weight (3 MiB of fp32 here) and a row's qkv in VMEM for each program; a
// Hopper block has 227 KB of shared memory. So each entry point runs its
// stages in sequence on the caller's stream, with the intermediates (qkv
// [B*T, 3D], ctx and dctx [B*T, D], dqkv [B*T, 3D]) in device memory from
// the caller's allocator:
// - the projections and weight gradients are the shared SIMT product of
//   tile_gemm.cuh (a weight gradient is one product over all B*T rows,
//   split along the rows into slices summed in a fixed order: no atomics);
// - the attention stage takes one block per (batch*head, 16-row query
//   tile) with the tile's whole score row (16 x T, T <= 512) in shared
//   memory, as sdpa_short.cu does, and reads q, k and v in place from the
//   qkv rows, with no transpose pass;
// - its backward is two grids, as in sdpa_short_bwd.cu: dq and rowsum(dP
//   P) per query tile with the tile's dP rows in shared memory, then dk and
//   dv per 64-key tile, which recomputes its tile of dP. Each writes only
//   its own columns of dqkv.
// The recompute of ctx in the backward is a batched product of the saved
// P and v. Dh is any multiple of 8 up to 128, which the shared-memory
// budget of the backward's second grid (82 KB at Dh 128) and its register
// accumulators (64 a thread) set. Keeping qkv and ctx out of device memory
// and tensor cores are the later steps for speed.
#include <float.h>
#include <math.h>

#include "tile_gemm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 16;      // query rows per block (forward, dq grid)
constexpr int kBK = 32;      // keys per streamed shared-memory tile
constexpr int kBS = 32;      // query rows per streamed tile (dk/dv grid)
constexpr int kR = 64;       // keys per dk/dv block
constexpr int kMaxT = 512;   // score row held in shared memory
constexpr int kMaxDh = 128;  // head width
constexpr int kAccQ = kBQ * kMaxDh / kThreads;  // output values a thread
constexpr int kAccK = kR * kMaxDh / kThreads;

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

// Backward, grid 1: dq and rowsum(dP * P) per (query tile, b*H+h).
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dq_kernel(const float* __restrict__ qkv,
                       const float* __restrict__ p,
                       const float* __restrict__ dctx,
                       float* __restrict__ dqkv, float* __restrict__ rowsum,
                       Shape s) {
  extern __shared__ float smem[];
  const int dh = s.dh, t = s.t, d3 = 3 * s.d;
  const int ts = (t + kBK - 1) / kBK * kBK;
  float* gs = smem;            // [kBQ][dh]
  float* dps = gs + kBQ * dh;  // [kBQ][ts]: dP, then dS
  float* kv = dps + kBQ * ts;  // [kBK][dh + 1]

  const int bh = blockIdx.y, b = bh / s.h, hh = bh % s.h;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int qcol = hh * dh, kcol = s.d + hh * dh, vcol = 2 * s.d + hh * dh;

  for (int i = tid; i < kBQ * dh; i += kThreads) {
    const int r = i / dh, c = i - r * dh;
    gs[i] = q0 + r < t ? dctx[at(b, t, q0 + r, s.d, qcol + c)] : 0.f;
  }
  // P is 0 past the tile's last row under causal masking
  int kend = t;
  if (s.causal) kend = min(t, q0 + kBQ);
  const int ntiles = (kend + kBK - 1) / kBK;
  const int ncols = ntiles * kBK;

  // pass 1: dP = dctx v^T
  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();
    for (int i = tid; i < kBK * dh; i += kThreads) {
      const int r = i / dh, c = i - r * dh;
      const int key = kt * kBK + r;
      kv[r * (dh + 1) + c] = key < t ? qkv[at(b, t, key, d3, vcol + c)] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < kBQ * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const float* gr = gs + r * dh;
      const float* vr = kv + c * (dh + 1);
      float dp = 0.f;
#pragma unroll 8
      for (int e = 0; e < dh; ++e) dp = fmaf(gr[e], vr[e], dp);
      dps[r * ts + kt * kBK + c] = dp;
    }
  }
  __syncthreads();

  // pass 2: one warp per row: rowsum(dP * P), then dS = P (dP - rowsum)
  const int lane = tid & 31, warp = tid >> 5;
  for (int r = warp; r < kBQ; r += kThreads / 32) {
    float* dr = dps + r * ts;
    if (q0 + r >= t) {  // tile padding
      for (int c = lane; c < ncols; c += 32) dr[c] = 0.f;
      continue;
    }
    const float* pr = p + ((int64_t)bh * t + q0 + r) * t;
    float sum = 0.f;
    for (int c = lane; c < ncols; c += 32)
      if (c < t) sum += dr[c] * pr[c];
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int c = lane; c < ncols; c += 32)
      dr[c] = c < t ? pr[c] * (dr[c] - sum) : 0.f;
    if (lane == 0) rowsum[(int64_t)bh * t + q0 + r] = sum;
  }

  // pass 3: dq = scale dS k
  float acc[kAccQ];
#pragma unroll
  for (int j = 0; j < kAccQ; ++j) acc[j] = 0.f;
  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();
    for (int i = tid; i < kBK * dh; i += kThreads) {
      const int r = i / dh, c = i - r * dh;
      const int key = kt * kBK + r;
      kv[r * (dh + 1) + c] = key < t ? qkv[at(b, t, key, d3, kcol + c)] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kAccQ; ++j) {
      const int idx = tid + j * kThreads;
      if (idx >= kBQ * dh) continue;
      const int r = idx / dh, c = idx - r * dh;
      const float* dr = dps + r * ts + kt * kBK;
      float a = acc[j];
#pragma unroll 8
      for (int cc = 0; cc < kBK; ++cc) a = fmaf(dr[cc], kv[cc * (dh + 1) + c], a);
      acc[j] = a;
    }
  }
#pragma unroll
  for (int j = 0; j < kAccQ; ++j) {
    const int idx = tid + j * kThreads;
    if (idx >= kBQ * dh) continue;
    const int r = idx / dh, c = idx - r * dh;
    if (q0 + r < t) dqkv[at(b, t, q0 + r, d3, qcol + c)] = acc[j] * s.scale;
  }
}

// Backward, grid 2: dk and dv per (64-key tile, b*H+h).
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dkv_kernel(const float* __restrict__ qkv,
                        const float* __restrict__ p,
                        const float* __restrict__ dctx,
                        const float* __restrict__ rowsum,
                        float* __restrict__ dqkv, Shape s) {
  extern __shared__ float smem[];
  const int dh = s.dh, t = s.t, d3 = 3 * s.d;
  float* vs = smem;                   // [kR][dh + 1]
  float* qs = vs + kR * (dh + 1);     // [kBS][dh]
  float* gs = qs + kBS * dh;          // [kBS][dh]
  float* ps = gs + kBS * dh;          // [kBS][kR + 1]
  float* dss = ps + kBS * (kR + 1);   // [kBS][kR + 1]
  float* rs = dss + kBS * (kR + 1);   // [kBS]

  const int bh = blockIdx.y, b = bh / s.h, hh = bh % s.h;
  const int k0 = blockIdx.x * kR;
  const int tid = threadIdx.x;
  const int qcol = hh * dh, kcol = s.d + hh * dh, vcol = 2 * s.d + hh * dh;
  const float* pb = p + (int64_t)bh * t * t;

  for (int i = tid; i < kR * dh; i += kThreads) {
    const int r = i / dh, c = i - r * dh;
    vs[r * (dh + 1) + c] =
        k0 + r < t ? qkv[at(b, t, k0 + r, d3, vcol + c)] : 0.f;
  }

  float dk_acc[kAccK], dv_acc[kAccK];
#pragma unroll
  for (int j = 0; j < kAccK; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  // under causal masking, query rows before k0 have P = 0 on this tile
  const int qstart = s.causal ? k0 / kBS * kBS : 0;
  for (int qt = qstart; qt < t; qt += kBS) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBS * dh; i += kThreads) {
      const int r = i / dh, c = i - r * dh;
      const bool in = qt + r < t;
      qs[i] = in ? qkv[at(b, t, qt + r, d3, qcol + c)] : 0.f;
      gs[i] = in ? dctx[at(b, t, qt + r, s.d, qcol + c)] : 0.f;
    }
    if (tid < kBS)
      rs[tid] = qt + tid < t ? rowsum[(int64_t)bh * t + qt + tid] : 0.f;
    __syncthreads();
    for (int i = tid; i < kBS * kR; i += kThreads) {
      const int r = i / kR, c = i % kR;
      const int qi = qt + r, kj = k0 + c;
      float pv = 0.f, ds = 0.f;
      if (qi < t && kj < t) {
        const float* gr = gs + r * dh;
        const float* vr = vs + c * (dh + 1);
        float dp = 0.f;
#pragma unroll 8
        for (int e = 0; e < dh; ++e) dp = fmaf(gr[e], vr[e], dp);
        pv = pb[(int64_t)qi * t + kj];
        ds = pv * (dp - rs[r]);
      }
      ps[r * (kR + 1) + c] = pv;
      dss[r * (kR + 1) + c] = ds;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kAccK; ++j) {
      const int idx = tid + j * kThreads;
      if (idx >= kR * dh) continue;
      const int key = idx / dh, c = idx - key * dh;
      float a = dk_acc[j], v = dv_acc[j];
#pragma unroll 8
      for (int r = 0; r < kBS; ++r) {
        a = fmaf(dss[r * (kR + 1) + key], qs[r * dh + c], a);
        v = fmaf(ps[r * (kR + 1) + key], gs[r * dh + c], v);
      }
      dk_acc[j] = a;
      dv_acc[j] = v;
    }
  }
#pragma unroll
  for (int j = 0; j < kAccK; ++j) {
    const int idx = tid + j * kThreads;
    if (idx >= kR * dh) continue;
    const int key = idx / dh, c = idx - key * dh;
    if (k0 + key < t) {
      dqkv[at(b, t, k0 + key, d3, kcol + c)] = dk_acc[j] * s.scale;
      dqkv[at(b, t, k0 + key, d3, vcol + c)] = dv_acc[j];
    }
  }
}

size_t fwd_smem(const Shape& s) {
  const int ts = (s.t + kBK - 1) / kBK * kBK;
  return sizeof(float) *
         (kBQ * s.dh + kBQ * ts + kBK * (s.dh + 1) + kBQ);
}

size_t dq_smem(const Shape& s) {
  const int ts = (s.t + kBK - 1) / kBK * kBK;
  return sizeof(float) * (kBQ * s.dh + kBQ * ts + kBK * (s.dh + 1));
}

size_t dkv_smem(const Shape& s) {
  return sizeof(float) * (kR * (s.dh + 1) + 2 * kBS * s.dh +
                          2 * kBS * (kR + 1) + kBS);
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
using tile_gemm::Params;

#define RETURN_IF(err)                           \
  do {                                           \
    const cudaError_t e_ = (err);                \
    if (e_ != cudaSuccess) return (int)e_;       \
  } while (0)

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
// pointers, contiguous. Scratch: qkv, dqkv [B*T, 3D]; ctx, dctx [B*T, D];
// rowsum [B*H, T]; ws (ws_floats values) for the weight gradients' row
// slices, or null. Returns as attention_block_fwd.
extern "C" int attention_block_bwd(
    const void* x, const void* wqkv, const void* wo, const void* p,
    const void* g, void* dx, void* dwqkv, void* dwo, void* qkv, void* ctx,
    void* dctx, void* dqkv, void* rowsum, void* ws, int64_t ws_floats, int b,
    int t, int d, int h, float scale, int causal, void* stream) {
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
  RETURN_IF(gemm(false, false, kNone,
                 params(s.rows, 3 * d, d, xf, d, wqkvf, 3 * d, qkvf, 3 * d), 1,
                 nullptr, 0, st));
  // ctx = P v, one product per (b, h): P [T, T] times v [T, Dh] (row
  // stride 3D inside qkv), into the head's columns of ctx
  Params pv = params(t, dh, t, pf, t, qkvf + 2 * d, 3 * d, ctxf, d);
  pv.inner = h;
  pv.a_outer = (int64_t)h * t * t;
  pv.a_inner = (int64_t)t * t;
  pv.b_outer = (int64_t)t * 3 * d;
  pv.b_inner = dh;
  pv.c_outer = (int64_t)t * d;
  pv.c_inner = dh;
  RETURN_IF(gemm(false, false, kNone, pv, b * h, nullptr, 0, st));
  // dWo = ctx^T g; dctx = g Wo^T
  RETURN_IF(gemm(true, false, kNone,
                 params(d, d, s.rows, ctxf, d, gf, d,
                        static_cast<float*>(dwo), d),
                 1, wsf, ws_floats, st));
  RETURN_IF(gemm(false, true, kNone,
                 params(s.rows, d, d, gf, d, static_cast<const float*>(wo), d,
                        dctxf, d),
                 1, nullptr, 0, st));
  // dq, dk, dv into dqkv
  const size_t dq_bytes = dq_smem(s), dkv_bytes = dkv_smem(s);
  RETURN_IF(allow_smem(attn_bwd_dq_kernel, dq_bytes));
  RETURN_IF(allow_smem(attn_bwd_dkv_kernel, dkv_bytes));
  attn_bwd_dq_kernel<<<dim3((t + kBQ - 1) / kBQ, b * h), kThreads, dq_bytes,
                       st>>>(qkvf, pf, dctxf, dqkvf,
                             static_cast<float*>(rowsum), s);
  RETURN_IF(cudaGetLastError());
  attn_bwd_dkv_kernel<<<dim3((t + kR - 1) / kR, b * h), kThreads, dkv_bytes,
                        st>>>(qkvf, pf, dctxf, static_cast<float*>(rowsum),
                              dqkvf, s);
  RETURN_IF(cudaGetLastError());
  // dWqkv = x^T dqkv; dx = dqkv Wqkv^T
  RETURN_IF(gemm(true, false, kNone,
                 params(d, 3 * d, s.rows, xf, d, dqkvf, 3 * d,
                        static_cast<float*>(dwqkv), 3 * d),
                 1, wsf, ws_floats, st));
  return (int)gemm(false, true, kNone,
                   params(s.rows, d, 3 * d, dqkvf, 3 * d, wqkvf, 3 * d,
                          static_cast<float*>(dx), d),
                   1, nullptr, 0, st);
}
