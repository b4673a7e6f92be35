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
//   memory, as sdpa_short.cu does, and reads q, k and v in place from the
//   qkv rows, with no transpose pass.
// - Backward: every product runs on the tensor cores in split TF32
//   (split_tf32.cuh). The six dense products (qkv, ctx = P v per head,
//   dWo, dctx, dWqkv, dx: 94.5 of the 116 GFLOP) go through tile_mma.cuh;
//   a weight gradient is one product over all B*T rows, split along the
//   rows into slices summed in a fixed order. The attention stages are
//   two grids in the form of flash_attention_bwd.cu, reading the saved P
//   instead of recomputing it: dq (with delta) per 64-row query tile,
//   streaming keys, then dk and dv per 64-key tile, streaming queries.
//   delta is taken as rowsum(dctx ctx), equal to rowsum(dP P) since P's
//   rows are normalized and ctx = P v is recomputed from the same P: so
//   neither grid holds a T-wide row of dP, and each streams its tiles
//   once. Both form dP (or dP^T) as accumulator fragments and feed dS,
//   P^T and dS^T straight back as A operands. Each writes only its own
//   columns of dqkv; no atomics, so two launches give identical bits.
// Dh is any multiple of 8 up to 128 (the backward's stages round it up to
// 32, 64 or 128 and zero-fill the rest). Keeping qkv and ctx out of device
// memory, the forward on the tensor cores and wgmma are the later steps for
// speed.
#include <float.h>
#include <math.h>

#include "tile_gemm.cuh"
#include "tile_mma.cuh"

namespace {

using namespace split_tf32;

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

// ---------------------------------------------------------------------------
// The backward's attention stages, split TF32 on the tensor cores
// (split_tf32.cuh), from the saved P: no exp. DP is the head width Dh
// rounded up to 32, 64 or 128; the columns past Dh are zero-filled as they
// land and never written.
// ---------------------------------------------------------------------------

// Grid 1: dq, and delta = rowsum(dP * P) into `delta`, per (64-row query
// tile, b*H+h); 4 warps of 16 rows; dctx resident, k and v streamed.
template <int DP>
struct DqTile {
  static constexpr int R = 64;                   // query rows a block
  static constexpr int C = DP == 128 ? 16 : 32;  // keys a streamed tile
  static constexpr int kThreads = 32 * R / 16;
  static constexpr size_t kSmem =
      sizeof(float) * (R * (DP + kPad) + 6 * C * (DP + kPad) + R);
};

template <int DP>
__global__ void __launch_bounds__(DqTile<DP>::kThreads)
    attn_bwd_dq_kernel(const float* __restrict__ qkv,
                       const float* __restrict__ p,
                       const float* __restrict__ ctx,
                       const float* __restrict__ dctx,
                       float* __restrict__ dqkv, float* __restrict__ delta,
                       Shape s) {
  using T = DqTile<DP>;
  constexpr int R = T::R, C = T::C, LD = DP + kPad, NT = C / 8, ND = DP / 8;
  constexpr int kThreads = T::kThreads;
  static_assert(kThreads == 2 * R, "two threads a row for delta");
  extern __shared__ __align__(16) float smem[];
  float* gs = smem;                // dctx [R][LD]
  float* ring = gs + R * LD;       // stage st: k [C][LD], then v [C][LD]
  float* klo = ring + 4 * C * LD;  // small halves: k [C][LD], v [C][LD]
  float* vlo = klo + C * LD;
  float* dl_s = vlo + C * LD;      // delta [R]

  const int dh = s.dh, t = s.t, d = s.d, d3 = 3 * s.d;
  const int bh = blockIdx.y, b = bh / s.h, hh = bh % s.h;
  const int q0 = blockIdx.x * R;
  const int tid = threadIdx.x;
  const int lane = tid % 32, gr = lane / 4, tc = lane % 4;
  const int m0 = tid / 32 * 16;  // this warp's rows within the block
  const float* kb = qkv + (int64_t)b * t * d3 + d + hh * dh;
  const float* vb = kb + d;
  const float* pb = p + (int64_t)bh * t * t;
  const int64_t head = (int64_t)b * t * d + hh * dh;  // in ctx and dctx

  load_tile<DP, R, kThreads>(gs, dctx + head, d, q0, t, dh, tid);
  // P is 0 past the block's last row under causal masking, and a warp
  // skips the tiles past its own last row
  const int kend = s.causal ? min(t, q0 + R) : t;
  const int ntiles = (kend + C - 1) / C;
  const int warp_last = q0 + m0 + 15;
  load_tile<DP, C, kThreads>(ring, kb, d3, 0, t, dh, tid);
  load_tile<DP, C, kThreads>(ring + C * LD, vb, d3, 0, t, dh, tid);
  cp_commit();

  // delta = rowsum(dP * P) = rowsum(dctx * ctx), as ctx = P v: the same
  // quantity as flash's delta and the reference's row sum, without a
  // T-wide row of dP. Two threads a row, every other 4-column chunk each.
  {
    const int r = tid / 2, row = q0 + r;
    float sum = 0.f;
    if (row < t) {
      const int64_t at = head + (int64_t)row * d;
      for (int c = tid % 2 * 4; c < dh; c += 8) {
        const float4 x = *reinterpret_cast<const float4*>(dctx + at + c);
        const float4 y = *reinterpret_cast<const float4*>(ctx + at + c);
        sum = fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, fmaf(x.w, y.w,
                                                                sum))));
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (tid % 2 == 0) {
      dl_s[r] = sum;
      if (row < t) delta[(int64_t)bh * t + row] = sum;
    }
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const float* gw = gs + m0 * LD;

  for (int kt = 0; kt < ntiles; ++kt) {
    float* ks = ring + (kt & 1) * 2 * C * LD;
    float* vs = ks + C * LD;
    if (kt + 1 < ntiles) {
      float* nk = ring + ((kt + 1) & 1) * 2 * C * LD;
      load_tile<DP, C, kThreads>(nk, kb, d3, (kt + 1) * C, t, dh, tid);
      load_tile<DP, C, kThreads>(nk + C * LD, vb, d3, (kt + 1) * C, t, dh,
                                 tid);
    }
    cp_commit();
    cp_wait<1>();  // this tile (and dctx) have landed
    split_rows<DP, C, kThreads>(ks, klo, tid);
    split_rows<DP, C, kThreads>(vs, vlo, tid);
    __syncthreads();
    if (!(s.causal && kt * C > warp_last)) {
      // this tile's P as accumulator fragments: (row gr | gr+8, key 2tc |
      // 2tc+1), read before the product so the loads overlap it
      float pf[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = q0 + m0 + gr + (i >> 1) * 8;
          const int key = kt * C + j * 8 + 2 * tc + (i & 1);
          pf[j][i] = row < t && key < t ? pb[(int64_t)row * t + key] : 0.f;
          dp[j][i] = 0.f;
        }
      // dP = dctx v^T
#pragma unroll
      for (int kk = 0; kk < DP; kk += 8) {
        const OpA a = load_a(gw + kk, LD, gr, tc);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int at = j * 8 * LD + kk;
          mma3(dp[j], a, load_b_t(vs + at, vlo + at, LD, gr, tc));
        }
      }
      // dS = P (dP - delta), then dq += dS k
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dp[j][i] = pf[j][i] * (dp[j][i] - dl_s[m0 + gr + (i >> 1) * 8]);
        const OpA a = acc_as_a(dp[j]);
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          const int at = j * 8 * LD + n * 8;
          mma3(acc[n], a, load_b_perm(ks + at, klo + at, LD, gr, tc));
        }
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }
  cp_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + m0 + gr + h * 8;
    if (row >= t) continue;
    float* out = dqkv + ((int64_t)b * t + row) * d3 + hh * dh + 2 * tc;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      if (n * 8 < dh)
        *reinterpret_cast<float2*>(out + n * 8) = make_float2(
            acc[n][2 * h] * s.scale, acc[n][2 * h + 1] * s.scale);
  }
}

// Grid 2: dk and dv per (64-key tile, b*H+h); v resident, 32-row query
// tiles of q, dctx and delta streamed. Warp w owns keys 16 (w / SPLIT) and
// output columns (w % SPLIT) DP / SPLIT. It forms dP^T = v dctx^T and
// dS^T = P^T (dP^T - delta) as accumulator fragments (keys as rows) and
// feeds P^T and dS^T back as the A operands of dv += P^T dctx and
// dk += dS^T q.
template <int DP>
struct DkvTile {
  static constexpr int C = 64;  // keys a block
  static constexpr int R = 32;  // queries a streamed tile
  // at Dh 128 two warps share 16 keys: a thread's registers do not hold
  // both [16, 128] accumulators
  static constexpr int SPLIT = DP == 128 ? 2 : 1;
  static constexpr int kThreads = 32 * (C / 16) * SPLIT;
  static constexpr size_t kSmem =
      sizeof(float) * (C * (DP + kPad) + 6 * R * (DP + kPad) + 2 * R);
};

template <int DP>
__global__ void __launch_bounds__(DkvTile<DP>::kThreads)
    attn_bwd_dkv_kernel(const float* __restrict__ qkv,
                        const float* __restrict__ p,
                        const float* __restrict__ dctx,
                        const float* __restrict__ delta,
                        float* __restrict__ dqkv, Shape s) {
  using T = DkvTile<DP>;
  constexpr int R = T::R, C = T::C, LD = DP + kPad, NT = R / 8;
  constexpr int NO = DP / T::SPLIT / 8;  // output column tiles a warp
  constexpr int kThreads = T::kThreads;
  extern __shared__ __align__(16) float smem[];
  float* vs = smem;                // [C][LD]
  float* ring = vs + C * LD;       // stage st: q [R][LD], then dctx [R][LD]
  float* qlo = ring + 4 * R * LD;  // small halves: q [R][LD], dctx [R][LD]
  float* glo = qlo + R * LD;
  float* vec = glo + R * LD;       // stage st: delta [R]

  const int dh = s.dh, t = s.t, d = s.d, d3 = 3 * s.d;
  const int bh = blockIdx.y, b = bh / s.h, hh = bh % s.h;
  const int k0 = blockIdx.x * C;
  const int tid = threadIdx.x;
  const int lane = tid % 32, gr = lane / 4, tc = lane % 4;
  const int warp = tid / 32;
  const int m0 = warp / T::SPLIT * 16;      // this warp's keys in the block
  const int c0 = warp % T::SPLIT * NO * 8;  // and its output columns
  const float* qb = qkv + (int64_t)b * t * d3 + hh * dh;
  const float* gb = dctx + (int64_t)b * t * d + hh * dh;
  const float* db = delta + (int64_t)bh * t;
  const float* pb = p + (int64_t)bh * t * t;

  auto fetch = [&](int qt, int st) {
    float* qs_ = ring + st * 2 * R * LD;
    load_tile<DP, R, kThreads>(qs_, qb, d3, qt, t, dh, tid);
    load_tile<DP, R, kThreads>(qs_ + R * LD, gb, d, qt, t, dh, tid);
    load_vec<R, kThreads>(vec + st * R, db, qt, t, tid);
  };

  load_tile<DP, C, kThreads>(vs, qb + 2 * d, d3, k0, t, dh, tid);
  // under causal masking, query rows before k0 have P = 0 on these keys,
  // and a warp skips the tiles before its own first key
  int qt = s.causal ? k0 / R * R : 0;
  fetch(qt, 0);
  cp_commit();
  const int warp_first = k0 + m0;

  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[n][i] = dv_acc[n][i] = 0.f;
  const float* vw = vs + m0 * LD;

  for (int st = 0; qt < t; st ^= 1) {
    const int nxt = qt + R;
    if (nxt < t) fetch(nxt, st ^ 1);
    cp_commit();
    cp_wait<1>();  // this tile (and v) have landed
    float* qs = ring + st * 2 * R * LD;
    float* gs = qs + R * LD;
    split_rows<DP, R, kThreads>(qs, qlo, tid);
    split_rows<DP, R, kThreads>(gs, glo, tid);
    __syncthreads();
    const float* dl = vec + st * R;
    if (!(s.causal && qt + R - 1 < warp_first)) {
      // P^T as accumulator fragments: (key gr | gr+8, query 2tc | 2tc+1)
      float pf[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = qt + j * 8 + 2 * tc + (i & 1);
          const int kj = k0 + m0 + gr + (i >> 1) * 8;
          pf[j][i] = qi < t && kj < t ? pb[(int64_t)qi * t + kj] : 0.f;
          dp[j][i] = 0.f;
        }
      // dP^T = v dctx^T
#pragma unroll
      for (int kk = 0; kk < DP; kk += 8) {
        const OpA a = load_a(vw + kk, LD, gr, tc);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int at = j * 8 * LD + kk;
          mma3(dp[j], a, load_b_t(gs + at, glo + at, LD, gr, tc));
        }
      }
      // dS^T = P^T (dP^T - delta); dv += P^T dctx, dk += dS^T q
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dp[j][i] = pf[j][i] * (dp[j][i] - dl[j * 8 + 2 * tc + (i & 1)]);
        const OpA ap = acc_as_a(pf[j]);
        const OpA ads = acc_as_a(dp[j]);
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          const int at = j * 8 * LD + c0 + n * 8;
          mma3(dv_acc[n], ap, load_b_perm(gs + at, glo + at, LD, gr, tc));
          mma3(dk_acc[n], ads, load_b_perm(qs + at, qlo + at, LD, gr, tc));
        }
      }
    }
    __syncthreads();  // the next iteration refills this stage
    qt = nxt;
  }
  cp_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + m0 + gr + h * 8;
    if (key >= t) continue;
    float* out = dqkv + ((int64_t)b * t + key) * d3 + hh * dh + c0 + 2 * tc;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (c0 + n * 8 >= dh) continue;
      *reinterpret_cast<float2*>(out + d + n * 8) = make_float2(
          dk_acc[n][2 * h] * s.scale, dk_acc[n][2 * h + 1] * s.scale);
      *reinterpret_cast<float2*>(out + 2 * d + n * 8) =
          make_float2(dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
    }
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

// the backward's attention stages at head width DP: dq and delta, then dk
// and dv, into dqkv
template <int DP>
cudaError_t attention_stages(const float* qkv, const float* p,
                             const float* ctx, const float* dctx, float* dqkv,
                             float* delta, const Shape& s, cudaStream_t st) {
  using Q = DqTile<DP>;
  using KV = DkvTile<DP>;
  const unsigned bh = (unsigned)(s.rows / s.t * s.h);
  cudaError_t err = allow_smem(attn_bwd_dq_kernel<DP>, Q::kSmem);
  if (err == cudaSuccess)
    err = allow_smem(attn_bwd_dkv_kernel<DP>, KV::kSmem);
  if (err != cudaSuccess) return err;
  attn_bwd_dq_kernel<DP><<<dim3((s.t + Q::R - 1) / Q::R, bh), Q::kThreads,
                           Q::kSmem, st>>>(qkv, p, ctx, dctx, dqkv, delta, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dkv_kernel<DP><<<dim3((s.t + KV::C - 1) / KV::C, bh),
                            KV::kThreads, KV::kSmem, st>>>(qkv, p, dctx,
                                                            delta, dqkv, s);
  return cudaGetLastError();
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
  RETURN_IF(dh <= 32   ? attention_stages<32>(qkvf, pf, ctxf, dctxf, dqkvf,
                                                delta, s, st)
            : dh <= 64 ? attention_stages<64>(qkvf, pf, ctxf, dctxf, dqkvf,
                                                delta, s, st)
                       : attention_stages<128>(qkvf, pf, ctxf, dctxf, dqkvf,
                                               delta, s, st));
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
