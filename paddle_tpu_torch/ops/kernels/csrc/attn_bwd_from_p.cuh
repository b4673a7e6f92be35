// The attention stages of a backward from saved probabilities, for Hopper
// (sm_90a): dq, dk and dv of one attention per (batch, head) from q, k, v,
// the normalized P that the forward saved, the output's cotangent dO and
// the forward's output O, with no exp. Every product runs on the tensor
// cores in split TF32 (split_tf32.cuh). Two kernels take them:
// attention_block.cu's backward (#11), which reads q, k, v inside the
// rows of its qkv buffer and writes one dqkv buffer, and sdpa_short_bwd.cu
// (#6), which reads and writes contiguous [BH, T, D] tensors. Each gives
// the stages a view of every operand (Rows: a base per (b, h) and a row
// stride).
//
//   dv = P^T dO;  dP = dO v^T;  dS = P (dP - delta);
//   dq = scale dS k;  dk = scale dS^T q
//
// delta is rowsum(dP P), which the TPU kernels take from a T-wide row of
// dP. Here it is the same quantity as rowsum(dO O): O = P v, so
// rowsum(dP P)_i = sum_k P_ik sum_d dO_id v_kd = sum_d dO_id O_id. So
// neither grid holds a T-wide row of dP, and each streams its tiles once:
// 1. dq (and delta): one block per (64-row query tile, bh), 4 warps of 16
//    rows; dO resident, k and v streamed through a two-stage cp.async ring,
//    each tile split once as it lands. A warp forms dP = dO v^T as
//    accumulator fragments, turns it into dS with this tile's P (read from
//    device memory beside the product), and feeds dS straight back as the A
//    operand of dq += dS k (permuted k index, k read in the same order).
// 2. dk and dv: one block per (64-key tile, bh); v resident, 32-row query
//    tiles of q, dO and delta streamed. Warp w owns keys 16 (w / SPLIT) and
//    output columns (w % SPLIT) DP / SPLIT. It forms dP^T = v dO^T and
//    dS^T = P^T (dP^T - delta) as accumulator fragments (keys as rows) and
//    feeds P^T and dS^T back as the A operands of dv += P^T dO and
//    dk += dS^T q.
// Under causal masking the tiles where P is 0 are skipped. Each grid writes
// only its own rows, with no atomics, so two launches give identical bits.
//
// DP is the head width rounded up to 32, 64 or 128; the columns past it
// are zero-filled as they land and never written. Every view's rows start
// on a 16-byte boundary (cp.async copies 16 bytes); P's rows need not.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "split_tf32.cuh"

namespace attn_bwd_from_p {

using namespace split_tf32;

// One operand of head bh: its rows start at base + (bh / heads) * outer +
// (bh % heads) * inner, `ld` floats apart.
template <typename F>
struct Rows {
  F* base;
  int64_t outer, inner;
  int ld;
  __device__ __forceinline__ F* head(int bh, int heads) const {
    return base + (int64_t)(bh / heads) * outer +
           (int64_t)(bh % heads) * inner;
  }
};

struct Args {
  Rows<const float> q, k, v, g, o;  // g: dO; o: the forward's output
  Rows<float> dq, dk, dv;
  const float* p;  // [BH, T, T], the normalized probabilities
  float* delta;    // [BH, T]: rowsum(dO O), written by grid 1
  int heads;       // the split of bh in the views above
  int t, dh;       // sequence length, head width (<= DP)
  float scale;
  int causal;      // query i sees keys <= i
};

// Grid 1: dq, and delta into a.delta, per (64-row query tile, bh).
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
    dq_kernel(const Args a) {
  using T = DqTile<DP>;
  constexpr int R = T::R, C = T::C, LD = DP + kPad, NT = C / 8, ND = DP / 8;
  constexpr int kThreads = T::kThreads;
  static_assert(kThreads == 2 * R, "two threads a row for delta");
  extern __shared__ __align__(16) float smem[];
  float* gs = smem;                // dO [R][LD]
  float* ring = gs + R * LD;       // stage st: k [C][LD], then v [C][LD]
  float* klo = ring + 4 * C * LD;  // small halves: k [C][LD], v [C][LD]
  float* vlo = klo + C * LD;
  float* dl_s = vlo + C * LD;      // delta [R]

  const int dh = a.dh, t = a.t;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * R;
  const int tid = threadIdx.x;
  const int lane = tid % 32, gr = lane / 4, tc = lane % 4;
  const int m0 = tid / 32 * 16;  // this warp's rows within the block
  const float* kb = a.k.head(bh, a.heads);
  const float* vb = a.v.head(bh, a.heads);
  const float* gb = a.g.head(bh, a.heads);
  const float* ob = a.o.head(bh, a.heads);
  const float* __restrict__ pb = a.p + (int64_t)bh * t * t;

  load_tile<DP, R, kThreads>(gs, gb, a.g.ld, q0, t, dh, tid);
  // P is 0 past the block's last row under causal masking, and a warp
  // skips the tiles past its own last row
  const int kend = a.causal ? min(t, q0 + R) : t;
  const int ntiles = (kend + C - 1) / C;
  const int warp_last = q0 + m0 + 15;
  load_tile<DP, C, kThreads>(ring, kb, a.k.ld, 0, t, dh, tid);
  load_tile<DP, C, kThreads>(ring + C * LD, vb, a.v.ld, 0, t, dh, tid);
  cp_commit();

  // delta = rowsum(dO O): two threads a row, every other 4-column chunk
  // each
  {
    const int r = tid / 2, row = q0 + r;
    float sum = 0.f;
    if (row < t) {
      const float* gr_ = gb + (int64_t)row * a.g.ld;
      const float* or_ = ob + (int64_t)row * a.o.ld;
      for (int c = tid % 2 * 4; c < dh; c += 8) {
        const float4 x = *reinterpret_cast<const float4*>(gr_ + c);
        const float4 y = *reinterpret_cast<const float4*>(or_ + c);
        sum = fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, fmaf(x.w, y.w,
                                                                sum))));
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (tid % 2 == 0) {
      dl_s[r] = sum;
      if (row < t) a.delta[(int64_t)bh * t + row] = sum;
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
      load_tile<DP, C, kThreads>(nk, kb, a.k.ld, (kt + 1) * C, t, dh, tid);
      load_tile<DP, C, kThreads>(nk + C * LD, vb, a.v.ld, (kt + 1) * C, t,
                                 dh, tid);
    }
    cp_commit();
    cp_wait<1>();  // this tile (and dO) have landed
    split_rows<DP, C, kThreads>(ks, klo, tid);
    split_rows<DP, C, kThreads>(vs, vlo, tid);
    __syncthreads();
    if (!(a.causal && kt * C > warp_last)) {
      // this tile's P as accumulator fragments: (row gr | gr+8, key 2tc |
      // 2tc+1), read before the product so the loads overlap it
      float pf[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = q0 + m0 + gr + (i >> 1) * 8;
          const int key = kt * C + j * 8 + 2 * tc + (i & 1);
          pf[j][i] =
              row < t && key < t ? pb[(int64_t)row * t + key] : 0.f;
          dp[j][i] = 0.f;
        }
      // dP = dO v^T
#pragma unroll
      for (int kk = 0; kk < DP; kk += 8) {
        const OpA af = load_a(gw + kk, LD, gr, tc);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int at = j * 8 * LD + kk;
          mma3(dp[j], af, load_b_t(vs + at, vlo + at, LD, gr, tc));
        }
      }
      // dS = P (dP - delta), then dq += dS k
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dp[j][i] = pf[j][i] * (dp[j][i] - dl_s[m0 + gr + (i >> 1) * 8]);
        const OpA af = acc_as_a(dp[j]);
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          const int at = j * 8 * LD + n * 8;
          mma3(acc[n], af, load_b_perm(ks + at, klo + at, LD, gr, tc));
        }
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }
  cp_wait<0>();

  float* dqb = a.dq.head(bh, a.heads);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + m0 + gr + h * 8;
    if (row >= t) continue;
    float* out = dqb + (int64_t)row * a.dq.ld + 2 * tc;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      if (n * 8 < dh)
        *reinterpret_cast<float2*>(out + n * 8) = make_float2(
            acc[n][2 * h] * a.scale, acc[n][2 * h + 1] * a.scale);
  }
}

// Grid 2: dk and dv per (64-key tile, bh).
template <int DP>
struct DkvTile {
  static constexpr int C = 64;  // keys a block
  static constexpr int R = 32;  // queries a streamed tile
  // at DP 128 two warps share 16 keys: a thread's registers do not hold
  // both [16, 128] accumulators
  static constexpr int SPLIT = DP == 128 ? 2 : 1;
  static constexpr int kThreads = 32 * (C / 16) * SPLIT;
  // below DP 128, three blocks an SM (70 KB of shared memory each), the
  // registers capped to fit (dkv_kernel); at DP 128 one block an SM fits
  // its shared memory, and capping the registers there spills
  // (dkv_kernel_wide)
  static constexpr int kMinBlocks = 3;
  static constexpr size_t kSmem =
      sizeof(float) * (C * (DP + kPad) + 6 * R * (DP + kPad) + 2 * R);
};

template <int DP>
__device__ __forceinline__ void dkv_tile(const Args& a) {
  using T = DkvTile<DP>;
  constexpr int R = T::R, C = T::C, LD = DP + kPad, NT = R / 8;
  constexpr int NO = DP / T::SPLIT / 8;  // output column tiles a warp
  constexpr int kThreads = T::kThreads;
  extern __shared__ __align__(16) float smem[];
  float* vs = smem;                // [C][LD]
  float* ring = vs + C * LD;       // stage st: q [R][LD], then dO [R][LD]
  float* qlo = ring + 4 * R * LD;  // small halves: q [R][LD], dO [R][LD]
  float* glo = qlo + R * LD;
  float* vec = glo + R * LD;       // stage st: delta [R]

  const int dh = a.dh, t = a.t;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * C;
  const int tid = threadIdx.x;
  const int lane = tid % 32, gr = lane / 4, tc = lane % 4;
  const int warp = tid / 32;
  const int m0 = warp / T::SPLIT * 16;      // this warp's keys in the block
  const int c0 = warp % T::SPLIT * NO * 8;  // and its output columns
  const float* qb = a.q.head(bh, a.heads);
  const float* gb = a.g.head(bh, a.heads);
  const float* db = a.delta + (int64_t)bh * t;
  const float* __restrict__ pb = a.p + (int64_t)bh * t * t;

  auto fetch = [&](int qt, int st) {
    float* qs_ = ring + st * 2 * R * LD;
    load_tile<DP, R, kThreads>(qs_, qb, a.q.ld, qt, t, dh, tid);
    load_tile<DP, R, kThreads>(qs_ + R * LD, gb, a.g.ld, qt, t, dh, tid);
    load_vec<R, kThreads>(vec + st * R, db, qt, t, tid);
  };

  load_tile<DP, C, kThreads>(vs, a.v.head(bh, a.heads), a.v.ld, k0, t, dh,
                             tid);
  // under causal masking, query rows before k0 have P = 0 on these keys,
  // and a warp skips the tiles before its own first key
  int qt = a.causal ? k0 / R * R : 0;
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
    if (!(a.causal && qt + R - 1 < warp_first)) {
      // P^T as accumulator fragments: (key gr | gr+8, query 2tc | 2tc+1)
      float pf[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = qt + j * 8 + 2 * tc + (i & 1);
          const int kj = k0 + m0 + gr + (i >> 1) * 8;
          pf[j][i] =
              qi < t && kj < t ? pb[(int64_t)qi * t + kj] : 0.f;
          dp[j][i] = 0.f;
        }
      // dP^T = v dO^T
#pragma unroll
      for (int kk = 0; kk < DP; kk += 8) {
        const OpA af = load_a(vw + kk, LD, gr, tc);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int at = j * 8 * LD + kk;
          mma3(dp[j], af, load_b_t(gs + at, glo + at, LD, gr, tc));
        }
      }
      // dS^T = P^T (dP^T - delta); dv += P^T dO, dk += dS^T q
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

  float* dkb = a.dk.head(bh, a.heads);
  float* dvb = a.dv.head(bh, a.heads);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + m0 + gr + h * 8;
    if (key >= t) continue;
    float* dko = dkb + (int64_t)key * a.dk.ld + c0 + 2 * tc;
    float* dvo = dvb + (int64_t)key * a.dv.ld + c0 + 2 * tc;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (c0 + n * 8 >= dh) continue;
      *reinterpret_cast<float2*>(dko + n * 8) = make_float2(
          dk_acc[n][2 * h] * a.scale, dk_acc[n][2 * h + 1] * a.scale);
      *reinterpret_cast<float2*>(dvo + n * 8) =
          make_float2(dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(DkvTile<DP>::kThreads,
                                  DkvTile<DP>::kMinBlocks)
    dkv_kernel(const Args a) {
  dkv_tile<DP>(a);
}

template <int DP>
__global__ void __launch_bounds__(DkvTile<DP>::kThreads)
    dkv_kernel_wide(const Args a) {
  dkv_tile<DP>(a);
}

template <int DP>
constexpr auto dkv_entry() {
  if constexpr (DP == 128)
    return &dkv_kernel_wide<DP>;
  else
    return &dkv_kernel<DP>;
}

// The two grids at head width DP over `bh` heads on stream st: dq and
// delta, then dk and dv.
template <int DP>
cudaError_t run(const Args& a, unsigned bh, cudaStream_t st) {
  using Q = DqTile<DP>;
  using KV = DkvTile<DP>;
  auto* dkv = dkv_entry<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Q::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)KV::kSmem);
  if (err != cudaSuccess) return err;
  dq_kernel<DP><<<dim3((a.t + Q::R - 1) / Q::R, bh), Q::kThreads, Q::kSmem,
                  st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv<<<dim3((a.t + KV::C - 1) / KV::C, bh), KV::kThreads, KV::kSmem, st>>>(
      a);
  return cudaGetLastError();
}

}  // namespace attn_bwd_from_p
