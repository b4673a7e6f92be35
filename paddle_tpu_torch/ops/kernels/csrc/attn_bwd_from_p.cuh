// The attention stages of a backward from saved probabilities, for Hopper
// (sm_90a): dq, dk and dv of one attention per (batch, head) from q, k, v,
// the normalized P that the forward saved, the output's cotangent dO and
// the forward's output O, with no exp. Every product runs on the tensor
// cores, in split TF32 (split_tf32.cuh) in fp32 or on bf16 planes
// (split_bf16.cuh; E is the element type of q, k, v, dO, P and the grads,
// and Mma<E> its operand traits). Two kernels take them:
// attention_block.cu's backward (#11, fp32 and planes), which reads q, k,
// v inside the rows of its qkv buffer and writes one dqkv buffer, and
// sdpa_short_bwd.cu (#6 in fp32; its bf16 instance runs attn_wgmma.cuh),
// which reads and writes contiguous [BH, T, D] tensors. Each gives
// the stages a view of every operand (Rows: a base per (b, h), a row
// stride and, for planes, the distance from the hi plane to the lo one).
//
//   dv = P^T dO;  dP = dO v^T;  dS = P (dP - delta);
//   dq = scale dS k;  dk = scale dS^T q
//
// delta is rowsum(dP P), which the TPU kernels take from a T-wide row of
// dP. Neither grid here holds a T-wide row of dP:
// 1. dq (and delta): one block per (64-row query tile, bh), 4 warps of 16
//    rows; dO resident, k and v streamed through a two-stage cp.async ring,
//    each tile split once as it lands. delta comes first, by one of two
//    ways. A caller that has the forward's output O (attention_block.cu)
//    gives it, and delta is rowsum(dO O), the same quantity: O = P v, so
//    rowsum(dP P)_i = sum_k P_ik sum_d dO_id v_kd = sum_d dO_id O_id. A
//    caller with no O (sdpa_short_bwd.cu, a.o.base null) gets a first
//    sweep over the key tiles that forms dP = dO v^T and sums dP P into
//    each row, as the TPU kernel takes it. Then a warp forms dP = dO v^T
//    as accumulator fragments, turns it into dS with this tile's P (read
//    from device memory beside the product), and feeds dS straight back as
//    the A operand of dq += dS k (permuted k index, k read in the same
//    order).
// 2. dk and dv: one block per (64-key tile, bh); v resident, 32-row query
//    tiles of q, dO and delta streamed. Warp w owns keys 16 (w / SPLIT) and
//    output columns (w % SPLIT) DP / SPLIT. It forms dP^T = v dO^T and
//    dS^T = P^T (dP^T - delta) as accumulator fragments (keys as rows) and
//    feeds P^T and dS^T back as the A operands of dv += P^T dO and
//    dk += dS^T q.
// Under causal masking the tiles where P is 0 are skipped. Each grid writes
// only its own rows, with no atomics, so two launches give identical bits.
//
// On planes (only attention_block.cu's bf16 backward, #11: E =
// split_bf16::planes) q, k, v, dO and the grads are fp32 intermediates
// kept as two bf16 planes, each product runs hi hi, hi lo and lo hi, and
// the saved fp32 P and dS enter split into their planes. Grid 1 then also
// recomputes the forward's output: its first sweep over the key tiles
// forms O = P v for its rows, writes it as planes to the view `o` (the
// operand of the caller's dWo = O^T dO) and takes delta = rowsum(dO O) on
// the planes' values, in a fixed order.
//
// DP is the head width rounded up to 32, 64 or 128; the columns past it
// are zero-filled as they land and never written. Every view's rows (and
// planes) start on a 16-byte boundary (cp.async copies 16 bytes); P's rows
// need not.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "split_bf16.cuh"
#include "split_tf32.cuh"

namespace attn_bwd_from_p {

using attn_mma::Mma;
using split_tf32::cp_commit;
using split_tf32::cp_wait;
using split_tf32::load_tile;
using split_tf32::load_vec;

// One operand of head bh: its rows start at base + (bh / heads) * outer +
// (bh % heads) * inner, `ld` elements apart; on planes the lo plane lies
// `plane` elements after the hi one.
template <typename F>
struct Rows {
  F* base;
  int64_t outer, inner;
  int ld;
  int64_t plane = 0;
  __device__ __forceinline__ F* head(int bh, int heads) const {
    return base + (int64_t)(bh / heads) * outer +
           (int64_t)(bh % heads) * inner;
  }
};

template <typename E = float>
struct Args {
  Rows<const E> q, k, v, g;  // g: dO
  Rows<E> o;  // the forward's output: fp32, read for delta (base null:
              // delta from rowsum(dP P)); planes, written by grid 1
  Rows<E> dq, dk, dv;
  const typename Mma<E>::PType* p;  // [BH, T, T], the normalized
                                    // probabilities
  float* delta;    // [BH, T]: rowsum(dP P), written by grid 1
  int heads;       // the split of bh in the views above
  int t, dh;       // sequence length, head width (<= DP)
  float scale;
  int causal;      // query i sees keys <= i
};

// rows [r0, r0 + N) of a head's operand at g (row stride ld) into the
// staged tile s: its values, or on planes the hi plane in columns [0, DP)
// and the lo plane (`plane` elements on) in [DP, 2 DP)
template <typename E, int DP, int N, int THREADS, int LD>
__device__ __forceinline__ void stage(E* s, const E* g, int ld,
                                      int64_t plane, int r0, int limit,
                                      int width, int tid) {
  load_tile<DP, N, THREADS, LD>(s, g, ld, r0, limit, width, tid);
  if constexpr (Mma<E>::kPlanes == 2)
    load_tile<DP, N, THREADS, LD>(s + DP, g + plane, ld, r0, limit, width,
                                  tid);
}

// two neighbouring results (x, y) of a view with planes `plane` apart
template <typename E>
__device__ __forceinline__ void put2(E* p, int64_t plane, float x, float y) {
  if constexpr (Mma<E>::kPlanes == 2)
    Mma<E>::store2(p, plane, x, y);
  else
    Mma<E>::store2(p, x, y);
}

// Grid 1: dq, and delta into a.delta, per (64-row query tile, bh).
template <typename E, int DP>
struct DqTile {
  static constexpr int R = 64;                   // query rows a block
  static constexpr int C = DP == 128 ? 16 : 32;  // keys a streamed tile
  static constexpr int kThreads = 32 * R / 16;
  static constexpr int LD = Mma<E>::kPlanes * DP + Mma<E>::kPad;
  static constexpr size_t kSmem =
      sizeof(E) * (R * LD + (4 + 2 * Mma<E>::kLo) * C * LD) +
      sizeof(float) * R;
};

template <typename E, int DP>
__global__ void __launch_bounds__(DqTile<E, DP>::kThreads)
    dq_kernel(const Args<E> a) {
  using T = DqTile<E, DP>;
  using M = Mma<E>;
  constexpr int R = T::R, C = T::C, LD = T::LD, NT = C / 8, ND = DP / 8;
  constexpr int KS = M::kK, KJ = KS / 8;
  constexpr int kThreads = T::kThreads;
  static_assert(kThreads == 2 * R, "two threads a row for delta");
  static_assert(NT % KJ == 0, "whole steps over a key tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* gs = reinterpret_cast<E*>(smem_raw);  // dO [R][LD]
  E* ring = gs + R * LD;           // stage st: k [C][LD], then v [C][LD]
  E* klo = ring + 4 * C * LD;      // fp32: small halves, k and v [C][LD]
  E* vlo = klo + M::kLo * C * LD;
  float* dl_s = reinterpret_cast<float*>(vlo + M::kLo * C * LD);  // [R]

  const int dh = a.dh, t = a.t;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * R;
  const int tid = threadIdx.x;
  const int lane = tid % 32, gr = lane / 4, tc = lane % 4;
  const int m0 = tid / 32 * 16;  // this warp's rows within the block
  const E* kb = a.k.head(bh, a.heads);
  const E* vb = a.v.head(bh, a.heads);
  const E* gb = a.g.head(bh, a.heads);
  const typename M::PType* __restrict__ pb = a.p + (int64_t)bh * t * t;
  auto load_k = [&](E* s, int r0) {
    stage<E, DP, C, kThreads, LD>(s, kb, a.k.ld, a.k.plane, r0, t, dh, tid);
  };
  auto load_v = [&](E* s, int r0) {
    stage<E, DP, C, kThreads, LD>(s, vb, a.v.ld, a.v.plane, r0, t, dh, tid);
  };

  stage<E, DP, R, kThreads, LD>(gs, gb, a.g.ld, a.g.plane, q0, t, dh, tid);
  // P is 0 past the block's last row under causal masking, and a warp
  // skips the tiles past its own last row
  const int kend = a.causal ? min(t, q0 + R) : t;
  const int ntiles = (kend + C - 1) / C;
  const int warp_last = q0 + m0 + 15;
  const E* gw = gs + m0 * LD;

  // this tile's P as accumulator fragments: (row gr | gr+8, key 2tc |
  // 2tc+1)
  auto p_frags = [&](float (&pf)[NT][4], int kt) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + m0 + gr + (i >> 1) * 8;
        const int key = kt * C + j * 8 + 2 * tc + (i & 1);
        pf[j][i] =
            row < t && key < t ? M::load(pb + (int64_t)row * t + key) : 0.f;
      }
  };
  // dP = dO v^T on the tile staged at vs
  auto dp_frags = [&](float (&dp)[NT][4], const E* vs, const E* vl) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) dp[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += KS) {
      const typename M::A af = M::load_a(gw + kk, LD, gr, tc);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int at = j * 8 * LD + kk;
        M::mma(dp[j], af, M::load_b_t(vs + at, vl + at, LD, gr, tc));
      }
    }
  };

  constexpr bool kPl = M::kPlanes == 2;
  if (!std::is_same<E, float>::value || a.o.base == nullptr) {
    // delta = rowsum(dP P), or on planes O = P v and delta = rowsum(dO O):
    // v alone through the ring's v slots
    float rs[2] = {0.f, 0.f};
    float ox[kPl ? ND : 1][4];  // planes: O, this warp's rows
#pragma unroll
    for (int n = 0; n < (kPl ? ND : 1); ++n)
      ox[n][0] = ox[n][1] = ox[n][2] = ox[n][3] = 0.f;
    load_v(ring + C * LD, 0);
    cp_commit();
    for (int kt = 0; kt < ntiles; ++kt) {
      E* vs = ring + (kt & 1) * 2 * C * LD + C * LD;
      if (kt + 1 < ntiles)
        load_v(ring + ((kt + 1) & 1) * 2 * C * LD + C * LD, (kt + 1) * C);
      cp_commit();
      cp_wait<1>();  // this tile (and dO) have landed
      M::template split_rows<DP, C, kThreads, LD>(vs, vlo, tid);
      __syncthreads();
      if (!(a.causal && kt * C > warp_last)) {
        float pf[NT][4];
        p_frags(pf, kt);
        if constexpr (kPl) {
          // O += P v, P split into its planes, KJ key tiles a step
#pragma unroll
          for (int j = 0; j < NT; j += KJ) {
            const typename M::AccA ap = M::acc_as_a(pf + j);
#pragma unroll
            for (int n = 0; n < ND; ++n) {
              const int at = j * 8 * LD + n * 8;
              M::mma(ox[n], ap, M::load_b_acc(vs + at, vlo + at, LD, gr, tc));
            }
          }
        } else {
          float dp[NT][4];
          dp_frags(dp, vs, vlo);
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) rs[i >> 1] += dp[j][i] * pf[j][i];
        }
      }
      __syncthreads();  // the next iteration refills this stage
    }
    cp_wait<0>();
    if constexpr (kPl) {
      // O's planes into a.o, and rowsum(dO O) on the planes' values,
      // each thread over its columns in order
      using split_bf16::bf16;
      E* ob = a.o.head(bh, a.heads);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + gr + h * 8, row = q0 + r;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          const int c = n * 8 + 2 * tc;
          uint32_t hi, lo;
          split_bf16::split(hi, lo, ox[n][2 * h], ox[n][2 * h + 1]);
          if (row < t && c < dh) {
            E* at = ob + (int64_t)row * a.o.ld + c;
            *reinterpret_cast<uint32_t*>(at) = hi;
            *reinterpret_cast<uint32_t*>(at + a.o.plane) = lo;
          }
          const bf16* gh = reinterpret_cast<const bf16*>(gs + r * LD + c);
          const float2 oh = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&hi));
          const float2 ol = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&lo));
          rs[h] += (__bfloat162float(gh[0]) + __bfloat162float(gh[DP])) *
                       (oh.x + ol.x) +
                   (__bfloat162float(gh[1]) + __bfloat162float(gh[DP + 1])) *
                       (oh.y + ol.y);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
      const int row = q0 + m0 + gr + h * 8;
      if (tc == 0) {
        dl_s[m0 + gr + h * 8] = rs[h];
        if (row < t) a.delta[(int64_t)bh * t + row] = rs[h];
      }
    }
    __syncthreads();  // the ring is free again
    load_k(ring, 0);
    load_v(ring + C * LD, 0);
    cp_commit();
  } else {
    load_k(ring, 0);
    load_v(ring + C * LD, 0);
    cp_commit();
    // delta = rowsum(dO O) (fp32 only): two threads a row, every other
    // 4-column chunk each
    const E* ob = a.o.head(bh, a.heads);
    const int r = tid / 2, row = q0 + r;
    float sum = 0.f;
    if (row < t) {
      const E* gr_ = gb + (int64_t)row * a.g.ld;
      const E* or_ = ob + (int64_t)row * a.o.ld;
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

  for (int kt = 0; kt < ntiles; ++kt) {
    E* ks = ring + (kt & 1) * 2 * C * LD;
    E* vs = ks + C * LD;
    if (kt + 1 < ntiles) {
      E* nk = ring + ((kt + 1) & 1) * 2 * C * LD;
      load_k(nk, (kt + 1) * C);
      load_v(nk + C * LD, (kt + 1) * C);
    }
    cp_commit();
    cp_wait<1>();  // this tile (and dO) have landed
    M::template split_rows<DP, C, kThreads, LD>(ks, klo, tid);
    M::template split_rows<DP, C, kThreads, LD>(vs, vlo, tid);
    __syncthreads();
    if (!(a.causal && kt * C > warp_last)) {
      // P read before the product so the loads overlap it
      float pf[NT][4], dp[NT][4];
      p_frags(pf, kt);
      dp_frags(dp, vs, vlo);
      // dS = P (dP - delta), then dq += dS k, KJ key tiles a step
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dp[j][i] = pf[j][i] * (dp[j][i] - dl_s[m0 + gr + (i >> 1) * 8]);
#pragma unroll
      for (int j = 0; j < NT; j += KJ) {
        const typename M::AccA af = M::acc_as_a(dp + j);
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          const int at = j * 8 * LD + n * 8;
          M::mma(acc[n], af, M::load_b_acc(ks + at, klo + at, LD, gr, tc));
        }
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }
  cp_wait<0>();

  E* dqb = a.dq.head(bh, a.heads);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + m0 + gr + h * 8;
    if (row >= t) continue;
    E* out = dqb + (int64_t)row * a.dq.ld + 2 * tc;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      if (n * 8 < dh)
        put2(out + n * 8, a.dq.plane, acc[n][2 * h] * a.scale,
             acc[n][2 * h + 1] * a.scale);
  }
}

// Grid 2: dk and dv per (64-key tile, bh).
template <typename E, int DP>
struct DkvTile {
  static constexpr int C = 64;  // keys a block
  static constexpr int R = 32;  // queries a streamed tile
  // at DP 128 two warps share 16 keys: a thread's registers do not hold
  // both [16, 128] accumulators
  static constexpr int SPLIT = DP == 128 ? 2 : 1;
  static constexpr int kThreads = 32 * (C / 16) * SPLIT;
  // below DP 128, three blocks an SM (70 KB of shared memory each in
  // fp32), the registers capped to fit (dkv_kernel); at DP 128 one block
  // an SM fits its shared memory, and capping the registers there spills
  // (dkv_kernel_wide)
  static constexpr int kMinBlocks = 3;
  static constexpr int LD = Mma<E>::kPlanes * DP + Mma<E>::kPad;
  static constexpr size_t kSmem =
      sizeof(E) * (C * LD + (4 + 2 * Mma<E>::kLo) * R * LD) +
      sizeof(float) * 2 * R;
};

template <typename E, int DP>
__device__ __forceinline__ void dkv_tile(const Args<E>& a) {
  using T = DkvTile<E, DP>;
  using M = Mma<E>;
  constexpr int R = T::R, C = T::C, LD = T::LD, NT = R / 8;
  constexpr int KJ = M::kK / 8;
  constexpr int NO = DP / T::SPLIT / 8;  // output column tiles a warp
  constexpr int kThreads = T::kThreads;
  static_assert(NT % KJ == 0, "whole steps over a query tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* vs = reinterpret_cast<E*>(smem_raw);  // [C][LD]
  E* ring = vs + C * LD;           // stage st: q [R][LD], then dO [R][LD]
  E* qlo = ring + 4 * R * LD;      // fp32: small halves, q and dO [R][LD]
  E* glo = qlo + M::kLo * R * LD;
  float* vec = reinterpret_cast<float*>(glo + M::kLo * R * LD);
  // stage st: delta [R]

  const int dh = a.dh, t = a.t;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * C;
  const int tid = threadIdx.x;
  const int lane = tid % 32, gr = lane / 4, tc = lane % 4;
  const int warp = tid / 32;
  const int m0 = warp / T::SPLIT * 16;      // this warp's keys in the block
  const int c0 = warp % T::SPLIT * NO * 8;  // and its output columns
  const E* qb = a.q.head(bh, a.heads);
  const E* gb = a.g.head(bh, a.heads);
  const float* db = a.delta + (int64_t)bh * t;
  const typename M::PType* __restrict__ pb = a.p + (int64_t)bh * t * t;

  auto fetch = [&](int qt, int st) {
    E* qs_ = ring + st * 2 * R * LD;
    stage<E, DP, R, kThreads, LD>(qs_, qb, a.q.ld, a.q.plane, qt, t, dh,
                                  tid);
    stage<E, DP, R, kThreads, LD>(qs_ + R * LD, gb, a.g.ld, a.g.plane, qt,
                                  t, dh, tid);
    load_vec<R, kThreads>(vec + st * R, db, qt, t, tid);
  };

  stage<E, DP, C, kThreads, LD>(vs, a.v.head(bh, a.heads), a.v.ld,
                                a.v.plane, k0, t, dh, tid);
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
  const E* vw = vs + m0 * LD;

  for (int st = 0; qt < t; st ^= 1) {
    const int nxt = qt + R;
    if (nxt < t) fetch(nxt, st ^ 1);
    cp_commit();
    cp_wait<1>();  // this tile (and v) have landed
    E* qs = ring + st * 2 * R * LD;
    E* gs = qs + R * LD;
    M::template split_rows<DP, R, kThreads, LD>(qs, qlo, tid);
    M::template split_rows<DP, R, kThreads, LD>(gs, glo, tid);
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
              qi < t && kj < t ? M::load(pb + (int64_t)qi * t + kj) : 0.f;
          dp[j][i] = 0.f;
        }
      // dP^T = v dO^T
#pragma unroll
      for (int kk = 0; kk < DP; kk += M::kK) {
        const typename M::A af = M::load_a(vw + kk, LD, gr, tc);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int at = j * 8 * LD + kk;
          M::mma(dp[j], af, M::load_b_t(gs + at, glo + at, LD, gr, tc));
        }
      }
      // dS^T = P^T (dP^T - delta); dv += P^T dO, dk += dS^T q
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dp[j][i] = pf[j][i] * (dp[j][i] - dl[j * 8 + 2 * tc + (i & 1)]);
#pragma unroll
      for (int j = 0; j < NT; j += KJ) {
        const typename M::A ap = M::exact_as_a(pf + j);
        const typename M::AccA ads = M::acc_as_a(dp + j);
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          const int at = j * 8 * LD + c0 + n * 8;
          M::mma(dv_acc[n], ap, M::load_b_acc(gs + at, glo + at, LD, gr, tc));
          M::mma(dk_acc[n], ads,
                 M::load_b_acc(qs + at, qlo + at, LD, gr, tc));
        }
      }
    }
    __syncthreads();  // the next iteration refills this stage
    qt = nxt;
  }
  cp_wait<0>();

  E* dkb = a.dk.head(bh, a.heads);
  E* dvb = a.dv.head(bh, a.heads);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + m0 + gr + h * 8;
    if (key >= t) continue;
    E* dko = dkb + (int64_t)key * a.dk.ld + c0 + 2 * tc;
    E* dvo = dvb + (int64_t)key * a.dv.ld + c0 + 2 * tc;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (c0 + n * 8 >= dh) continue;
      put2(dko + n * 8, a.dk.plane, dk_acc[n][2 * h] * a.scale,
           dk_acc[n][2 * h + 1] * a.scale);
      put2(dvo + n * 8, a.dv.plane, dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
    }
  }
}

template <typename E, int DP>
__global__ void __launch_bounds__(DkvTile<E, DP>::kThreads,
                                  DkvTile<E, DP>::kMinBlocks)
    dkv_kernel(const Args<E> a) {
  dkv_tile<E, DP>(a);
}

template <typename E, int DP>
__global__ void __launch_bounds__(DkvTile<E, DP>::kThreads)
    dkv_kernel_wide(const Args<E> a) {
  dkv_tile<E, DP>(a);
}

template <typename E, int DP>
constexpr auto dkv_entry() {
  if constexpr (DP == 128)
    return &dkv_kernel_wide<E, DP>;
  else
    return &dkv_kernel<E, DP>;
}

// The two grids at head width DP over `bh` heads on stream st: dq and
// delta, then dk and dv.
template <int DP, typename E>
cudaError_t run(const Args<E>& a, unsigned bh, cudaStream_t st) {
  using Q = DqTile<E, DP>;
  using KV = DkvTile<E, DP>;
  auto* dq = dq_kernel<E, DP>;
  auto* dkv = dkv_entry<E, DP>();
  cudaError_t err = cudaFuncSetAttribute(
      dq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Q::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)KV::kSmem);
  if (err != cudaSuccess) return err;
  dq<<<dim3((a.t + Q::R - 1) / Q::R, bh), Q::kThreads, Q::kSmem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv<<<dim3((a.t + KV::C - 1) / KV::C, bh), KV::kThreads, KV::kSmem, st>>>(
      a);
  return cudaGetLastError();
}

}  // namespace attn_bwd_from_p
