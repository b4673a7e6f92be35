// Flash-attention backward for Hopper (sm_90a), fp32 or bf16 in and out:
// two kernels, the FlashAttention-2 recipe, with every product on the
// tensor cores, in split TF32 for fp32 inputs and in bf16 for bf16 inputs
// (split_bf16.cuh: q k^T and dO v^T one bf16 MMA a step, P and ds, fp32
// intermediates, split into two bf16 parts for P^T dO, ds k and ds^T q;
// lse and delta fp32; the grads rounded to bf16 once, at the end).
//
// Replaces: paddle_tpu/ops/pallas/attention.py `_flash_bwd_impl`, its
// `_bwd_dq_kernel` (dq, a grid over query tiles) and `_bwd_dkv_kernel`
// (dk and dv, a grid over key tiles), the backward of `flash_attention`
// (routed from ops/nn_ops.py `attention` for T > 512, d in {64, 128, 256}).
//
// Inputs: q, dO [BH, tq, D]; k, v [BH, tk, D]; the forward's per-row
// logsumexp lse [BH, tq] (flash_attention.cu); delta = rowsum(dO * O)
// [BH, tq], which the caller computes, as the JAX package does outside its
// kernels. Both kernels recompute P = exp(scale q k^T - lse) tile by tile
// and take ds = P * (dO v^T - delta); then dq = scale ds k,
// dk = scale ds^T q, dv = P^T dO.
//
// The gradient is that of the port's forward (`reference_attention`), in
// which a masked score is filled with -FLT_MAX:
// - a masked entry passes no gradient to its score: ds = 0;
// - under causal masking with tq > tk, query rows i < tq - tk see no key.
//   The forward gives them the uniform average of v, so their P is 1/tk
//   on every key (dv gets dO / tk), and their dq and their share of dk
//   are 0. Their lse (-FLT_MAX) cannot give that: exp(s - lse) would read
//   1, not 1/tk, so such rows are found by index, not through lse.
//
// What bounds them on an H100: operations. At the training shape
// [16, 8, 1024, 64] the dq kernel does three products (S = q k^T,
// dP = dO v^T, ds k) and the dk/dv kernel four (S, dP, P^T dO, ds^T q),
// 2*BH*tq*tk*D flops each: 52 and 69 GFLOP on 168 and 201 MB. On the fp32
// units (67 TFLOP/s) that is at least 0.78 and 1.04 ms; on the tensor
// cores, three TF32 products for each fp32 one (below), 0.31 and 0.42 ms
// at 495 TFLOP/s. mma.sync does not reach that rate (wgmma does), and what
// holds these kernels back now is the instructions issued around each
// product: shared-memory reads of the operands, their splitting and the
// fp32 adds.
//
// What the design does about it:
// - Split TF32 (split_tf32.cuh): three mma.sync.m16n8k8 TF32 products
//   for each fp32 product, each 8-deep step summed in a fresh fragment and
//   added to the running sum in fp32. Chaining the steps through the
//   tensor cores' truncating accumulator, even only the 8 steps of S and
//   dP at D = 64, moves the grads by several times the fp32 error, and
//   chaining every product fails the 1e-5 gate.
// - Register-resident softmax derivative. S and dP come out as mma
//   accumulator fragments; P and ds are computed on them in fp32 registers
//   and fed straight back as the A operand of the next product (ds k for
//   dq; P^T dO and ds^T q for dk/dv, whose fragments hold keys as rows
//   because the kernel computes S^T = k q^T). An accumulator fragment
//   holds columns 2t and 2t+1 of a row where an A fragment wants t and
//   t+4, so the product's k index is permuted (slot t <- column 2t, slot
//   t+4 <- column 2t+1) and the B operand is read from shared memory in the
//   same order: no shuffle, and P and ds never touch shared memory. The
//   masks are applied without branches.
// - Staging. The tile a block owns (q and dO for dq; k and v for dk/dv)
//   stays in shared memory and is split where it is read. The streamed
//   tiles (k and v; q, dO, lse and delta) come through a two-stage ring
//   filled by cp.async with 16-byte copies (4-byte ones for lse and delta,
//   whose rows need not be 16-byte aligned), so the next tile loads while
//   this one is multiplied. Each streamed tile is split once as it lands,
//   by the threads that copied it: the big halves in place, the small
//   halves into a second buffer, so that every warp reads split B
//   operands. Rows are padded to D + 4 floats, which makes every fragment
//   read, the transposed ones included, hit 32 distinct banks. Ragged rows
//   are zero-filled by the copy.
// - Each warp owns 16 rows (queries for dq, keys for dk/dv). At D >= 128
//   the dk/dv kernel lets two warps share 16 keys, each owning half of
//   the output columns and both computing the same S and dP: the two
//   [16, D] accumulators of dk and dv do not fit one thread's registers.
//   At D = 64 the tiles are small enough (16 streamed keys or queries)
//   for three blocks of 4 warps an SM, which hides more of the products'
//   latency than larger tiles at two blocks.
// - Causal tiles that no row of the block can see are skipped, and the
//   ring fetches only the tiles that are used.
// - Deterministic: every block writes only its own rows, with no atomics,
//   and sums in a fixed order, so two launches give identical bits.
//
// In bf16 the 52 and 69 GFLOP take 0.053 and 0.070 ms at 989 TFLOP/s, on
// 84 and 101 MB (0.025 and 0.030 ms): the products still bound them. The
// dq kernel at D 256 streams 16 keys a tile in bf16 (8 in fp32): a bf16
// step is 16 keys deep.
//
// Which design runs which instance: fp32 at every d on the mma.sync
// kernels below; bf16 dq and dk/dv at d 64 and 128 on attn_wgmma.cuh's
// Hopper design (`flash_dq_kernel` and `flash_dkv_kernel`: wgmma fed by
// TMA, P recomputed from the lse on the fragments, dS (and P^T for dv) as
// hi/lo planes), at d 256 on the mma.sync kernels below, a dispatch by d:
// there a wgmma consumer would hold a 64 x 128 slice of the dq
// accumulator and its chain (64 registers each) beside its share of S and
// dP, and the dk/dv kernel two accumulators beside S^T and dP^T, past the
// 168 registers a thread of a 288-thread block gets.
//
// Registers a thread and bytes of spill stores (ptxas -v for sm_90a, as
// chip_smoke.py's build phase prints them): dq 98 (D 64, none), 183 (128,
// none), 254 (256, 16 bytes); dk/dv 168 (64, capped for three blocks an
// SM: 8 bytes), 255 (128: 8 bytes), 255 (256: 184 bytes).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attn_wgmma.cuh"
#include "split_bf16.cuh"
#include "split_tf32.cuh"

namespace {

using attn_mma::Mma;
using split_tf32::cp_commit;
using split_tf32::cp_wait;
using split_tf32::load_rows;
using split_tf32::load_vec;

// P and ds of one (query qi, key kj) entry, from its raw score s, dp =
// dO_qi . v_kj and the query row's lse and delta; blind_p = 1 / tk.
// Branch-free, so the compiler can interleave it with the products: the
// exponential is taken everywhere and the masked cases are selected away.
__device__ __forceinline__ void p_and_ds(float s, float scale, float dp,
                                         float lse, float delta, int qi,
                                         int kj, int tq, int tk, int causal,
                                         float blind_p, float& p, float& ds) {
  const int offset = tk - tq;
  const bool in = qi < tq && kj < tk;  // else tile padding
  const bool masked = causal && kj > qi + offset;
  const float e = __expf(fmaf(s, scale, -lse));
  // a row that sees no key averages v: P = 1 / tk
  p = !in ? 0.f : masked ? (qi + offset < 0 ? blind_p : 0.f) : e;
  ds = in && !masked ? e * (dp - delta) : 0.f;
}

// ---------------------------------------------------------------------------
// dq: one block per (bh, R-row query tile), 4 warps of 16 rows; q, dO,
// lse and delta resident, C-key tiles of k and v streamed.
// ---------------------------------------------------------------------------
template <typename E, int D>
struct DqTile {
  static constexpr int R = 64;  // query rows a block
  // keys a streamed tile: at D = 64, 16 keys keep a block at 61 KB of
  // shared memory, three blocks an SM; at D = 256, 8 keep the S and dP
  // fragments (C / 2 registers) beside the dq accumulator (D / 2) within a
  // thread's registers and the block within shared memory (16 in bf16,
  // one 16-deep step)
  static constexpr int C =
      D == 64 ? 16 : D == 128 ? 32 : std::is_same<E, float>::value ? 8 : 16;
  static constexpr int kThreads = 32 * R / 16;
  static constexpr int LD = D + Mma<E>::kPad;
  static constexpr size_t kSmem =
      sizeof(E) * (2 * R * LD + (4 + 2 * Mma<E>::kLo) * C * LD) +
      sizeof(float) * 2 * R;
};

template <typename E, int D>
__global__ void __launch_bounds__(DqTile<E, D>::kThreads)
    flash_bwd_dq_kernel(const E* __restrict__ q, const E* __restrict__ k,
                        const E* __restrict__ v, const E* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        E* __restrict__ dq, int tq, int tk, float scale,
                        int causal) {
  using T = DqTile<E, D>;
  using M = Mma<E>;
  constexpr int R = T::R, C = T::C, LD = T::LD, NT = C / 8, ND = D / 8;
  constexpr int KS = M::kK, KJ = KS / 8;
  constexpr int kThreads = T::kThreads;
  static_assert(NT % KJ == 0, "whole steps over a key tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* qs = reinterpret_cast<E*>(smem_raw);  // [R][LD]
  E* gs = qs + R * LD;              // [R][LD]
  E* ring = gs + R * LD;            // stage st: k [C][LD], then v [C][LD]
  E* klo = ring + 4 * C * LD;       // fp32: small halves, k and v [C][LD]
  E* vlo = klo + M::kLo * C * LD;
  float* lse_s = reinterpret_cast<float*>(vlo + M::kLo * C * LD);  // [R]
  float* dl_s = lse_s + R;          // [R]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * R;
  const int tid = threadIdx.x;
  const int lane = tid % 32, gr = lane / 4, tc = lane % 4;
  const int m0 = tid / 32 * 16;  // this warp's rows within the block
  const float blind_p = 1.f / tk;
  const E* kb = k + (int64_t)bh * tk * D;
  const E* vb = v + (int64_t)bh * tk * D;

  load_rows<D, R, kThreads, LD>(qs, q + (int64_t)bh * tq * D, q0, tq, tid);
  load_rows<D, R, kThreads, LD>(gs, g + (int64_t)bh * tq * D, q0, tq, tid);
  load_vec<R, kThreads>(lse_s, lse + (int64_t)bh * tq, q0, tq, tid);
  load_vec<R, kThreads>(dl_s, delta + (int64_t)bh * tq, q0, tq, tid);

  // keys past the last row's horizon are masked for every row: ds = 0
  int kend = tk;
  if (causal) kend = max(0, min(tk, q0 + R + tk - tq));
  const int ntiles = (kend + C - 1) / C;
  if (ntiles > 0) {
    load_rows<D, C, kThreads, LD>(ring, kb, 0, tk, tid);
    load_rows<D, C, kThreads, LD>(ring + C * LD, vb, 0, tk, tid);
  }
  cp_commit();

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const E* qw = qs + m0 * LD;
  const E* gw = gs + m0 * LD;

  for (int kt = 0; kt < ntiles; ++kt) {
    E* ks = ring + (kt & 1) * 2 * C * LD;
    E* vs = ks + C * LD;
    if (kt + 1 < ntiles) {
      E* nk = ring + ((kt + 1) & 1) * 2 * C * LD;
      load_rows<D, C, kThreads, LD>(nk, kb, (kt + 1) * C, tk, tid);
      load_rows<D, C, kThreads, LD>(nk + C * LD, vb, (kt + 1) * C, tk, tid);
    }
    cp_commit();
    cp_wait<1>();  // this tile (and the resident rows) have landed
    M::template split_rows<D, C, kThreads, LD>(ks, klo, tid);
    M::template split_rows<D, C, kThreads, LD>(vs, vlo, tid);
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += KS) {
      const typename M::A aq = M::load_a(qw + kk, LD, gr, tc);
      const typename M::A ag = M::load_a(gw + kk, LD, gr, tc);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int at = j * 8 * LD + kk;
        M::mma(s[j], aq, M::load_b_t(ks + at, klo + at, LD, gr, tc));
        M::mma(dp[j], ag, M::load_b_t(vs + at, vlo + at, LD, gr, tc));
      }
    }
    // ds on the fragments: c0..c3 are (row gr | gr+8, key 2tc | 2tc+1)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = m0 + gr + (i >> 1) * 8;
        float p, ds;
        p_and_ds(s[j][i], scale, dp[j][i], lse_s[r], dl_s[r], q0 + r,
                 kt * C + j * 8 + 2 * tc + (i & 1), tq, tk, causal, blind_p,
                 p, ds);
        s[j][i] = ds;
      }
    // dq += ds k, KJ key tiles a step
#pragma unroll
    for (int j = 0; j < NT; j += KJ) {
      const typename M::AccA a = M::acc_as_a(s + j);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int at = j * 8 * LD + n * 8;
        M::mma(acc[n], a, M::load_b_acc(ks + at, klo + at, LD, gr, tc));
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }
  cp_wait<0>();

  E* dqb = dq + (int64_t)bh * tq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + m0 + gr + h * 8;
    if (row >= tq) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      M::store2(dqb + (int64_t)row * D + n * 8 + 2 * tc,
                acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// dk/dv: one block per (bh, C-key tile); k and v resident, R-row query
// tiles of q, dO, lse and delta streamed. Warp w owns keys 16 (w / SPLIT)
// and output columns (w % SPLIT) D / SPLIT.
// ---------------------------------------------------------------------------
template <typename E, int D>
struct DkvTile {
  static constexpr int C = D == 256 ? 32 : 64;  // keys a block
  static constexpr int R = D == 128 ? 32 : 16;  // queries a streamed tile
  static constexpr int SPLIT = D == 64 ? 1 : 2;  // warps sharing 16 keys
  static constexpr int kThreads = 32 * (C / 16) * SPLIT;
  // at D = 64 three blocks an SM (61 KB of shared memory each in fp32),
  // with the registers capped to fit: more warps to hide the products'
  // latency outweigh the few spills
  static constexpr int kMinBlocks = D == 64 ? 3 : 1;
  static constexpr int LD = D + Mma<E>::kPad;
  static constexpr size_t kSmem =
      sizeof(E) * (2 * C * LD + (4 + 2 * Mma<E>::kLo) * R * LD) +
      sizeof(float) * 4 * R;
};

template <typename E, int D>
__global__ void __launch_bounds__(DkvTile<E, D>::kThreads,
                                  DkvTile<E, D>::kMinBlocks)
    flash_bwd_dkv_kernel(const E* __restrict__ q, const E* __restrict__ k,
                         const E* __restrict__ v, const E* __restrict__ g,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         E* __restrict__ dk, E* __restrict__ dv, int tq,
                         int tk, float scale, int causal) {
  using T = DkvTile<E, D>;
  using M = Mma<E>;
  constexpr int R = T::R, C = T::C, LD = T::LD, NT = R / 8;
  constexpr int KS = M::kK, KJ = KS / 8;
  constexpr int NO = D / T::SPLIT / 8;  // output column tiles a warp
  constexpr int kThreads = T::kThreads;
  static_assert(NT % KJ == 0, "whole steps over a query tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* ks = reinterpret_cast<E*>(smem_raw);  // [C][LD]
  E* vs = ks + C * LD;               // [C][LD]
  E* ring = vs + C * LD;             // stage st: q [R][LD], then dO [R][LD]
  E* qlo = ring + 4 * R * LD;        // fp32: small halves, q and dO [R][LD]
  E* glo = qlo + M::kLo * R * LD;
  // stage st: lse [R], then delta [R]
  float* vec = reinterpret_cast<float*>(glo + M::kLo * R * LD);

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * C;
  const int tid = threadIdx.x;
  const int lane = tid % 32, gr = lane / 4, tc = lane % 4;
  const int warp = tid / 32;
  const int m0 = warp / T::SPLIT * 16;       // this warp's keys in the block
  const int c0 = warp % T::SPLIT * NO * 8;   // and its output columns
  const int offset = tk - tq;
  const float blind_p = 1.f / tk;
  const E* qb = q + (int64_t)bh * tq * D;
  const E* gb = g + (int64_t)bh * tq * D;
  const float* lb = lse + (int64_t)bh * tq;
  const float* db = delta + (int64_t)bh * tq;

  // the first query tile at or after qt that adds to these keys: under
  // causal masking a tile whose last row cannot reach key k0 adds nothing
  // unless it holds rows that see no key (rows < -offset, all at the top)
  auto next_tile = [&](int qt) {
    if (causal && qt + offset >= 0 && qt + R - 1 + offset < k0)
      qt = (k0 - offset) / R * R;
    return qt;
  };
  auto fetch = [&](int qt, int st) {
    E* qs_ = ring + st * 2 * R * LD;
    load_rows<D, R, kThreads, LD>(qs_, qb, qt, tq, tid);
    load_rows<D, R, kThreads, LD>(qs_ + R * LD, gb, qt, tq, tid);
    load_vec<R, kThreads>(vec + st * 2 * R, lb, qt, tq, tid);
    load_vec<R, kThreads>(vec + st * 2 * R + R, db, qt, tq, tid);
  };

  load_rows<D, C, kThreads, LD>(ks, k + (int64_t)bh * tk * D, k0, tk, tid);
  load_rows<D, C, kThreads, LD>(vs, v + (int64_t)bh * tk * D, k0, tk, tid);
  int qt = next_tile(0);
  if (qt < tq) fetch(qt, 0);
  cp_commit();

  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[n][i] = dv_acc[n][i] = 0.f;
  const E* kw = ks + m0 * LD;
  const E* vw = vs + m0 * LD;

  for (int st = 0; qt < tq; st ^= 1) {
    const int nxt = next_tile(qt + R);
    if (nxt < tq) fetch(nxt, st ^ 1);
    cp_commit();
    cp_wait<1>();  // this tile (and the resident keys) have landed
    E* qs = ring + st * 2 * R * LD;
    E* gs = qs + R * LD;
    M::template split_rows<D, R, kThreads, LD>(qs, qlo, tid);
    M::template split_rows<D, R, kThreads, LD>(gs, glo, tid);
    __syncthreads();
    const float* lse_s = vec + st * 2 * R;
    const float* dl_s = lse_s + R;

    // S^T = k q^T and dP^T = v dO^T: rows are keys, columns queries
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
    for (int kk = 0; kk < D; kk += KS) {
      const typename M::A ak = M::load_a(kw + kk, LD, gr, tc);
      const typename M::A av = M::load_a(vw + kk, LD, gr, tc);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int at = j * 8 * LD + kk;
        M::mma(s[j], ak, M::load_b_t(qs + at, qlo + at, LD, gr, tc));
        M::mma(dp[j], av, M::load_b_t(gs + at, glo + at, LD, gr, tc));
      }
    }
    // P^T and ds^T on the fragments: (key gr | gr+8, query 2tc | 2tc+1)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = j * 8 + 2 * tc + (i & 1);
        float p, ds;
        p_and_ds(s[j][i], scale, dp[j][i], lse_s[col], dl_s[col], qt + col,
                 k0 + m0 + gr + (i >> 1) * 8, tq, tk, causal, blind_p, p,
                 ds);
        s[j][i] = p;
        dp[j][i] = ds;
      }
    // dv += P^T dO, dk += ds^T q over this warp's output columns, KJ query
    // tiles a step
#pragma unroll
    for (int j = 0; j < NT; j += KJ) {
      const typename M::AccA ap = M::acc_as_a(s + j);
      const typename M::AccA ads = M::acc_as_a(dp + j);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int at = j * 8 * LD + c0 + n * 8;
        M::mma(dv_acc[n], ap, M::load_b_acc(gs + at, glo + at, LD, gr, tc));
        M::mma(dk_acc[n], ads, M::load_b_acc(qs + at, qlo + at, LD, gr, tc));
      }
    }
    __syncthreads();  // the next iteration refills this stage
    qt = nxt;
  }
  cp_wait<0>();

  E* dkb = dk + (int64_t)bh * tk * D;
  E* dvb = dv + (int64_t)bh * tk * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + m0 + gr + h * 8;
    if (key >= tk) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int64_t at = (int64_t)key * D + c0 + n * 8 + 2 * tc;
      M::store2(dkb + at, dk_acc[n][2 * h] * scale,
                dk_acc[n][2 * h + 1] * scale);
      M::store2(dvb + at, dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
    }
  }
}

template <typename E>
struct Args {
  const E *q, *k, *v, *g;
  const float *lse, *delta;
  E *dq, *dk, *dv;
  int64_t bh;
  int tq, tk;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename E, int D>
int launch_dq(const Args<E>& a) {
  using T = DqTile<E, D>;
  auto* kernel = flash_bwd_dq_kernel<E, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.tq + T::R - 1) / T::R, (unsigned)a.bh);
  kernel<<<grid, T::kThreads, T::kSmem, a.stream>>>(
      a.q, a.k, a.v, a.g, a.lse, a.delta, a.dq, a.tq, a.tk, a.scale,
      a.causal);
  return (int)cudaGetLastError();
}

template <typename E, int D>
int launch_dkv(const Args<E>& a) {
  using T = DkvTile<E, D>;
  auto* kernel = flash_bwd_dkv_kernel<E, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.tk + T::C - 1) / T::C, (unsigned)a.bh);
  kernel<<<grid, T::kThreads, T::kSmem, a.stream>>>(
      a.q, a.k, a.v, a.g, a.lse, a.delta, a.dk, a.dv, a.tq, a.tk, a.scale,
      a.causal);
  return (int)cudaGetLastError();
}

// the dq (kDq) or the dk/dv launch at head width d
template <typename E, bool kDq>
int by_head_dim(const Args<E>& a, int d) {
  if (a.tq < 1 || a.tk < 1) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 64:
      return kDq ? launch_dq<E, 64>(a) : launch_dkv<E, 64>(a);
    case 128:
      return kDq ? launch_dq<E, 128>(a) : launch_dkv<E, 128>(a);
    case 256:
      return kDq ? launch_dq<E, 256>(a) : launch_dkv<E, 256>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename E>
Args<E> make_args(const void* q, const void* k, const void* v, const void* g,
                  const void* lse, const void* delta, int64_t bh, int tq,
                  int tk, float scale, int causal, void* stream) {
  Args<E> a{};
  a.q = static_cast<const E*>(q);
  a.k = static_cast<const E*>(k);
  a.v = static_cast<const E*>(v);
  a.g = static_cast<const E*>(g);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.bh = bh;
  a.tq = tq;
  a.tk = tk;
  a.scale = scale;
  a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

template <typename E>
int bwd_dq(const void* q, const void* k, const void* v, const void* g,
           const void* lse, const void* delta, void* dq, int64_t bh, int tq,
           int tk, int d, float scale, int causal, void* stream) {
  Args<E> a = make_args<E>(q, k, v, g, lse, delta, bh, tq, tk, scale, causal,
                           stream);
  a.dq = static_cast<E*>(dq);
  return by_head_dim<E, true>(a, d);
}

template <typename E>
int bwd_dkv(const void* q, const void* k, const void* v, const void* g,
            const void* lse, const void* delta, void* dk, void* dv,
            int64_t bh, int tq, int tk, int d, float scale, int causal,
            void* stream) {
  Args<E> a = make_args<E>(q, k, v, g, lse, delta, bh, tq, tk, scale, causal,
                           stream);
  a.dk = static_cast<E*>(dk);
  a.dv = static_cast<E*>(dv);
  return by_head_dim<E, false>(a, d);
}

}  // namespace

// Contiguous device pointers: q, g (dO), dq [bh, tq, d]; k, v, dk, dv
// [bh, tk, d], all fp32 (flash_attention_bwd_dq/_dkv) or all bf16 (the
// _bf16 entries); lse, delta fp32 [bh, tq]. q, k, v, g, dq, dk and dv
// 16-byte aligned (cp.async and pair stores). d in {64, 128, 256}. Each
// returns cudaGetLastError() of its launch (or of the shared-memory
// attribute call); 1 (cudaErrorInvalidValue) for a shape the kernels do
// not take.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* g,
                                      const void* lse, const void* delta,
                                      void* dq, int64_t bh, int tq, int tk,
                                      int d, float scale, int causal,
                                      void* stream) {
  return bwd_dq<float>(q, k, v, g, lse, delta, dq, bh, tq, tk, d, scale,
                       causal, stream);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* g,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int64_t bh, int tq,
                                       int tk, int d, float scale, int causal,
                                       void* stream) {
  return bwd_dkv<float>(q, k, v, g, lse, delta, dk, dv, bh, tq, tk, d,
                        scale, causal, stream);
}

// bf16 dq at d 64 and 128 on attn_wgmma.cuh's `flash_dq_kernel` (q, k, v
// and g on 16 bytes, TMA's rule); d 256 on the mma.sync body above
extern "C" int flash_attention_bwd_dq_bf16(const void* q, const void* k,
                                           const void* v, const void* g,
                                           const void* lse,
                                           const void* delta, void* dq,
                                           int64_t bh, int tq, int tk, int d,
                                           float scale, int causal,
                                           void* stream) {
  using bf16 = __nv_bfloat16;
  if (d == 64 || d == 128) {
    const bf16* qe = static_cast<const bf16*>(q);
    const bf16* ke = static_cast<const bf16*>(k);
    const bf16* ve = static_cast<const bf16*>(v);
    const bf16* ge = static_cast<const bf16*>(g);
    const float* lf = static_cast<const float*>(lse);
    const float* df = static_cast<const float*>(delta);
    bf16* dqe = static_cast<bf16*>(dq);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return (int)(d == 64 ? attn_wgmma::flash_dq<64>(qe, ke, ve, ge, lf, df,
                                                    dqe, bh, tq, tk, scale,
                                                    causal, s)
                         : attn_wgmma::flash_dq<128>(qe, ke, ve, ge, lf, df,
                                                     dqe, bh, tq, tk, scale,
                                                     causal, s));
  }
  if (d != 256 || tq < 1 || tk < 1) return (int)cudaErrorInvalidValue;
  Args<bf16> a = make_args<bf16>(q, k, v, g, lse, delta, bh, tq, tk, scale,
                                 causal, stream);
  a.dq = static_cast<bf16*>(dq);
  return launch_dq<bf16, 256>(a);
}

// bf16 dk/dv at d 64 and 128 on attn_wgmma.cuh's `flash_dkv_kernel` (q,
// k, v and g on 16 bytes, TMA's rule); d 256 on the mma.sync body above
extern "C" int flash_attention_bwd_dkv_bf16(const void* q, const void* k,
                                            const void* v, const void* g,
                                            const void* lse,
                                            const void* delta, void* dk,
                                            void* dv, int64_t bh, int tq,
                                            int tk, int d, float scale,
                                            int causal, void* stream) {
  using bf16 = __nv_bfloat16;
  if (d == 64 || d == 128) {
    const bf16* qe = static_cast<const bf16*>(q);
    const bf16* ke = static_cast<const bf16*>(k);
    const bf16* ve = static_cast<const bf16*>(v);
    const bf16* ge = static_cast<const bf16*>(g);
    const float* lf = static_cast<const float*>(lse);
    const float* df = static_cast<const float*>(delta);
    bf16* dke = static_cast<bf16*>(dk);
    bf16* dve = static_cast<bf16*>(dv);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return (int)(d == 64 ? attn_wgmma::flash_dkv<64>(qe, ke, ve, ge, lf, df,
                                                     dke, dve, bh, tq, tk,
                                                     scale, causal, s)
                         : attn_wgmma::flash_dkv<128>(qe, ke, ve, ge, lf, df,
                                                      dke, dve, bh, tq, tk,
                                                      scale, causal, s));
  }
  if (d != 256 || tq < 1 || tk < 1) return (int)cudaErrorInvalidValue;
  Args<__nv_bfloat16> a = make_args<__nv_bfloat16>(
      q, k, v, g, lse, delta, bh, tq, tk, scale, causal, stream);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  return launch_dkv<__nv_bfloat16, 256>(a);
}
