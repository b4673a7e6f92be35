// The online-softmax attention forward for Hopper (sm_90a), in fp32 (split
// TF32) or bf16 (E, the element type of q, k, v, o and P; split_bf16.cuh):
// the body that flash_attention.cu (#2, any tq and tk, d 64, 128 or 256,
// optionally the per-row logsumexp), sdpa_short.cu (#5, tq == tk <= 512, d
// 64 or 128, optionally the normalized P) and the attention_block forward
// (#10, attention_block.cu, fp32 only: head widths up to 64 on d 64, up to
// 128 on d 128, optionally P; its bf16 instance writes the output as two
// bf16 planes, kOutPlanes) instantiate.
//
// In bf16: S = q k^T is one bf16 MMA a step (its products exact in fp32,
// as after the TPU kernel's upcast); P, an fp32 intermediate, enters P v
// split into two bf16 parts (two MMAs); the lse stays fp32, the output and
// the saved P are rounded to bf16 once, at the end. The scale multiplies
// the fp32 scores, where the TPU kernel multiplies its fp32 q before the
// product (attention.py:131): the same up to fp32 rounding, a power of two
// at d 64 and 256 exact either way.
//
// Computes out = softmax(scale * q k^T [+ causal mask]) v for q [BH, tq, D],
// k, v [BH, tk, D]. Each operand may be a view (Layout: a base per head
// and a 32-bit row stride), so that attention_block.cu (#10) reads q, k
// and v in place inside its [B*T, 3D] qkv rows and writes each head's
// columns of its context; only the first dh <= D columns exist, the rest
// zero-filled as they land (they add nothing to a score, the scale being
// given) and not written. #2 and #5 pass contiguous [BH, T, D] tensors,
// for which the body is instantiated with the view's arithmetic folded to
// constants (kViews false): behind runtime strides the D-64 instance,
// capped at 168 registers for three blocks an SM, spilled more in its P
// sweep and ran slower on the card.
//
// Causal masking is bottom-right aligned: query i sees keys <= i + tk - tq
// (for tq == tk, keys <= i). Masked scores take -FLT_MAX, as in
// `reference_attention`, so a fully masked row (tq > tk) yields the
// uniform average of v instead of NaN; its logsumexp, -FLT_MAX + log(tk),
// rounds to -FLT_MAX.
//
// The design (the recipe of flash_attention_bwd.cu):
// - Split TF32 (split_tf32.cuh): S = q k^T and O += P v are
//   mma.sync.m16n8k8 TF32 products, three for each fp32 product, each
//   8-deep step summed in a fresh fragment and added in fp32.
// - One block per (bh, 64 query rows), 4 warps; each warp owns 16 rows
//   for the whole key loop and keeps the online-softmax state (row max m,
//   a partial denominator l, the [16, D] output accumulator) in registers.
//   At D = 64 the warp's q rows also stay in registers, split once (64
//   registers); at D = 128 and 256 they stay in shared memory and are
//   split where they are read. At D = 256 two warps share 16 rows, each
//   owning half of the output columns and both computing the same S: one
//   thread's registers cannot hold a [16, 256] accumulator beside S.
// - K and V come through a two-stage ring filled by cp.async with 16-byte
//   copies (32 keys a tile at D = 64, 16 at 128 and 256), so the next tile
//   loads while this one is multiplied. Each tile is split once as it
//   lands, by the threads that copied it: big halves in place, small
//   halves into a second buffer. Rows are padded to D + 4 floats, so every
//   fragment read hits 32 distinct banks. Ragged rows are zero-filled.
// - The softmax runs on the S accumulator fragments: a thread holds two
//   rows (g and g + 8), and the row max is taken over the quad that shares
//   them with two __shfl_xor_sync; the scale and the masks are applied
//   without branches. P goes straight back as the A operand of P v
//   (permuted k index, V read in the same order): P never touches shared
//   memory. The denominators stay partial per thread until the end.
// - Causal tiles past the block's last visible key are not fetched, and a
//   warp skips the products of a tile that none of its rows can see.
// - With kSaveP, once the key loop has ended and each row's max m and
//   denominator l are final, one more sweep streams the K tiles again,
//   recomputes S with the same fragment code and masks, and writes the
//   normalized P = exp(S - m) / l straight from the fragments (float2
//   stores where the rows of P are 8-byte aligned, single floats where tk
//   is odd), zeros where the key loop skipped a causal tile. Every element
//   of the block's rows of P is written. The sweep leaves the output
//   alone: it is the same with P and without, bit for bit.
// - Deterministic: every block writes only its own rows, with no atomics,
//   and sums in a fixed order, so two launches give identical bits.
//
// A later lever: wgmma takes TF32 operands only K-major. S = q k^T
// already is (q and k both run along D); P v would need V transposed as it
// lands.
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "split_bf16.cuh"
#include "split_tf32.cuh"

namespace flash_fwd {

using attn_mma::Mma;
using split_tf32::cp_commit;
using split_tf32::cp_wait;
using split_tf32::load_tile;

// a pointer parameter that does not take part in deducing E
template <typename T>
struct Same {
  using type = T;
};

template <typename E, int D>
struct FwdTile {
  static constexpr int R = 64;                    // query rows a block
  static constexpr int SPLIT = D == 256 ? 2 : 1;  // warps sharing 16 rows
  static constexpr int C = D == 64 ? 32 : 16;     // keys a streamed tile
  static constexpr bool kQInRegs = D == 64;
  static constexpr int kThreads = 32 * (R / 16) * SPLIT;
  // at D = 64 three blocks an SM (68 KB of shared memory each), the
  // registers capped to fit; at D = 128 and 256 stating one block ran
  // faster on the card than leaving the bound out
  static constexpr int kMinBlocks = D == 64 ? 3 : 1;
  static constexpr int LD = D + Mma<E>::kPad;  // a staged row, elements
  // q [R][LD]; a two-stage ring of k and v tiles [C][LD]; in fp32 their
  // small halves
  static constexpr size_t kSmem =
      sizeof(E) * (R * LD + (4 + 2 * Mma<E>::kLo) * C * LD);
};

// The views of q, k, v and o (operands 0-3) across heads: head bh's rows
// of operand i start at its pointer + (bh / heads) * outer[i] + (bh %
// heads) * inner[i], ld[i] elements apart (a 32-bit stride, which keeps the
// address arithmetic in fewer registers); only their first dh columns
// exist. With kOutPlanes, o's elements are bf16: hi = bf16(value) at
// those offsets, lo = bf16(value - hi) `plane` elements further.
struct Layout {
  int64_t outer[4], inner[4];
  int ld[4];
  int heads, dh;
  int64_t plane;
};

// kViews: q, k, v and o lie as `lay` says; else they are contiguous [BH, t,
// D] (lay unused), so that the address arithmetic of #2 and #5 stays
// compile-time constants and their pointers __restrict__. kOutPlanes (with
// kViews): o holds the output as two bf16 planes (Layout)
template <typename E, int D, bool kSaveP, bool kViews, bool kOutPlanes = false>
__global__ void __launch_bounds__(FwdTile<E, D>::kThreads,
                                  FwdTile<E, D>::kMinBlocks)
    fwd_kernel(const E* __restrict__ q, const E* __restrict__ k,
               const E* __restrict__ v, E* __restrict__ o,
               float* __restrict__ lse, E* __restrict__ p_out, int tq,
               int tk, float scale, int causal, const Layout lay) {
  using T = FwdTile<E, D>;
  using M = Mma<E>;
  constexpr int R = T::R, C = T::C, LD = T::LD, NT = C / 8;
  constexpr int KS = M::kK, KJ = KS / 8;  // a step's depth, in 8-col tiles
  constexpr int NK = D / KS;              // steps over the head width
  constexpr int NO = D / 8 / T::SPLIT;    // output column tiles a warp
  constexpr int kThreads = T::kThreads;
  static_assert(!kSaveP || T::SPLIT == 1, "one warp writes a row of P");
  static_assert(NT % KJ == 0, "whole steps over a key tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* smem = reinterpret_cast<E*>(smem_raw);
  E* qs = smem;                // [R][LD]
  E* ring = qs + R * LD;       // stage st: k [C][LD], then v [C][LD]
  // fp32: small halves, k [C][LD] and v [C][LD]; bf16: none (unread)
  E* klo = ring + 4 * C * LD;
  E* vlo = klo + M::kLo * C * LD;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * R;
  const int dh = kViews ? lay.dh : D;
  const int tid = threadIdx.x;
  const int lane = tid % 32, gr = lane / 4, tc = lane % 4;
  const int warp = tid / 32;
  const int m0 = warp / T::SPLIT * 16;      // this warp's rows in the block
  const int c0 = warp % T::SPLIT * NO * 8;  // and its output columns
  const int offset = tk - tq;
  // head bh's rows of operand i (t of them), and their stride
  auto rows = [&](auto* x, int i, int t) {
    return kViews ? x + (int64_t)(bh / lay.heads) * lay.outer[i] +
                        (int64_t)(bh % lay.heads) * lay.inner[i]
                  : x + (int64_t)bh * t * D;
  };
  auto ld = [&](int i) { return kViews ? lay.ld[i] : D; };
  const E* kb = rows(k, 1, tk);
  const E* vb = rows(v, 2, tk);
  // key rows [k0, k0 + C) of K into stage st's k slot (and of V into its
  // v slot)
  auto load_k = [&](E* st, int k0) {
    load_tile<D, C, kThreads, LD>(st, kb, ld(1), k0, tk, dh, tid);
  };
  auto load_kv = [&](E* st, int k0) {
    load_k(st, k0);
    load_tile<D, C, kThreads, LD>(st + C * LD, vb, ld(2), k0, tk, dh, tid);
  };

  // With no fully masked row in the block, keys past the last row's
  // horizon add exp(-FLT_MAX - m) = 0 and are not fetched; likewise a warp
  // whose rows all see a key skips the tiles past its own last row.
  int kend = tk;
  if (causal && q0 + offset >= 0) kend = min(tk, q0 + R + offset);
  const int ntiles = (kend + C - 1) / C;
  const bool warp_skips = causal && q0 + m0 + offset >= 0;
  const int warp_last = q0 + m0 + 15 + offset;  // its last row's horizon

  load_tile<D, R, kThreads, LD>(qs, rows(q, 0, tq), ld(0), q0, tq, dh, tid);
  load_kv(ring, 0);
  cp_commit();

  float acc[NO][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const E* qw = qs + m0 * LD;
  typename M::A aq[T::kQInRegs ? NK : 1];

  // S = q k^T of the warp's rows on key tile kt (staged at ks, its small
  // halves in klo), scaled and masked: c0..c3 are (row gr | gr+8, key 2tc
  // | 2tc+1)
  auto scores = [&](float (&s)[NT][4], const E* ks, int kt) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      typename M::A a;
      if constexpr (T::kQInRegs)
        a = aq[kk];
      else
        a = M::load_a(qw + kk * KS, LD, gr, tc);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int at = j * 8 * LD + kk * KS;
        M::mma(s[j], a, M::load_b_t(ks + at, klo + at, LD, gr, tc));
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = kt * C + j * 8 + 2 * tc + (i & 1);
        const int qi = q0 + m0 + gr + (i >> 1) * 8;
        s[j][i] = key >= tk ? -INFINITY  // tile padding, not a key
                  : causal && key > qi + offset ? -FLT_MAX
                                                : s[j][i] * scale;
      }
  };

  for (int kt = 0; kt < ntiles; ++kt) {
    E* ks = ring + (kt & 1) * 2 * C * LD;
    E* vs = ks + C * LD;
    if (kt + 1 < ntiles)
      load_kv(ring + ((kt + 1) & 1) * 2 * C * LD, (kt + 1) * C);
    cp_commit();
    cp_wait<1>();  // this tile (and q) have landed
    M::template split_rows<D, C, kThreads, LD>(ks, klo, tid);
    M::template split_rows<D, C, kThreads, LD>(vs, vlo, tid);
    __syncthreads();
    if constexpr (T::kQInRegs) {
      if (kt == 0) {
#pragma unroll
        for (int kk = 0; kk < NK; ++kk)
          aq[kk] = M::load_a(qw + kk * KS, LD, gr, tc);
      }
    }
    if (!(warp_skips && kt * C > warp_last)) {
      float s[NT][4];
      scores(s, ks, kt);
      // the row max over the quad that holds the row
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        // every tile holds a key, so m_new is finite; corr is 0 at first
        const float m_new = fmaxf(m[h], mx[h]);
        corr[h] = __expf(m[h] - m_new);
        m[h] = m_new;
        l[h] *= corr[h];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = __expf(s[j][i] - m[i >> 1]);
          s[j][i] = p;
          l[i >> 1] += p;
        }
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }
      // O += P v over this warp's output columns, KJ key tiles a step
#pragma unroll
      for (int j = 0; j < NT; j += KJ) {
        const typename M::AccA a = M::acc_as_a(s + j);
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          const int at = j * 8 * LD + c0 + n * 8;
          M::mma(acc[n], a, M::load_b_acc(vs + at, vlo + at, LD, gr, tc));
        }
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }
  cp_wait<0>();

  E* ob = rows(o, 3, tq);
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.f / l[h];
    const int row = q0 + m0 + gr + h * 8;
    if (row >= tq) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      if (c0 + n * 8 < dh) {
        const int64_t at = (int64_t)row * ld(3) + c0 + n * 8 + 2 * tc;
        if constexpr (kOutPlanes) {
          uint32_t hi, lo;
          split_bf16::split(hi, lo, acc[n][2 * h] * inv[h],
                            acc[n][2 * h + 1] * inv[h]);
          uint32_t* ow = reinterpret_cast<uint32_t*>(
              reinterpret_cast<split_bf16::bf16*>(o) + (ob - o) + at);
          ow[0] = hi;
          ow[lay.plane / 2] = lo;
        } else {
          M::store2(ob + at, acc[n][2 * h] * inv[h],
                    acc[n][2 * h + 1] * inv[h]);
        }
      }
    if (lse != nullptr && c0 == 0 && tc == 0)
      lse[(int64_t)bh * tq + row] = m[h] + logf(l[h]);
  }

  if constexpr (kSaveP) {
    // the P sweep: K alone through the ring's k slots (the key loop's last
    // barrier freed them)
    E* pb = p_out + (int64_t)bh * tq * tk;
    const bool pairs = tk % 2 == 0;  // rows of P aligned for pair stores
    load_k(ring, 0);
    cp_commit();
    for (int kt = 0; kt < ntiles; ++kt) {
      E* ks = ring + (kt & 1) * 2 * C * LD;
      if (kt + 1 < ntiles)
        load_k(ring + ((kt + 1) & 1) * 2 * C * LD, (kt + 1) * C);
      cp_commit();
      cp_wait<1>();
      M::template split_rows<D, C, kThreads, LD>(ks, klo, tid);
      __syncthreads();
      float s[NT][4];
      if (!(warp_skips && kt * C > warp_last)) {
        scores(s, ks, kt);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            s[j][i] = expf(s[j][i] - m[i >> 1]) * inv[i >> 1];
      } else {  // every key of the tile lies past the warp's rows
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q0 + m0 + gr + h * 8;
        if (row >= tq) continue;
        E* pr = pb + (int64_t)row * tk;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int key = kt * C + j * 8 + 2 * tc;
          if (key >= tk) continue;
          if (pairs) {
            M::store2(pr + key, s[j][2 * h], s[j][2 * h + 1]);
          } else {
            pr[key] = E(s[j][2 * h]);
            if (key + 1 < tk) pr[key + 1] = E(s[j][2 * h + 1]);
          }
        }
      }
      __syncthreads();  // the next iteration refills this stage
    }
    cp_wait<0>();
    // keys past the tiles the key loop fetched: a causal P is 0 there
    const int k1 = ntiles * C, width = tk - k1;
    if (width > 0) {
      for (int i = tid; i < R * width; i += kThreads) {
        const int row = q0 + i / width;
        if (row < tq) pb[(int64_t)row * tk + k1 + i % width] = M::zero();
      }
    }
  }
}

// Launches the forward over `bh` heads on stream s, on operands laid out
// as `lay` says (kViews; kOutPlanes: the output as two bf16 planes in o's
// bytes) or contiguous [bh, t, D] (lay unused); returns cudaGetLastError()
// of the launch (or of the shared-memory attribute call).
template <int D, bool kSaveP, bool kViews, bool kOutPlanes = false,
          typename E>
int launch(const E* q, const E* k, const E* v, E* o, float* lse,
           typename Same<E>::type* p, int64_t bh, int tq, int tk,
           float scale, int causal, const Layout& lay, cudaStream_t s) {
  using T = FwdTile<E, D>;
  static_assert(!kOutPlanes || kViews, "planes through a view");
  auto* kernel = fwd_kernel<E, D, kSaveP, kViews, kOutPlanes>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((tq + T::R - 1) / T::R, (unsigned)bh);
  kernel<<<grid, T::kThreads, T::kSmem, s>>>(q, k, v, o, lse, p, tq, tk,
                                             scale, causal, lay);
  return (int)cudaGetLastError();
}

// The same on contiguous q, o [bh, tq, D] and k, v [bh, tk, D].
template <int D, bool kSaveP, typename E>
int launch(const E* q, const E* k, const E* v, E* o, float* lse,
           typename Same<E>::type* p, int64_t bh, int tq, int tk,
           float scale, int causal, cudaStream_t s) {
  return launch<D, kSaveP, false>(q, k, v, o, lse, p, bh, tq, tk, scale,
                                  causal, Layout{}, s);
}

}  // namespace flash_fwd
