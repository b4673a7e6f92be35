// Flash-attention backward for Hopper (sm_90a), fp32 in and out: two
// kernels, the FlashAttention-2 recipe, with every product on the tensor
// cores in split TF32.
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
// - Split TF32. The port's gradients are held to fp32 (1e-5 of the
//   largest |grad|), which one TF32 product (11-bit significands) misses
//   by two orders. Each fp32 operand x is split into big = tf32(x) and
//   small = tf32(x - big) (rounded to nearest, ties away, with two integer
//   instructions), and a product is small*big + big*small + big*big
//   (small*small, ~2^-22 of it, dropped): three mma.sync.m16n8k8 TF32
//   products for each fp32 product.
// - Round-to-nearest sums. The three products of one 8-deep step go into
//   a fresh fragment that is then added to the running sum with an fp32
//   add. The tensor cores' own accumulation truncates: chaining the steps
//   through it, even only the 8 steps of S and dP at D = 64, moves the
//   grads by several times the fp32 error, and chaining every product
//   fails the 1e-5 gate.
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
// Registers a thread and bytes of spill stores (ptxas -v for sm_90a, as
// chip_smoke.py's build phase prints them): dq 98 (D 64, none), 183 (128,
// none), 254 (256, 16 bytes); dk/dv 168 (64, capped for three blocks an
// SM: 8 bytes), 255 (128: 8 bytes), 255 (256: 184 bytes).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPad = 4;  // row padding, floats: conflict-free fragments

// ---------------------------------------------------------------------------
// split-TF32 products on mma.sync.m16n8k8 (PTX ISA fragment layouts; lane
// = 4 g + t):
//   A 16x8: a0 (row g, k t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B 8x8:  b0 (k t, col g), b1 (k t+4, col g)
//   C 16x8: c0 (row g, col 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
// ---------------------------------------------------------------------------
template <int N>
struct Operand {  // N tf32 registers of a fragment, split
  uint32_t big[N], small[N];
};
using OpA = Operand<4>;
using OpB = Operand<2>;

// x rounded to TF32, to nearest with ties away from zero: what
// cvt.rna.tf32.f32 gives for a finite x, in two integer instructions,
// fewer than the cvt compiles to (the operands here are always finite)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

template <int N>
__device__ __forceinline__ void split(Operand<N>& o, int i, float x) {
  o.big[i] = to_tf32(x);
  o.small[i] = to_tf32(x - __uint_as_float(o.big[i]));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += a b to about fp32 accuracy (see the note at the top)
__device__ __forceinline__ void mma3(float (&acc)[4], const OpA& a,
                                     const OpB& b) {
  float t[4];
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(t[0]), "=f"(t[1]), "=f"(t[2]), "=f"(t[3])
      : "r"(a.small[0]), "r"(a.small[1]), "r"(a.small[2]), "r"(a.small[3]),
        "r"(b.big[0]), "r"(b.big[1]), "f"(0.f));
  mma(t, a.big, b.small);
  mma(t, a.big, b.big);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += t[i];
}

// A = M[m0:m0+16, k0:k0+8] of a row-major M (row stride ld) at p = &M[m0][k0]
__device__ __forceinline__ OpA load_a(const float* p, int ld, int g, int t) {
  OpA a;
  split(a, 0, p[g * ld + t]);
  split(a, 1, p[(g + 8) * ld + t]);
  split(a, 2, p[g * ld + t + 4]);
  split(a, 3, p[(g + 8) * ld + t + 4]);
  return a;
}

// A from an accumulator fragment, k permuted: slot t <- column 2t, slot
// t+4 <- column 2t+1
__device__ __forceinline__ OpA acc_as_a(const float (&c)[4]) {
  OpA a;
  split(a, 0, c[0]);
  split(a, 1, c[2]);
  split(a, 2, c[1]);
  split(a, 3, c[3]);
  return a;
}

// A B operand comes from a tile split once as it lands (split_rows): its
// big halves in place, its small halves at the same offsets in a second
// buffer; hi and lo point at the same element of each.
__device__ __forceinline__ void pick(OpB& b, int i, const float* hi,
                                     const float* lo, int at) {
  b.big[i] = __float_as_uint(hi[at]);
  b.small[i] = __float_as_uint(lo[at]);
}

// B = M^T for a row-major M [n][k] at &M[n0][k0]: B(k, n) = M[n][k]
__device__ __forceinline__ OpB load_b_t(const float* hi, const float* lo,
                                        int ld, int g, int t) {
  OpB b;
  pick(b, 0, hi, lo, g * ld + t);
  pick(b, 1, hi, lo, g * ld + t + 4);
  return b;
}

// B = M for a row-major M [k][n] at &M[k0][n0], k permuted as in acc_as_a
__device__ __forceinline__ OpB load_b_perm(const float* hi, const float* lo,
                                           int ld, int g, int t) {
  OpB b;
  pick(b, 0, hi, lo, 2 * t * ld + g);
  pick(b, 1, hi, lo, (2 * t + 1) * ld + g);
  return b;
}

// ---------------------------------------------------------------------------
// cp.async staging
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp16(float* dst, const float* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// rows [r0, r0 + N) of a row-major [*, D] matrix g into s [N][D + kPad];
// rows at or past `limit` are zero-filled
template <int D, int N, int THREADS>
__device__ __forceinline__ void load_rows(float* s, const float* g, int r0,
                                          int limit, int tid) {
  constexpr int kChunks = D / 4;  // 16-byte chunks a row
  static_assert(N * kChunks % THREADS == 0, "whole rounds of chunks");
#pragma unroll
  for (int n = 0; n < N * kChunks / THREADS; ++n) {
    const int i = tid + n * THREADS;
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const bool in = r0 + r < limit;
    cp16(s + r * (D + kPad) + c, g + (int64_t)(in ? r0 + r : 0) * D + c, in);
  }
}

// after load_rows<D, N, THREADS> into s has landed: each thread splits
// the chunks it copied itself (so no barrier is needed first), the big
// halves in place and the small ones into lo
template <int D, int N, int THREADS>
__device__ __forceinline__ void split_rows(float* s, float* lo, int tid) {
  constexpr int kChunks = D / 4;
#pragma unroll
  for (int n = 0; n < N * kChunks / THREADS; ++n) {
    const int i = tid + n * THREADS;
    const int at = i / kChunks * (D + kPad) + (i % kChunks) * 4;
    const float4 x = *reinterpret_cast<const float4*>(s + at);
    Operand<4> o;
    split(o, 0, x.x);
    split(o, 1, x.y);
    split(o, 2, x.z);
    split(o, 3, x.w);
    *reinterpret_cast<uint4*>(s + at) =
        make_uint4(o.big[0], o.big[1], o.big[2], o.big[3]);
    *reinterpret_cast<uint4*>(lo + at) =
        make_uint4(o.small[0], o.small[1], o.small[2], o.small[3]);
  }
}

template <int N, int THREADS>
__device__ __forceinline__ void load_vec(float* s, const float* g, int r0,
                                         int limit, int tid) {
  static_assert(N <= THREADS, "one entry a thread");
  if (tid < N) {
    const bool in = r0 + tid < limit;
    cp4(s + tid, g + (in ? r0 + tid : 0), in);
  }
}

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
template <int D>
struct DqTile {
  static constexpr int R = 64;  // query rows a block
  // keys a streamed tile: at D = 64, 16 keys keep a block at 61 KB of
  // shared memory, three blocks an SM; at D = 256, 8 keep the S and dP
  // fragments (C / 2 registers) beside the dq accumulator (D / 2) within a
  // thread's registers and the block within shared memory
  static constexpr int C = D == 64 ? 16 : D == 128 ? 32 : 8;
  static constexpr int kThreads = 32 * R / 16;
  static constexpr size_t kSmem =
      sizeof(float) * (2 * R * (D + kPad) + 6 * C * (D + kPad) + 2 * R);
};

template <int D>
__global__ void __launch_bounds__(DqTile<D>::kThreads)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int tq, int tk, float scale,
                        int causal) {
  using T = DqTile<D>;
  constexpr int R = T::R, C = T::C, LD = D + kPad, NT = C / 8, ND = D / 8;
  constexpr int kThreads = T::kThreads;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [R][LD]
  float* gs = qs + R * LD;          // [R][LD]
  float* ring = gs + R * LD;        // stage st: k [C][LD], then v [C][LD]
  float* klo = ring + 4 * C * LD;   // small halves: k [C][LD], v [C][LD]
  float* vlo = klo + C * LD;
  float* lse_s = vlo + C * LD;      // [R]
  float* dl_s = lse_s + R;          // [R]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * R;
  const int tid = threadIdx.x;
  const int lane = tid % 32, gr = lane / 4, tc = lane % 4;
  const int m0 = tid / 32 * 16;  // this warp's rows within the block
  const float blind_p = 1.f / tk;
  const float* kb = k + (int64_t)bh * tk * D;
  const float* vb = v + (int64_t)bh * tk * D;

  load_rows<D, R, kThreads>(qs, q + (int64_t)bh * tq * D, q0, tq, tid);
  load_rows<D, R, kThreads>(gs, g + (int64_t)bh * tq * D, q0, tq, tid);
  load_vec<R, kThreads>(lse_s, lse + (int64_t)bh * tq, q0, tq, tid);
  load_vec<R, kThreads>(dl_s, delta + (int64_t)bh * tq, q0, tq, tid);

  // keys past the last row's horizon are masked for every row: ds = 0
  int kend = tk;
  if (causal) kend = max(0, min(tk, q0 + R + tk - tq));
  const int ntiles = (kend + C - 1) / C;
  if (ntiles > 0) {
    load_rows<D, C, kThreads>(ring, kb, 0, tk, tid);
    load_rows<D, C, kThreads>(ring + C * LD, vb, 0, tk, tid);
  }
  cp_commit();

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const float* qw = qs + m0 * LD;
  const float* gw = gs + m0 * LD;

  for (int kt = 0; kt < ntiles; ++kt) {
    float* ks = ring + (kt & 1) * 2 * C * LD;
    float* vs = ks + C * LD;
    if (kt + 1 < ntiles) {
      float* nk = ring + ((kt + 1) & 1) * 2 * C * LD;
      load_rows<D, C, kThreads>(nk, kb, (kt + 1) * C, tk, tid);
      load_rows<D, C, kThreads>(nk + C * LD, vb, (kt + 1) * C, tk, tid);
    }
    cp_commit();
    cp_wait<1>();  // this tile (and the resident rows) have landed
    split_rows<D, C, kThreads>(ks, klo, tid);
    split_rows<D, C, kThreads>(vs, vlo, tid);
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 8) {
      const OpA aq = load_a(qw + kk, LD, gr, tc);
      const OpA ag = load_a(gw + kk, LD, gr, tc);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int at = j * 8 * LD + kk;
        mma3(s[j], aq, load_b_t(ks + at, klo + at, LD, gr, tc));
        mma3(dp[j], ag, load_b_t(vs + at, vlo + at, LD, gr, tc));
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
    // dq += ds k
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const OpA a = acc_as_a(s[j]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int at = j * 8 * LD + n * 8;
        mma3(acc[n], a, load_b_perm(ks + at, klo + at, LD, gr, tc));
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }
  cp_wait<0>();

  float* dqb = dq + (int64_t)bh * tq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + m0 + gr + h * 8;
    if (row >= tq) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<float2*>(dqb + (int64_t)row * D + n * 8 + 2 * tc) =
          make_float2(acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// dk/dv: one block per (bh, C-key tile); k and v resident, R-row query
// tiles of q, dO, lse and delta streamed. Warp w owns keys 16 (w / SPLIT)
// and output columns (w % SPLIT) D / SPLIT.
// ---------------------------------------------------------------------------
template <int D>
struct DkvTile {
  static constexpr int C = D == 256 ? 32 : 64;  // keys a block
  static constexpr int R = D == 128 ? 32 : 16;  // queries a streamed tile
  static constexpr int SPLIT = D == 64 ? 1 : 2;  // warps sharing 16 keys
  static constexpr int kThreads = 32 * (C / 16) * SPLIT;
  // at D = 64 three blocks an SM (61 KB of shared memory each), with the
  // registers capped to fit: more warps to hide the products' latency
  // outweigh the few spills
  static constexpr int kMinBlocks = D == 64 ? 3 : 1;
  static constexpr size_t kSmem =
      sizeof(float) * (2 * C * (D + kPad) + 6 * R * (D + kPad) + 4 * R);
};

template <int D>
__global__ void __launch_bounds__(DkvTile<D>::kThreads,
                                  DkvTile<D>::kMinBlocks)
    flash_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ g,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int tq, int tk, float scale, int causal) {
  using T = DkvTile<D>;
  constexpr int R = T::R, C = T::C, LD = D + kPad, NT = R / 8;
  constexpr int NO = D / T::SPLIT / 8;  // output column tiles a warp
  constexpr int kThreads = T::kThreads;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                  // [C][LD]
  float* vs = ks + C * LD;           // [C][LD]
  float* ring = vs + C * LD;         // stage st: q [R][LD], then dO [R][LD]
  float* qlo = ring + 4 * R * LD;    // small halves: q [R][LD], dO [R][LD]
  float* glo = qlo + R * LD;
  float* vec = glo + R * LD;         // stage st: lse [R], then delta [R]

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * C;
  const int tid = threadIdx.x;
  const int lane = tid % 32, gr = lane / 4, tc = lane % 4;
  const int warp = tid / 32;
  const int m0 = warp / T::SPLIT * 16;       // this warp's keys in the block
  const int c0 = warp % T::SPLIT * NO * 8;   // and its output columns
  const int offset = tk - tq;
  const float blind_p = 1.f / tk;
  const float* qb = q + (int64_t)bh * tq * D;
  const float* gb = g + (int64_t)bh * tq * D;
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
    float* qs_ = ring + st * 2 * R * LD;
    load_rows<D, R, kThreads>(qs_, qb, qt, tq, tid);
    load_rows<D, R, kThreads>(qs_ + R * LD, gb, qt, tq, tid);
    load_vec<R, kThreads>(vec + st * 2 * R, lb, qt, tq, tid);
    load_vec<R, kThreads>(vec + st * 2 * R + R, db, qt, tq, tid);
  };

  load_rows<D, C, kThreads>(ks, k + (int64_t)bh * tk * D, k0, tk, tid);
  load_rows<D, C, kThreads>(vs, v + (int64_t)bh * tk * D, k0, tk, tid);
  int qt = next_tile(0);
  if (qt < tq) fetch(qt, 0);
  cp_commit();

  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[n][i] = dv_acc[n][i] = 0.f;
  const float* kw = ks + m0 * LD;
  const float* vw = vs + m0 * LD;

  for (int st = 0; qt < tq; st ^= 1) {
    const int nxt = next_tile(qt + R);
    if (nxt < tq) fetch(nxt, st ^ 1);
    cp_commit();
    cp_wait<1>();  // this tile (and the resident keys) have landed
    float* qs = ring + st * 2 * R * LD;
    float* gs = qs + R * LD;
    split_rows<D, R, kThreads>(qs, qlo, tid);
    split_rows<D, R, kThreads>(gs, glo, tid);
    __syncthreads();
    const float* lse_s = vec + st * 2 * R;
    const float* dl_s = lse_s + R;

    // S^T = k q^T and dP^T = v dO^T: rows are keys, columns queries
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
    for (int kk = 0; kk < D; kk += 8) {
      const OpA ak = load_a(kw + kk, LD, gr, tc);
      const OpA av = load_a(vw + kk, LD, gr, tc);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int at = j * 8 * LD + kk;
        mma3(s[j], ak, load_b_t(qs + at, qlo + at, LD, gr, tc));
        mma3(dp[j], av, load_b_t(gs + at, glo + at, LD, gr, tc));
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
    // dv += P^T dO, dk += ds^T q over this warp's output columns
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const OpA ap = acc_as_a(s[j]);
      const OpA ads = acc_as_a(dp[j]);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int at = j * 8 * LD + c0 + n * 8;
        mma3(dv_acc[n], ap, load_b_perm(gs + at, glo + at, LD, gr, tc));
        mma3(dk_acc[n], ads, load_b_perm(qs + at, qlo + at, LD, gr, tc));
      }
    }
    __syncthreads();  // the next iteration refills this stage
    qt = nxt;
  }
  cp_wait<0>();

  float* dkb = dk + (int64_t)bh * tk * D;
  float* dvb = dv + (int64_t)bh * tk * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + m0 + gr + h * 8;
    if (key >= tk) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int64_t at = (int64_t)key * D + c0 + n * 8 + 2 * tc;
      *reinterpret_cast<float2*>(dkb + at) = make_float2(
          dk_acc[n][2 * h] * scale, dk_acc[n][2 * h + 1] * scale);
      *reinterpret_cast<float2*>(dvb + at) =
          make_float2(dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
    }
  }
}

struct Args {
  const float *q, *k, *v, *g, *lse, *delta;
  float *dq, *dk, *dv;
  int64_t bh;
  int tq, tk;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int D>
int launch_dq(const Args& a) {
  using T = DqTile<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)T::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.tq + T::R - 1) / T::R, (unsigned)a.bh);
  flash_bwd_dq_kernel<D><<<grid, T::kThreads, T::kSmem, a.stream>>>(
      a.q, a.k, a.v, a.g, a.lse, a.delta, a.dq, a.tq, a.tk, a.scale,
      a.causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const Args& a) {
  using T = DkvTile<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)T::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.tk + T::C - 1) / T::C, (unsigned)a.bh);
  flash_bwd_dkv_kernel<D><<<grid, T::kThreads, T::kSmem, a.stream>>>(
      a.q, a.k, a.v, a.g, a.lse, a.delta, a.dk, a.dv, a.tq, a.tk, a.scale,
      a.causal);
  return (int)cudaGetLastError();
}

template <int (*F64)(const Args&), int (*F128)(const Args&),
          int (*F256)(const Args&)>
int by_head_dim(const Args& a, int d) {
  if (a.tq < 1 || a.tk < 1) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 64:
      return F64(a);
    case 128:
      return F128(a);
    case 256:
      return F256(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* g,
               const void* lse, const void* delta, int64_t bh, int tq, int tk,
               float scale, int causal, void* stream) {
  Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.g = static_cast<const float*>(g);
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

}  // namespace

// All pointers fp32 device pointers, contiguous: q, g (dO), dq [bh, tq, d];
// k, v, dk, dv [bh, tk, d]; lse, delta [bh, tq]. q, k, v, g, dq, dk and dv
// 16-byte aligned (cp.async and float2 stores). d in {64, 128, 256}.
// Each returns cudaGetLastError() of its launch (or of the shared-memory
// attribute call); 1 (cudaErrorInvalidValue) for a shape the kernels do not
// take.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* g,
                                      const void* lse, const void* delta,
                                      void* dq, int64_t bh, int tq, int tk,
                                      int d, float scale, int causal,
                                      void* stream) {
  Args a = make_args(q, k, v, g, lse, delta, bh, tq, tk, scale, causal,
                     stream);
  a.dq = static_cast<float*>(dq);
  return by_head_dim<launch_dq<64>, launch_dq<128>, launch_dq<256>>(a, d);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* g,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int64_t bh, int tq,
                                       int tk, int d, float scale, int causal,
                                       void* stream) {
  Args a = make_args(q, k, v, g, lse, delta, bh, tq, tk, scale, causal,
                     stream);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  return by_head_dim<launch_dkv<64>, launch_dkv<128>, launch_dkv<256>>(a, d);
}
