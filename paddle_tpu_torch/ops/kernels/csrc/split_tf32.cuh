// Split-TF32 products on the tensor cores for Hopper (sm_90a), and the
// cp.async staging that feeds them: the helpers that the flash-attention
// kernels (flash_attention.cu, flash_attention_bwd.cu), the attention
// block's backward (attention_block.cu) and the shared product
// (tile_mma.cuh) build on.
//
// Split TF32. The port's kernels are held to fp32 (1e-5 of the largest
// |grad|, 2e-5 of an attention output), which one TF32 product (11-bit
// significands) misses by two orders. Each fp32 operand x is split into
// big = tf32(x) and small = tf32(x - big) (rounded to nearest, ties away,
// with two integer instructions), and a product is small*big + big*small
// + big*big (small*small, ~2^-22 of it, dropped): three
// mma.sync.m16n8k8 TF32 products for each fp32 product. The three
// products of one 8-deep step go into a fresh fragment that is then added
// to the running sum with an fp32 add: the tensor cores' own accumulation
// truncates, and chaining the steps through it moves the results by
// several times the fp32 error.
//
// Fragment layouts of mma.sync.m16n8k8 (PTX ISA; lane = 4 g + t):
//   A 16x8: a0 (row g, k t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B 8x8:  b0 (k t, col g), b1 (k t+4, col g)
//   C 16x8: c0 (row g, col 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
// An accumulator fragment holds columns 2t and 2t+1 of a row where an A
// fragment wants t and t+4, so a product fed from an accumulator permutes
// its k index (slot t <- column 2t, slot t+4 <- column 2t+1) and reads its
// B operand in the same order (acc_as_a, load_b_perm): no shuffle.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace split_tf32 {

// row padding, floats, of a tile whose rows run along k: g * (n + 4) + t
// hits 32 distinct banks, and so do the transposed reads of 2t or t rows
constexpr int kPad = 4;

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

// An operand read from a tile split once as it landed (split_rows): its
// big halves in place, its small halves at the same offsets in a second
// buffer; hi and lo point at the same element of each.
template <int N>
__device__ __forceinline__ void pick(Operand<N>& o, int i, const float* hi,
                                     const float* lo, int at) {
  o.big[i] = __float_as_uint(hi[at]);
  o.small[i] = __float_as_uint(lo[at]);
}

// A = M[m0:m0+16, k0:k0+8] of a split row-major M [m][k] at &M[m0][k0]
__device__ __forceinline__ OpA load_a_split(const float* hi, const float* lo,
                                            int ld, int g, int t) {
  OpA a;
  pick(a, 0, hi, lo, g * ld + t);
  pick(a, 1, hi, lo, (g + 8) * ld + t);
  pick(a, 2, hi, lo, g * ld + t + 4);
  pick(a, 3, hi, lo, (g + 8) * ld + t + 4);
  return a;
}

// A = M^T for a split row-major M [k][m] at &M[k0][m0]: A(m, k) = M[k][m]
__device__ __forceinline__ OpA load_a_t(const float* hi, const float* lo,
                                        int ld, int g, int t) {
  OpA a;
  pick(a, 0, hi, lo, t * ld + g);
  pick(a, 1, hi, lo, t * ld + g + 8);
  pick(a, 2, hi, lo, (t + 4) * ld + g);
  pick(a, 3, hi, lo, (t + 4) * ld + g + 8);
  return a;
}

// B = M for a split row-major M [k][n] at &M[k0][n0]
__device__ __forceinline__ OpB load_b(const float* hi, const float* lo,
                                      int ld, int g, int t) {
  OpB b;
  pick(b, 0, hi, lo, t * ld + g);
  pick(b, 1, hi, lo, (t + 4) * ld + g);
  return b;
}

// B = M^T for a split row-major M [n][k] at &M[n0][k0]: B(k, n) = M[n][k]
__device__ __forceinline__ OpB load_b_t(const float* hi, const float* lo,
                                        int ld, int g, int t) {
  OpB b;
  pick(b, 0, hi, lo, g * ld + t);
  pick(b, 1, hi, lo, g * ld + t + 4);
  return b;
}

// B = M for a split row-major M [k][n] at &M[k0][n0], k permuted as in
// acc_as_a
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
// 16 bytes to shared memory, of which the first `bytes` (0-16) are read
// from src and the rest zero-filled
__device__ __forceinline__ void cp16n(void* dst, const void* src,
                                      int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool in) {
  cp16n(dst, src, in ? 16 : 0);
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

// rows [r0, r0 + N) of a row-major matrix g (row stride ld) into s [N][LD],
// columns [0, width) of each (width a multiple of a 16-byte chunk, the row
// starts 16-byte aligned) and zeros in [width, D); rows at or past `limit`
// are zero-filled. E is the element type (fp32 or bf16).
template <int D, int N, int THREADS, int LD, typename E>
__device__ __forceinline__ void load_tile(E* s, const E* g, int64_t ld,
                                          int r0, int limit, int width,
                                          int tid) {
  constexpr int kVec = 16 / sizeof(E);  // elements a 16-byte chunk
  constexpr int kChunks = D / kVec;     // 16-byte chunks a row
  static_assert(N * kChunks % THREADS == 0, "whole rounds of chunks");
  static_assert(LD * sizeof(E) % 16 == 0, "rows on 16-byte boundaries");
#pragma unroll
  for (int n = 0; n < N * kChunks / THREADS; ++n) {
    const int i = tid + n * THREADS;
    const int r = i / kChunks, c = (i % kChunks) * kVec;
    const bool in = r0 + r < limit && c < width;
    cp16(s + r * LD + c, g + (in ? (r0 + r) * ld + c : 0), in);
  }
}

// rows [r0, r0 + N) of a contiguous row-major [*, D] matrix
template <int D, int N, int THREADS, int LD, typename E>
__device__ __forceinline__ void load_rows(E* s, const E* g, int r0,
                                          int limit, int tid) {
  load_tile<D, N, THREADS, LD>(s, g, D, r0, limit, D, tid);
}

// after load_tile<D, N, THREADS, LD> into s has landed: each thread splits
// the chunks it copied itself (so no barrier is needed first), the big
// halves in place and the small ones into lo
template <int D, int N, int THREADS, int LD = D + kPad>
__device__ __forceinline__ void split_rows(float* s, float* lo, int tid) {
  constexpr int kChunks = D / 4;
#pragma unroll
  for (int n = 0; n < N * kChunks / THREADS; ++n) {
    const int i = tid + n * THREADS;
    const int at = i / kChunks * LD + (i % kChunks) * 4;
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

}  // namespace split_tf32
