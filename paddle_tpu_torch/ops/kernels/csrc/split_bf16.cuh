// bf16 products on Hopper's tensor cores (sm_90a), and the operand traits
// that let one attention body run in fp32 (split TF32, split_tf32.cuh), in
// bf16, or on bf16 planes: flash_fwd.cuh (#2 at d 256 in bf16, #5),
// flash_attention_bwd.cu (#3, #4) and attn_bwd_from_p.cuh (#6 in fp32,
// #11) take their operands through Mma<E>; attn_wgmma.cuh (#2 at d 64 and
// 128 and #6 in bf16, on wgmma) takes the hi/lo split.
//
// The TPU kernels take bf16 q, k, v and dO, upcast them and compute in
// fp32 (paddle_tpu/ops/pallas/attention.py: `.astype(jnp.float32)` on
// every block). On Hopper a product of two bf16 inputs (q k^T, dO v^T)
// goes straight to mma.sync.m16n8k16 bf16 with fp32 accumulation: each
// product of two bf16 values is exact in fp32, as after the TPU's upcast.
// A product whose A operand is an fp32 intermediate (P in P v, dS in dS k
// and dS^T q, P^T in P^T dO) must not simply round it to bf16, which moves
// the result by one bf16 ulp everywhere: the operand is split into a bf16
// high part hi = bf16(x) and a low part lo = bf16(x - hi) (x - hi is exact
// in fp32; hi + lo is within 2^-17 of x), and the product is hi b + lo b,
// two MMAs against split TF32's three; the B operand, a bf16 input, is
// exact in one part.
// As in split_tf32.cuh, the MMAs of one step go into a fresh fragment
// added to the running sum in fp32.
//
// Planes (Mma<split_bf16::planes>, the bf16 attention block's backward
// stages, #11): every operand is an fp32 intermediate kept as its two bf16
// planes, in device memory one plane `plane` elements after the other (hi
// then lo, as wgmma_bf16.cuh's epilogues write them), in a staged row side
// by side (hi in columns [0, DP), lo in [DP, 2 DP), one padding after
// both). A product takes hi hi, hi lo and lo hi (lo lo, ~2^-18 of it,
// dropped): three MMAs a 16-deep step, against split TF32's three 8-deep
// ones. The saved fp32 P and dS enter split into their two planes.
//
// Fragment layouts of mma.sync.m16n8k16 .bf16 (PTX ISA; lane = 4 g + t;
// each register holds two elements, the lower k in the low 16 bits):
//   A 16x16: a0 (row g, k 2t..2t+1), a1 (g+8, 2t..2t+1), a2 (g, 2t+8..2t+9),
//            a3 (g+8, 2t+8..2t+9)
//   B 16x8:  b0 (k 2t..2t+1, col g), b1 (k 2t+8..2t+9, col g)
//   C 16x8:  as m16n8k8: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8)
// Two neighbouring accumulator fragments (columns 8j.. and 8j+8..) hold
// exactly an A fragment's 16-deep k range, so an fp32 intermediate goes
// back into a product with no permutation, and its B operand is read in
// its natural k order.
//
// Staged bf16 tiles are rows of D elements (planes: 2 D) padded by 8 (16
// bytes): the 32-bit fragment reads g (D + 8) / 2 + t hit 32 distinct
// banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "split_tf32.cuh"

namespace split_bf16 {

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;  // row padding, elements (16 bytes)

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (x, y) rounded to bf16 as one register, x in the low half
__device__ __forceinline__ uint32_t pack(float x, float y) {
  return bits(__floats2bfloat162_rn(x, y));
}

// (x, y) split: hi = bf16(x, y), lo = bf16 of what hi leaves; hi's
// values read back by a shift and a mask (a bf16 is the high half of its
// fp32), two instructions where __bfloat1622float2 takes four
__device__ __forceinline__ void split(uint32_t& hi, uint32_t& lo, float x,
                                      float y) {
  hi = pack(x, y);
  lo = pack(x - __uint_as_float(hi << 16),
            y - __uint_as_float(hi & 0xffff0000u));
}

// two bf16 elements that are not neighbours in memory, as one register
__device__ __forceinline__ uint32_t join(const bf16* lo_k, const bf16* hi_k) {
  return (uint32_t) * reinterpret_cast<const uint16_t*>(lo_k) |
         (uint32_t) * reinterpret_cast<const uint16_t*>(hi_k) << 16;
}

__device__ __forceinline__ uint32_t word(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The element type of an fp32 intermediate kept as two bf16 planes (see
// the note at the top): a bf16 of the hi plane, whose lo partner lies a
// plane further in device memory and DP columns further in a staged row.
struct planes {
  bf16 x;
};

}  // namespace split_bf16

// ---------------------------------------------------------------------------
// Mma<E>: what an attention body asks of its element type E.
//   A      an operand from an input tile, exact (fp32: split as read)
//   AccA   an operand from fp32 accumulator fragments, split
//   kK     depth of one product step: 8 (TF32) or 16 (bf16), i.e. kK / 8
//          accumulator fragments make one AccA
//   load_a(p, ld)        A = M[m0:m0+16, k0:k0+kK] of a row-major M at p
//   load_b_t(hi, lo, ld) B(k, n) = M[n][k] of a staged row-major M [n][k]
//   load_b_acc(hi, lo, ld) B(k, n) = M[k][n] of a staged row-major
//                        M [k][n], in the k order of acc_as_a
//   acc_as_a(c)          AccA from fragments c[0 .. kK / 8)
//   exact_as_a(c)        A from fragments holding a saved P (fp32 and
//                        planes only: split TF32, or its two planes)
//   mma(acc, A|AccA, B)  acc += a b, in a fresh fragment added in fp32
//   store2(p, x, y)      two neighbouring results into memory (planes:
//                        store2(p, plane, x, y), hi at p, lo a plane on)
//   kPlanes              values a staged row holds per column: 2 for
//                        planes (hi, then lo DP columns on), else 1
//   PType, load(p)       the saved P's element type (fp32 and planes
//                        only: fp32) and a read of one of its values
// Staged tiles: rows padded by kPad elements; in fp32 each tile is split
// once as it lands (split_rows, its small halves in a second buffer, kLo
// tiles of them), in bf16 and planes it is used as it lands.
// ---------------------------------------------------------------------------
namespace attn_mma {

template <typename E>
struct Mma;

template <>
struct Mma<float> {
  using A = split_tf32::OpA;
  using AccA = split_tf32::OpA;
  using B = split_tf32::OpB;
  static constexpr int kK = 8;
  static constexpr int kPad = split_tf32::kPad;
  static constexpr int kLo = 1;  // a small-halves tile per staged tile
  static constexpr int kPlanes = 1;  // values a staged row holds per column
  using PType = float;               // the saved P's element type

  static __device__ __forceinline__ A load_a(const float* p, int ld, int g,
                                             int t) {
    return split_tf32::load_a(p, ld, g, t);
  }
  static __device__ __forceinline__ B load_b_t(const float* hi,
                                               const float* lo, int ld,
                                               int g, int t) {
    return split_tf32::load_b_t(hi, lo, ld, g, t);
  }
  static __device__ __forceinline__ B load_b_acc(const float* hi,
                                                 const float* lo, int ld,
                                                 int g, int t) {
    return split_tf32::load_b_perm(hi, lo, ld, g, t);
  }
  static __device__ __forceinline__ AccA acc_as_a(const float (*c)[4]) {
    return split_tf32::acc_as_a(c[0]);
  }
  static __device__ __forceinline__ A exact_as_a(const float (*c)[4]) {
    return split_tf32::acc_as_a(c[0]);
  }
  static __device__ __forceinline__ void mma(float (&acc)[4], const A& a,
                                             const B& b) {
    split_tf32::mma3(acc, a, b);
  }
  template <int D, int N, int THREADS, int LD>
  static __device__ __forceinline__ void split_rows(float* s, float* lo,
                                                    int tid) {
    split_tf32::split_rows<D, N, THREADS, LD>(s, lo, tid);
  }
  static __device__ __forceinline__ void store2(float* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float zero() { return 0.f; }
};

template <>
struct Mma<__nv_bfloat16> {
  using bf16 = __nv_bfloat16;
  struct A {
    uint32_t x[4];
  };
  struct AccA {
    uint32_t hi[4], lo[4];
  };
  struct B {
    uint32_t x[2];
  };
  static constexpr int kK = 16;
  static constexpr int kPad = split_bf16::kPad;
  static constexpr int kLo = 0;
  static constexpr int kPlanes = 1;

  static __device__ __forceinline__ A load_a(const bf16* p, int ld, int g,
                                             int t) {
    using split_bf16::word;
    return A{{word(p + g * ld + 2 * t), word(p + (g + 8) * ld + 2 * t),
              word(p + g * ld + 2 * t + 8),
              word(p + (g + 8) * ld + 2 * t + 8)}};
  }
  static __device__ __forceinline__ B load_b_t(const bf16* hi, const bf16*,
                                               int ld, int g, int t) {
    using split_bf16::word;
    return B{{word(hi + g * ld + 2 * t), word(hi + g * ld + 2 * t + 8)}};
  }
  static __device__ __forceinline__ B load_b_acc(const bf16* hi, const bf16*,
                                                 int ld, int g, int t) {
    using split_bf16::join;
    return B{{join(hi + 2 * t * ld + g, hi + (2 * t + 1) * ld + g),
              join(hi + (2 * t + 8) * ld + g, hi + (2 * t + 9) * ld + g)}};
  }
  static __device__ __forceinline__ AccA acc_as_a(const float (*c)[4]) {
    AccA a;
    split_bf16::split(a.hi[0], a.lo[0], c[0][0], c[0][1]);
    split_bf16::split(a.hi[1], a.lo[1], c[0][2], c[0][3]);
    split_bf16::split(a.hi[2], a.lo[2], c[1][0], c[1][1]);
    split_bf16::split(a.hi[3], a.lo[3], c[1][2], c[1][3]);
    return a;
  }
  static __device__ __forceinline__ void mma(float (&acc)[4], const A& a,
                                             const B& b) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    split_bf16::mma(t, a.x, b.x);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += t[i];
  }
  static __device__ __forceinline__ void mma(float (&acc)[4], const AccA& a,
                                             const B& b) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    split_bf16::mma(t, a.lo, b.x);
    split_bf16::mma(t, a.hi, b.x);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += t[i];
  }
  template <int D, int N, int THREADS, int LD>
  static __device__ __forceinline__ void split_rows(bf16*, bf16*, int) {}
  static __device__ __forceinline__ void store2(bf16* p, float x, float y) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  }
  static __device__ __forceinline__ bf16 zero() {
    return __float2bfloat16(0.f);
  }
};

template <>
struct Mma<split_bf16::planes> {
  using bf16 = __nv_bfloat16;
  using E = split_bf16::planes;
  struct A {
    uint32_t hi[4], lo[4];
  };
  using AccA = A;
  struct B {
    uint32_t hi[2], lo[2];
  };
  static constexpr int kK = 16;
  static constexpr int kPad = split_bf16::kPad;
  static constexpr int kLo = 0;
  static constexpr int kPlanes = 2;
  using PType = float;

  static __device__ __forceinline__ const bf16* bits(const E* p) {
    return reinterpret_cast<const bf16*>(p);
  }
  // columns from a staged row's hi value to its lo partner: the row is
  // 2 DP + kPad wide
  static __device__ __forceinline__ int lo_at(int ld) {
    return (ld - kPad) / 2;
  }
  static __device__ __forceinline__ void a_from(uint32_t (&r)[4],
                                                const bf16* p, int ld, int g,
                                                int t) {
    using split_bf16::word;
    r[0] = word(p + g * ld + 2 * t);
    r[1] = word(p + (g + 8) * ld + 2 * t);
    r[2] = word(p + g * ld + 2 * t + 8);
    r[3] = word(p + (g + 8) * ld + 2 * t + 8);
  }
  static __device__ __forceinline__ A load_a(const E* p, int ld, int g,
                                             int t) {
    A a;
    a_from(a.hi, bits(p), ld, g, t);
    a_from(a.lo, bits(p) + lo_at(ld), ld, g, t);
    return a;
  }
  static __device__ __forceinline__ B load_b_t(const E* hi, const E*, int ld,
                                               int g, int t) {
    using split_bf16::word;
    const bf16* h = bits(hi);
    const bf16* l = h + lo_at(ld);
    return B{{word(h + g * ld + 2 * t), word(h + g * ld + 2 * t + 8)},
             {word(l + g * ld + 2 * t), word(l + g * ld + 2 * t + 8)}};
  }
  static __device__ __forceinline__ B load_b_acc(const E* hi, const E*,
                                                 int ld, int g, int t) {
    using split_bf16::join;
    const bf16* h = bits(hi);
    const bf16* l = h + lo_at(ld);
    return B{{join(h + 2 * t * ld + g, h + (2 * t + 1) * ld + g),
              join(h + (2 * t + 8) * ld + g, h + (2 * t + 9) * ld + g)},
             {join(l + 2 * t * ld + g, l + (2 * t + 1) * ld + g),
              join(l + (2 * t + 8) * ld + g, l + (2 * t + 9) * ld + g)}};
  }
  static __device__ __forceinline__ AccA acc_as_a(const float (*c)[4]) {
    AccA a;
    split_bf16::split(a.hi[0], a.lo[0], c[0][0], c[0][1]);
    split_bf16::split(a.hi[1], a.lo[1], c[0][2], c[0][3]);
    split_bf16::split(a.hi[2], a.lo[2], c[1][0], c[1][1]);
    split_bf16::split(a.hi[3], a.lo[3], c[1][2], c[1][3]);
    return a;
  }
  // the saved fp32 P enters as its two planes too
  static __device__ __forceinline__ A exact_as_a(const float (*c)[4]) {
    return acc_as_a(c);
  }
  static __device__ __forceinline__ void mma(float (&acc)[4], const A& a,
                                             const B& b) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    split_bf16::mma(t, a.lo, b.hi);
    split_bf16::mma(t, a.hi, b.lo);
    split_bf16::mma(t, a.hi, b.hi);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += t[i];
  }
  template <int D, int N, int THREADS, int LD>
  static __device__ __forceinline__ void split_rows(E*, E*, int) {}
  // (x, y) as planes: hi at p, lo `plane` elements on
  static __device__ __forceinline__ void store2(E* p, int64_t plane, float x,
                                                float y) {
    uint32_t hi, lo;
    split_bf16::split(hi, lo, x, y);
    *reinterpret_cast<uint32_t*>(p) = hi;
    *reinterpret_cast<uint32_t*>(p + plane) = lo;
  }
  static __device__ __forceinline__ float load(const float* p) { return *p; }
};

}  // namespace attn_mma
