// The bf16 attention kernels #2-#6 for Hopper (sm_90a), on
// wgmma.mma_async fed by TMA (hopper.cuh), at head widths d 64 and 128:
// - #2, the flash forward (flash_attention.cu `flash_attention_fwd_bf16`):
//   `fwd_kernel`;
// - #5, the short-sequence forward (sdpa_short.cu `sdpa_short_fwd_bf16`):
//   `fwd_kernel` at tq == tk, and with P asked for, `p_kernel` after it;
// - #3, the flash backward's dq (flash_attention_bwd.cu
//   `flash_attention_bwd_dq_bf16`): `flash_dq_kernel`;
// - #4, the flash backward's dk and dv (flash_attention_bwd.cu
//   `flash_attention_bwd_dkv_bf16`): `flash_dkv_kernel`;
// - #6, the short-sequence backward from the saved P (sdpa_short_bwd.cu
//   `sdpa_short_bwd_bf16`): `dq_kernel`, then `dkv_kernel`.
// d 256 (#2, #3 and #4 only) keeps the mma.sync bodies (flash_fwd.cuh,
// split_bf16.cuh `Mma<E>`), a dispatch by d; fp32 inputs keep the split-TF32
// kernels.
//
// Replaces, on the bf16 path: paddle_tpu/ops/pallas/attention.py
// `_flash_fwd_impl` / `_fwd_kernel` (#2), `_bwd_dq_kernel` (#3),
// `_bwd_dkv_kernel` (#4), `_sdpa_short_fwd_impl` (#5) and
// `_sdpa_short_bwd_impl` (#6), which upcast their bf16 blocks and compute
// in fp32.
//
// The bf16 contract of the port's attention kernels: a product of two
// bf16 inputs (q k^T, dO v^T, v dO^T, P^T dO with the saved bf16 P) is
// one wgmma a 16-deep step, each product exact in fp32 as after the TPU
// kernel's upcast; an fp32 intermediate fed to a product (P in P v and
// in #4's P^T dO, dS in dS k and dS^T q) enters as two bf16 planes made
// in registers, hi = bf16(x) and lo = bf16(x - hi), within 2^-17 of x:
// two RS wgmmas (A from registers) a step. Every
// wgmma chain starts in a fresh fp32 accumulator at most 256 terms deep
// (a key or query tile, both planes counted), added to the running sum in
// fp32 once it has retired. Sums run in a fixed order with no atomics:
// two launches give the same bits.
//
// Every kernel: one block an SM, two consumer warpgroups (64 rows each)
// and one producer warp whose first thread keeps TMA loads in flight into
// a ring of stages in shared memory behind mbarriers (a full barrier a
// stage, completed by the producer's arrivals and TMA's transaction
// count; an empty barrier the 8 consumer warps release once the wgmmas
// that read the stage have retired). Tiles are slabs of 64 bf16 columns
// with the 128-byte swizzle (hopper.cuh); the tensors are 3-d maps
// [BH][T][D], so rows past T arrive as zeros. Results go out through
// shared memory in 16-byte chunks of whole rows, rows past T skipped.
//
// #2, the forward (`fwd_kernel`): out = softmax(scale q k^T [+ causal
// mask]) v for q [BH, tq, D], k, v [BH, tk, D], and the fp32 per-row lse
// [BH, tq] that #3 and #4 read. The grid persists: a block per SM walks
// the items (bh, 128 query rows) in a fixed order (under causal masking
// the longest items first), the producer running
// on into the next item's q (two q buffers) and key tiles while the
// consumers finish an item. K and V tiles of KT keys (128 at D 64; 64 at
// D 128, whose wider output leaves no room for more) stream through a
// 4-stage ring. S = q k^T runs SS (q and k K-major) into fp32; the mask
// and the online softmax run on the accumulator fragments in the log2
// domain, the scale inside the ex2's FFMA where a tile needs no mask (one
// FFMA and one ex2 a score); P's planes feed O += P v as two RS wgmmas (V
// MN-major), 64 output columns at a time into a fresh 64-column
// accumulator. Causal masking is bottom-right aligned: query i sees keys
// <= i + tk - tq. A masked score takes -FLT_MAX, a key past tk -inf, so a
// fully masked row (tq > tk) gives the mean of v (the port's C5 rule) and
// its lse -FLT_MAX. Causal tiles past an item's last visible key are not
// fetched, and a warpgroup skips the products of a tile past its own
// rows' horizon. out / l is rounded to bf16 once.
//
// #5 (tq == tk <= 512, #2's causal offset tk - tq then 0): without P,
// `fwd_kernel` with no lse. With P, two grids: `fwd_kernel` writing the lse
// into a scratch, then `p_kernel`, P = ex2(S c - lse log2e) [BH, t, t]
// bf16 with the row's final max and sum, on #2's persistent items and
// ring (K tiles alone): S = q k^T again (SS), P staged by each warp in
// one of its two tiles of shared memory and written by TMA stores that
// drain while it computes the next tile (2-byte stores where t % 8 != 0,
// P's rows then lying off 16 bytes); tiles past a warpgroup's causal
// horizon written as zeros with no product. The output is #2's, the same
// bits with P and without. Measured and given up on an H100: P swept in
// the forward's own blocks after each item's key loop (0.1726 ms at [32,
// 8, 512, 64], against 0.1408 for the two grids: more spills in the key
// loop, and the sweep's products, exponentials and stores not overlapped),
// a P grid of 64-key tiles with the next tile's S issued before this
// tile's exponentials (its grid 0.0827 ms against 0.0689), and one of
// 64-key tiles at two blocks an SM (0.0678, causal 0.0732 against
// 0.0697).
//
// #4, the flash backward's dk and dv (`flash_dkv_kernel`): #6's grid 2
// with P recomputed from the lse, P^T = ex2(S^T c - lse log2e): a block
// per (bh, 128 keys at D 64, 64 at D 128), k and v resident, 64-row query
// tiles of q and dO by TMA with their lse and delta rows (bulk copies
// where tq % 4 == 0, else gathered by the producer warp); S^T and dP^T
// SS in one group; P^T and dS^T on the fragments (masks by index: padding,
// causal bottom-right, a query that sees no key P = 1 / tk and dS = 0);
// dv += P^T dO and dk += dS^T q as two RS wgmmas each (P is an fp32
// intermediate here, not a saved bf16 P), into chains of two query tiles
// that retire into fp32 running sums in shared memory: a thread holds the
// two chains and S^T, dP^T (128 registers), not two running sums besides.
// 6 products as run against the function's 4.
//
// #3, the flash backward's dq (`flash_dq_kernel`): #6's grid 1 with P
// recomputed from the lse, as #4 takes it, on #2's persistent grid and
// items (the longest causal items first; the producer loads the next
// item's q and dO into a second buffer while the consumers finish one):
// an item is (bh, 128 query rows at D 64, 64 at D 128), q and dO
// resident by TMA, each consumer thread's two rows of lse and delta
// loaded into its registers (any tq, any alignment: they are not
// streamed), 64-key tiles of k and v through the ring. S = q k^T and dP =
// dO v^T run SS in one group; P = ex2(S c - lse log2e) and dS = P (dP -
// delta) on the fragments (masks by index, as #4's: a row that sees no
// key has dS 0 on every key, so dq 0); dq += dS k as two RS wgmmas (hi,
// lo; k MN-major) into a fresh chain a key tile (128 terms) retired into
// an fp32 running sum in registers: with 64-key tiles a thread holds S,
// dP and the sum (96 registers) and then the planes, the chain and the
// sum, where 128-key tiles would leave no room for the sum beside S and
// dP, and a chain of two tiles kept live across S and dP spilled (168
// registers, 72 bytes at d 64). dq is scaled once and rounded to bf16
// once. 4 products as run against the function's 3.
//
// #6, the backward from the saved P (`dq_kernel`, `dkv_kernel`), as the
// TPU kernel computes it: dv = P^T dO, dP = dO v^T, delta = rowsum(dP P),
// dS = P (dP - delta), dq = scale dS k, dk = scale dS^T q; no exp, no O.
// P is [BH, T, T] bf16 (exact in one bf16 part), T <= 512, D 64 or 128.
// - Grid 1, dq and delta: one block per (bh, 128 queries at D 64, 64 at
//   D 128); dO resident. A first sweep over 128-key tiles of v and P forms
//   dP = dO v^T (SS) and sums dP P into each row's delta (fp32, in
//   registers, in tile order; written to the scratch for grid 2). A
//   second sweep over tiles of v, k and P forms dP again, dS = P (dP -
//   delta) on its fragments, and dq += dS k as two RS wgmmas (hi, lo; k
//   MN-major). A block's P rows (128 KB at T 512) come from L2 on the
//   second read.
// - Grid 2, dk and dv: one block per (bh, 128 keys at D 64, 64 at D 128);
//   v resident. It streams 64-row query tiles of dO, q, the [64 x 128] (or
//   [64 x 64]) tile of P and delta. dP^T = v dO^T runs SS; dv += P^T dO
//   runs SS with P's tile read MN-major (the transposed view needs no
//   pass); dS^T = P^T (dP^T - delta) is formed on the fragments, P^T read
//   from the swizzled tile, split into planes and fed as two RS wgmmas
//   into dk += dS^T q (q MN-major).
// - At D 128 the two warpgroups of a block take the same 64 rows (grid 1)
//   or keys (grid 2) and 64 output columns each, so that a thread holds a
//   64-column accumulator and its fresh partner; the shared product (dP or
//   dP^T) is formed by both.
// - Causal: grid 1 stops at the block's last row, grid 2 starts at the
//   block's first key: P is 0 beyond.
// - P's rows are 2T bytes apart, which TMA takes only when T % 8 == 0. At
//   any other T (a ragged T, 1-511) the producer warp gathers P's tile
//   itself, 16 bytes of the swizzled layout a lane at a time from 2-byte
//   loads (cp.async needs a 4-byte-aligned source, which an odd T does not
//   give), zeros past T, then fences them for the async proxy before its
//   arrival on the stage's full barrier. The same kernels run; nothing
//   falls back.
//
// What bounds them on an H100 (bf16 989 TFLOP/s, 3.35 TB/s): #2 at
// [16, 8, 1024, 64] does 34.4 GFLOP of products (51.5 as run: P v twice)
// on 34 MB, 0.035 ms by its operations; #5 at [32, 8, 512, 64] 17.2
// GFLOP on 34 MB (0.020 ms by its bytes), with P 201 MB (0.060 ms), P's
// 134 MB written once; #3 at [16, 8, 1024, 64] 51.5 GFLOP (68.7 as run),
// 0.0521 ms by its operations; #4 there 68.7 GFLOP (103 as run),
// 0.0695 ms by its operations; #6 at [32, 8, 512, 64] the
// function's 34.4 GFLOP (68.7 as run: dP three times, dq and dk twice) on
// 134 MB of P and 117 MB of the rest, 0.075 ms by its bytes (P is read
// three times as run: 0.12 ms at the memory's rate, the second read from
// L2). Only wgmma reaches the bf16 rate. As built, #2 is bound by the
// consumers' CUDA-core work (7 instructions a score as written: the max,
// the FFMA, the ex2, the row sum and 3 for the hi/lo split), which runs
// beside the other warpgroup's products but not beside its own. Measured on an H100
// and given up: taking turns on the tensor cores (ping-pong), a 64-key
// tile with the next tile's S issued beside the last tile's P v, and
// setmaxnreg (ptxas kept the consumers at 168 registers), each slower.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "split_bf16.cuh"

namespace attn_wgmma {

using bf16 = __nv_bfloat16;
using hopper::desc;
using hopper::desc_at;
using hopper::fence_acc;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::Operand;
using hopper::smem_u32;
using hopper::swz;
using hopper::tma_load;
using hopper::wg_commit;
using hopper::wg_fence;
using hopper::wg_wait;
using hopper::wgmma_rs;
using hopper::wgmma_ss;
using split_bf16::pack;
using split_bf16::split;

constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kSlab = 8192;                // 64 rows of a slab, bytes
constexpr int kSmemLimit = 220 * 1024;     // a block's ring and tiles
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float2 bf2(uint32_t w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

__device__ __forceinline__ float bf1(const uint8_t* p) {
  return __uint_as_float((uint32_t)*reinterpret_cast<const uint16_t*>(p)
                         << 16);
}

// the planes of accumulator x's columns 16 s .. 16 s + 15 as the A operand
// of step s (hopper.cuh: d[8 s .. 8 s + 7] in pairs)
template <int NX>
__device__ __forceinline__ void planes_of(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                          const float (&x)[NX], int s) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    split(hi[i], lo[i], x[8 * s + 2 * i], x[8 * s + 2 * i + 1]);
}

// Stage a warpgroup's 64 x 64 fp32 accumulator d (times mul) as bf16 into
// the swizzled slab at stg: element (r, c) at swz(r, c)
__device__ __forceinline__ void stage_acc(uint8_t* stg, const float (&d)[32],
                                          float mul, int warp, int lane) {
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(stg + swz(16 * warp + g + 8 * h,
                                             8 * j + 2 * t4)) =
          pack(d[4 * j + 2 * h] * mul, d[4 * j + 2 * h + 1] * mul);
}

// Write 64 staged rows of 64 bf16 (a swizzled slab) in 16-byte chunks to
// out (row r at out + r * ld), rows at or past `rows` skipped
__device__ __forceinline__ void store_slab(bf16* out, int64_t ld,
                                          const uint8_t* stg, int rows,
                                          int lt) {
#pragma unroll
  for (int st = 0; st < 4; ++st) {
    const int i = lt + 128 * st, r = i / 8, c8 = i % 8;
    if (r < rows)
      *reinterpret_cast<uint4*>(out + r * ld + 8 * c8) =
          *reinterpret_cast<const uint4*>(stg + r * 128 +
                                          ((c8 ^ (r & 7)) << 4));
  }
}

// A tile of a row-major [t, t] bf16 matrix that TMA cannot describe (t %
// 8 != 0): rows [row0, row0 + ROWS) x columns [col0, col0 + COLS) into the
// slabs of dst (64 columns each, ROWS rows a slab), zeros outside the
// matrix, gathered by the 32 lanes of a warp from 2-byte loads
template <int ROWS, int COLS>
__device__ __forceinline__ void gather_tile(uint8_t* dst, const bf16* p, int t,
                                            int row0, int col0, int lane) {
  const uint16_t* src = reinterpret_cast<const uint16_t*>(p);
  for (int i = lane; i < ROWS * (COLS / 8); i += 32) {
    const int r = i / (COLS / 8), ch = i % (COLS / 8);
    const int row = row0 + r, col = col0 + 8 * ch;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c0 = col + 2 * e;
      const uint32_t x0 =
          row < t && c0 < t ? __ldg(src + (int64_t)row * t + c0) : 0u;
      const uint32_t x1 =
          row < t && c0 + 1 < t ? __ldg(src + (int64_t)row * t + c0 + 1) : 0u;
      w[e] = x0 | x1 << 16;
    }
    *reinterpret_cast<uint4*>(dst + (ch / 8) * ROWS * 128 + r * 128 +
                              (((ch % 8) ^ (r & 7)) << 4)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// the ring starts on 1024 bytes (the swizzle's period)
__device__ __forceinline__ uint8_t* aligned(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// ---------------------------------------------------------------------------
// #2: the flash forward
// ---------------------------------------------------------------------------
// The items (bh, R query rows) of a persistent attention grid: item i's
// head and first query row, i < nbh * nqt. Under causal masking the last
// query tiles, which see the most keys, come first, heads fastest.
struct Items {
  int nqt, nbh, causal;
  __device__ __forceinline__ void at(int i, int r, int& bh, int& q0) const {
    if (causal) {
      bh = i % nbh;
      q0 = (nqt - 1 - i / nbh) * r;
    } else {
      bh = i / nqt;
      q0 = i % nqt * r;
    }
  }
};

template <int D>
struct Fwd {
  static constexpr int R = 128;                  // query rows an item
  static constexpr int KT = D == 64 ? 128 : 64;  // keys a tile
  static constexpr int NS = D / 64;              // slabs of a row
  static constexpr int kQBytes = R * D * 2;      // q of an item; two of them
  static constexpr int kTileBytes = KT * D * 2;  // a K or a V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kStages = 4;
  static constexpr size_t kSmem =
      (size_t)2 * kQBytes + kStages * kStageBytes + 1024;
};

// #2, persistent: block b takes the items (bh, 128 query rows) b, b + G,
// b + 2 G, ... (G blocks, at most one an SM), item i being head i / nqt's
// query tile i % nqt; under causal masking the items with the most key
// tiles (the last query tiles) come first, heads fastest, so that the
// blocks' shares balance (`Items`). The producer runs on into the next
// item's q (two q buffers) and key tiles (one ring across items) while
// the consumers finish an item, so an item's start and its epilogue
// overlap the neighbouring items' loads.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap mq,
               const __grid_constant__ CUtensorMap mk,
               const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o,
               float* __restrict__ lse, int tq, int tk, float scale,
               int causal, int nitems) {
  using F = Fwd<D>;
  constexpr int R = F::R, KT = F::KT, NS = F::NS, S = F::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S], qfull[2], qempty[2];
  uint8_t* qbuf = aligned(smem_raw);      // q: 2 x NS slabs of [R][64]
  uint8_t* ring = qbuf + 2 * F::kQBytes;  // stage: K (NS slabs [KT][64]),
                                          // then V
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&qfull[b], 1);
      mbar_init(&qempty[b], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int nqt = (tq + R - 1) / R, offset = tk - tq;
  const Items items{nqt, nitems / nqt, causal};
  // the key tiles item (bh, q0) fetches: with no fully masked row in it,
  // keys past its last row's horizon add nothing and are not fetched
  auto tiles_of = [&](int q0) {
    int kend = tk;
    if (causal && q0 + offset >= 0) kend = min(tk, q0 + R + offset);
    return (kend + KT - 1) / KT;
  };

  if (tid >= kConsumers) {
    if (tid == kConsumers) {
      int it = 0;  // key tiles issued, across items
      for (int item = blockIdx.x, k = 0; item < nitems;
           item += gridDim.x, ++k) {
        int bh, q0;
        items.at(item, R, bh, q0);
        const int qb = k & 1;
        if (k >= 2) mbar_wait(&qempty[qb], ((k >> 1) - 1) & 1);
        mbar_expect_tx(&qfull[qb], F::kQBytes);
        uint8_t* qs = qbuf + qb * F::kQBytes;
#pragma unroll
        for (int s = 0; s < NS; ++s)
#pragma unroll
          for (int rc = 0; rc < R / 64; ++rc)
            tma_load(qs + s * R * 128 + rc * kSlab, &mq, &qfull[qb], 64 * s,
                     q0 + 64 * rc, bh);
        const int ntiles = tiles_of(q0);
        for (int j = 0; j < ntiles; ++j, ++it) {
          const int st = it % S;
          if (it >= S) mbar_wait(&empty[st], ((it / S) - 1) & 1);
          mbar_expect_tx(&full[st], F::kStageBytes);
          uint8_t* ks = ring + st * F::kStageBytes;
#pragma unroll
          for (int s = 0; s < NS; ++s)
#pragma unroll
            for (int rc = 0; rc < KT / 64; ++rc) {
              const int at = s * KT * 128 + rc * kSlab;
              tma_load(ks + at, &mk, &full[st], 64 * s, j * KT + 64 * rc,
                       bh);
              tma_load(ks + F::kTileBytes + at, &mv, &full[st], 64 * s,
                       j * KT + 64 * rc, bh);
            }
        }
      }
    }
    return;
  }

  const int wg = tid / 128, lt = tid % 128, warp = lt / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const float c = scale * kLog2e;
  int it = 0;  // key tiles consumed, across items
  for (int item = blockIdx.x, k = 0; item < nitems; item += gridDim.x, ++k) {
    int bh, q0;
    items.at(item, R, bh, q0);
    const int qb = k & 1;
    const int ntiles = tiles_of(q0);
    const int r0 = q0 + 64 * wg;  // this warpgroup's first row
    // where its rows all see key 0, the tiles past its last row's horizon
    // are masked out entirely: it computes the first nw tiles only
    const int nw = causal && r0 + offset >= 0
                       ? min(ntiles, (r0 + 63 + offset) / KT + 1)
                       : ntiles;
    float acc[D / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    uint8_t* qs = qbuf + qb * F::kQBytes;
    // descriptors of its rows of q and of a stage's K and V; a step's is
    // the base's plus its byte offset / 16 (hopper::desc_at)
    const uint64_t dq = desc(smem_u32(qs) + wg * kSlab, 16, 1024);
    mbar_wait(&qfull[qb], (k >> 1) & 1);

    for (int j = 0; j < nw; ++j, ++it) {
      const int st = it % S;
      mbar_wait(&full[st], (it / S) & 1);
      const uint32_t ka = smem_u32(ring) + st * F::kStageBytes;
      const uint64_t dk = desc(ka, 16, 1024);
      const uint64_t dv = desc(ka + F::kTileBytes, KT * 128, 1024);
      // S = q k^T, q and k K-major
      float s[KT / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<KT, 0, 0>(
            s, desc_at(dq, (kk / 4) * R * 128 + (kk % 4) * 32),
            desc_at(dk, (kk / 4) * KT * 128 + (kk % 4) * 32), kk > 0);
      wg_commit();
      wg_wait<0>();
      fence_acc(s);
      // into the log2 domain: a tile that reaches past tk or past a row's
      // horizon is scaled and masked here (cs 1); any other keeps its raw
      // scores, whose max (c > 0) scales to the max of the scaled ones, and
      // takes the scale in the ex2's FFMA (cs c)
      const bool edge = (j + 1) * KT > tk ||
                        (causal && (j + 1) * KT - 1 > r0 + offset) ||
                        !(c > 0.f);
      const float cs = edge ? 1.f : c;
      if (edge) {
#pragma unroll
        for (int i = 0; i < KT / 2; ++i) {
          const int key = j * KT + 8 * (i / 4) + 2 * t4 + (i & 1);
          const int row = r0 + 16 * warp + g + 8 * ((i >> 1) & 1);
          s[i] = key >= tk                         ? -INFINITY
                 : causal && key > row + offset ? -FLT_MAX
                                                   : s[i] * c;
        }
      }
      // the row max over the quad that holds a row (every tile holds a
      // key, so the new max is finite or -FLT_MAX)
      float mx[2] = {-INFINITY, -INFINITY}, corr[2];
#pragma unroll
      for (int i = 0; i < KT / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h] * cs);
        corr[h] = ex2(m[h] - m_new);
        m[h] = m_new;
        l[h] *= corr[h];
      }
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) {
        const int h = (i >> 1) & 1;
        s[i] = ex2(fmaf(s[i], cs, -m[h]));
        l[h] += s[i];
      }
      // O += P v: P's planes from the fragments as the A operand, V
      // MN-major, into a fresh accumulator (KT keys, two planes: at most
      // 256 terms), 64 output columns (a slab of V) at a time
      uint32_t ph[KT / 16][4], pl[KT / 16][4];
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) planes_of(ph[kk], pl[kk], s, kk);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        float t[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) {
          const uint64_t db = desc_at(dv, n * KT * 128 + kk * 2048);
          wgmma_rs<64, 1>(t, ph[kk], db, kk > 0);
          wgmma_rs<64, 1>(t, pl[kk], db, 1);
        }
        wg_commit();
        wg_wait<0>();
        fence_acc(t);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          acc[32 * n + i] = acc[32 * n + i] * corr[(i >> 1) & 1] + t[i];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    // the tiles it does not compute: their stages go back in order
    for (int j = nw; j < ntiles; ++j, ++it) {
      mbar_wait(&full[it % S], (it / S) & 1);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[it % S]);
    }

    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      inv[h] = 1.f / l[h];
      const int row = r0 + 16 * warp + g + 8 * h;
      if (lse != nullptr && t4 == 0 && row < tq)
        lse[(int64_t)bh * tq + row] =
            m[h] == -FLT_MAX ? -FLT_MAX : m[h] * kLn2 + logf(l[h]);
    }
    // out / l through this warpgroup's rows of the item's q buffer (only
    // it reads them, and its wgmmas have retired), then 16-byte chunks of
    // whole rows; then the buffer goes back to the producer
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    uint8_t* stg = qs + wg * kSlab;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * (8 * s + j) + 2 * h;
          *reinterpret_cast<uint32_t*>(stg + s * R * 128 +
                                       swz(16 * warp + g + 8 * h,
                                           8 * j + 2 * t4)) =
              pack(acc[i] * inv[h], acc[i + 1] * inv[h]);
        }
    }
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    bf16* ob = o + ((int64_t)bh * tq + r0) * D;
#pragma unroll
    for (int s = 0; s < NS; ++s)
      store_slab(ob + 64 * s, D, stg + s * R * 128, tq - r0, lt);
    hopper::fence_proxy_async();  // staged through by generic stores; the
                                  // next q arrives by TMA
    __syncwarp();
    if (lane == 0) mbar_arrive(&qempty[qb]);
  }
}

// ---------------------------------------------------------------------------
// #6: the backward from the saved P
// ---------------------------------------------------------------------------
template <int D>
struct Bwd {
  static constexpr int NS = D / 64;
  static constexpr bool kSplitCols = D == 128;  // a warpgroup's 64 columns
  // grid 1
  static constexpr int R1 = D == 64 ? 128 : 64;  // query rows a block
  static constexpr int KT = 128;                 // keys a tile
  static constexpr int kGBytes = R1 * D * 2;     // dO, resident
  static constexpr int kTileBytes = KT * D * 2;  // a v or a k tile
  static constexpr int kP1Bytes = R1 * KT * 2;
  static constexpr int kStage1 = 2 * kTileBytes + kP1Bytes;
  static constexpr int kStages1 = (kSmemLimit - kGBytes) / kStage1;
  static constexpr size_t kSmem1 =
      (size_t)kGBytes + kStages1 * kStage1 + 1024;
  // grid 2
  static constexpr int KB = D == 64 ? 128 : 64;  // keys a block
  static constexpr int QT = 64;                  // queries a tile
  static constexpr int kVBytes = KB * D * 2;     // v, resident
  static constexpr int kQtBytes = QT * D * 2;    // a dO or a q tile
  static constexpr int kP2Bytes = QT * KB * 2;
  static constexpr int kStage2 = 2 * kQtBytes + kP2Bytes;
  static constexpr int kStages2 = 4;
  static constexpr size_t kSmem2 = (size_t)kVBytes + kStages2 * kStage2 +
                                   kStages2 * QT * 4 + 1024;
  static_assert(kStages1 >= 2, "a two-stage ring");
  static_assert(kSmem1 <= 227 * 1024 && kSmem2 <= 227 * 1024, "fits");
  static_assert(kStage2 >= 2 * QT * 64 * 2, "a stage holds dk and dv");
};

// Grid 1: dq, and delta into the scratch (row stride tp)
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const __grid_constant__ CUtensorMap mg,
              const __grid_constant__ CUtensorMap mv,
              const __grid_constant__ CUtensorMap mk,
              const __grid_constant__ CUtensorMap mp,
              const bf16* __restrict__ p, bf16* __restrict__ dq,
              float* __restrict__ delta, int t, int tp, float scale,
              int causal, int p_tma) {
  using B = Bwd<D>;
  constexpr int R = B::R1, KT = B::KT, NS = B::NS, S = B::kStages1;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S], gbar;
  uint8_t* gs = aligned(smem_raw);  // dO: NS slabs of [R][64]
  uint8_t* ring = gs + B::kGBytes;  // stage: v, k (NS slabs [KT][64]), P
                                    // (2 slabs [R][64])
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_init(&gbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int bh = blockIdx.y, q0 = blockIdx.x * R;
  // P is 0 past the block's last row under causal masking
  const int kend = causal ? min(t, q0 + R) : t;
  const int ntiles = (kend + KT - 1) / KT;

  if (tid >= kConsumers) {
    // the producer warp: two sweeps over the key tiles, v and P, then v,
    // k and P
    const int lane = tid % 32;
    if (lane == 0) {
      mbar_expect_tx(&gbar, B::kGBytes);
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int rc = 0; rc < R / 64; ++rc)
          tma_load(gs + s * R * 128 + rc * kSlab, &mg, &gbar, 64 * s,
                   q0 + 64 * rc, bh);
    }
    const bf16* pb = p + (int64_t)bh * t * t;
    for (int it = 0; it < 2 * ntiles; ++it) {
      const int st = it % S, kt = it % ntiles;
      const bool second = it >= ntiles;
      if (it >= S) mbar_wait(&empty[st], ((it / S) - 1) & 1);
      uint8_t* vs = ring + st * B::kStage1;
      uint8_t* ks = vs + B::kTileBytes;
      uint8_t* ps = ks + B::kTileBytes;
      if (!p_tma) gather_tile<R, KT>(ps, pb, t, q0, kt * KT, lane);
      __syncwarp();
      if (lane != 0) {
        mbar_arrive(&full[st]);
        continue;
      }
      mbar_expect_tx(&full[st], B::kTileBytes * (second ? 2 : 1) +
                                    (p_tma ? B::kP1Bytes : 0));
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int rc = 0; rc < KT / 64; ++rc) {
          const int at = s * KT * 128 + rc * kSlab;
          tma_load(vs + at, &mv, &full[st], 64 * s, kt * KT + 64 * rc, bh);
          if (second)
            tma_load(ks + at, &mk, &full[st], 64 * s, kt * KT + 64 * rc,
                     bh);
        }
      if (p_tma) {
#pragma unroll
        for (int s = 0; s < KT / 64; ++s)
#pragma unroll
          for (int rc = 0; rc < R / 64; ++rc)
            tma_load(ps + s * R * 128 + rc * kSlab, &mp, &full[st],
                     kt * KT + 64 * s, q0 + 64 * rc, bh);
      }
    }
    return;
  }

  const int wg = tid / 128, lt = tid % 128, warp = lt / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rb = B::kSplitCols ? 0 : 64 * wg;  // its first row in the block
  const int cb = B::kSplitCols ? 64 * wg : 0;  // its first dq column
  const uint32_t ga = smem_u32(gs) + (rb / 64) * kSlab;
  float rs[2] = {0.f, 0.f}, acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  mbar_wait(&gbar, 0);

  for (int it = 0; it < 2 * ntiles; ++it) {
    const int st = it % S;
    const bool second = it >= ntiles;
    mbar_wait(&full[st], (it / S) & 1);
    const uint8_t* vs = ring + st * B::kStage1;
    const uint8_t* ps = vs + 2 * B::kTileBytes;
    const uint32_t va = smem_u32(vs), ka = va + B::kTileBytes;
    // dP = dO v^T, dO and v K-major
    float dp[KT / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<KT, 0, 0>(
          dp, desc(ga + (kk / 4) * R * 128 + (kk % 4) * 32, 16, 1024),
          desc(va + (kk / 4) * KT * 128 + (kk % 4) * 32, 16, 1024), kk > 0);
    wg_commit();
    wg_wait<0>();
    fence_acc(dp);
    // P at the fragments' places: rows rb + 16 warp + g (+ 8), columns
    // 8 j + 2 t4 (+ 1), a pair a 4-byte word
    auto pw = [&](int j, int h) {
      return bf2(*reinterpret_cast<const uint32_t*>(
          ps + (j / 8) * R * 128 +
          swz(rb + 16 * warp + g + 8 * h, 8 * (j % 8) + 2 * t4)));
    };
    if (!second) {
      // delta = rowsum(dP P), in tile order
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 pf = pw(j, h);
          rs[h] = fmaf(dp[4 * j + 2 * h + 1], pf.y,
                       fmaf(dp[4 * j + 2 * h], pf.x, rs[h]));
        }
      __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
      if (it == ntiles - 1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
          rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
          if (t4 == 0 && cb == 0)
            delta[(int64_t)bh * tp + q0 + rb + 16 * warp + g + 8 * h] =
                rs[h];
        }
      }
      continue;
    }
    // dS = P (dP - delta), then dq += dS k as two RS wgmmas (hi, lo) into
    // a fresh accumulator (128 keys, two planes: 256 terms), k MN-major
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 pf = pw(j, h);
        dp[4 * j + 2 * h] = pf.x * (dp[4 * j + 2 * h] - rs[h]);
        dp[4 * j + 2 * h + 1] = pf.y * (dp[4 * j + 2 * h + 1] - rs[h]);
      }
    uint32_t hi[KT / 16][4], lo[KT / 16][4];
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) planes_of(hi[kk], lo[kk], dp, kk);
    float tq_[32];
    const uint32_t kc = ka + (cb / 64) * KT * 128;  // its columns of k
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      const uint64_t db = desc(kc + kk * 2048, KT * 128, 1024);
      wgmma_rs<64, 1>(tq_, hi[kk], db, kk > 0);
      wgmma_rs<64, 1>(tq_, lo[kk], db, 1);
    }
    wg_commit();
    wg_wait<0>();
    fence_acc(tq_);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += tq_[i];
  }

  // every consumer is done with dO (at D 128 both warpgroups read all of
  // it): each stages its 64 x 64 of dq in 8 KB of it
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
  uint8_t* stg = gs + wg * kSlab;
  stage_acc(stg, acc, scale, warp, lane);
  asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
  store_slab(dq + ((int64_t)bh * t + q0 + rb) * D + cb, D, stg,
             t - q0 - rb, lt);
}

// Grid 2: dk and dv
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_kernel(const __grid_constant__ CUtensorMap mv,
               const __grid_constant__ CUtensorMap mg,
               const __grid_constant__ CUtensorMap mq,
               const __grid_constant__ CUtensorMap mp,
               const bf16* __restrict__ p, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int t, int tp,
               float scale, int causal, int p_tma) {
  using B = Bwd<D>;
  constexpr int KB = B::KB, QT = B::QT, NS = B::NS, S = B::kStages2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S], vbar;
  uint8_t* vres = aligned(smem_raw);  // v: NS slabs of [KB][64]
  uint8_t* ring = vres + B::kVBytes;  // stage: dO, q (NS slabs [QT][64]),
                                      // P (KB / 64 slabs [QT][64])
  float* dls = reinterpret_cast<float*>(ring + S * B::kStage2);  // [S][QT]
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_init(&vbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int bh = blockIdx.y, k0 = blockIdx.x * KB;
  // under causal masking the queries before k0 have P = 0 on these keys
  const int qt0 = causal ? k0 / QT * QT : 0;
  const int ntiles = (t - qt0 + QT - 1) / QT;

  if (tid >= kConsumers) {
    const int lane = tid % 32;
    if (lane == 0) {
      mbar_expect_tx(&vbar, B::kVBytes);
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int rc = 0; rc < KB / 64; ++rc)
          tma_load(vres + s * KB * 128 + rc * kSlab, &mv, &vbar, 64 * s,
                   k0 + 64 * rc, bh);
    }
    const bf16* pb = p + (int64_t)bh * t * t;
    for (int it = 0; it < ntiles; ++it) {
      const int st = it % S, qt = qt0 + it * QT;
      if (it >= S) mbar_wait(&empty[st], ((it / S) - 1) & 1);
      uint8_t* gs = ring + st * B::kStage2;
      uint8_t* qs = gs + B::kQtBytes;
      uint8_t* ps = qs + B::kQtBytes;
      if (!p_tma) {
        gather_tile<QT, KB>(ps, pb, t, qt, k0, lane);
        hopper::fence_proxy_async();  // wgmma reads the tile
      }
      __syncwarp();
      if (lane != 0) {
        mbar_arrive(&full[st]);
        continue;
      }
      mbar_expect_tx(&full[st], 2 * B::kQtBytes + QT * 4 +
                                    (p_tma ? B::kP2Bytes : 0));
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        tma_load(gs + s * kSlab, &mg, &full[st], 64 * s, qt, bh);
        tma_load(qs + s * kSlab, &mq, &full[st], 64 * s, qt, bh);
      }
      if (p_tma) {
#pragma unroll
        for (int s = 0; s < KB / 64; ++s)
          tma_load(ps + s * kSlab, &mp, &full[st], k0 + 64 * s, qt, bh);
      }
      hopper::bulk_load(dls + st * QT, delta + (int64_t)bh * tp + qt, QT * 4,
                        &full[st]);
    }
    return;
  }

  const int wg = tid / 128, lt = tid % 128, warp = lt / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int kb = B::kSplitCols ? 0 : 64 * wg;  // its first key in the block
  const int cb = B::kSplitCols ? 64 * wg : 0;  // its first output column
  const uint32_t va = smem_u32(vres) + (kb / 64) * kSlab;
  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  mbar_wait(&vbar, 0);

  for (int it = 0; it < ntiles; ++it) {
    const int st = it % S;
    mbar_wait(&full[st], (it / S) & 1);
    const uint8_t* gsp = ring + st * B::kStage2;
    const uint32_t ga = smem_u32(gsp), qa = ga + B::kQtBytes;
    const uint32_t pa = qa + B::kQtBytes + (kb / 64) * kSlab;  // its keys
    const uint8_t* pp = gsp + 2 * B::kQtBytes + (kb / 64) * kSlab;
    const float* dl = dls + st * QT;
    // dP^T = v dO^T (v and dO K-major) and, in the same group, the fresh
    // tv = P^T dO (P's tile and dO MN-major)
    float dpt[32], tv[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<64, 0, 0>(
          dpt, desc(va + (kk / 4) * KB * 128 + (kk % 4) * 32, 16, 1024),
          desc(ga + (kk / 4) * QT * 128 + (kk % 4) * 32, 16, 1024), kk > 0);
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk)
      wgmma_ss<64, 1, 1>(tv, desc(pa + kk * 2048, QT * 128, 1024),
                         desc(ga + (cb / 64) * kSlab + kk * 2048, kSlab,
                              1024),
                         kk > 0);
    wg_commit();
    wg_wait<0>();
    fence_acc(dpt);
    fence_acc(tv);
#pragma unroll
    for (int i = 0; i < 32; ++i) dv_acc[i] += tv[i];
    // dS^T = P^T (dP^T - delta): key rows 16 warp + g (+ 8) of its slab,
    // query columns 8 j + 2 t4 (+ 1); P^T read across the tile's rows
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int q = 8 * (i / 4) + 2 * t4 + (i & 1);
      const int key = 16 * warp + g + 8 * ((i >> 1) & 1);
      dpt[i] = bf1(pp + swz(q, key)) * (dpt[i] - dl[q]);
    }
    uint32_t hi[QT / 16][4], lo[QT / 16][4];
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) planes_of(hi[kk], lo[kk], dpt, kk);
    // dk += dS^T q as two RS wgmmas into a fresh accumulator, q MN-major
    float tk_[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      const uint64_t db = desc(qa + (cb / 64) * kSlab + kk * 2048, kSlab, 1024);
      wgmma_rs<64, 1>(tk_, hi[kk], db, kk > 0);
      wgmma_rs<64, 1>(tk_, lo[kk], db, 1);
    }
    wg_commit();
    wg_wait<0>();
    fence_acc(tk_);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[i] += tk_[i];
  }

  // every consumer is done with the ring: each stages its 64 x 64 of dk
  // and of dv in 16 KB of it
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
  uint8_t* stg = ring + wg * 2 * kSlab;
  stage_acc(stg, dk_acc, scale, warp, lane);
  stage_acc(stg + kSlab, dv_acc, 1.f, warp, lane);
  asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
  const int64_t at = ((int64_t)bh * t + k0 + kb) * D + cb;
  store_slab(dk + at, D, stg, t - k0 - kb, lt);
  store_slab(dv + at, D, stg + kSlab, t - k0 - kb, lt);
}

// ---------------------------------------------------------------------------
// #5's P: the normalized probabilities from #2's lse
// ---------------------------------------------------------------------------
template <int D>
struct Probs {
  static constexpr int R = 128;             // query rows an item
  static constexpr int KT = Fwd<D>::KT;     // keys a tile
  static constexpr int NS = D / 64;
  static constexpr int kQBytes = R * D * 2;
  static constexpr int kTileBytes = KT * D * 2;  // a K tile
  static constexpr int kStages = 4;
  static constexpr int kWarpTile = 16 * KT * 2;  // a warp's rows of P's tile
  static constexpr size_t kSmem = (size_t)2 * kQBytes +
                                  kStages * kTileBytes +
                                  2 * 8 * kWarpTile + 1024;
  static_assert(kSmem <= 227 * 1024, "fits");
};

// A warp's 16 rows of a tile of P (KT / 64 swizzled boxes of [16][64] at
// stg, or zeros where stg is null) to rows row0.. and columns col0.. of
// the row-major [t, t] matrix pb, rows and columns at or past t skipped:
// 16-byte chunks where the rows lie on 16 bytes (vec), else 2-byte stores
template <int KT>
__device__ __forceinline__ void store_rows(bf16* pb, int t, int row0,
                                           int col0, const uint8_t* stg,
                                           bool vec, int lane) {
  if (vec) {
    for (int i = lane; i < 16 * (KT / 8); i += 32) {
      const int r = i / (KT / 8), c8 = i % (KT / 8);
      const int row = row0 + r, col = col0 + 8 * c8;
      if (row < t && col < t)
        *reinterpret_cast<uint4*>(pb + (int64_t)row * t + col) =
            stg == nullptr
                ? make_uint4(0u, 0u, 0u, 0u)
                : *reinterpret_cast<const uint4*>(
                      stg + (c8 / 8) * 2048 + r * 128 +
                      (((c8 % 8) ^ (r & 7)) << 4));
    }
  } else {
    uint16_t* dst = reinterpret_cast<uint16_t*>(pb);
    for (int i = lane; i < 16 * KT; i += 32) {
      const int r = i / KT, cc = i % KT, row = row0 + r, col = col0 + cc;
      if (row < t && col < t)
        dst[(int64_t)row * t + col] =
            stg == nullptr ? (uint16_t)0
                           : *reinterpret_cast<const uint16_t*>(
                                 stg + (cc / 64) * 2048 + swz(r, cc % 64));
    }
  }
}

// P = ex2(S c - lse log2e) for q, k [BH, t, D], lse fp32 [BH, t] (#2's,
// from the same q, k and v), into p [BH, t, t] bf16: #2's persistent grid
// and items, the producer streaming q (two buffers) and the item's K
// tiles up to its causal horizon through the ring, two consumer
// warpgroups of 64 rows forming S = q k^T (SS) a tile at a time. Each
// warp stages its 16 rows of P as bf16 in one of its two tiles and writes
// them by TMA stores that drain while it computes the next tile (2-byte
// stores where t % 8 != 0); tiles past a warpgroup's horizon are written
// as zeros, with no product. No barrier across warps after the item's q.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    p_kernel(const __grid_constant__ CUtensorMap mq,
             const __grid_constant__ CUtensorMap mk,
             const __grid_constant__ CUtensorMap mp,
             const float* __restrict__ lse, bf16* __restrict__ p, int t,
             float scale, int causal, int nitems, int p_vec) {
  using F = Probs<D>;
  constexpr int R = F::R, KT = F::KT, NS = F::NS, S = F::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S], qfull[2], qempty[2];
  uint8_t* qbuf = aligned(smem_raw);      // q: 2 x NS slabs of [R][64]
  uint8_t* ring = qbuf + 2 * F::kQBytes;  // stage: K (NS slabs [KT][64])
  uint8_t* pst = ring + S * F::kTileBytes;  // a warp's two tiles of P
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&qfull[b], 1);
      mbar_init(&qempty[b], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int nqt = (t + R - 1) / R;
  const Items items{nqt, nitems / nqt, causal};
  // the key tiles item (bh, q0) fetches: P is 0 past its last row
  auto tiles_of = [&](int q0) {
    return ((causal ? min(t, q0 + R) : t) + KT - 1) / KT;
  };

  if (tid >= kConsumers) {
    if (tid == kConsumers) {
      int it = 0;
      for (int item = blockIdx.x, k = 0; item < nitems;
           item += gridDim.x, ++k) {
        int bh, q0;
        items.at(item, R, bh, q0);
        const int qb = k & 1;
        if (k >= 2) mbar_wait(&qempty[qb], ((k >> 1) - 1) & 1);
        mbar_expect_tx(&qfull[qb], F::kQBytes);
        uint8_t* qs = qbuf + qb * F::kQBytes;
#pragma unroll
        for (int s = 0; s < NS; ++s)
#pragma unroll
          for (int rc = 0; rc < R / 64; ++rc)
            tma_load(qs + s * R * 128 + rc * kSlab, &mq, &qfull[qb], 64 * s,
                     q0 + 64 * rc, bh);
        const int ntiles = tiles_of(q0);
        for (int j = 0; j < ntiles; ++j, ++it) {
          const int st = it % S;
          if (it >= S) mbar_wait(&empty[st], ((it / S) - 1) & 1);
          mbar_expect_tx(&full[st], F::kTileBytes);
          uint8_t* ks = ring + st * F::kTileBytes;
#pragma unroll
          for (int s = 0; s < NS; ++s)
#pragma unroll
            for (int rc = 0; rc < KT / 64; ++rc)
              tma_load(ks + s * KT * 128 + rc * kSlab, &mk, &full[st],
                       64 * s, j * KT + 64 * rc, bh);
        }
      }
    }
    return;
  }

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const float c = scale * kLog2e;
  uint8_t* mine = pst + (tid / 32) * 2 * F::kWarpTile;
  int it = 0, nst = 0;  // key tiles consumed; tiles staged
  for (int item = blockIdx.x, k = 0; item < nitems; item += gridDim.x, ++k) {
    int bh, q0;
    items.at(item, R, bh, q0);
    const int qb = k & 1, ntiles = tiles_of(q0);
    const int r0 = q0 + 64 * wg, rw = r0 + 16 * warp;  // its first rows
    // the tiles past the last row's horizon of its warpgroup are 0
    const int nw = causal ? min(ntiles, (r0 + 63) / KT + 1) : ntiles;
    float l2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rw + g + 8 * h;
      l2[h] = row < t ? lse[(int64_t)bh * t + row] * kLog2e : 0.f;
    }
    const uint64_t dq =
        desc(smem_u32(qbuf + qb * F::kQBytes) + wg * kSlab, 16, 1024);
    bf16* pb = p + (int64_t)bh * t * t;
    mbar_wait(&qfull[qb], (k >> 1) & 1);
    const int nall = (t + KT - 1) / KT;
    for (int j = 0; j < nall; ++j) {
      if (j >= nw) {
        if (j < ntiles) {
          mbar_wait(&full[it % S], (it / S) & 1);
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[it % S]);
          ++it;
        }
        store_rows<KT>(pb, t, rw, j * KT, nullptr, p_vec, lane);
        continue;
      }
      const int st = it % S;
      mbar_wait(&full[st], (it / S) & 1);
      const uint64_t dk = desc(smem_u32(ring) + st * F::kTileBytes, 16,
                               1024);
      float s[KT / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<KT, 0, 0>(
            s, desc_at(dq, (kk / 4) * R * 128 + (kk % 4) * 32),
            desc_at(dk, (kk / 4) * KT * 128 + (kk % 4) * 32), kk > 0);
      wg_commit();
      wg_wait<0>();
      fence_acc(s);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      ++it;
      // a key past t or past a row's horizon has P 0
      const bool edge = (j + 1) * KT > t || (causal && (j + 1) * KT - 1 > r0);
      // the tile staged two tiles ago has been read by its store
      uint8_t* buf = mine + (nst++ & 1) * F::kWarpTile;
      if (p_vec && lane == 0) hopper::bulk_wait_read<1>();
      __syncwarp();
#pragma unroll
      for (int i = 0; i < KT / 2; i += 2) {
        const int h = (i >> 1) & 1, col = 8 * (i / 4) + 2 * t4;
        float x0 = ex2(fmaf(s[i], c, -l2[h]));
        float x1 = ex2(fmaf(s[i + 1], c, -l2[h]));
        if (edge) {
          const int key = j * KT + col, row = rw + g + 8 * h;
          x0 = key < t && !(causal && key > row) ? x0 : 0.f;
          x1 = key + 1 < t && !(causal && key + 1 > row) ? x1 : 0.f;
        }
        *reinterpret_cast<uint32_t*>(buf + (col / 64) * 2048 +
                                     swz(g + 8 * h, col % 64)) =
            pack(x0, x1);
      }
      if (p_vec) hopper::fence_proxy_async();  // TMA reads the tile
      __syncwarp();
      if (!p_vec) {
        store_rows<KT>(pb, t, rw, j * KT, buf, false, lane);
      } else if (lane == 0) {
#pragma unroll
        for (int c64 = 0; c64 < KT / 64; ++c64)
          hopper::tma_store(&mp, buf + c64 * 2048, j * KT + 64 * c64, rw,
                            bh);
        hopper::bulk_commit();
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&qempty[qb]);
  }
  if (p_vec && lane == 0) hopper::bulk_wait<0>();  // P's last stores
}

// ---------------------------------------------------------------------------
// #4: the flash backward's dk and dv, P recomputed from the lse
// ---------------------------------------------------------------------------
template <int D>
struct FlashDkv {
  static constexpr int NS = D / 64;
  static constexpr bool kSplitCols = D == 128;   // a warpgroup's 64 columns
  static constexpr int KB = D == 64 ? 128 : 64;  // keys a block
  static constexpr int QT = 64;                  // queries a tile
  static constexpr int kKVBytes = KB * D * 2;    // k or v, resident
  static constexpr int kQtBytes = QT * D * 2;    // a q or a dO tile
  static constexpr int kStage = 2 * kQtBytes;
  static constexpr int kStages = D == 64 ? 4 : 3;
  static constexpr int kVecBytes = kStages * 2 * QT * 4;  // lse, delta
  // the running sums of dk and dv, fp32: [2 warpgroups][2][8][128] float4
  static constexpr int kRunBytes = 2 * 2 * 8 * 128 * 16;
  static constexpr size_t kSmem = (size_t)2 * kKVBytes + kStages * kStage +
                                  kVecBytes + kRunBytes + 1024;
  static_assert(kSmem <= 227 * 1024, "fits");
  static_assert(kStages * kStage >= 2 * 2 * kSlab, "the ring holds dk, dv");
};

// One block per (bh, KB keys): k and v resident; 64-row query tiles of q
// and dO stream through the ring by TMA, their rows of lse and delta
// beside them (by bulk copy where tq % 4 == 0, else gathered by the
// producer warp). A warpgroup takes 64 keys (at D 128 both take the same
// 64 keys and 64 output columns each). A tile: S^T = k q^T and dP^T =
// v dO^T (SS, one group); P^T = ex2(S^T c - lse log2e) and dS^T = P^T
// (dP^T - delta) on the fragments; dv += P^T dO and dk += dS^T q, each as
// two RS wgmmas (hi, lo; dO and q MN-major), one group. Those two chains
// run into fresh accumulators over two tiles (256 terms), then retire
// into fp32 running sums in shared memory, so that a thread holds two
// chains and S^T, dP^T (128 registers) and not also two running sums.
// Masking by index: a key past tk or a query past tq is padding (P = 0);
// under causal masking (bottom-right) a masked entry has P = 0 and dS =
// 0, and a query that sees no key (i < tq - tk) P = 1 / tk and dS = 0,
// whatever its lse (-FLT_MAX). dk is scaled once, at the end.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_kernel(const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv,
                     const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mg,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int tq, int tk, float scale,
                     int causal, int vec_tma) {
  using F = FlashDkv<D>;
  constexpr int KB = F::KB, QT = F::QT, NS = F::NS, S = F::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S], kvbar;
  uint8_t* kres = aligned(smem_raw);   // k: NS slabs of [KB][64]
  uint8_t* vres = kres + F::kKVBytes;  // v: the same
  uint8_t* ring = vres + F::kKVBytes;  // stage: q, then dO (NS slabs
                                       // [QT][64] each)
  float* vecs = reinterpret_cast<float*>(ring + S * F::kStage);  // [S][2][QT]
  float4* run = reinterpret_cast<float4*>(
      reinterpret_cast<uint8_t*>(vecs) + F::kVecBytes);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_init(&kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int bh = blockIdx.y, k0 = blockIdx.x * KB, offset = tk - tq;
  const int nqt = (tq + QT - 1) / QT;
  // the first query tile at or after tile i that adds to these keys: under
  // causal masking a tile whose last row cannot reach key k0 adds nothing,
  // unless it holds rows that see no key (rows < -offset, all at the top)
  auto next_tile = [&](int i) {
    return causal && i * QT + offset >= 0 && i * QT + QT - 1 + offset < k0
               ? max(i, (k0 - offset) / QT)
               : i;
  };

  if (tid >= kConsumers) {
    const int lane = tid % 32;
    if (lane == 0) {
      mbar_expect_tx(&kvbar, 2 * F::kKVBytes);
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int rc = 0; rc < KB / 64; ++rc) {
          const int at = s * KB * 128 + rc * kSlab;
          tma_load(kres + at, &mk, &kvbar, 64 * s, k0 + 64 * rc, bh);
          tma_load(vres + at, &mv, &kvbar, 64 * s, k0 + 64 * rc, bh);
        }
    }
    const float* lb = lse + (int64_t)bh * tq;
    const float* db = delta + (int64_t)bh * tq;
    int it = 0;
    for (int i = next_tile(0); i < nqt; i = next_tile(i + 1), ++it) {
      const int st = it % S, qt = i * QT, n = min(QT, tq - qt);
      if (it >= S) mbar_wait(&empty[st], ((it / S) - 1) & 1);
      uint8_t* qs = ring + st * F::kStage;
      float* ls = vecs + st * 2 * QT;
      if (!vec_tma)
        for (int r = lane; r < QT; r += 32) {
          ls[r] = r < n ? lb[qt + r] : 0.f;
          ls[QT + r] = r < n ? db[qt + r] : 0.f;
        }
      __syncwarp();
      if (lane != 0) {
        mbar_arrive(&full[st]);
        continue;
      }
      mbar_expect_tx(&full[st], F::kStage + (vec_tma ? 2 * n * 4 : 0));
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        tma_load(qs + s * kSlab, &mq, &full[st], 64 * s, qt, bh);
        tma_load(qs + F::kQtBytes + s * kSlab, &mg, &full[st], 64 * s, qt,
                 bh);
      }
      if (vec_tma) {
        hopper::bulk_load(ls, lb + qt, n * 4, &full[st]);
        hopper::bulk_load(ls + QT, db + qt, n * 4, &full[st]);
      }
    }
    return;
  }

  const int wg = tid / 128, lt = tid % 128, warp = lt / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int kb = F::kSplitCols ? 0 : 64 * wg;  // its first key in the block
  const int cb = F::kSplitCols ? 64 * wg : 0;  // its first output column
  const int kw0 = k0 + kb;
  const uint32_t ka = smem_u32(kres) + (kb / 64) * kSlab;
  const uint32_t va = smem_u32(vres) + (kb / 64) * kSlab;
  const float c = scale * kLog2e, blind_p = 1.f / tk;
  // its running sums: dk at [j][lt], dv at [8 + j][lt], j < 8, so that a
  // warp's 16-byte accesses fall on distinct banks
  float4* mine = run + wg * 16 * 128 + lt;
#pragma unroll
  for (int j = 0; j < 16; ++j) mine[j * 128] = make_float4(0.f, 0.f, 0.f, 0.f);
  auto retire = [&](const float(&x)[32], int at) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float4 r = mine[(at + j) * 128];
      r.x += x[4 * j];
      r.y += x[4 * j + 1];
      r.z += x[4 * j + 2];
      r.w += x[4 * j + 3];
      mine[(at + j) * 128] = r;
    }
  };
  float fk[32], fv[32];  // the chains of dk and dv
#pragma unroll
  for (int i = 0; i < 32; ++i) fk[i] = fv[i] = 0.f;
  mbar_wait(&kvbar, 0);

  int it = 0, done = 0;  // stages consumed; tiles this warpgroup computed
  for (int i = next_tile(0); i < nqt; i = next_tile(i + 1), ++it) {
    const int st = it % S, qt = i * QT;
    mbar_wait(&full[st], (it / S) & 1);
    // every entry masked for its keys and no row that sees no key: the
    // tile adds nothing to them
    if (causal && qt + offset >= 0 && qt + QT - 1 + offset < kw0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      continue;
    }
    const uint32_t qa = smem_u32(ring + st * F::kStage);
    const uint32_t ga = qa + F::kQtBytes;
    const float* ls = vecs + st * 2 * QT;
    const float* dl = ls + QT;
    // S^T = k q^T and dP^T = v dO^T: key rows, query columns; all K-major
    float s[32], dp[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<64, 0, 0>(
          s, desc(ka + (kk / 4) * KB * 128 + (kk % 4) * 32, 16, 1024),
          desc(qa + (kk / 4) * QT * 128 + (kk % 4) * 32, 16, 1024), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<64, 0, 0>(
          dp, desc(va + (kk / 4) * KB * 128 + (kk % 4) * 32, 16, 1024),
          desc(ga + (kk / 4) * QT * 128 + (kk % 4) * 32, 16, 1024), kk > 0);
    wg_commit();
    wg_wait<0>();
    fence_acc(s);
    fence_acc(dp);
    // P^T and dS^T at (key kw0 + 16 warp + g (+ 8), query qt + 8 j + 2 t4
    // (+ 1)), then their planes, a 16-query step at a time
    const bool edge = qt + QT > tq || kw0 + 64 > tk ||
                      (causal && kw0 + 63 > qt + offset);
    uint32_t ph[QT / 16][4], pl[QT / 16][4], sh[QT / 16][4], sl[QT / 16][4];
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
#pragma unroll
      for (int i = 8 * kk; i < 8 * kk + 8; ++i) {
        const int col = 8 * (i / 4) + 2 * t4 + (i & 1);
        float p = ex2(fmaf(s[i], c, -ls[col] * kLog2e));
        float ds = p * (dp[i] - dl[col]);
        if (edge) {
          const int q = qt + col, key = kw0 + 16 * warp + g + 8 * ((i >> 1) & 1);
          const bool in = q < tq && key < tk;
          const bool masked = causal && key > q + offset;
          p = !in ? 0.f : masked ? (q + offset < 0 ? blind_p : 0.f) : p;
          ds = in && !masked ? ds : 0.f;
        }
        s[i] = p;
        dp[i] = ds;
      }
      planes_of(ph[kk], pl[kk], s, kk);
      planes_of(sh[kk], sl[kk], dp, kk);
    }
    // dv += P^T dO and dk += dS^T q, two planes a step, dO and q MN-major
    // (its 64 columns), into the chains: fresh every other tile
    const int acc0 = done % 2;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      const uint64_t db = desc(ga + (cb / 64) * kSlab + kk * 2048, kSlab, 1024);
      wgmma_rs<64, 1>(fv, ph[kk], db, acc0 | (kk > 0));
      wgmma_rs<64, 1>(fv, pl[kk], db, 1);
    }
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      const uint64_t db = desc(qa + (cb / 64) * kSlab + kk * 2048, kSlab, 1024);
      wgmma_rs<64, 1>(fk, sh[kk], db, acc0 | (kk > 0));
      wgmma_rs<64, 1>(fk, sl[kk], db, 1);
    }
    wg_commit();
    wg_wait<0>();
    fence_acc(fv);
    fence_acc(fk);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
    if (++done % 2 == 0) {
      retire(fk, 0);
      retire(fv, 8);
    }
  }
  if (done % 2) {
    retire(fk, 0);
    retire(fv, 8);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 a = mine[j * 128], b = mine[(8 + j) * 128];
    fk[4 * j] = a.x, fk[4 * j + 1] = a.y, fk[4 * j + 2] = a.z;
    fk[4 * j + 3] = a.w;
    fv[4 * j] = b.x, fv[4 * j + 1] = b.y, fv[4 * j + 2] = b.z;
    fv[4 * j + 3] = b.w;
  }
  // every consumer is done with the ring: each stages its 64 x 64 of dk
  // and of dv in 16 KB of it
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
  uint8_t* stg = ring + wg * 2 * kSlab;
  stage_acc(stg, fk, scale, warp, lane);
  stage_acc(stg + kSlab, fv, 1.f, warp, lane);
  asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
  const int64_t at = ((int64_t)bh * tk + kw0) * D + cb;
  store_slab(dk + at, D, stg, tk - kw0, lt);
  store_slab(dv + at, D, stg + kSlab, tk - kw0, lt);
}

// ---------------------------------------------------------------------------
// #3: the flash backward's dq, P recomputed from the lse
// ---------------------------------------------------------------------------
template <int D>
struct FlashDq {
  static constexpr int NS = D / 64;
  static constexpr bool kSplitCols = D == 128;   // a warpgroup's 64 columns
  static constexpr int R = D == 64 ? 128 : 64;   // query rows an item
  static constexpr int KT = 64;                  // keys a tile
  static constexpr int kQBytes = R * D * 2;      // q or dO of an item
  static constexpr int kItemBytes = 2 * kQBytes;  // q, then dO; two buffers
  static constexpr int kTileBytes = KT * D * 2;  // a k or a v tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kStgBytes = 2 * kSlab;  // each warpgroup's dq tile
  static constexpr int kStages =
      (kSmemLimit - 2 * kItemBytes - kStgBytes) / kStageBytes;
  static constexpr size_t kSmem = (size_t)2 * kItemBytes + kStgBytes +
                                  kStages * kStageBytes + 1024;
  static_assert(kStages >= 4 && kSmem <= 227 * 1024, "fits");
};

// #2's persistent grid and items (bh, R query rows), longest causal items
// first: the producer loads an item's q and dO (two buffers, so that it
// runs on into the next item) and streams its key tiles of k and v up to
// the item's causal horizon through the ring. A warpgroup takes 64 rows
// (at D 128 both take the same 64 rows and 64 dq columns each); its
// threads load their rows' lse and delta into registers as the item
// starts. A tile: S = q k^T and dP = dO v^T (SS, one group); P =
// ex2(S c - lse log2e) and dS = P (dP - delta) on the fragments; dq += dS
// k as two RS wgmmas (hi, lo; k MN-major) into a fresh chain (128 terms)
// added to the fp32 running sum in registers. dq is scaled once,
// staged as bf16 in the warpgroup's own tile of shared memory and written
// in 16-byte chunks, rows past tq skipped. Masking by index: keys past tk
// and, under causal masking (bottom-right), keys past a row's horizon
// have dS 0, so a row that sees no key has dq 0 whatever its lse.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_kernel(const __grid_constant__ CUtensorMap mq,
                    const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv,
                    const __grid_constant__ CUtensorMap mg,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int tq, int tk, float scale, int causal, int nitems) {
  using F = FlashDq<D>;
  constexpr int R = F::R, KT = F::KT, NS = F::NS, S = F::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S], qfull[2], qempty[2];
  uint8_t* qbuf = aligned(smem_raw);  // item buffer: q, then dO (NS slabs
                                      // of [R][64] each)
  uint8_t* stg = qbuf + 2 * F::kItemBytes;  // a warpgroup's dq: [64][64]
  uint8_t* ring = stg + F::kStgBytes;       // stage: k, then v (NS slabs
                                            // of [KT][64] each)
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&qfull[b], 1);
      mbar_init(&qempty[b], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int nqt = (tq + R - 1) / R, offset = tk - tq;
  const Items items{nqt, nitems / nqt, causal};
  // the key tiles item (bh, q0) fetches: under causal masking the keys
  // past its last row's horizon have dS 0 on every row
  auto tiles_of = [&](int q0) {
    const int kend = causal ? max(0, min(tk, q0 + R + offset)) : tk;
    return (kend + KT - 1) / KT;
  };

  if (tid >= kConsumers) {
    if (tid == kConsumers) {
      int it = 0;  // key tiles issued, across items
      for (int item = blockIdx.x, k = 0; item < nitems;
           item += gridDim.x, ++k) {
        int bh, q0;
        items.at(item, R, bh, q0);
        const int qb = k & 1;
        if (k >= 2) mbar_wait(&qempty[qb], ((k >> 1) - 1) & 1);
        mbar_expect_tx(&qfull[qb], F::kItemBytes);
        uint8_t* qs = qbuf + qb * F::kItemBytes;
#pragma unroll
        for (int s = 0; s < NS; ++s)
#pragma unroll
          for (int rc = 0; rc < R / 64; ++rc) {
            const int at = s * R * 128 + rc * kSlab;
            tma_load(qs + at, &mq, &qfull[qb], 64 * s, q0 + 64 * rc, bh);
            tma_load(qs + F::kQBytes + at, &mg, &qfull[qb], 64 * s,
                     q0 + 64 * rc, bh);
          }
        const int ntiles = tiles_of(q0);
        for (int j = 0; j < ntiles; ++j, ++it) {
          const int st = it % S;
          if (it >= S) mbar_wait(&empty[st], ((it / S) - 1) & 1);
          mbar_expect_tx(&full[st], F::kStageBytes);
          uint8_t* ks = ring + st * F::kStageBytes;
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            tma_load(ks + s * kSlab, &mk, &full[st], 64 * s, j * KT, bh);
            tma_load(ks + F::kTileBytes + s * kSlab, &mv, &full[st], 64 * s,
                     j * KT, bh);
          }
        }
      }
    }
    return;
  }

  const int wg = tid / 128, lt = tid % 128, warp = lt / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rb = F::kSplitCols ? 0 : 64 * wg;  // its first row in an item
  const int cb = F::kSplitCols ? 64 * wg : 0;  // its first dq column
  const float c = scale * kLog2e;
  uint8_t* mine = stg + wg * kSlab;
  int it = 0;  // key tiles consumed, across items
  for (int item = blockIdx.x, k = 0; item < nitems; item += gridDim.x, ++k) {
    int bh, q0;
    items.at(item, R, bh, q0);
    const int qb = k & 1, ntiles = tiles_of(q0);
    const int r0 = q0 + rb;  // its first row
    // the tiles past its last row's horizon have dS 0 on its rows
    const int nw =
        causal ? min(ntiles, (max(0, min(tk, r0 + 64 + offset)) + KT - 1) / KT)
               : ntiles;
    // its rows' lse (log2 domain) and delta; 0 past tq, whose dq is not
    // written
    float l2[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 16 * warp + g + 8 * h;
      const bool in = row < tq;
      l2[h] = in ? lse[(int64_t)bh * tq + row] * kLog2e : 0.f;
      dl[h] = in ? delta[(int64_t)bh * tq + row] : 0.f;
    }
    const uint32_t qa =
        smem_u32(qbuf + qb * F::kItemBytes) + (rb / 64) * kSlab;
    const uint32_t ga = qa + F::kQBytes;
    float acc[32];  // the running sum
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    mbar_wait(&qfull[qb], (k >> 1) & 1);

    for (int j = 0; j < nw; ++j, ++it) {
      const int st = it % S;
      mbar_wait(&full[st], (it / S) & 1);
      const uint32_t ka = smem_u32(ring) + st * F::kStageBytes;
      const uint32_t va = ka + F::kTileBytes;
      // S = q k^T and dP = dO v^T: query rows, key columns; all K-major
      float s[KT / 2], dp[KT / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<KT, 0, 0>(
            s, desc(qa + (kk / 4) * R * 128 + (kk % 4) * 32, 16, 1024),
            desc(ka + (kk / 4) * kSlab + (kk % 4) * 32, 16, 1024), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<KT, 0, 0>(
            dp, desc(ga + (kk / 4) * R * 128 + (kk % 4) * 32, 16, 1024),
            desc(va + (kk / 4) * kSlab + (kk % 4) * 32, 16, 1024), kk > 0);
      wg_commit();
      wg_wait<0>();
      fence_acc(s);
      fence_acc(dp);
      // dS at (row r0 + 16 warp + g (+ 8), key j KT + 8 (i / 4) + 2 t4
      // (+ 1)), then its planes, a 16-key step at a time
      const bool edge = (j + 1) * KT > tk ||
                        (causal && (j + 1) * KT - 1 > r0 + offset);
      uint32_t hi[KT / 16][4], lo[KT / 16][4];
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
#pragma unroll
        for (int i = 8 * kk; i < 8 * kk + 8; ++i) {
          const int h = (i >> 1) & 1;
          float ds = ex2(fmaf(s[i], c, -l2[h])) * (dp[i] - dl[h]);
          if (edge) {
            const int key = j * KT + 8 * (i / 4) + 2 * t4 + (i & 1);
            const int row = r0 + 16 * warp + g + 8 * h;
            ds = key < tk && !(causal && key > row + offset) ? ds : 0.f;
          }
          dp[i] = ds;
        }
        planes_of(hi[kk], lo[kk], dp, kk);
      }
      // dq += dS k, k MN-major (its 64 columns), two planes a step, into
      // a fresh chain (64 keys, two planes: 128 terms)
      const uint32_t kc = ka + (cb / 64) * kSlab;
      float ch[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        const uint64_t db = desc(kc + kk * 2048, kSlab, 1024);
        wgmma_rs<64, 1>(ch, hi[kk], db, kk > 0);
        wgmma_rs<64, 1>(ch, lo[kk], db, 1);
      }
      wg_commit();
      wg_wait<0>();
      fence_acc(ch);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] += ch[i];
    }
    // q and dO are read (its wgmmas have retired): the buffer goes back
    __syncwarp();
    if (lane == 0) mbar_arrive(&qempty[qb]);
    // the tiles it does not compute: their stages go back in order
    for (int j = nw; j < ntiles; ++j, ++it) {
      mbar_wait(&full[it % S], (it / S) & 1);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[it % S]);
    }
    // scale dq once, stage it as bf16 (once the last item's stores have
    // read the tile), then 16-byte chunks of whole rows
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    stage_acc(mine, acc, scale, warp, lane);
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    store_slab(dq + ((int64_t)bh * tq + r0) * D + cb, D, mine, tq - r0, lt);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
// each kernel's dynamic shared memory limit, set once a process (internal
// linkage: see wgmma_bf16.cuh's smem_attr)
namespace {
template <typename K>
cudaError_t smem_attr(K* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
template <int D>
cudaError_t fwd_attr() {
  static const cudaError_t err = smem_attr(fwd_kernel<D>, Fwd<D>::kSmem);
  return err;
}
template <int D>
cudaError_t bwd_attr() {
  static const cudaError_t err = [] {
    const cudaError_t e = smem_attr(dq_kernel<D>, Bwd<D>::kSmem1);
    return e != cudaSuccess ? e : smem_attr(dkv_kernel<D>, Bwd<D>::kSmem2);
  }();
  return err;
}
template <int D>
cudaError_t flash_dkv_attr() {
  static const cudaError_t err =
      smem_attr(flash_dkv_kernel<D>, FlashDkv<D>::kSmem);
  return err;
}
template <int D>
cudaError_t p_attr() {
  static const cudaError_t err = smem_attr(p_kernel<D>, Probs<D>::kSmem);
  return err;
}
template <int D>
cudaError_t flash_dq_attr() {
  static const cudaError_t err =
      smem_attr(flash_dq_kernel<D>, FlashDq<D>::kSmem);
  return err;
}
}  // namespace

// the map of a contiguous [bh][rows][inner] bf16 tensor, boxes of 64 x 64
inline cudaError_t map3(CUtensorMap* m, const void* p, int inner, int rows,
                        int64_t bh) {
  return hopper::make_map(m, Operand{p, inner, rows, (int)bh}, 64);
}

// #2 on contiguous q, o [bh, tq, D], k, v [bh, tk, D]; lse fp32 [bh, tq]
// or null
template <int D>
cudaError_t fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                float* lse, int64_t bh, int tq, int tk, float scale,
                int causal, cudaStream_t st) {
  if (tq < 1 || tk < 1 || bh < 1) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  cudaError_t err = map3(&mq, q, D, tq, bh);
  if (err == cudaSuccess) err = map3(&mk, k, D, tk, bh);
  if (err == cudaSuccess) err = map3(&mv, v, D, tk, bh);
  if (err == cudaSuccess) err = fwd_attr<D>();
  if (err != cudaSuccess) return err;
  const int64_t items = (int64_t)bh * ((tq + Fwd<D>::R - 1) / Fwd<D>::R);
  if (items >= (int64_t)1 << 31) return cudaErrorInvalidValue;
  const int blocks = (int)(items < hopper::sm_count() ? items
                                                      : hopper::sm_count());
  fwd_kernel<D><<<blocks, kThreads, Fwd<D>::kSmem, st>>>(
      mq, mk, mv, o, lse, tq, tk, scale, causal, (int)items);
  return cudaGetLastError();
}

// the row stride of #6's delta scratch: t rounded up to 128 (grid 1 writes
// every row its blocks cover; grid 2 reads it in 64-row tiles by TMA)
inline int delta_stride(int t) { return (t + 127) / 128 * 128; }

// #6 on contiguous q, k, v, g (dO), dq, dk, dv [bh, t, D] and P [bh, t,
// t]; delta: fp32 [bh, delta_stride(t)] scratch
template <int D>
cudaError_t bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* p,
                const bf16* g, bf16* dq, bf16* dk, bf16* dv, float* delta,
                int64_t bh, int t, float scale, int causal, cudaStream_t st) {
  if (t < 1 || bh < 1 || bh > 65535) return cudaErrorInvalidValue;
  using B = Bwd<D>;
  const int p_tma = t % 8 == 0;
  CUtensorMap mq, mk, mv, mg, mp;
  cudaError_t err = map3(&mq, q, D, t, bh);
  if (err == cudaSuccess) err = map3(&mk, k, D, t, bh);
  if (err == cudaSuccess) err = map3(&mv, v, D, t, bh);
  if (err == cudaSuccess) err = map3(&mg, g, D, t, bh);
  // P's map only where TMA takes its rows; else a copy of g's, unread
  if (err == cudaSuccess)
    err = p_tma ? map3(&mp, p, t, t, bh) : map3(&mp, g, D, t, bh);
  if (err == cudaSuccess) err = bwd_attr<D>();
  if (err != cudaSuccess) return err;
  const int tp = delta_stride(t);
  dq_kernel<D><<<dim3((unsigned)((t + B::R1 - 1) / B::R1), (unsigned)bh),
                 kThreads, B::kSmem1, st>>>(mg, mv, mk, mp, p, dq, delta, t,
                                            tp, scale, causal, p_tma);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkv_kernel<D><<<dim3((unsigned)((t + B::KB - 1) / B::KB), (unsigned)bh),
                  kThreads, B::kSmem2, st>>>(mv, mg, mq, mp, p, delta, dk, dv,
                                             t, tp, scale, causal, p_tma);
  return cudaGetLastError();
}

// #5 with P: #2 at tq == tk == t writing its lse to the scratch lse
// [bh, t] fp32, then P = ex2(S c - lse log2e) [bh, t, t] bf16 into p
// (2-byte aligned; any t)
template <int D>
cudaError_t fwd_with_p(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                       bf16* p, float* lse, int64_t bh, int t, float scale,
                       int causal, cudaStream_t st) {
  cudaError_t err = fwd<D>(q, k, v, o, lse, bh, t, t, scale, causal, st);
  if (err != cudaSuccess) return err;
  // P's rows go by TMA where they lie on 16 bytes (t % 8 == 0)
  const int p_vec = t % 8 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  CUtensorMap mq, mk, mp;
  err = map3(&mq, q, D, t, bh);
  if (err == cudaSuccess) err = map3(&mk, k, D, t, bh);
  // P's map (boxes of a warp's 16 rows) only where TMA takes its rows;
  // else a copy of q's, unread
  if (err == cudaSuccess)
    err = p_vec ? hopper::make_map(&mp, Operand{p, t, t, (int)bh}, 16)
                : map3(&mp, q, D, t, bh);
  if (err == cudaSuccess) err = p_attr<D>();
  if (err != cudaSuccess) return err;
  const int64_t items = (int64_t)bh * ((t + Probs<D>::R - 1) / Probs<D>::R);
  const int blocks = (int)(items < hopper::sm_count() ? items
                                                      : hopper::sm_count());
  p_kernel<D><<<blocks, kThreads, Probs<D>::kSmem, st>>>(
      mq, mk, mp, lse, p, t, scale, causal, (int)items, p_vec);
  return cudaGetLastError();
}

// #4 on contiguous q, g (dO) [bh, tq, D], k, v, dk, dv [bh, tk, D]; lse
// and delta fp32 [bh, tq]
template <int D>
cudaError_t flash_dkv(const bf16* q, const bf16* k, const bf16* v,
                      const bf16* g, const float* lse, const float* delta,
                      bf16* dk, bf16* dv, int64_t bh, int tq, int tk,
                      float scale, int causal, cudaStream_t st) {
  if (tq < 1 || tk < 1 || bh < 1 || bh > 65535) return cudaErrorInvalidValue;
  using F = FlashDkv<D>;
  CUtensorMap mq, mk, mv, mg;
  cudaError_t err = map3(&mq, q, D, tq, bh);
  if (err == cudaSuccess) err = map3(&mk, k, D, tk, bh);
  if (err == cudaSuccess) err = map3(&mv, v, D, tk, bh);
  if (err == cudaSuccess) err = map3(&mg, g, D, tq, bh);
  if (err == cudaSuccess) err = flash_dkv_attr<D>();
  if (err != cudaSuccess) return err;
  // a bulk copy takes lse's and delta's rows where they lie on 16 bytes
  const int vec_tma = tq % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(lse) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(delta) % 16 == 0;
  flash_dkv_kernel<D>
      <<<dim3((unsigned)((tk + F::KB - 1) / F::KB), (unsigned)bh), kThreads,
         F::kSmem, st>>>(mk, mv, mq, mg, lse, delta, dk, dv, tq, tk, scale,
                         causal, vec_tma);
  return cudaGetLastError();
}

// #3 on contiguous q, g (dO), dq [bh, tq, D], k, v [bh, tk, D]; lse and
// delta fp32 [bh, tq] (any alignment: the threads load their rows)
template <int D>
cudaError_t flash_dq(const bf16* q, const bf16* k, const bf16* v,
                     const bf16* g, const float* lse, const float* delta,
                     bf16* dq, int64_t bh, int tq, int tk, float scale,
                     int causal, cudaStream_t st) {
  if (tq < 1 || tk < 1 || bh < 1) return cudaErrorInvalidValue;
  using F = FlashDq<D>;
  CUtensorMap mq, mk, mv, mg;
  cudaError_t err = map3(&mq, q, D, tq, bh);
  if (err == cudaSuccess) err = map3(&mk, k, D, tk, bh);
  if (err == cudaSuccess) err = map3(&mv, v, D, tk, bh);
  if (err == cudaSuccess) err = map3(&mg, g, D, tq, bh);
  if (err == cudaSuccess) err = flash_dq_attr<D>();
  if (err != cudaSuccess) return err;
  const int64_t items = bh * ((tq + F::R - 1) / F::R);
  if (items >= (int64_t)1 << 31) return cudaErrorInvalidValue;
  const int blocks = (int)(items < hopper::sm_count() ? items
                                                      : hopper::sm_count());
  flash_dq_kernel<D><<<blocks, kThreads, F::kSmem, st>>>(
      mq, mk, mv, mg, lse, delta, dq, tq, tk, scale, causal, (int)items);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The operand forms alone, for a check against float64: C [64, N] fp32 =
// A B over a depth of 128, one warpgroup, the operands brought by TMA as
// the kernels bring theirs.
//   form 0: SS, A [64][128] and B [N][128] K-major (S, dP, dP^T)
//   form 1: SS, A [128][64] and B [128][N] MN-major (P^T dO)
//   form 2: RS, A fp32 [64][128] as planes from the accumulator layout, B
//           [128][N] MN-major (P v, dS k, dS^T q)
// ---------------------------------------------------------------------------
template <int N, int FORM>
__global__ void __launch_bounds__(128, 1)
    form_kernel(const __grid_constant__ CUtensorMap ma,
                const __grid_constant__ CUtensorMap mb,
                const float* __restrict__ a32, float* __restrict__ c) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  uint8_t* as = aligned(smem_raw);  // 16 KB
  uint8_t* bs = as + 2 * kSlab;     // N * 256 bytes
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  if (tid == 0) {
    mbar_init(&bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar, (FORM == 2 ? 0 : 2 * kSlab) + N * 256);
    for (int s = 0; s < 2; ++s) {
      if (FORM == 0) tma_load(as + s * kSlab, &ma, &bar, 64 * s, 0, 0);
      if (FORM == 1) tma_load(as + s * kSlab, &ma, &bar, 0, 64 * s, 0);
    }
    for (int s = 0; s < 2; ++s)
      for (int rc = 0; rc < N / 64; ++rc) {
        if (FORM == 0)  // [N][128]: slab s of k, rows 64 rc
          tma_load(bs + s * N * 128 + rc * kSlab, &mb, &bar, 64 * s, 64 * rc,
                   0);
        else  // [128][N]: slab rc of n, rows 64 s
          tma_load(bs + rc * 2 * kSlab + s * kSlab, &mb, &bar, 64 * rc,
                   64 * s, 0);
      }
  }
  mbar_wait(&bar, 0);
  const uint32_t aa = smem_u32(as), ba = smem_u32(bs);
  float d[N / 2];
  if constexpr (FORM == 2) {
    float x[64];
#pragma unroll
    for (int i = 0; i < 64; ++i)
      x[i] = a32[(16 * warp + g + 8 * ((i >> 1) & 1)) * 128 + 8 * (i / 4) +
                 2 * t4 + (i & 1)];
    uint32_t hi[8][4], lo[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) planes_of(hi[kk], lo[kk], x, kk);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t db = desc(ba + kk * 2048, 2 * kSlab, 1024);
      wgmma_rs<N, 1>(d, hi[kk], db, kk > 0);
      wgmma_rs<N, 1>(d, lo[kk], db, 1);
    }
  } else {
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      if constexpr (FORM == 0)
        wgmma_ss<N, 0, 0>(d, desc(aa + (kk / 4) * kSlab + (kk % 4) * 32, 16, 1024),
                          desc(ba + (kk / 4) * N * 128 + (kk % 4) * 32, 16, 1024),
                          kk > 0);
      else
        wgmma_ss<N, 1, 1>(d, desc(aa + kk * 2048, 2 * kSlab, 1024),
                          desc(ba + kk * 2048, 2 * kSlab, 1024), kk > 0);
    }
  }
  wg_commit();
  wg_wait<0>();
  fence_acc(d);
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    c[(16 * warp + g + 8 * ((i >> 1) & 1)) * N + 8 * (i / 4) + 2 * t4 +
      (i & 1)] = d[i];
}

namespace {
template <int N, int FORM>
cudaError_t form_attr(size_t smem) {
  static const cudaError_t err = smem_attr(form_kernel<N, FORM>, smem);
  return err;
}
}  // namespace

template <int N, int FORM>
cudaError_t form(const void* a, const void* b, float* c, cudaStream_t st) {
  CUtensorMap ma, mb;
  // A: [64][128] (form 0) or [128][64] (form 1); form 2 reads a32 alone
  cudaError_t err = FORM == 1 ? map3(&ma, a, 64, 128, 1)
                    : FORM == 0 ? map3(&ma, a, 128, 64, 1)
                                : map3(&ma, b, N, 128, 1);
  if (err == cudaSuccess)
    err = FORM == 0 ? map3(&mb, b, 128, N, 1) : map3(&mb, b, N, 128, 1);
  const size_t smem = 2 * kSlab + N * 256 + 1024;
  if (err == cudaSuccess) err = form_attr<N, FORM>(smem);
  if (err != cudaSuccess) return err;
  form_kernel<N, FORM><<<1, 128, smem, st>>>(
      ma, mb, static_cast<const float*>(a), c);
  return cudaGetLastError();
}

}  // namespace attn_wgmma
