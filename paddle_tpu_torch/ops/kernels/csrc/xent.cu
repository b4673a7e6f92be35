// Fused softmax cross-entropy, forward and backward, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/xent.py `xent_forward` (`_fwd_kernel`)
// and `xent_backward` (`_bwd_kernel`), the Pallas TPU kernels behind
// `softmax_with_cross_entropy` and its grad with hard labels (routed
// from ops/nn_ops.py).
//
// Computes, per row of logits x [N, V] (fp32 or bf16, fp32 arithmetic)
// with an int64 label:
//   forward:  lse = log sum_j exp(x_j)
//             loss = (1-eps)(lse - x[lab]) + eps(lse - mean_j x_j)
//             (eps == 0: lse - x[lab]); loss = 0 where lab == ignore.
//   backward: dx_j = (exp(x_j - lse) - (1-eps)[j == lab] - eps/V) * g,
//             lse recomputed; a zero row where lab == ignore; dx in the
//             logits' type, g fp32.
// A label outside [0, V) picks 0 and matches no column, as the TPU
// kernel's `cols == lab` compare does; it is not read.
//
// What bounds it on an H100: bytes. At the training slice's shape
// [16384, 32000] fp32 the forward reads 2.1 GB and writes 131 KB (0.63 ms
// at 3.35 TB/s); the backward reads and writes 2.1 GB each (1.25 ms).
// One exp and a few adds per element is about 0.5 operations a byte,
// far below the ~20 a byte at which fp32 arithmetic would take over.
//
// What the design does about it. Forward: each row is read from device
// memory once, and no [N, V] intermediate is kept. A plan chosen on the
// host by V gives each row a group of threads (`fwd_lanes`):
// - V <= 32: a group of lanes a row (as many lanes as the row has
//   16-byte packs, rounded up to a power of two), 256 / lanes rows a
//   block;
// - V > 32 with rows of up to kFwdWarpMaxBytes (fp32 V 4096, bf16 V
//   8192): a warp a row, 8 rows a block;
// - wider rows: a block of 256 threads a row.
// Each thread reads its columns with 16-byte loads (kFwdUnroll in flight),
// scalar columns around them where the row starts off 16 bytes (fp32
// V % 4, bf16 V % 8), and keeps a (max, sum of exp) pair in the log2
// domain: a batch of loads takes its max first, rescales the sum once and
// adds one ex2 an element (x log2e - max in one FFMA); the plain row sum
// only when eps != 0; the thread whose columns hold the label keeps
// x[label]. The pairs merge with warp shuffles in a fixed butterfly
// order (the 8 warps of a block's row then through shared memory, in
// warp order), so a second launch gives the same bits; a group's lane 0
// (a block's thread 0) writes the row's loss and lse. The crossovers were
// set by timing the plans at V 10 to 32000 on an H100 (PERF.md).
//
// Backward: each row crosses from device memory once and dx is written
// once, the byte bound. A row is split over a thread-block cluster of
// C CTAs (1, 2, 4 or 8: the fewest whose slices hold kSliceTarget
// columns or fewer; 2 at V 32000, so three half rows are resident on an
// SM and one's reads overlap another's writes). Each CTA stages its
// slice in shared memory as fp32 with 16-byte loads, eight in flight a
// thread, taking the slice's max as it goes; then it replaces each
// staged x by e = exp(x - max) and sums them, one exp2 an element. Each
// CTA writes its (max, sum) pair into every CTA's shared memory of the
// cluster, passes one cluster barrier and merges the C pairs in rank
// order, so every CTA holds the same lse bits and dx repeats bit for bit
// (no atomics). Each then writes dx = e * exp(max_c - max) / sum * g -
// (eps/V + (1-eps)[j == label]) * g from its staged e with 16-byte
// stores. A slice that does not start on a 16-byte boundary (fp32 V % 4,
// bf16 V % 8) takes scalar columns around the vector body. A row too wide
// for eight CTAs' shared memory (V above 409536) takes a streamed body
// with the same split and merge: a first pass with running (max, sum of
// exp) pairs and a second that reads x again to write dx. An ignored row
// is written as zeros without reading x. Any N and V are taken (no
// N % 32 or V % 128 tiling condition as on the TPU).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Folds one element into the running (max m, sum of exp(x - m)) pair
// with one exp. A -inf element adds nothing.
__device__ __forceinline__ void push(float& m, float& s, float xi) {
  if (xi > m) {
    s = s * expf(m - xi) + 1.f;
    m = xi;
  } else if (xi != -INFINITY) {
    s += expf(xi - m);
  }
}

// Folds another thread's pair into (m, s). A pair whose max is -inf
// holds nothing and leaves the other as it is.
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  if (m2 == -INFINITY) return;
  if (m == -INFINITY) {
    m = m2;
    s = s2;
    return;
  }
  const float mx = fmaxf(m, m2);
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

// ---------------------------------------------------------------------------
// Backward.
constexpr int kBwdThreads = 256;
constexpr int kBwdUnroll = 8;  // 16-byte loads a thread keeps in flight
// The most columns a CTA stages before the row is split over more CTAs:
// 64 KB of fp32, three CTAs an SM. Chosen by timing 1, 2, 4 and 8 CTAs a
// row at the training shape [16384, 32000] (PERF.md): 2 was fastest in
// fp32 and bf16.
constexpr int kSliceTarget = 16384;
constexpr int kMaxCluster = 8;  // the portable cluster size
// The most fp32 columns a staged slice may take in shared memory.
constexpr int kMaxStageFloats = 200 * 1024 / 4;
constexpr int kStageSlack = 8;  // for a slice that starts inside a pack
constexpr float kLog2e = 1.4426950408889634f;

// Columns of T in 16 bytes.
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  static constexpr int kN = 4;
};
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kN = 8;
};

__device__ __forceinline__ void unpack16(uint4 r, float* f, const float*) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack16(uint4 r, float* f,
                                         const __nv_bfloat16*) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack16(const float* f, const float*) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack16(const float* f,
                                        const __nv_bfloat16*) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// `len` columns starting at `p`, cut for 16-byte access: `mis` columns
// past the last 16-byte boundary at p, then `head` scalar columns up to
// the next one, `nvec` packs, and scalar columns from `tail` to the end.
struct Slice {
  int len, mis, head, nvec, tail;
  // the k-th of the head and tail columns
  __device__ __forceinline__ int scalar_col(int k) const {
    return k < head ? k : tail + (k - head);
  }
  __device__ __forceinline__ int scalars() const {
    return head + (len - tail);
  }
};

template <typename T>
__device__ __forceinline__ Slice slice_of(const T* p, int len) {
  constexpr int kN = Pack<T>::kN;
  Slice s;
  s.len = len;
  s.mis = (int)((reinterpret_cast<uintptr_t>(p) / sizeof(T)) % kN);
  s.head = min(len, (kN - s.mis) % kN);
  s.nvec = (len - s.head) / kN;
  s.tail = s.head + s.nvec * kN;
  return s;
}

// The block's max (kMax) or sum of v, in a fixed order; every thread
// gets lane 0's result. `red` holds 33 floats.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, w) : v + w;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : (kMax ? -INFINITY : 0.f);
    for (int o = 16; o > 0; o >>= 1) {
      const float w = __shfl_xor_sync(0xffffffffu, v, o);
      v = kMax ? fmaxf(v, w) : v + w;
    }
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

// The block's (max, sum of exp) pairs merged in a fixed order; every
// thread gets the result. `red` holds 66 floats.
__device__ __forceinline__ void block_merge(float& m, float& s, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    merge(m, s, m2, s2);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[warp] = m;
    red[33 + warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    const bool in = lane < (int)(blockDim.x >> 5);
    m = in ? red[lane] : -INFINITY;
    s = in ? red[33 + lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
      const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
      merge(m, s, m2, s2);
    }
    if (lane == 0) {
      red[32] = m;
      red[65] = s;
    }
  }
  __syncthreads();
  m = red[32];
  s = red[65];
}

// One row's dx over a cluster of CTAs, each CTA a slice of `chunk`
// columns (a multiple of 8; the last slice may be shorter or empty).
// kStaged: the slice lives in shared memory (`chunk` + kStageSlack fp32
// columns of dynamic shared memory, column j at stage[mis + j], -inf
// around it up to 8-column boundaries) and x is read once; else x is
// read twice, with running (max, sum of exp) pairs in the first pass.
// exp(x - m) is taken as exp2(x log2(e) - m log2(e)), one fma and one
// exp2 an element.
template <typename T, bool kStaged>
__global__ void __launch_bounds__(kBwdThreads, 4)
    xent_bwd_kernel(const T* __restrict__ x, const int64_t* __restrict__ lab,
                    const float* __restrict__ g, T* __restrict__ dx, int v,
                    int chunk, float eps, int64_t ignore) {
  constexpr int kN = Pack<T>::kN;
  extern __shared__ float4 stage4[];
  float* stage = reinterpret_cast<float*>(stage4);
  __shared__ float red[66];
  __shared__ float pairs[2 * kMaxCluster];
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int64_t row = blockIdx.x / ranks;
  const int64_t start = (int64_t)rank * chunk;
  const int s0 = start < v ? (int)start : v;
  const int len = min(v - s0, chunk);
  const T* xp = x + row * v + s0;
  T* dp = dx + row * v + s0;
  const Slice xs = slice_of(xp, len);
  const Slice ds = slice_of(dp, len);
  const int64_t l = lab[row];
  if (l == ignore) {
    for (int k = tid; k < ds.scalars(); k += nt) {
      dp[ds.scalar_col(k)] = from_f<T>(0.f);
    }
    uint4* d4 = reinterpret_cast<uint4*>(dp + ds.head);
    for (int c = tid; c < ds.nvec; c += nt) d4[c] = make_uint4(0, 0, 0, 0);
    return;
  }

  // Pass 1: the slice's max, staging it (kStaged, with -inf around it up
  // to 8-column boundaries: exp gives 0 there), or its (max, sum of exp)
  // pair.
  float m = -INFINITY, s = 0.f;
  auto take = [&](float xi) {
    if constexpr (kStaged) {
      m = fmaxf(m, xi);
    } else {
      push(m, s, xi);
    }
  };
  const int end = xs.mis + len;
  const int end8 = (end + 7) / 8 * 8;
  if (kStaged) {
    if (tid < xs.mis) {
      stage[tid] = -INFINITY;
    } else if (tid >= 8 && tid - 8 < end8 - end) {
      stage[end + tid - 8] = -INFINITY;
    }
  }
  for (int k = tid; k < xs.scalars(); k += nt) {
    const int j = xs.scalar_col(k);
    const float xi = to_f(xp[j]);
    if (kStaged) stage[xs.mis + j] = xi;
    take(xi);
  }
  {
    const uint4* src = reinterpret_cast<const uint4*>(xp + xs.head);
    // xs.mis + xs.head is 0 or kN: a 16-byte boundary
    float4* dst = reinterpret_cast<float4*>(stage + xs.mis + xs.head);
    for (int c0 = tid; c0 < xs.nvec; c0 += kBwdUnroll * nt) {
      uint4 r[kBwdUnroll];
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u) {
        const int c = c0 + u * nt;
        if (c < xs.nvec) r[u] = __ldcs(src + c);
      }
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u) {
        const int c = c0 + u * nt;
        if (c >= xs.nvec) break;
        float f[kN];
        unpack16(r[u], f, xp);
#pragma unroll
        for (int q = 0; q < kN; ++q) take(f[q]);
        if (kStaged) {
#pragma unroll
          for (int q = 0; q < kN; q += 4) {
            dst[c * (kN / 4) + q / 4] =
                make_float4(f[q], f[q + 1], f[q + 2], f[q + 3]);
          }
        }
      }
    }
  }
  if (kStaged) {
    m = block_reduce<true>(m, red);
    // Pass 2: e = exp(x - m) in place, and its sum. A slice that is all
    // -inf (or empty) holds e = 0.
    const float ml = (m == -INFINITY ? 0.f : m) * kLog2e;
    float4* st4 = reinterpret_cast<float4*>(stage);
    for (int i = tid; i < end8 / 4; i += nt) {
      float4 a = st4[i];
      a.x = exp2f(fmaf(a.x, kLog2e, -ml));
      a.y = exp2f(fmaf(a.y, kLog2e, -ml));
      a.z = exp2f(fmaf(a.z, kLog2e, -ml));
      a.w = exp2f(fmaf(a.w, kLog2e, -ml));
      st4[i] = a;
      s += (a.x + a.y) + (a.z + a.w);
    }
    s = block_reduce<false>(s, red);
  } else {
    block_merge(m, s, red);
  }

  // The row's (max, sum of exp): every CTA merges all the cluster's pairs
  // in rank order, so all hold the same bits. Each writes its pair into
  // every CTA's `pairs` before the cluster barrier and reads only its own
  // after it: one barrier, and no CTA touches another's shared memory
  // once past it.
  float mrow = m, srow = s;
  if (ranks > 1) {
    if (tid < ranks) {
      float* to = cluster.map_shared_rank(pairs, tid);
      to[2 * rank] = m;
      to[2 * rank + 1] = s;
    }
    cluster.sync();
    mrow = -INFINITY;
    for (int r = 0; r < ranks; ++r) mrow = fmaxf(mrow, pairs[2 * r]);
    srow = 0.f;
    for (int r = 0; r < ranks; ++r) {
      const float mr = pairs[2 * r];
      if (mr != -INFINITY) srow += pairs[2 * r + 1] * expf(mr - mrow);
    }
  }

  // Pass 3: dx = e * scale - (eps/V + (1-eps)[j == label]) * g, with
  // e = exp(x - m) and scale = exp(m - mrow) / srow * g.
  const float gr = g[row];
  const float ml = (m == -INFINITY ? 0.f : m) * kLog2e;
  const float scale = m == -INFINITY ? 0.f : expf(m - mrow) / srow * gr;
  const float ug = (eps != 0.f ? eps / v : 0.f) * gr;
  const float hg = (1.f - eps) * gr;
  const int64_t lcol = l - s0;  // the label's column in the slice
  auto out = [&](int j, float e) {
    const float d = fmaf(e, scale, -ug);
    return j == lcol ? d - hg : d;
  };
  auto e_at = [&](int j, float xj) {
    return kStaged ? stage[xs.mis + j] : exp2f(fmaf(xj, kLog2e, -ml));
  };
  if (ds.mis != xs.mis) {  // x and dx out of phase: scalar columns only
    for (int j = tid; j < len; j += nt) {
      dp[j] = from_f<T>(out(j, e_at(j, kStaged ? 0.f : to_f(xp[j]))));
    }
    return;
  }
  for (int k = tid; k < ds.scalars(); k += nt) {
    const int j = ds.scalar_col(k);
    dp[j] = from_f<T>(out(j, e_at(j, kStaged ? 0.f : to_f(xp[j]))));
  }
  const uint4* src = reinterpret_cast<const uint4*>(xp + xs.head);
  const float4* est = reinterpret_cast<const float4*>(stage + xs.mis +
                                                      xs.head);
  uint4* d4 = reinterpret_cast<uint4*>(dp + ds.head);
  // the pack that holds the label's column, and its place there
  const int64_t lbody = lcol - ds.head;
  const int lpack = lbody >= 0 && lbody < (int64_t)ds.nvec * kN
                        ? (int)(lbody / kN) : -1;
  const int lq = (int)(lbody - (int64_t)lpack * kN);
#pragma unroll 4
  for (int c = tid; c < ds.nvec; c += nt) {
    float f[kN];
    if (kStaged) {
#pragma unroll
      for (int q = 0; q < kN; q += 4) {
        const float4 e4 = est[c * (kN / 4) + q / 4];
        f[q] = e4.x;
        f[q + 1] = e4.y;
        f[q + 2] = e4.z;
        f[q + 3] = e4.w;
      }
    } else {
      unpack16(__ldcs(src + c), f, xp);
#pragma unroll
      for (int q = 0; q < kN; ++q) f[q] = exp2f(fmaf(f[q], kLog2e, -ml));
    }
#pragma unroll
    for (int q = 0; q < kN; ++q) f[q] = fmaf(f[q], scale, -ug);
    if (c == lpack) {
#pragma unroll
      for (int q = 0; q < kN; ++q) f[q] -= q == lq ? hg : 0.f;
    }
    d4[c] = pack16(f, dp);
  }
}

// ---------------------------------------------------------------------------
// Forward.
constexpr int kFwdThreads = 256;
constexpr int kFwdUnroll = 8;  // 16-byte loads a thread keeps in flight
// The widest row, in bytes, a warp takes (fp32 V 4096, bf16 V 8192);
// wider rows take a block. Chosen by timing a warp and a block a row at
// 16384 rows on an H100 (chip_smoke.py `_xent_fwd_plans`, PERF.md): a
// warp is faster at V 10 to 4096 in both types (V 4096 fp32 0.0906
// against 0.0939 ms) and at V 8192 in bf16 (0.0927 against 0.1366), a
// block at V 8192 in fp32 (0.1709 against 0.1776) and at V 32000 in both.
constexpr int kFwdWarpMaxBytes = 16384;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The running pair (ml, s): ml the largest value taken times log2(e)
// (-inf before any), s the sum of 2^(x log2(e) - ml). A batch whose max
// is bm rescales s once; returns what each of the batch's values
// subtracts before its ex2 (0 while ml is -inf: the values are all -inf).
__device__ __forceinline__ float rebase(float& ml, float& s, float bm) {
  const float mn = fmaxf(ml, bm * kLog2e);
  s = mn == ml ? s : s * ex2(ml - mn);
  ml = mn;
  return mn == -INFINITY ? 0.f : mn;
}

// Folds the pair (ml2, s2) into (ml, s): the same bits whichever of the
// two is folded into the other.
__device__ __forceinline__ void fold(float& ml, float& s, float ml2,
                                     float s2) {
  const float mx = fmaxf(ml, ml2);
  s = (ml == mx ? s : s * ex2(ml - mx)) + (ml2 == mx ? s2 : s2 * ex2(ml2 - mx));
  ml = mx;
}

// One row's pair over the columns of thread `li` of the `nl` that share
// it, its plain sum (kEps) and x[l] (left as it is unless this thread's
// columns hold column l): scalar head and tail columns, then kUnroll
// 16-byte packs at a time, each batch's max first.
template <typename T, int kUnroll, bool kEps>
__device__ __forceinline__ void row_sweep(const T* __restrict__ xr, int len,
                                          int64_t l, int li, int nl,
                                          float& ml, float& s, float& tot,
                                          float& picked) {
  constexpr int kN = Pack<T>::kN;
  const Slice xs = slice_of(xr, len);
  for (int k = li; k < xs.scalars(); k += nl) {
    const int j = xs.scalar_col(k);
    const float xi = to_f(xr[j]);
    const float sub = rebase(ml, s, xi);
    s += ex2(fmaf(xi, kLog2e, -sub));
    if (kEps) tot += xi;
    if (j == l) picked = xi;
  }
  const uint4* src = reinterpret_cast<const uint4*>(xr + xs.head);
  // the pack that holds the label's column, and its place there
  const int64_t lbody = l - xs.head;
  const int lpack = lbody >= 0 && lbody < (int64_t)xs.nvec * kN
                        ? (int)(lbody / kN) : -1;
  const int lq = (int)(lbody - (int64_t)lpack * kN);
  for (int c0 = li; c0 < xs.nvec; c0 += kUnroll * nl) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * nl;
      if (c < xs.nvec) r[u] = __ldcs(src + c);
    }
    float bm = -INFINITY;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c0 + u * nl >= xs.nvec) break;
      float f[kN];
      unpack16(r[u], f, xr);
#pragma unroll
      for (int q = 0; q < kN; ++q) bm = fmaxf(bm, f[q]);
    }
    const float sub = rebase(ml, s, bm);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * nl;
      if (c >= xs.nvec) break;
      float f[kN], e[kN];
      unpack16(r[u], f, xr);
#pragma unroll
      for (int q = 0; q < kN; ++q) e[q] = ex2(fmaf(f[q], kLog2e, -sub));
      // pairwise, in a fixed order
#pragma unroll
      for (int w = 1; w < kN; w *= 2)
#pragma unroll
        for (int q = 0; q < kN; q += 2 * w) {
          e[q] += e[q + w];
          if (kEps) f[q] += f[q + w];
        }
      s += e[0];
      if (kEps) tot += f[0];
      if (c == lpack) {
        unpack16(r[u], f, xr);
#pragma unroll
        for (int q = 0; q < kN; ++q) picked = q == lq ? f[q] : picked;
      }
    }
  }
}

// loss and lse of rows of v columns: `lanes` threads a row (a power of
// two up to 32, 256 / lanes rows a block), or with kRow == kFwdThreads a
// block a row. The row's threads merge their pairs, sums and picks by
// warp shuffles in a fixed butterfly order (a block's 8 warps then in
// warp order through shared memory); its first thread writes.
template <typename T, int kRow, int kUnroll, bool kEps>
__global__ void __launch_bounds__(kFwdThreads)
    xent_fwd_kernel(const T* __restrict__ x, const int64_t* __restrict__ lab,
                    float* __restrict__ loss, float* __restrict__ lse_out,
                    int64_t n, int v, int lanes, float eps, int64_t ignore) {
  const int tid = threadIdx.x;
  const int nl = kRow == kFwdThreads ? kFwdThreads : lanes;
  const int64_t row = (int64_t)blockIdx.x * (kFwdThreads / nl) + tid / nl;
  // a row past n takes part in its warp's shuffles with no columns
  const bool live = row < n;
  const int64_t l = live ? lab[row] : -1;
  float ml = -INFINITY, s = 0.f, tot = 0.f, picked = 0.f;
  row_sweep<T, kUnroll, kEps>(x + (live ? row : 0) * (int64_t)v,
                              live ? v : 0, l, tid % nl, nl, ml, s, tot,
                              picked);
  const int width = kRow == kFwdThreads ? 32 : nl;
  for (int o = 1; o < width; o <<= 1) {
    const float ml2 = __shfl_xor_sync(0xffffffffu, ml, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    fold(ml, s, ml2, s2);
    if (kEps) tot += __shfl_xor_sync(0xffffffffu, tot, o);
    picked += __shfl_xor_sync(0xffffffffu, picked, o);
  }
  if constexpr (kRow == kFwdThreads) {
    constexpr int kWarps = kFwdThreads / 32;
    __shared__ float red[4][kWarps];
    if (tid % 32 == 0) {
      red[0][tid / 32] = ml;
      red[1][tid / 32] = s;
      red[2][tid / 32] = tot;
      red[3][tid / 32] = picked;
    }
    __syncthreads();
    if (tid != 0) return;
    ml = red[0][0], s = red[1][0], tot = red[2][0], picked = red[3][0];
    for (int w = 1; w < kWarps; ++w) {
      fold(ml, s, red[0][w], red[1][w]);
      tot += red[2][w];
      picked += red[3][w];
    }
  } else if (tid % nl != 0 || !live) {
    return;
  }
  const float lse = ml * kLn2 + logf(s);
  float out = lse - picked;
  if (kEps) out = (1.f - eps) * out + eps * (lse - tot / v);
  loss[row] = l == ignore ? 0.f : out;
  lse_out[row] = lse;
}

__global__ void empty_kernel() {}

}  // namespace

namespace {

// Threads a row of v columns of T in the forward: a power of two up to 32
// (lanes of a warp: 32 from V 33 up to kFwdWarpMaxBytes a row), or
// kFwdThreads (a block). At V <= 32, as many lanes as the row has 16-byte
// packs.
template <typename T>
int fwd_lanes(int v) {
  if (v > 32)
    return (int64_t)v * sizeof(T) <= kFwdWarpMaxBytes ? 32 : kFwdThreads;
  const int packs = (v + Pack<T>::kN - 1) / Pack<T>::kN;
  int l = 1;
  while (l < packs) l *= 2;
  return l;
}

template <typename T, int kRow, int kUnroll>
cudaError_t launch_fwd(const void* x, const int64_t* lab, float* loss,
                       float* lse, int64_t n, int v, int lanes, float eps,
                       int64_t ignore, cudaStream_t st) {
  const int64_t rows = kRow == kFwdThreads ? 1 : kFwdThreads / lanes;
  const int64_t blocks = (n + rows - 1) / rows;
  if (blocks >= ((int64_t)1 << 31)) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  if (eps != 0.f)
    xent_fwd_kernel<T, kRow, kUnroll, true><<<(unsigned)blocks, kFwdThreads,
                                               0, st>>>(
        xt, lab, loss, lse, n, v, lanes, eps, ignore);
  else
    xent_fwd_kernel<T, kRow, kUnroll, false><<<(unsigned)blocks,
                                                kFwdThreads, 0, st>>>(
        xt, lab, loss, lse, n, v, lanes, eps, ignore);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_with(const void* x, const int64_t* lab, float* loss,
                     float* lse, int64_t n, int v, float eps, int64_t ignore,
                     int lanes, int unroll, cudaStream_t st) {
  if (lanes == kFwdThreads) {
    switch (unroll) {
      case 1:
        return launch_fwd<T, kFwdThreads, 1>(x, lab, loss, lse, n, v, lanes,
                                             eps, ignore, st);
      case 2:
        return launch_fwd<T, kFwdThreads, 2>(x, lab, loss, lse, n, v, lanes,
                                             eps, ignore, st);
      case 4:
        return launch_fwd<T, kFwdThreads, 4>(x, lab, loss, lse, n, v, lanes,
                                             eps, ignore, st);
      case kFwdUnroll:
        return launch_fwd<T, kFwdThreads, kFwdUnroll>(x, lab, loss, lse, n, v,
                                                      lanes, eps, ignore, st);
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0 ||
      unroll != kFwdUnroll)
    return cudaErrorInvalidValue;
  return launch_fwd<T, 32, kFwdUnroll>(x, lab, loss, lse, n, v, lanes, eps,
                                       ignore, st);
}

}  // namespace

// The forward with its plan given: `lanes` threads a row (a power of two
// up to 32, or 256: a block a row) and, for a block a row, `unroll`
// 16-byte loads in flight a thread (1, 2, 4 or 8; else 8), as the timing
// of the plans needs. x: [n, v] device pointer, fp32 (bf16 when `bf16` is
// nonzero); lab: int64 [n]; loss, lse: fp32 [n]. Launches on `stream` and
// returns cudaGetLastError() of the launch (1, cudaErrorInvalidValue, for
// a plan it does not take).
extern "C" int xent_fwd_with(const void* x, const void* lab, void* loss,
                             void* lse, int64_t n, int v, float eps,
                             int64_t ignore, int bf16, int lanes, int unroll,
                             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* lb = static_cast<const int64_t*>(lab);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  return (int)(bf16 ? fwd_with<__nv_bfloat16>(x, lb, lo, ls, n, v, eps,
                                              ignore, lanes, unroll, st)
                    : fwd_with<float>(x, lb, lo, ls, n, v, eps, ignore,
                                      lanes, unroll, st));
}

// The forward on the plan xent_fwd_plan gives for v.
extern "C" int xent_fwd(const void* x, const void* lab, void* loss, void* lse,
                        int64_t n, int v, float eps, int64_t ignore, int bf16,
                        void* stream) {
  const int lanes = bf16 ? fwd_lanes<__nv_bfloat16>(v) : fwd_lanes<float>(v);
  return xent_fwd_with(x, lab, loss, lse, n, v, eps, ignore, bf16, lanes,
                       kFwdUnroll, stream);
}

// The threads a row (1-32 lanes of a warp, or 256: a block) that
// xent_fwd takes for rows of v columns (bf16 nonzero: bf16 logits).
extern "C" int xent_fwd_plan(int v, int bf16) {
  return bf16 ? fwd_lanes<__nv_bfloat16>(v) : fwd_lanes<float>(v);
}

// An empty kernel launched as `blocks` blocks of 256 threads in clusters
// of one, as the xent backward launches its CTAs at V <= kSliceTarget:
// the launch's own cost, to set beside the kernels' times at small V.
extern "C" int xent_empty(int64_t blocks, void* stream) {
  if (blocks < 1 || blocks >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kBwdThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, empty_kernel);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

namespace {

// Columns of each CTA's slice when a row of v columns is split over
// `cluster` CTAs: a multiple of 8, so every slice but the first starts
// in the same 16-byte phase as the row.
int bwd_chunk(int v, int cluster) {
  return (int)((((int64_t)v + cluster - 1) / cluster + 7) / 8 * 8);
}

template <typename T, bool kStaged>
cudaError_t launch_bwd(const void* x, const int64_t* lab, const float* g,
                       void* dx, int64_t n, int v, float eps, int64_t ignore,
                       int cluster, cudaStream_t st) {
  const int chunk = bwd_chunk(v, cluster);
  const size_t smem =
      kStaged ? (size_t)(chunk + kStageSlack) * sizeof(float) : 0;
  void (*kern)(const T*, const int64_t*, const float*, T*, int, int, float,
               int64_t) = xent_bwd_kernel<T, kStaged>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n * cluster));
  cfg.blockDim = dim3(kBwdThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(x), lab, g,
                            static_cast<T*>(dx), v, chunk, eps, ignore);
}

// The backward's launch plan for rows of v columns: the fewest CTAs a
// row (1, 2, 4 or 8) whose slices hold kSliceTarget columns or fewer,
// and whether such a slice fits shared memory (staged) or is streamed.
void bwd_plan(int v, int* cluster, int* staged) {
  int c = 1;
  while (c < kMaxCluster && ((int64_t)v + c - 1) / c > kSliceTarget) c *= 2;
  *cluster = c;
  *staged = bwd_chunk(v, c) + kStageSlack <= kMaxStageFloats;
}

}  // namespace

// xent_bwd with its cluster size (1, 2, 4 or 8) and body (`staged`
// nonzero: the slice in shared memory, which must fit; else streamed)
// given, as the timing of cluster sizes needs.
extern "C" int xent_bwd_with(const void* x, const void* lab, const void* g,
                             void* dx, int64_t n, int v, float eps,
                             int64_t ignore, int bf16, int cluster,
                             int staged, void* stream) {
  if ((cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      n * cluster >= ((int64_t)1 << 31) ||
      (staged && bwd_chunk(v, cluster) + kStageSlack > kMaxStageFloats)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* lb = static_cast<const int64_t*>(lab);
  const float* gr = static_cast<const float*>(g);
  cudaError_t err;
  if (bf16) {
    err = staged ? launch_bwd<__nv_bfloat16, true>(x, lb, gr, dx, n, v, eps,
                                                   ignore, cluster, st)
                 : launch_bwd<__nv_bfloat16, false>(x, lb, gr, dx, n, v, eps,
                                                    ignore, cluster, st);
  } else {
    err = staged ? launch_bwd<float, true>(x, lb, gr, dx, n, v, eps, ignore,
                                           cluster, st)
                 : launch_bwd<float, false>(x, lb, gr, dx, n, v, eps, ignore,
                                            cluster, st);
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// x, dx: [n, v] of the same type (fp32, or bf16 when `bf16` is nonzero);
// lab: int64 [n]; g: fp32 [n]. Takes the cluster size and body that
// xent_bwd_plan gives for v.
extern "C" int xent_bwd(const void* x, const void* lab, const void* g,
                        void* dx, int64_t n, int v, float eps, int64_t ignore,
                        int bf16, void* stream) {
  int cluster, staged;
  bwd_plan(v, &cluster, &staged);
  return xent_bwd_with(x, lab, g, dx, n, v, eps, ignore, bf16, cluster,
                       staged, stream);
}

// The cluster size (1, 2, 4 or 8) and body (staged 1, streamed 0) that
// xent_bwd takes for rows of v columns.
extern "C" void xent_bwd_plan(int v, int* cluster, int* staged) {
  bwd_plan(v, cluster, staged);
}
