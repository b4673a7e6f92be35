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
// What the design does about it. Forward: one block per row. Each thread
// keeps a running (max, sum of exp) pair and the running row sum over a
// strided slice of the row, so the forward reads the row from device
// memory once and keeps no [N, V] intermediate; the pairs merge with warp
// shuffles, then through shared memory.
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

constexpr int kThreads = 256;

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

// The (max, sum of exp) pair and the plain sum of one row, over the
// whole block; every thread gets the results. `red` holds 3 * 33 floats.
template <typename T>
__device__ void row_stats(const T* __restrict__ xr, int v, float* red,
                          float& m_out, float& s_out, float& sum_out) {
  float m = -INFINITY, s = 0.f, tot = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < v; i += blockDim.x) {
    const float xi = to_f(xr[i]);
    push(m, s, xi);
    tot += xi;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    merge(m, s, m2, s2);
    tot += __shfl_xor_sync(0xffffffffu, tot, o);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (lane == 0) {
    red[warp] = m;
    red[33 + warp] = s;
    red[66 + warp] = tot;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < nwarps ? red[lane] : -INFINITY;
    s = lane < nwarps ? red[33 + lane] : 0.f;
    tot = lane < nwarps ? red[66 + lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
      const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
      merge(m, s, m2, s2);
      tot += __shfl_xor_sync(0xffffffffu, tot, o);
    }
    if (lane == 0) {
      red[32] = m;
      red[65] = s;
      red[98] = tot;
    }
  }
  __syncthreads();
  m_out = red[32];
  s_out = red[65];
  sum_out = red[98];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    xent_fwd_kernel(const T* __restrict__ x, const int64_t* __restrict__ lab,
                    float* __restrict__ loss, float* __restrict__ lse_out,
                    int v, float eps, int64_t ignore) {
  __shared__ float red[99];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * v;
  float m, s, tot;
  row_stats(xr, v, red, m, s, tot);
  if (threadIdx.x == 0) {
    const float lse = m + logf(s);
    const int64_t l = lab[row];
    const float picked = (l >= 0 && l < v) ? to_f(xr[l]) : 0.f;
    float out = lse - picked;
    if (eps != 0.f) out = (1.f - eps) * out + eps * (lse - tot / v);
    loss[row] = l == ignore ? 0.f : out;
    lse_out[row] = lse;
  }
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

}  // namespace

// x: [n, v] device pointer, fp32 (bf16 when `bf16` is nonzero); lab:
// int64 [n]; loss, lse: fp32 [n]. Launches on `stream` and returns
// cudaGetLastError() of the launch.
extern "C" int xent_fwd(const void* x, const void* lab, void* loss, void* lse,
                        int64_t n, int v, float eps, int64_t ignore, int bf16,
                        void* stream) {
  const dim3 grid((unsigned)n);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* lb = static_cast<const int64_t*>(lab);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  if (bf16) {
    xent_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), lb, lo, ls, v, eps, ignore);
  } else {
    xent_fwd_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), lb, lo, ls, v, eps, ignore);
  }
  return (int)cudaGetLastError();
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
