// Paged single-query decode attention for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py `paged_decode_attention`
// (`_paged_kernel`, the Pallas TPU kernel at its `pl.pallas_call`). The JAX
// package computes the same function in its paged decode step as a gather of
// the dense [R, H, maxT, Dh] cache view followed by a masked softmax
// (models/decode_engine.py `_PagedLaneCache`); the port's paged step routes
// each layer's self-attention here instead.
//
// Computes, per lane r and head h, with q [R, H, Dh] and the shared pools
// pool_k / pool_v [NB, BS, H, Dh] addressed through the lane's block table
// tab [R, NP] (int32) and its step (int64):
//   out[r, h] = sum_t p_t v_t,  p = softmax_t(scale * q[r, h] . k_t)
// over the cache positions t <= step[r], where position t lives at
// pool[tab[r, t / BS], t % BS, h]. A lane whose step is negative sees no
// position; it gets the average of v over all NP * BS cells, as the
// reference's all-masked softmax does.
//
// What bounds it on an H100: bytes. At the paged serving shape (R 17, H 8,
// Dh 64, BS 16, NP 16, NB 256, every lane at step 255) it reads
// 17 * 256 * 512 floats of K and as many of V, 17.8 MB, and does 8.9 MFLOP:
// 5.3 us at 3.35 TB/s against 0.13 us of fp32 arithmetic.
//
// What the design does about it:
// * Pages past the step are never read. The reference masks every position
//   past the step and walks all NP pages; a masked score's weight is exactly
//   0 in fp32 (exp(-1e9 - m) underflows), so skipping those pages gives the
//   same sums and moves fewer bytes. A lane early in its generation reads
//   one page, not NP.
// * One block per (head, lane), 8 warps. Warp w takes positions w, w + 8,
//   ...; a position's Dh floats are contiguous (Dh * 4 bytes), so a warp's
//   load of one position is coalesced, Dh / 32 floats a lane. Each warp
//   issues the loads of 4 positions before it uses any, to keep loads in
//   flight.
// * Scores by a warp shuffle reduction, then an online softmax per warp
//   (running max m, sum l and the weighted sum of v in registers, fp32). The
//   warps' states merge in shared memory at the end.
// * Table entries are trusted as the host writes them: the scheduler's
//   HostBlockPool only hands out blocks < NB, and the entries of pages past
//   the step, which may be stale, are never read.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// KPL: floats per lane, ceil(Dh / 32), at most 8 (Dh <= 256).
template <int KPL>
__global__ void __launch_bounds__(kWarps * 32)
    paged_decode_kernel(const float* __restrict__ q,
                        const float* __restrict__ pool_k,
                        const float* __restrict__ pool_v,
                        const int32_t* __restrict__ tab,
                        const int64_t* __restrict__ step,
                        float* __restrict__ out, int H, int D, int BS, int NP,
                        float scale) {
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  extern __shared__ float sm_acc[];  // [kWarps, D]

  const int h = blockIdx.x;
  const int r = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int T = NP * BS;
  const int64_t st = step[r];
  // positions 0..n-1 are visible; a negative step averages all T cells
  const int n = (st < 0 || st + 1 >= T) ? T : (int)(st + 1);
  const bool uniform = st < 0;
  const int32_t* row = tab + (size_t)r * NP;

  float qr[KPL];
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int d = lane + 32 * j;
    qr[j] = d < D ? q[((size_t)r * H + h) * D + d] : 0.f;
  }

  float m = -INFINITY, l = 0.f;
  float acc[KPL];
#pragma unroll
  for (int j = 0; j < KPL; ++j) acc[j] = 0.f;

  for (int t0 = warp; t0 < n; t0 += kWarps * kUnroll) {
    float kr[kUnroll][KPL], vr[kUnroll][KPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * kWarps;
      if (t < n) {
        const size_t cell = (size_t)row[t / BS] * BS + t % BS;
        const size_t base = (cell * H + h) * D;
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          const int d = lane + 32 * j;
          kr[u][j] = d < D ? pool_k[base + d] : 0.f;
          vr[u][j] = d < D ? pool_v[base + d] : 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * kWarps;
      if (t >= n) break;
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < KPL; ++j) dot = fmaf(qr[j], kr[u][j], dot);
      const float s = uniform ? 0.f : warp_sum(dot) * scale;
      const float m_new = fmaxf(m, s);
      const float corr = expf(m - m_new);  // 0 while m is -inf
      const float p = expf(s - m_new);
      l = l * corr + p;
#pragma unroll
      for (int j = 0; j < KPL; ++j) acc[j] = fmaf(p, vr[u][j], acc[j] * corr);
      m = m_new;
    }
  }

  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int d = lane + 32 * j;
    if (d < D) sm_acc[warp * D + d] = acc[j];
  }
  __syncthreads();

  // merge the warps' states: every warp with a position has a finite m
  float M = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w]);
  float L = 0.f;
  float wts[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    wts[w] = sm_l[w] > 0.f ? expf(sm_m[w] - M) : 0.f;
    L = fmaf(sm_l[w], wts[w], L);
  }
  const float inv = 1.f / L;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o = fmaf(sm_acc[w * D + d], wts[w], o);
    out[((size_t)r * H + h) * D + d] = o * inv;
  }
}

template <int KPL>
cudaError_t launch(const float* q, const float* pool_k, const float* pool_v,
                   const int32_t* tab, const int64_t* step, float* out, int R,
                   int H, int D, int BS, int NP, float scale,
                   cudaStream_t stream) {
  const dim3 grid(H, R);
  const size_t smem = sizeof(float) * kWarps * D;
  paged_decode_kernel<KPL><<<grid, kWarps * 32, smem, stream>>>(
      q, pool_k, pool_v, tab, step, out, H, D, BS, NP, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [R,H,D], pool_k/pool_v [NB,BS,H,D] fp32; tab [R,NP] int32; step [R]
// int64 (the decode bundle's per-lane step counters as they are); out
// [R,H,D]. D a multiple of 8, at most 256. Returns the cudaError_t of
// the launch (0 on success).
int paged_decode_attention_fwd(const float* q, const float* pool_k,
                               const float* pool_v, const int32_t* tab,
                               const int64_t* step, float* out, int R, int H,
                               int D, int BS, int NP, float scale,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || H <= 0) return 0;
  if (D <= 64)
    return launch<2>(q, pool_k, pool_v, tab, step, out, R, H, D, BS, NP,
                     scale, s);
  if (D <= 128)
    return launch<4>(q, pool_k, pool_v, tab, step, out, R, H, D, BS, NP,
                     scale, s);
  if (D <= 256)
    return launch<8>(q, pool_k, pool_v, tab, step, out, R, H, D, BS, NP,
                     scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
