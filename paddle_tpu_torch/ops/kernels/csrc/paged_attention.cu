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
// 5.3 us at 3.35 TB/s against 0.13 us of fp32 arithmetic. The card has to
// keep about 25 KB in flight on each SM (3.35 TB/s over 132 SMs times a
// microsecond of latency) to reach that rate.
//
// What the design does about it:
// * Pages past the step are never read. The reference masks every position
//   past the step and walks all NP pages; a masked score's weight is exactly
//   0 in fp32 (exp(-1e9 - m) underflows), so skipping those pages gives the
//   same sums and moves fewer bytes. A lane early in its generation reads
//   one page, not NP.
// * One block of 8 warps per (head, lane). Its step and q are read
//   together at the start; each copy reads its page's table entry from
//   global memory (the L1 keeps the lane's row), so the first chunk's
//   copies wait on the step and the entry and on no barrier: a lane
//   early in its generation reads a page or two, and there the launch is
//   a chain of latencies. Entries past the step are never read.
// * The positions stream through shared memory in chunks of CT (64 at Dh
//   64, 32 at 128, 16 at 256: 32 KB of K and V): each position's Dh floats
//   of one head are contiguous, so a chunk moves as 16-byte cp.async copies
//   into a ring of three stages, two chunks in flight while one is used.
//   The ring takes 96 KiB, so two blocks share an SM and all 136 blocks
//   of the serving shape are resident at once.
// * A chunk is scored in parallel: 8 threads a position, each a 16-byte
//   slice of q . k, summed by three shuffles in a fixed order. The softmax
//   is rescaled once a chunk (by the chunk's max over warp maxima), not
//   once a position. P v runs with threads along Dh (a float4 each) and
//   positions split across thread groups, each thread weighing its own
//   positions (so a chunk takes two barriers); the groups' sums and
//   weight sums merge in their order at the end.
// * The positions' addresses come without a division a copy: each thread
//   copies the same rows of every chunk and steps their page and offset
//   on by a chunk.
// * No split of a lane's positions across blocks: the paged server runs
//   R * H = 128 blocks (16 lanes, 8 heads), about one an SM. A served
//   configuration with few lanes and long buffers would need one (the
//   partial (acc, m, l) of each split merged in a fixed order).
// * Table entries are trusted as the host writes them: the scheduler's
//   HostBlockPool only hands out blocks < NB.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "split_tf32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;
constexpr int kTpp = 8;  // threads scoring one position

// DMAX: the largest head dim of an instance (64, 128 or 256)
template <int DMAX>
struct Cfg {
  static constexpr int CT = 4096 / DMAX;         // positions a chunk
  static constexpr int QV = DMAX / (4 * kTpp);   // float4s of q a thread
};

__device__ __forceinline__ float dot4(float4 a, const float* b) {
  const float4 v = *reinterpret_cast<const float4*>(b);
  return a.x * v.x + a.y * v.y + a.z * v.z + a.w * v.w;
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads, 2)
    paged_decode_kernel(const float* __restrict__ q,
                        const float* __restrict__ pool_k,
                        const float* __restrict__ pool_v,
                        const int32_t* __restrict__ tab,
                        const int64_t* __restrict__ step,
                        float* __restrict__ out, int H, int D, int BS,
                        int NP, float scale) {
  constexpr int CT = Cfg<DMAX>::CT, QV = Cfg<DMAX>::QV;
  extern __shared__ __align__(16) float ring[];  // kStages x (K, V [CT][D])
  __shared__ float sc[CT];       // the chunk's scores
  __shared__ float red[kWarps];  // their warp maxima

  const int h = blockIdx.x, r = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int D4 = D / 4;
  const int T = NP * BS;

  // the step and q, read together
  const int64_t st = step[r];
  const int32_t* trow = tab + (int64_t)r * NP;
  const int part_id = tid % kTpp;
  const float* qr = q + ((int64_t)r * H + h) * D;
  float4 qv[QV];
#pragma unroll
  for (int j = 0; j < QV; ++j) {
    const int c = part_id + kTpp * j;
    qv[j] = c < D4 ? make_float4(qr[4 * c], qr[4 * c + 1], qr[4 * c + 2],
                                 qr[4 * c + 3])
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // positions 0..n-1 are visible; a negative step averages all T cells
  const int n = (st < 0 || st + 1 >= T) ? T : (int)(st + 1);
  const bool uniform = st < 0;
  const int nch = (n + CT - 1) / CT;

  // chunk i (positions i CT ...) into ring stage i % kStages, the
  // chunks in order: this thread copies 16-byte column cc of rows row0,
  // row0 + kRowStep, ... of K and of V, where visible, and keeps each
  // row's page and offset for the next chunk (no division a copy)
  constexpr int C4 = DMAX / 4, kRowStep = kThreads / C4;
  constexpr int kRows = CT / kRowStep;
  const int cc = tid % C4, row0 = tid / C4;
  int pg[kRows], off[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    pg[k] = (row0 + k * kRowStep) / BS;
    off[k] = (row0 + k * kRowStep) % BS;
  }
  const int dpg = CT / BS, doff = CT % BS;
  auto fetch = [&](int i) {
    const int c0 = i * CT;
    float* ks = ring + (i % kStages) * 2 * CT * D;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int row = row0 + k * kRowStep;
      if (cc < D4 && c0 + row < n) {
        const int64_t at =
            ((int64_t)(__ldg(trow + pg[k]) * BS + off[k]) * H + h) * D +
            4 * cc;
        split_tf32::cp16(ks + row * D + 4 * cc, pool_k + at, true);
        split_tf32::cp16(ks + (CT + row) * D + 4 * cc, pool_v + at, true);
      }
      pg[k] += dpg;
      off[k] += doff;
      if (off[k] >= BS) {
        off[k] -= BS;
        ++pg[k];
      }
    }
  };

  // P v: column c4 (a float4 of Dh), positions g, g + G, ... of a chunk;
  // l_run the sum of their weights
  const int G = kThreads / D4;
  const int c4 = tid % D4, g = tid / D4;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float m_run = -INFINITY, l_run = 0.f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nch) fetch(i);
    split_tf32::cp_commit();
  }
  for (int it = 0; it < nch; ++it) {
    split_tf32::cp_wait<kStages - 2>();  // this thread's copies of chunk it
    __syncthreads();  // everyone's; and chunk it - 1 is done with
    if (it + kStages - 1 < nch) fetch(it + kStages - 1);
    split_tf32::cp_commit();
    const float* ks = ring + (it % kStages) * 2 * CT * D;
    const float* vs = ks + CT * D;
    const int nv = min(CT, n - it * CT);

    // scores: position pos by the 8 threads tid / 8 == pos % 32
    float smax = -INFINITY;
#pragma unroll
    for (int pass = 0; pass < (CT + 31) / 32; ++pass) {
      if (pass * 32 >= nv) break;  // the same for the whole block
      const int pos = pass * 32 + tid / kTpp;
      float dot = 0.f;
      if (pos < nv) {
#pragma unroll
        for (int j = 0; j < QV; ++j) {
          const int c = part_id + kTpp * j;
          if (c < D4) dot += dot4(qv[j], ks + pos * D + 4 * c);
        }
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 4);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      const float sv = pos < nv ? (uniform ? 0.f : dot * scale) : -INFINITY;
      if (pos < CT && part_id == 0) sc[pos] = sv;
      smax = fmaxf(smax, sv);
    }
    smax = fmaxf(smax, __shfl_xor_sync(0xffffffffu, smax, 8));
    smax = fmaxf(smax, __shfl_xor_sync(0xffffffffu, smax, 16));
    if (lane == 0) red[warp] = smax;
    __syncthreads();

    // one rescale a chunk: every chunk holds a visible position, so its
    // max is finite, and exp(m_run - m_new) is 0 on the first. Each P v
    // thread weighs its own positions and keeps its group's sum of them
    float mc = red[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mc = fmaxf(mc, red[w]);
    const float m_new = fmaxf(m_run, mc);
    const float corr = expf(m_run - m_new);
    m_run = m_new;
    if (g < G) {
      l_run *= corr;
      acc.x *= corr;
      acc.y *= corr;
      acc.z *= corr;
      acc.w *= corr;
      for (int t = g; t < nv; t += G) {
        const float pt = expf(sc[t] - m_new);
        const float4 v = *reinterpret_cast<const float4*>(vs + t * D + 4 * c4);
        l_run += pt;
        acc.x = fmaf(pt, v.x, acc.x);
        acc.y = fmaf(pt, v.y, acc.y);
        acc.z = fmaf(pt, v.z, acc.z);
        acc.w = fmaf(pt, v.w, acc.w);
      }
    }
  }
  split_tf32::cp_wait<0>();
  __syncthreads();  // the ring is free: the groups' sums go there

  float* lsum = ring + G * D;
  if (g < G) {
    *reinterpret_cast<float4*>(ring + g * D + 4 * c4) = acc;
    if (c4 == 0) lsum[g] = l_run;
  }
  __syncthreads();
  float L = 0.f;
  for (int k = 0; k < G; ++k) L += lsum[k];
  const int64_t rh = (int64_t)r * H + h;
  for (int d = tid; d < D; d += kThreads) {
    float o = 0.f;
    for (int k = 0; k < G; ++k) o += ring[k * D + d];
    out[rh * D + d] = o / L;
  }
}

template <int DMAX>
cudaError_t launch(const float* q, const float* pool_k, const float* pool_v,
                   const int32_t* tab, const int64_t* step, float* out,
                   int R, int H, int D, int BS, int NP, float scale,
                   cudaStream_t stream) {
  constexpr int CT = Cfg<DMAX>::CT;
  const size_t smem = sizeof(float) * kStages * 2 * CT * D;
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  paged_decode_kernel<DMAX><<<dim3(H, R), kThreads, smem, stream>>>(
      q, pool_k, pool_v, tab, step, out, H, D, BS, NP, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [R,H,D], pool_k/pool_v [NB,BS,H,D] fp32, the pools 16-byte aligned;
// tab [R,NP] int32; step [R] int64 (the decode bundle's per-lane step
// counters as they are); out [R,H,D]. D a multiple of 8, at most 256; BS
// a multiple of 8. Returns the cudaError_t of the launch (0 on success).
int paged_decode_attention_fwd(const float* q, const float* pool_k,
                               const float* pool_v, const int32_t* tab,
                               const int64_t* step, float* out, int R, int H,
                               int D, int BS, int NP, float scale,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || H <= 0) return 0;
  if (D <= 0 || D % 8 != 0 || BS <= 0 || BS % 8 != 0 || NP <= 0 ||
      reinterpret_cast<uintptr_t>(pool_k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(pool_v) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (D <= 64)
    return launch<64>(q, pool_k, pool_v, tab, step, out, R, H, D, BS, NP,
                      scale, s);
  if (D <= 128)
    return launch<128>(q, pool_k, pool_v, tab, step, out, R, H, D, BS, NP,
                       scale, s);
  if (D <= 256)
    return launch<256>(q, pool_k, pool_v, tab, step, out, R, H, D, BS, NP,
                       scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
