// Row LayerNorm forward for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/layer_norm.py `_ln_impl` (the Pallas TPU
// kernel behind `layer_norm`, routed from ops/nn_ops.py `layer_norm`).
//
// Computes, per row of x [N, D]: mean and variance in fp32 from the
// centred values (two sums, as `_ln_ref` does, never E[x^2] - E[x]^2),
// y = (x - mean) * rsqrt(var + eps) * scale + bias in fp32, cast to the
// input's type, and writes the row's mean and variance (fp32) beside y,
// which the layer_norm op returns as its Mean and Variance outputs. Any
// D is accepted (there is no D % 128 gate as on the TPU).
//
// What bounds it on an H100: bytes. It reads x once and writes y once,
// about 2 flops a byte, far below the ~20 flops a byte at which fp32
// arithmetic (67 TFLOP/s) would take over from HBM (3.35 TB/s). At the
// bulk shapes ([4096-16384, 512]) the bytes take 2.5-20 us; at a decoder
// step ([8-68, 512]) they take nanoseconds and a launch's latency is the
// time.
//
// What the design does about it. A plan chosen on the host
// (layer_norm.py `ln_plan`, by D, the type and the pointers' alignment)
// picks one of two bodies:
// - D <= 512: a warp a row, the row held in registers (`ln_warp_kernel`).
//   Each lane loads its packs of the row (pack c of the row is lane
//   c % 32's, load c / 32) with the widest loads that D * sizeof(T) and
//   the x, y, scale and bias pointers allow (16 bytes: 4 fp32 or 8 bf16;
//   else 8, 4 or 2), sums them, reduces the sum with a fixed
//   __shfl_xor_sync butterfly, then the centred squares from the same
//   registers the same way (no shared memory, no __syncthreads), and
//   writes y with stores of the same width; lane 0 writes mean and var.
//   A lane owns the same columns in every row, so it loads its columns of
//   scale and bias once and keeps them in registers while its warp walks
//   a grid-stride loop over rows; the grid is at most kMinCtas CTAs of 8
//   warps an SM, which the launch bound keeps resident, so it runs in one
//   wave. A warp issues its next row's loads before it reduces the
//   current one, so two rows a warp are in flight (where a warp has one
//   row, the early load loads nothing). A lane holds at most kLaneMax
//   elements, which covers D 512 at any alignment and keeps a thread
//   under the 128 registers it has at 2 CTAs an SM. Timed on an H100
//   (chip_smoke.py phase 3, PERF.md): 1 or 4 CTAs an SM run slower
//   than 2.
// - D > 512: the block body, one block of 256 threads a row, three
//   block-wide sums with their barriers, the row re-read from L1 by the
//   second and third passes. No path of the repository has such rows; it
//   is also the body this kernel replaced at D 512, which chip_smoke.py
//   times beside the warp plan.
// Both sum in a fixed order with no atomics, so a second launch gives the
// same bits.
//
// Why CUDA C++ and not Triton: the other twelve kernels are CUDA C++
// built by one nvcc call a source (build.py) and bound through ctypes;
// Triton would serve a row reduction as well, but it would be a second
// build route for one kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // both bodies
constexpr int kWarps = kThreads / 32;
constexpr int kLaneMax = 16;   // elements a lane holds, warp body
constexpr int kMinCtas = 2;    // CTAs an SM keeps resident, warp body

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

// Sum of `v` over the block; every thread gets the total. `red` holds
// 33 floats of shared memory.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  const float total = red[32];
  __syncthreads();  // `red` is reused by the next call
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                  const T* __restrict__ bias, T* __restrict__ y,
                  float* __restrict__ mean_out, float* __restrict__ var_out,
                  int d, float eps) {
  __shared__ float red[33];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;

  float acc = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) acc += to_f(xr[i]);
  const float mean = block_sum(acc, red) / d;

  acc = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float c = to_f(xr[i]) - mean;
    acc += c * c;
  }
  const float var = block_sum(acc, red) / d;
  const float rstd = rsqrtf(var + eps);

  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float v = (to_f(xr[i]) - mean) * rstd;
    yr[i] = from_f<T>(v * to_f(scale[i]) + to_f(bias[i]));
  }
  if (threadIdx.x == 0) {
    mean_out[row] = mean;
    var_out[row] = var;
  }
}

// ---------------------------------------------------------------------------
// The warp body.

// One element's bits and their fp32 value.
template <typename T>
struct Bits;
template <>
struct Bits<float> {
  using type = unsigned;
  static __device__ __forceinline__ float f(unsigned b) {
    return __uint_as_float(b);
  }
  static __device__ __forceinline__ unsigned r(float v) {
    return __float_as_uint(v);
  }
};
template <>
struct Bits<__nv_bfloat16> {
  using type = unsigned short;
  static __device__ __forceinline__ float f(unsigned short b) {
    return __uint_as_float((unsigned)b << 16);
  }
  static __device__ __forceinline__ unsigned short r(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

// The register type of one load or store of BYTES bytes.
template <int BYTES>
struct Raw;
template <>
struct Raw<16> {
  using type = uint4;
};
template <>
struct Raw<8> {
  using type = uint2;
};
template <>
struct Raw<4> {
  using type = unsigned;
};
template <>
struct Raw<2> {
  using type = unsigned short;
};

// VEC elements of T as one register pack R.
template <typename T, int VEC>
struct Pack {
  using R = typename Raw<VEC * sizeof(T)>::type;
  union U {
    R r;
    typename Bits<T>::type b[VEC];
  };
  static_assert(sizeof(R) == VEC * sizeof(T), "pack size");

  static __device__ __forceinline__ void unpack(R r, float (&v)[VEC]) {
    U u;
    u.r = r;
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = Bits<T>::f(u.b[e]);
  }
  static __device__ __forceinline__ R pack(const float (&v)[VEC]) {
    U u;
#pragma unroll
    for (int e = 0; e < VEC; ++e) u.b[e] = Bits<T>::r(v[e]);
    return u.r;
  }
};

// Loads row `row` (packs c = j * 32 + lane < nvec) into `r`; nothing
// past the last row.
template <typename R, int NV>
__device__ __forceinline__ void load_row(R (&r)[NV], const R* __restrict__ x,
                                         int64_t row, int64_t n, int nvec,
                                         int lane) {
  if (row >= n) return;
  const R* xr = x + row * nvec;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = j * 32 + lane;
    if (c < nvec) r[j] = xr[c];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A warp a row: VEC elements a pack, NV packs a lane (NV * VEC <=
// kLaneMax), the next row's loads issued before the current row's sums.
// x, y, scale and bias start on a VEC * sizeof(T) boundary and
// d % VEC == 0 (the entry checks both).
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    ln_warp_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                   const T* __restrict__ bias, T* __restrict__ y,
                   float* __restrict__ mean_out, float* __restrict__ var_out,
                   int64_t n, int d, float eps) {
  using P = Pack<T, VEC>;
  using R = typename P::R;
  const int lane = threadIdx.x & 31;
  const int nvec = d / VEC;
  const int64_t stride = (int64_t)gridDim.x * kWarps;
  int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const R* xs = reinterpret_cast<const R*>(x);
  R* ys = reinterpret_cast<R*>(y);
  const R* ss = reinterpret_cast<const R*>(scale);
  const R* bs = reinterpret_cast<const R*>(bias);

  R s[NV], b[NV], cur[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = j * 32 + lane;
    s[j] = R{};
    b[j] = R{};
    cur[j] = R{};
    if (c < nvec) {
      s[j] = ss[c];
      b[j] = bs[c];
    }
  }
  load_row(cur, xs, row, n, nvec, lane);

  for (; row < n; row += stride) {
    R nxt[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) nxt[j] = R{};
    load_row(nxt, xs, row + stride, n, nvec, lane);
    float v[NV][VEC];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      P::unpack(cur[j], v[j]);  // a pack past the row holds zeros
#pragma unroll
      for (int e = 0; e < VEC; ++e) sum += v[j][e];
    }
    const float mean = warp_sum(sum) / d;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (j * 32 + lane < nvec) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float c = v[j][e] - mean;
          sq += c * c;
        }
      }
    }
    const float var = warp_sum(sq) / d;
    const float rstd = rsqrtf(var + eps);
    R* yr = ys + row * nvec;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = j * 32 + lane;
      if (c < nvec) {
        float sv[VEC], bv[VEC], o[VEC];
        P::unpack(s[j], sv);
        P::unpack(b[j], bv);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          o[e] = (v[j][e] - mean) * rstd * sv[e] + bv[e];
        yr[c] = P::pack(o);
      }
    }
    if (lane == 0) {
      mean_out[row] = mean;
      var_out[row] = var;
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) cur[j] = nxt[j];
  }
}

__global__ void ln_empty_kernel() {}

struct Args {
  const void* x;
  const void* scale;
  const void* bias;
  void* y;
  float* mean;
  float* var;
  int64_t n;
  int d;
  float eps;
  int64_t grid;
  cudaStream_t stream;
};

template <typename T, int VEC, int NV>
int launch_warp(const Args& a) {
  ln_warp_kernel<T, VEC, NV><<<(unsigned)a.grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.scale),
      static_cast<const T*>(a.bias), static_cast<T*>(a.y), a.mean, a.var,
      a.n, a.d, a.eps);
  return (int)cudaGetLastError();
}

// The instance with NV == loads (a power of two, NV * VEC <= kLaneMax).
template <typename T, int VEC, int NV = 1>
int warp_loads(const Args& a, int loads) {
  if constexpr (NV * VEC > kLaneMax) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (loads != NV) return warp_loads<T, VEC, NV * 2>(a, loads);
    return launch_warp<T, VEC, NV>(a);
  }
}

template <typename T>
int warp_body(const Args& a, int vec_bytes, int loads) {
  if (vec_bytes == 16) return warp_loads<T, 16 / sizeof(T)>(a, loads);
  if (vec_bytes == 8) return warp_loads<T, 8 / sizeof(T)>(a, loads);
  if (vec_bytes == 4) return warp_loads<T, 4 / sizeof(T)>(a, loads);
  if constexpr (sizeof(T) == 2) {
    if (vec_bytes == 2) return warp_loads<T, 1>(a, loads);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, scale, bias, y: device pointers of the same type (fp32, or bf16
// when `bf16` is nonzero); mean, var: fp32 [n]. The plan
// (layer_norm.py `ln_plan`): `body` 0 is the block a row (grid n), 1 the
// warp a row with loads of `vec_bytes` bytes, `loads` of them a lane (a
// power of two), on `grid` CTAs of 256 threads. Returns cudaErrorInvalidValue, launching
// nothing, for a plan that does not cover the row or that the pointers'
// alignment or D does not allow; else cudaGetLastError() of the launch
// on `stream`.
extern "C" int layer_norm_fwd(const void* x, const void* scale,
                              const void* bias, void* y, void* mean,
                              void* var, int64_t n, int d, float eps,
                              int bf16, int body, int vec_bytes, int loads,
                              int64_t grid, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || d < 1 || grid < 1 || grid >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  if (body == 0) {
    if (grid != n) return (int)cudaErrorInvalidValue;
    if (bf16) {
      ln_fwd_kernel<__nv_bfloat16><<<(unsigned)grid, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const __nv_bfloat16*>(scale),
          static_cast<const __nv_bfloat16*>(bias),
          static_cast<__nv_bfloat16*>(y), static_cast<float*>(mean),
          static_cast<float*>(var), d, eps);
    } else {
      ln_fwd_kernel<float><<<(unsigned)grid, kThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(scale),
          static_cast<const float*>(bias), static_cast<float*>(y),
          static_cast<float*>(mean), static_cast<float*>(var), d, eps);
    }
    return (int)cudaGetLastError();
  }
  const int64_t item = bf16 ? 2 : 4;
  if (body != 1 || vec_bytes < item || vec_bytes > 16 ||
      (vec_bytes & (vec_bytes - 1)) || loads < 1)
    return (int)cudaErrorInvalidValue;
  const uint64_t where = (uint64_t)(uintptr_t)x | (uint64_t)(uintptr_t)y |
                         (uint64_t)(uintptr_t)scale |
                         (uint64_t)(uintptr_t)bias | (uint64_t)(d * item);
  if (where % (uint64_t)vec_bytes) return (int)cudaErrorInvalidValue;
  const int64_t nvec = (int64_t)d * item / vec_bytes;
  if (nvec > (int64_t)loads * 32) return (int)cudaErrorInvalidValue;
  const Args a{x, scale, bias, y, static_cast<float*>(mean),
               static_cast<float*>(var), n, d, eps, grid, s};
  return bf16 ? warp_body<__nv_bfloat16>(a, vec_bytes, loads)
              : warp_body<float>(a, vec_bytes, loads);
}

// An empty kernel launched as `blocks` blocks of 256 threads: a launch's
// own time, beside the kernel's at a decoder step's few rows.
extern "C" int layer_norm_empty(int64_t blocks, void* stream) {
  if (blocks < 1 || blocks >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  ln_empty_kernel<<<(unsigned)blocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
