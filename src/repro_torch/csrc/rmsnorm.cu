// rmsnorm: y = x * rsqrt(mean(x^2) + eps) * w per row, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm
// (pallas_call at :44), which runs every norm of a model with
// d_model >= 128: ln1 and ln2 of each layer plus the final norm.
//
// Bound on Hopper: bytes read and written (x once, y once, w once per call);
// a handful of flops per element is far below the H100's ridge.
//
// Design: one block per row.  A phi3 row (d = 3072) is 6 KB of bf16, small
// enough that the second read of the row in the write pass is served by L1/L2
// and device memory sees each byte of x once.  Pass 1 loads the row in 16-byte
// vectors (8 bf16 or 4 f32) when the row pointers allow it, squares and sums
// in f32, and reduces across the block (warp shuffles, then shared memory).
// Pass 2 reloads the row and writes (x * r) * w in x's dtype, the same order
// of operations as the reference (xf * rsqrt(ms + eps) * w).  x may be
// float32 or bfloat16 and w float32 or bfloat16, in any combination.
// The C entry point returns cudaGetLastError(); the Python wrapper raises when
// it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum of v over the block, returned to every thread.
__device__ __forceinline__ float block_sum_all(float v) {
  __shared__ float warp_part[kThreads / 32];
  __shared__ float total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kThreads / 32 ? warp_part[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) total = t;
  }
  __syncthreads();
  return total;
}

// Loads VEC consecutive elements of type T starting at p (16 bytes when VEC > 1).
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  if (VEC == 1) {
    out[0] = to_f32(p[0]);
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < VEC; ++k) out[k] = to_f32(e[k]);
  }
}

// VEC: x elements handled per step (16 bytes of x), or 1 on the scalar path.
template <typename TX, typename TW, int VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_rows(const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ y,
             int d, float eps) {
  const long long row = blockIdx.x;
  const TX* xr = x + row * d;
  TX* yr = y + row * d;
  const int steps = d / VEC;

  float ss = 0.f;
  for (int i = threadIdx.x; i < steps; i += kThreads) {
    float v[VEC];
    load_vec<TX, VEC>(xr + i * VEC, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) ss = fmaf(v[k], v[k], ss);
  }
  const float r = rsqrtf(block_sum_all(ss) / (float)d + eps);

  for (int i = threadIdx.x; i < steps; i += kThreads) {
    float v[VEC];
    load_vec<TX, VEC>(xr + i * VEC, v);
    alignas(16) TX o[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      o[k] = from_f32<TX>((v[k] * r) * to_f32(w[i * VEC + k]));
    if (VEC == 1) {
      yr[i] = o[0];
    } else {
      *reinterpret_cast<uint4*>(yr + i * VEC) = *reinterpret_cast<const uint4*>(o);
    }
  }
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, void* y, long long rows, int d, float eps,
           cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(TX);
  const bool vec_ok = (d % kVec == 0) &&
                      (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                      (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  const TX* px = static_cast<const TX*>(x);
  const TW* pw = static_cast<const TW*>(w);
  TX* py = static_cast<TX*>(y);
  if (vec_ok)
    rmsnorm_rows<TX, TW, kVec><<<(unsigned)rows, kThreads, 0, stream>>>(px, pw, py, d, eps);
  else
    rmsnorm_rows<TX, TW, 1><<<(unsigned)rows, kThreads, 0, stream>>>(px, pw, py, d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x_dtype / w_dtype: 0 = float32, 1 = bfloat16.  y has x's dtype and shape
// (rows, d), row-major and contiguous like x.  Launches on `stream`.
extern "C" int repro_rmsnorm(const void* x, const void* w, void* y, long long rows, int d,
                             float eps, int x_dtype, int w_dtype, void* stream) {
  if (rows < 0 || rows > 0x7fffffffLL || d < 1) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0) return launch<float, float>(x, w, y, rows, d, eps, s);
  if (x_dtype == 0 && w_dtype == 1) return launch<float, __nv_bfloat16>(x, w, y, rows, d, eps, s);
  if (x_dtype == 1 && w_dtype == 0) return launch<__nv_bfloat16, float>(x, w, y, rows, d, eps, s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
}
