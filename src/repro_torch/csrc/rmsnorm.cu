// rmsnorm: y = x * rsqrt(mean(x^2) + eps) * w per row, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm
// (pallas_call at :44), which runs every norm of a model with
// d_model >= 128: ln1 and ln2 of each layer plus the final norm.
//
// Bound on Hopper: bytes read and written (x once, y once, w once per call);
// a handful of flops per element is far below the H100's ridge.
//
// Two kernels; the wrapper (kernels/rmsnorm.py::variant) picks one per call
// and names it to the C entry point, which refuses a kernel that cannot take
// the inputs.  Both compute (x * r) * w with r = rsqrt(sum(x^2) / d + eps),
// products and sums as __fmul_rn/__fadd_rn (never contracted to FMAs), the
// division and rsqrt correctly rounded: the order of operations of the plain
// version (xf * rsqrt(ms + eps) * w).  x may be float32 or bfloat16 and w
// float32 or bfloat16, in any combination.
//  * rmsnorm_warp ("warp"): d a multiple of the 16-byte vector (8 bf16 or 4
//    f32), d <= kMaxWarpD, x and y 16-byte aligned.  ONE WARP PER ROW, the row
//    in registers: lane l loads the vectors l, l + 32, ... of its row (12 a
//    lane at d = 3072 bf16), so x is read once, with 16-byte loads.  Each lane
//    adds its squares in vector order, the warp adds the lanes' sums in an
//    xor-shuffle tree (no __syncthreads, no shared memory round trip), and
//    the lane writes its outputs from its registers.  w is staged once per
//    block in shared memory as f32, with 16-byte loads where w allows them,
//    while the block's rows are in flight.  A block of 4 warps takes 4 rows,
//    so one block serves the decode shapes (2 or 4 rows) and 1024 blocks a
//    (4096, 3072) x; the hardware hands blocks to SMs as they free up.
//  * rmsnorm_block ("block"): any d and alignment.  One 128-thread block per
//    row; the row's second read (the output pass) is served by L1/L2.
// The C entry point takes the device ordinal (it switches the calling
// thread's device only when it differs, and switches back) and returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWarpD = 4096;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Sum over the warp in an xor tree: every lane gets the same bits (each step
// adds the same two values, in either order).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float inv_rms(float ss, int d, float eps) {
  return __frsqrt_rn(__fadd_rn(__fdiv_rn(ss, (float)d), eps));
}

// ---------------------------------------------------------------------------
// "warp": one warp per row, the row in registers.
// ---------------------------------------------------------------------------
// Lane `lane`'s vectors lane, lane + 32, ... of a row of nvec 16-byte vectors.
template <typename TX, int NV>
__device__ __forceinline__ void load_row(const TX* xr, int lane, int nvec, uint4 (&raw)[NV]) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = lane + 32 * i;
    raw[i] = v < nvec ? reinterpret_cast<const uint4*>(xr)[v] : make_uint4(0, 0, 0, 0);
  }
}

// NV: 16-byte vectors a lane holds (ceil(d / VEC / 32), rounded up to an instance).
template <typename TX, typename TW, int NV>
__global__ void __launch_bounds__(kThreads)
rmsnorm_warp(const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ y,
             long long rows, int d, float eps) {
  constexpr int VEC = 16 / sizeof(TX);
  extern __shared__ float4 w_smem4[];
  float* w_smem = reinterpret_cast<float*>(w_smem4);
  const int lane = threadIdx.x & 31;
  const int nvec = d / VEC;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);

  uint4 raw[NV];
  if (row < rows) load_row<TX, NV>(x + row * d, lane, nvec, raw);   // in flight while w is staged

  constexpr int WVEC = 16 / sizeof(TW);
  if (reinterpret_cast<uintptr_t>(w) % 16 == 0 && d % WVEC == 0) {
    for (int v = threadIdx.x; v < d / WVEC; v += kThreads) {
      const uint4 r = reinterpret_cast<const uint4*>(w)[v];
      const TW* e = reinterpret_cast<const TW*>(&r);
#pragma unroll
      for (int k = 0; k < WVEC; ++k) w_smem[v * WVEC + k] = to_f32(e[k]);
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) w_smem[i] = to_f32(w[i]);
  }
  __syncthreads();
  if (row >= rows) return;

  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (lane + 32 * i < nvec) {
      const TX* e = reinterpret_cast<const TX*>(&raw[i]);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float f = to_f32(e[k]);
        ss = __fadd_rn(ss, __fmul_rn(f, f));
      }
    }
  }
  const float r = inv_rms(warp_sum(ss), d, eps);
  uint4* yr = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = lane + 32 * i;
    if (v < nvec) {
      const TX* e = reinterpret_cast<const TX*>(&raw[i]);
      const float* wv = w_smem + v * VEC;
      uint4 o;
      TX* oe = reinterpret_cast<TX*>(&o);
#pragma unroll
      for (int k = 0; k < VEC; ++k) oe[k] = from_f32<TX>(__fmul_rn(__fmul_rn(to_f32(e[k]), r), wv[k]));
      yr[v] = o;
    }
  }
}

// ---------------------------------------------------------------------------
// "block": one block per row, any d and alignment.
// ---------------------------------------------------------------------------
// Sum of v over the block, returned to every thread.
__device__ __forceinline__ float block_sum_all(float v) {
  __shared__ float warp_part[kWarps];
  __shared__ float total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kWarps ? warp_part[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) total = t;
  }
  __syncthreads();
  return total;
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
rmsnorm_block(const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ y, int d,
              float eps) {
  const long long row = blockIdx.x;
  const TX* xr = x + row * d;
  TX* yr = y + row * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float f = to_f32(xr[i]);
    ss = __fadd_rn(ss, __fmul_rn(f, f));
  }
  const float r = inv_rms(block_sum_all(ss), d, eps);
  for (int i = threadIdx.x; i < d; i += kThreads)
    yr[i] = from_f32<TX>(__fmul_rn(__fmul_rn(to_f32(xr[i]), r), to_f32(w[i])));
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------
template <typename TX, typename TW, int NV>
int launch_warp(const TX* x, const TW* w, TX* y, long long rows, int d, float eps,
                cudaStream_t stream) {
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  rmsnorm_warp<TX, TW, NV><<<blocks, kThreads, d * sizeof(float), stream>>>(x, w, y, rows, d, eps);
  return (int)cudaGetLastError();
}

template <typename TX, typename TW>
int launch(const void* xv, const void* wv, void* yv, long long rows, int d, float eps,
           int variant, cudaStream_t stream) {
  const TX* x = static_cast<const TX*>(xv);
  const TW* w = static_cast<const TW*>(wv);
  TX* y = static_cast<TX*>(yv);
  if (variant == 0) {
    constexpr int VEC = 16 / sizeof(TX);
    if (d % VEC || d > kMaxWarpD ||
        (reinterpret_cast<uintptr_t>(xv) | reinterpret_cast<uintptr_t>(yv)) % 16)
      return (int)cudaErrorInvalidValue;
    const int per_lane = (d / VEC + 31) / 32;
    if (per_lane <= 1) return launch_warp<TX, TW, 1>(x, w, y, rows, d, eps, stream);
    if (per_lane <= 2) return launch_warp<TX, TW, 2>(x, w, y, rows, d, eps, stream);
    if (per_lane <= 3) return launch_warp<TX, TW, 3>(x, w, y, rows, d, eps, stream);
    if (per_lane <= 4) return launch_warp<TX, TW, 4>(x, w, y, rows, d, eps, stream);
    if (per_lane <= 6) return launch_warp<TX, TW, 6>(x, w, y, rows, d, eps, stream);
    if (per_lane <= 8) return launch_warp<TX, TW, 8>(x, w, y, rows, d, eps, stream);
    if (per_lane <= 12) return launch_warp<TX, TW, 12>(x, w, y, rows, d, eps, stream);
    if (per_lane <= 16) return launch_warp<TX, TW, 16>(x, w, y, rows, d, eps, stream);
    if constexpr (VEC == 4) {              // f32 rows up to kMaxWarpD take 32 vectors a lane
      if (per_lane <= 24) return launch_warp<TX, TW, 24>(x, w, y, rows, d, eps, stream);
      return launch_warp<TX, TW, 32>(x, w, y, rows, d, eps, stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  rmsnorm_block<TX, TW><<<(unsigned)rows, kThreads, 0, stream>>>(x, w, y, d, eps);
  return (int)cudaGetLastError();
}

struct DeviceScope {   // makes `device` current while it lives, if it is not
  int previous = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceScope(int device) {
    int current = 0;
    err = cudaGetDevice(&current);
    if (err == cudaSuccess && current != device) {
      err = cudaSetDevice(device);
      if (err == cudaSuccess) previous = current;
    }
  }
  ~DeviceScope() {
    if (previous >= 0) cudaSetDevice(previous);
  }
};

}  // namespace

// x_dtype / w_dtype: 0 = float32, 1 = bfloat16.  y has x's dtype and shape
// (rows, d), row-major and contiguous like x.  variant 0 runs rmsnorm_warp
// (d a multiple of 16 bytes of x, at most 4096, x and y 16-byte aligned),
// variant 1 rmsnorm_block.  Launches on `stream`.
extern "C" int repro_rmsnorm(const void* x, const void* w, void* y, long long rows, int d,
                             float eps, int x_dtype, int w_dtype, int variant, int device,
                             void* stream) {
  if (rows < 0 || rows > 0x7fffffffLL || d < 1 || (x_dtype != 0 && x_dtype != 1) ||
      (w_dtype != 0 && w_dtype != 1) || (variant != 0 && variant != 1) || device < 0 ||
      device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float>(x, w, y, rows, d, eps, variant, s);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, __nv_bfloat16>(x, w, y, rows, d, eps, variant, s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(x, w, y, rows, d, eps, variant, s);
  return launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, rows, d, eps, variant, s);
}
