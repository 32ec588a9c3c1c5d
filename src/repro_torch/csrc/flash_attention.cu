// flash_attention: blocked online-softmax attention for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (_kernel at :33, pallas_call at :115), which runs every
// attention without a KV cache: the training loss and the cache-free forward.
// It computes, per (batch, query head), o = softmax(mask(cap(q*scale . k^T))) v
// with causal masking, GQA (kv head = q head / group, read in place, never
// repeated), a sliding window, tanh soft-capping and a guard that makes a
// fully masked row 0 instead of NaN.
//
// Bound on Hopper: operations.  At phi3's training shape (1, 32, 4096, 96)
// the causal half of QK^T and PV is ~103 GFLOP against ~100 MB of q/k/v/o,
// about 1000 flops per byte, far above the card's ridge.  The bound is set by
// the bf16 tensor cores (989 TFLOP/s); this first kernel runs the products on
// the CUDA cores in f32 (67 TFLOP/s peak), so it is expected to sit well above
// that bound.  wgmma, TMA and a pipelined K/V ring are later work.
//
// Design: one block of 128 threads per (64-row query tile, batch * q head).
// The block stages its query tile in shared memory as f32, scaled by `scale`
// before the product (as the TPU kernel does at :45), then loops over 64-key
// tiles; that loop takes the place of the TPU's sequential `ik` grid axis.
// Each key tile's K and V are staged in shared memory as f32.  Thread (ty, tx)
// owns query rows 4*ty..4*ty+3 and key columns tx + 8*j of the score tile, and
// output columns tx + 8*c of the same rows; the 8 threads of a row group are
// consecutive lanes of one warp, so row maxima and sums are warp shuffles and
// the probability tile needs only a warp barrier.  The running max m, sum l
// and output accumulator stay in registers in f32.  Key tiles entirely
// outside the causal or sliding window are skipped: in the TPU kernel such a
// tile leaves m, l and acc unchanged (p = 0, alpha = 1), so skipping is exact.
// The per-tile update is the TPU kernel's own (:59-71), and the output is
// acc / (l == 0 ? 1 : l).  Sequence lengths need not be multiples of 64: rows
// and keys past the end are masked in the kernel.  The grid depends on the
// shapes only and nothing is reduced across blocks, so repeated launches give
// the same bits.  q, k, v and o share one dtype, float32 or bfloat16; the head
// dim is at most 128.  The C entry point returns cudaGetLastError(); the
// Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 128;    // 16 row groups of 4 rows x 8 column lanes
constexpr int kLdP = kBK + 1;    // padded row stride of the probability tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// max / sum over the 8 consecutive lanes that share a row group
__device__ __forceinline__ float group_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
}
__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 1);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int hq, hkv, sq, sk, d;
  float scale;
  int causal;
  int has_window, window;
  int has_softcap;
  float softcap;
};

// Shared memory, in floats: Q and K tiles with a padded row stride d + 1
// (conflict-free column reads), V with stride d, P with stride kBK + 1.
__host__ __device__ inline size_t smem_floats(int d) {
  return (size_t)(kBQ + kBK) * (d + 1) + (size_t)kBK * d + (size_t)kBQ * kLdP;
}

// NC: output columns per thread, ceil(d / 8) <= NC.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) flash_fwd(Args a) {
  extern __shared__ float smem[];
  const int d = a.d;
  const int ld = d + 1;
  float* sQ = smem;
  float* sK = sQ + kBQ * ld;
  float* sV = sK + kBK * ld;
  float* sP = sV + kBK * d;

  const int bh = blockIdx.x;                       // b * hq + query head
  const int b = bh / a.hq, qh = bh % a.hq;
  const long long kvh = (long long)b * a.hkv + qh / (a.hq / a.hkv);   // kv_map
  // the longest (latest) query tiles first: causal blocks differ in work
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const T* q = static_cast<const T*>(a.q) + (long long)bh * a.sq * d;
  const T* k = static_cast<const T*>(a.k) + kvh * a.sk * d;
  const T* v = static_cast<const T*>(a.v) + kvh * a.sk * d;
  T* o = static_cast<T*>(a.o) + (long long)bh * a.sq * d;

  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;

  for (int i = tid; i < kBQ * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    sQ[r * ld + c] = q0 + r < a.sq ? to_f32(q[(long long)(q0 + r) * d + c]) * a.scale : 0.f;
  }

  // keys any row of this tile may see: [k_lo, k_hi)
  const int q_last = min(q0 + kBQ, a.sq) - 1;
  int k_lo = 0, k_hi = a.sk;
  if (a.causal) k_hi = min(k_hi, q_last + 1);
  if (a.has_window) k_lo = max(0, q0 - a.window + 1);
  const int t_lo = k_lo / kBK;
  const int t_hi = k_hi > k_lo ? (k_hi + kBK - 1) / kBK : t_lo;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                 // the previous tile's K/V reads are done
    for (int i = tid; i < kBK * d; i += kThreads) {
      const int r = i / d, c = i - r * d;
      const bool in = k0 + r < a.sk;
      const long long off = (long long)(k0 + r) * d + c;
      sK[r * ld + c] = in ? to_f32(k[off]) : 0.f;
      sV[r * d + c] = in ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qa[4], kb[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sQ[(ty * 4 + i) * ld + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) kb[j] = sK[(tx + 8 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      bool ok[8];
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + tx + 8 * j;
        float x = s[i][j];
        if (a.has_softcap) x = tanhf(x / a.softcap) * a.softcap;
        ok[j] = kpos < a.sk && (!a.causal || qpos >= kpos) &&
                (!a.has_window || qpos - kpos < a.window);
        s[i][j] = ok[j] ? x : kNegInf;
        mc = fmaxf(mc, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mc));
      // guard fully masked rows (max = NEG_INF) against exp overflow to nan
      const float m_sub = m_new <= kNegInf / 2 ? 0.f : m_new;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_sub) : 0.f;
        psum += p;
        sP[(ty * 4 + i) * kLdP + tx + 8 * j] = p;
      }
      const float alpha = expf((m[i] <= kNegInf / 2 ? kNegInf : m[i]) - m_sub);
      l[i] = l[i] * alpha + group_sum(psum);
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncwarp();                    // a row group's P is written by its own warp

    for (int kk = 0; kk < kBK; ++kk) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = sP[(ty * 4 + i) * kLdP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 8 * c;
        if (col < d) {
          const float vb = sV[kk * d + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pa[i], vb, acc[i][c]);
        }
      }
    }
    __syncwarp();                    // P is rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.sq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 8 * c;
      if (col < d) o[(long long)row * d + col] = from_f32<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int NC>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const size_t bytes = smem_floats(a.d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<T, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(batch * a.hq), (unsigned)((a.sq + kBQ - 1) / kBQ));
  flash_fwd<T, NC><<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int batch, cudaStream_t stream) {
  if (a.d <= 32) return launch<T, 4>(a, batch, stream);
  if (a.d <= 64) return launch<T, 8>(a, batch, stream);
  if (a.d <= 96) return launch<T, 12>(a, batch, stream);
  return launch<T, 16>(a, batch, stream);
}

}  // namespace

// q: (batch, hq, sq, d); k, v: (batch, hkv, sk, d); o like q.  All contiguous,
// one dtype (0 = float32, 1 = bfloat16).  hq % hkv == 0, 1 <= d <= 128.
// window is read only when has_window, softcap only when has_softcap.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int batch, int hq, int hkv, int sq, int sk, int d,
                                     float scale, int causal, int has_window, int window,
                                     int has_softcap, float softcap, int dtype, void* stream) {
  if (batch < 0 || hq < 1 || hkv < 1 || hq % hkv || sq < 0 || sk < 0 || d < 1 || d > 128 ||
      (long long)batch * hq > 0x7fffffffLL || (sq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || sq == 0) return (int)cudaSuccess;
  const Args a{q, k, v, o, hq, hkv, sq, sk, d, scale, causal, has_window, window,
               has_softcap, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, batch, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, batch, s);
  return (int)cudaErrorInvalidValue;
}
