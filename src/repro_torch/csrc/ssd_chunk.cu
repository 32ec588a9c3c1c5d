// ssd_chunk: the chunk-local part of Mamba-2's SSD scan, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::ssd_chunk
// (_kernel at :31, pallas_call at :73), which runs every prefill and every
// cache-free forward (the training loss) of a Mamba-2 layer.  For each
// (batch * head, chunk) of L <= 64 steps, with x (L, p), a (L) and b, c (L, n):
//   a_cum   = cumsum(a)
//   S[i][j] = (c_i . b_j) * exp(a_cum_i - a_cum_j)   for j <= i, else 0
//   y_diag  = S x                                      (L, p)
//   w_l     = exp(a_cum_{L-1} - a_cum_l)
//   state   = (b o w)^T x                              (n, p)
// and a_cum itself, all in f32 whatever the inputs' types.  The exponential
// is taken only under the mask, as the TPU kernel masks before its exp
// (:41-42): above the diagonal a_cum_i - a_cum_j > 0 and can overflow.
//
// Bound on Hopper: bytes.  At the path's shape (24 heads, 64 chunks of 64,
// p 64, n 128; x, b, c bf16 and a f32) the kernel reads 63 MB and writes
// 76 MB of f32 outputs, 0.042 ms at 3.35 TB/s, against 4 GFLOP of products
// (0.004 ms on the bf16 tensor cores).  This first kernel runs the products
// in f32 on the CUDA cores out of shared memory, so it is expected to sit
// above the byte bound; tensor-core tiles and an output in fewer bytes are
// later work.
//
// Design: one block of 256 threads per (batch * head, chunk), the TPU grid
// (bh, nc) flattened; nothing carries between blocks.  The block stages x, b
// and c converted to f32 in dynamic shared memory, rows L..Lp-1 zero (Lp is
// L rounded up to 16), b and c rows padded to n + 1 floats so that threads
// reading one column of different rows hit different banks.  Warp 0 builds
// a_cum with a shuffle scan.  The three products use a 16 x 16 grid of
// threads, each owning a 4 x 4 register tile (rows ty + 16 r, columns
// tx + 16 q), over 64-wide column tiles where the output is wider.  The
// score tile S (Lp x (Lp + 1)) stays in shared memory between the first
// product and the second.  At the path's shape a block takes 99.6 KB of shared
// memory, above the 48 KB default, so the launcher opts in with
// cudaFuncSetAttribute (once per device, and again only for a larger size);
// two blocks share an SM.  L is a runtime value (a 37-token prompt is one
// chunk of 37), so no loop assumes a multiple of 16 or 32; p and n may take any value whose tiles fit in the shared memory a
// block may use (the C entry point refuses larger ones, and the Python
// wrapper raises first, naming the limit).  Nothing is reduced across blocks
// and the grid depends on the shapes only, so repeated launches give the same
// bits.  x, a, b and c may each be float32 or bfloat16.  The C entry point
// returns cudaGetLastError(); the Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

namespace {

constexpr int kThreads = 256;    // a 16 x 16 grid
constexpr int kMaxL = 64;        // four 16-row steps of a 4 x 4 register tile
constexpr int kTile = 64;        // output columns (and state rows) per pass

__host__ __device__ inline int padded_rows(int L) { return (L + 15) / 16 * 16; }

// floats of dynamic shared memory: x (Lp x p), b and c (Lp x (n + 1) each),
// S (Lp x (Lp + 1)), a_cum and w (Lp each); kernels/ssd_scan.py::smem_bytes
// checks the same sum before a launch
inline size_t smem_floats(int L, int p, int n) {
  const size_t lp = padded_rows(L);
  return lp * p + 2 * lp * (n + 1) + lp * (lp + 1) + 2 * lp;
}

__device__ __forceinline__ float load_f32(const void* ptr, size_t i, int dtype) {
  return dtype == 0 ? static_cast<const float*>(ptr)[i]
                    : __bfloat162float(static_cast<const __nv_bfloat16*>(ptr)[i]);
}

struct Args {
  const void* x;
  const void* a;
  const void* b;
  const void* c;
  float* y;
  float* st;
  float* acum;
  int L, p, n;
  int x_dtype, a_dtype, b_dtype, c_dtype;
};

__global__ void __launch_bounds__(kThreads) ssd_chunk_kernel(Args g) {
  extern __shared__ float smem[];
  const int L = g.L, p = g.p, n = g.n;
  const int Lp = padded_rows(L);
  const int R = Lp / 16;                       // 16-row steps in use, <= 4
  const int ldb = n + 1, lds = Lp + 1;
  float* sx = smem;                            // Lp x p
  float* sb = sx + (size_t)Lp * p;             // Lp x ldb
  float* sc = sb + (size_t)Lp * ldb;           // Lp x ldb
  float* ss = sc + (size_t)Lp * ldb;           // Lp x lds
  float* sacum = ss + (size_t)Lp * lds;        // Lp
  float* sw = sacum + Lp;                      // Lp

  const size_t blk = blockIdx.x;               // (batch * head) * nc + chunk
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  // ---- stage x, b, c in f32 (rows past L are zero) ----
  const size_t xoff = blk * (size_t)L * p, boff = blk * (size_t)L * n;
  for (int e = tid; e < Lp * p; e += kThreads)
    sx[e] = e < L * p ? load_f32(g.x, xoff + e, g.x_dtype) : 0.f;
  for (int e = tid; e < Lp * n; e += kThreads) {
    const int r = e / n, k = e - r * n;
    const bool in = r < L;
    sb[r * ldb + k] = in ? load_f32(g.b, boff + e, g.b_dtype) : 0.f;
    sc[r * ldb + k] = in ? load_f32(g.c, boff + e, g.c_dtype) : 0.f;
  }

  // ---- a_cum = cumsum(a): warp 0, a shuffle scan per 32 steps plus a carry ----
  if (tid < 32) {
    float carry = 0.f;
    for (int base = 0; base < Lp; base += 32) {
      const int l = base + tid;
      float v = l < L ? load_f32(g.a, blk * (size_t)L + l, g.a_dtype) : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (tid >= off) v += u;
      }
      v += carry;
      if (l < Lp) sacum[l] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
  for (int l = tid; l < Lp; l += kThreads)
    sw[l] = l < L ? expf(sacum[L - 1] - sacum[l]) : 0.f;
  if (tid < L) g.acum[blk * (size_t)L + tid] = sacum[tid];

  // ---- S = (C B^T) o decay, masked before the exp ----
  {
    float acc[4][4] = {};
    for (int k = 0; k < n; ++k) {
      float cv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = r < R ? sc[(ty + 16 * r) * ldb + k] : 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = q < R ? sb[(tx + 16 * q) * ldb + k] : 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(cv[r], bv[q], acc[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = ty + 16 * r, j = tx + 16 * q;
        if (r < R && q < R)
          ss[i * lds + j] = (i < L && j <= i) ? acc[r][q] * expf(sacum[i] - sacum[j]) : 0.f;
      }
  }
  __syncthreads();

  // ---- y_diag = S x ----
  for (int c0 = 0; c0 < p; c0 += kTile) {
    float acc[4][4] = {};
    for (int j = 0; j < L; ++j) {
      float sv[4], xv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) sv[r] = r < R ? ss[(ty + 16 * r) * lds + j] : 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = c0 + tx + 16 * q;
        xv[q] = col < p ? sx[j * p + col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(sv[r], xv[q], acc[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = ty + 16 * r, col = c0 + tx + 16 * q;
        if (i < L && col < p) g.y[xoff + (size_t)i * p + col] = acc[r][q];
      }
  }

  // ---- state = (b o w)^T x ----
  const size_t soff = blk * (size_t)n * p;
  for (int k0 = 0; k0 < n; k0 += kTile) {
    for (int c0 = 0; c0 < p; c0 += kTile) {
      float acc[4][4] = {};
      for (int l = 0; l < L; ++l) {
        const float wl = sw[l];
        float bv[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int k = k0 + ty + 16 * r;
          bv[r] = k < n ? sb[l * ldb + k] * wl : 0.f;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int col = c0 + tx + 16 * q;
          xv[q] = col < p ? sx[l * p + col] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(bv[r], xv[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = k0 + ty + 16 * r, col = c0 + tx + 16 * q;
          if (k < n && col < p) g.st[soff + (size_t)k * p + col] = acc[r][q];
        }
    }
  }
}

constexpr int kMaxDevices = 64;

// Per device: the shared memory a block may opt in to (0 until read), and the
// dynamic shared memory the kernel is set to allow (0 until set).  Both are
// read once and raised only when a launch needs more, so a launch at a size
// already allowed makes no driver call beyond cudaGetDevice.
std::atomic<int> g_optin[kMaxDevices];
std::atomic<int> g_allowed[kMaxDevices];
std::mutex g_allow_mutex;

// Lets ssd_chunk_kernel take `bytes` of dynamic shared memory on `dev`.
cudaError_t allow_smem(int dev, int bytes) {
  if (bytes <= g_allowed[dev].load(std::memory_order_acquire)) return cudaSuccess;
  std::lock_guard<std::mutex> lock(g_allow_mutex);
  if (bytes <= g_allowed[dev].load(std::memory_order_relaxed)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) g_allowed[dev].store(bytes, std::memory_order_release);
  return err;
}

}  // namespace

// x (blocks, L, p), a (blocks, L), b and c (blocks, L, n), contiguous, blocks
// being batch * heads * chunks; outputs y (blocks, L, p), st (blocks, n, p)
// and acum (blocks, L) in float32.  dtype codes: 0 = float32, 1 = bfloat16.
// Launches on `stream`.
extern "C" int repro_ssd_chunk(const void* x, const void* a, const void* b, const void* c,
                               void* y, void* st, void* acum, long long blocks, int L, int p,
                               int n, int x_dtype, int a_dtype, int b_dtype, int c_dtype,
                               void* stream) {
  if (blocks < 0 || blocks > 0x7fffffffLL || L < 1 || L > kMaxL || p < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  if ((x_dtype | a_dtype | b_dtype | c_dtype) & ~1) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaSuccess;
  const size_t bytes = smem_floats(L, p, n) * sizeof(float);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int optin = g_optin[dev].load(std::memory_order_relaxed);
  if (optin == 0) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    g_optin[dev].store(optin, std::memory_order_relaxed);
  }
  if (bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  err = allow_smem(dev, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  Args g{x, a, b, c, static_cast<float*>(y), static_cast<float*>(st),
         static_cast<float*>(acum), L, p, n, x_dtype, a_dtype, b_dtype, c_dtype};
  ssd_chunk_kernel<<<(unsigned)blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(g);
  return (int)cudaGetLastError();
}
