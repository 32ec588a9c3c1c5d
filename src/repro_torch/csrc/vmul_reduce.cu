// vmul_reduce: sum = sum_i a[i] * b[i] over two equal 1-D vectors, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/vmul_reduce.py::vmul_reduce
// (pallas_call at :63), the paper's own VMUL & Reduce workload and the
// overlay's LARGE "vmul_reduce" bitstream.
//
// Bound on Hopper: bytes read.  The kernel does 2 flops per 2 input elements,
// far below the ~295 flop/byte ridge of an H100, so the least time is
// 2 * n * sizeof(T) / (3.35 TB/s).  At the paper's 16 KB the device work is a
// few microseconds and the cost of a call is its launch: one launch per call,
// at every n, and no scratch allocation on the small path.
//
// Design (the caller's launch plan, kernels/vmul_reduce.py::plan, depends on
// n only, so the order of the float sums -- and the result's bits -- is the
// same on every run, stream and H100):
//  * Every thread g of W sums the 16-byte chunks j = g, g + W, g + 2W, ... of
//    a*b (4 f32 or 8 bf16 per chunk), one f32 accumulator per lane of the
//    chunk; the ragged tail (n % VEC elements) is the last chunk, masked.
//    Its lanes then add in a halving tree, the warp in a shuffle tree, the
//    block's warps in a second shuffle tree.  Products and sums are
//    __fmul_rn/__fadd_rn, never contracted to FMAs, so the order is exactly
//    the one the CPU tests emulate.  An unaligned input takes scalar loads of
//    the same chunks in the same order: the same bits as the aligned path.
//  * Small n: ONE thread-block cluster (vmul_reduce_cluster).  Rank 0 adds
//    the CTAs' partials in rank order, read from their shared memory through
//    distributed shared memory (map_shared_rank), and writes the result.  No
//    scratch buffer, no second pass.
//  * Large n: a grid of at most kMaxBlocks blocks (vmul_reduce_grid), each
//    writing one f32 partial to a workspace.  The last block to finish --
//    found through an unsigned ticket (__threadfence, then an integer
//    atomicAdd) -- adds the partials in index order, writes the result and
//    resets the ticket.  The atomic only decides WHO adds; the order is fixed.
//  * No float atomics: the overlay promises bit-identical outputs across
//    placements and repeated calls.
// The C entry point takes the device ordinal (it switches the calling
// thread's device only when it differs, and switches back) and returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;          // chunks in flight per thread on the aligned path
constexpr int kMaxBlocks = 528;     // 132 SMs x 4 blocks of 256 threads: one wave
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// v summed over the warp in a halving tree (lane i adds lane i + off); valid in lane 0.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

// v summed over the block: each warp's tree, then a tree over the warps'
// sums; valid in thread 0.  Starts and ends with a barrier on warp_part's use.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_part[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  v = 0.f;
  if (warp == 0) {
    if (lane < kWarps) v = warp_part[lane];
    v = warp_sum(v);
  }
  return v;
}

template <typename T, int VEC>
__device__ __forceinline__ void accumulate(float (&acc)[VEC], const uint4& ra, const uint4& rb) {
  const T* pa = reinterpret_cast<const T*>(&ra);
  const T* pb = reinterpret_cast<const T*>(&rb);
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(to_f32(pa[k]), to_f32(pb[k])));
}

// Thread g's share of sum(a * b) when W threads share the work (see the note
// at the top for the order).  ALIGNED: both pointers 16-byte aligned.
template <typename T, bool ALIGNED>
__device__ __forceinline__ float thread_sum(const T* __restrict__ a, const T* __restrict__ b,
                                            long long n, long long g, long long W) {
  constexpr int VEC = 16 / sizeof(T);
  const long long full = n / VEC;          // whole 16-byte chunks
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  long long j = g;
  if (ALIGNED) {
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    const uint4* b4 = reinterpret_cast<const uint4*>(b);
    for (; j + (kUnroll - 1) * W < full; j += kUnroll * W) {
      uint4 ra[kUnroll], rb[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        ra[u] = a4[j + u * W];
        rb[u] = b4[j + u * W];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) accumulate<T, VEC>(acc, ra[u], rb[u]);
    }
    for (; j < full; j += W) accumulate<T, VEC>(acc, a4[j], b4[j]);
  } else {
    for (; j < full; j += W) {
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        acc[k] = __fadd_rn(acc[k], __fmul_rn(to_f32(a[j * VEC + k]), to_f32(b[j * VEC + k])));
    }
  }
  if (j == full) {                         // the ragged last chunk is this thread's
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const long long i = full * VEC + k;
      if (i < n) acc[k] = __fadd_rn(acc[k], __fmul_rn(to_f32(a[i]), to_f32(b[i])));
    }
  }
#pragma unroll
  for (int h = VEC / 2; h > 0; h >>= 1) {
#pragma unroll
    for (int k = 0; k < h; ++k) acc[k] = __fadd_rn(acc[k], acc[k + h]);
  }
  return acc[0];
}

// Small n: one cluster of gridDim.x CTAs (the launch's cluster dimension).
template <typename T, bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
vmul_reduce_cluster(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
                    long long n) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ float part;
  const unsigned rank = cluster.block_rank();
  const unsigned size = cluster.num_blocks();
  float v = thread_sum<T, ALIGNED>(a, b, n, (long long)rank * kThreads + threadIdx.x,
                                   (long long)size * kThreads);
  v = block_sum(v);
  if (threadIdx.x == 0) part = v;
  cluster.sync();                          // every partial written, cluster-wide
  if (rank == 0 && threadIdx.x < 32) {     // size <= 32: one warp adds the partials
    float s = threadIdx.x < size ? *cluster.map_shared_rank(&part, threadIdx.x) : 0.f;
    s = warp_sum(s);
    if (threadIdx.x == 0) out[0] = from_f32<T>(s);
  }
  cluster.sync();                          // no CTA exits while rank 0 reads its memory
}

// Large n: gridDim.x blocks; parts[b] holds block b's partial, *ticket counts
// finished blocks and is 0 between launches.
template <typename T, bool ALIGNED>
__global__ void __launch_bounds__(kThreads, 4)
vmul_reduce_grid(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
                 float* __restrict__ parts, unsigned* __restrict__ ticket, long long n) {
  __shared__ bool last;
  float v = thread_sum<T, ALIGNED>(a, b, n, (long long)blockIdx.x * kThreads + threadIdx.x,
                                   (long long)gridDim.x * kThreads);
  v = block_sum(v);
  if (threadIdx.x == 0) {
    parts[blockIdx.x] = v;
    __threadfence();                       // the partial is visible before the ticket moves
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float s = 0.f;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads) s = __fadd_rn(s, __ldcg(parts + i));
  s = block_sum(s);
  if (threadIdx.x == 0) {
    out[0] = from_f32<T>(s);
    *ticket = 0u;                          // ready for the next launch on this stream
  }
}

template <typename T, bool ALIGNED>
int launch(const T* a, const T* b, T* out, void* workspace, long long n, int cluster, int blocks,
           cudaStream_t stream) {
  if (cluster > 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)cluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, vmul_reduce_cluster<T, ALIGNED>, a, b, out, n);
    if (err != cudaSuccess) return (int)err;   // a refused cluster launch is an error, not a retry
    return (int)cudaGetLastError();
  }
  unsigned* ticket = static_cast<unsigned*>(workspace);
  float* parts = reinterpret_cast<float*>(ticket + 1);
  vmul_reduce_grid<T, ALIGNED><<<blocks, kThreads, 0, stream>>>(a, b, out, parts, ticket, n);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* a, const void* b, void* out, void* workspace, long long n, int cluster,
             int blocks, cudaStream_t stream) {
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  T* po = static_cast<T*>(out);
  if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16 == 0)
    return launch<T, true>(pa, pb, po, workspace, n, cluster, blocks, stream);
  return launch<T, false>(pa, pb, po, workspace, n, cluster, blocks, stream);
}

// Makes `device` current for its lifetime when it is not, and restores the caller's.
struct DeviceScope {
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

// dtype: 0 = float32, 1 = bfloat16 (a, b and out).  cluster > 0: one cluster of
// `cluster` CTAs (1..8), no workspace; cluster == 0: `blocks` blocks (1..528)
// and a workspace of 1 + blocks 32-bit words whose first word (the ticket) is
// 0, used by one stream at a time.  Launches on `stream`; does not synchronise.
extern "C" int repro_vmul_reduce(const void* a, const void* b, void* out, void* workspace,
                                 long long n, int cluster, int blocks, int dtype, int device,
                                 void* stream) {
  if (n < 0 || cluster < 0 || cluster > kMaxCluster || device < 0 || device >= kMaxDevices ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (cluster == 0 && (blocks < 1 || blocks > kMaxBlocks || workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, b, out, workspace, n, cluster, blocks, s);
  return dispatch<__nv_bfloat16>(a, b, out, workspace, n, cluster, blocks, s);
}
