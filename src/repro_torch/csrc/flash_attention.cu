// flash_attention: blocked online-softmax attention for sm_90a, two kernels.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (_kernel at :33, pallas_call at :115), which runs every
// attention without a KV cache: the training loss and the cache-free forward.
// Both kernels compute, per (batch, query head),
// o = softmax(mask(cap(q k^T * scale))) v with causal masking, GQA (kv head =
// q head / group, read in place, never repeated), a sliding window, tanh
// soft-capping and a guard that makes a fully masked row 0 instead of NaN, at
// any sequence length (rows and keys past the end are masked in the kernel).
// The C entry point takes the variant the wrapper chose
// (kernels/flash_attention.py::variant) and refuses one that cannot take the
// inputs.
//
// flash_fwd_wgmma: bfloat16 with a head dim d that is a multiple of 16 up to
// 128 (the training path: d 96).
//   Bound on Hopper: operations.  At phi3's training shape (1, 32, 4096, 96)
//   the causal half of QK^T and PV is ~103 GFLOP against ~100 MB of q/k/v/o,
//   about 1000 flops per byte, far above the card's ridge (~295), so the bf16
//   tensor cores (989 TFLOP/s) set the bound, 0.104 ms.  Only wgmma reaches
//   that rate, and only if shared memory is fed without stalling it.
//   Design: the usual Hopper shape, a producer keeping TMA loads in flight
//   into a ring of tiles and consumer warpgroups running wgmma on the tiles
//   that have arrived.  One block of three warpgroups per (128 query rows,
//   batch * q head).  Warpgroup 0 produces: one thread issues the TMA
//   loads, the Q tile once, then K and V tiles of 128 keys into a ring of 3
//   stages (4 at d <= 64), each stage with a "full" mbarrier (the TMA's
//   bytes) and an "empty" one (one arrival per consumer warp).  The two
//   consumer warpgroups own 64 query rows each.  Per key tile a consumer
//   runs S = Q K^T as wgmma m64n128k16 with both operands in shared memory
//   (K, stored keys x d, is already the K-major B operand) and keeps S in
//   f32 registers; applies scale to the f32 scores, not to a bf16 copy of
//   q, folded with log2 e into the exp2's FMA (the soft cap, when set, is
//   taken first); masks only the tiles that cross the causal diagonal, the
//   window's edge or the end of the keys; runs the TPU kernel's update of
//   m, l and acc (:59-71) in registers; rounds P to bf16 in registers (the
//   S accumulator's layout is the A fragments' layout); and runs O += P V
//   as wgmma m64nNk16 with P as the register A operand and V, stored
//   keys x d, as the MN-major (transposed) B operand.  A row of d 96 is 192
//   bytes, wider than the 128 B a swizzled TMA box may span, so every tile
//   is loaded as 64-column slabs in the 128B swizzle (TMA fills the columns
//   past d with zeros): the QK^T k-steps walk the slabs' descriptors, and
//   P V runs one wgmma per slab.  Key tiles entirely outside the causal or
//   sliding window are skipped, which is exact: in the TPU kernel such a
//   tile leaves m, l and acc unchanged.  The output is
//   acc / (l == 0 ? 1 : l).  Rounding P to bf16 moves an output by at most
//   2^-9 max|v| (the tolerance in kernels/flash_attention.py::tolerance).
//   The block's shared memory, up to 225 KB, is opted in once per device.
//   A pipeline stall that would hang the card traps instead.
//   Tried on the card and left out (PERF.md): setmaxnreg (ptxas still
//   allocates the kernel's 168 registers a thread to every warpgroup, and
//   spills), a pingpong of the two consumers at the tensor cores, and
//   overlapping the next tile's Q K^T with the softmax (it spills at 168
//   registers with 128-key tiles; with 64-key tiles it ties this loop).
//
// flash_fwd_simt: float32, or bf16 with any other d up to 128.  The port's
// first kernel, unchanged: one block of 128 threads per (64-row query tile,
// batch * q head); 64-key K/V tiles staged in shared memory as f32, q scaled
// before the product (as the TPU kernel does at :45), both products as f32
// FMAs on the CUDA cores (67 TFLOP/s peak), so it sits far above the bound.
// Thread (ty, tx) owns query rows 4*ty..4*ty+3 and key columns tx + 8*j of
// the score tile, and output columns tx + 8*c of the same rows; the 8
// threads of a row group are consecutive lanes of one warp, so row maxima
// and sums are warp shuffles.
//
// Neither kernel uses atomics or splits the keys across blocks, and the grid
// depends on the shapes only, so repeated launches give the same bits.  The
// latest query tiles launch first: causal blocks differ in work.  The C entry
// point returns cudaGetLastError(), or a negative code when libcuda's
// tensor-map encoder is missing (-1) or refuses the inputs (-2); the wrapper
// raises when it is not 0.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

namespace {

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

constexpr int kNoEncoder = -1;      // cuTensorMapEncodeTiled not found
constexpr int kEncodeFailed = -2;   // it refused a tensor

// ---------------------------------------------------------------------------
// The CUDA-core kernel: float32, or bfloat16 with a head dim the
// tensor-core kernel does not take.
// ---------------------------------------------------------------------------
namespace simt {

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

// Shared memory, in floats: Q and K tiles with a padded row stride d + 1
// (conflict-free column reads), V with stride d, P with stride kBK + 1.
__host__ __device__ inline size_t smem_floats(int d) {
  return (size_t)(kBQ + kBK) * (d + 1) + (size_t)kBK * d + (size_t)kBQ * kLdP;
}

// NC: output columns per thread, ceil(d / 8) <= NC.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) flash_fwd_simt(Args a) {
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

constexpr int kMaxDevices = 64;

// Per device and kernel instance: the dynamic shared memory the kernel is set
// to allow (0 until set), raised only when a launch needs more, so a launch at
// a size already allowed makes no driver call beyond cudaGetDevice.
template <typename T, int NC>
cudaError_t allow_smem(int bytes) {
  static std::atomic<int> allowed[kMaxDevices];
  static std::mutex mutex;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= allowed[dev].load(std::memory_order_acquire)) return cudaSuccess;
  std::lock_guard<std::mutex> lock(mutex);
  if (bytes <= allowed[dev].load(std::memory_order_relaxed)) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_fwd_simt<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) allowed[dev].store(bytes, std::memory_order_release);
  return err;
}

template <typename T, int NC>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const size_t bytes = smem_floats(a.d) * sizeof(float);
  const cudaError_t err = allow_smem<T, NC>((int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(batch * a.hq), (unsigned)((a.sq + kBQ - 1) / kBQ));
  flash_fwd_simt<T, NC><<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int batch, cudaStream_t stream) {
  if (a.d <= 32) return launch<T, 4>(a, batch, stream);
  if (a.d <= 64) return launch<T, 8>(a, batch, stream);
  if (a.d <= 96) return launch<T, 12>(a, batch, stream);
  return launch<T, 16>(a, batch, stream);
}

}  // namespace simt

// ---------------------------------------------------------------------------
// The tensor-core kernel: bfloat16, head dim a multiple of 16 up to 128.
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBQ = 128;              // query rows per block: two consumer warpgroups of 64
constexpr int kBK = 128;              // keys per K/V tile
constexpr int kThreads = 384;         // warpgroup 0 loads, warpgroups 1 and 2 compute
constexpr int kConsumerWarps = 8;
constexpr int kSlabCols = 64;         // head-dim columns a TMA box holds: 128 B, the swizzle span
constexpr uint32_t kRowBytes = kSlabCols * 2u;
constexpr uint32_t kRowGroupBytes = 8u * kRowBytes;     // 8 swizzled rows of a box, 1 KB
constexpr uint32_t kQSlab = kBQ * kRowBytes;            // one Q box, 16 KB
constexpr uint32_t kKVSlab = kBK * kRowBytes;           // one K or V box
constexpr float kLog2e = 1.4426950408889634f;

// DN: the head dim rounded up to 16, 32, 64, 96 or 128 (the widths the
// kernel is built for; TMA fills the columns past d with zeros).
template <int DN>
struct Shape {
  static constexpr int kSlabs = (DN + kSlabCols - 1) / kSlabCols;
  static constexpr uint32_t kQTile = kSlabs * kQSlab;
  static constexpr uint32_t kKVTile = kSlabs * kKVSlab;
  static constexpr int kStages = kSlabs == 1 ? 4 : 3;   // K/V ring depth within 227 KB
  // 1 KB of slack to align the tiles for the 128B swizzle, the Q tile, the
  // K and V rings, and the mbarriers (full and empty per stage, one for Q)
  static constexpr uint32_t kSmem = 1024u + kQTile + 2u * kStages * kKVTile + 8u * (2 * kStages + 1);
};

struct TcArgs {
  __nv_bfloat16* o;
  int hq, hkv, sq, sk, d;
  float scale;
  int causal, has_window, window, has_softcap;
  float softcap;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the phase of `bar` with this parity to complete.  A wait that
// outlasts ~2^34 cycles (seconds; a working pipeline waits microseconds)
// traps, so a broken pipeline ends the launch with an error instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// One TMA load of a box of `map` at (c0, c1, c2) into shared memory at
// `dst`; its bytes complete a transaction on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma shared-memory matrix descriptor for a tile in the 128B-swizzled
// layout TMA writes: start address, leading and stride byte offsets.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous product's issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// 2^x on the special function unit (2 ulp; subnormal results flush to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S (64 x 128, f32) [+]= A (64 x 16, shared) . B (128 x 16, shared)^T, both
// K-major; accumulate = 0 overwrites S.  The m64nNk16 products below take A
// from registers and B transposed (MN-major) and always accumulate.
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_m64n16(float (&d)[8], const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n32(float (&d)[16], const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O (64 x N, f32) += P (64 x 16, bf16 registers) . V (16 x N, shared, MN-major);
// a slab of the head dim at most 64 wide per call.
template <int N>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t (&p)[4], uint64_t v) {
  if constexpr (N == 16) wgmma_rs_m64n16(*reinterpret_cast<float(*)[8]>(o), p, v);
  if constexpr (N == 32) wgmma_rs_m64n32(*reinterpret_cast<float(*)[16]>(o), p, v);
  if constexpr (N == 64) wgmma_rs_m64n64(*reinterpret_cast<float(*)[32]>(o), p, v);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int DN>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const TcArgs a) {
  using Sh = Shape<DN>;
  constexpr int kSlabs = Sh::kSlabs, kStages = Sh::kStages;
  constexpr uint32_t kKVTile = Sh::kKVTile;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + Sh::kQTile;             // stage s at sK + s * kKVTile
  const uint32_t sV = sK + kStages * kKVTile;
  const uint32_t bars = sV + kStages * kKVTile;    // full[s], then empty[s], then Q's
  const uint32_t q_bar = bars + 16u * kStages;

  const int bh = blockIdx.x;                       // b * hq + query head
  const int b = bh / a.hq, qh = bh - b * a.hq;
  const int kvh = b * a.hkv + qh / (a.hq / a.hkv);   // kv_map
  // the longest (latest) query tiles first: causal blocks differ in work
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  // key tiles any row of this block may see
  const int q_last = min(q0 + kBQ, a.sq) - 1;
  int k_lo = 0, k_hi = a.sk;
  if (a.causal) k_hi = min(k_hi, q_last + 1);
  if (a.has_window) k_lo = max(0, q0 - a.window + 1);
  const int t_lo = k_lo / kBK;
  const int t_hi = k_hi > k_lo ? (k_hi + kBK - 1) / kBK : t_lo;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8u * s, 1);                              // the producer's expect_tx
      mbar_init(bars + 8u * (kStages + s), kConsumerWarps);     // one arrival per consumer warp
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every TMA load
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_bar, Sh::kQTile);
      for (int c = 0; c < kSlabs; ++c)
        tma_load(sQ + c * kQSlab, &tm_q, q_bar, c * kSlabCols, q0, bh);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = t_lo; t < t_hi; ++t) {
        mbar_wait(bars + 8u * (kStages + stage), phase ^ 1u);   // the consumers freed it
        const uint32_t full = bars + 8u * stage;
        mbar_expect_tx(full, 2 * kKVTile);
        for (int c = 0; c < kSlabs; ++c) {
          tma_load(sK + stage * kKVTile + c * kKVSlab, &tm_k, full, c * kSlabCols, t * kBK, kvh);
          tma_load(sV + stage * kKVTile + c * kKVSlab, &tm_v, full, c * kSlabCols, t * kBK, kvh);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }

  // consumer warpgroups: 64 query rows each
  const int cw = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int r_lo = q0 + 64 * cw;                   // this warpgroup's first row
  const int row0 = r_lo + 16 * warp + (lane >> 2); // this thread's rows: row0 and row0 + 8
  const int col0 = 2 * (lane & 3);                 // and its columns: col0 + 8 i + {0, 1}
  // exp2's argument is s * c - m: c = scale * log2 e folds the scale into
  // one FMA, unless the scores are scaled (and capped) first
  const bool prescale = a.has_softcap || !(a.scale > 0.f);
  const float c = prescale ? 1.f : a.scale * kLog2e;

  // accumulator element 4 i + 2 h + e sits at row row0 + 8 h, column 8 i + col0 + e
  float o[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};             // running max, in units of s * c
  float l[2] = {0.f, 0.f};                         // this thread's part of the row sums

  mbar_wait(q_bar, 0);
  const uint64_t desc_q = make_desc(sQ + cw * 64 * kRowBytes, 16, kRowGroupBytes);
  int stage = 0;
  uint32_t phase = 0;
  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBK;
    mbar_wait(bars + 8u * stage, phase);
    const uint32_t k_tile = sK + stage * kKVTile, v_tile = sV + stage * kKVTile;

    // S = Q K^T: 16 head-dim columns a step, 4 steps per 64-column slab
    float s[kBK / 2];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < DN / 16; ++j) {
      const uint32_t off_q = (j / 4) * kQSlab + (j % 4) * 32u;
      const uint32_t off_k = (j / 4) * kKVSlab + (j % 4) * 32u;
      wgmma_ss_m64n128(s, desc_q + (off_q >> 4), make_desc(k_tile + off_k, 16, kRowGroupBytes),
                       j > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    if (a.has_softcap) {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i)
        s[i] = tanhf(s[i] * (a.scale / a.softcap)) * (a.softcap * kLog2e);
    } else if (prescale) {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) s[i] *= a.scale * kLog2e;
    }
    // mask only tiles that cross the causal diagonal, the window's edge or
    // the end of the keys
    if ((a.causal && k0 + kBK - 1 > r_lo) || (a.has_window && k0 <= r_lo + 63 - a.window) ||
        k0 + kBK > a.sk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qpos = row0 + 8 * h;
#pragma unroll
        for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kpos = k0 + 8 * i + col0 + e;
            const bool ok = kpos < a.sk && (!a.causal || kpos <= qpos) &&
                            (!a.has_window || qpos - kpos < a.window);
            if (!ok) s[4 * i + 2 * h + e] = -INFINITY;
          }
      }
    }
    // the online softmax update of m, l and acc (the TPU kernel's :59-71)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < kBK / 8; ++i) mx = fmaxf(mx, fmaxf(s[4 * i + 2 * h], s[4 * i + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx * c);
      // guard rows with nothing seen yet (max = -inf) against inf - inf
      const float m_sub = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = fast_exp2(m[h] - m_sub);
      m[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = fast_exp2(fmaf(s[4 * i + 2 * h + e], c, -m_sub));
          s[4 * i + 2 * h + e] = p;
          sum += p;
        }
      l[h] = l[h] * alpha + sum;
#pragma unroll
      for (int i = 0; i < DN / 8; ++i) {
        o[4 * i + 2 * h] *= alpha;
        o[4 * i + 2 * h + 1] *= alpha;
      }
    }

    // O += P V: P rounded to bf16 in registers is the A operand (the S
    // accumulator's layout is the A fragments' layout), 16 keys a step; V is
    // read per 64-column slab of the head dim
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t v_rows = v_tile + kk * 2 * kRowGroupBytes;   // keys 16 kk .. 16 kk + 15
#pragma unroll
      for (int sl = 0; sl + 1 < kSlabs; ++sl)
        wgmma_pv<kSlabCols>(o + sl * kSlabCols / 2, pa[kk],
                            make_desc(v_rows + sl * kKVSlab, kKVSlab, kRowGroupBytes));
      constexpr int kLast = DN - kSlabCols * (kSlabs - 1);       // the last slab's width
      wgmma_pv<kLast>(o + (kSlabs - 1) * kSlabCols / 2, pa[kk],
                      make_desc(v_rows + (kSlabs - 1) * kKVSlab, kKVSlab, kRowGroupBytes));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    if (lane == 0) mbar_arrive(bars + 8u * (kStages + stage));   // the stage is free
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1u;
    }
  }

  // o = acc / (l == 0 ? 1 : l), stored as bf16
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float den = lt == 0.f ? 1.f : lt;
    const int row = row0 + 8 * h;
    if (row >= a.sq) continue;
    __nv_bfloat16* out = a.o + ((long long)bh * a.sq + row) * a.d;
#pragma unroll
    for (int i = 0; i < DN / 8; ++i) {
      const int col = 8 * i + col0;
      if (col < a.d)
        *reinterpret_cast<__nv_bfloat162*>(out + col) =
            __floats2bfloat162_rn(o[4 * i + 2 * h] / den, o[4 * i + 2 * h + 1] / den);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, which the build does not link:
// fetch it once through the runtime.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// (heads, rows, d) bf16, contiguous, as a 3-D tensor map of 64-column x
// box_rows boxes in the 128B swizzle; rows and columns past the ends read as 0.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* base, int d, int rows, long long heads,
            uint32_t box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {kSlabCols, box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kMaxDevices = 64;

template <int DN>
int launch(const Args& a, int batch, cudaStream_t stream) {
  using Sh = Shape<DN>;
  // per device: whether the kernel may take its dynamic shared memory yet
  static std::atomic<bool> allowed[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!allowed[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(flash_fwd_wgmma<DN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Sh::kSmem);
    if (err != cudaSuccess) return (int)err;
    allowed[dev].store(true, std::memory_order_release);
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoEncoder;
  CUtensorMap tq, tk, tv;
  if (!encode(fn, &tq, a.q, a.d, a.sq, (long long)batch * a.hq, kBQ) ||
      !encode(fn, &tk, a.k, a.d, a.sk, (long long)batch * a.hkv, kBK) ||
      !encode(fn, &tv, a.v, a.d, a.sk, (long long)batch * a.hkv, kBK))
    return kEncodeFailed;
  const TcArgs t{static_cast<__nv_bfloat16*>(a.o), a.hq, a.hkv, a.sq, a.sk, a.d, a.scale,
                 a.causal, a.has_window, a.window, a.has_softcap, a.softcap};
  const dim3 grid((unsigned)(batch * a.hq), (unsigned)((a.sq + kBQ - 1) / kBQ));
  flash_fwd_wgmma<DN><<<grid, kThreads, Sh::kSmem, stream>>>(tq, tk, tv, t);
  return (int)cudaGetLastError();
}

int dispatch(const Args& a, int batch, cudaStream_t stream) {
  if (a.d <= 16) return launch<16>(a, batch, stream);
  if (a.d <= 32) return launch<32>(a, batch, stream);
  if (a.d <= 64) return launch<64>(a, batch, stream);
  if (a.d <= 96) return launch<96>(a, batch, stream);
  return launch<128>(a, batch, stream);
}

}  // namespace tc

}  // namespace

// q: (batch, hq, sq, d); k, v: (batch, hkv, sk, d); o like q.  All contiguous,
// one dtype (0 = float32, 1 = bfloat16).  hq % hkv == 0, 1 <= d <= 128.
// window is read only when has_window, softcap only when has_softcap.
// variant 0 runs flash_fwd_simt; variant 1 runs flash_fwd_wgmma and needs
// bfloat16, d a multiple of 16, sk >= 1 and 16-byte aligned q, k and v.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int batch, int hq, int hkv, int sq, int sk, int d,
                                     float scale, int causal, int has_window, int window,
                                     int has_softcap, float softcap, int dtype, int variant,
                                     void* stream) {
  if (batch < 0 || hq < 1 || hkv < 1 || hq % hkv || sq < 0 || sk < 0 || d < 1 || d > 128 ||
      (long long)batch * hq > 0x7fffffffLL || (sq + simt::kBQ - 1) / simt::kBQ > 65535 ||
      (dtype != 0 && dtype != 1) || (variant != 0 && variant != 1))
    return (int)cudaErrorInvalidValue;
  if (variant == 1 && (dtype != 1 || d % 16 || sk < 1 ||
                       ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16))
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || sq == 0) return (int)cudaSuccess;
  const Args a{q, k, v, o, hq, hkv, sq, sk, d, scale, causal, has_window, window,
               has_softcap, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) return tc::dispatch(a, batch, s);
  if (dtype == 0) return simt::dispatch<float>(a, batch, s);
  return simt::dispatch<__nv_bfloat16>(a, batch, s);
}
