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
//   state   = (b o w)^T x = b^T (w o x)                (n, p)
// and a_cum itself, all in f32 whatever the inputs' types, as the TPU
// kernel's out_shape is.  The exponential is taken only under the mask, as
// the TPU kernel masks before its exp (:41-42): above the diagonal
// a_cum_i - a_cum_j > 0 and can overflow.
//
// Bound on Hopper: bytes.  At the path's shape (24 heads, 64 chunks of 64,
// p 64, n 128; x, b, c bf16 and a f32) a call reads 63 MB and writes 76 MB
// of f32 outputs: 0.042 ms at 3.35 TB/s, against 4 GFLOP of products
// (0.004 ms on the bf16 tensor cores, 0.06 ms on the f32 CUDA cores).  Two
// kernels, picked by kernels/ssd_scan.py::variant and passed here as
// `variant` (the entry point refuses a pick that cannot take the inputs):
//
// ssd_chunk_mma (variant 1): x, b, c bf16, a f32, p 64, n 128, L <= 64, every
// pointer 16-byte aligned -- every launch of the mamba2 paths.  What held the
// first kernel above its bound was arithmetic on the CUDA cores and loads
// that did not overlap compute; this one
//   * runs the three products on the tensor cores, mma.sync.m16n8k16 bf16
//     with f32 accumulation.  C B^T takes the bf16 inputs as they are (their
//     products are exact in f32; only the order of the sums changes).  S x
//     and b^T (w o x) have one f32 operand (S, w o x): it is split into three
//     bf16 parts, hi + mid + lo, each a product of its own into the same f32
//     accumulator.  Three parts carry 24 significant bits, so the result
//     keeps f32's precision (two would leave ~2^-17 of each term, too close
//     to the 1e-5 the outputs are held to; TF32 keeps 10 bits);
//   * overlaps loads with compute: a block walks a run of consecutive chunks
//     (one wave of blocks covers the grid) through a two-stage ring in
//     shared memory fed by cp.async, so chunk k+1's x, b, c and a arrive
//     while chunk k computes and stores; rows past L are zero-filled by the
//     copy (a 37-token prompt is one chunk of 37), so every product runs
//     over 64 rows and the padding adds exact zeros;
//   * stores y_diag and the states as 16-byte streaming stores: the two
//     lanes of an accumulator pair trade halves with one shuffle each, so a
//     lane holds four consecutive floats of one row.
// Tiles are bf16 rows in 16-byte chunks, the chunk index XORed with the
// row's low three bits, so the 8 rows an ldmatrix reads hit 8 different
// bank groups.  Eight warps: for the scores and y_diag, warp w takes rows
// 16 (w % 4) .. +15 and the 32 output columns (w / 4); both warps of a row
// tile compute its scores (only the tiles on or below the diagonal), and
// the scores feed the next product from registers, as the A operand.  For
// the states, warp w takes state rows 16 w .. +15.  105 KB of shared memory
// a block, two blocks an SM.
//
// ssd_chunk_simt (variant 0): the port's first kernel, for f32 inputs and any
// other shape.  One block of 256 threads per (batch * head, chunk), the TPU grid
// (bh, nc) flattened.  The block stages x, b and c converted to f32 in
// dynamic shared memory, rows L..Lp-1 zero (Lp is L rounded up to 16), b and
// c rows padded to n + 1 floats so that threads reading one column of
// different rows hit different banks.  Warp 0 builds a_cum with a shuffle
// scan.  The three products run on the CUDA cores over a 16 x 16 grid of
// threads, each owning a 4 x 4 register tile (rows ty + 16 r, columns
// tx + 16 q), over 64-wide column tiles where the output is wider.  The
// score tile S (Lp x (Lp + 1)) stays in shared memory between the first
// product and the second.  At the path's shape a block takes 99.6 KB; the
// launcher opts in with cudaFuncSetAttribute (once per device, and again
// only for a larger size).  p and n may take any value whose tiles fit in
// the shared memory a block may use (the C entry point refuses larger ones,
// and the Python wrapper raises first, naming the limit).
//
// Both: nothing is reduced across blocks and no atomics are used, so
// repeated launches give the same bits.  The C entry point returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>
#include <mutex>

namespace {

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
  long long chunks;      // batch * heads * chunks
  long long per_block;   // consecutive chunks one block walks (ssd_chunk_mma)
};

namespace simt {

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

__global__ void __launch_bounds__(kThreads) ssd_chunk_simt(Args g) {
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

}  // namespace simt

namespace mma {

constexpr int kL = 64;                     // rows a chunk is staged at (L <= 64, zero-padded)
constexpr int kP = 64;                     // head dim
constexpr int kN = 128;                    // state size
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kParts = 3;                  // bf16 parts of an f32 operand
constexpr int kXChunks = kP * 2 / 16;      // 16-byte chunks in a bf16 row of x
constexpr int kBChunks = kN * 2 / 16;      // ... of b and c
constexpr int kXBytes = kL * kP * 2;
constexpr int kBBytes = kL * kN * 2;
constexpr int kStageBytes = kXBytes + 2 * kBBytes + kL * 4;     // x, b, c, a
constexpr int kStages = 2;
constexpr int kWxOffset = kStages * kStageBytes;                // kParts parts of w o x
constexpr int kAcumOffset = kWxOffset + kParts * kXBytes;       // a_cum, then w
constexpr int kSmemBytes = kAcumOffset + 2 * kL * 4;            // 107,520
static_assert(kStageBytes % 128 == 0 && kWxOffset % 128 == 0, "tiles stay 128-byte aligned");
static_assert(kL == 64 && kP == 64 && kN % 64 == 0 && kN / 16 == kWarps,
              "the warp layout below assumes 64 rows, 64 columns and 16 state rows a warp");

// Byte offset of 16-byte chunk `q` of row `r` in a tile of `chunks`-chunk
// rows: the chunk index XORed with the row's low three bits.
__device__ __forceinline__ uint32_t swz(int r, int q, int chunks) {
  return (uint32_t)(r * chunks + (q ^ (r & 7))) * 16u;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b for one 16 x 8 tile: a the 16 x 16 bf16 A fragment, (b0, b1) the
// 16 x 8 bf16 B fragment, d f32.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  uint32_t r;
  memcpy(&r, &h, 4);
  return r;
}

// (u, v) as kParts packed bf16 pairs whose sum is (u, v): each part is the
// remainder of the ones before it rounded to bf16 (each subtraction exact).
__device__ __forceinline__ void split(float u, float v, uint32_t (&out)[kParts]) {
#pragma unroll
  for (int k = 0; k < kParts; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(u, v);
    out[k] = bits(h);
    u -= __low2float(h);
    v -= __high2float(h);
  }
}

// Stores one 16 x 8 f32 accumulator tile (rows row0.., columns col0..) of a
// row-major matrix with `ld` columns, rows >= `rows` left out.  Lane (g, t)
// holds rows g and g + 8 at columns 2t, 2t + 1; the lanes t and t ^ 1 trade
// one row's pair each, so that every lane stores four consecutive floats.
__device__ __forceinline__ void store_tile(float* out, int ld, int row0, int col0,
                                           const float (&c)[4], int lane, int rows) {
  const int g = lane >> 2, t = lane & 3;
  const bool odd = t & 1;
  const float r0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
  const float r1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
  const int row = row0 + g + (odd ? 8 : 0);
  const int col = col0 + 2 * t - (odd ? 2 : 0);
  const float4 v = odd ? make_float4(r0, r1, c[2], c[3]) : make_float4(c[0], c[1], r0, r1);
  if (row < rows) __stcs(reinterpret_cast<float4*>(out + (size_t)row * ld + col), v);
}

// Starts the copies of chunk `blk` into the stage at shared address `s`;
// rows L..63 of x, b and c and entries L..63 of a are zero-filled.
__device__ __forceinline__ void load_chunk(uint32_t s, const Args& g, long long blk, int tid) {
  const int L = g.L;
  const char* xg = static_cast<const char*>(g.x) + blk * L * (kP * 2);
  const char* bg = static_cast<const char*>(g.b) + blk * L * (kN * 2);
  const char* cg = static_cast<const char*>(g.c) + blk * L * (kN * 2);
  const float* ag = static_cast<const float*>(g.a) + blk * L;
  for (int e = tid; e < kL * kXChunks; e += kThreads) {
    const int r = e / kXChunks, q = e % kXChunks;
    const bool in = r < L;
    cp_async16(s + swz(r, q, kXChunks), in ? xg + r * (kP * 2) + q * 16 : xg, in ? 16 : 0);
  }
  for (int e = tid; e < kL * kBChunks; e += kThreads) {
    const int r = e / kBChunks, q = e % kBChunks;
    const bool in = r < L;
    const int off = r * (kN * 2) + q * 16;
    cp_async16(s + kXBytes + swz(r, q, kBChunks), in ? bg + off : bg, in ? 16 : 0);
    cp_async16(s + kXBytes + kBBytes + swz(r, q, kBChunks), in ? cg + off : cg, in ? 16 : 0);
  }
  if (tid < kL) {
    const bool in = tid < L;
    cp_async4(s + kXBytes + 2 * kBBytes + tid * 4, in ? ag + tid : ag, in ? 4 : 0);
  }
}

__global__ void __launch_bounds__(kThreads, 2) ssd_chunk_mma(Args g) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  float* sacum = reinterpret_cast<float*>(smem + kAcumOffset);
  float* sw = sacum + kL;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;       // the fragment's row group and column pair
  const int L = g.L;

  const long long first = blockIdx.x * g.per_block;
  const long long last = first + g.per_block < g.chunks ? first + g.per_block : g.chunks;
  if (first >= last) return;

  // the ring: chunk first + k goes to stage k % kStages; one commit group a
  // chunk (empty past the last), so waiting for all but the newest
  // kStages - 1 groups is waiting for this chunk's copies
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (first + k < last) load_chunk(sbase + k * kStageBytes, g, first + k, tid);
    cp_async_commit();
  }
  for (long long blk = first; blk < last; ++blk) {
    const long long ahead = blk + kStages - 1;     // in flight while this chunk runs
    if (ahead < last)
      load_chunk(sbase + (int)((ahead - first) % kStages) * kStageBytes, g, ahead, tid);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();                               // this chunk's stage is in place
    const int stage = (int)((blk - first) % kStages);
    const uint32_t sx = sbase + stage * kStageBytes;
    const uint32_t sb = sx + kXBytes, sc = sb + kBBytes;
    const unsigned char* stage_ptr = smem + stage * kStageBytes;
    const float* sa = reinterpret_cast<const float*>(stage_ptr + kXBytes + 2 * kBBytes);

    // ---- a_cum = cumsum(a): warp 0, a shuffle scan per 32 steps plus a carry; w ----
    if (warp == 0) {
      float carry = 0.f;
#pragma unroll
      for (int base = 0; base < kL; base += 32) {
        float v = sa[base + lane];
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v += u;
        }
        v += carry;
        sacum[base + lane] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
      __syncwarp();
      const float last_cum = sacum[L - 1];
#pragma unroll
      for (int base = 0; base < kL; base += 32) {
        const int l = base + lane;
        sw[l] = l < L ? expf(last_cum - sacum[l]) : 0.f;
      }
    }
    __syncthreads();
    if (tid < L) g.acum[blk * L + tid] = sacum[tid];

    // ---- w o x, split into kParts bf16 tiles laid out as x ----
    for (int e = tid; e < kL * kXChunks; e += kThreads) {
      const int r = e / kXChunks;
      const uint32_t off = swz(r, e % kXChunks, kXChunks);
      const uint4 raw = *reinterpret_cast<const uint4*>(stage_ptr + off);
      const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float wl = sw[r];
      uint32_t parts[4][kParts];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(xv[k]);
        split(wl * f.x, wl * f.y, parts[k]);
      }
#pragma unroll
      for (int k = 0; k < kParts; ++k)
        *reinterpret_cast<uint4*>(smem + kWxOffset + k * kXBytes + off) =
            make_uint4(parts[0][k], parts[1][k], parts[2][k], parts[3][k]);
    }

    // ---- scores S = (C B^T) o decay for rows 16 rt .. +15, tiles on or below the diagonal ----
    const int rt = warp & 3, half = warp >> 2;
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kN / 16; ++ks) {
      uint32_t af[4];
      ldsm_x4(sc + swz(16 * rt + (lane & 15), 2 * ks + (lane >> 4), kBChunks), af);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np > rt) continue;
        uint32_t bf[4];
        ldsm_x4(sb + swz(16 * np + (lane & 7) + ((lane >> 4) << 3), 2 * ks + ((lane >> 3) & 1),
                         kBChunks),
                bf);
        mma16816(s[2 * np], af, bf[0], bf[1]);
        mma16816(s[2 * np + 1], af, bf[2], bf[3]);
      }
    }
    const int i0 = 16 * rt + gq, i1 = i0 + 8;
    const float ai0 = sacum[i0], ai1 = sacum[i1];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt / 2 > rt) continue;
      const int j = 8 * nt + 2 * tq;
      const float aj0 = sacum[j], aj1 = sacum[j + 1];
      s[nt][0] = (j <= i0 && i0 < L) ? s[nt][0] * expf(ai0 - aj0) : 0.f;
      s[nt][1] = (j + 1 <= i0 && i0 < L) ? s[nt][1] * expf(ai0 - aj1) : 0.f;
      s[nt][2] = (j <= i1 && i1 < L) ? s[nt][2] * expf(ai1 - aj0) : 0.f;
      s[nt][3] = (j + 1 <= i1 && i1 < L) ? s[nt][3] * expf(ai1 - aj1) : 0.f;
    }

    // ---- y_diag = S x, output columns 32 half .. +31; S is the A operand from registers ----
    float yacc[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[q][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk > rt) continue;
      uint32_t p0[kParts], p1[kParts], p2[kParts], p3[kParts];
      split(s[2 * kk][0], s[2 * kk][1], p0);
      split(s[2 * kk][2], s[2 * kk][3], p1);
      split(s[2 * kk + 1][0], s[2 * kk + 1][1], p2);
      split(s[2 * kk + 1][2], s[2 * kk + 1][3], p3);
#pragma unroll
      for (int pp = 0; pp < 2; ++pp) {
        uint32_t bx[4];
        ldsm_x4_t(sx + swz(16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8,
                           4 * half + 2 * pp + (lane >> 4), kXChunks),
                  bx);
#pragma unroll
        for (int k = 0; k < kParts; ++k) {
          const uint32_t af[4] = {p0[k], p1[k], p2[k], p3[k]};
          mma16816(yacc[2 * pp], af, bx[0], bx[1]);
          mma16816(yacc[2 * pp + 1], af, bx[2], bx[3]);
        }
      }
    }
    float* ychunk = g.y + blk * L * kP;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      store_tile(ychunk, kP, 16 * rt, 8 * (4 * half + q), yacc[q], lane, L);
    __syncthreads();                               // every part of w o x is in place

    // ---- state = b^T (w o x), state rows 16 warp .. +15 ----
    float sacc[8][4];
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[q][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kL / 16; ++ks) {
      uint32_t ab[4];
      ldsm_x4_t(sb + swz(16 * ks + (lane & 7) + ((lane >> 4) << 3),
                         2 * warp + ((lane >> 3) & 1), kBChunks),
                ab);
#pragma unroll
      for (int k = 0; k < kParts; ++k) {
        const uint32_t swx = sbase + kWxOffset + k * kXBytes;
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          uint32_t bw[4];
          ldsm_x4_t(swx + swz(16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8,
                              2 * pp + (lane >> 4), kXChunks),
                    bw);
          mma16816(sacc[2 * pp], ab, bw[0], bw[1]);
          mma16816(sacc[2 * pp + 1], ab, bw[2], bw[3]);
        }
      }
    }
    float* schunk = g.st + blk * kN * kP;
#pragma unroll
    for (int q = 0; q < 8; ++q) store_tile(schunk, kP, 16 * warp, 8 * q, sacc[q], lane, kN);
    __syncthreads();                               // the stage and w o x may be overwritten
  }
}

}  // namespace mma

constexpr int kMaxDevices = 64;

// Per device, for ssd_chunk_simt: the shared memory a block may opt in to
// (0 until read), and the dynamic shared memory the kernel is set to allow
// (0 until set).  Both are read once and raised only when a launch needs
// more, so a launch at a size already allowed makes no CUDA API call beyond
// cudaGetDevice.  For ssd_chunk_mma: the blocks of one wave (SMs times
// resident blocks an SM), 0 until its shared memory is opted in and the
// occupancy read.
std::atomic<int> g_optin[kMaxDevices];
std::atomic<int> g_allowed[kMaxDevices];
std::atomic<int> g_mma_wave[kMaxDevices];
std::mutex g_setup_mutex;

// Lets ssd_chunk_simt take `bytes` of dynamic shared memory on `dev`.
cudaError_t allow_smem(int dev, int bytes) {
  if (bytes <= g_allowed[dev].load(std::memory_order_acquire)) return cudaSuccess;
  std::lock_guard<std::mutex> lock(g_setup_mutex);
  if (bytes <= g_allowed[dev].load(std::memory_order_relaxed)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      simt::ssd_chunk_simt, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) g_allowed[dev].store(bytes, std::memory_order_release);
  return err;
}

// Opts ssd_chunk_mma in to its shared memory on `dev` (once) and sets *wave
// to the blocks of one full wave there.
cudaError_t mma_wave(int dev, int* wave) {
  *wave = g_mma_wave[dev].load(std::memory_order_acquire);
  if (*wave > 0) return cudaSuccess;
  std::lock_guard<std::mutex> lock(g_setup_mutex);
  *wave = g_mma_wave[dev].load(std::memory_order_relaxed);
  if (*wave > 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      mma::ssd_chunk_mma, cudaFuncAttributeMaxDynamicSharedMemorySize, mma::kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mma::ssd_chunk_mma,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mma::ssd_chunk_mma,
                                                        mma::kThreads, mma::kSmemBytes);
  if (err != cudaSuccess) return err;
  if (sms < 1 || per_sm < 1) return cudaErrorInvalidConfiguration;
  *wave = sms * per_sm;
  g_mma_wave[dev].store(*wave, std::memory_order_release);
  return cudaSuccess;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// x (chunks, L, p), a (chunks, L), b and c (chunks, L, n), contiguous, chunks
// being batch * heads * chunks a sequence; outputs y (chunks, L, p), st
// (chunks, n, p) and acum (chunks, L) in float32.  dtype codes: 0 = float32,
// 1 = bfloat16.  variant 0 runs ssd_chunk_simt; variant 1 runs ssd_chunk_mma
// and needs x, b, c bf16, a f32, p 64, n 128 and 16-byte aligned x, b, c, y
// and st (anything else is refused with cudaErrorInvalidValue).  Launches on
// `stream`.
extern "C" int repro_ssd_chunk(const void* x, const void* a, const void* b, const void* c,
                               void* y, void* st, void* acum, long long chunks, int L, int p,
                               int n, int x_dtype, int a_dtype, int b_dtype, int c_dtype,
                               int variant, void* stream) {
  if (chunks < 0 || chunks > 0x7fffffffLL || L < 1 || L > simt::kMaxL || p < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  if ((x_dtype | a_dtype | b_dtype | c_dtype) & ~1) return (int)cudaErrorInvalidValue;
  if (variant != 0 && variant != 1) return (int)cudaErrorInvalidValue;
  if (variant == 1 && (x_dtype != 1 || b_dtype != 1 || c_dtype != 1 || a_dtype != 0 ||
                       p != mma::kP || n != mma::kN || L > mma::kL || !aligned16(x) ||
                       !aligned16(b) || !aligned16(c) || !aligned16(y) || !aligned16(st)))
    return (int)cudaErrorInvalidValue;
  if (chunks == 0) return (int)cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  Args g{x, a, b, c, static_cast<float*>(y), static_cast<float*>(st),
         static_cast<float*>(acum), L, p, n, x_dtype, a_dtype, b_dtype, c_dtype, chunks, 1};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    int wave = 0;
    err = mma_wave(dev, &wave);
    if (err != cudaSuccess) return (int)err;
    g.per_block = (chunks + wave - 1) / wave;
    const long long grid = (chunks + g.per_block - 1) / g.per_block;
    mma::ssd_chunk_mma<<<(unsigned)grid, mma::kThreads, mma::kSmemBytes, s>>>(g);
    return (int)cudaGetLastError();
  }
  const size_t bytes = simt::smem_floats(L, p, n) * sizeof(float);
  int optin = g_optin[dev].load(std::memory_order_relaxed);
  if (optin == 0) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    g_optin[dev].store(optin, std::memory_order_relaxed);
  }
  if (bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  err = allow_smem(dev, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  simt::ssd_chunk_simt<<<(unsigned)chunks, simt::kThreads, bytes, s>>>(g);
  return (int)cudaGetLastError();
}
