// Phase-I LOD window kernels for NVIDIA Hopper (sm_90a), bound to Python
// through a plain C interface (ctypes; see ops/_build.py and
// ops/cuda_lod.py, which also hold the plain PyTorch versions).
//
// K1 gt_lod_windows replaces the Pallas TPU kernel
//    garlic_tpu/ops/pallas_lod.py:93  _lod_windows_pallas_padded
//    win[i, l] = sum_{k<W} T[g[i, l+k], l+k]  (missing genotype adds 0),
//    written as f32 [I, nwin], MISSING where the window mask is set.
// K2 gt_covered replaces the Pallas TPU kernel
//    garlic_tpu/ops/pallas_lod.py:291 _covered_pallas_padded
//    the same window sums, never written to memory, turned into
//    above = win >= cutoff & live, susw = |win - cutoff| < delta & live
//    ([I, nwin] u8 each) and covered[i, s] = count >= thr ([I, L] u8),
//    count = sum of above over window starts [s - W + 1, s].
// K3 gt_window_sums replaces the Pallas TPU kernel
//    garlic_tpu/ops/pallas_lod.py:175 _window_sums_pallas_padded
//    K1 over a precomputed f32 term plane a[I, L] (TGLS: per-genotype
//    error terms, built by cuda_lod.gl_terms_f32).
// K4 gt_covered_terms replaces the Pallas TPU kernel
//    garlic_tpu/ops/pallas_lod.py:402 _covered_terms_pallas_padded
//    K2 over the same term plane.
//
// Two kernel bodies, lod_windows_kernel (K1, K3) and covered_kernel (K2,
// K4), each a template over a term loader: PackedTerms (2-bit genotype
// codes packed 4 per byte, little-endian lanes, code 3 = missing, the
// layout of pallas_lod.pack_genotypes, plus the f32 LOD table [3, L] of
// genotype classes 0/1/2) or PlaneTerms (one f32 row of the term plane).
// Every kernel also reads the window-missing mask [nwin] u8;
// nwin = L - W + 1 >= 1.  Columns outside [0, L) add 0 in both loaders.
//
// Bound on the card.  Every window is a fresh chain of W f32 adds, so a
// launch does I * nwin * W adds: 6.0e9 at 200 x 500,000, W=60, which at
// 128 f32 adds per clock on each of the 132 SMs is 0.18 ms at 1.98 GHz.
// The bytes are fewer: K1 reads 1/4 B of codes per genotype and writes
// 4 B per window (0.13 ms at 3.35 TB/s), K2 writes 3 B per SNP
// (0.10 ms); K3/K4 read the 4 B term plane as well (0.24 / 0.21 ms).  So
// K1/K2 are bound by the adds, K3/K4 by device memory about as much.
// An add issues at the rate the four schedulers of an SM issue any
// instruction, so the design keeps every other instruction rare per add:
//
// * Register blocking.  A thread owns R consecutive window starts (kR1 =
//   29 in K1/K3, kR = 15 in K2/K4, whose flags take registers too) and
//   keeps one accumulator per start.  It streams the W + R - 1 terms
//   they read from shared memory once, adding each term to every window
//   that holds it (chain(), below): at W=60 one shared load per 19.8
//   adds in K1 (88 loads for 29 windows) and per 12.2 in K2, instead of
//   one per add.
// * Bank conflicts.  Lane t reads word t * R + m at step m; R is odd,
//   so the 32 lanes of a warp hit 32 distinct banks.
// * Tiles and grid.  A K1 tile is kStarts1 = 128 * 29 = 3712 window
//   starts of one row (its W - 1 extra terms are loads, not adds); a K2
//   block pass covers kStarts = 256 * 15 = 3840 starts (its tile of
//   3840 - (W - 1) SNPs recomputes W - 1 halo windows: 1.6% at W=60,
//   against 5.8% with the 1024-SNP tiles before).  A launch has one block per
//   resident block slot (shared memory sets how many blocks an SM holds),
//   and block b takes the b-th of gridDim.x equal shares of the
//   (column tile, row) items in column-major order (Items), so every block
//   runs the whole launch and the last wave is never partial; a block
//   stages a column tile's table once and keeps it over its rows.
// * Inputs.  The next item's code bytes (or K3/K4's term row) are copied
//   into shared memory with cp.async (16-byte copies for the codes) while
//   the current item's chains run.
// * Decode.  A thread turns one code byte into four terms per step and
//   stores them as one float4; the staged table keeps the four columns of
//   a byte in four quarters of its row, so the lanes' table loads hit 32
//   distinct banks, and no column is tested (PackedTerms::decode).
// * Stores.  Each thread writes K1's sums into shared memory at an offset
//   that aligns the tile with its row in device memory, and one thread
//   hands the aligned body to the TMA unit as one bulk copy, which
//   streams it out while the block decodes its next item; K2's flags go
//   to device memory as 16-byte words (16 flags spread from two bit
//   masks), its coverage as 4-byte words.  A row's unaligned head and
//   tail are stored as scalars.
// * K2's count.  count[q] = P[q + W] - P[q] over an exact integer block
//   prefix P of the above flags (one barrier per pass), compared with the
//   threshold as an integer: two loads per SNP, exact in any order.
// * Registers.  The packed loader's bodies ask for kMinBlocks = 3 blocks
//   per SM, what their shared memory allows at W = 60 (12 warps of K1,
//   24 of K2); ptxas gives K1 72 registers and K2 80, with no spills
//   (chip_smoke.py phase 1 prints its report).
//
// What binds them (chip_smoke.py phase 2 prints each time beside its
// bound, the times at W = 1, 60 and 120, the time fill_ takes to write
// the same outputs, and the resident warps per SM): from W = 60 to
// W = 120 each time grows by about what the added adds take at the add
// rate, so the chains run near that rate.  The work that does not grow
// with W (the time at W = 1: the decode, K1's sums through shared
// memory, K2's flags, prefix and byte stores, each item's barriers) is
// most of the time at W = 60, and is about twice what writing the
// outputs alone takes: it is latency that 12 (K1) or 24 (K2) resident
// warps per SM do not hide, and it hides little under the chains; warps
// that ran their strips with no block barrier at all, and a decode
// loop unrolled 2 or 4 times, were no faster.
//
// Numerics.  Each window's sum is a left-to-right chain of W f32 adds
// starting from 0.0f, the order of the JAX kernels' unrolled W <= 64 path
// (pallas_lod.py:72-76): register blocking changes which thread adds, not
// the order of any window's adds.  With the same f32 terms the sums are
// bit-identical to interpret-mode Pallas for W <= 64, K1 and K2 (and K3
// and K4) agree bit for bit at every W, and K3 equals K1 and K4 equals K2
// whenever the plane holds K1's terms.  The chains hold only adds, so
// nvcc's FMA contraction cannot change their rounding.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

namespace {

// K2 / K4's block: kThreads threads of kR window starts each (kR odd)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kR = 15;
constexpr int kStarts = kThreads * kR;   // window starts per block pass
// K1 / K3's block: fewer threads of more window starts each, which cuts
// the chains' shared loads per add; K2's flags and counts would need more
// registers per thread, and run slower so
constexpr int kThreads1 = 128;
constexpr int kR1 = 29;
constexpr int kStarts1 = kThreads1 * kR1;
static_assert(kR >= 15 && kR < 32, "flag_bits reads 16 flags from two masks");
constexpr float kMissing = -9999.0f;     // garlic_tpu_torch.core.types.MISSING

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Floats per row of the staged table: a multiple of 128, so that its four
// quarters (below) start on bank 0.
__host__ __device__ constexpr int table_stride(int nterm) {
  return round_up(nterm + 3, 128);
}

// Asynchronous 4-byte copy from device to shared memory (cp.async): the
// next row's inputs land in shared memory while this row's chains run.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Bulk copy from shared to device memory by the TMA unit (Hopper): one
// thread hands it `bytes` (a multiple of 16, both addresses 16-byte
// aligned) and the block goes on while it streams them out.  The block's
// generic writes to the source must be made visible to the unit first
// (fence_async_shared by each writer, then a barrier), and the source
// stays untouched until bulk_wait_read.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(src);
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(s), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the unit has read every source handed to it by this thread
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// ... and written every destination
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// A term loader fetches row i's inputs for columns [c0, c0 + n) into a
// raw buffer (asynchronously) and turns them into f32 terms, 0 outside
// [0, L).  raw_floats(nterm): floats of one raw buffer, 0 when the raw
// buffer is the terms buffer itself.

// K1/K2 terms: the table entry of the genotype class at (row i, column c).
// The raw buffer holds the row's code bytes, fetched as aligned 16-byte
// words; decode() maps them through the table's columns, staged in
// shared memory once per column tile a block takes.
struct PackedTerms {
  static constexpr int kRows = 3;  // table rows staged in shared memory
  static constexpr bool kDecodes = true;
  // blocks per SM the kernels' registers must allow: the 3 that their
  // shared memory allows at W = 60 (left to itself, ptxas picks 64
  // registers, for 4 blocks, and K1/K2 run slower)
  static constexpr int kMinBlocks = 3;
  const uint8_t* packed;           // [I, Lq]
  const float* table;              // [3, L]
  int I, L, Lq;

  __host__ __device__ static int raw_floats(int nterm) {
    return round_up(nterm / 4 + 32, 16) / 4;
  }

  // The terms buffer starts at column c0 - shift(c0), a multiple of 4, so
  // that each code byte decodes into one aligned float4.
  __host__ __device__ static int shift(int c0) { return c0 & 3; }

  // Table columns [cb, cb + round_up(n + shift(c0), 4)) into tab[3][ts],
  // cb = c0 - shift(c0) (every column of the tile's code bytes),
  // asynchronously (it lands with the next row's fetch), 0 outside [0, L).
  // Row k holds column cb + 4 b + q at k * ts + q * ts / 4 + b: the four
  // columns of code byte b lie in four quarters, so a warp's lanes, one
  // byte each, read 32 distinct banks.
  template <int NT>  // the block's threads
  __device__ __forceinline__ void stage(int c0, int n, float* tab,
                                        int ts) const {
    const int d = shift(c0), cb = c0 - d, m = round_up(n + d, 4);
    for (int k = 0; k < kRows; ++k)
      for (int j = threadIdx.x; j < m; j += NT) {
        const int c = cb + j;
        float* dst = tab + k * ts + (j & 3) * (ts >> 2) + (j >> 2);
        if (c >= 0 && c < L) {
          cp_async4(dst, table + (size_t)k * L + c);
        } else {
          *dst = 0.0f;
        }
      }
  }

  // The 16-byte words holding row i's bytes of columns [a, e): the first
  // word's address and the offset of column a's byte in it.  A word that
  // starts before the row lies in the tensor's allocation (whose start is
  // 16-byte aligned) and its bytes before the row are never decoded.
  __device__ __forceinline__ const uint8_t* words(int i, int a,
                                                  int* off) const {
    const uint8_t* first = packed + (size_t)i * Lq + (a >> 2);
    *off = (int)((uintptr_t)first & 15);
    return first - *off;
  }

  template <int NT>
  __device__ __forceinline__ void fetch(int i, int c0, int n,
                                        float* rawf) const {
    const int a = max(c0, 0), e = min(c0 + n, L);
    if (a >= e) return;
    uint8_t* raw = reinterpret_cast<uint8_t*>(rawf);
    int off;
    const uint8_t* w0 = words(i, a, &off);
    const uint8_t* end = packed + (size_t)I * Lq;  // the codes' last byte + 1
    const int nw = (off + ((e - 1) >> 2) - (a >> 2) + 1 + 15) >> 4;
    for (int k = threadIdx.x; k < nw; k += NT) {
      const uint8_t* src = w0 + 16 * k;
      if (src + 16 <= end) {
        cp_async16(raw + 16 * k, src);
      } else {  // the tensor's last, partial word
        for (int q = 0; q < 16 && src + q < end; ++q) raw[16 * k + q] = src[q];
      }
    }
  }

  // Terms of columns [cb, cb + n + shift(c0)) of row i into s[0, ...),
  // one code byte (four columns) per thread and step, as a float4; a
  // missing genotype (code 3) stores 0.  tab is the staged table, or null
  // when it did not fit in shared memory (then the terms are gathered from
  // the table in device memory).  With the table staged, a column outside
  // [0, L) reads the staged 0 whatever its code, and a column outside
  // [c0, c0 + n) inside [0, L) (at most 3 on each side, in the tile's end
  // bytes) stores its own row's term, which only window starts outside
  // the tile read; so the staged path tests no column, and clamps only
  // the bytes left of column a (K2's first tile) to a's.  Bytes right of
  // the fetched ones lie in the same raw buffer (raw_floats) and hold
  // stale codes.  The unstaged path stores 0 outside
  // [c0, c0 + n).
  template <int NT>
  __device__ __forceinline__ void decode(int i, int c0, int n,
                                         const float* rawf, const float* tab,
                                         int ts, float* s) const {
    const uint8_t* raw = reinterpret_cast<const uint8_t*>(rawf);
    const int a = max(c0, 0), e = min(c0 + n, L);
    int off;
    words(i, a, &off);
    const int base = off - (a >> 2);  // raw index of column c: base + c / 4
    const int blo = a >> 2, bhi = (e - 1) >> 2;  // the fetched bytes
    const int d = shift(c0), cb = c0 - d;
    const int nb = (n + d + 3) >> 2;  // code bytes of the tile
    float4* s4 = reinterpret_cast<float4*>(s);
    if (tab != nullptr) {
      // m = code << 2q, so code * ts = m * (ts >> 2q) (ts is a multiple
      // of 128) and class min(code, 2) is row min(m, 2 << 2q) / (1 << 2q)
      const int q4 = ts >> 2;
      const int first = base + (cb >> 2);  // raw index of byte 0
#pragma unroll 1
      for (int b = threadIdx.x; b < nb; b += NT) {
        const uint32_t byte = raw[max(first + b, off)];
        const float* tb = tab + b;
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t m = byte & (3u << (2 * q));
          const float x = tb[q * q4 + min(m, 2u << (2 * q)) *
                                          (uint32_t)(ts >> (2 * q))];
          v[q] = m == (3u << (2 * q)) ? 0.0f : x;
        }
        s4[b] = make_float4(v[0], v[1], v[2], v[3]);
      }
      return;
    }
    for (int b = threadIdx.x; b < nb; b += NT) {
      const int c = cb + 4 * b;  // the byte's first column
      const uint32_t byte = raw[base + min(max(c >> 2, blo), bhi)];
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int code = min((int)(byte >> (2 * q)) & 3, 2);
        const float x = table[(size_t)code * L + min(max(c + q, 0), L - 1)];
        v[q] = c + q >= a && c + q < e && ((byte >> (2 * q)) & 3) != 3
                   ? x : 0.0f;
      }
      s4[b] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
};

// K3/K4 terms: one entry of the f32 term plane [I, L], fetched straight
// into the terms buffer (two buffers, alternating by row).
struct PlaneTerms {
  static constexpr int kRows = 0;
  static constexpr bool kDecodes = false;
  static constexpr int kMinBlocks = 4;  // K3/K4 fit in 64 registers
  const float* terms;
  int L;

  __host__ __device__ static int shift(int) { return 0; }

  __host__ __device__ static int raw_floats(int) { return 0; }

  template <int NT>
  __device__ __forceinline__ void stage(int, int, float*, int) const {}

  template <int NT>
  __device__ __forceinline__ void fetch(int i, int c0, int n,
                                        float* s) const {
    const float* p = terms + (size_t)i * L;
    for (int j = threadIdx.x; j < n; j += NT) {
      const int c = c0 + j;
      if (c >= 0 && c < L) {
        cp_async4(s + j, p + c);
      } else {
        s[j] = 0.0f;
      }
    }
  }

  template <int NT>
  __device__ __forceinline__ void decode(int, int, int, const float*,
                                         const float*, int, float*) const {}
};

// The R window sums starting at s[0], s[1], ... s[R - 1]: for each
// window, W f32 adds of its terms, left to right, from 0.0f.  Term m
// belongs to windows r with 0 <= m - r < W; the three loops below are the
// terms that reach only the first windows (ramp-up), all windows, and only
// the last windows (ramp-down), so each window still sees its terms in
// order.  For W < R - 1 a larger R splits into chains of 15 and R - 15
// windows, and R <= 15 takes the plain loop.
template <int R>
__device__ __forceinline__ void chain(const float* s, int W, float (&acc)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;
  if (W >= R - 1) {
#pragma unroll
    for (int m = 0; m < R - 1; ++m) {
      const float t = s[m];
#pragma unroll
      for (int r = 0; r <= m; ++r) acc[r] += t;
    }
#pragma unroll 8
    for (int m = R - 1; m < W; ++m) {
      const float t = s[m];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] += t;
    }
#pragma unroll
    for (int d = 0; d < R - 1; ++d) {
      const float t = s[W + d];
#pragma unroll
      for (int r = d + 1; r < R; ++r) acc[r] += t;
    }
  } else if constexpr (R > 15) {
    float lo[15], hi[R - 15];
    chain<15>(s, W, lo);
    chain<R - 15>(s + 15, W, hi);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = r < 15 ? lo[r] : hi[r - 15];
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r)
      for (int k = 0; k < W; ++k) acc[r] += s[r + k];
  }
}

// dst[0, n) = src[0, n), src in shared memory at the same offset modulo
// 16 bytes as dst: the threads store the unaligned head and tail (< 4
// floats each), thread 0 hands the aligned body to the TMA unit.
template <int NT>
__device__ __forceinline__ void store_f32(float* dst, const float* src,
                                          int n) {
  const int head = min(n, (int)((4 - (((uintptr_t)dst >> 2) & 3)) & 3));
  const int body = (n - head) & ~3;
  if ((int)threadIdx.x < head) dst[threadIdx.x] = src[threadIdx.x];
  const int t = head + body + threadIdx.x;
  if (t < n) dst[t] = src[t];
  if (threadIdx.x == 0 && body > 0)
    bulk_store(dst + head, src + head, 4 * body);
}

// thr as a bound on an integer count c <= 65535: c >= thr exactly when
// c >= count_bound(thr); a NaN thr covers nothing.
__device__ __forceinline__ int count_bound(float thr) {
  return thr <= 0.0f ? 0 : thr <= 65536.0f ? (int)ceilf(thr) : 65537;
}

// Bits 0-3 of b as bytes 0-3 of a little-endian word (the four shifted
// copies of b do not overlap).
__device__ __forceinline__ uint32_t spread4(uint32_t b) {
  return (b & 15u) * 0x00204081u & 0x01010101u;
}

// Bits 0-15 of b as the 16 bytes of a uint4.
__device__ __forceinline__ uint4 spread16(uint32_t b) {
  return make_uint4(spread4(b), spread4(b >> 4), spread4(b >> 8),
                    spread4(b >> 12));
}

// covered[q] = P[q + W] - P[q] >= thr (ithr = count_bound(thr)).
__device__ __forceinline__ uint32_t cov_byte(const uint16_t* P, int q, int W,
                                             int ithr) {
  return P[q + W] - P[q] >= ithr;
}

// dst[q] = covered[q] for q < n, the aligned body as 4-byte words (lane
// k of a warp reads P at 8-byte steps: 16-byte words would read them at
// 32-byte steps, an 8-way bank conflict).
__device__ __forceinline__ void store_cov(uint8_t* dst, const uint16_t* P,
                                          int W, int ithr, int n) {
  const int head = min(n, (int)((4 - ((uintptr_t)dst & 3)) & 3));
  for (int q = threadIdx.x; q < head; q += kThreads)
    dst[q] = cov_byte(P, q, W, ithr);
  const int nv = (n - head) >> 2;
  uint32_t* d4 = reinterpret_cast<uint32_t*>(dst + head);
  for (int k = threadIdx.x; k < nv; k += kThreads) {
    const int q = head + 4 * k;
    d4[k] = cov_byte(P, q, W, ithr) | cov_byte(P, q + 1, W, ithr) << 8 |
            cov_byte(P, q + 2, W, ithr) << 16 |
            cov_byte(P, q + 3, W, ithr) << 24;
  }
  for (int q = head + 4 * nv + threadIdx.x; q < n; q += kThreads)
    dst[q] = cov_byte(P, q, W, ithr);
}

// Exclusive prefix of v over the block's threads, in thread order; total
// gets the block's sum.  One barrier: every warp reads all kWarps warp
// sums from wsum (kWarps ints of shared memory), so two calls in a row
// must use two wsum arrays; a call may reuse the array of the call before
// the last, whose reads the last call's barrier has closed.
__device__ __forceinline__ int block_scan(int v, int* wsum, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int y = wsum[w];
    before += w < warp ? y : 0;
    total += y;
  }
  return before + x - v;
}

// Shared memory of the two bodies, in 4-byte units: the terms buffers
// (one when the loader decodes from a raw buffer, else two), the staged
// table, two raw buffers, then K2's own arrays.
template <class Terms>
size_t stage_floats(int nterm, bool staged) {
  return (size_t)(Terms::kDecodes ? 1 : 2) * round_up(nterm + 3, 4) +
         (staged ? (size_t)Terms::kRows * table_stride(nterm) : 0) +
         2 * (size_t)Terms::raw_floats(nterm);
}

template <class Terms>
size_t lod_windows_smem(int W, bool staged) {
  return 4 * stage_floats<Terms>(kStarts1 + W - 1, staged);
}

template <class Terms>
size_t covered_smem(int W, int npass, bool staged) {
  const int span = npass * kStarts;
  return 4 * (stage_floats<Terms>(span + W - 1, staged) +
              3 * ((size_t)npass * kThreads + 1) + 2 * kWarps);
}

// The shared-memory stage of either body: terms buffers, table, raw
// buffers (see stage_floats).
struct Stage {
  float* s[2];    // the terms of even / odd rows
  float* tab;     // the staged table, or null
  float* raw[2];  // the raw buffers of even / odd rows
  float* end;     // the first float after the stage
};

template <class Terms>
__device__ __forceinline__ Stage stage_layout(float* smem, int nterm,
                                              bool staged) {
  const int tb = round_up(nterm + 3, 4);
  const int rf = Terms::raw_floats(nterm);
  Stage st;
  st.s[0] = smem;
  st.s[1] = Terms::kDecodes ? smem : smem + tb;
  float* t = smem + (Terms::kDecodes ? 1 : 2) * tb;
  st.tab = staged && Terms::kRows ? t : nullptr;
  st.raw[0] = t + (staged ? Terms::kRows * table_stride(nterm) : 0);
  st.raw[1] = st.raw[0] + rf;
  st.end = st.raw[1] + rf;
  return st;
}

// Item k of a block's items, row i of the tile of columns [c0, c0 + n):
// wait for its fetch, start the fetch of the next item (row `next` of the
// tile [nc0, nc0 + nn); none when next < 0), and return the item's terms
// (decoded into the terms buffer by a decoding loader).
template <int NT, class Terms>
__device__ __forceinline__ float* next_terms(const Terms& t, const Stage& st,
                                             int k, int i, int c0, int n,
                                             int next, int nc0, int nn,
                                             int ts) {
  // constant indices and selects keep the buffer pointers in registers
  const bool odd = k & 1;
  float* s = odd ? st.s[1] : st.s[0];
  float* raw = odd ? st.raw[1] : st.raw[0];
  float* later = Terms::kDecodes ? (odd ? st.raw[0] : st.raw[1])
                                 : (odd ? st.s[0] : st.s[1]);
  cp_async_wait_all();
  if (threadIdx.x == 0) bulk_wait_read();  // item k - 1's sums are out
  __syncthreads();  // item k has landed; the buffers of item k - 1 are free
  if (next >= 0) t.template fetch<NT>(next, nc0, nn, later);
  cp_async_commit();
  if (Terms::kDecodes) {
    t.template decode<NT>(i, c0, n, raw, st.tab, ts, s);
    __syncthreads();
  }
  return s;
}

// A block's items: the launch's (column tile, row) pairs in column-major
// order, item x * I + i, split into gridDim.x ranges whose lengths differ
// by at most one, so that every block gets the same work and keeps a
// column tile's staged table over its consecutive rows.  next() steps to
// the following item.  ncols * I < 2^31 (the launchers check it).
struct Items {
  int x, i, left;  // the current item's tile and row; items left after it
  __device__ Items(int ncols, int I) {
    const int items = ncols * I, b = blockIdx.x;
    const int q = items / (int)gridDim.x, rem = items % (int)gridDim.x;
    const int lo = b * q + min(b, rem);
    x = lo / I;
    i = lo - x * I;
    left = q + (b < rem) - 1;
  }
  __device__ __forceinline__ void next(int I) {
    --left;
    if (++i == I) i = 0, ++x;
  }
  // the item after this one, as (tile, row); row -1 when there is none
  __device__ __forceinline__ int after(int I, int* nx) const {
    *nx = i + 1 == I ? x + 1 : x;
    return left > 0 ? (i + 1 == I ? 0 : i + 1) : -1;
  }
};

// Bit r (r < R) of the result: miss[w + r] != 0 for r in [lo_r, hi_r),
// else `outside`.  The R loads are independent and all issued before use.
template <int R>
__device__ __forceinline__ uint32_t mask_bits(const uint8_t* miss, int w,
                                              int lo_r, int hi_r,
                                              int outside) {
  uint8_t m[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    m[r] = (r >= lo_r && r < hi_r) ? miss[w + r] : (uint8_t)outside;
  uint32_t bits = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) bits |= (uint32_t)(m[r] != 0) << r;
  return bits;
}

// Flags j .. j + 15 as bits 0-15, from per-thread bit masks: bit r of
// M[t] is flag t * kR + r (r < kR), so two entries hold the 16 flags.  M
// holds one zero entry past the last thread's.
__device__ __forceinline__ uint32_t flag_bits(const uint32_t* M, int j) {
  const int t = j / kR, r = j - t * kR;
  return (M[t] >> r) | (M[t + 1] << (kR - r));
}

// dst[q] = flag j + q for q < n: flag bytes from masks M, the aligned body
// as 16-byte words.
__device__ __forceinline__ void store_flags(uint8_t* dst, const uint32_t* M,
                                            int j, int n) {
  const int head = min(n, (int)((16 - ((uintptr_t)dst & 15)) & 15));
  for (int q = threadIdx.x; q < head; q += kThreads)
    dst[q] = (uint8_t)(flag_bits(M, j + q) & 1u);
  const int nv = (n - head) >> 4;
  uint4* d16 = reinterpret_cast<uint4*>(dst + head);
  for (int k = threadIdx.x; k < nv; k += kThreads)
    d16[k] = spread16(flag_bits(M, j + head + 16 * k));
  for (int q = head + 16 * nv + threadIdx.x; q < n; q += kThreads)
    dst[q] = (uint8_t)(flag_bits(M, j + q) & 1u);
}

// K1 / K3.  Column tile x: window starts [x * kStarts1, + kStarts1).
template <class Terms>
__global__ void __launch_bounds__(kThreads1, Terms::kMinBlocks)
lod_windows_kernel(Terms t, const uint8_t* __restrict__ miss,
                   float* __restrict__ out, int I, int W, int nwin,
                   bool staged) {
  extern __shared__ __align__(16) float smem[];
  const int nterm = kStarts1 + W - 1;
  const int ts = table_stride(nterm);
  const Stage st = stage_layout<Terms>(smem, nterm, staged);
  const int ncols = (nwin + kStarts1 - 1) / kStarts1;
  const int j0 = threadIdx.x * kR1;  // this thread's first window start
  Items it(ncols, I);
  if (it.left < 0) return;
  // terms of tile x
  auto nterms = [&](int x) {
    return min(kStarts1, nwin - x * kStarts1) + W - 1;
  };
  t.template fetch<kThreads1>(it.i, it.x * kStarts1, nterms(it.x),
                              Terms::kDecodes ? st.raw[0] : st.s[0]);
  cp_async_commit();
  int col = -1, col0 = 0, ncol = 0;
  uint32_t dead = 0;
  for (int k = 0; it.left >= 0; ++k, it.next(I)) {
    if (it.x != col) {  // a new column tile
      col = it.x;
      col0 = col * kStarts1;
      ncol = min(kStarts1, nwin - col0);
      dead = mask_bits<kR1>(miss, col0 + j0, 0, ncol - j0, 0);
      if (st.tab != nullptr)
        t.template stage<kThreads1>(col0, ncol + W - 1, st.tab, ts);
      cp_async_commit();  // next_terms waits for committed groups only
    }
    int nx;
    const int next = it.after(I, &nx);
    float* s = next_terms<kThreads1>(t, st, k, it.i, col0, ncol + W - 1,
                                     next, nx * kStarts1,
                                     next >= 0 ? nterms(nx) : 0, ts);
    float acc[kR1];
    if (j0 < ncol) chain<kR1>(s + Terms::shift(col0) + j0, W, acc);
    __syncthreads();  // every chain has read its terms: s takes the sums
    float* orow = out + (size_t)it.i * nwin + col0;
    float* o = s + (((uintptr_t)orow >> 2) & 3);  // orow's 16-byte phase
    if (j0 + kR1 <= ncol && dead == 0) {  // most threads: no test per sum
#pragma unroll
      for (int r = 0; r < kR1; ++r) o[j0 + r] = acc[r];
    } else if (j0 < ncol) {
#pragma unroll
      for (int r = 0; r < kR1; ++r)
        if (j0 + r < ncol) o[j0 + r] = (dead >> r) & 1 ? kMissing : acc[r];
    }
    fence_async_shared();
    __syncthreads();
    store_f32<kThreads1>(orow, o, ncol);
  }
  if (threadIdx.x == 0) bulk_wait_all();
}

// K2 / K4.  Column tile x: SNPs [x * tile, + tile), tile = npass *
// kStarts - (W - 1): the block computes the W - 1 window starts left of
// its SNPs as well, in npass passes of kStarts starts.
template <class Terms>
__global__ void __launch_bounds__(kThreads, Terms::kMinBlocks)
covered_kernel(Terms t, const uint8_t* __restrict__ miss,
               uint8_t* __restrict__ cov, uint8_t* __restrict__ susw,
               uint8_t* __restrict__ above, int I, int L, int W, int nwin,
               int npass, bool staged, float cutoff, float thr,
               float delta) {
  extern __shared__ __align__(16) float smem[];
  const int span = npass * kStarts;
  const int tile = span - (W - 1);
  const int nterm = span + W - 1;
  const int ts = table_stride(nterm);
  const int nmask = npass * kThreads + 1;  // one zero entry past the last
  const Stage st = stage_layout<Terms>(smem, nterm, staged);
  uint32_t* live = reinterpret_cast<uint32_t*>(st.end);  // live starts
  uint32_t* ma = live + nmask;                           // above flags
  uint32_t* ms = ma + nmask;                             // suspect flags
  int* wsum = reinterpret_cast<int*>(ms + nmask);        // 2 x kWarps
  const int ithr = count_bound(thr);
  const int ncols = (L + tile - 1) / tile;
  Items it(ncols, I);
  if (it.left < 0) return;
  if (threadIdx.x == 0) ma[nmask - 1] = ms[nmask - 1] = 0;
  // tile x: window starts [x * tile - (W - 1), + nst), terms nst + W - 1
  auto nterms = [&](int x) { return min(tile, L - x * tile) + 2 * (W - 1); };
  t.template fetch<kThreads>(it.i, it.x * tile - (W - 1), nterms(it.x),
                             Terms::kDecodes ? st.raw[0] : st.s[0]);
  cp_async_commit();
  int col = -1, s0 = 0, nsnp = 0, st0 = 0, nst = 0, nown = 0;
  for (int k = 0; it.left >= 0; ++k, it.next(I)) {
    if (it.x != col) {  // a new column tile
      col = it.x;
      s0 = col * tile;                // first SNP of the tile
      nsnp = min(tile, L - s0);
      st0 = s0 - (W - 1);             // first window start it needs
      nst = nsnp + W - 1;             // window starts [st0, st0 + nst)
      nown = max(0, min(nsnp, nwin - s0));  // starts >= s0
      if (st.tab != nullptr)
        t.template stage<kThreads>(st0, nst + W - 1, st.tab, ts);
      cp_async_commit();  // next_terms waits for committed groups only
      for (int p = 0; p < npass; ++p) {  // bit r: start j0 + r is live
        const int j0 = p * kStarts + threadIdx.x * kR;
        const int w = st0 + j0;
        const uint32_t masked = mask_bits<kR>(miss, w, max(0, -w),
                                          min(nst - j0, nwin - w), 1);
        live[p * kThreads + threadIdx.x] = ~masked & ((1u << kR) - 1);
      }
    }
    int nx;
    const int next = it.after(I, &nx);
    float* s = next_terms<kThreads>(t, st, k, it.i, st0, nst + W - 1, next,
                          nx * tile - (W - 1), next >= 0 ? nterms(nx) : 0,
                          ts);
    for (int p = 0; p < npass; ++p) {
      const int j0 = p * kStarts + threadIdx.x * kR;
      uint32_t a = 0, sw = 0;
      if (j0 < nst) {
        float acc[kR];
        chain<kR>(s + Terms::shift(st0) + j0, W, acc);
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          a |= (uint32_t)(acc[r] >= cutoff) << r;
          sw |= (uint32_t)(fabsf(acc[r] - cutoff) < delta) << r;
        }
        const uint32_t lv = live[p * kThreads + threadIdx.x];
        a &= lv;
        sw &= lv;
      }
      ma[p * kThreads + threadIdx.x] = a;
      ms[p * kThreads + threadIdx.x] = sw;
    }
    __syncthreads();  // the terms are dead: s holds the prefix from here
    uint16_t* P = reinterpret_cast<uint16_t*>(s);  // P[j]: flags in [0, j)
    int carry = 0;
    for (int p = 0; p < npass; ++p) {
      const int j0 = p * kStarts + threadIdx.x * kR;
      const uint32_t a = ma[p * kThreads + threadIdx.x];
      int total;
      int run = carry + block_scan(__popc(a), wsum + (p & 1) * kWarps, total);
      if (j0 + kR <= nst) {  // most threads: no test per start
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          run += (a >> r) & 1u;
          P[j0 + r + 1] = (uint16_t)run;
        }
      } else {
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          run += (a >> r) & 1u;
          if (j0 + r < nst) P[j0 + r + 1] = (uint16_t)run;
        }
      }
      carry += total;
    }
    if (threadIdx.x == 0) P[0] = 0;
    __syncthreads();
    store_flags(above + (size_t)it.i * nwin + s0, ma, W - 1, nown);
    store_flags(susw + (size_t)it.i * nwin + s0, ms, W - 1, nown);
    store_cov(cov + (size_t)it.i * L + s0, P, W, ithr, nsnp);
  }
}

// Dynamic shared memory above the 48 KB default needs an opt-in; the
// carveout asks for the largest shared-memory share of the SM's 256 KB,
// so that as many blocks as the shared memory allows are resident.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess || bytes <= 48 * 1024) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The largest dynamic shared memory a block may opt into on `device`.
cudaError_t smem_limit(int device, size_t* bytes) {
  int v = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  *bytes = (size_t)v;
  return e;
}

// Resident blocks per SM of `kernel` with `smem` bytes of shared memory
// (the occupancy the card allows, not a measured one).
template <typename K>
cudaError_t per_sm(K kernel, int threads, size_t smem, int* blocks) {
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, threads, smem);
  if (e == cudaSuccess && *blocks < 1) return cudaErrorInvalidConfiguration;
  return e;
}

// Blocks of a launch of `items` (column tile, row) items: one per
// resident block slot, so that every block runs from start to end at once
// and the balanced shares (Items) finish together.
template <typename K>
cudaError_t grid_blocks(int device, K kernel, int threads, size_t smem,
                        long items, int* blocks) {
  int sms = 0, n = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) e = per_sm(kernel, threads, smem, &n);
  if (e != cudaSuccess) return e;
  *blocks = (int)std::min<long>(items, (long)sms * n);
  return cudaSuccess;
}

// A launch's shared memory: `want` bytes with the table staged when they
// fit under the device's opt-in limit, else `fallback` bytes (unstaged);
// the kernel is allowed that much.
template <typename K>
cudaError_t size_smem(int device, K kernel, size_t want, size_t fallback,
                      size_t* smem, bool* staged) {
  size_t limit = 0;
  cudaError_t e = smem_limit(device, &limit);
  if (e != cudaSuccess) return e;
  *staged = want <= limit;
  *smem = *staged ? want : fallback;
  return allow_smem(kernel, *smem);
}

template <class Terms>
cudaError_t lod_windows_config(int device, int W, size_t* smem,
                               bool* staged) {
  return size_smem(device, &lod_windows_kernel<Terms>,
                   lod_windows_smem<Terms>(W, true),
                   lod_windows_smem<Terms>(W, false), smem, staged);
}

// K2's passes per block: the fewest whose tile keeps at least half a pass
// of SNPs; 0 when W is too large (the u16 prefix bounds a block to 65535
// window starts).
int covered_passes(int W) {
  const int npass = (W - 1 + kStarts / 2 + kStarts - 1) / kStarts;
  return (long)npass * kStarts > 65535 ? 0 : npass;
}

template <class Terms>
cudaError_t covered_config(int device, int W, size_t* smem, bool* staged) {
  const int npass = covered_passes(W);
  if (npass == 0) return cudaErrorInvalidValue;
  return size_smem(device, &covered_kernel<Terms>,
                   covered_smem<Terms>(W, npass, true),
                   covered_smem<Terms>(W, npass, false), smem, staged);
}

// Each launcher makes `device` (the tensors' CUDA device) current for
// this library's runtime, enqueues one kernel on `stream` (PyTorch's
// current stream of that device) and returns cudaGetLastError(): a
// refused launch never runs and a later synchronize would not report it.

template <class Terms>
cudaError_t launch_lod_windows(int device, Terms t, const void* miss,
                               void* out, int I, int L, int W, void* stream) {
  const int nwin = L - W + 1;
  if (I < 1 || nwin < 1 || W < 1) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  size_t smem = 0;
  bool staged = false;
  if (e == cudaSuccess)
    e = lod_windows_config<Terms>(device, W, &smem, &staged);
  const int ncols = (nwin + kStarts1 - 1) / kStarts1;
  if ((long)ncols * I > INT_MAX) return cudaErrorInvalidValue;
  int blocks = 1;
  if (e == cudaSuccess)
    e = grid_blocks(device, &lod_windows_kernel<Terms>, kThreads1, smem,
                    (long)ncols * I, &blocks);
  if (e != cudaSuccess) return e;
  lod_windows_kernel<Terms><<<blocks, kThreads1, smem,
                              (cudaStream_t)stream>>>(
      t, (const uint8_t*)miss, (float*)out, I, W, nwin, staged);
  return cudaGetLastError();
}

template <class Terms>
cudaError_t launch_covered(int device, Terms t, const void* miss, void* cov,
                           void* susw, void* above, int I, int L, int W,
                           float cutoff, float thr, float delta,
                           void* stream) {
  const int nwin = L - W + 1;
  const int npass = covered_passes(W);
  if (I < 1 || nwin < 1 || W < 1 || npass == 0) return cudaErrorInvalidValue;
  const int tile = npass * kStarts - (W - 1);
  cudaError_t e = cudaSetDevice(device);
  size_t smem = 0;
  bool staged = false;
  if (e == cudaSuccess) e = covered_config<Terms>(device, W, &smem, &staged);
  const int ncols = (L + tile - 1) / tile;
  if ((long)ncols * I > INT_MAX) return cudaErrorInvalidValue;
  int blocks = 1;
  if (e == cudaSuccess)
    e = grid_blocks(device, &covered_kernel<Terms>, kThreads, smem,
                    (long)ncols * I, &blocks);
  if (e != cudaSuccess) return e;
  covered_kernel<Terms><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      t, (const uint8_t*)miss, (uint8_t*)cov, (uint8_t*)susw,
      (uint8_t*)above, I, L, W, nwin, npass, staged, cutoff, thr, delta);
  return cudaGetLastError();
}

template <class Terms>
int resident_warps(int device, int W, bool covered) {
  size_t smem = 0;
  bool staged = false;
  int n = -1;
  cudaError_t e = covered
                      ? covered_config<Terms>(device, W, &smem, &staged)
                      : lod_windows_config<Terms>(device, W, &smem, &staged);
  if (e == cudaSuccess)
    e = covered ? per_sm(&covered_kernel<Terms>, kThreads, smem, &n)
                : per_sm(&lod_windows_kernel<Terms>, kThreads1, smem, &n);
  return e == cudaSuccess ? n * (covered ? kThreads : kThreads1) / 32 : -1;
}

}  // namespace

extern "C" int gt_lod_windows(int device, const void* packed,
                              const void* table, const void* miss, void* out,
                              int I, int L, int Lq, int W, void* stream) {
  const PackedTerms t{(const uint8_t*)packed, (const float*)table, I, L, Lq};
  return (int)launch_lod_windows(device, t, miss, out, I, L, W, stream);
}

extern "C" int gt_covered(int device, const void* packed, const void* table,
                          const void* miss, void* cov, void* susw,
                          void* above, int I, int L, int Lq, int W,
                          float cutoff, float thr, float delta,
                          void* stream) {
  const PackedTerms t{(const uint8_t*)packed, (const float*)table, I, L, Lq};
  return (int)launch_covered(device, t, miss, cov, susw, above, I, L, W,
                             cutoff, thr, delta, stream);
}

extern "C" int gt_window_sums(int device, const void* terms,
                              const void* miss, void* out, int I, int L,
                              int W, void* stream) {
  const PlaneTerms t{(const float*)terms, L};
  return (int)launch_lod_windows(device, t, miss, out, I, L, W, stream);
}

extern "C" int gt_covered_terms(int device, const void* terms,
                                const void* miss, void* cov, void* susw,
                                void* above, int I, int L, int W,
                                float cutoff, float thr, float delta,
                                void* stream) {
  const PlaneTerms t{(const float*)terms, L};
  return (int)launch_covered(device, t, miss, cov, susw, above, I, L, W,
                             cutoff, thr, delta, stream);
}

// Resident warps per SM of kernel k (0-3: K1-K4) at window size W, as
// its launch sizes its blocks (the occupancy the card allows, not a
// measured one); -1 on an error.
extern "C" int gt_resident_warps(int device, int k, int W) {
  if (k < 0 || k > 3 || W < 1 || cudaSetDevice(device) != cudaSuccess)
    return -1;
  return k < 2 ? resident_warps<PackedTerms>(device, W, k == 1)
               : resident_warps<PlaneTerms>(device, W, k == 3);
}
