// Weighted Phase-I kernels for NVIDIA Hopper (sm_90a), bound to Python
// through a plain C interface (ctypes; see ops/_build.py and
// ops/device_wlod.py, which also hold the plain PyTorch versions).
//
// K5 gt_pair_counts replaces the XLA programs
//    garlic_tpu/ops/device_wlod.py:247 _hr2_counts_chunk  (HR^2) and
//    garlic_tpu/ops/device_wlod.py:317 _r2_counts_chunk   (r^2, phased)
//    For offsets 1 <= d < W and loci m < L - d it counts, over the rows,
//    T[d, m] = #{i : valid(i, m) & valid(i, m + d)} and
//    HR^2: X[d, m] = #{i : hom(i, m) & hom(i, m + d)} (hom: code 0 or 2),
//    r^2:  X[d, m] = 2 #(a2 & b2) + #(a1 & b2) + #(a2 & b1)
//                    + #(a1 & b1 & same first copy)
//    (a = locus m, b = locus m + d; 1 and 2 the het and hom-alt codes)
//    into the int32 [W, L] planes: stored (`fresh`: every entry written,
//    0 in row 0 and past L - d) or added to what they hold (every other
//    entry left as it is).  The counts are exact, so row chunks and shards
//    accumulate into the same planes in any order.
// K6 gt_wlod_windows / gt_wlod_windows_terms replace the XLA program
//    garlic_tpu/ops/device_wlod.py:604 _wlod_chunk, that is
//    _wlod_score_from_table (:417) followed by _wlod_windows_dev (:513):
//    win[i, l] = sum_j score[i, l + j] * inv[j, l], j = 0 .. W - 1, one
//    rounded product (__fmul_rn) then one rounded add (__fadd_rn), left
//    to right from 0.0f (never an FMA: nvcc contracts a * b + c by
//    default, and the CPU's plain version rounds both), MISSING where the
//    window mask is set; score[i, m] = table[code(i, m), m] from 2-bit
//    codes and a [4, L] per-class table (codes), or an f32 score plane
//    (TGLS).  inv is offset-major [W, nwin]: each offset is one
//    contiguous row.  The tie scale is the largest finite
//    colmax[l + j] * |inv[j, l]|, colmax[m] the largest finite
//    |score[i, m]| over the rows: the plain version's formula; rounding
//    is monotone, so a max over row blocks gives the same value whenever
//    no product overflows.
//
// Bounds at the bench shape (200 x 499,456, W = 60).  K5 reads the codes
// once (25 MB) and writes two int32 [W, L] planes (240 MB): 0.08 ms at
// 3.35 TB/s, the writes all but all of it.  K6 does 6.0e9 products and
// 6.0e9 adds, 0.36 ms at 128 f32 lanes per clock on 132 SMs at 1.98 GHz:
// one FMUL or FADD per clock per SM sub-partition, so every other
// instruction in its inner loop (a shared load, a compare) takes an FP
// instruction's slot; its bytes (codes, the 120 MB band, 400 MB of
// windows) take about 0.17 ms.
//
// K5's design: the counts as int8 products on the tensor cores.  A block
// owns 128 loci m (one row group of 16 per warp) and walks over chunks
// of 64 offsets.  Each count plane is a product of 0/1 int8 flag planes
// over the rows: T = sum_i valid_i(m) valid_i(n), HR^2's X = sum_i
// hom_i(m) hom_i(n), and r^2's x11 = sum_i h1_i(m) h1_i(n) + h2_i(m)
// h2_i(n) over the two haplotypes (h1 = a2 | (a1 & f), h2 = a2 | (a1 &
// ~f), f the first-copy bit): the count of 1-1 haplotype pairs, which is
// the four terms above.  Up to 256 rows of the codes (and first-copy
// bits) of the block's loci and their partners come in at once as 4-byte
// words by cp.async, from the aligned word at or below each row's first
// byte (no alignment is asked of the caller); for each chunk of 64 rows
// the block turns them into flags, K-major (a locus's rows contiguous,
// 80 bytes a locus, so that ldmatrix and the flag stores are free of bank
// conflicts), 4 rows x 4 loci per thread by bit operations.  Each warp
// then runs mma.sync m16n8k32 s8 (16 loci x 8 partners x 32 rows) over
// the 10 partner groups of 8 that meet its band (n - m in the chunk's
// offsets), T and X in int32 registers.  The sums leave through a shared
// tile [offset][locus] (132 ints a row: the C fragments' scatter is free
// of conflicts), one plane at a time, in coalesced rows of 128 loci:
// stored when the planes are fresh, else added.  The int32 counts are
// exact (each term is at most 2 n).  What binds it on the card: the
// stores alone run near the bytes bound, and the staging, flag building
// and barriers of each block do not overlap them (chip_smoke.py phase 6
// prints the times; PERF.md has the measurements).
//
// K6's design.  A block owns a tile of 128 window starts, laid in the
// column frame (tile t covers the windows starting at columns 128 t ..
// 128 t + 127, so every staged row starts on a 16-byte boundary), and its
// rows in groups of 8.  Each warp takes every kWarps-th group and runs
// it alone (its own buffers, __syncwarp only): the block meets at a
// barrier only to stage a chunk of 64 offsets' 1/LD rows and table
// columns, and for the tie scale.  A lane owns 4 consecutive starts of
// the group's 8 rows, 32 sums in registers; per 4 offsets it loads 8
// float4 of new scores (one per row) and 4 float4 of 1/LD (one per
// offset) from shared memory and does 256 rounded FP operations: 12
// loads to 256 FP instructions.  The inputs of the warp's next
// groups are in flight while it computes: the codes' 4-byte words (from
// the aligned word at or below each row's first byte, three groups
// ahead), decoded a byte into 4 scores (4 rows x one byte a lane); the
// plane's rows by cp.async (16-byte copies where a row's position 0 is
// aligned) into the second of two score buffers.  The tie scale leaves
// the inner loop: each staged column's largest finite |score| is folded
// into one shared array (atomicMax on the bits), and once every group of
// a chunk is done the block does one product and max per (start, offset)
// from the staged 1/LD rows, then one atomicMax per block.  A W of more
// than 64 runs chunk by chunk, each chunk's partial sums (exact f32
// values) kept in the output rows.  Sums leave through the warp's score
// buffer, 32 consecutive windows of a row a store, MISSING applied.
// What binds it on the card: its part that grows with W runs near the FP
// rate; the per-group work that does not (the decode, the column maxima,
// the stores, the block's barriers around a chunk) and the last of a
// tile's row groups on its warps take the rest (chip_smoke.py phase 6
// prints the times at W=60 and W=1; PERF.md has the measurements).
//
// Neither kernel has a silent fallback: a launch that cannot run (shared
// memory, shape) returns its CUDA error and the wrapper raises.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

namespace {

constexpr float kMissing = -9999.0f;  // garlic_tpu_torch.core.types.MISSING

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 4-byte asynchronous copy to shared memory; src_bytes 0 writes zeros
// (src is then not read, but stays a valid address).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
// 16-byte asynchronous copy (both addresses 16-byte aligned); bytes past
// src_bytes are zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// all but the newest N committed groups of this thread have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// K5: pair counts
// ---------------------------------------------------------------------------

constexpr int kPairWarps = 8;
constexpr int kPairThreads = 32 * kPairWarps;
constexpr int kPairTile = 16 * kPairWarps;  // loci m per block
constexpr int kDc = 64;   // offsets per chunk; chunk c starts at 1 + 64 c
constexpr int kNG = 10;   // partner groups of 8 per row group and chunk
// partner window of a chunk: row group 7's last group ends at 16 * 7 + 80
constexpr int kPWin = 16 * (kPairWarps - 1) + 8 * kNG;  // 192 loci
constexpr int kKC = 64;        // rows (individuals) per flag chunk
constexpr int kRawRows = 256;  // rows of raw codes staged at once
constexpr int kFP = kKC + 16;  // bytes per locus in a flag plane
constexpr int kOP = kPairTile + 4;  // ints per offset row of the out tile
static_assert(kDc % 8 == 0, "chunks start at 1 mod 8");
static_assert(8 * kNG >= 15 + kDc, "the groups cover a chunk's band");
static_assert((kFP / 16) % 2 == 1, "ldmatrix rows on distinct banks");
static_assert(kRawRows % kKC == 0, "whole flag chunks per raw tile");

// words holding n bytes that start anywhere in a word, plus the word
// after them (the flag builder reads 4 bytes from any byte of the span)
constexpr int span_words(int n) { return (3 + n + 3) / 4 + 1; }
constexpr int kWinCodeWords = span_words(kPWin / 4);
constexpr int kACodeWords = span_words(kPairTile / 4);
constexpr int kWinFcWords = span_words(kPWin / 8);
constexpr int kAFcWords = span_words(kPairTile / 8);

// The shared-memory layout of one launch (host and device agree).  multi:
// more than one chunk of offsets, so the loci m (A) are staged apart from
// the partner window (B).
struct PairSmem {
  int F, multi;
  __host__ __device__ int flag_rows() const {
    return kPWin + (multi ? kPairTile : 0);
  }
  __host__ __device__ int plane() const { return flag_rows() * kFP; }
  __host__ __device__ int flags() const {
    const int f = F * plane(), o = kDc * kOP * 4;
    return f > o ? f : o;  // the out tile reuses the flags' bytes
  }
  // 4-byte words per raw row: the window's code words (from the aligned
  // word at or below its first byte), then A's; the first-copy words
  // likewise
  __host__ __device__ int code_words() const {
    return kWinCodeWords + (multi ? kACodeWords : 0);
  }
  __host__ __device__ int fc_words() const {
    return kWinFcWords + (multi ? kAFcWords : 0);
  }
  // the raw words, then each raw row's misalignments (a byte per
  // segment: the window's codes, A's codes, the window's and A's
  // first-copy bytes)
  __host__ __device__ int raw() const {
    return kRawRows * 4 * (code_words() + (F == 3 ? fc_words() : 0) + 1);
  }
  __host__ __device__ int bytes() const { return flags() + raw(); }
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 32 s8, row-major) * b (32 x 8 s8, column-major), exact s32
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 4-byte words holding bytes [b0, b0 + nby) of rows k0 .. k0 +
// kRawRows - 1 of a byte plane (row stride ld, ld bytes a row), from the
// aligned word at or below byte b0, into words woff .. woff + nw - 1 of
// each raw row (pitch rw words), by cp.async: every copy of the tile in
// flight at once.  Rows past n and words past a row's end are zeros.
__device__ void load_words(uint32_t* raw, int rw, int woff, int nw,
                           const uint8_t* __restrict__ src, int n, int ld,
                           int k0, int b0) {
  for (int e = threadIdx.x; e < kRawRows * nw; e += kPairThreads) {
    const int row = e / nw, w = e - row * nw, k = k0 + row;
    const uint8_t* rs = src + (size_t)k * ld;
    const uint8_t* wa =
        (const uint8_t*)((uintptr_t)(rs + b0) & ~(uintptr_t)3) + 4 * w;
    const bool ok = k < n && wa < rs + ld;
    cp_async4(raw + row * rw + woff + w,
              ok ? (const void*)wa : (const void*)src, ok ? 4 : 0);
  }
}

// Four bytes from byte offset o of a row of 4-byte words (o + 4 bytes
// within the row's words).
__device__ __forceinline__ uint32_t bytes4(const uint32_t* w, int o) {
  return __funnelshift_r(w[o >> 2], w[(o >> 2) + 1], 8 * (o & 3));
}

// Byte j of word i of (w0, w1, w2, w3) into byte i of word j: a 4 x 4
// transpose of bytes.
__device__ __forceinline__ void transpose4(uint32_t (&w)[4]) {
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
  w[0] = __byte_perm(lo01, lo23, 0x5410);
  w[1] = __byte_perm(lo01, lo23, 0x7632);
  w[2] = __byte_perm(hi01, hi23, 0x5410);
  w[3] = __byte_perm(hi01, hi23, 0x7632);
}

// Flags of raw rows kr .. kr + 4 nq - 1 (rows k0 + kr ..) at the loci s0 +
// 4 bi + q (code byte s0 / 4 + bi, bi < nby) into flag rows ro + 4 bi + q
// of each plane: byte k of a flag row is flag f of raw row kr + k (F = 2:
// valid, hom; F = 3: valid, h1, h2).  Rows past n and loci past L are
// missing.  A raw row holds its code words from woff (first byte at the
// row's misalignment, mis[4 row + seg]) and, F = 3, its first-copy words
// from fwoff (misalignment mis[4 row + 2 + seg]); seg 0: the window, 1:
// A.  An item is 4 rows x 4 code bytes (16 loci): a thread reads each
// row's 4 bytes as one word (two loads and a funnel shift), transposes
// them into 4 words of the 4 rows' codes at one byte (byte_perm), and
// turns each into 4 words of 4 rows' flags per plane by bit operations
// on the 2-bit codes held a byte a row.
template <int F>
__device__ void flags_from_raw(uint8_t* fl, int plane, const uint32_t* raw,
                               const uint8_t* mis, int seg, int rw, int woff,
                               int fwoff, int n, int k0, int kr, int nq,
                               int s0, int nby, int ro, int L) {
  for (int it = threadIdx.x; it < (nby / 4) * nq; it += kPairThreads) {
    const int qd = it % nq, bg = it / nq;
    uint32_t w[4], fw[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = kr + 4 * qd + i;
      const uint32_t* rr = raw + row * rw;
      w[i] = k0 + row < n ? bytes4(rr + woff, mis[4 * row + seg] + 4 * bg)
                          : 0xFFFFFFFFu;
      if constexpr (F == 3) {
        // the 16 loci's first-copy bits, a nibble a code byte, spread to
        // a byte a code byte
        const uint32_t h =
            bytes4(rr + fwoff, mis[4 * row + 2 + seg] + 2 * bg) & 0xFFFFu;
        const uint32_t x = __byte_perm(h, 0, 0x1100);
        fw[i] = (x & 0x000F000Fu) | ((x >> 4) & 0x0F000F00u);
      }
    }
    transpose4(w);
    if constexpr (F == 3) transpose4(fw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int bi = 4 * bg + j;
      uint32_t c = w[j];
      if (s0 + 4 * bi + 3 >= L) {  // the loci past L are missing
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (s0 + 4 * bi + q >= L) c |= 0x03030303u << (2 * q);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = 4 * bi + q;
        const uint32_t x = (c >> (2 * q)) & 0x03030303u;  // a code a byte
        const uint32_t hi = x >> 1;  // bit 0 of a byte: the code's bit 1
        uint32_t* dst = (uint32_t*)(fl + (ro + p) * kFP + 4 * qd);
        dst[0] = ~(x & hi) & 0x01010101u;  // valid: code != 3
        if constexpr (F == 2) {
          dst[plane / 4] = ~x & 0x01010101u;  // hom: code 0 or 2
        } else {
          const uint32_t a2 = hi & ~x & 0x01010101u;  // code 2
          const uint32_t a1 = x & ~hi & 0x01010101u;  // code 1
          const uint32_t f = (fw[j] >> q) & 0x01010101u;
          dst[plane / 4] = a2 | (a1 & f);
          dst[2 * (plane / 4)] = a2 | (a1 & ~f);
        }
      }
    }
  }
}

// F = 2: HR^2 (T, hom-hom); F = 3: r^2 (T, x11).  One block per 128 loci.
template <int F>
__global__ void __launch_bounds__(kPairThreads, 2)
pair_counts_kernel(const uint8_t* __restrict__ packed,
                   const uint8_t* __restrict__ fcb, int* __restrict__ T,
                   int* __restrict__ X, int n, int L, int Lq, int Lf, int W,
                   int fresh) {
  extern __shared__ __align__(16) uint8_t psm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * kPairTile;
  const int nchunk = (W - 1 + kDc - 1) / kDc;
  const PairSmem lay{F, nchunk > 1};
  const int plane = lay.plane();
  const int rw = lay.code_words() + (F == 3 ? lay.fc_words() : 0);
  const int fwoff = lay.code_words();  // the first-copy words of a raw row
  uint8_t* fl = psm;
  int* out = (int*)psm;  // [kDc][kOP], after the flags are read
  uint32_t* raw = (uint32_t*)(psm + lay.flags());  // [kRawRows][rw]
  uint8_t* mis = (uint8_t*)(raw + kRawRows * rw);   // [kRawRows][4]
  if (fresh) {  // row 0 holds no pair
    for (int c = tid; c < kPairTile; c += kPairThreads)
      if (m0 + c < L) T[m0 + c] = X[m0 + c] = 0;
  }
  for (int ch = 0; ch < nchunk; ++ch) {
    const int d0 = 1 + ch * kDc, dc = min(kDc, W - d0);
    const int wb = d0 - 1;  // the window's first locus - m0 (d0 - 1 % 8 == 0)
    // A (loci m) is the window's first 128 loci when it starts at m0
    const int arow = wb == 0 ? 0 : kPWin;
    int cT[kNG][4], cX[kNG][4];
#pragma unroll
    for (int q = 0; q < kNG; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) cT[q][e] = cX[q][e] = 0;
    for (int k1 = 0; k1 < n; k1 += kRawRows) {
      __syncthreads();  // the raw tile, the flags and the out tile are read
      load_words(raw, rw, 0, kWinCodeWords, packed, n, Lq, k1,
                 (m0 + wb) >> 2);
      if (F == 3)
        load_words(raw, rw, fwoff, kWinFcWords, fcb, n, Lf, k1,
                   (m0 + wb) >> 3);
      if (wb != 0) {
        load_words(raw, rw, kWinCodeWords, kACodeWords, packed, n, Lq, k1,
                   m0 >> 2);
        if (F == 3)
          load_words(raw, rw, fwoff + kWinFcWords, kAFcWords, fcb, n, Lf, k1,
                     m0 >> 3);
      }
      cp_async_commit();
      // each raw row's misalignments (see flags_from_raw)
      for (int row = tid; row < kRawRows; row += kPairThreads) {
        const size_t k = min(k1 + row, n - 1);
        mis[4 * row] = (uintptr_t)(packed + k * Lq + ((m0 + wb) >> 2)) & 3;
        mis[4 * row + 1] = (uintptr_t)(packed + k * Lq + (m0 >> 2)) & 3;
        if (F == 3) {
          mis[4 * row + 2] = (uintptr_t)(fcb + k * Lf + ((m0 + wb) >> 3)) & 3;
          mis[4 * row + 3] = (uintptr_t)(fcb + k * Lf + (m0 >> 3)) & 3;
        }
      }
      cp_async_wait_all();
      for (int k0 = k1; k0 < min(n, k1 + kRawRows); k0 += kKC) {
        // the k-steps of this chunk and the row quads they read
        const int nks = (min(kKC, n - k0) + 31) / 32, nq = 8 * nks;
        __syncthreads();  // the raw tile is in; the flags are read
        flags_from_raw<F>(fl, plane, raw, mis, 0, rw, 0, fwoff, n, k1,
                          k0 - k1, nq, m0 + wb, kPWin / 4, 0, L);
        if (wb != 0)
          flags_from_raw<F>(fl, plane, raw, mis, 1, rw, kWinCodeWords,
                            fwoff + kWinFcWords, n, k1, k0 - k1, nq, m0,
                            kPairTile / 4, kPWin, L);
        __syncthreads();
        for (int ks = 0; ks < nks; ++ks) {
          // A: rows 16 warp .. +15 of the A rows, bytes 32 ks .. +31
          const uint8_t* ap = fl + (arow + 16 * warp + (lane & 7)
                                    + ((lane >> 3) & 1) * 8) * kFP
                              + 32 * ks + (lane >> 4) * 16;
          uint32_t a[F][4];
#pragma unroll
          for (int f = 0; f < F; ++f) ldsm_x4(a[f], ap + f * plane);
#pragma unroll
          for (int qp = 0; qp < kNG / 2; ++qp) {
            // B: partner groups 2 qp and 2 qp + 1 of this row group
            const uint8_t* bp =
                fl + (16 * warp + 8 * (2 * qp + (lane >> 4)) + (lane & 7))
                         * kFP
                + 32 * ks + ((lane >> 3) & 1) * 16;
            uint32_t b[F][4];
#pragma unroll
            for (int f = 0; f < F; ++f) ldsm_x4(b[f], bp + f * plane);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int q = 2 * qp + h;
              mma_s8(cT[q], a[0], b[0][2 * h], b[0][2 * h + 1]);
              mma_s8(cX[q], a[1], b[1][2 * h], b[1][2 * h + 1]);
              if constexpr (F == 3)
                mma_s8(cX[q], a[2], b[2][2 * h], b[2][2 * h + 1]);
            }
          }
        }
      }
    }
    // the sums, one plane at a time, through the out tile [dd][m - m0]
#pragma unroll
    for (int pl = 0; pl < 2; ++pl) {
      __syncthreads();  // the flags, or the previous plane's tile, are read
#pragma unroll
      for (int q = 0; q < kNG; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = 16 * warp + g + (e >> 1) * 8;
          const int dd = 16 * warp + wb + 8 * q + 2 * tig + (e & 1) - m - d0;
          if (dd >= 0 && dd < dc) out[dd * kOP + m] = pl ? cX[q][e] : cT[q][e];
        }
      __syncthreads();
      // coalesced rows of 128 loci; to add, 8 a thread are read before
      // any is written (a store may alias a later load in the compiler's
      // eyes, which would serialise every read-modify-write)
      int* P = pl ? X : T;
      constexpr int kU = 8;
      for (int e0 = tid; e0 < dc * kPairTile; e0 += kU * kPairThreads) {
        int* at[kU];
        int v[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int e = e0 + u * kPairThreads;
          const int dd = e / kPairTile, c = e % kPairTile;
          const bool ok = e < dc * kPairTile && m0 + c < L;
          at[u] = ok ? P + (size_t)(d0 + dd) * L + m0 + c : nullptr;
          v[u] = ok ? out[dd * kOP + c] : 0;
        }
        if (!fresh) {
#pragma unroll
          for (int u = 0; u < kU; ++u)
            if (at[u]) v[u] += *at[u];
        }
#pragma unroll
        for (int u = 0; u < kU; ++u)
          if (at[u]) *at[u] = v[u];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K6: wLOD window sums
// ---------------------------------------------------------------------------

constexpr int kR = 8;         // rows of a warp's group (each thread's rows)
constexpr int kTile = 128;    // window starts per block (4 per lane)
constexpr int kJ = 64;        // offsets per staged chunk
// code words a row: a step's kTile / 4 + kJ / 4 bytes from any byte
constexpr int kRawWords = 14;
static_assert(4 * kRawWords >= 3 + (kTile + kJ) / 4 + 3, "raw words fit");

// Warps per block and blocks per SM: what the shared memory of W = 60
// allows (the codes' warps hold one score buffer, the plane's two) and
// the registers of the inner loop (128 or 170 a thread).
// kDepth: a warp's groups in flight ahead of the one it computes, in a
// ring of kRing input buffers (the codes' raw words are decoded before
// their buffer is refilled; the plane's scores are read in place).
template <bool kCodes>
struct WinCfg {
  static constexpr int kWarps = kCodes ? 8 : 6;
  static constexpr int kBlocks = 2;
  static constexpr int kDepth = kCodes ? 3 : 1;
  static constexpr int kRing = kCodes ? kDepth : kDepth + 1;
};

// The shared-memory layout of one launch at window size W (host and
// device agree), in floats: jr offsets per staged 1/LD chunk, ld floats
// per staged score row (the tile's starts plus a chunk's offsets: the
// 16-byte loads read up to position 127 + jr), each warp's buffers, then
// the block's 1/LD chunk [jr][kTile], table chunk [4][ld] (codes) and
// column maxima [cm].
struct WinSmem {
  int jr, ld, nchunk, cm, warp;
  __host__ __device__ WinSmem(int W, bool codes)
      : jr(W > kJ ? kJ : (W + 3) & ~3),
        ld(kTile + (W > kJ ? kJ : (W + 3) & ~3)),
        nchunk((W + kJ - 1) / kJ),
        cm(kTile + ((W + kJ - 1) / kJ) * (W > kJ ? kJ : (W + 3) & ~3)),
        warp(codes ? kR * ld + WinCfg<true>::kRing * kR * kRawWords
                   : WinCfg<false>::kRing * kR * ld) {}
  __host__ __device__ int floats(int warps, bool codes) const {
    return warps * warp + jr * kTile + (codes ? 4 * ld : 0) + cm;
  }
};

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Four offsets jb .. jb + 3 of a step: old[r] holds the scores of row r
// at positions 4 lane + jb .. + 3, nw[r] takes the next four; start s and
// offset jb + u read position s + u of the eight.  Partial: only the
// offsets below jn.
template <bool kPartial>
__device__ __forceinline__ void win_group(float (&acc)[kR][4],
                                          const float4 (&old)[kR],
                                          float4 (&nw)[kR], const float* srow,
                                          int ld, const float* iv, int jb,
                                          int jn) {
#pragma unroll
  for (int r = 0; r < kR; ++r) nw[r] = lds4(srow + r * ld + jb + 4);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (!kPartial || jb + u < jn) {
      const float4 v = lds4(iv + (jb + u) * kTile);
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float sv[8] = {old[r].x, old[r].y, old[r].z, old[r].w,
                             nw[r].x,  nw[r].y,  nw[r].z,  nw[r].w};
#pragma unroll
        for (int s = 0; s < 4; ++s)
          acc[r][s] = __fadd_rn(acc[r][s], __fmul_rn(sv[s + u], vs[s]));
      }
    }
  }
}

// Largest finite |v| folded into m.
__device__ __forceinline__ float fold_abs(float m, float v) {
  const float a = fabsf(v);
  return a < INFINITY ? fmaxf(m, a) : m;
}

// Grid: x the tiles of window starts (column frame), y ranges of `per`
// row groups (8 rows each).  kCodes: scores from 2-bit codes (u8 [I, Lq],
// little-endian lanes, 4 loci a byte, cuda_lod.pack_codes's layout) and a
// [4, Ls] per-class table; else from an f32 plane [I, Ls].  Window start
// l reads columns col0 + l + j.  Warp w takes row groups ga + w, ga + w +
// kWarps, ... and runs them on its own (its buffers, __syncwarp only);
// the block meets at a barrier only to stage a chunk's 1/LD rows and
// table and for the tie scale.
template <bool kCodes>
__global__ void __launch_bounds__(32 * WinCfg<kCodes>::kWarps,
                                  WinCfg<kCodes>::kBlocks)
wlod_windows_kernel(const uint8_t* __restrict__ packed,
                    const float* __restrict__ table,
                    const float* __restrict__ plane,
                    const float* __restrict__ inv,
                    const uint8_t* __restrict__ miss,
                    float* __restrict__ out, unsigned* __restrict__ tie,
                    int I, int Ls, int Lq, int W, int nwin, int col0,
                    int per) {
  constexpr int NW = WinCfg<kCodes>::kWarps, NT = 32 * NW;
  constexpr int kDepth = WinCfg<kCodes>::kDepth, kRing = WinCfg<kCodes>::kRing;
  extern __shared__ __align__(16) float wsm[];
  const WinSmem lay(W, kCodes);
  const int jr = lay.jr, ld = lay.ld, nchunk = lay.nchunk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* wbuf = wsm + warp * lay.warp;  // this warp's buffers
  float* ivs = wsm + NW * lay.warp;     // [jr][kTile]
  float* tab = ivs + jr * kTile;        // [4][ld] (codes)
  float* cm = tab + (kCodes ? 4 * ld : 0);
  const int C0 = (col0 / kTile + (int)blockIdx.x) * kTile;  // position 0
  const int lo = C0 - col0;  // window start of position 0
  const int cmin = max(0, -lo), cmax = min(kTile, nwin - lo);
  const int ngroups = (I + kR - 1) / kR;
  const int ga = blockIdx.y * per, gb = min(ngroups, ga + per);

  for (int x = tid; x < lay.cm; x += NT) cm[x] = 0.0f;
  // this lane's output positions lane + 32 k: in the windows, masked
  bool cv[kTile / 32], mk[kTile / 32];
#pragma unroll
  for (int k = 0; k < kTile / 32; ++k) {
    const int c = lane + 32 * k;
    cv[k] = c >= cmin && c < cmax;
    mk[k] = cv[k] && miss[lo + c] != 0;
  }

  // group gi's inputs of chunk j0 into buffer b: the plane's rows by
  // cp.async into score buffer b, or the codes' 4-byte words holding each
  // row's bytes (from the aligned word at or below the first) into raw
  // buffer b; rows past I and words past a row's end are zeros
  auto issue = [&](int gi, int j0, int b) {
    if constexpr (kCodes) {
      uint32_t* raw = (uint32_t*)(wbuf + kR * ld) + b * kR * kRawWords;
      for (int x = lane; x < kR * kRawWords; x += 32) {
        const int r = x / kRawWords, w = x - r * kRawWords, row = gi * kR + r;
        const uint8_t* rs = packed + (size_t)row * Lq;
        const uint8_t* a0 =
            (const uint8_t*)((uintptr_t)(rs + (C0 + j0) / 4) & ~(uintptr_t)3);
        const uint8_t* wa = a0 + 4 * w;
        const bool ok = row < I && wa < rs + Lq;
        cp_async4(raw + x, ok ? (const void*)wa : (const void*)packed,
                  ok ? 4 : 0);
      }
    } else {
      // a row whose position 0 is 16-byte aligned in 16-byte copies (the
      // columns past Ls zeros), another in 4-byte ones
      float* dst = wbuf + b * kR * ld;
      for (int r = 0; r < kR; ++r) {
        const int row = gi * kR + r;
        const float* src = plane + (size_t)row * Ls + C0 + j0;
        if (row < I && ((uintptr_t)src & 15) == 0) {
          for (int p = 4 * lane; p < ld; p += 128) {
            const int nb = 4 * min(4, max(0, Ls - (C0 + j0 + p)));
            cp_async16(dst + r * ld + p, nb > 0 ? src + p : plane, nb);
          }
        } else {
          for (int p = lane; p < ld; p += 32) {
            const bool ok = row < I && C0 + j0 + p < Ls;
            cp_async4(dst + r * ld + p, ok ? src + p : plane, ok ? 4 : 0);
          }
        }
      }
    }
  };
  // the codes of group gi (in raw buffer b) into the score buffer: a
  // lane takes items of 4 rows (half h of the group) x one byte bi of the
  // chunk's columns, 4 scores a byte; the columns' largest finite |score|
  // go into cm
  auto decode = [&](int gi, int j0, int b) {
    const uint8_t* raw =
        (const uint8_t*)(wbuf + kR * ld) + 4 * b * kR * kRawWords;
    for (int it = lane; it < 2 * (ld / 4); it += 32) {
      const int h = it & 1, bi = it >> 1;
      const float4 t0 = lds4(tab + 4 * bi), t1 = lds4(tab + ld + 4 * bi);
      const float4 t2 = lds4(tab + 2 * ld + 4 * bi);
      const float4 t3 = lds4(tab + 3 * ld + 4 * bi);
      const float tb[4][4] = {{t0.x, t0.y, t0.z, t0.w},
                              {t1.x, t1.y, t1.z, t1.w},
                              {t2.x, t2.y, t2.z, t2.w},
                              {t3.x, t3.y, t3.z, t3.w}};
      float big[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < kR / 2; ++i) {
        const int r = h * (kR / 2) + i, row = gi * kR + r;
        const int dl = (int)((uintptr_t)(packed + (size_t)row * Lq
                                         + (C0 + j0) / 4) & 3);
        const uint32_t byte = raw[r * 4 * kRawWords + dl + bi];
        const bool live = row < I;  // rows past I score 0
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t c = (byte >> (2 * q)) & 3u;
          const float l2 = c & 1u ? tb[1][q] : tb[0][q];
          const float h2 = c & 1u ? tb[3][q] : tb[2][q];
          v[q] = live ? (c & 2u ? h2 : l2) : 0.0f;
          big[q] = fold_abs(big[q], v[q]);
        }
        *reinterpret_cast<float4*>(wbuf + r * ld + 4 * bi) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (big[q] > 0.0f)
          atomicMax((unsigned*)cm + j0 + 4 * bi + q, __float_as_uint(big[q]));
    }
  };
  // the plane's column maxima of score buffer b (this lane's copies)
  auto scan = [&](int j0, int b) {
    const float* src = wbuf + b * kR * ld;
    for (int p = lane; p < ld; p += 32) {
      float big = 0.0f;
#pragma unroll
      for (int r = 0; r < kR; ++r) big = fold_abs(big, src[r * ld + p]);
      if (big > 0.0f) atomicMax((unsigned*)cm + j0 + p, __float_as_uint(big));
    }
  };

  float tmax = 0.0f;
  for (int ch = 0; ch < nchunk; ++ch) {
    const int j0 = ch * kJ, jn = min(kJ, W - j0);
    const bool last = ch == nchunk - 1;
    __syncthreads();  // cm is zero; the previous chunk is done
    // the chunk's 1/LD rows (zeros past them and outside the windows) and
    // table columns, with each warp's first group
    for (int x = tid; x < jr * kTile; x += NT) {
      const int jj = x / kTile, c = x - jj * kTile, l = lo + c;
      const bool ok = jj < jn && l >= 0 && l < nwin;
      cp_async4(ivs + x, ok ? inv + (size_t)(j0 + jj) * nwin + l : inv,
                ok ? 4 : 0);
    }
    if constexpr (kCodes) {
      for (int x = tid; x < 4 * ld; x += NT) {
        const int k = x / ld, col = C0 + j0 + x - k * ld;
        const bool ok = col < Ls;
        cp_async4(tab + x, ok ? table + (size_t)k * Ls + col : table,
                  ok ? 4 : 0);
      }
    }
    // the first kDepth groups (one commit each, empty or not, so that
    // group k is always kDepth - 1 commits behind the newest)
    int gi = ga + warp;
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      if (gi + d * NW < gb) issue(gi + d * NW, j0, d % kRing);
      cp_async_commit();
    }
    cp_async_wait<kDepth - 1>();
    __syncthreads();
    for (int k = 0; gi < gb; gi += NW, ++k) {
      const int b = k % kRing;
      cp_async_wait<kDepth - 1>();
      __syncwarp();
      if constexpr (kCodes) {
        decode(gi, j0, b);
      } else {
        scan(j0, b);
      }
      __syncwarp();
      if (gi + kDepth * NW < gb)
        issue(gi + kDepth * NW, j0, (k + kDepth) % kRing);
      cp_async_commit();
      float* sbuf = kCodes ? wbuf : wbuf + b * kR * ld;
      float acc[kR][4];
      if (ch == 0) {
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
      } else {  // the earlier chunks' sums of these windows
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const int row = gi * kR + r;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int l = lo + 4 * lane + q;
            acc[r][q] = row < I && l >= 0 && l < nwin
                            ? out[(size_t)row * nwin + l]
                            : 0.0f;
          }
        }
      }
      const float* srow = sbuf + 4 * lane;
      const float* iv = ivs + 4 * lane;
      float4 a[kR], bb[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) a[r] = lds4(srow + r * ld);
      int jb = 0;
      for (; jb + 8 <= jn; jb += 8) {
        win_group<false>(acc, a, bb, srow, ld, iv, jb, jn);
        win_group<false>(acc, bb, a, srow, ld, iv, jb + 4, jn);
      }
      if (jb + 4 <= jn) {
        win_group<false>(acc, a, bb, srow, ld, iv, jb, jn);
        if (jb + 4 < jn) win_group<true>(acc, bb, a, srow, ld, iv, jb + 4, jn);
      } else if (jb < jn) {
        win_group<true>(acc, a, bb, srow, ld, iv, jb, jn);
      }
      // the sums leave through the score buffer just read (this warp's
      // own), 32 consecutive windows of a row a store, MISSING applied
      // after the last chunk
      __syncwarp();
#pragma unroll
      for (int r = 0; r < kR; ++r)
        *reinterpret_cast<float4*>(sbuf + r * kTile + 4 * lane) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      __syncwarp();
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int row = gi * kR + r;
        if (row < I) {
          float* orow = out + (size_t)row * nwin + lo + lane;  // position lane
#pragma unroll
          for (int k = 0; k < kTile / 32; ++k)
            if (cv[k])
              orow[32 * k] =
                  last && mk[k] ? kMissing : sbuf[r * kTile + lane + 32 * k];
        }
      }
      __syncwarp();
    }
    // the chunk's tie-scale terms, from its staged 1/LD rows: every row's
    // fold of the chunk's columns is in cm
    __syncthreads();
#pragma unroll 4
    for (int x = tid; x < jn * kTile; x += NT) {
      const int c = x % kTile, l = lo + c;
      if (l >= 0 && l < nwin) {
        const float q = __fmul_rn(cm[c + j0 + x / kTile], fabsf(ivs[x]));
        if (q < INFINITY) tmax = fmaxf(tmax, q);
      }
    }
  }
  // one atomicMax on the tie word per block (on the bits: non-negative
  // floats order as integers)
#pragma unroll
  for (int k = 16; k > 0; k >>= 1)
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, k));
  __syncthreads();  // cm is read
  if (lane == 0) cm[warp] = tmax;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < NW; ++w) tmax = fmaxf(tmax, cm[w]);
    if (tmax > 0.0f) atomicMax(tie, __float_as_uint(tmax));
  }
}

// Dynamic shared memory above the 48 KB default needs an opt-in, once per
// kernel, device and size (each kernel keeps the largest size it has
// opted in to on each of the first kDevices devices; beyond them every
// launch opts in).
constexpr int kDevices = 64;
template <auto kernel>
cudaError_t allow_smem(int device, size_t bytes) {
  static size_t done[kDevices] = {};  // one table per kernel
  if (device >= 0 && device < kDevices && bytes <= done[device])
    return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && bytes > 48 * 1024)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (e == cudaSuccess && device >= 0 && device < kDevices)
    done[device] = bytes;
  return e;
}

// The SM count of a device (asked once per device).
cudaError_t sm_count(int device, int* sms) {
  static int cached[kDevices] = {};
  if (device >= 0 && device < kDevices && cached[device] > 0) {
    *sms = cached[device];
    return cudaSuccess;
  }
  cudaError_t e =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess && device >= 0 && device < kDevices)
    cached[device] = *sms;
  return e;
}

// Each launcher makes `device` current for this library's runtime,
// enqueues one kernel on `stream` (PyTorch's current stream of that
// device) and returns cudaGetLastError(): a refused launch never runs and
// a later synchronize would not report it.

template <int F>
cudaError_t launch_pairs(int device, const uint8_t* packed, const uint8_t* fcb,
                         int* T, int* X, int n, int L, int Lq, int Lf, int W,
                         int fresh, void* stream) {
  const int nchunk = (W - 1 + kDc - 1) / kDc;
  const size_t smem = PairSmem{F, nchunk > 1}.bytes();
  cudaError_t e = allow_smem<pair_counts_kernel<F>>(device, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (L + kPairTile - 1) / kPairTile;
  pair_counts_kernel<F><<<blocks, kPairThreads, smem, (cudaStream_t)stream>>>(
      packed, fcb, T, X, n, L, Lq, Lf, W, fresh);
  return cudaGetLastError();
}

cudaError_t launch_pair_counts(int device, const uint8_t* packed,
                               const uint8_t* fcb, int* T, int* X, int n,
                               int L, int Lq, int Lf, int W, int fresh,
                               void* stream) {
  if (n < 1 || L < 1 || W < 1 || Lq != (L + 3) / 4)
    return cudaErrorInvalidValue;
  if (fcb != nullptr && Lf != (L + 7) / 8) return cudaErrorInvalidValue;
  if ((long)W * L > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  return fcb == nullptr
             ? launch_pairs<2>(device, packed, fcb, T, X, n, L, Lq, Lf, W,
                               fresh, stream)
             : launch_pairs<3>(device, packed, fcb, T, X, n, L, Lq, Lf, W,
                               fresh, stream);
}

template <bool kCodes>
cudaError_t launch_wlod_windows(int device, const uint8_t* packed,
                                const float* table, const float* plane,
                                const void* inv, const void* miss, void* out,
                                void* tie, int I, int Ls, int Lq, int W,
                                int nwin, int col0, void* stream) {
  if (I < 1 || W < 1 || nwin < 1 || col0 < 0 ||
      (long)col0 + nwin + W - 1 > Ls)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  const size_t smem = sizeof(float)
      * (size_t)WinSmem(W, kCodes).floats(WinCfg<kCodes>::kWarps, kCodes);
  if (e == cudaSuccess)
    e = allow_smem<wlod_windows_kernel<kCodes>>(device, smem);
  int sms = 0;
  if (e == cudaSuccess) e = sm_count(device, &sms);
  if (e != cudaSuccess) return e;
  const long tiles = (col0 + (long)nwin - 1) / kTile - col0 / kTile + 1;
  const int ngroups = (I + kR - 1) / kR;
  // row ranges: enough blocks for two waves when the tiles alone are
  // fewer; each range re-reads its tile's band
  const long want = 2L * WinCfg<kCodes>::kBlocks * sms;
  int ranges = (int)std::min<long>(
      (ngroups + WinCfg<kCodes>::kWarps - 1) / WinCfg<kCodes>::kWarps,
      std::max<long>(1, want / tiles));
  ranges = std::min(ranges, 65535);
  const int per = (ngroups + ranges - 1) / ranges;
  ranges = (ngroups + per - 1) / per;
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)ranges);
  wlod_windows_kernel<kCodes><<<grid, 32 * WinCfg<kCodes>::kWarps, smem,
                                (cudaStream_t)stream>>>(
      packed, table, plane, (const float*)inv, (const uint8_t*)miss,
      (float*)out, (unsigned*)tie, I, Ls, Lq, W, nwin, col0, per);
  return cudaGetLastError();
}

}  // namespace

// Counts the pairs of the n rows of `packed` (u8 [n, Lq] 2-bit codes) into
// the int32 [W, L] planes T and X: HR^2 when fcb is null, else r^2 with
// the rows' first-copy bits fcb (u8 [n, Lf], bit k of byte b is locus
// 8 b + k).  fresh != 0: every entry of the planes is written (the counts,
// 0 in row 0 and past L - d); else the counts are added to the planes.
extern "C" int gt_pair_counts(int device, const void* packed,
                              const void* fcb, void* T, void* X, int n,
                              int L, int Lq, int Lf, int W, int fresh,
                              void* stream) {
  return (int)launch_pair_counts(device, (const uint8_t*)packed,
                                 (const uint8_t*)fcb, (int*)T, (int*)X, n, L,
                                 Lq, Lf, W, fresh, stream);
}

// Window sums out (f32 [I, nwin]) over the scores of 2-bit codes (u8
// [I, Lq]) and a per-class table (f32 [4, Ls]), from column col0; inv f32
// [W, nwin], miss u8 [nwin]; *tie (f32, zeroed by the caller) takes the
// max with this launch's tie scale.
extern "C" int gt_wlod_windows(int device, const void* packed,
                               const void* table, const void* inv,
                               const void* miss, void* out, void* tie,
                               int I, int Ls, int Lq, int W, int nwin,
                               int col0, void* stream) {
  if (Lq != (Ls + 3) / 4) return (int)cudaErrorInvalidValue;
  return (int)launch_wlod_windows<true>(
      device, (const uint8_t*)packed, (const float*)table, nullptr, inv,
      miss, out, tie, I, Ls, Lq, W, nwin, col0, stream);
}

// The same over an f32 score plane [I, Ls].
extern "C" int gt_wlod_windows_terms(int device, const void* score,
                                     const void* inv, const void* miss,
                                     void* out, void* tie, int I, int Ls,
                                     int W, int nwin, int col0,
                                     void* stream) {
  return (int)launch_wlod_windows<false>(
      device, nullptr, nullptr, (const float*)score, inv, miss, out, tie, I,
      Ls, 0, W, nwin, col0, stream);
}
