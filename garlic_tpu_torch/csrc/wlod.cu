// Weighted Phase-I kernels for NVIDIA Hopper (sm_90a), bound to Python
// through a plain C interface (ctypes; see ops/_build.py and
// ops/device_wlod.py, which also hold the plain PyTorch versions).
//
// K5 gt_pair_counts replaces the XLA programs
//    garlic_tpu/ops/device_wlod.py:247 _hr2_counts_chunk  (HR^2) and
//    garlic_tpu/ops/device_wlod.py:317 _r2_counts_chunk   (r^2, phased)
//    For offsets 1 <= d < W and loci m < L - d it adds into int32 [W, L]
//    planes T[d, m] = #{i : valid(i, m) & valid(i, m + d)} and
//    HR^2: X[d, m] = #{i : hom(i, m) & hom(i, m + d)} (hom: code 0 or 2),
//    r^2:  X[d, m] = 2 #(a2 & b2) + #(a1 & b2) + #(a2 & b1)
//                    + #(a1 & b1 & same first copy)
//    (a = locus m, b = locus m + d; 1 and 2 the het and hom-alt codes);
//    every other entry is left as it is.  The counts are exact, so row
//    chunks and shards accumulate into the same planes in any order.
// K6 gt_wlod_windows / gt_wlod_windows_terms replace the XLA program
//    garlic_tpu/ops/device_wlod.py:604 _wlod_chunk, that is
//    _wlod_score_from_table (:417) followed by _wlod_windows_dev (:513):
//    win[i, l] = sum_j score[i, l + j] * inv[j, l], j = 0 .. W - 1, one
//    rounded product (__fmul_rn) then one rounded add (__fadd_rn), left
//    to right from 0.0f (never an FMA: nvcc contracts a * b + c by
//    default, and the CPU's plain version rounds both), MISSING where the
//    window mask is set; score[i, m] = table[code(i, m), m] from 2-bit
//    codes and a [4, L] per-class table (CodeScores), or an f32 score
//    plane (PlaneScores, TGLS).  inv is offset-major [W, nwin]: each
//    offset is one contiguous row.  The tie scale is the largest finite
//    colmax[l + j] * |inv[j, l]|, colmax[m] the largest finite
//    |score[i, m]| over the rows: the plain version's formula; rounding
//    is monotone, so a max over row blocks gives the same value whenever
//    no product overflows.
//
// Bounds at the bench shape (200 x 499,456, W = 60).  K5 reads the codes
// once (25 MB) and writes two int32 [W, L] planes (240 MB): 0.08 ms at
// 3.35 TB/s; its bit tests are few (a 32-bit AND and a popcount count 32
// individuals).  K6 does 6.0e9 products and 6.0e9 adds, 0.36 ms at 128
// f32 lanes per clock on 132 SMs at 1.98 GHz; its bytes (codes, the
// 120 MB band, 400 MB of windows) take about 0.17 ms.
//
// K5's design.  A block owns kPairThreads consecutive loci m (one per
// thread) and every offset.  For a chunk of rows (kSlabs slabs of 32
// individuals) and a chunk of kDChunk offsets, each warp turns the 2-bit
// codes of 32 individuals at one locus into per-flag bit masks with
// __ballot_sync (valid, hom; or valid, het, hom-alt, first copy), held in
// shared memory for the block's loci plus the chunk's offsets.  A thread
// keeps its own locus's masks in registers and, for each offset, ANDs
// them with the partner locus's and adds the popcounts; the r^2 sum takes
// two popcounts (its het/hom-alt terms are disjoint bit sets).  The
// planes are updated by a read-modify-write per (d, m), coalesced along
// m.  So the bytes are the codes once (plus the halo of W - 1 loci per
// block) and the planes, and the int32 counts are exact.
//
// K6's design.  A block owns a tile of kTile = 32 * kS window starts and
// walks over passes of kPassRows rows.  For each chunk of kJ offsets it
// stages the tile's inv rows [kJ, kTile] and the pass's scores over the
// tile's kTile + kJ - 1 loci (gathered from the codes and the table, or
// read from the plane) in shared memory.  A thread owns kR rows x kS
// consecutive window starts (40 sums in registers); for each offset it
// loads kS inv values and, through a ring of kS scores per row, one new
// score per row, then does 2 kR kS rounded operations: 80 per 13 shared
// loads.  kS is odd, so the 32 lanes of a warp read 32 distinct banks.
// Each warp also keeps the largest finite |score| of its rows per locus
// (staged beside the scores) for the tie scale, one product and max per
// (start, offset).  The sums go out through shared memory, coalesced,
// with MISSING where the mask is set; a block's tie scale goes into one
// word by atomicMax on its bits (non-negative floats order as integers).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

namespace {

constexpr float kMissing = -9999.0f;  // garlic_tpu_torch.core.types.MISSING

// ---------------------------------------------------------------------------
// K5: pair counts
// ---------------------------------------------------------------------------

constexpr int kPairThreads = 256;  // loci per block, one per thread
constexpr int kPairWarps = kPairThreads / 32;
constexpr int kSlabs = 8;          // slabs of 32 rows per row chunk
constexpr int kDChunk = 64;        // offsets per staged chunk
constexpr int kSpan = kPairThreads + kDChunk;  // staged loci per chunk

// The masks of rows [r0, r0 + 32 ns) at loci [base, base + kSpan) into
// msk: bit i of msk[(f * kSlabs + s) * kSpan + p] is flag f of row
// r0 + 32 s + i at locus base + p.  F = 2: valid, hom (code 0 or 2);
// F = 4: valid, het (code 1), hom-alt (code 2), first copy.  Loci at or
// past L and rows at or past n set no bit.  Each warp takes (slab, four
// code bytes) items: lane i loads row r0 + 32 s + i's four bytes (16
// loci) at once, every load in range (clamped) and in flight together.
template <int F>
__device__ __forceinline__ void stage_masks(
    uint32_t* msk, const uint8_t* __restrict__ packed,
    const uint8_t* __restrict__ fcb, int n, int L, int Lq, int Lf, int r0,
    int ns, int base) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b0 = base >> 2;
  const int ng = (((base + kSpan - 1) >> 2) - b0 + 4) >> 2;  // byte quads
  for (int item = warp; item < ns * ng; item += kPairWarps) {
    const int s = item / ng, bq = b0 + 4 * (item - s * ng);
    const bool rowok = r0 + 32 * s + lane < n;
    const size_t row = min(r0 + 32 * s + lane, n - 1);
    uint32_t code[4], fc[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int b = min(bq + k, Lq - 1);
      code[k] = __ldg(packed + row * Lq + b);
      if constexpr (F == 4)
        fc[k] = __ldg(fcb + row * Lf + (b >> 1)) >> ((b & 1) * 4);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = 4 * (bq + k) + q, p = c - base;
        const uint32_t g = rowok && c < L ? (code[k] >> (2 * q)) & 3u : 3u;
        uint32_t m[F];
        m[0] = __ballot_sync(0xffffffffu, g != 3u);
        if constexpr (F == 2) {
          m[1] = __ballot_sync(0xffffffffu, g == 0u || g == 2u);
        } else {
          m[1] = __ballot_sync(0xffffffffu, g == 1u);
          m[2] = __ballot_sync(0xffffffffu, g == 2u);
          m[3] = __ballot_sync(0xffffffffu, ((fc[k] >> q) & 1u) != 0u);
        }
        if (lane < F && p >= 0 && p < kSpan) {
          uint32_t v = m[0];
#pragma unroll
          for (int f = 1; f < F; ++f) v = lane == f ? m[f] : v;
          msk[(lane * kSlabs + s) * kSpan + p] = v;
        }
      }
    }
  }
}

// F = 2: HR^2 (T, hom-hom); F = 4: r^2 (T, x11).
template <int F>
__global__ void __launch_bounds__(kPairThreads)
pair_counts_kernel(const uint8_t* __restrict__ packed,
                   const uint8_t* __restrict__ fcb, int* __restrict__ T,
                   int* __restrict__ X, int n, int L, int Lq, int Lf, int W) {
  __shared__ uint32_t msk[F * kSlabs * kSpan];
  const int t = threadIdx.x;
  const int m0 = blockIdx.x * kPairThreads, m = m0 + t;
  // the offsets with a locus pair in this block: d <= L - 1 - m0
  const int dmax = min(W - 1, L - 1 - m0);
  if (dmax < 1) return;
  for (int r0 = 0; r0 < n; r0 += 32 * kSlabs) {
    const int ns = min(kSlabs, (n - r0 + 31) / 32);
    uint32_t own[kSlabs][F];
    for (int d0 = 1; d0 <= dmax; d0 += kDChunk) {
      const int dn = min(kDChunk, dmax - d0 + 1);
      const int base = m0 + d0 - 1;  // locus m + d at offset t + d - d0 + 1
      __syncthreads();  // the previous chunk's masks are read
      stage_masks<F>(msk, packed, fcb, n, L, Lq, Lf, r0, ns, base);
      __syncthreads();
      if (d0 == 1) {  // base = m0: this thread's own locus at offset t
#pragma unroll
        for (int s = 0; s < kSlabs; ++s)
#pragma unroll
          for (int f = 0; f < F; ++f)
            own[s][f] = s < ns ? msk[(f * kSlabs + s) * kSpan + t] : 0u;
      }
      for (int k = 0; k < dn; ++k) {
        const int d = d0 + k, o = t + k + 1;
        int ct = 0, cx = 0;
#pragma unroll
        for (int s = 0; s < kSlabs; ++s) {
          if (s < ns) {
            const uint32_t* p = msk + s * kSpan + o;
            ct += __popc(own[s][0] & p[0]);
            if constexpr (F == 2) {
              cx += __popc(own[s][1] & p[kSlabs * kSpan]);
            } else {
              const uint32_t a1 = own[s][1], a2 = own[s][2];
              const uint32_t b1 = p[kSlabs * kSpan];
              const uint32_t b2 = p[2 * kSlabs * kSpan];
              const uint32_t same = ~(own[s][3] ^ p[3 * kSlabs * kSpan]);
              cx += 2 * __popc(a2 & b2) +
                    __popc((a1 & b2) | (a2 & b1) | (a1 & b1 & same));
            }
          }
        }
        if (m < L - d) {
          const size_t at = (size_t)d * L + m;
          T[at] += ct;
          X[at] += cx;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K6: wLOD window sums
// ---------------------------------------------------------------------------

constexpr int kWinThreads = 128;
constexpr int kWinWarps = kWinThreads / 32;
constexpr int kS = 5;   // window starts per thread (odd: distinct banks)
constexpr int kR = 8;   // rows per thread
constexpr int kTile = 32 * kS;               // window starts per block
constexpr int kPassRows = kWinWarps * kR;    // rows per pass
constexpr int kJ = 12 * kS;                  // offsets per staged chunk
constexpr int kSpanW = kTile + kJ;           // >= the loci of a chunk
constexpr int kWinSmemFloats = kJ * kTile + (kPassRows + kWinWarps) * kSpanW;
static_assert(kPassRows * kTile <= kPassRows * kSpanW, "sums fit the scores");
static_assert(kJ % kS == 0, "the ring's slots are fixed at compile time");

// K6 scores from 2-bit codes (little-endian lanes, 4 loci per byte, the
// layout of cuda_lod.pack_codes) and a [4, Ls] per-class table: column
// state holds the column's four table entries.  load() fetches a row's
// raw value (any row and column in range), value() turns it into the
// score without a branch, so a thread's loads of many rows are in flight
// together.
struct CodeScores {
  const uint8_t* packed;  // [I, Lq]
  const float* table;     // [4, Ls]
  int Lq, Ls;
  using Raw = uint32_t;
  struct Col {
    float t0, t1, t2, t3;
    int byte, shift;
  };
  __device__ __forceinline__ Col column(int c) const {
    return Col{__ldg(table + c), __ldg(table + Ls + c),
               __ldg(table + 2 * (size_t)Ls + c),
               __ldg(table + 3 * (size_t)Ls + c), c >> 2, 2 * (c & 3)};
  }
  __device__ __forceinline__ Raw load(int row, const Col& k) const {
    return __ldg(packed + (size_t)row * Lq + k.byte);
  }
  __device__ __forceinline__ float value(Raw b, const Col& k) const {
    const uint32_t g = (b >> k.shift) & 3u;
    const float lo = g & 1u ? k.t1 : k.t0, hi = g & 1u ? k.t3 : k.t2;
    return g & 2u ? hi : lo;
  }
};

// K6 scores from an f32 plane [I, Ls] (TGLS: the host's f64 scores as f32).
struct PlaneScores {
  const float* score;
  int Ls;
  using Raw = float;
  struct Col {
    int c;
  };
  __device__ __forceinline__ Col column(int c) const { return Col{c}; }
  __device__ __forceinline__ Raw load(int row, const Col& k) const {
    return __ldg(score + (size_t)row * Ls + k.c);
  }
  __device__ __forceinline__ float value(Raw v, const Col&) const {
    return v;
  }
};

// Grid: x the tiles of window starts, y groups of `per` passes each.
// Source column of window start l and offset j: col0 + l + j.
template <class Scores>
__global__ void __launch_bounds__(kWinThreads, 3)
wlod_windows_kernel(Scores src, const float* __restrict__ inv,
                    const uint8_t* __restrict__ miss,
                    float* __restrict__ out, unsigned* __restrict__ tie,
                    int I, int W, int nwin, int col0, int per) {
  extern __shared__ __align__(16) float smem[];
  float* ivs = smem;                        // [kJ][kTile]
  float* sc = ivs + kJ * kTile;             // [kPassRows][kSpanW]
  float* cm = sc + kPassRows * kSpanW;      // [kWinWarps][kSpanW]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int l0 = blockIdx.x * kTile;
  const int ncol = min(kTile, nwin - l0);
  const int npass = (I + kPassRows - 1) / kPassRows;
  const int pa = blockIdx.y * per, pb = min(npass, pa + per);
  const int js = lane * kS;  // this thread's first window start in the tile
  const int nchunk = (W + kJ - 1) / kJ;
  const int ncols = nwin + W - 1;  // source columns the windows read
  float tmax = 0.0f;
  const float* srow = sc + warp * kR * kSpanW + js;
  const float* crow = cm + warp * kSpanW + js;
  for (int pass = pa; pass < pb; ++pass) {
    const int rp = pass * kPassRows;
    float acc[kR][kS];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int s = 0; s < kS; ++s) acc[r][s] = 0.0f;
    for (int j0 = 0; j0 < W; j0 += kJ) {
      const int jn = min(kJ, W - j0);
      const int span = kTile + jn - 1;
      __syncthreads();  // the previous chunk or pass is done with smem
      if (nchunk > 1 || pass == pa) {
        for (int x = tid; x < jn * kTile; x += kWinThreads) {
          const int jj = x / kTile, c = x - jj * kTile;
          ivs[x] = l0 + c < nwin
                       ? __ldg(inv + (size_t)(j0 + jj) * nwin + l0 + c)
                       : 0.0f;
        }
      }
      for (int p = tid; p < span; p += kWinThreads) {
        const int c = l0 + j0 + p;  // column of the windows' frame
        const bool live = c < ncols;
        const typename Scores::Col k = src.column(live ? col0 + c : col0);
        // every load first (rows past I read row I - 1), then the values
        typename Scores::Raw raw[kPassRows];
#pragma unroll
        for (int r = 0; r < kPassRows; ++r)
          raw[r] = src.load(min(rp + r, I - 1), k);
        float v[kPassRows];
#pragma unroll
        for (int r = 0; r < kPassRows; ++r)
          v[r] = live && rp + r < I ? src.value(raw[r], k) : 0.0f;
#pragma unroll
        for (int w = 0; w < kWinWarps; ++w) {
          float big = 0.0f;
#pragma unroll
          for (int r = w * kR; r < (w + 1) * kR; ++r) {
            sc[r * kSpanW + p] = v[r];
            if (fabsf(v[r]) < INFINITY) big = fmaxf(big, fabsf(v[r]));
          }
          cm[w * kSpanW + p] = big;
        }
      }
      __syncthreads();
      // offset jj = jb + u: score of start s at ring slot (u + s) % kS;
      // the ring holds loci js + jj .. js + jj + kS - 1 of the chunk
      float buf[kR][kS], cbuf[kS];
#pragma unroll
      for (int q = 0; q < kS - 1; ++q) {
#pragma unroll
        for (int r = 0; r < kR; ++r) buf[r][q] = srow[r * kSpanW + q];
        cbuf[q] = crow[q];
      }
      for (int jb = 0; jb < jn; jb += kS) {
#pragma unroll
        for (int u = 0; u < kS; ++u) {
          const int jj = jb + u;
          if (jj < jn) {
            constexpr int kLast = kS - 1;
            const int slot = (u + kLast) % kS;
#pragma unroll
            for (int r = 0; r < kR; ++r)
              buf[r][slot] = srow[r * kSpanW + jj + kLast];
            cbuf[slot] = crow[jj + kLast];
            float iv[kS];
#pragma unroll
            for (int s = 0; s < kS; ++s) iv[s] = ivs[jj * kTile + js + s];
#pragma unroll
            for (int s = 0; s < kS; ++s) {
              const float q = __fmul_rn(cbuf[(u + s) % kS], fabsf(iv[s]));
              if (q < INFINITY) tmax = fmaxf(tmax, q);
            }
#pragma unroll
            for (int r = 0; r < kR; ++r)
#pragma unroll
              for (int s = 0; s < kS; ++s)
                acc[r][s] = __fadd_rn(
                    acc[r][s], __fmul_rn(buf[r][(u + s) % kS], iv[s]));
          }
        }
      }
    }
    __syncthreads();  // every score is read: sc takes the pass's sums
    float* o = sc;    // [kPassRows][kTile]
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int s = 0; s < kS; ++s)
        o[(warp * kR + r) * kTile + js + s] = acc[r][s];
    __syncthreads();
    for (int x = tid; x < kPassRows * ncol; x += kWinThreads) {
      const int r = x / ncol, c = x - r * ncol, row = rp + r;
      if (row < I)
        out[(size_t)row * nwin + l0 + c] =
            miss[l0 + c] ? kMissing : o[r * kTile + c];
    }
  }
#pragma unroll
  for (int k = 16; k > 0; k >>= 1)
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, k));
  if (lane == 0 && tmax > 0.0f) atomicMax(tie, __float_as_uint(tmax));
}

// Dynamic shared memory above the 48 KB default needs an opt-in.
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

// Each launcher makes `device` current for this library's runtime,
// enqueues one kernel on `stream` (PyTorch's current stream of that
// device) and returns cudaGetLastError(): a refused launch never runs and
// a later synchronize would not report it.

cudaError_t launch_pair_counts(int device, const uint8_t* packed,
                               const uint8_t* fcb, int* T, int* X, int n,
                               int L, int Lq, int Lf, int W, void* stream) {
  if (n < 1 || L < 1 || W < 1 || Lq != (L + 3) / 4)
    return cudaErrorInvalidValue;
  if (fcb != nullptr && Lf != (L + 7) / 8) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const int blocks = (L + kPairThreads - 1) / kPairThreads;
  if (fcb == nullptr) {
    pair_counts_kernel<2><<<blocks, kPairThreads, 0, (cudaStream_t)stream>>>(
        packed, fcb, T, X, n, L, Lq, Lf, W);
  } else {
    pair_counts_kernel<4><<<blocks, kPairThreads, 0, (cudaStream_t)stream>>>(
        packed, fcb, T, X, n, L, Lq, Lf, W);
  }
  return cudaGetLastError();
}

template <class Scores>
cudaError_t launch_wlod_windows(int device, Scores src, const void* inv,
                                const void* miss, void* out, void* tie,
                                int I, int Ls, int W, int nwin, int col0,
                                void* stream) {
  if (I < 1 || W < 1 || nwin < 1 || col0 < 0 ||
      (long)col0 + nwin + W - 1 > Ls)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  const size_t smem = sizeof(float) * kWinSmemFloats;
  if (e == cudaSuccess) e = allow_smem(&wlod_windows_kernel<Scores>, smem);
  int sms = 0;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const long tiles = (nwin + kTile - 1) / kTile;
  const int npass = (I + kPassRows - 1) / kPassRows;
  // pass groups: enough blocks for two waves of 3 per SM when the tiles
  // alone are fewer; each group re-reads its tile's band
  const long want = 6L * sms;
  int groups = (int)std::min<long>(npass, std::max<long>(1, want / tiles));
  groups = std::min(groups, 65535);
  const int per = (npass + groups - 1) / groups;
  groups = (npass + per - 1) / per;
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)groups);
  wlod_windows_kernel<Scores><<<grid, kWinThreads, smem,
                                (cudaStream_t)stream>>>(
      src, (const float*)inv, (const uint8_t*)miss, (float*)out,
      (unsigned*)tie, I, W, nwin, col0, per);
  return cudaGetLastError();
}

}  // namespace

// Adds the pair counts of the n rows of `packed` (u8 [n, Lq] 2-bit codes)
// into the int32 [W, L] planes T and X: HR^2 when fcb is null, else r^2
// with the rows' first-copy bits fcb (u8 [n, Lf], bit k of byte b is
// locus 8 b + k).
extern "C" int gt_pair_counts(int device, const void* packed,
                              const void* fcb, void* T, void* X, int n,
                              int L, int Lq, int Lf, int W, void* stream) {
  return (int)launch_pair_counts(device, (const uint8_t*)packed,
                                 (const uint8_t*)fcb, (int*)T, (int*)X, n, L,
                                 Lq, Lf, W, stream);
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
  const CodeScores src{(const uint8_t*)packed, (const float*)table, Lq, Ls};
  return (int)launch_wlod_windows(device, src, inv, miss, out, tie, I, Ls, W,
                                  nwin, col0, stream);
}

// The same over an f32 score plane [I, Ls].
extern "C" int gt_wlod_windows_terms(int device, const void* score,
                                     const void* inv, const void* miss,
                                     void* out, void* tie, int I, int Ls,
                                     int W, int nwin, int col0,
                                     void* stream) {
  const PlaneScores src{(const float*)score, Ls};
  return (int)launch_wlod_windows(device, src, inv, miss, out, tie, I, Ls, W,
                                  nwin, col0, stream);
}
