// Phase II's exact f64 pool of thinned rolling LOD windows on NVIDIA
// Hopper (sm_90a), bound to Python through a plain C interface (ctypes;
// see ops/_build.py and ops/exact_pool.py, which also holds the plain
// PyTorch version).
//
// gt_exact_pool replaces no Pallas kernel: the JAX package pools these
// samples on the host, and so did the port.  It takes over the host pass
// gt_lod_windows_exact_thin (garlic_tpu_torch/native/garlic_native.cpp:1433)
// and the decode and column compaction of the codes that fed it: the
// codes are the chromosome's 2-bit codes on the card (cuda_lod.
// packed_device), read through a row index.
//
//   For each chain (a chromosome c and the k-th of its requested rows,
//   row = rows_c[k]), with term(l) = table_c[code(row, l)][l] for codes
//   0-2 and +0.0 for code 3 (missing), nwin = L - W + 1, the recurrence
//   of gt_lod_windows_exact_tbl, add for add in f64 round-to-nearest:
//     acc = a fresh sum 0.0 + term(l) + ... + term(l + W - 1), from the
//           left, at the first window and after every missing window;
//     acc = (acc - term(l - 1)) + term(l + W - 1) otherwise;
//   out_c[k, l / step] = acc where l % step == 0 and window l is not
//   missing, and `missing` in every other column of [rows_c, ceil(L/step)].
//   No product is formed, so nothing can contract to an FMA: the card's
//   bits are the host's.
//
// Inputs: desc, int64 [kDesc * nchrom + nchains]: a chromosome's fields
// (codes, table, miss and rows as device addresses; out's offset in
// elements; the codes' row stride in bytes, L, ceil(L / step)), then a
// chain's (c << 32 | k), chromosome-major.  codes: u8 [*, stride] 2-bit
// codes, 4 a byte in little-endian lanes; table: f64 [3, L]; miss: u8
// [max(nwin, 0)], 1 where the window is missing; rows: int32 [nrows].
//
// Bound on the card: the serial chain.  Each chain is ~2 (nwin - 1)
// dependent f64 adds (plus W at each fresh sum), so its time is that
// count times one dependent add's latency: at the example benchmark's
// chromosome 1 (50,300 loci, W = 60) ~100,000 adds, ~0.4 ms; the bytes
// (the rows' codes, the tables, the masks and the output, ~19 MB for the
// example's pool) take ~6 us at 3.35 TB/s.  Chains are few (20 rows x
// 22 chromosomes = 440), so the card is far from full whatever the
// design: what matters is that the chain never waits for anything but
// its own adds.
//
// Design.  One warp a chain.  Every lane runs the same chain (the adds
// are warp-wide instructions, so the 31 copies cost no time) and takes
// each step's two terms by a shuffle from the lane that gathered them.
// The warp walks the windows in chunks of kChunk = 32 kP: lane j gathers
// the terms of windows l0 + 32 p + j, p < kP (the term leaving, l - 1,
// and the term entering, l + W - 1) and the window's mask byte.  The
// gathers are made one chunk ahead, as raw loads whose values nothing
// reads until the next chunk: the code byte and all three table rows of
// each locus (the row is picked once the code is there), so no load's
// address waits on another load, and the loads' latency hides under the
// chain of the chunk before.  A chunk with no missing window after a
// live one is 2 kChunk adds fully unrolled; any other chunk runs a loop
// that restarts the sum where the mask says so (a fresh sum: the warp
// gathers W terms, 32 at a time, and every lane adds them in order).
// After each chunk, lane j holds the value of its own windows and the
// lanes whose window is a thinned column write it.  (On an H100 80GB
// HBM3 this takes 1.8 ms at the example's pool, 4.3 times its chain; a
// variant that reads the terms from a buffer in shared memory in place
// of the shuffles took 1.4 ms in one comparison.)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;        // chains of a block, a warp each
constexpr int kP = 4;            // windows of a chunk a lane gathers
constexpr int kChunk = 32 * kP;  // windows of a chunk
constexpr int kDesc = 8;         // int64 fields of a chromosome
constexpr unsigned kFull = 0xffffffffu;

struct Chain {
  const uint8_t* codes;  // the chain's row
  const double* table;   // [3, L]
  int L;
};

// A locus's raw loads: its code byte and its three table values; byte
// 0xff (code 3, adds +0.0) where the locus is out of range.
struct Locus {
  uint8_t byte;
  double t[3];
};

__device__ __forceinline__ void gather(const Chain& ch, bool ok, int l,
                                       Locus& x) {
  if (ok) {
    x.byte = __ldg(ch.codes + (l >> 2));
    x.t[0] = __ldg(ch.table + l);
    x.t[1] = __ldg(ch.table + ch.L + l);
    x.t[2] = __ldg(ch.table + 2LL * ch.L + l);
  } else {
    x.byte = 0xff;
    x.t[0] = x.t[1] = x.t[2] = 0.0;
  }
}

__device__ __forceinline__ double pick(const Locus& x, int l) {
  const int c = (x.byte >> (2 * (l & 3))) & 3;
  return c == 0 ? x.t[0] : c == 1 ? x.t[1] : c == 2 ? x.t[2] : 0.0;
}

// term(l), its loads waited for at once (the fresh sums only)
__device__ __forceinline__ double term(const Chain& ch, int l) {
  Locus x;
  gather(ch, true, l, x);
  return pick(x, l);
}

struct Raw {
  uint8_t miss[kP];
  Locus head[kP], tail[kP];
};

__device__ __forceinline__ void gather_chunk(const Chain& ch,
                                             const uint8_t* miss, int nwin,
                                             int W, int l0, int lane,
                                             Raw& r) {
#pragma unroll
  for (int p = 0; p < kP; p++) {
    const int l = l0 + 32 * p + lane;
    const bool live = l < nwin;
    r.miss[p] = live ? __ldg(miss + l) : 1;
    gather(ch, live && l >= 1, l - 1, r.head[p]);
    gather(ch, live, l + W - 1, r.tail[p]);
  }
}

// 0.0 + term(l) + ... + term(l + W - 1), from the left, on every lane
__device__ double fresh_sum(const Chain& ch, int l, int W, int lane) {
  double s = 0.0;
  for (int k0 = 0; k0 < W; k0 += 32) {
    const double v = k0 + lane < W ? term(ch, l + k0 + lane) : 0.0;
    const int nk = min(32, W - k0);
    for (int j = 0; j < nk; j++) s = __dadd_rn(s, __shfl_sync(kFull, v, j));
  }
  return s;
}

__global__ void __launch_bounds__(32 * kWarps)
exact_pool_kernel(const long long* __restrict__ desc, int nchrom,
                  int nchains, int W, int step, double missing,
                  double* __restrict__ out) {
  const int g = blockIdx.x * kWarps + threadIdx.x / 32;
  if (g >= nchains) return;  // a whole warp
  const int lane = threadIdx.x & 31;
  const long long cell = desc[(long long)kDesc * nchrom + g];
  const long long* d = desc + (long long)kDesc * (cell >> 32);
  const int k = (int)(cell & 0xffffffffLL);
  const int L = (int)d[6];
  const long long nthin = d[7];
  const int row = __ldg((const int32_t*)d[3] + k);
  const Chain ch = {(const uint8_t*)d[0] + (long long)row * d[5],
                    (const double*)d[1], L};
  const uint8_t* miss = (const uint8_t*)d[2];
  double* o = out + d[4] + (long long)k * nthin;
  const int nwin = L - W + 1;

  bool have = false;  // acc holds the previous window's sum
  double acc = 0.0;
  Raw nxt;
  if (nwin > 0) gather_chunk(ch, miss, nwin, W, 0, lane, nxt);
  for (int l0 = 0; l0 < nwin; l0 += kChunk) {
    double h[kP], e[kP], mine[kP];
    unsigned mb[kP];
    bool none = true;
#pragma unroll
    for (int p = 0; p < kP; p++) {
      const int l = l0 + 32 * p + lane;
      h[p] = pick(nxt.head[p], l - 1);
      e[p] = pick(nxt.tail[p], l + W - 1);
      mb[p] = __ballot_sync(kFull, nxt.miss[p] != 0);
      none = none && mb[p] == 0;
      mine[p] = missing;
    }
    // the next chunk's loads, in flight under this chunk's chain
    if (l0 + kChunk < nwin)
      gather_chunk(ch, miss, nwin, W, l0 + kChunk, lane, nxt);
    if (have && none) {
#pragma unroll
      for (int p = 0; p < kP; p++) {
#pragma unroll
        for (int j = 0; j < 32; j++) {
          acc = __dadd_rn(__dsub_rn(acc, __shfl_sync(kFull, h[p], j)),
                          __shfl_sync(kFull, e[p], j));
          mine[p] = lane == j ? acc : mine[p];
        }
      }
    } else {
#pragma unroll
      for (int p = 0; p < kP; p++) {
        for (int j = 0; j < 32; j++) {
          // the same on every lane: the loop's branches are the warp's
          const double hj = __shfl_sync(kFull, h[p], j);
          const double ej = __shfl_sync(kFull, e[p], j);
          if ((mb[p] >> j) & 1u) {
            have = false;
            continue;
          }
          if (have) {
            acc = __dadd_rn(__dsub_rn(acc, hj), ej);
          } else {
            acc = fresh_sum(ch, l0 + 32 * p + j, W, lane);
            have = true;
          }
          if (lane == j) mine[p] = acc;
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kP; p++) {
      const int l = l0 + 32 * p + lane;
      if (l < nwin && l % step == 0) o[l / step] = mine[p];
    }
  }
  // the columns of no window
  const long long t0 = nwin > 0 ? (nwin + step - 1) / step : 0;
  for (long long t = t0 + lane; t < nthin; t += 32) o[t] = missing;
}

// n rounds of two dependent f64 adds on one thread: the latency that
// bounds a chain of exact_pool_kernel (timed by chip_smoke.py)
__global__ void dadd_chain_kernel(const double* __restrict__ x,
                                  long long n, double* __restrict__ out) {
  const double v = x[0], w = x[1];
  double acc = x[2];
#pragma unroll 16
  for (long long i = 0; i < n; i++) acc = __dadd_rn(__dsub_rn(acc, v), w);
  out[0] = acc;
}

}  // namespace

// One thread's n rounds of two dependent f64 adds from x[2], adding
// -x[0] and x[1], into out[0], enqueued on `stream`: its time over 2 n is
// one dependent add's latency.
extern "C" int gt_dadd_chain(int device, const void* x, long long n,
                             void* out, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  dadd_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const double*)x, n, (double*)out);
  return (int)cudaGetLastError();
}

// Makes `device` current for this library's runtime, enqueues the pool
// on `stream` (PyTorch's current stream of that device) and returns
// cudaGetLastError(): a refused launch never runs and a later
// synchronize would not report it.
extern "C" int gt_exact_pool(int device, const void* desc, int nchrom,
                             int nchains, int W, int step, double missing,
                             void* out, void* stream) {
  if (nchrom < 1 || nchains < 1 || W < 1 || step < 1 ||
      ((uintptr_t)desc & 7) != 0 || ((uintptr_t)out & 7) != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  exact_pool_kernel<<<(nchains + kWarps - 1) / kWarps, 32 * kWarps, 0,
                      (cudaStream_t)stream>>>(
      (const long long*)desc, nchrom, nchains, W, step, missing,
      (double*)out);
  return (int)cudaGetLastError();
}
