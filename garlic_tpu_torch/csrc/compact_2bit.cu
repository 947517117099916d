// Column compaction of 2-bit genotype codes on NVIDIA Hopper (sm_90a),
// bound to Python through a plain C interface (ctypes; see ops/_build.py
// and ops/cuda_lod.py, which also holds the plain PyTorch version).
//
// gt_compact_2bit replaces no Pallas kernel: the JAX package compacts the
// codes on the host, and so did the port.  It takes over the host pass
// gt_filter_pack_2bit (garlic_tpu_torch/native/garlic_native.cpp:217),
// which the monomorphic filter defers (io/filters._apply): where a
// chromosome's compaction is still deferred when Phase I builds a shard's
// inputs, the shard's rows of the unfiltered parent payload and the index
// of its kept loci go up, and this kernel writes the codes K1-K4 read
// (ops/cuda_lod.packed_device).
//
//   out[r, o] = the code at parent position idx[o] of parent row r, for
//   o < n, and 3 (missing) for n <= o < 4 * nb: u8 [rows, nb] with
//   nb = ceil(n / 4), 4 codes a byte in little-endian lanes (the layout
//   of pallas_lod.pack_genotypes and of the host pass, tail included).
//   parent: `size` bytes (4-byte aligned), row r from parent + r * stride;
//   idx: int32 [n] (16-byte aligned), ascending code positions from a
//   row's start; plan: 32 * ceil(n / 16) bytes of scratch.
//
// Bound on the card: bytes.  A launch reads the parent's rows once (at
// most rows * stride bytes), the index once (4 n bytes) and writes
// rows * nb bytes, with a few integer operations a code: at the WGS
// benchmark's chromosome 1 (108 rows of 820,835 loci, ~806,000 kept)
// ~47 MB, 14 us at 3.35 TB/s.  (The plan, 2 bytes a locus written once
// and read once a block of rows, is scratch and not counted.)
//
// Design.  A thread owns a group of 16 consecutive kept loci: one 4-byte
// word of each row's output.  The kept loci are nearly consecutive, so a
// group is a few runs of consecutive parent positions (one where no locus
// inside it was dropped), and each run's codes are one field of the
// parent row: the word is an OR of one 32-bit funnel shift a run, in
// place of 16 code gathers.
// * compact_plan_kernel finds each group's runs once (at most 4; a group
//   with more is marked, and gathers its codes one by one): for run q
//   the row bit src[q] that lands at bit 0 of the word when the field is
//   shifted out there, and its bits msk[q] in the word.
// * compact_2bit_kernel: a block of kThreads threads takes kRows rows of
//   kThreads consecutive groups.  A thread reads its plan (two 16-byte
//   loads) and for each row reads, for each run, the two aligned words
//   that hold its field (neighbouring threads, neighbouring words: a
//   warp's loads are coalesced), shifts and masks, and stores the word:
//   whole, or in halves, where the row's alignment allows.  The warp runs
//   as many runs as its thread with the most (a template per count), and
//   starts the loads of kBatch rows before it makes any of their words.
// The run finding is the costly part of a group's work (16 index entries
// compared, a run list built), so it is made once per group by the plan
// and not once per block of rows; and a batch's loads go out together,
// since the time of a block is its chain of load latencies (plan, words,
// stores), not its operations.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // groups of a block, a thread each
constexpr int kRows = 8;          // rows of a block
constexpr int kBatch = 4;         // rows whose loads go out together
constexpr int kPlanThreads = 256;

__global__ void __launch_bounds__(kPlanThreads)
compact_plan_kernel(const int32_t* __restrict__ idx, int n,
                    int4* __restrict__ src, uint4* __restrict__ msk) {
  const int gi = blockIdx.x * kPlanThreads + threadIdx.x;
  const int o0 = 16 * gi;
  if (o0 >= n) return;
  int p[16];
  if (o0 + 16 <= n) {
    const int4* v = (const int4*)(idx + o0);
#pragma unroll
    for (int i = 0; i < 4; i++) {
      const int4 t = __ldg(v + i);
      p[4 * i] = t.x;
      p[4 * i + 1] = t.y;
      p[4 * i + 2] = t.z;
      p[4 * i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 16; k++) p[k] = o0 + k < n ? __ldg(idx + o0 + k) : 0;
  }
  // the runs newest first, in registers (a shift register: no array is
  // indexed by a run's number)
  int s0 = 0, s1 = 0, s2 = 0, s3 = 0;
  uint32_t m0 = 0, m1 = 0, m2 = 0, m3 = 0;
  int runs = 0;
#pragma unroll
  for (int k = 0; k < 16; k++) {
    if (o0 + k < n) {
      if (k > 0 && p[k] == p[k - 1] + 1) {
        m0 |= 3u << (2 * k);
      } else {
        s3 = s2; m3 = m2;
        s2 = s1; m2 = m1;
        s1 = s0; m1 = m0;
        s0 = 2 * (p[k] - k);
        m0 = 3u << (2 * k);
        runs++;
      }
    }
  }
  src[gi] = runs > 4 ? make_int4(-1, 0, 0, 0) : make_int4(s0, s1, s2, s3);
  msk[gi] = runs > 4 ? make_uint4(0, 0, 0, 0) : make_uint4(m0, m1, m2, m3);
}

__device__ __forceinline__ void store4(uint8_t* o, uint32_t v, int nbytes) {
  if (nbytes == 4 && ((uintptr_t)o & 3) == 0) {
    *(uint32_t*)o = v;
  } else if (nbytes == 4 && ((uintptr_t)o & 1) == 0) {
    ((uint16_t*)o)[0] = (uint16_t)v;
    ((uint16_t*)o)[1] = (uint16_t)(v >> 16);
  } else {
    for (int b = 0; b < nbytes; b++) o[b] = (uint8_t)(v >> (8 * b));
  }
}

// The words of rows [r0, r0 + nr) from R runs (s, m); a thread with more
// than 4 runs (over) stores nothing here.
template <int R>
__device__ __forceinline__ void rows_runs(
    const uint8_t* __restrict__ parent, const uint32_t* last,
    long long stride, int r0, int nr, const int* s, const uint32_t* m,
    uint32_t pad, uint8_t* __restrict__ out, int nb, int j, int nbytes,
    bool over) {
  for (int r = 0; r < nr; r += kBatch) {
    uint32_t x[kBatch][R], y[kBatch][R], sh[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; b++) {
      const uint8_t* g = parent + (r0 + min(r + b, nr - 1)) * stride;
      const uint32_t* w = (const uint32_t*)((uintptr_t)g & ~(uintptr_t)3);
      sh[b] = 8 * (uint32_t)((uintptr_t)g & 3);
#pragma unroll
      for (int q = 0; q < R; q++) {
        const uint32_t* a = w + ((sh[b] + s[q]) >> 5);
        x[b][q] = __ldg(a);
        y[b][q] = __ldg(a < last ? a + 1 : a);
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; b++) {
      uint32_t v = pad;
#pragma unroll
      for (int q = 0; q < R; q++)
        v |= __funnelshift_r(x[b][q], y[b][q], sh[b] + s[q]) & m[q];
      if (r + b < nr && !over)
        store4(out + (long long)(r0 + r + b) * nb + j, v, nbytes);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
compact_2bit_kernel(const uint8_t* __restrict__ parent, long long size,
                    long long stride, const int32_t* __restrict__ idx,
                    const int4* __restrict__ src,
                    const uint4* __restrict__ msk, uint8_t* __restrict__ out,
                    int rows, int n, int nb) {
  const int gi = blockIdx.x * kThreads + threadIdx.x;
  const int o0 = 16 * gi;
  if (o0 >= n) return;
  const int r0 = blockIdx.y * kRows;
  const int nr = min(rows - r0, kRows);
  const int4 s4 = __ldg(src + gi);
  const uint4 m4 = __ldg(msk + gi);
  const bool over = s4.x < 0;
  // an unused run (or an over thread) reads run 0's words
  const int sx = over ? 0 : s4.x;
  const int s[4] = {sx, m4.y ? s4.y : sx, m4.z ? s4.z : sx,
                    m4.w ? s4.w : sx};
  const uint32_t m[4] = {m4.x, m4.y, m4.z, m4.w};
  // the missing codes past n
  const uint32_t pad = o0 + 16 > n ? ~0u << (2 * (n - o0)) : 0u;
  const int more = (m4.y != 0) + (m4.z != 0) + (m4.w != 0);
  const int most = __reduce_max_sync(__activemask(), more);
  const uint32_t* last =
      (const uint32_t*)((uintptr_t)(parent + size - 1) & ~(uintptr_t)3);
  const int j = o0 / 4;
  const int nbytes = min(4, nb - j);
  if (most == 0)
    rows_runs<1>(parent, last, stride, r0, nr, s, m, pad, out, nb, j,
                 nbytes, over);
  else if (most == 1)
    rows_runs<2>(parent, last, stride, r0, nr, s, m, pad, out, nb, j,
                 nbytes, over);
  else if (most == 2)
    rows_runs<3>(parent, last, stride, r0, nr, s, m, pad, out, nb, j,
                 nbytes, over);
  else
    rows_runs<4>(parent, last, stride, r0, nr, s, m, pad, out, nb, j,
                 nbytes, over);
  if (over) {  // more than 4 runs: locus by locus
    for (int rr = r0; rr < r0 + nr; rr++) {
      const uint8_t* g = parent + rr * stride;
      uint32_t v = pad;
      for (int k = 0; k < 16 && o0 + k < n; k++) {
        const int c = __ldg(idx + o0 + k);
        v |= ((uint32_t)(__ldg(g + (c >> 2)) >> (2 * (c & 3))) & 3u)
             << (2 * k);
      }
      store4(out + (long long)rr * nb + j, v, nbytes);
    }
  }
}

}  // namespace

// Makes `device` current for this library's runtime, enqueues the plan
// and the compaction on `stream` (PyTorch's current stream of that
// device) and returns cudaGetLastError(): a refused launch never runs and
// a later synchronize would not report it.
extern "C" int gt_compact_2bit(int device, const void* parent,
                               long long size, long long stride,
                               const void* idx, void* plan, void* out,
                               int rows, int n, int nb, void* stream) {
  const int groups = (n + 15) / 16;
  if (rows < 1 || n < 1 || nb != (n + 3) / 4 || stride < 1 ||
      (rows - 1) * stride >= size || ((uintptr_t)parent & 3) != 0 ||
      ((uintptr_t)idx & 15) != 0 || ((uintptr_t)plan & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((groups + kThreads - 1) / kThreads,
                  (rows + kRows - 1) / kRows);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  int4* src = (int4*)plan;
  uint4* msk = (uint4*)((char*)plan + 16LL * groups);
  compact_plan_kernel<<<(groups + kPlanThreads - 1) / kPlanThreads,
                        kPlanThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)idx, n, src, msk);
  compact_2bit_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)parent, size, stride, (const int32_t*)idx, src, msk,
      (uint8_t*)out, rows, n, nb);
  return (int)cudaGetLastError();
}
