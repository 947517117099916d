// Automatic-run kernels for NVIDIA Hopper (sm_90a), bound to Python
// through a plain C interface (ctypes; see ops/_build.py, and ops/kde.py
// and ops/gmm.py, which also hold the plain PyTorch versions and the
// Python mirror of K7's plan).
//
// K7 gt_gauss_sums replaces the XLA Gauss transform of
//    garlic_tpu/parallel/engine.py:250 gauss_transform_sharded (its scan
//    body, :283-285) and garlic_tpu/ops/kde.py:119 gauss_transform
//    (device=True): y[m] = sum_j exp(-(x_j - t_m)^2 / h^2) over f32
//    sources x [n] and f32 targets t [M], in f64 [M].  Each term it
//    computes is the plain version's value bit for bit: __fsub_rn(x, t),
//    __fmul_rn(d, d), __fmul_rn(., neg_inv_h2), expf (every step an
//    intrinsic, so nvcc contracts nothing into an FMA; expf is the one
//    torch's exp_ calls).
//    What binds a dense transform is issuing the f32 steps of expf's range
//    reduction over all n M terms; at the bench shape (n = 3,328,600
//    pooled windows, M = 512, h ~ 0.52 against a grid 127 units wide)
//    ~92% of them are exactly +0.  A term is exactly +0 once its
//    argument is at most -104 (chip_smoke.py checks expf of every f32 in
//    [-inf, -104] on the card); a pair farther apart than hw = 10.5 /
//    sqrt(-neg_inv_h2) (10.5 h) has an argument of at most -110.25 (1 -
//    4 2^-24): each rounded step is monotone.  So K7 computes only the
//    pairs that can be non-zero, and adding the +0 of a pair it skips
//    changes no sum.
//    1. Cells (k7_cells): NC = min(M - 1, 1024) cells of width
//       (t[M-1] - t[0]) / NC from t0 = t[0]; a source's bucket is its
//       cell floor((x - t0) * inv_c) (f32, inv_c = f32(NC / span)),
//       clamped to an under- and an over-range bucket, and NaN sources a
//       last bucket of their own: B = NC + 3 buckets.  A degenerate grid
//       (M < 2, span not > 0, inv_c not finite) plans every tile dense.
//    2. Bucketing, stable, without atomics: blocks of 8 warps take 8192
//       sources each, a warp 1024 in index order, 32 at a time (8 loads
//       in flight); the lanes of one bucket find each other by one ballot
//       per bit of the bucket (same_bucket; __match_any_sync was the
//       slower), and the lowest adds their count to the warp's row of a
//       shared histogram (one writer per bucket and step).
//       k7_count_kernel writes each warp's counts ([warps][B]) and each
//       block's ([B][blocks]); k7_rows_kernel turns each bucket's row of
//       block counts into exclusive offsets (one warp a bucket) and its
//       total; k7_plan_kernel the totals into bucket starts;
//       k7_scatter_kernel gives each warp its first place in each bucket
//       (bucket start + row offset + the earlier warps' counts) and writes
//       each source at its warp's place plus its rank among its bucket's
//       lanes, in lane order.  The order is a stable sort by bucket.
//    3. Plan (k7_plan_kernel, f64 on the f32 targets, mirrored in
//       ops/kde.k7_plan): tile tau holds the 32 targets [32 tau, 32 tau +
//       32); its candidate cells are [floor((tmin - hw - t0) inv_c) - 2,
//       floor((tmax + hw - t0) inv_c) + 2] (two cells of margin for the
//       f32 cell arithmetic), clamped; a tile with a NaN target, or a
//       plan whose hw is not finite and > 0, takes every bucket but NaN's
//       (dense: the same kernels, computing every term).  Its sources are
//       one contiguous range [S_lo, S_hi) of the bucketed array.
//    4. Gather (k7_gather_kernel): the bucketed array is cut at multiples
//       of kGChunk = 1024 into chunks; an item is (tile, chunk meeting its
//       range), numbered tile by tile.  A warp takes items i, i + W, ...
//       (W warps resident on the card); its lane l owns target 32 tau + l
//       in a register.  An item's 2 stages of 512 sources are copied into
//       the warp's shared memory by the TMA unit (cp.async.bulk, two
//       buffers on two mbarriers: the next stage streams in while the
//       warp computes this one) and read as float4 broadcasts.  The
//       lane adds the item's terms in runs of 16 sources (aligned in the
//       bucketed array, cut to the tile's range) in f32 from 0.0f, each
//       run's sum to an f64 item sum from 0.0 in order.
//    5. Finish (k7_finish_kernel): target m adds its tile's item sums j,
//       for j = q mod 32 in 32 f64 sums from 0.0 in order, then those 32
//       from 0.0 in order; NaN where a source is NaN.
//    The order is fixed by n, the targets and neg_inv_h2 (not by the
//    card), no atomics anywhere: two launches on the same inputs are
//    bit-equal.  tests/test_torch_auto_kernels.py models it in numpy.
// K8 gt_gmm_em replaces garlic_tpu/parallel/engine.py:309
//    fit_gmm_sharded (its lax.while_loop, :370-397), which a single
//    device reaches through garlic_tpu/ops/gmm.py:111 _device_mesh_1x1:
//    the f64 GMM-EM of GMM::update (src/gmm.cpp:276-331) in the op order
//    of ops/gmm._em_stats: for each point x and component k
//    logp_k = log w_k + ((-0.5 log 2 pi - 0.5 log var_k)
//                        - (d * d) / (2 var_k)),  d = x - mu_k,
//    tmp = lmax + log(sum_k exp(logp_k - lmax)) (lmax the largest logp_k,
//    NaN if any is), den = sum_k exp(logp_k - tmp), r_k = exp(logp_k -
//    tmp) / den; the sums s0_k = sum r_k, s1_k = sum x r_k, s2_k = sum
//    (x x) r_k and ll = sum tmp, packed [s0 (K), s1 (K), s2 (K), ll].
//    Stats mode (fit = 0): one E-step, the packed sums of these points.
//    Fit mode (fit = 1): the whole loop in one launch with fit_em's and
//    the while_loop's semantics (stop on |ll - last_ll| <= prec, on a
//    non-finite mu or var, or at max_iter; last_ll keeps its value on the
//    iteration that stops), out = [w (K), mu (K), var (K), ll,
//    iterations, done, finite].
//    What binds it is latency, iteration after iteration (N = 5,530 ROH,
//    K = 3, ~211 iterations at the bench shape): each point's chain of
//    f64 divisions, exps and a log, the reductions, and the step that
//    makes every block's totals.  Design:
//    * One fused pass a round of points: for K <= kEmG, G lanes share a
//      point (G a power of two up to K rounded up; em_fused), lane j its
//      components j, j + G, ...: each log-term computed once an
//      iteration and held in registers, lmax, the sums and den gathered
//      by shuffles in k order, so a point's chain of divisions, exps and
//      a log is split G ways and 4x the warps hide its latency.  Its 3K +
//      1 sums go into one fused block reduction (each value over the
//      warp's groups by the xor tree, the warps' by one warp a sum and
//      the shuffle tree).  Larger K (up to 2895) takes the components in
//      groups of kEmG, one lane a point: a first pass keeps each point's
//      tmp and den (shared memory, or the scratch where the points
//      stream), then each group recomputes its log-terms and reduces its
//      3 kEmG sums (ll with the first); no per-thread store holds K terms.
//    * One thread-block cluster (em_kernel<true>, cudaLaunchKernelEx):
//      up to 16 blocks of 1024 threads on neighbouring SMs.  Each block
//      publishes its partial sums in its shared memory; after
//      cluster.sync() one warp a sum reads every block's partial through
//      distributed shared memory (cluster.map_shared_rank, lane r rank
//      r), so every block holds the same totals, runs the same M-step
//      and stops on the same iteration; the partials are
//      double-buffered, so one cluster barrier an iteration suffices.
//      No grid barrier, no global partials.
//    * Points resident: a block loads its points [b per, b per + per)
//      into shared memory once; where they do not fit (em_shape),
//      threads read them from device memory (L2) every iteration.
//    * The grid (em_kernel<false>): the same pass over every SM (as many
//      blocks as the card holds at once, a cooperative launch), the
//      totals by a grid barrier and the blocks' partials in device
//      memory (one warp a sum, lanes over blocks, the shuffle tree).
//      em_auto_path takes the cluster only where every point runs at
//      once in it with all its lanes (N x 4 <= 16,384 at K = 3): on an
//      H100 a round of points at 4 lanes a point is what makes an
//      iteration short, and the cluster's 16 SMs hold too few lanes for
//      the bench's 5,530 ROH, where the grid takes 5.9 us an iteration
//      and the cluster at 2 lanes a point 6.9 (chip_smoke.py times both
//      at 5,530, 100,000 and 1,000,000 points).
//    * What an iteration costs (clock64 per phase on an H100, the
//      cluster at 1,383 points, 4 lanes a point): ~2.6 us the E-step
//      with its block reduction (one point's dependent f64 chain is most
//      of it), ~0.8 us the cluster barrier, ~0.5 us the ranks' sums,
//      ~0.7 us the M-step (its two logs in two warps at once).
//    * Stats mode is one launch: block 0 writes the packed sums.
//    Every step of the E- and M-step is an intrinsic (__ddiv_rn, never a
//    reciprocal multiply); log and exp are the functions torch's CUDA ops
//    call; the M-step's order is fit_em's.  The summation order is fixed
//    by N, K and the launch shape (em_shape: by N, K and the card), so
//    two launches are bit-equal.
//
// Bounds at the bench shapes: see chip_smoke.py (gauss_bound_ms,
// gauss_needed_bound_ms, em_bound_ms).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cfloat>
#include <climits>
#include <cmath>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
// a block's dynamic shared memory: the 227 KB a block may have, less
// room for the kernels' static shared memory
constexpr size_t kMaxSmem = 227 * 1024 - 1024;

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

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// lane 0 gets the warp's sum: offsets 16, 8, 4, 2, 1.
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __dadd_rn(v, __shfl_down_sync(kFull, v, off));
  return v;
}

// every lane gets the inclusive prefix sum of v over lanes 0..lane
__device__ __forceinline__ int warp_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += u;
  }
  return v;
}

// ---------------------------------------------------------------------------
// K7: the Gauss transform
// ---------------------------------------------------------------------------

constexpr int kMaxCells = 1024;              // cells of the bucket map
constexpr int kMaxB = kMaxCells + 3;         // buckets: under, cells, over, NaN
constexpr int kBWarps = 8;                   // warps of a bucketing block
constexpr int kBThreads = kBWarps * 32;
constexpr int kBWarpChunk = 1024;            // sources a warp buckets
constexpr int kBChunk = kBWarps * kBWarpChunk;  // sources a block buckets
constexpr int kBUnroll = 8;                  // loads a lane keeps in flight
constexpr int kTile = 32;                    // targets of a tile (a warp)
constexpr int kRun = 16;                     // sources of an f32 run
constexpr int kGStage = 512;                 // sources of a copy stage
constexpr int kGStages = 2;                  // stages of an item
constexpr int kGChunk = kGStage * kGStages;  // sources of an item
constexpr int kGWarps = 8;                   // warps of a gather block
constexpr int kScanThreads = 1024;
constexpr double kHalfWidth = 10.5;          // hw = 10.5 / sqrt(-nih2)
constexpr int kInfo = 4;                     // info's head: total items,
                                             // NaN sources, all dense, 0
static_assert(kBWarpChunk % (32 * kBUnroll) == 0, "whole load batches");
static_assert(kGStage % kRun == 0 && kRun % 4 == 0, "float4 runs");
static_assert(kGStage * 4 % 16 == 0, "bulk copies of 16-byte multiples");

struct K7Cells {
  float t0, inv_c;
  int nc;
  bool ok;
};

// The bucket map: ops/kde.k7_plan's cells, in the same IEEE operations.
__device__ __forceinline__ K7Cells k7_cells(const float* tgt, int M) {
  K7Cells c;
  c.nc = min(M - 1, kMaxCells);
  c.t0 = tgt[0];
  const double span = __dsub_rn((double)tgt[M - 1], (double)tgt[0]);
  const float inv = __double2float_rn(__ddiv_rn((double)c.nc, span));
  c.ok = M >= 2 && span > 0.0 && isfinite(inv) && inv > 0.0f;
  c.inv_c = c.ok ? inv : 0.0f;
  return c;
}

__device__ __forceinline__ int k7_bucket(float x, const K7Cells& c) {
  if (isnan(x)) return c.nc + 2;
  float u = floorf(__fmul_rn(__fsub_rn(x, c.t0), c.inv_c));
  u = fminf(fmaxf(u, -1.0f), (float)c.nc);  // a NaN u (inf * 0) is -1
  return (int)u + 1;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// The lanes whose bucket equals this lane's, from one ballot per bit of
// the bucket (bits: enough for every bucket and the -1 of an idle lane,
// whose low bits are all set and so match no bucket).
__device__ __forceinline__ unsigned same_bucket(int b, int bits) {
  unsigned peers = kFull;
  for (int i = 0; i < bits; ++i) {
    const bool on = (b >> i) & 1;
    const unsigned bal = __ballot_sync(kFull, on);
    peers &= on ? bal : ~bal;
  }
  return peers;
}

// One warp's sources [lo, hi), 32 at a time in index order, kBUnroll
// loads in flight: a step's lanes of one bucket (same_bucket) are counted
// by the lowest of them into hist (the warp's own row: one writer per
// bucket and step); with sorted, each source first goes to
// sorted[hist[b] + its rank among them], so hist must hold the warp's
// first place in each bucket.
__device__ __forceinline__ void k7_warp_buckets(
    const float* __restrict__ src, long long lo, long long hi,
    const K7Cells& c, int bits, int* hist, float* __restrict__ sorted) {
  const int lane = threadIdx.x & 31;
  for (long long base = lo; base < hi; base += 32 * kBUnroll) {
    float v[kBUnroll];
#pragma unroll
    for (int u = 0; u < kBUnroll; ++u) {
      const long long i = base + 32 * u + lane;
      v[u] = i < hi ? src[i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBUnroll; ++u) {
      const bool in = base + 32 * u + lane < hi;
      const int b = in ? k7_bucket(v[u], c) : -1;
      const unsigned peers = same_bucket(b, bits);
      if (sorted != nullptr) {
        if (in) sorted[hist[b] + __popc(peers & lanemask_lt())] = v[u];
        __syncwarp();
      }
      if (in && lane == __ffs(peers) - 1) hist[b] += __popc(peers);
      __syncwarp();
    }
  }
}

// Count: each warp's counts by bucket to wtab[warp][b] (warps numbered
// over the grid), the block's to table[b][blockIdx.x].
__global__ void __launch_bounds__(kBThreads)
    k7_count_kernel(const float* __restrict__ src, int n,
                    const float* __restrict__ tgt, int M,
                    int* __restrict__ table, int nblk,
                    int* __restrict__ wtab) {
  __shared__ int hist[kBWarps][kMaxB];
  const K7Cells c = k7_cells(tgt, M);
  const int B = c.nc + 3, bits = 32 - __clz(B);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int b = lane; b < B; b += 32) hist[warp][b] = 0;
  __syncwarp();
  const long long lo =
      (long long)blockIdx.x * kBChunk + (long long)warp * kBWarpChunk;
  k7_warp_buckets(src, lo, min((long long)n, lo + kBWarpChunk), c, bits,
                  hist[warp], nullptr);
  int* row = wtab + ((long long)blockIdx.x * kBWarps + warp) * B;
  for (int b = lane; b < B; b += 32) row[b] = hist[warp][b];
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += kBThreads) {
    int s = 0;
    for (int w = 0; w < kBWarps; ++w) s += hist[w][b];
    table[(long long)b * nblk + blockIdx.x] = s;
  }
}

// The table's rows (one warp a bucket) -> exclusive offsets in place,
// and each bucket's total to tot[b].
__global__ void __launch_bounds__(kBThreads)
    k7_rows_kernel(int* __restrict__ table, int nblk, int B,
                   int* __restrict__ tot) {
  const int r = blockIdx.x * kBWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= B) return;
  int* row = table + (long long)r * nblk;
  int carry = 0;
  for (int j0 = 0; j0 < nblk; j0 += 32 * kBUnroll) {
    int v[kBUnroll];
#pragma unroll
    for (int u = 0; u < kBUnroll; ++u) {
      const int j = j0 + 32 * u + lane;
      v[u] = j < nblk ? row[j] : 0;
    }
#pragma unroll
    for (int u = 0; u < kBUnroll; ++u) {
      const int j = j0 + 32 * u + lane;
      const int inc = warp_scan(v[u]);
      if (j < nblk) row[j] = carry + inc - v[u];
      carry += __shfl_sync(kFull, inc, 31);
    }
  }
  if (lane == 0) tot[r] = carry;
}

// Scatter: each source to sorted[start[b] + table[b][blk] (the scanned
// row) + the earlier warps' counts + its rank in its warp].
__global__ void __launch_bounds__(kBThreads)
    k7_scatter_kernel(const float* __restrict__ src, int n,
                      const float* __restrict__ tgt, int M,
                      const int* __restrict__ table, int nblk,
                      const int* __restrict__ wtab,
                      const int* __restrict__ start,
                      float* __restrict__ sorted) {
  __shared__ int hist[kBWarps][kMaxB];
  const K7Cells c = k7_cells(tgt, M);
  const int B = c.nc + 3, bits = 32 - __clz(B);
  const int warp = threadIdx.x >> 5;
  const int* rows = wtab + (long long)blockIdx.x * kBWarps * B;
  for (int b = threadIdx.x; b < B; b += kBThreads) {
    int p = start[b] + table[(long long)b * nblk + blockIdx.x];
    for (int w = 0; w < kBWarps; ++w) {
      hist[w][b] = p;
      p += rows[w * B + b];
    }
  }
  __syncthreads();
  const long long lo =
      (long long)blockIdx.x * kBChunk + (long long)warp * kBWarpChunk;
  k7_warp_buckets(src, lo, min((long long)n, lo + kBWarpChunk), c, bits,
                  hist[warp], sorted);
}

// The plan, in one block: the bucket totals (start[0..B), from
// k7_rows_kernel) -> bucket starts in place (start[B] = n); each tile's
// range and items (info[kInfo + 4 tau ..] = S_lo, S_hi, first item,
// items); info[0] = all items, info[1] = NaN sources, info[2] = 1 when
// every tile is dense.
__global__ void __launch_bounds__(kScanThreads)
    k7_plan_kernel(const float* __restrict__ tgt, int M, float nih2,
                   int* __restrict__ info) {
  __shared__ int s_dense;
  __shared__ int st[kMaxB + 1];
  const K7Cells c = k7_cells(tgt, M);
  const int B = c.nc + 3, tiles = (M + kTile - 1) / kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* tinfo = info + kInfo;
  int* start = tinfo + 4 * tiles;
  if (threadIdx.x == 0) s_dense = 1;
  for (int b = threadIdx.x; b < B; b += kScanThreads) st[b] = start[b];
  __syncthreads();
  if (warp == 0) {
    if (lane == 0) info[1] = st[B - 1];
    int carry = 0;
    for (int b0 = 0; b0 < B; b0 += 32) {
      const int b = b0 + lane;
      const int v = b < B ? st[b] : 0;
      const int inc = warp_scan(v);
      if (b < B) st[b] = carry + inc - v;
      carry += __shfl_sync(kFull, inc, 31);
    }
    if (lane == 0) st[B] = carry;  // n
  }
  __syncthreads();
  for (int b = threadIdx.x; b <= B; b += kScanThreads) start[b] = st[b];
  const double hw = __ddiv_rn(kHalfWidth, __dsqrt_rn(-(double)nih2));
  const bool all_dense = !c.ok || !(hw > 0.0) || !isfinite(hw);
  for (int tau = threadIdx.x; tau < tiles; tau += kScanThreads) {
    const int m0 = tau * kTile, m1 = min(M, m0 + kTile);
    double tmin = tgt[m0], tmax = tmin;
    bool nan = false;
    for (int m = m0; m < m1; ++m) {
      const double t = tgt[m];
      nan |= isnan(t);
      tmin = fmin(tmin, t);
      tmax = fmax(tmax, t);
    }
    const double lo =
        floor(__dmul_rn(__dsub_rn(__dsub_rn(tmin, hw), (double)c.t0),
                        (double)c.inv_c)) - 2.0;
    const double hi =
        floor(__dmul_rn(__dsub_rn(__dadd_rn(tmax, hw), (double)c.t0),
                        (double)c.inv_c)) + 2.0;
    int blo = 0, bhi = c.nc + 1;
    if (!all_dense && !nan && isfinite(lo) && isfinite(hi)) {
      blo = (int)fmin(fmax(lo, -1.0), (double)c.nc) + 1;
      bhi = (int)fmin(fmax(hi, -1.0), (double)c.nc) + 1;
    }
    if (blo != 0 || bhi != c.nc + 1) s_dense = 0;
    const int s_lo = st[blo], s_hi = st[bhi + 1];
    tinfo[4 * tau] = s_lo;
    tinfo[4 * tau + 1] = s_hi;
    tinfo[4 * tau + 3] =
        s_hi > s_lo ? (s_hi - 1) / kGChunk - s_lo / kGChunk + 1 : 0;
  }
  __syncthreads();
  if (warp == 0) {
    int carry = 0;
    for (int t0 = 0; t0 < tiles; t0 += 32) {
      const int tau = t0 + lane;
      const int v = tau < tiles ? tinfo[4 * tau + 3] : 0;
      const int inc = warp_scan(v);
      if (tau < tiles) tinfo[4 * tau + 2] = carry + inc - v;
      carry += __shfl_sync(kFull, inc, 31);
    }
    if (lane == 0) {
      info[0] = carry;
      info[2] = s_dense;
      info[3] = 0;
    }
  }
}

__device__ __forceinline__ float gauss_term(float x, float t, float nih2) {
  const float d = __fsub_rn(x, t);
  return expf(__fmul_rn(__fmul_rn(d, d), nih2));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(a)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One thread: the TMA unit copies `bytes` from src (device memory) to dst
// (shared memory), both 16-byte aligned, and completes the barrier's
// phase when they have landed.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(d),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

// Waits until the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(b),
      "r"(parity)
      : "memory");
}

// The tile whose items hold item i (binary search over first items).
__device__ __forceinline__ int k7_tile_of(const int* tinfo, int tiles,
                                          int i) {
  int a = 0, z = tiles - 1;
  while (a < z) {
    const int mid = (a + z + 1) >> 1;
    if (__ldg(tinfo + 4 * mid + 2) <= i) a = mid; else z = mid - 1;
  }
  return a;
}

struct K7Item {
  int tau, s_lo, s_hi;
  long long base;  // the item's first position in the bucketed array
};

__device__ __forceinline__ K7Item k7_item(const int* tinfo, int tiles,
                                          int i) {
  K7Item it;
  it.tau = k7_tile_of(tinfo, tiles, i);
  it.s_lo = __ldg(tinfo + 4 * it.tau);
  it.s_hi = __ldg(tinfo + 4 * it.tau + 1);
  const int k = it.s_lo / kGChunk + (i - __ldg(tinfo + 4 * it.tau + 2));
  it.base = (long long)k * kGChunk;
  return it;
}

__global__ void __launch_bounds__(kGWarps * 32)
    k7_gather_kernel(const float* __restrict__ sorted,
                     const float* __restrict__ tgt, int M, float nih2,
                     const int* __restrict__ info, int tiles,
                     double* __restrict__ part) {
  __shared__ __align__(128) float4 buf[kGWarps][2][kGStage / 4];
  __shared__ __align__(8) unsigned long long bar[kGWarps][2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* tinfo = info + kInfo;
  const int total = __ldg(info);
  const int wg = blockIdx.x * kGWarps + warp, nw = gridDim.x * kGWarps;
  const int mine = wg < total ? (total - 1 - wg) / nw + 1 : 0;
  const int nst = mine * kGStages;
  if (nst == 0) return;
  if (lane == 0) {
    mbar_init(&bar[warp][0]);
    mbar_init(&bar[warp][1]);
    const K7Item first = k7_item(tinfo, tiles, wg);
    bulk_load(buf[warp][0], sorted + first.base, kGStage * 4,
              &bar[warp][0]);
  }
  __syncwarp();
  K7Item it{};
  float t = 0.0f;
  double acc = 0.0;
  for (int s = 0; s < nst; ++s) {
    const int sub = s % kGStages;
    if (s + 1 < nst) {  // the next stage streams in while this one runs
      __syncwarp();     // (every lane is done with that buffer)
      if (lane == 0) {
        const int nsub = (s + 1) % kGStages;
        const K7Item nx = k7_item(tinfo, tiles, wg + ((s + 1) / kGStages)
                                                         * nw);
        bulk_load(buf[warp][(s + 1) & 1],
                  sorted + nx.base + (long long)nsub * kGStage,
                  kGStage * 4, &bar[warp][(s + 1) & 1]);
      }
    }
    if (sub == 0) {
      it = k7_item(tinfo, tiles, wg + (s / kGStages) * nw);
      t = __ldg(tgt + min(it.tau * kTile + lane, M - 1));
      acc = 0.0;
    }
    mbar_wait(&bar[warp][s & 1], (s >> 1) & 1);
    const float4* x4 = buf[warp][s & 1];
    const long long base = it.base + (long long)sub * kGStage;
#pragma unroll 1
    for (int r = 0; r < kGStage / kRun; ++r) {
      const long long rb = base + r * kRun;
      const int a = (int)max(0LL, it.s_lo - rb);
      const int z = (int)min((long long)kRun, it.s_hi - rb);
      if (a >= z) continue;
      float run = 0.0f;
      if (a == 0 && z == kRun) {
#pragma unroll
        for (int j = 0; j < kRun / 4; ++j) {
          const float4 x = x4[r * (kRun / 4) + j];  // a broadcast
          run = __fadd_rn(run, gauss_term(x.x, t, nih2));
          run = __fadd_rn(run, gauss_term(x.y, t, nih2));
          run = __fadd_rn(run, gauss_term(x.z, t, nih2));
          run = __fadd_rn(run, gauss_term(x.w, t, nih2));
        }
      } else {  // the run at an end of the tile's range
        const float* x1 = reinterpret_cast<const float*>(x4) + r * kRun;
        for (int j = a; j < z; ++j)
          run = __fadd_rn(run, gauss_term(x1[j], t, nih2));
      }
      acc = __dadd_rn(acc, (double)run);
    }
    if (sub == kGStages - 1)
      part[((long long)wg + (s / kGStages) * (long long)nw) * kTile + lane] =
          acc;
  }
}

// out[m] = the item sums of m's tile in 32 strided f64 sums, then those
// in order; NaN where a source is NaN.
__global__ void __launch_bounds__(1024)
    k7_finish_kernel(const double* __restrict__ part,
                     const int* __restrict__ info, int M,
                     double* __restrict__ out) {
  __shared__ double red[32][kTile + 1];
  const int tau = blockIdx.x, lane = threadIdx.x & 31,
            q = threadIdx.x >> 5;
  const int* tinfo = info + kInfo + 4 * tau;
  const int first = tinfo[2], cnt = tinfo[3];
  double s = 0.0;
#pragma unroll 8
  for (int j = q; j < cnt; j += 32)
    s = __dadd_rn(s, part[((long long)first + j) * kTile + lane]);
  red[q][lane] = s;
  __syncthreads();
  if (q == 0) {
    double v = 0.0;
    for (int p = 0; p < 32; ++p) v = __dadd_rn(v, red[p][lane]);
    const int m = tau * kTile + lane;
    if (m < M) out[m] = info[1] > 0 ? __longlong_as_double(0x7ff8000000000000LL)
                                    : v;
  }
}

// The skip's premise, checked on the card (chip_smoke.py): *bad = the
// bits of an f32 in [lo, lo + count) (as bit patterns) whose expf is not
// +0, any one of them; left as it was when there is none.
__global__ void expf_underflow_kernel(unsigned lo, unsigned count,
                                      unsigned* bad) {
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += gridDim.x * blockDim.x)
    if (__float_as_uint(expf(__uint_as_float(lo + i))) != 0u) *bad = lo + i;
}

// Warps of the gather kernel resident on the card (asked once per
// device).
cudaError_t gather_warps(int device, int* warps) {
  static int cached[kDevices] = {};
  if (device >= 0 && device < kDevices && cached[device] > 0) {
    *warps = cached[device];
    return cudaSuccess;
  }
  int sms = 0, occ = 0;
  cudaError_t e = sm_count(device, &sms);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, k7_gather_kernel, kGWarps * 32, 0);
  if (e != cudaSuccess) return e;
  *warps = std::max(occ, 1) * sms * kGWarps;
  if (device >= 0 && device < kDevices) cached[device] = *warps;
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// K8: the GMM-EM
// ---------------------------------------------------------------------------

constexpr int kEmThreads = 1024;
constexpr int kEmWarps = kEmThreads / 32;
constexpr int kEmG = 4;              // components held in registers
constexpr int kEmE = 3 * kEmG + 1;   // a group's packed sums (+ ll)
constexpr int kEmMaxCluster = 16;  // <= kEmWarps (the gather's warps)

struct EmArgs {
  const double* x;    // [N] points
  const double* w;    // [K] parameters (fit mode: the initial ones)
  const double* mu;
  const double* var;
  double* scratch;    // grid: [2][kEmE][blocks] partials; then [2 N]
                      // (tmp, den) when K > kEmG and the points stream
  double* out;        // stats: [3 K + 1]; fit: [3 K + 4]
  double n;           // fit: the point count the weights divide by
  double prec;        // fit: the convergence threshold
  double log2pi_c;    // -0.5 log(2 pi), the plain version's double
  int N, K, per, max_iter, fit, resident;
  int G;              // K <= kEmG: lanes a point takes (em_fused)
};

// P = [log w (K), c (K), 2 var (K), mu (K)], c = log2pi_c - 0.5 log var:
// the factors of _em_stats's logp in its op order.
__device__ __forceinline__ void em_set_param(double* P, int K, int k,
                                             double w, double mu,
                                             double var, double log2pi_c) {
  P[k] = log(w);
  P[K + k] = __dsub_rn(log2pi_c, __dmul_rn(0.5, log(var)));
  P[2 * K + k] = __dmul_rn(2.0, var);
  P[3 * K + k] = mu;
}

__device__ __forceinline__ double em_logp(double x, const double* P, int K,
                                          int k) {
  const double d = __dsub_rn(x, P[3 * K + k]);
  return __dadd_rn(P[k], __dsub_rn(P[K + k],
                                   __ddiv_rn(__dmul_rn(d, d), P[2 * K + k])));
}

__device__ __forceinline__ double nan_max(double a, double l) {
  return (l > a || isnan(l)) ? l : a;  // torch's max keeps NaN
}

// acc[j] += r, acc[kEmG + j] += x r, acc[2 kEmG + j] += (x x) r
__device__ __forceinline__ void em_add(double (&acc)[kEmE], int j, double x,
                                       double r) {
  acc[j] = __dadd_rn(acc[j], r);
  acc[kEmG + j] = __dadd_rn(acc[kEmG + j], __dmul_rn(x, r));
  acc[2 * kEmG + j] =
      __dadd_rn(acc[2 * kEmG + j], __dmul_rn(__dmul_rn(x, x), r));
}

// a group's packed sum e is live: a component of the group, or ll
__device__ __forceinline__ bool em_live(int e, int kk, bool ll) {
  return e == kEmE - 1 ? ll : (e % kEmG) < kk;
}

// red (shared, kEmWarps x kEmE, each warp's sums) -> bp[e] for the live
// e: warp e adds the warps' values by the shuffle tree.
__device__ __forceinline__ void em_warps_sum(const double* red, int kk,
                                             bool ll, double* bp) {
  const int lane = threadIdx.x & 31;
  for (int e = threadIdx.x >> 5; e < kEmE; e += kEmWarps) {
    if (!em_live(e, kk, ll)) continue;
    const double v = warp_sum(lane < kEmWarps ? red[lane * kEmE + e] : 0.0);
    if (lane == 0) bp[e] = v;
  }
}

// K <= kEmG, one fused pass: G lanes (a power of two, at most K rounded
// up) share a point, lane j its components j, j + G, ... (kEmG / G
// slots): each log-term computed once an iteration and held in
// registers; lmax, sum exp(. - lmax), tmp and den in the plain order
// (every lane gathers the K values in k order from their lanes); each
// component's r, x r, (x x) r into a[0..2][slot], tmp into ll (lane 0 of
// the group).  Then the block's sums into bp (shared, the packed
// layout): each value over the warp's groups by the xor tree, the warps
// by em_warps_sum.
template <int G>
__device__ __forceinline__ void em_fused(const double* xs, int cnt,
                                         const double* P, int K,
                                         double* red, double* bp) {
  constexpr int C = kEmG / G, slots = kEmThreads / G;
  const int j = threadIdx.x & (G - 1), slot = threadIdx.x / G;
  double a[3][C], ll = 0.0;
#pragma unroll
  for (int c = 0; c < C; ++c) a[0][c] = a[1][c] = a[2][c] = 0.0;
  for (int i0 = 0; i0 < cnt; i0 += slots) {  // every lane, every round
    const int i = i0 + slot;
    const bool on = i < cnt;
    const double x = on ? xs[i] : 0.0;
    double lp[C], e[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = j + c * G;
      lp[c] = k < K ? em_logp(x, P, K, k) : 0.0;
    }
    double lmax = __shfl_sync(kFull, lp[0], 0, G);
#pragma unroll
    for (int k = 1; k < kEmG; ++k)
      if (k < K) lmax = nan_max(lmax, __shfl_sync(kFull, lp[k / G], k % G, G));
#pragma unroll
    for (int c = 0; c < C; ++c)
      e[c] = j + c * G < K ? exp(__dsub_rn(lp[c], lmax)) : 0.0;
    double s = 0.0;
#pragma unroll
    for (int k = 0; k < kEmG; ++k)
      if (k < K) s = __dadd_rn(s, __shfl_sync(kFull, e[k / G], k % G, G));
    const double tmp = __dadd_rn(lmax, log(s));
#pragma unroll
    for (int c = 0; c < C; ++c)
      e[c] = j + c * G < K ? exp(__dsub_rn(lp[c], tmp)) : 0.0;
    double den = 0.0;
#pragma unroll
    for (int k = 0; k < kEmG; ++k)
      if (k < K) den = __dadd_rn(den, __shfl_sync(kFull, e[k / G], k % G, G));
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (on && j + c * G < K) {
        const double r = __ddiv_rn(e[c], den);
        a[0][c] = __dadd_rn(a[0][c], r);
        a[1][c] = __dadd_rn(a[1][c], __dmul_rn(x, r));
        a[2][c] = __dadd_rn(a[2][c], __dmul_rn(__dmul_rn(x, x), r));
      }
    if (on && j == 0) ll = __dadd_rn(ll, tmp);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off >= G; off >>= 1) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (c * G < K) {
#pragma unroll
        for (int q = 0; q < 3; ++q)
          a[q][c] = __dadd_rn(a[q][c], __shfl_xor_sync(kFull, a[q][c], off));
      }
    ll = __dadd_rn(ll, __shfl_xor_sync(kFull, ll, off));
  }
  double* w = red + warp * kEmE;
  if (lane < G) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = lane + c * G;
      if (k < K) {
        w[k] = a[0][c];
        w[kEmG + k] = a[1][c];
        w[2 * kEmG + k] = a[2][c];
      }
    }
  }
  if (lane == 0) w[kEmE - 1] = ll;
  __syncthreads();
  em_warps_sum(red, K, true, bp);
}

// K > kEmG, group g: the components [g kEmG, g kEmG + kk) of this
// thread's points from each point's (tmp, den) in pt, into acc.
__device__ __forceinline__ void em_group(const double* xs, const double* pt,
                                         int cnt, const double* P, int K,
                                         int g, int kk,
                                         double (&acc)[kEmE]) {
#pragma unroll
  for (int e = 0; e < kEmE; ++e) acc[e] = 0.0;
  for (int i = threadIdx.x; i < cnt; i += kEmThreads) {
    const double x = xs[i];
    const double tmp = pt[2 * i], den = pt[2 * i + 1];
#pragma unroll
    for (int j = 0; j < kEmG; ++j)
      if (j < kk)
        em_add(acc, j, x,
               __ddiv_rn(exp(__dsub_rn(em_logp(x, P, K, g * kEmG + j), tmp)),
                         den));
  }
}

// K > kEmG: each point's tmp and den into pt (recomputing its K
// log-terms in each pass); returns this thread's sum of tmp.
__device__ double em_prepass(const double* xs, double* pt, int cnt,
                             const double* P, int K) {
  double ll = 0.0;
  for (int i = threadIdx.x; i < cnt; i += kEmThreads) {
    const double x = xs[i];
    double lmax = em_logp(x, P, K, 0);
    for (int k = 1; k < K; ++k) lmax = nan_max(lmax, em_logp(x, P, K, k));
    double s = 0.0;
    for (int k = 0; k < K; ++k)
      s = __dadd_rn(s, exp(__dsub_rn(em_logp(x, P, K, k), lmax)));
    const double tmp = __dadd_rn(lmax, log(s));
    double den = 0.0;
    for (int k = 0; k < K; ++k)
      den = __dadd_rn(den, exp(__dsub_rn(em_logp(x, P, K, k), tmp)));
    pt[2 * i] = tmp;
    pt[2 * i + 1] = den;
    ll = __dadd_rn(ll, tmp);
  }
  return ll;
}

// The block's sums of the live entries of acc (em_group) into bp: each
// warp by the shuffle tree, then the warps (em_warps_sum).
__device__ __forceinline__ void em_block_sum(double (&acc)[kEmE], int kk,
                                             bool ll, double* red,
                                             double* bp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < kEmE; ++e)
    if (em_live(e, kk, ll)) acc[e] = warp_sum(acc[e]);
  if (lane == 0) {
#pragma unroll
    for (int e = 0; e < kEmE; ++e) red[warp * kEmE + e] = acc[e];
  }
  __syncthreads();
  em_warps_sum(red, kk, ll, bp);
}

// em_kernel<true>: one cluster, partials exchanged in distributed shared
// memory; em_kernel<false>: every SM (cooperative launch), partials in
// device memory after a grid barrier.
template <bool kCluster>
__global__ void __launch_bounds__(kEmThreads, 1) em_kernel(EmArgs a) {
  extern __shared__ double sm[];
  const int K = a.K, ng = (K + kEmG - 1) / kEmG;
  const int b = blockIdx.x, nb = gridDim.x;
  const long long lo = (long long)b * a.per;
  const int cnt = (int)max(0LL, min((long long)a.N, lo + a.per) - lo);
  double* P = sm;                       // 4 K
  double* red = P + 4 * K;              // kEmWarps x kEmE
  double* part = red + kEmWarps * kEmE;  // cluster: [2][kEmE] published
  double* tot = part + (kCluster ? 2 * kEmE : 0);  // kEmE totals
  double* xs_s = tot + kEmE;            // resident: [per] points
  double* pt_s = xs_s + a.per;          // resident, K > kEmG: [2 per]
  double* gpart = a.scratch;            // grid: [2][kEmE][nb]
  double* gpt = a.scratch + (kCluster ? 0 : 2 * kEmE * nb);
  const double* xs = a.resident ? xs_s : a.x + lo;
  double* pt = a.resident ? pt_s : gpt + 2 * lo;
  for (int k = threadIdx.x; k < K; k += kEmThreads)
    em_set_param(P, K, k, a.w[k], a.mu[k], a.var[k], a.log2pi_c);
  if (a.resident)
    for (int i = threadIdx.x; i < cnt; i += kEmThreads) xs_s[i] = a.x[lo + i];
  __syncthreads();
  // the loop's state: every thread of every block holds the same values
  // (the same totals, in the same order)
  double last = -DBL_MAX, ll = -DBL_MAX;
  int it = 0, done = 0, bad = 0;
  const bool lead = b == 0;  // writes out (cluster rank 0 is block 0)
  int buf = 0;
  while (!done && it < (a.fit ? a.max_iter : 1)) {
    // a thread reads back only the (tmp, den) it wrote itself
    const double ll0 = K > kEmG ? em_prepass(xs, pt, cnt, P, K) : 0.0;
    for (int g = 0; g < ng; ++g) {
      const int kk = min(kEmG, K - g * kEmG);
      // this block's sums -> bp (shared) -> every block's totals (tot)
      double* bp = kCluster ? part + buf * kEmE : tot;
      if (K > kEmG) {
        double acc[kEmE];
        em_group(xs, pt, cnt, P, K, g, kk, acc);
        if (g == 0) acc[kEmE - 1] = ll0;
        em_block_sum(acc, kk, g == 0, red, bp);
      } else if (a.G == 1) {
        em_fused<1>(xs, cnt, P, K, red, bp);
      } else if (a.G == 2) {
        em_fused<2>(xs, cnt, P, K, red, bp);
      } else {
        em_fused<4>(xs, cnt, P, K, red, bp);
      }
      if constexpr (kCluster) {
        cg::cluster_group cl = cg::this_cluster();
        cl.sync();
        {  // warp e: lane r reads rank r's partial e, then the tree
          const int e = threadIdx.x >> 5, r = threadIdx.x & 31;
          if (e < kEmE && em_live(e, kk, g == 0)) {
            const double v =
                warp_sum(r < nb ? cl.map_shared_rank(bp, r)[e] : 0.0);
            if (r == 0) tot[e] = v;
          }
        }
      } else {
        double* gp = gpart + (long long)buf * kEmE * nb;
        __syncthreads();  // bp (= tot) complete
        if (threadIdx.x < kEmE && em_live(threadIdx.x, kk, g == 0))
          gp[(long long)threadIdx.x * nb + b] = tot[threadIdx.x];
        cg::this_grid().sync();
        const int lane = threadIdx.x & 31;
        for (int e = threadIdx.x >> 5; e < kEmE; e += kEmWarps) {
          if (!em_live(e, kk, g == 0)) continue;
          double v = 0.0;
          for (int q = lane; q < nb; q += 32)
            v = __dadd_rn(v, __ldcg(gp + (long long)e * nb + q));
          v = warp_sum(v);
          if (lane == 0) tot[e] = v;
        }
      }
      buf ^= 1;
      __syncthreads();
      if (g == 0) ll = tot[kEmE - 1];
      int badk = 0;
      const int j = threadIdx.x & 31, k = g * kEmG + j;
      if (j < kk && !a.fit && threadIdx.x < 32 && lead) {
        a.out[k] = tot[j];
        a.out[K + k] = tot[kEmG + j];
        a.out[2 * K + k] = tot[2 * kEmG + j];
        if (g == 0 && j == 0) a.out[3 * K] = ll;
      }
      if (j < kk && a.fit && threadIdx.x < 32) {  // warp 0: mu, var
        const double s0 = tot[j];
        const double mu = __ddiv_rn(tot[kEmG + j], s0);
        const double var = __dsub_rn(__ddiv_rn(tot[2 * kEmG + j], s0),
                                     __dmul_rn(mu, mu));
        badk = !(isfinite(mu) && isfinite(var));
        if (lead) {
          a.out[K + k] = mu;
          a.out[2 * K + k] = var;
        }
        P[K + k] = __dsub_rn(a.log2pi_c, __dmul_rn(0.5, log(var)));
        P[2 * K + k] = __dmul_rn(2.0, var);
        P[3 * K + k] = mu;
      } else if (j < kk && a.fit && threadIdx.x < 64) {  // warp 1: w
        const double w = __ddiv_rn(tot[j], a.n);
        if (lead) a.out[k] = w;
        P[k] = log(w);
      }
      bad |= __syncthreads_or(badk);  // also: P's new values are seen
    }
    if (a.fit) {
      done = fabs(__dsub_rn(ll, last)) <= a.prec || bad;
      if (!done) last = ll;
    }
    it += 1;
  }
  if (a.fit && lead && threadIdx.x == 0) {
    a.out[3 * K] = ll;
    a.out[3 * K + 1] = (double)it;
    a.out[3 * K + 2] = (double)done;
    a.out[3 * K + 3] = (double)!bad;
  }
  if constexpr (kCluster) cg::this_cluster().sync();  // partials read
}

// dynamic shared memory of em_kernel (doubles -> bytes)
size_t em_smem(int K, bool cluster, int per, bool resident) {
  size_t d = (size_t)4 * K + (size_t)kEmWarps * kEmE + (cluster ? 2 : 0) *
             kEmE + kEmE;
  if (resident) d += (size_t)per * (K > kEmG ? 3 : 1);
  return d * sizeof(double);
}

struct EmShape {
  int device, N, K, key;   // the key (key: the path asked for)
  int path;                // 1 cluster, 2 grid
  int nb, per, resident, G;
  size_t smem;
  long long scratch;       // doubles of scratch the launch needs
};

// Sets the kernels' attributes on a device once.
cudaError_t em_attributes(int device) {
  static bool done[kDevices] = {};
  if (device >= 0 && device < kDevices && done[device]) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      em_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kMaxSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(em_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kMaxSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(em_kernel<true>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e == cudaSuccess && device >= 0 && device < kDevices)
    done[device] = true;
  return e;
}

// Blocks in one cluster of em_kernel<true> the device can run with this
// shared memory: the largest power of two up to kEmMaxCluster it holds.
cudaError_t em_cluster_size(int want, size_t smem, int* size) {
  for (int c = kEmMaxCluster; c >= 1; c >>= 1) {
    if (c > want && c > 1) continue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)c);
    cfg.blockDim = dim3(kEmThreads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = (unsigned)c;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    int clusters = 0;
    cudaError_t e = cudaOccupancyMaxActiveClusters(
        &clusters, (const void*)em_kernel<true>, &cfg);
    if (e == cudaSuccess && clusters >= 1) {
      *size = c;
      return cudaSuccess;
    }
    cudaGetLastError();  // a refused size leaves no error behind
  }
  return cudaErrorInvalidConfiguration;
}

// The lanes a point takes (em_fused): the most, up to K rounded up to a
// power of two, that let every point of N run at once on `lanes`
// threads (one for K > kEmG).
int em_lanes(int N, int K, long long lanes) {
  int G = 1;
  while (K <= kEmG && G < K) G <<= 1;
  while (G > 1 && (long long)N * G > lanes) G >>= 1;
  return G;
}

// path 0: the cluster when every point runs at once in it with all its
// lanes (N x the most lanes a point can take <= the cluster's threads),
// else the grid (on an H100 one round of points at 4 lanes a point is
// what makes an iteration short: chip_smoke.py times both).
cudaError_t em_auto_path(int N, int K, int* path) {
  int cmax = 0;
  const cudaError_t e =
      em_cluster_size(kEmMaxCluster, em_smem(K, true, 0, false), &cmax);
  if (e != cudaSuccess) return e;
  const long long lanes = (long long)cmax * kEmThreads;
  *path = (long long)N * em_lanes(1, K, lanes) <= lanes ? 1 : 2;
  return cudaSuccess;
}

cudaError_t em_compute_shape(EmShape* s) {
  const int N = s->N, K = s->K;
  cudaError_t e = cudaSuccess;
  if (s->path == 1) {
    int cmax = 0;
    e = em_cluster_size(kEmMaxCluster, em_smem(K, true, 0, false), &cmax);
    if (e != cudaSuccess) return e;
    s->G = em_lanes(N, K, (long long)cmax * kEmThreads);
    const int want = (int)std::min<long long>(
        cmax, ceil_div((long long)N * s->G, kEmThreads));
    int want2 = 1;
    while (want2 < want) want2 <<= 1;
    e = em_cluster_size(want2, em_smem(K, true, 0, false), &s->nb);
    if (e != cudaSuccess) return e;
    s->per = (int)ceil_div(N, s->nb);
    s->resident = em_smem(K, true, s->per, true) <= kMaxSmem;
    s->smem = em_smem(K, true, s->per, s->resident);
    s->scratch = (!s->resident && K > kEmG) ? 2LL * N : 0;
    return cudaSuccess;
  }
  int sms = 0, occ = 0;
  e = sm_count(s->device, &sms);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, em_kernel<false>, kEmThreads, em_smem(K, false, 0, false));
  if (e != cudaSuccess) return e;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  s->G = em_lanes(N, K, (long long)occ * sms * kEmThreads);
  const long long blocks = std::min(
      ceil_div((long long)N * s->G, kEmThreads), (long long)occ * sms);
  s->per = (int)ceil_div(N, blocks);
  s->nb = (int)ceil_div(N, s->per);
  int occ_res = 0;
  const size_t res = em_smem(K, false, s->per, true);
  if (res <= kMaxSmem)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ_res, em_kernel<false>, kEmThreads, res);
  if (e != cudaSuccess) return e;
  s->resident = res <= kMaxSmem && (long long)occ_res * sms >= s->nb;
  s->smem = em_smem(K, false, s->per, s->resident);
  s->scratch = 2LL * kEmE * s->nb + ((!s->resident && K > kEmG) ? 2LL * N
                                                                  : 0);
  return cudaSuccess;
}

// The launch shape for (device, N, K, path), computed once and cached
// (path 0: em_auto_path's choice).
cudaError_t em_shape(int device, int N, int K, int path, EmShape* out) {
  static std::mutex mu;
  static EmShape cache[64];
  static int used = 0, next = 0;
  if (N < 1 || K < 1 || path < 0 || path > 2) return cudaErrorInvalidValue;
  if (em_smem(K, true, 0, false) > kMaxSmem) return cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const EmShape& c = cache[i];
    if (c.device == device && c.N == N && c.K == K && c.key == path) {
      *out = c;
      return cudaSuccess;
    }
  }
  EmShape s = {};
  s.device = device;
  s.N = N;
  s.K = K;
  s.key = s.path = path;
  cudaError_t e = em_attributes(device);
  if (e == cudaSuccess && path == 0) e = em_auto_path(N, K, &s.path);
  if (e == cudaSuccess) e = em_compute_shape(&s);
  if (e != cudaSuccess) return e;
  cache[next] = s;
  next = (next + 1) % 64;
  used = std::min(used + 1, 64);
  *out = s;
  return cudaSuccess;
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------

// K7: out (f64 [M]) = sum_j exp((x_j - t_m)^2 * neg_inv_h2) over src (f32
// [n]) at tgt (f32 [M]).  Scratch, sized by ops/kde._k7_sizes: sorted
// (f32 [n_pad], n_pad = n rounded up to kGChunk), table (i32 [B][nblk],
// nblk = ceil(n / kBChunk)), wtab (i32 [nblk kBWarps][B]), info (i32
// [kInfo + 4 tiles + B + 1]), part (f64 [tiles n_pad / kGChunk][kTile]).
// Six kernels on `stream`.
extern "C" int gt_gauss_sums(int device, const void* src, const void* tgt,
                             float neg_inv_h2, int n, int M, void* sorted,
                             int n_pad, void* table, int nblk, void* wtab,
                             void* info, void* part, void* out,
                             void* stream) {
  if (n < 1 || M < 1 || n_pad != (int)(ceil_div(n, kGChunk) * kGChunk) ||
      nblk != (int)ceil_div(n, kBChunk) ||
      (((unsigned long long)sorted) & 15))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  int warps = 0;
  if (e == cudaSuccess) e = gather_warps(device, &warps);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (int)ceil_div(M, kTile);
  const int B = std::min(M - 1, kMaxCells) + 3;
  const float* x = (const float*)src;
  const float* t = (const float*)tgt;
  int* tab = (int*)table;
  int* wt = (int*)wtab;
  int* inf = (int*)info;
  int* start = inf + kInfo + 4 * tiles;
  k7_count_kernel<<<nblk, kBThreads, 0, s>>>(x, n, t, M, tab, nblk, wt);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  k7_rows_kernel<<<(unsigned)ceil_div(B, kBWarps), kBThreads, 0, s>>>(
      tab, nblk, B, start);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  k7_plan_kernel<<<1, kScanThreads, 0, s>>>(t, M, neg_inv_h2, inf);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  k7_scatter_kernel<<<nblk, kBThreads, 0, s>>>(x, n, t, M, tab, nblk, wt,
                                               start, (float*)sorted);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int items = tiles * (n_pad / kGChunk);
  const int blocks = (int)std::min<long long>(
      ceil_div(warps, kGWarps), ceil_div(items, kGWarps));
  k7_gather_kernel<<<blocks, kGWarps * 32, 0, s>>>(
      (const float*)sorted, t, M, neg_inv_h2, inf, tiles, (double*)part);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  k7_finish_kernel<<<tiles, 1024, 0, s>>>((const double*)part, inf, M,
                                          (double*)out);
  return (int)cudaGetLastError();
}

// expf of the f32s with bit patterns [lo, lo + count), each compared
// with +0 (expf_underflow_kernel); bad: u32 [1].
extern "C" int gt_expf_underflow(int device, unsigned lo, unsigned count,
                                 void* bad, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  int sms = 0;
  if (e == cudaSuccess) e = sm_count(device, &sms);
  if (e != cudaSuccess) return (int)e;
  expf_underflow_kernel<<<sms * 8, 256, 0, (cudaStream_t)stream>>>(
      lo, count, (unsigned*)bad);
  return (int)cudaGetLastError();
}

// Doubles of scratch K8 needs for N points, K components on `device` by
// `path` (0 auto, 1 cluster, 2 grid); a negative CUDA error code on
// failure.
extern "C" long long gt_gmm_em_scratch(int device, int N, int K, int path) {
  EmShape sh;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = em_shape(device, N, K, path, &sh);
  return e == cudaSuccess ? sh.scratch : -(long long)e;
}

// The path K8 takes for N points and K components on `device` (1 the
// cluster, 2 the grid-wide launch), its blocks, whether its points are
// resident and the lanes a point takes: path + 4 blocks + 4096 resident +
// 8192 lanes; a negative CUDA error code on failure.
extern "C" int gt_gmm_em_path(int device, int N, int K, int path) {
  EmShape sh;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = em_shape(device, N, K, path, &sh);
  return e == cudaSuccess
             ? sh.path + 4 * sh.nb + 4096 * sh.resident + 8192 * sh.G
             : -(int)e;
}

// K8 over x (f64 [N]) with the parameters w, mu, var (f64 [K]): fit = 0
// writes the packed sums [3 K + 1] to out; fit = 1 runs the whole EM and
// writes [w, mu, var, ll, iterations, done, finite] ([3 K + 4]).
// scratch: f64, gt_gmm_em_scratch's count for (N, K, path) (may be null
// when that is 0).  One launch on `stream`.
extern "C" int gt_gmm_em(int device, const void* x, int N, int K, double n,
                         const void* w, const void* mu, const void* var,
                         void* scratch, void* out, int max_iter, double prec,
                         double log2pi_c, int fit, int path, void* stream) {
  EmShape sh;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = em_shape(device, N, K, path, &sh);
  if (e != cudaSuccess) return (int)e;
  if (sh.scratch > 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  EmArgs a;
  a.x = (const double*)x;
  a.w = (const double*)w;
  a.mu = (const double*)mu;
  a.var = (const double*)var;
  a.scratch = (double*)scratch;
  a.out = (double*)out;
  a.n = n;
  a.prec = prec;
  a.log2pi_c = log2pi_c;
  a.N = N;
  a.K = K;
  a.per = sh.per;
  a.max_iter = max_iter;
  a.fit = fit;
  a.resident = sh.resident;
  a.G = sh.G;
  const cudaStream_t s = (cudaStream_t)stream;
  if (sh.path == 1) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)sh.nb);
    cfg.blockDim = dim3(kEmThreads);
    cfg.dynamicSmemBytes = sh.smem;
    cfg.stream = s;
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = (unsigned)sh.nb;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, em_kernel<true>, a);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
  }
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)em_kernel<false>,
                                  dim3((unsigned)sh.nb), dim3(kEmThreads),
                                  args, sh.smem, s);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
