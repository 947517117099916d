// Automatic-run kernels for NVIDIA Hopper (sm_90a), bound to Python
// through a plain C interface (ctypes; see ops/_build.py, and ops/kde.py
// and ops/gmm.py, which also hold the plain PyTorch versions).
//
// K7 gt_gauss_sums replaces the XLA Gauss transform of
//    garlic_tpu/parallel/engine.py:250 gauss_transform_sharded (its scan
//    body, :283-285) and garlic_tpu/ops/kde.py:119 gauss_transform
//    (device=True): y[m] = sum_j exp(-(x_j - t_m)^2 / h^2) over f32
//    sources x [n] and f32 targets t [M], in f64 [M].  Each term is the
//    plain version's value bit for bit: __fsub_rn(x, t), __fmul_rn(d, d),
//    __fmul_rn(., neg_inv_h2), expf (every step an intrinsic, so nvcc
//    contracts nothing into an FMA; expf is the one torch's exp_ calls).
//    Summation order, fixed by n and the launch shape, with no atomics:
//    block b takes the sources [b c, b c + c) (c, a multiple of 4, from
//    n and the SMs' resident blocks: gauss_shape); for each target the
//    thread that owns it adds the block's terms in index order in f32
//    runs of 16 sources from 0.0f, each run's sum added to an f64 sum
//    from 0.0 in run order; a second kernel adds the blocks' f64 partials
//    from 0.0 in block order.  Two launches on the same inputs are
//    bit-equal.  The short f32 runs keep the sums closer to the exact
//    sums of the f32 terms than torch's f32 block sums are (runs of 256
//    were not, at n = 1000).
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
//    A point's K terms are computed again in each pass (the max, the
//    log-sum, den, then each k's sums), so any K runs with no register
//    array per thread.  The parameters (log w, the constant, 2 var, mu)
//    live in dynamic shared memory (32 bytes a component, 80 with the
//    sums: K <= 2895 on this card).
//    Stats mode (fit = 0): one E-step, the packed sums of these points.
//    Fit mode (fit = 1): the whole loop in one cooperative launch with
//    fit_em's and the while_loop's semantics (stop on |ll - last_ll| <=
//    prec, on a non-finite mu or var, or at max_iter; last_ll keeps its
//    value on the iteration that stops), out = [w (K), mu (K), var (K),
//    ll, iterations, done, finite].
//    Summation order, the same in both modes (fixed by N and the launch
//    shape, no atomics): block b takes the points [b p, b p + p) (em_shape:
//    as many blocks as 256-point groups, at most the resident ones), each
//    thread adds its points (thread t: b p + t, + 256, ...) in order from
//    0.0; a warp adds its lanes by the shuffle tree (offsets 16, 8, 4, 2,
//    1), then warp 0 the block's warps the same way; the blocks' partials
//    are added for each sum by one warp, lane l adding blocks l, l + 32,
//    ... in order, then the shuffle tree.  In fit mode every block adds
//    the partials after a grid barrier (cooperative_groups grid.sync) and
//    runs the same M-step on the same totals, so every block holds the
//    same parameters and stops on the same iteration; the partials are
//    double-buffered across iterations (a block writes buffer i & 1 only
//    after every block has read it two barriers back).  The iteration
//    count does not depend on timing.  Both modes add the E-step's sums
//    in the same order, but fit mode's M-step need not round as torch's
//    ops do, so a fit and a loop of stats-mode launches with torch's
//    M-step can part in the last bits.
//
// Bounds at the bench shapes (bench.py's panel, automatic run, W = 60).
// K7: n = 3,328,600 pooled windows x M = 512 targets = 1.70e9 terms.  Its
// bytes (13.3 MB of sources) take 4 us; each term is one exp on the
// special-function units (MUFU.EX2, 16 a clock per SM: 0.41 ms at 132 SMs
// and 1.98 GHz) and four f32 operations (0.20 ms at 128 lanes), plus the
// f32 arithmetic of expf's range reduction (about 8 instructions a term,
// so about 0.6 ms of f32 issue in all).  Design: the 512 targets in
// registers (2 a thread, 256 threads), the block's sources staged once in
// shared memory and read as float4 broadcasts (one 16-byte load feeds 8
// terms), every term computed once, no [n, M] temporary; partials in f64
// [blocks, M] (4 MB), added by a second kernel.
// K8: N = 5,530 ROH lengths, K = 3, about 211 iterations.  Its f64
// arithmetic is about 60 operations a point and iteration (7e7 in all: 4
// us at 64 f64 lanes per SM) and its bytes 44 KB: what binds it is the
// latency of each iteration (its chains of f64 exp, log and division per
// point, K + 1 block reductions, one grid barrier, the partials' sums),
// 211 times over.  Design: one launch for the whole fit, one 256-thread
// block per 256 points (22 at the bench shape), one host read per fit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cfloat>
#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int kDevices = 64;

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

// ---------------------------------------------------------------------------
// K7: the Gauss transform
// ---------------------------------------------------------------------------

constexpr int kGThreads = 256;                 // threads of a block
constexpr int kGPer = 2;                       // targets per thread
constexpr int kGTile = kGThreads * kGPer;      // targets per block
constexpr int kGRun = 16;                      // sources per f32 run
constexpr int kGMaxChunk = 4096;               // most sources per block
constexpr int kGMinChunk = 256;                // fewest, unless n is less
static_assert(kGRun % 4 == 0 && kGMaxChunk % kGRun == 0, "float4 runs");

__device__ __forceinline__ float gauss_term(float x, float t, float nih2) {
  const float d = __fsub_rn(x, t);
  return expf(__fmul_rn(__fmul_rn(d, d), nih2));
}

// part[b, m]: the f64 sum of block b's terms at target m.
__global__ void __launch_bounds__(kGThreads)
    gauss_partials_kernel(const float* __restrict__ src,
                          const float* __restrict__ tgt, float nih2,
                          long long n, int M, int chunk,
                          double* __restrict__ part) {
  __shared__ float4 s4[kGMaxChunk / 4];
  float* s = reinterpret_cast<float*>(s4);
  const long long start = (long long)blockIdx.x * chunk;
  const int cnt = (int)min((long long)chunk, n - start);
  for (int i = threadIdx.x; i < cnt; i += kGThreads) s[i] = src[start + i];
  __syncthreads();
  int m[kGPer];
  float t[kGPer];
  double acc[kGPer];
#pragma unroll
  for (int q = 0; q < kGPer; ++q) {
    m[q] = blockIdx.y * kGTile + q * kGThreads + threadIdx.x;
    t[q] = m[q] < M ? tgt[m[q]] : 0.0f;
    acc[q] = 0.0;
  }
  for (int r0 = 0; r0 < cnt; r0 += kGRun) {
    float run[kGPer];
#pragma unroll
    for (int q = 0; q < kGPer; ++q) run[q] = 0.0f;
    if (cnt - r0 >= kGRun) {
#pragma unroll
      for (int j = r0; j < r0 + kGRun; j += 4) {
        const float4 x = s4[j >> 2];  // one broadcast for 4 sources
#pragma unroll
        for (int q = 0; q < kGPer; ++q) {
          run[q] = __fadd_rn(run[q], gauss_term(x.x, t[q], nih2));
          run[q] = __fadd_rn(run[q], gauss_term(x.y, t[q], nih2));
          run[q] = __fadd_rn(run[q], gauss_term(x.z, t[q], nih2));
          run[q] = __fadd_rn(run[q], gauss_term(x.w, t[q], nih2));
        }
      }
    } else {  // the block's last, short run
      for (int j = r0; j < cnt; ++j) {
#pragma unroll
        for (int q = 0; q < kGPer; ++q)
          run[q] = __fadd_rn(run[q], gauss_term(s[j], t[q], nih2));
      }
    }
#pragma unroll
    for (int q = 0; q < kGPer; ++q)
      acc[q] = __dadd_rn(acc[q], (double)run[q]);
  }
#pragma unroll
  for (int q = 0; q < kGPer; ++q)
    if (m[q] < M) part[(long long)blockIdx.x * M + m[q]] = acc[q];
}

// out[m] = the blocks' partials at m, added from 0.0 in block order.
__global__ void gauss_finish_kernel(const double* __restrict__ part, int nb,
                                    int M, double* __restrict__ out) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  double s = 0.0;
#pragma unroll 8
  for (int b = 0; b < nb; ++b) s = __dadd_rn(s, part[(long long)b * M + m]);
  out[m] = s;
}

// (blocks, sources per block) of K7 for n sources on the current device:
// as many waves of the resident blocks as keep a block at most kGMaxChunk
// sources, at least kGMinChunk a block, chunks a multiple of 4.
cudaError_t gauss_shape(int device, long long n, int* nb, int* chunk) {
  if (n < 1) return cudaErrorInvalidValue;
  int sms = 0, occ = 0;
  cudaError_t e = sm_count(device, &sms);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, gauss_partials_kernel, kGThreads, 0);
  if (e != cudaSuccess) return e;
  const long long resident = (long long)std::max(occ, 1) * sms;
  const long long waves = ceil_div(n, resident * kGMaxChunk);
  const long long blocks =
      std::max(1LL, std::min(waves * resident, ceil_div(n, kGMinChunk)));
  const long long c = ceil_div(ceil_div(n, blocks), 4) * 4;
  const long long b = ceil_div(n, c);
  if (b > INT_MAX) return cudaErrorInvalidValue;
  *nb = (int)b;
  *chunk = (int)c;
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// K8: the GMM-EM
// ---------------------------------------------------------------------------

constexpr int kEmThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

struct EmArgs {
  const double* x;    // [N] points
  const double* w;    // [K] parameters (fit mode: the initial ones)
  const double* mu;
  const double* var;
  double* pt;         // [2 N] scratch: each point's tmp and den
  double* part;       // [buffers][3 K + 1][blocks] partial sums
  double* out;        // stats: [3 K + 1]; fit: [3 K + 4]
  double n;           // fit: the point count the weights divide by
  double prec;        // fit: the convergence threshold
  double log2pi_c;    // -0.5 log(2 pi), the plain version's double
  int N, K, per, max_iter;
};

// lane 0 gets the warp's sum: offsets 16, 8, 4, 2, 1.
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __dadd_rn(v, __shfl_down_sync(kFull, v, off));
  return v;
}

// Thread 0 gets the block's sums of v (red: V x 32 doubles of shared
// memory); every thread passes both barriers.
template <int V>
__device__ __forceinline__ void block_sum(double (&v)[V], double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = warp_sum(v[i]);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < V; ++i) red[i * 32 + warp] = v[i];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < V; ++i)
      v[i] = warp_sum(lane < nw ? red[i * 32 + lane] : 0.0);
  }
  __syncthreads();
}

// P = [log w (K), c (K), 2 var (K), mu (K)], c = log2pi_c - 0.5 log var:
// the factors of _em_stats's logp in its op order.
__device__ void em_set_params(double* P, const double* w, const double* mu,
                              const double* var, int K, double log2pi_c) {
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    P[k] = log(w[k]);
    P[K + k] = __dsub_rn(log2pi_c, __dmul_rn(0.5, log(var[k])));
    P[2 * K + k] = __dmul_rn(2.0, var[k]);
    P[3 * K + k] = mu[k];
  }
}

__device__ __forceinline__ double em_logp(double x, const double* P, int K,
                                          int k) {
  const double d = __dsub_rn(x, P[3 * K + k]);
  return __dadd_rn(P[k], __dsub_rn(P[K + k],
                                   __ddiv_rn(__dmul_rn(d, d), P[2 * K + k])));
}

// One E-step over block b's points into part ([3 K + 1][nb], this
// iteration's buffer).
__device__ void em_estep(const EmArgs& a, const double* P, double* red,
                         double* part, int b, int nb) {
  const int K = a.K;
  const long long lo = (long long)b * a.per;
  const long long hi = min((long long)a.N, lo + (long long)a.per);
  double ll[1] = {0.0};
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const double x = a.x[i];
    double lmax = em_logp(x, P, K, 0);
    for (int k = 1; k < K; ++k) {
      const double l = em_logp(x, P, K, k);
      lmax = (l > lmax || isnan(l)) ? l : lmax;  // torch's max keeps NaN
    }
    double s = 0.0;
    for (int k = 0; k < K; ++k)
      s = __dadd_rn(s, exp(__dsub_rn(em_logp(x, P, K, k), lmax)));
    const double tmp = __dadd_rn(lmax, log(s));
    double den = 0.0;
    for (int k = 0; k < K; ++k)
      den = __dadd_rn(den, exp(__dsub_rn(em_logp(x, P, K, k), tmp)));
    a.pt[2 * i] = tmp;
    a.pt[2 * i + 1] = den;
    ll[0] = __dadd_rn(ll[0], tmp);
  }
  block_sum<1>(ll, red);
  if (threadIdx.x == 0) part[(long long)(3 * K) * nb + b] = ll[0];
  for (int k = 0; k < K; ++k) {
    double v[3] = {0.0, 0.0, 0.0};
    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      const double x = a.x[i];
      const double r = __ddiv_rn(
          exp(__dsub_rn(em_logp(x, P, K, k), a.pt[2 * i])), a.pt[2 * i + 1]);
      v[0] = __dadd_rn(v[0], r);
      v[1] = __dadd_rn(v[1], __dmul_rn(x, r));
      v[2] = __dadd_rn(v[2], __dmul_rn(__dmul_rn(x, x), r));
    }
    block_sum<3>(v, red);
    if (threadIdx.x == 0) {
      part[(long long)k * nb + b] = v[0];
      part[(long long)(K + k) * nb + b] = v[1];
      part[(long long)(2 * K + k) * nb + b] = v[2];
    }
  }
}

// S[e] = the blocks' partials of sum e (one warp a sum: lane l adds
// blocks l, l + 32, ... in order, then the shuffle tree).  The partials
// are read past L1 (other blocks wrote them).  The caller synchronizes.
__device__ void em_totals(const double* part, int E, int nb, double* S) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int e = warp; e < E; e += nw) {
    double v = 0.0;
    for (int b = lane; b < nb; b += 32)
      v = __dadd_rn(v, __ldcg(part + (long long)e * nb + b));
    v = warp_sum(v);
    if (lane == 0) S[e] = v;
  }
}

size_t em_smem(int K) {  // P (4 K), S (3 K + 1), NW (3 K), red (3 x 32)
  return sizeof(double) * ((size_t)10 * K + 1 + 3 * 32);
}

__global__ void __launch_bounds__(kEmThreads) gmm_em_kernel(EmArgs a,
                                                            int fit) {
  extern __shared__ double sm[];
  const int K = a.K, E = 3 * K + 1;
  double* P = sm;
  double* S = P + 4 * K;
  double* NW = S + E;  // the M-step's w (K), mu (K), var (K)
  double* red = NW + 3 * K;
  __shared__ double s_last, s_ll;
  __shared__ int s_it, s_done, s_finite;
  const int b = blockIdx.x, nb = gridDim.x;
  em_set_params(P, a.w, a.mu, a.var, K, a.log2pi_c);
  __syncthreads();
  if (!fit) {
    em_estep(a, P, red, a.part, b, nb);
    return;
  }
  cg::grid_group grid = cg::this_grid();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    NW[k] = a.w[k];
    NW[K + k] = a.mu[k];
    NW[2 * K + k] = a.var[k];
  }
  if (threadIdx.x == 0) {
    s_last = s_ll = -DBL_MAX;
    s_it = s_done = 0;
    s_finite = 1;
  }
  __syncthreads();
  int buf = 0;
  while (!s_done && s_it < a.max_iter) {
    double* part = a.part + (long long)buf * E * nb;
    em_estep(a, P, red, part, b, nb);
    grid.sync();
    em_totals(part, E, nb, S);
    __syncthreads();
    int bad = 0;
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      const double s0 = S[k];
      const double mu = __ddiv_rn(S[K + k], s0);
      const double var = __dsub_rn(__ddiv_rn(S[2 * K + k], s0),
                                   __dmul_rn(mu, mu));
      NW[k] = __ddiv_rn(s0, a.n);
      NW[K + k] = mu;
      NW[2 * K + k] = var;
      bad |= !(isfinite(mu) && isfinite(var));
    }
    bad = __syncthreads_or(bad);
    if (threadIdx.x == 0) {
      const double ll = S[3 * K];
      const bool conv = fabs(__dsub_rn(ll, s_last)) <= a.prec;
      s_ll = ll;
      s_finite = !bad;
      s_done = conv || bad;
      if (!s_done) s_last = ll;
      s_it += 1;
    }
    em_set_params(P, NW, NW + K, NW + 2 * K, K, a.log2pi_c);
    __syncthreads();
    buf ^= 1;
  }
  if (b == 0) {
    for (int e = threadIdx.x; e < 3 * K; e += blockDim.x) a.out[e] = NW[e];
    if (threadIdx.x == 0) {
      a.out[3 * K] = s_ll;
      a.out[3 * K + 1] = (double)s_it;
      a.out[3 * K + 2] = (double)s_done;
      a.out[3 * K + 3] = (double)s_finite;
    }
  }
}

// Stats mode's second kernel: out[e] = the blocks' partials of sum e.
__global__ void em_finish_kernel(const double* __restrict__ part, int E,
                                 int nb, double* __restrict__ out) {
  em_totals(part, E, nb, out);
}

// (blocks, points per block, dynamic shared memory) of K8 for N points
// and K components on the current device: one block per kEmThreads
// points, at most the blocks the SMs hold at once (fit mode's grid
// barrier needs them all resident), the same in both modes.
cudaError_t em_shape(int device, int N, int K, int* nb, int* per,
                     size_t* smem) {
  if (N < 1 || K < 1) return cudaErrorInvalidValue;
  *smem = em_smem(K);
  if (*smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
  if (*smem > 48 * 1024)
    e = cudaFuncSetAttribute(gmm_em_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)*smem);
  int sms = 0, occ = 0;
  if (e == cudaSuccess) e = sm_count(device, &sms);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, gmm_em_kernel,
                                                      kEmThreads, *smem);
  if (e != cudaSuccess) return e;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  const long long blocks =
      std::min(ceil_div(N, kEmThreads), (long long)occ * sms);
  *per = (int)ceil_div(N, blocks);
  *nb = (int)ceil_div(N, *per);
  return cudaSuccess;
}

}  // namespace

// The number of f64 partial rows ([rows, M]) K7 writes for n sources on
// `device`; a negative CUDA error code on failure.
extern "C" int gt_gauss_blocks(int device, long long n) {
  int nb = 0, chunk = 0;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = gauss_shape(device, n, &nb, &chunk);
  return e == cudaSuccess ? nb : -(int)e;
}

// K7: out (f64 [M]) = sum_j exp((x_j - t_m)^2 * neg_inv_h2) over src (f32
// [n]) at tgt (f32 [M]); part: f64 [nb, M] scratch, nb from
// gt_gauss_blocks.  Two kernels on `stream`.
extern "C" int gt_gauss_sums(int device, const void* src, const void* tgt,
                             float neg_inv_h2, long long n, int M, int nb,
                             void* part, void* out, void* stream) {
  if (n < 1 || M < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  int want = 0, chunk = 0;
  if (e == cudaSuccess) e = gauss_shape(device, n, &want, &chunk);
  if (e != cudaSuccess) return (int)e;
  if (want != nb) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)nb, (unsigned)ceil_div(M, kGTile));
  gauss_partials_kernel<<<grid, kGThreads, 0, (cudaStream_t)stream>>>(
      (const float*)src, (const float*)tgt, neg_inv_h2, n, M, chunk,
      (double*)part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  gauss_finish_kernel<<<(unsigned)ceil_div(M, 128), 128, 0,
                        (cudaStream_t)stream>>>((const double*)part, nb, M,
                                                (double*)out);
  return (int)cudaGetLastError();
}

// The number of blocks K8 runs for N points and K components on
// `device` (its partials are [buffers][3 K + 1][blocks] f64, two buffers
// in fit mode); a negative CUDA error code on failure.
extern "C" int gt_gmm_em_blocks(int device, int N, int K) {
  int nb = 0, per = 0;
  size_t smem = 0;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = em_shape(device, N, K, &nb, &per, &smem);
  return e == cudaSuccess ? nb : -(int)e;
}

// K8 over x (f64 [N]) with the parameters w, mu, var (f64 [K]): fit = 0
// writes the packed sums [3 K + 1] to out; fit = 1 runs the whole EM
// (one cooperative launch) and writes [w, mu, var, ll, iterations, done,
// finite] ([3 K + 4]).  pt: f64 [2 N] scratch; part: f64 [(1 + fit) (3 K
// + 1) nb] scratch, nb from gt_gmm_em_blocks.
extern "C" int gt_gmm_em(int device, const void* x, int N, int K, double n,
                         const void* w, const void* mu, const void* var,
                         void* pt, void* part, void* out, int nb,
                         int max_iter, double prec, double log2pi_c, int fit,
                         void* stream) {
  cudaError_t e = cudaSetDevice(device);
  int want = 0, per = 0;
  size_t smem = 0;
  if (e == cudaSuccess) e = em_shape(device, N, K, &want, &per, &smem);
  if (e != cudaSuccess) return (int)e;
  if (want != nb) return (int)cudaErrorInvalidValue;
  EmArgs a;
  a.x = (const double*)x;
  a.w = (const double*)w;
  a.mu = (const double*)mu;
  a.var = (const double*)var;
  a.pt = (double*)pt;
  a.part = (double*)part;
  a.out = (double*)out;
  a.n = n;
  a.prec = prec;
  a.log2pi_c = log2pi_c;
  a.N = N;
  a.K = K;
  a.per = per;
  a.max_iter = max_iter;
  const cudaStream_t s = (cudaStream_t)stream;
  if (fit) {
    int coop = 0;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (e != cudaSuccess) return (int)e;
    if (!coop) return (int)cudaErrorNotSupported;
    int one = 1;
    void* args[] = {&a, &one};
    return (int)cudaLaunchCooperativeKernel((const void*)gmm_em_kernel,
                                            dim3((unsigned)nb),
                                            dim3(kEmThreads), args, smem, s);
  }
  gmm_em_kernel<<<(unsigned)nb, kEmThreads, smem, s>>>(a, 0);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  em_finish_kernel<<<1, kEmThreads, 0, s>>>((const double*)part, 3 * K + 1,
                                            nb, (double*)out);
  return (int)cudaGetLastError();
}
