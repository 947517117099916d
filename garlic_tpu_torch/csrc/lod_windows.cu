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
//
// Inputs of both: 2-bit genotype codes packed 4 per byte, little-endian
// lanes, code 3 = missing ([I, ceil(L/4)] u8, the layout of
// pallas_lod.pack_genotypes); the f32 LOD table [3, L] (genotype classes
// 0/1/2); the window-missing mask [nwin] u8.  nwin = L - W + 1 >= 1.
//
// Bound on the card.  Per genotype a kernel reads 1/4 B of codes (the
// table row, 12 B per locus, is shared by every individual and stays in
// L2) and writes 4 B per window (K1) or 3 B per SNP (K2): in device
// memory both are write-bound.  Design against that bound: one block
// owns (row, tile of 1024 columns), decodes its codes and table entries
// once into shared memory (the tile plus a W-1 halo; K2 a halo on each
// side), and each thread chains the W adds of its windows from shared
// memory, so device memory sees each packed byte once per block and each
// output element once, written by consecutive threads.  K2 keeps the
// window sums and the above flags in shared memory and derives the
// coverage count per SNP with a running integer sum, so the [I, nwin] f32
// window plane never reaches device memory.  What binds this simple
// design first is the chain's W shared-memory loads per window: on an
// H100 (700 W), K1 at 200 x 500,000, W=60 writes at about 13% of the
// memory peak while its loads run near the shared-memory rate.
//
// Numerics.  window_sum is the one routine both kernels use for every W:
// a left-to-right chain of f32 adds starting from 0.0f, the order of the
// JAX kernels' unrolled W <= 64 path (pallas_lod.py:72-76).  With the same
// f32 table the sums are bit-identical to interpret-mode Pallas for
// W <= 64, and K1 and K2 agree bit for bit at every W.  The chain holds
// only adds, so nvcc's FMA contraction cannot change its rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;         // threads per block
constexpr int kTile = 1024;           // window starts (K1) / SNPs (K2) per block
constexpr int kCountRun = 4;          // SNPs per thread in K2's running count
constexpr int kMaxGridRows = 65535;   // gridDim.y limit; blocks loop over rows
constexpr float kMissing = -9999.0f;  // garlic_tpu.core.types.MISSING

// LOD term of row prow at column c: the table entry of its genotype
// class; missing genotypes (code 3) and columns outside [0, L) add 0.
__device__ __forceinline__ float term_at(const uint8_t* __restrict__ prow,
                                         const float* __restrict__ table,
                                         int L, int c) {
  if (c < 0 || c >= L) return 0.0f;
  const int code = (prow[c >> 2] >> ((c & 3) << 1)) & 3;
  return code < 3 ? table[(size_t)code * L + c] : 0.0f;
}

// Terms of columns [c0, c0 + n) of one row into shared memory.
__device__ __forceinline__ void load_terms(const uint8_t* __restrict__ prow,
                                           const float* __restrict__ table,
                                           int L, int c0, int n, float* s) {
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    s[j] = term_at(prow, table, L, c0 + j);
}

// The window sum of both kernels: W f32 adds, left to right, from 0.0f.
__device__ __forceinline__ float window_sum(const float* s, int W) {
  float acc = 0.0f;
  for (int k = 0; k < W; ++k) acc += s[k];
  return acc;
}

__global__ void __launch_bounds__(kThreads)
lod_windows_kernel(const uint8_t* __restrict__ packed,
                   const float* __restrict__ table,
                   const uint8_t* __restrict__ miss, float* __restrict__ out,
                   int I, int L, int Lq, int W, int nwin) {
  extern __shared__ float s[];  // kTile + W - 1 terms
  const int col0 = blockIdx.x * kTile;
  const int ncol = min(kTile, nwin - col0);
  for (int i = blockIdx.y; i < I; i += gridDim.y) {
    load_terms(packed + (size_t)i * Lq, table, L, col0, ncol + W - 1, s);
    __syncthreads();
    float* orow = out + (size_t)i * nwin + col0;
    for (int j = threadIdx.x; j < ncol; j += blockDim.x)
      orow[j] = miss[col0 + j] ? kMissing : window_sum(s + j, W);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
covered_kernel(const uint8_t* __restrict__ packed,
               const float* __restrict__ table,
               const uint8_t* __restrict__ miss, uint8_t* __restrict__ cov,
               uint8_t* __restrict__ susw, uint8_t* __restrict__ above,
               int I, int L, int Lq, int W, int nwin, float cutoff,
               float thr, float delta) {
  // kTile + 2W - 2 terms, then kTile + W - 1 above flags
  extern __shared__ float s[];
  uint8_t* f = reinterpret_cast<uint8_t*>(s + kTile + 2 * W - 2);
  const int s0 = blockIdx.x * kTile;   // first SNP of the tile
  const int nsnp = min(kTile, L - s0);
  const int st0 = s0 - (W - 1);        // first window start the tile needs
  const int nst = nsnp + W - 1;        // window starts [st0, s0 + nsnp)
  for (int i = blockIdx.y; i < I; i += gridDim.y) {
    load_terms(packed + (size_t)i * Lq, table, L, st0, nst + W - 1, s);
    __syncthreads();
    uint8_t* arow = above + (size_t)i * nwin;
    uint8_t* srow = susw + (size_t)i * nwin;
    for (int j = threadIdx.x; j < nst; j += blockDim.x) {
      const int st = st0 + j;
      uint8_t a = 0, sw = 0;
      if (st >= 0 && st < nwin && !miss[st]) {
        const float v = window_sum(s + j, W);
        a = v >= cutoff;
        sw = fabsf(v - cutoff) < delta;
      }
      f[j] = a;
      if (st >= s0 && st < nwin) {  // the tile's own window starts
        arow[st] = a;
        srow[st] = sw;
      }
    }
    __syncthreads();
    // count at SNP s0 + q = sum of f[q .. q + W - 1]; each thread runs
    // the sum over kCountRun consecutive SNPs
    uint8_t* crow = cov + (size_t)i * L + s0;
    for (int q0 = threadIdx.x * kCountRun; q0 < nsnp;
         q0 += blockDim.x * kCountRun) {
      int cnt = 0;
      for (int k = 0; k < W; ++k) cnt += f[q0 + k];
      const int qe = min(q0 + kCountRun, nsnp);
      for (int q = q0; q < qe; ++q) {
        if (q > q0) cnt += f[q + W - 1] - f[q - 1];
        crow[q] = (float)cnt >= thr;
      }
    }
    __syncthreads();
  }
}

// Dynamic shared memory above the 48 KB default needs an opt-in.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// Each launcher makes `device` (the tensors' CUDA device) current for
// this library's runtime, enqueues one kernel on `stream` (PyTorch's
// current stream of that device) and returns cudaGetLastError(): a
// refused launch never runs and a later synchronize would not report it.

extern "C" int gt_lod_windows(int device, const void* packed,
                              const void* table, const void* miss, void* out,
                              int I, int L, int Lq, int W, void* stream) {
  const int nwin = L - W + 1;
  if (I < 1 || nwin < 1 || W < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)(kTile + W - 1) * sizeof(float);
  e = allow_smem(lod_windows_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((nwin + kTile - 1) / kTile, min(I, kMaxGridRows));
  lod_windows_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (const float*)table, (const uint8_t*)miss,
      (float*)out, I, L, Lq, W, nwin);
  return (int)cudaGetLastError();
}

extern "C" int gt_covered(int device, const void* packed, const void* table,
                          const void* miss, void* cov, void* susw,
                          void* above, int I, int L, int Lq, int W,
                          float cutoff, float thr, float delta,
                          void* stream) {
  const int nwin = L - W + 1;
  if (I < 1 || nwin < 1 || W < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)(kTile + 2 * W - 2) * sizeof(float) +
                      (size_t)(kTile + W - 1);
  e = allow_smem(covered_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((L + kTile - 1) / kTile, min(I, kMaxGridRows));
  covered_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (const float*)table, (const uint8_t*)miss,
      (uint8_t*)cov, (uint8_t*)susw, (uint8_t*)above, I, L, Lq, W, nwin,
      cutoff, thr, delta);
  return (int)cudaGetLastError();
}
