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
// One kernel body per pair, two term sources: the kernels are templates
// over a term loader, PackedTerms (K1/K2: 2-bit genotype codes packed 4
// per byte, little-endian lanes, code 3 = missing, the layout of
// pallas_lod.pack_genotypes, plus the f32 LOD table [3, L] of genotype
// classes 0/1/2) or PlaneTerms (K3/K4: one f32 row of the term plane).
// Every kernel also reads the window-missing mask [nwin] u8;
// nwin = L - W + 1 >= 1.  Columns outside [0, L) add 0 in both loaders,
// which stands in for the Pallas kernels' aligned halos and zero left
// halo.
//
// Bound on the card.  Per genotype K1/K2 read 1/4 B of codes (the table
// row, 12 B per locus, is shared by every individual and stays in L2);
// K3/K4 read 4 B of terms.  K1/K3 write 4 B per window, K2/K4 3 B per
// SNP: about 4 1/4 B per window for K1 and 8 B for K3.  Design against
// that: one block owns (row, tile of 1024 columns), loads its terms once
// into shared memory (the tile plus a W-1 halo; K2/K4 a halo on each
// side), with consecutive threads on consecutive columns, and each thread
// chains the W adds of its windows from shared memory, so device memory
// sees each input byte once per block and each output element once.
// K2/K4 keep the window sums and the above flags in shared memory and
// derive the coverage count per SNP with a running integer sum, so the
// [I, nwin] f32 window plane never reaches device memory.  What binds
// this simple design first is not device memory but the chain's W
// shared-memory loads per window: on an H100 80GB HBM3 (700 W), K1 at
// 200 x 500,000, W=60 writes at about 13% of the memory peak while its
// loads run near the shared-memory rate.  K3/K4 share that chain and it
// binds them too: on the same card and shape K3 moves its 800 MB in
// 0.87 ms, about 28% of the memory peak, and runs no slower than K1
// (0.90 ms), whose decode and table gather cost more than a coalesced
// row load.  The TGLS path pays for the plane outside the kernels as
// well: gl_terms_f32 writes it ([I, L] f32, 400 MB at 200 x 500,000)
// and K3/K4 read it back.
// Decoding the lut and computing the terms inside the kernel, so the
// plane is never stored, is later work: it needs the in-kernel log10f to
// round as torch's CUDA log10 does, or the tie band measured again.
//
// Numerics.  window_sum is the one routine all four kernels use for every
// W: a left-to-right chain of f32 adds starting from 0.0f, the order of
// the JAX kernels' unrolled W <= 64 path (pallas_lod.py:72-76).  With the
// same f32 terms the sums are bit-identical to interpret-mode Pallas for
// W <= 64, K1 and K2 (and K3 and K4) agree bit for bit at every W, and
// K3 equals K1 and K4 equals K2 whenever the plane holds K1's terms.  The
// chain holds only adds, so nvcc's FMA contraction cannot change its
// rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;         // threads per block
constexpr int kTile = 1024;           // window starts (K1/K3) / SNPs (K2/K4) per block
constexpr int kCountRun = 4;          // SNPs per thread in K2/K4's running count
constexpr int kMaxGridRows = 65535;   // gridDim.y limit; blocks loop over rows
constexpr float kMissing = -9999.0f;  // garlic_tpu.core.types.MISSING

// K1/K2 terms: the table entry of the genotype class at (row i, column c).
struct PackedTerms {
  const uint8_t* packed;  // [I, Lq]
  const float* table;     // [3, L]
  int L, Lq;

  __device__ __forceinline__ float at(int i, int c) const {
    if (c < 0 || c >= L) return 0.0f;
    const int code = (packed[(size_t)i * Lq + (c >> 2)] >> ((c & 3) << 1)) & 3;
    return code < 3 ? table[(size_t)code * L + c] : 0.0f;
  }
};

// K3/K4 terms: one entry of the f32 term plane [I, L].
struct PlaneTerms {
  const float* terms;
  int L;

  __device__ __forceinline__ float at(int i, int c) const {
    return (c < 0 || c >= L) ? 0.0f : terms[(size_t)i * L + c];
  }
};

// Terms of columns [c0, c0 + n) of row i into shared memory.
template <class Terms>
__device__ __forceinline__ void load_terms(const Terms& t, int i, int c0,
                                           int n, float* s) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) s[j] = t.at(i, c0 + j);
}

// The window sum of every kernel: W f32 adds, left to right, from 0.0f.
__device__ __forceinline__ float window_sum(const float* s, int W) {
  float acc = 0.0f;
  for (int k = 0; k < W; ++k) acc += s[k];
  return acc;
}

// K1 / K3
template <class Terms>
__global__ void __launch_bounds__(kThreads)
lod_windows_kernel(Terms t, const uint8_t* __restrict__ miss,
                   float* __restrict__ out, int I, int W, int nwin) {
  extern __shared__ float s[];  // kTile + W - 1 terms
  const int col0 = blockIdx.x * kTile;
  const int ncol = min(kTile, nwin - col0);
  for (int i = blockIdx.y; i < I; i += gridDim.y) {
    load_terms(t, i, col0, ncol + W - 1, s);
    __syncthreads();
    float* orow = out + (size_t)i * nwin + col0;
    for (int j = threadIdx.x; j < ncol; j += blockDim.x)
      orow[j] = miss[col0 + j] ? kMissing : window_sum(s + j, W);
    __syncthreads();
  }
}

// K2 / K4
template <class Terms>
__global__ void __launch_bounds__(kThreads)
covered_kernel(Terms t, const uint8_t* __restrict__ miss,
               uint8_t* __restrict__ cov, uint8_t* __restrict__ susw,
               uint8_t* __restrict__ above, int I, int L, int W, int nwin,
               float cutoff, float thr, float delta) {
  // kTile + 2W - 2 terms, then kTile + W - 1 above flags
  extern __shared__ float s[];
  uint8_t* f = reinterpret_cast<uint8_t*>(s + kTile + 2 * W - 2);
  const int s0 = blockIdx.x * kTile;   // first SNP of the tile
  const int nsnp = min(kTile, L - s0);
  const int st0 = s0 - (W - 1);        // first window start the tile needs
  const int nst = nsnp + W - 1;        // window starts [st0, s0 + nsnp)
  for (int i = blockIdx.y; i < I; i += gridDim.y) {
    load_terms(t, i, st0, nst + W - 1, s);
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
  if (e != cudaSuccess) return e;
  const size_t smem = (size_t)(kTile + W - 1) * sizeof(float);
  e = allow_smem(&lod_windows_kernel<Terms>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((nwin + kTile - 1) / kTile, min(I, kMaxGridRows));
  lod_windows_kernel<Terms><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      t, (const uint8_t*)miss, (float*)out, I, W, nwin);
  return cudaGetLastError();
}

template <class Terms>
cudaError_t launch_covered(int device, Terms t, const void* miss, void* cov,
                           void* susw, void* above, int I, int L, int W,
                           float cutoff, float thr, float delta,
                           void* stream) {
  const int nwin = L - W + 1;
  if (I < 1 || nwin < 1 || W < 1) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const size_t smem = (size_t)(kTile + 2 * W - 2) * sizeof(float) +
                      (size_t)(kTile + W - 1);
  e = allow_smem(&covered_kernel<Terms>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((L + kTile - 1) / kTile, min(I, kMaxGridRows));
  covered_kernel<Terms><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      t, (const uint8_t*)miss, (uint8_t*)cov, (uint8_t*)susw,
      (uint8_t*)above, I, L, W, nwin, cutoff, thr, delta);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gt_lod_windows(int device, const void* packed,
                              const void* table, const void* miss, void* out,
                              int I, int L, int Lq, int W, void* stream) {
  const PackedTerms t{(const uint8_t*)packed, (const float*)table, L, Lq};
  return (int)launch_lod_windows(device, t, miss, out, I, L, W, stream);
}

extern "C" int gt_covered(int device, const void* packed, const void* table,
                          const void* miss, void* cov, void* susw,
                          void* above, int I, int L, int Lq, int W,
                          float cutoff, float thr, float delta,
                          void* stream) {
  const PackedTerms t{(const uint8_t*)packed, (const float*)table, L, Lq};
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
