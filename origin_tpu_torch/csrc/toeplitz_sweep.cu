// GLR spectral matched-filter sweep for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_sweep_kernel` of origin_tpu/ops/pallas_sweep.py
// (entry `toeplitz_sweep_pallas`).  For every spaxel s and channel z it
// computes, over the K profiles of the dictionary,
//
//     num_k = sum_j tnum_k[j] * x[z + j - pad_left, s]
//     den_k = sum_j tden_k[j] * n[z + j - pad_left, s]
//     t_k   = num_k / (den_k <= 0 ? +inf : sqrt(den_k))
//
// and writes max_k t_k, the first k that reaches it (strict `>`), and
// min_k t_k.  The taps are column 0 of the banded-Toeplitz banks
// (origin_tpu/ops/glr.py:pack_profiles_toeplitz), bit-identical to the
// bank entries; the j loop spans only each profile's true length
// [start_k, start_k + len_k).  Samples outside [0, Nz) read as zero, which
// is the zero padding of the Toeplitz form.
//
// Layout: the cube's own (Nz, S) layout, S = Ny*Nx spaxels, neighbouring
// threads on neighbouring spaxels, so every global load and store is
// coalesced and no transpose or padded copy is made.  A block stages a
// (TZ + reach - 1) x TS window of x and n plus all taps in shared memory,
// then each thread runs ZT channels of one spaxel through all K profiles,
// keeping max / argmax / min in registers: the inputs are read from
// device memory once for every K, as in the TPU kernel.
//
// What bounds it on an H100: per voxel it moves 17 bytes (two float32
// inputs, two float32 outputs, one uint8 index), about 1.25 GB for a
// 3681 x 100 x 200 cube, or ~0.4 ms at 3.35 TB/s; it does 2 * sum_k len_k
// float32 FMAs per voxel (206 for the 3-profile dictionary, ~30 GFLOP on
// that cube; ~1400 and ~207 GFLOP for the 20-profile one).  So it is bound
// by the FP32 pipes, and in this simple form by shared-memory loads (one
// per FMA: the tap is a broadcast, the sample is not reused from
// registers).  Register blocking along z is the next step.
//
// Arithmetic: float32 FMAs, IEEE sqrtf and division (no fast math), the
// den <= 0 -> +inf guard, NaN propagation of jnp.maximum / jnp.minimum.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int TS = 32;        // spaxels per block (threadIdx.x)
constexpr int WY = 8;         // threadIdx.y
constexpr int ZT = 16;        // channels per thread
constexpr int TZ = WY * ZT;   // channels per block

size_t smem_bytes(int nprof, int reach) {
  size_t rows = TZ + reach - 1;
  return (2 * rows * TS + 2 * (size_t)nprof * reach) * sizeof(float)
         + 2 * (size_t)nprof * sizeof(int);
}

template <typename P>
__global__ void __launch_bounds__(TS * WY)
sweep_kernel(const float* __restrict__ x, const float* __restrict__ n,
             const float* __restrict__ taps_num,
             const float* __restrict__ taps_den,
             const int* __restrict__ tap_start,
             const int* __restrict__ tap_len,
             float* __restrict__ correl, P* __restrict__ profile,
             float* __restrict__ cmin,
             int nz, int s, int nprof, int reach, int pad_left) {
  extern __shared__ float smem[];
  const int rows = TZ + reach - 1;
  float* xs = smem;                  // rows x TS
  float* ns = xs + rows * TS;        // rows x TS
  float* tn = ns + rows * TS;        // nprof x reach
  float* td = tn + nprof * reach;    // nprof x reach
  int* ts = reinterpret_cast<int*>(td + nprof * reach);
  int* tl = ts + nprof;

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TS + tx;
  const int sp = blockIdx.x * TS + tx;
  const int z0 = blockIdx.y * TZ;

  for (int i = tid; i < nprof * reach; i += TS * WY) {
    tn[i] = taps_num[i];
    td[i] = taps_den[i];
  }
  for (int i = tid; i < nprof; i += TS * WY) {
    ts[i] = tap_start[i];
    tl[i] = tap_len[i];
  }
  // row r of the window holds channel z0 - pad_left + r
  for (int r = ty; r < rows; r += WY) {
    const int zi = z0 - pad_left + r;
    float xv = 0.f, nv = 0.f;
    if (zi >= 0 && zi < nz && sp < s) {
      const size_t off = (size_t)zi * s + sp;
      xv = x[off];
      nv = n[off];
    }
    xs[r * TS + tx] = xv;
    ns[r * TS + tx] = nv;
  }
  __syncthreads();
  if (sp >= s) return;

  for (int t = 0; t < ZT; ++t) {
    const int zl = ty * ZT + t;
    const int z = z0 + zl;
    if (z >= nz) break;
    float best = -INFINITY;
    float low = INFINITY;
    int arg = 0;
    for (int k = 0; k < nprof; ++k) {
      const int j0 = ts[k];
      const int j1 = j0 + tl[k];
      const float* tnk = tn + k * reach;
      const float* tdk = td + k * reach;
      float num = 0.f, den = 0.f;
      for (int j = j0; j < j1; ++j) {
        num = fmaf(tnk[j], xs[(zl + j) * TS + tx], num);
        den = fmaf(tdk[j], ns[(zl + j) * TS + tx], den);
      }
      const float norm = (den <= 0.f) ? INFINITY : sqrtf(den);
      const float tv = num / norm;
      if (tv > best) arg = k;               // strict: first profile wins
      best = (tv > best || tv != tv) ? tv : best;  // NaN propagates
      low = (tv < low || tv != tv) ? tv : low;
    }
    const size_t off = (size_t)z * s + sp;
    correl[off] = best;
    profile[off] = static_cast<P>(arg);
    cmin[off] = low;
  }
}

template <typename P>
int launch(const void* x, const void* n, const void* tnum, const void* tden,
           const void* tstart, const void* tlen, void* correl, void* profile,
           void* cmin, int nz, int s, int nprof, int reach, int pad_left,
           void* stream) {
  const size_t smem = smem_bytes(nprof, reach);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 block(TS, WY);
  dim3 grid((s + TS - 1) / TS, (nz + TZ - 1) / TZ);
  sweep_kernel<P><<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)n, (const float*)tnum,
      (const float*)tden, (const int*)tstart, (const int*)tlen,
      (float*)correl, (P*)profile, (float*)cmin, nz, s, nprof, reach,
      pad_left);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the sweep on `stream`; allocates nothing.  x, n, correl, cmin:
// (nz, s) float32; profile: (nz, s) uint8 (prof_bytes 1) or int32
// (prof_bytes 4); taps: (nprof, reach) float32; tap_start / tap_len:
// (nprof,) int32.  Returns the cudaError_t of the launch.
int toeplitz_sweep_launch(const void* x, const void* n, const void* tnum,
                          const void* tden, const void* tstart,
                          const void* tlen, void* correl, void* profile,
                          void* cmin, int nz, int s, int nprof, int reach,
                          int pad_left, int prof_bytes, void* stream) {
  if (prof_bytes == 1)
    return launch<uint8_t>(x, n, tnum, tden, tstart, tlen, correl, profile,
                           cmin, nz, s, nprof, reach, pad_left, stream);
  if (prof_bytes == 4)
    return launch<int32_t>(x, n, tnum, tden, tstart, tlen, correl, profile,
                           cmin, nz, s, nprof, reach, pad_left, stream);
  return (int)cudaErrorInvalidValue;
}

const char* toeplitz_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
