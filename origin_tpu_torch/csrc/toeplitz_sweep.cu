// GLR spectral matched-filter sweep for NVIDIA Hopper (sm_90a).
//
// Replaces three TPU kernels that compute the same function:
// - `_sweep_kernel` of origin_tpu/ops/pallas_sweep.py (entry
//   `toeplitz_sweep_pallas`, step 05), in float32 (`highest`) and in its
//   `bf16x3` form, on the cube's (Nz, S) layout;
// - `_mf_kernel` and `_banded_kernel` of origin_tpu/ops/pallas_kernels.py
//   (entries `matched_filter_spectral` and `banded_matmul_spectral`), on
//   the spaxel-major (S, Nz) layout, float32, int32 indices.
//
// For every spaxel s and channel z it computes, over the K profiles,
//
//     num_k = sum_j tnum_k[j] * x[z + j - pad_left, s]
//     den_k = sum_j tden_k[j] * n[z + j - pad_left, s]
//     t_k   = num_k / (den_k <= 0 ? +inf : sqrt(den_k))
//
// and writes max_k t_k, the first k that reaches it (strict `>`), and
// min_k t_k.  The taps are one row per profile (for the Toeplitz banks,
// column 0, bit-identical to the bank entries); the j loop spans only
// each profile's nonzero taps [start_k, start_k + len_k).  Samples outside
// [0, Nz) read as zero, which is the zero padding of the Toeplitz form.
//
// Layout: threads on neighbouring spaxels.  In the cube's (Nz, S) layout
// every global load and store is coalesced and no transpose or padded
// copy is made; the spaxel-major layout stages its window with threads
// along z (coalesced) and stores uncoalesced.  A block stages a
// (TZ + reach - 1) x TS window of x and n plus all taps in shared memory,
// then each thread runs ZT channels of one spaxel through all K profiles,
// keeping max / argmax / min in registers: the inputs are read from
// device memory once for every K, as in the TPU kernel.
//
// bf16x3: each staged sample and each tap is split once, as it is
// staged, into hi = bf16_rn(a) and lo = bf16_rn(a - hi), packed into one
// 32-bit word (hi in the upper half: both halves are floats by a mask or a
// shift), so the window takes the shared memory of the float32 form.
// Each tap term is th*xh + th*xl + tl*xh in float32 FMAs, the three
// passes of origin_tpu/ops/pallas_prec.py (a bf16 x bf16 product is exact
// in float32).
//
// What bounds it on an H100: per voxel it moves 17 bytes (two float32
// inputs, two float32 outputs, one uint8 index), about 1.25 GB for a
// 3681 x 100 x 200 cube, or ~0.4 ms at 3.35 TB/s; it does 2 * sum_k len_k
// float32 FMAs per voxel (206 for the 3-profile dictionary, ~30 GFLOP on
// that cube; ~1400 and ~207 GFLOP for the 20-profile one), three times
// that in bf16x3.  So it is bound by the FP32 pipes, and in this simple
// form by shared-memory loads (one per FMA in float32: the tap is a
// broadcast, the sample is not reused from registers; bf16x3 adds the
// unpacking).  Register blocking along z is the next step.
//
// Arithmetic: float32 FMAs, IEEE sqrtf and division (no fast math), the
// den <= 0 -> +inf guard, NaN propagation of jnp.maximum / jnp.minimum.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int TS = 32;        // spaxels per block (threadIdx.x)
constexpr int WY = 8;         // threadIdx.y
constexpr int ZT = 16;        // channels per thread
constexpr int TZ = WY * ZT;   // channels per block
constexpr int NT = TS * WY;

size_t smem_bytes(int nprof, int reach) {
  size_t rows = TZ + reach - 1;
  return (2 * rows * TS + 2 * (size_t)nprof * reach) * sizeof(float)
         + 2 * (size_t)nprof * sizeof(int);
}

// hi in the upper 16 bits, lo in the lower: the bf16x3 split of v
__device__ __forceinline__ uint32_t pack_split(float v) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  const __nv_bfloat16 l = __float2bfloat16_rn(v - __bfloat162float(h));
  return ((uint32_t)__bfloat16_as_ushort(h) << 16)
         | (uint32_t)__bfloat16_as_ushort(l);
}

__device__ __forceinline__ float hi_of(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ float lo_of(uint32_t u) {
  return __uint_as_float(u << 16);
}

// One tap term: a float32 FMA, or the three bf16x3 passes.
template <bool X3>
__device__ __forceinline__ float term(float t, float v, float acc) {
  if (!X3) return fmaf(t, v, acc);
  const uint32_t tu = __float_as_uint(t), vu = __float_as_uint(v);
  acc = fmaf(hi_of(tu), hi_of(vu), acc);
  acc = fmaf(hi_of(tu), lo_of(vu), acc);
  return fmaf(lo_of(tu), hi_of(vu), acc);
}

template <bool X3>
__device__ __forceinline__ float stage(float v) {
  return X3 ? __uint_as_float(pack_split(v)) : v;
}

// SMAJ: inputs and outputs spaxel-major, element (z, s) at s * nz + z;
// otherwise the cube's (Nz, S) layout, at z * s_total + s.
template <typename P, bool X3, bool SMAJ>
__global__ void __launch_bounds__(NT)
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

  for (int i = tid; i < nprof * reach; i += NT) {
    tn[i] = stage<X3>(taps_num[i]);
    td[i] = stage<X3>(taps_den[i]);
  }
  for (int i = tid; i < nprof; i += NT) {
    ts[i] = tap_start[i];
    tl[i] = tap_len[i];
  }
  // row r of the window holds channel z0 - pad_left + r
  for (int e = tid; e < rows * TS; e += NT) {
    const int r = SMAJ ? e % rows : e / TS;
    const int c = SMAJ ? e / rows : e % TS;
    const int zi = z0 - pad_left + r;
    const int spc = blockIdx.x * TS + c;
    float xv = 0.f, nv = 0.f;
    if (zi >= 0 && zi < nz && spc < s) {
      const size_t off = SMAJ ? (size_t)spc * nz + zi : (size_t)zi * s + spc;
      xv = x[off];
      nv = n[off];
    }
    xs[r * TS + c] = stage<X3>(xv);
    ns[r * TS + c] = stage<X3>(nv);
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
        num = term<X3>(tnk[j], xs[(zl + j) * TS + tx], num);
        den = term<X3>(tdk[j], ns[(zl + j) * TS + tx], den);
      }
      const float norm = (den <= 0.f) ? INFINITY : sqrtf(den);
      const float tv = num / norm;
      if (tv > best) arg = k;               // strict: first profile wins
      best = (tv > best || tv != tv) ? tv : best;  // NaN propagates
      low = (tv < low || tv != tv) ? tv : low;
    }
    const size_t off = SMAJ ? (size_t)sp * nz + z : (size_t)z * s + sp;
    correl[off] = best;
    profile[off] = static_cast<P>(arg);
    cmin[off] = low;
  }
}

template <typename P, bool X3, bool SMAJ>
int launch(const void* x, const void* n, const void* tnum, const void* tden,
           const void* tstart, const void* tlen, void* correl, void* profile,
           void* cmin, int nz, int s, int nprof, int reach, int pad_left,
           void* stream) {
  const size_t smem = smem_bytes(nprof, reach);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<P, X3, SMAJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 block(TS, WY);
  dim3 grid((s + TS - 1) / TS, (nz + TZ - 1) / TZ);
  sweep_kernel<P, X3, SMAJ><<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)n, (const float*)tnum,
      (const float*)tden, (const int*)tstart, (const int*)tlen,
      (float*)correl, (P*)profile, (float*)cmin, nz, s, nprof, reach,
      pad_left);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the sweep on `stream`; allocates nothing.  x, n, correl, cmin:
// (nz, s) float32, or (s, nz) when spaxel_major; profile: the same shape,
// uint8 (prof_bytes 1) or int32 (prof_bytes 4); taps: (nprof, reach)
// float32; tap_start / tap_len: (nprof,) int32.  x3: 0 for `highest`,
// 1 for `bf16x3` (cube layout only).  Returns the cudaError_t of the
// launch.
int toeplitz_sweep_launch(const void* x, const void* n, const void* tnum,
                          const void* tden, const void* tstart,
                          const void* tlen, void* correl, void* profile,
                          void* cmin, int nz, int s, int nprof, int reach,
                          int pad_left, int prof_bytes, int x3,
                          int spaxel_major, void* stream) {
#define SWEEP_ARGS x, n, tnum, tden, tstart, tlen, correl, profile, cmin, \
                   nz, s, nprof, reach, pad_left, stream
  if (spaxel_major) {
    if (prof_bytes != 4 || x3) return (int)cudaErrorInvalidValue;
    return launch<int32_t, false, true>(SWEEP_ARGS);
  }
  if (prof_bytes == 1)
    return x3 ? launch<uint8_t, true, false>(SWEEP_ARGS)
              : launch<uint8_t, false, false>(SWEEP_ARGS);
  if (prof_bytes == 4)
    return x3 ? launch<int32_t, true, false>(SWEEP_ARGS)
              : launch<int32_t, false, false>(SWEEP_ARGS);
#undef SWEEP_ARGS
  return (int)cudaErrorInvalidValue;
}

const char* toeplitz_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
