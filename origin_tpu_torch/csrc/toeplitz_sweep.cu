// GLR spectral matched-filter sweep for NVIDIA Hopper (sm_90a).
//
// Replaces three TPU kernels that compute the same function:
// - `_sweep_kernel` of origin_tpu/ops/pallas_sweep.py (entry
//   `toeplitz_sweep_pallas`, step 05), in float32 (`highest`), on the
//   cube's (Nz, S) layout (its bf16x3 form is csrc/sweep_bf16x3.cu);
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
// each profile's nonzero taps [start_k, start_k + len_k), in ascending j
// from 0.f, whatever the tiling.  Samples outside [0, Nz) read as zero,
// which is the zero padding of the Toeplitz form.
//
// Layout: threads on neighbouring spaxels.  In the cube's (Nz, S) layout
// every global load and store is coalesced and no transpose or padded
// copy is made.  A block copies a (TZ + reach - 1) x TS window of x and n
// into shared memory with cp.async (all copies in flight at once, no
// registers), plus all taps; every thread then runs RZ consecutive
// channels of one spaxel through all K profiles, keeping max / argmax /
// min in registers: the inputs are read from device memory once for every
// K, as in the TPU kernel.
//
// The spaxel-major (S, Nz) form runs the same core on the same staged
// window, transposed at both ends.  Its copies run with threads along z;
// its results go through shared memory: after the profile loop the block
// writes them into [spaxel][z] tiles over the staging planes and stores
// each spaxel's run of TZ channels with consecutive threads on consecutive
// z, full 128-byte lines but for a run's two ends.  Stored straight from
// the registers, each warp store touched 32 rows Nz floats apart, a
// sector each for 4 of its 32 bytes: 3.3 of its 4.6 ms at K=3 on an H100
// 80GB HBM3 at 700 W.  Its tile stays the cube layout's 64 channels: 128,
// which halves the halo of reach - 1 rows that every tile stages again,
// ran 4% slower at K=3 and level at K=20 (PERF.md).
//
// Register blocking along z: the RZ channels of a thread share their
// samples, so a tap step loads one tap (a broadcast) and one new sample
// into a sliding window of RZ registers and does RZ FMAs.  The tap loop
// is unrolled by RZ, so the window slides by register renaming; the
// `len_k % RZ` last taps run in a guarded tail (no zero taps are added:
// a zero tap times a NaN or infinite sample would turn a finite
// statistic into NaN).
//
// What bounds it on an H100: per voxel it moves 17 bytes (two float32
// inputs, two float32 outputs, one uint8 index), about 1.25 GB for a
// 3681 x 100 x 200 cube, or ~0.37 ms at 3.35 TB/s; it does 2 * sum_k len_k
// float32 FMAs per voxel (206 for the 3-profile dictionary, ~30 GFLOP on
// that cube, 0.45 ms at 67 TFLOP/s; ~1400 and ~207 GFLOP for the
// 20-profile one).  So it is bound by the
// FP32 pipes.  With one shared-memory load per FMA (the form before
// register blocking) it sat at its shared-memory ceiling, 11% of that
// bound.  Blocked, it loads 2 words per RZ FMAs, and its instruction
// slots go to the FMAs, to each span's window fill and tail, and to the
// IEEE sqrt and division and the max / argmax / min of each (voxel,
// profile), whose slow-path branches keep the compiler from interleaving
// them.  RZ = 8 at 64 registers keeps 32 warps on an SM; RZ = 16 (128
// registers, 16 warps) runs fewer instructions but ran slower, since the
// FMAs wait on shared-memory loads and on the division, which more warps
// hide.  On an H100 80GB HBM3 at 700 W that is 34% of the FP32 bound for
// the 3-profile dictionary and 44% for the 20-profile one (PERF.md); the
// spaxel-major form, whose int32 index adds 3 bytes a voxel, runs 0.17 ms
// behind it at both (the output tiles' round trip and barriers).
//
// Arithmetic: float32 FMAs, IEEE sqrtf and division (no fast math), the
// den <= 0 -> +inf guard, NaN propagation of jnp.maximum / jnp.minimum.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int TS = 32;        // spaxels per block (threadIdx.x)
constexpr int SROW = TS + 1;  // shared row stride: both layouts stage
                              // without bank conflicts
constexpr int RZ = 8;         // channels per thread
constexpr int WY = 8;         // threads along z (threadIdx.y)
constexpr int TZ = RZ * WY;   // channels per block
constexpr int NT = TS * WY;
constexpr int OROW = TZ + 1;  // spaxel-major output tile row: one spaxel's
                              // TZ channels, padded against bank conflicts

// the staging window and taps; in the spaxel-major form at least the three
// output tiles that alias them
size_t smem_bytes(int nprof, int reach, bool smaj) {
  size_t rows = TZ + reach - 1;
  size_t staging = (2 * rows * SROW + 2 * (size_t)nprof * reach)
                   * sizeof(float) + 2 * (size_t)nprof * sizeof(int);
  size_t tiles = 3 * (size_t)TS * OROW * sizeof(float);
  return smaj && tiles > staging ? tiles : staging;
}

// dst = *src (4 bytes, global to shared, asynchronous), or 0 unless `in`
__device__ __forceinline__ void copy4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src),
                  "r"(in ? 4 : 0));
}

// Tap u of the current group of RZ: sample u + RZ - 1 enters the window
// slot that sample u - 1 (the last one output 0 needed) leaves, then
// output t takes tap u times sample u + t.  With u a compile-time constant
// every slot index is one.
__device__ __forceinline__ void tap_step(int u, const float* tap,
                                         const float* smp, float (&w)[RZ],
                                         float (&acc)[RZ]) {
  w[(u + RZ - 1) % RZ] = smp[(u + RZ - 1) * SROW];
  const float a = tap[u];
#pragma unroll
  for (int t = 0; t < RZ; ++t) acc[t] = fmaf(a, w[(u + t) % RZ], acc[t]);
}

// acc[t] = sum_{j < len} tap[j] * smp[(j + t) * SROW] for t < RZ, each
// sum in ascending j from 0.f.  Slot (j + t) % RZ of the window holds
// sample j + t.
__device__ __forceinline__ void span_sums(const float* tap, const float* smp,
                                          int len, float (&acc)[RZ]) {
  float w[RZ];
#pragma unroll
  for (int t = 0; t < RZ; ++t) acc[t] = 0.f;
#pragma unroll
  for (int i = 0; i < RZ - 1; ++i) w[i] = smp[i * SROW];
  for (; len >= RZ; len -= RZ, tap += RZ, smp += RZ * SROW) {
#pragma unroll
    for (int u = 0; u < RZ; ++u) tap_step(u, tap, smp, w, acc);
  }
#pragma unroll
  for (int u = 0; u < RZ - 1; ++u)
    if (u < len) tap_step(u, tap, smp, w, acc);
}

// SMAJ: inputs and outputs spaxel-major, element (z, s) at s * nz + z;
// otherwise the cube's (Nz, S) layout, at z * s_total + s.
template <typename P, bool SMAJ>
__global__ void __launch_bounds__(NT, 4)
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
  float* xs = smem;                  // rows x SROW
  float* ns = xs + rows * SROW;      // rows x SROW
  float* tn = ns + rows * SROW;      // nprof x reach
  float* td = tn + nprof * reach;    // nprof x reach
  int* ts = reinterpret_cast<int*>(td + nprof * reach);
  int* tl = ts + nprof;

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TS + tx;
  const int sp = blockIdx.x * TS + tx;
  const int z0 = blockIdx.y * TZ;

  for (int i = tid; i < nprof * reach; i += NT) {
    tn[i] = taps_num[i];
    td[i] = taps_den[i];
  }
  for (int i = tid; i < nprof; i += NT) {
    ts[i] = tap_start[i];
    tl[i] = tap_len[i];
  }
  // row r of the window holds channel z0 - pad_left + r; the copies go
  // straight to shared memory, all in flight at once (threads along z in
  // the spaxel-major layout, along spaxels in the cube's)
  for (int e = tid; e < rows * TS; e += NT) {
    const int r = SMAJ ? e % rows : e / TS;
    const int c = SMAJ ? e / rows : e % TS;
    const int zi = z0 - pad_left + r;
    const int spc = blockIdx.x * TS + c;
    const bool in = zi >= 0 && zi < nz && spc < s;
    const size_t off = !in ? 0
                       : SMAJ ? (size_t)spc * nz + zi : (size_t)zi * s + spc;
    copy4(xs + r * SROW + c, x + off, in);
    copy4(ns + r * SROW + c, n + off, in);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const int zl = ty * RZ;
  // the spaxel-major epilogue has barriers: every thread stays to them and
  // runs the loop, those past the edges on the zero-filled samples (a loop
  // count that skipped them ran 7% slower at K=20)
  if (!SMAJ && (sp >= s || z0 + zl >= nz)) return;

  float best[RZ], low[RZ];
  int arg[RZ];
#pragma unroll
  for (int t = 0; t < RZ; ++t) {
    best[t] = -INFINITY;
    low[t] = INFINITY;
    arg[t] = 0;
  }
  for (int k = 0; k < nprof; ++k) {
    const int j0 = ts[k];
    const int len = tl[k];
    const int at = (zl + j0) * SROW + tx;
    float num[RZ], den[RZ];
    span_sums(tn + k * reach + j0, xs + at, len, num);
    span_sums(td + k * reach + j0, ns + at, len, den);
#pragma unroll
    for (int t = 0; t < RZ; ++t) {
      const float norm = (den[t] <= 0.f) ? INFINITY : sqrtf(den[t]);
      const float tv = num[t] / norm;
      if (tv > best[t]) arg[t] = k;                  // strict: first wins
      best[t] = (tv > best[t] || tv != tv) ? tv : best[t];  // NaN wins
      low[t] = (tv < low[t] || tv != tv) ? tv : low[t];
    }
  }
  if constexpr (SMAJ) {
    // the three [spaxel][z] output tiles alias the planes and the taps,
    // which every thread has finished reading at the first barrier
    float* ob = smem;
    float* ol = ob + TS * OROW;
    int* oa = reinterpret_cast<int*>(ol + TS * OROW);
    __syncthreads();
#pragma unroll
    for (int t = 0; t < RZ; ++t) {
      ob[tx * OROW + zl + t] = best[t];
      ol[tx * OROW + zl + t] = low[t];
      oa[tx * OROW + zl + t] = arg[t];
    }
    __syncthreads();
    for (int e = tid; e < TS * TZ; e += NT) {
      const int c = e / TZ;
      const int r = e % TZ;
      const int spc = blockIdx.x * TS + c;
      if (spc < s && z0 + r < nz) {
        const size_t off = (size_t)spc * nz + z0 + r;
        correl[off] = ob[c * OROW + r];
        profile[off] = static_cast<P>(oa[c * OROW + r]);
        cmin[off] = ol[c * OROW + r];
      }
    }
  } else {
#pragma unroll
    for (int t = 0; t < RZ; ++t) {
      const int z = z0 + zl + t;
      if (z < nz) {
        const size_t off = (size_t)z * s + sp;
        correl[off] = best[t];
        profile[off] = static_cast<P>(arg[t]);
        cmin[off] = low[t];
      }
    }
  }
}

template <typename P, bool SMAJ>
int launch(const void* x, const void* n, const void* tnum, const void* tden,
           const void* tstart, const void* tlen, void* correl, void* profile,
           void* cmin, int nz, int s, int nprof, int reach, int pad_left,
           void* stream) {
  const size_t smem = smem_bytes(nprof, reach, SMAJ);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<P, SMAJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 block(TS, WY);
  dim3 grid((s + TS - 1) / TS, (nz + TZ - 1) / TZ);
  sweep_kernel<P, SMAJ><<<grid, block, smem, (cudaStream_t)stream>>>(
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
// float32; tap_start / tap_len: (nprof,) int32.  x3 must be 0: the
// bf16x3 form is csrc/sweep_bf16x3.cu.  Returns the cudaError_t of the
// launch.
int toeplitz_sweep_launch(const void* x, const void* n, const void* tnum,
                          const void* tden, const void* tstart,
                          const void* tlen, void* correl, void* profile,
                          void* cmin, int nz, int s, int nprof, int reach,
                          int pad_left, int prof_bytes, int x3,
                          int spaxel_major, void* stream) {
#define SWEEP_ARGS x, n, tnum, tden, tstart, tlen, correl, profile, cmin, \
                   nz, s, nprof, reach, pad_left, stream
  if (x3) return (int)cudaErrorInvalidValue;
  if (spaxel_major) {
    if (prof_bytes != 4) return (int)cudaErrorInvalidValue;
    return launch<int32_t, true>(SWEEP_ARGS);
  }
  if (prof_bytes == 1) return launch<uint8_t, false>(SWEEP_ARGS);
  if (prof_bytes == 4) return launch<int32_t, false>(SWEEP_ARGS);
#undef SWEEP_ARGS
  return (int)cudaErrorInvalidValue;
}

const char* toeplitz_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
