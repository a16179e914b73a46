// GLR spectral sweep in bf16x3 for NVIDIA Hopper (sm_90a), as a banded
// matmul on the bf16 tensor cores.
//
// Replaces the bf16x3 form of the TPU kernel `_sweep_kernel` of
// origin_tpu/ops/pallas_sweep.py (entry `toeplitz_sweep_pallas` with
// precision "bf16x3", step 05 of the bf16x3 mode), which runs the sweep as
// banded Toeplitz matmuls on the TPU's matrix unit, each product as three
// bf16 passes (origin_tpu/ops/pallas_prec.py:make_dot).  For every spaxel
// s and channel z it computes, over the K profiles,
//
//     num_k = sum_j tnum_k[j] * x[z + j - pad_left, s]
//     den_k = sum_j tden_k[j] * n[z + j - pad_left, s]
//     t_k   = num_k / (den_k <= 0 ? +inf : sqrt(den_k))
//
// each product as hi.hi + hi.lo + lo.hi of the halves hi = bf16_rn(a),
// lo = bf16_rn(a - hi) of both operands, and writes max_k t_k, the first k
// that reaches it (strict `>`) and min_k t_k, NaN winning both, with IEEE
// sqrtf and division.  Samples outside [0, Nz) read as zero.
//
// Design.  A block owns 64 channels x 32 spaxels of the cube's (Nz, S)
// layout.  Over it num = T X: X is the window of x (row r: channel
// z0 - pad_left + r; columns: the spaxels) and T[t][r] = tnum[r - t] the
// profile's Toeplitz band.  In 16 x 16 blocks, T's block (ti, rj) depends
// only on d = rj - ti, D_k[d][a][b] = tnum_k[16 d + b - a], and is zero
// outside d_first_k <= d <= d_last_k (ops/sweep.py:toeplitz_blocks builds
// the blocks and bf16x3_blocks splits them, once per launch).  So the 16
// channels of group ti take only those few k-steps (3 to 5 for the
// dictionaries), not the whole window: each an m16n16k16 product on the
// tensor cores through wmma, bf16 operands, a float accumulator.
// - X is read once per block in its own layout, coalesced along spaxels
//   (float4 where S and the pointers allow), and each sample is split once
//   as it is staged, into bf16 hi and lo planes in shared memory that all
//   K profiles and the four channel groups reuse.
// - Profile k + 1's blocks are copied into shared memory (cp.async, two
//   buffers) while the warps work on profile k: one barrier per profile.
// - Each warp owns one 16 x 16 output tile.  num, den, the running max,
//   argmax (a float: k is exact) and min are accumulators of one shape,
//   which share one element map, so the statistic and the reductions run
//   element by element in registers.  At the end each warp stores its
//   tiles to shared memory and the block writes them coalesced.
// - The fragments move through the PTX wmma instructions with the shared
//   state space: through the nvcuda::wmma API nvcc loaded them with generic
//   4-byte loads, 1.5x slower at K=20.
//
// Sums: the three passes of every k-step go into one float accumulator
// per quantity, in ascending k-steps.  The tensor cores' own additions are
// not float32's; over at most 5 k-steps this stays within 3.4e-6 of the
// plain version on the 3681 x 100 x 200 field (PERF.md), and one
// accumulator kept 80 registers, where csrc/spatial_fsf.cu's scheme for
// deep sums (hi.hi per k-step added in float32) spilled.
//
// Footprint: a block multiplies its zero taps too, so a NaN or infinite
// sample of x or n makes NaN every channel of a 16-channel group whose
// blocks cover it.  For channel z of group G = z / 16 that is the samples
// [16 (G + d_first_k) - pad_left, 16 (G + d_last_k + 1) - pad_left) of
// each profile k: the reach of z and more, up to one block past the plain
// version's (W, block) window.  The engine zero-fills non-finite voxels
// before step 05, so its path never feeds such a sample.
//
// What bounds it on an H100: 17 bytes per voxel (0.37 ms at 3.35 TB/s
// for 3681 x 100 x 200) and, counted as the function's work, three bf16
// passes over the nonzero taps (0.63 ms at 989 TFLOP/s for the 20-profile
// dictionary).  The blocks' zero taps make the tensor-core work 2,304 /
// 15,552 flop a voxel for the 3- / 20-profile dictionary, and it runs on
// mma.sync-class instructions, not the faster wgmma.  Measured (NVIDIA
// H100 80GB HBM3, 700 W, PERF.md): 1.39 / 6.2 ms, from 3.35 / 21.1 for the
// CUDA-core form this replaces.  At K=20 the MMAs themselves take most of
// it (an HMMA.16816 every ~12.6 cycles a sub-partition; without the
// fragment loads it ran no faster), the epilogue of each (voxel,
// profile), its IEEE sqrt and division, max, argmax and min, ~1.5 ms and
// the per-profile barrier ~0.8 ms; at K=3
// the staging and the stores, ~1 ms, with the window read 2x through L2.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int WF = 16;            // fragment m = n = k: a channel group
constexpr int GZ = 4;             // channel groups per block
constexpr int GS = 2;             // 16-spaxel columns per block
constexpr int TZ = GZ * WF;       // channels per block
constexpr int TS = GS * WF;       // spaxels per block
constexpr int NT = GZ * GS * 32;  // one warp per 16 x 16 output tile
constexpr int LDX = TS + 8;       // padded row of a staged sample plane
constexpr int LDA = WF + 8;       // padded row of a staged block half
constexpr int LDC = TS + 4;       // padded row of an output tile (float)
constexpr int BLK = WF * WF;      // elements of a block half in memory
constexpr int SBLK = WF * LDA;    // elements of a staged block half
// wmma wants strides of 16 bytes and 32-byte aligned fragment bases; the
// paddings also keep its shared-memory loads free of bank conflicts
static_assert(LDX % 8 == 0 && LDA % 8 == 0 && LDC % 4 == 0, "wmma stride");
static_assert((WF * LDX * 2) % 32 == 0 && (SBLK * 2) % 32 == 0 &&
              (WF * LDC * 4) % 32 == 0, "wmma fragment alignment");

// rows of the staged window: group GZ - 1 reaches block GZ - 1 + nd - 1
__host__ __device__ inline int window_rows(int nd) {
  return WF * (GZ + nd - 1);
}

// Shared memory: the sample planes (the output tiles alias them at the
// end), then two profiles' blocks.
__host__ __device__ inline size_t bank_offset(int nd) {
  const size_t planes = 4 * (size_t)window_rows(nd) * LDX * sizeof(bf16);
  const size_t tiles = 3 * (size_t)TZ * LDC * sizeof(float);
  return ((planes > tiles ? planes : tiles) + 127) / 128 * 128;
}

__host__ __device__ inline size_t bank_elems(int nd) {
  return (size_t)nd * 4 * SBLK;
}

size_t smem_bytes(int nd) {
  return bank_offset(nd) + 2 * bank_elems(nd) * sizeof(bf16);
}

__device__ __forceinline__ unsigned smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The PTX wmma instructions, m16n16k16, bf16 operands and float
// accumulators, with the shared state space spelled out: through the
// nvcuda::wmma API nvcc loads the fragments with generic 4-byte loads.
// Every accumulator of this shape has one element map.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* p,
                                       int ld) {
  asm volatile(
      "wmma.load.a.sync.aligned.row.m16n16k16.shared.bf16 "
      "{%0, %1, %2, %3}, [%4], %5;\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem(p)), "r"(ld) : "memory");
}

__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* p,
                                       int ld) {
  asm volatile(
      "wmma.load.b.sync.aligned.row.m16n16k16.shared.bf16 "
      "{%0, %1, %2, %3}, [%4], %5;\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(smem(p)), "r"(ld) : "memory");
}

// d = a b + c
__device__ __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4],
                                    const uint32_t (&b)[4],
                                    const float (&c)[8]) {
  asm("wmma.mma.sync.aligned.row.row.m16n16k16.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, {%16, %17, %18, %19, %20, %21, %22, %23};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "r"(b[2]), "r"(b[3]), "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]),
        "f"(c[4]), "f"(c[5]), "f"(c[6]), "f"(c[7]));
}

__device__ __forceinline__ void store_d(float* p, const float (&d)[8],
                                        int ld) {
  asm volatile(
      "wmma.store.d.sync.aligned.row.m16n16k16.shared.f32 "
      "[%0], {%1, %2, %3, %4, %5, %6, %7, %8}, %9;\n"
      :: "r"(smem(p)), "f"(d[0]), "f"(d[1]), "f"(d[2]), "f"(d[3]),
         "f"(d[4]), "f"(d[5]), "f"(d[6]), "f"(d[7]), "r"(ld) : "memory");
}

__device__ __forceinline__ void fill(float (&d)[8], float v) {
#pragma unroll
  for (int q = 0; q < 8; ++q) d[q] = v;
}

// Stages rows [z0 - pad_left, z0 - pad_left + rows) x spaxels [s0, s0 + TS)
// of the (nz, s) cube `src` into the bf16 planes hi = bf16_rn(v) and
// lo = bf16_rn(v - hi), zero outside the cube.  VEC: float4 loads (s a
// multiple of 4 and `src` 16-byte aligned).
template <bool VEC>
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      bf16* hi, bf16* lo, int rows, int z0,
                                      int s0, int nz, int s, int pad_left) {
  if constexpr (VEC) {
    constexpr int C4 = TS / 4;
#pragma unroll 4
    for (int e = threadIdx.x; e < rows * C4; e += NT) {
      const int r = e / C4, c = e % C4 * 4;
      const int zi = z0 - pad_left + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (zi >= 0 && zi < nz && s0 + c < s)
        v = __ldg(reinterpret_cast<const float4*>(src + (size_t)zi * s + s0
                                                  + c));
      const __nv_bfloat162 h01 = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 h23 = __floats2bfloat162_rn(v.z, v.w);
      const float2 f01 = __bfloat1622float2(h01);
      const float2 f23 = __bfloat1622float2(h23);
      __nv_bfloat162* ph = reinterpret_cast<__nv_bfloat162*>(hi + r * LDX
                                                             + c);
      __nv_bfloat162* pl = reinterpret_cast<__nv_bfloat162*>(lo + r * LDX
                                                             + c);
      ph[0] = h01;
      ph[1] = h23;
      pl[0] = __floats2bfloat162_rn(v.x - f01.x, v.y - f01.y);
      pl[1] = __floats2bfloat162_rn(v.z - f23.x, v.w - f23.y);
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < rows * TS; e += NT) {
      const int r = e / TS, c = e % TS;
      const int zi = z0 - pad_left + r;
      const float v = (zi >= 0 && zi < nz && s0 + c < s)
                          ? __ldg(src + (size_t)zi * s + s0 + c) : 0.f;
      const bf16 h = __float2bfloat16_rn(v);
      hi[r * LDX + c] = h;
      lo[r * LDX + c] = __float2bfloat16_rn(v - __bfloat162float(h));
    }
  }
}

// Starts the copy of profile k's blocks d_first..d_last (4 halves each,
// 16 rows of 32 bytes) into `bank`, padded to rows of LDA, with 16-byte
// cp.async: it lands while the warps work on the previous profile.
__device__ __forceinline__ void fetch_blocks(bf16* bank,
                                             const bf16* __restrict__ blocks,
                                             int k, int nd, int d0, int d1) {
  const bf16* src = blocks + ((size_t)k * nd + d0) * 4 * BLK;
  const int chunks = (d1 - d0 + 1) * 4 * WF * 2;
  for (int e = threadIdx.x; e < chunks; e += NT) {
    const int h = e / (2 * WF), row = e / 2 % WF, c = e % 2 * 8;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem(bank + h * SBLK + row * LDA + c)),
                    "l"(src + h * BLK + row * WF + c));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// out = the bf16x3 product of one quantity over k-steps d0 + i, i < nk:
// the staged blocks (half q, the taps' hi, and q + 1, their lo, of block
// i of `bank`) times the sample planes (hi, lo) at window rows
// row0 + 16 (d0 + i), column col0.  The three passes hi.hi, lo.hi (the
// taps' lo) and hi.lo (the samples' lo) of every k-step go into one float
// accumulator, in ascending k-steps.
__device__ __forceinline__ void band_product(float (&out)[8],
                                             const bf16* bank, int q,
                                             const bf16* xh, const bf16* xl,
                                             int row0, int col0, int d0,
                                             int nk) {
  fill(out, 0.f);
  for (int i = 0; i < nk; ++i) {
    uint32_t ah[4], al[4], bh[4], bl[4];
    load_a(ah, bank + (4 * i + q) * SBLK, LDA);
    load_a(al, bank + (4 * i + q + 1) * SBLK, LDA);
    const int o = (row0 + (d0 + i) * WF) * LDX + col0;
    load_b(bh, xh + o, LDX);
    load_b(bl, xl + o, LDX);
    mma(out, ah, bh, out);
    mma(out, al, bh, out);
    mma(out, ah, bl, out);
  }
}

// blocks: (nprof, nd, 4, 16, 16) bf16, halves num hi, num lo, den hi,
// den lo; d_first / d_last: (nprof,) int32.  The grid's x is the channel
// tile (fastest, so that neighbours read their windows' overlap from L2
// at about the same time), y the spaxel tile.  Three blocks an SM (24
// warps) cap a thread at 80 registers, which this form fits unspilled;
// with 16 warps it ran 15-20% slower.
template <typename P, bool VEC>
__global__ void __launch_bounds__(NT, 3)
sweep_bf16x3_kernel(const float* __restrict__ x, const float* __restrict__ n,
                    const bf16* __restrict__ blocks,
                    const int* __restrict__ d_first,
                    const int* __restrict__ d_last,
                    float* __restrict__ correl, P* __restrict__ profile,
                    float* __restrict__ cmin, int nz, int s, int nprof,
                    int nd, int pad_left) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int rows = window_rows(nd);
  bf16* xh = reinterpret_cast<bf16*>(smem_raw);
  bf16* xl = xh + rows * LDX;
  bf16* nh = xl + rows * LDX;
  bf16* nl = nh + rows * LDX;
  bf16* bank = reinterpret_cast<bf16*>(smem_raw + bank_offset(nd));
  const int z0 = blockIdx.x * TZ;
  const int s0 = blockIdx.y * TS;
  fetch_blocks(bank, blocks, 0, nd, __ldg(d_first), __ldg(d_last));
  stage<VEC>(x, xh, xl, rows, z0, s0, nz, s, pad_left);
  stage<VEC>(n, nh, nl, rows, z0, s0, nz, s, pad_left);

  const int warp = threadIdx.x / 32;
  const int row0 = warp % GZ * WF, col0 = warp / GZ * WF;
  float best[8], low[8], arg[8];
  fill(best, -INFINITY);
  fill(low, INFINITY);
  fill(arg, 0.f);
  for (int k = 0; k < nprof; ++k) {
    const int d0 = __ldg(d_first + k), nk = __ldg(d_last + k) - d0 + 1;
    // profile k's blocks (and at k = 0 the planes) are in for every warp,
    // and every warp is done with profile k - 1, whose buffer the copy of
    // profile k + 1 takes
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (k + 1 < nprof)
      fetch_blocks(bank + ((k + 1) & 1) * bank_elems(nd), blocks, k + 1, nd,
                   __ldg(d_first + k + 1), __ldg(d_last + k + 1));
    const bf16* bk = bank + (k & 1) * bank_elems(nd);
    float num[8], den[8];
    band_product(num, bk, 0, xh, xl, row0, col0, d0, nk);
    band_product(den, bk, 2, nh, nl, row0, col0, d0, nk);
    const float kf = (float)k;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float dv = den[q];
      const float norm = (dv <= 0.f) ? INFINITY : sqrtf(dv);
      const float tv = num[q] / norm;
      const float b = best[q], l = low[q];
      if (tv > b) arg[q] = kf;                       // strict: first wins
      best[q] = (tv > b || tv != tv) ? tv : b;       // NaN wins
      low[q] = (tv < l || tv != tv) ? tv : l;
    }
  }

  __syncthreads();  // the output tiles alias the planes
  float* cb = reinterpret_cast<float*>(smem_raw);
  float* cl = cb + TZ * LDC;
  float* ca = cl + TZ * LDC;
  const int o = row0 * LDC + col0;
  store_d(cb + o, best, LDC);
  store_d(cl + o, low, LDC);
  store_d(ca + o, arg, LDC);
  __syncthreads();
  for (int e = threadIdx.x; e < TZ * TS; e += NT) {
    const int r = e / TS, c = e % TS;
    const int z = z0 + r, sp = s0 + c;
    if (z < nz && sp < s) {
      const size_t off = (size_t)z * s + sp;
      correl[off] = cb[r * LDC + c];
      cmin[off] = cl[r * LDC + c];
      profile[off] = static_cast<P>(static_cast<int>(ca[r * LDC + c]));
    }
  }
}

template <typename P, bool VEC>
int launch(const void* x, const void* n, const void* blocks,
           const void* d_first, const void* d_last, void* correl,
           void* profile, void* cmin, int nz, int s, int nprof, int nd,
           int pad_left, void* stream) {
  const size_t smem = smem_bytes(nd);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_bf16x3_kernel<P, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nz + TZ - 1) / TZ, (s + TS - 1) / TS);
  sweep_bf16x3_kernel<P, VEC><<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)n, (const bf16*)blocks,
      (const int*)d_first, (const int*)d_last, (float*)correl, (P*)profile,
      (float*)cmin, nz, s, nprof, nd, pad_left);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the sweep on `stream`; allocates nothing.  x, n, correl, cmin:
// (nz, s) float32; profile: (nz, s) uint8 (prof_bytes 1) or int32
// (prof_bytes 4); blocks: (nprof, nd, 4, 16, 16) bf16 (num hi, num lo,
// den hi, den lo of each block D_k[d]); d_first, d_last: (nprof,) int32
// in [0, nd).  Returns the cudaError_t of the launch.
int sweep_bf16x3_launch(const void* x, const void* n, const void* blocks,
                        const void* d_first, const void* d_last,
                        void* correl, void* profile, void* cmin, int nz,
                        int s, int nprof, int nd, int pad_left,
                        int prof_bytes, void* stream) {
  if (nz < 1 || s < 1 || nd < 1 || (s + TS - 1) / TS > 65535)
    return (int)cudaErrorInvalidValue;
  const bool vec = s % 4 == 0 && ((uintptr_t)x | (uintptr_t)n) % 16 == 0;
#define SWEEP_ARGS x, n, blocks, d_first, d_last, correl, profile, cmin, nz, \
                   s, nprof, nd, pad_left, stream
  if (prof_bytes == 1)
    return vec ? launch<uint8_t, true>(SWEEP_ARGS)
               : launch<uint8_t, false>(SWEEP_ARGS);
  if (prof_bytes == 4)
    return vec ? launch<int32_t, true>(SWEEP_ARGS)
               : launch<int32_t, false>(SWEEP_ARGS);
#undef SWEEP_ARGS
  return (int)cudaErrorInvalidValue;
}

const char* sweep_bf16x3_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
