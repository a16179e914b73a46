// GLR spatial FSF stage (DFT-by-matmul) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_spatial_kernel` of
// origin_tpu/ops/pallas_spatial.py (entries `_spatial_field_pallas` /
// `glr_spatial_pallas`).  For every channel z of one field it computes,
// with the factor matrices of origin_tpu_torch/ops/glr.py:
// dft_spatial_factors and the field's FSF spectrum (kr, ki)[z],
//
//     d      = x[z] * w                      (Ny, Nx), w optional
//     zr, zi = d @ axr, d @ axi              (Ny, FXr)   x-DFT
//     yr     = ayr @ zr - ayi @ zi           (FY, FXr)   y-DFT
//     yi     = ayr @ zi + ayi @ zr
//     pr     = yr * kr - yi * ki             float32 spectral multiply
//     pi     = yr * ki + yi * kr
//     gr     = byr @ pr - byi @ pi           (Ny, FXr)   inverse y-DFT
//     gi     = byr @ pi + byi @ pr
//     out[z] = gr @ cxr - gi @ cxi           (Ny, Nx)    inverse x-DFT
//
// One launch is one field; the wrapper sums the fields.
//
// Design.  The chain is separable along kx: the x-DFT, the y-DFT, the
// multiply and the inverse y-DFT are independent per kx column, and only
// the last product sums over kx.  So one block owns one channel and walks
// its kx columns in tiles of TK: for each tile it holds Z (then G) in a
// (Ny, 2 TK) shared buffer and Y (then P) in an (FY, 2 TK) one, and adds
// the tile's share of the inverse x-DFT into out[z], which no other block
// touches.  The factor matrices (548 KB at 100 x 200 with a 25 x 25 FSF,
// 2.2 MB at 300 x 300) are read through L2.  Every product is one tiled
// block GEMM (64 x 64 output tiles, 4 x 4 per thread, k-steps of 16
// staged in shared memory), with the real and imaginary parts
// concatenated: [yr | yi] = [ayr | ayi] @ [[zr, zi], [-zi, zr]], and the
// same for G; the inverse x-DFT is [gr | gi] @ [cxr ; -cxi].  TK is 32
// unless the field is too large for the two buffers in shared memory.
//
// Precision.  `highest`: float32 FMAs on CUDA cores.  `bf16x3`: where the
// TPU kernel splits (the factors, d, zr/zi, pr/pi, gr/gi) every operand
// is split once, as it is staged, into hi = bf16_rn(a) and
// lo = bf16_rn(a - hi), and each product term is th*xh + th*xl + tl*xh:
// a product of two bf16 values is exact in float32, so this is what three
// bf16 tensor-core passes with float32 accumulation compute.
//
// What bounds it on an H100: 20.3 M FMAs per channel at 3681 x 100 x 200
// with a 25 x 25 FSF (75 GFMA), 2.2 ms at the 67 TFLOP/s of the FP32
// pipes, three times that in bf16x3 on CUDA cores; the bytes (the cube
// in, out and the (FY, FXr) complex spectra, ~1.0 GB) take 0.3 ms.  So it
// is bound by operations; this simple form also pays for the padding of
// its 64 x 64 tiles (Ny = 100 fills 78% of two row tiles) and for
// staging every operand through shared memory.  Tensor cores (mma.sync /
// wgmma on the bf16 halves) are the next step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;         // threads per block
constexpr int BM = 64;          // GEMM output tile rows
constexpr int BN = 64;          // GEMM output tile columns
constexpr int BK = 16;          // GEMM k-step
constexpr int TM = 4;           // rows per thread
constexpr int TN = 4;           // columns per thread
constexpr int SA = BM + 4;      // padded row of the staged A tile

__device__ __forceinline__ void split(float v, float& hi, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(v));
  lo = __bfloat162float(__float2bfloat16_rn(v - hi));
}

// C = A @ B over an (M, N) output with depth K, one 64 x 64 tile at a
// time.  la(i, k) and lb(k, j) load operand elements (from global or
// shared memory), ep(i, j, v) consumes each result.  `stage` holds the
// staged tiles: A as [BK][SA] and B as [BK][BN], hi then lo halves.
template <bool X3, class LA, class LB, class EP>
__device__ void block_gemm(int M, int N, int K, LA la, LB lb, EP ep,
                           float* stage) {
  float* ah = stage;
  float* al = ah + BK * SA;
  float* bh = al + (X3 ? BK * SA : 0);
  float* bl = bh + BK * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  for (int m0 = 0; m0 < M; m0 += BM) {
    for (int n0 = 0; n0 < N; n0 += BN) {
      float acc[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < K; k0 += BK) {
        for (int e = tid; e < BM * BK; e += NT) {
          const int i = e / BK, k = e % BK;
          const float v = (m0 + i < M && k0 + k < K) ? la(m0 + i, k0 + k)
                                                      : 0.f;
          if (X3) split(v, ah[k * SA + i], al[k * SA + i]);
          else ah[k * SA + i] = v;
        }
        for (int e = tid; e < BK * BN; e += NT) {
          const int k = e / BN, j = e % BN;
          const float v = (k0 + k < K && n0 + j < N) ? lb(k0 + k, n0 + j)
                                                      : 0.f;
          if (X3) split(v, bh[k * BN + j], bl[k * BN + j]);
          else bh[k * BN + j] = v;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          const float4 a = *reinterpret_cast<const float4*>(
              &ah[kk * SA + ty * TM]);
          const float4 b = *reinterpret_cast<const float4*>(
              &bh[kk * BN + tx * TN]);
          const float av[TM] = {a.x, a.y, a.z, a.w};
          const float bv[TN] = {b.x, b.y, b.z, b.w};
          if (X3) {
            const float4 a2 = *reinterpret_cast<const float4*>(
                &al[kk * SA + ty * TM]);
            const float4 b2 = *reinterpret_cast<const float4*>(
                &bl[kk * BN + tx * TN]);
            const float alv[TM] = {a2.x, a2.y, a2.z, a2.w};
            const float blv[TN] = {b2.x, b2.y, b2.z, b2.w};
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
              for (int j = 0; j < TN; ++j) {
                acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
                acc[i][j] = fmaf(av[i], blv[j], acc[i][j]);
                acc[i][j] = fmaf(alv[i], bv[j], acc[i][j]);
              }
          } else {
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
              for (int j = 0; j < TN; ++j)
                acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int r = m0 + ty * TM + i, c = n0 + tx * TN + j;
          if (r < M && c < N) ep(r, c, acc[i][j]);
        }
    }
  }
}

size_t stage_floats(bool x3) {
  return (x3 ? 2 : 1) * (size_t)(BK * SA + BK * BN);
}

size_t smem_bytes(int ny, int fy, int tk, bool x3) {
  return ((size_t)(ny + fy) * 2 * tk + stage_floats(x3)) * sizeof(float);
}

template <bool X3>
__global__ void __launch_bounds__(NT)
spatial_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ kr, const float* __restrict__ ki,
               const float* __restrict__ axr, const float* __restrict__ axi,
               const float* __restrict__ ayr, const float* __restrict__ ayi,
               const float* __restrict__ byr, const float* __restrict__ byi,
               const float* __restrict__ cxr, const float* __restrict__ cxi,
               float* __restrict__ out, int ny, int nx, int fy, int fxr,
               int tk) {
  extern __shared__ float smem[];
  const int ld = 2 * tk;               // columns: tk real, then tk imag
  float* zg = smem;                    // (ny, ld): Z, then G
  float* yp = zg + ny * ld;            // (fy, ld): Y, then P
  float* stage = yp + fy * ld;
  const int z = blockIdx.x;
  const size_t plane = (size_t)ny * nx;
  const float* xz = x + z * plane;
  const float* krz = kr + (size_t)z * fy * fxr;
  const float* kiz = ki + (size_t)z * fy * fxr;
  float* oz = out + z * plane;

  for (int kx0 = 0; kx0 < fxr; kx0 += tk) {
    const int nk = min(tk, fxr - kx0);

    // x-DFT: [zr | zi] = d @ [axr | axi][:, kx0 : kx0 + nk]
    block_gemm<X3>(
        ny, ld, nx,
        [&](int y, int xx) {
          const float v = xz[y * nx + xx];
          return w ? v * w[y * nx + xx] : v;
        },
        [&](int xx, int j) {
          const int c = j % tk;
          if (c >= nk) return 0.f;
          return (j < tk ? axr : axi)[xx * fxr + kx0 + c];
        },
        [&](int y, int j, float v) { zg[y * ld + j] = v; }, stage);
    __syncthreads();

    // y-DFT: [yr | yi] = [ayr | ayi] @ [[zr, zi], [-zi, zr]]
    block_gemm<X3>(
        fy, ld, 2 * ny,
        [&](int f, int k) {
          return k < ny ? ayr[f * ny + k] : ayi[f * ny + k - ny];
        },
        [&](int k, int j) {
          const int c = j % tk;
          if (j < tk)
            return k < ny ? zg[k * ld + c] : -zg[(k - ny) * ld + tk + c];
          return k < ny ? zg[k * ld + tk + c] : zg[(k - ny) * ld + c];
        },
        [&](int f, int j, float v) { yp[f * ld + j] = v; }, stage);
    __syncthreads();

    // float32 spectral multiply, in place: [yr | yi] -> [pr | pi]
    for (int e = threadIdx.x; e < fy * tk; e += NT) {
      const int f = e / tk, c = e % tk;
      float pr = 0.f, pi = 0.f;
      if (c < nk) {
        const float yr = yp[f * ld + c], yi = yp[f * ld + tk + c];
        const float r = krz[f * fxr + kx0 + c], i = kiz[f * fxr + kx0 + c];
        pr = yr * r - yi * i;
        pi = yr * i + yi * r;
      }
      yp[f * ld + c] = pr;
      yp[f * ld + tk + c] = pi;
    }
    __syncthreads();

    // inverse y-DFT: [gr | gi] = [byr | byi] @ [[pr, pi], [-pi, pr]]
    block_gemm<X3>(
        ny, ld, 2 * fy,
        [&](int y, int k) {
          return k < fy ? byr[y * fy + k] : byi[y * fy + k - fy];
        },
        [&](int k, int j) {
          const int c = j % tk;
          if (j < tk)
            return k < fy ? yp[k * ld + c] : -yp[(k - fy) * ld + tk + c];
          return k < fy ? yp[k * ld + tk + c] : yp[(k - fy) * ld + c];
        },
        [&](int y, int j, float v) { zg[y * ld + j] = v; }, stage);
    __syncthreads();

    // inverse x-DFT, this tile's share: out += [gr | gi] @ [cxr ; -cxi]
    const bool first = kx0 == 0;
    block_gemm<X3>(
        ny, nx, ld,
        [&](int y, int k) { return zg[y * ld + k]; },
        [&](int k, int xx) {
          const int c = k % tk;
          if (c >= nk) return 0.f;
          return k < tk ? cxr[(kx0 + c) * nx + xx]
                        : -cxi[(kx0 + c) * nx + xx];
        },
        [&](int y, int xx, float v) {
          float* o = oz + y * nx + xx;
          *o = first ? v : *o + v;
        },
        stage);
    __syncthreads();
  }
}

template <bool X3>
int launch(const void* x, const void* w, const void* kr, const void* ki,
           const void* const* fac, void* out, int nz, int ny, int nx,
           int fy, int fxr, int tk, void* stream) {
  const size_t smem = smem_bytes(ny, fy, tk, X3);
  cudaError_t err = cudaFuncSetAttribute(
      spatial_kernel<X3>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  spatial_kernel<X3><<<nz, NT, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)kr, (const float*)ki,
      (const float*)fac[0], (const float*)fac[1], (const float*)fac[2],
      (const float*)fac[3], (const float*)fac[4], (const float*)fac[5],
      (const float*)fac[6], (const float*)fac[7], (float*)out, ny, nx, fy,
      fxr, tk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs for kx tiles of `tk` columns.
long long spatial_fsf_smem_bytes(int ny, int fy, int tk, int x3) {
  return (long long)smem_bytes(ny, fy, tk, x3 != 0);
}

// Launches one field on `stream`; allocates nothing.  x, out: (nz, ny, nx)
// float32; w: (ny, nx) float32 or null; kr, ki: (nz, fy, fxr) float32;
// fac: the 8 factor matrices axr, axi (nx, fxr), ayr, ayi (fy, ny),
// byr, byi (ny, fy), cxr, cxi (fxr, nx), float32 row-major.  x3: 0 for
// `highest`, 1 for `bf16x3`.  Returns the cudaError_t of the launch.
int spatial_fsf_launch(const void* x, const void* w, const void* kr,
                       const void* ki, const void* axr, const void* axi,
                       const void* ayr, const void* ayi, const void* byr,
                       const void* byi, const void* cxr, const void* cxi,
                       void* out, int nz, int ny, int nx, int fy, int fxr,
                       int tk, int x3, void* stream) {
  const void* fac[8] = {axr, axi, ayr, ayi, byr, byi, cxr, cxi};
  if (tk < 1 || nz < 1) return (int)cudaErrorInvalidValue;
  if (x3)
    return launch<true>(x, w, kr, ki, fac, out, nz, ny, nx, fy, fxr, tk,
                        stream);
  return launch<false>(x, w, kr, ki, fac, out, nz, ny, nx, fy, fxr, tk,
                       stream);
}

const char* spatial_fsf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
