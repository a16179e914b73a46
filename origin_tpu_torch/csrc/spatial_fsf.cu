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
// block GEMM (64 x 64 output tiles, operands staged in shared memory
// through the loaders `la` / `lb`, zero-filled past the ragged edges),
// with the real and imaginary parts concatenated:
// [yr | yi] = [ayr | ayi] @ [[zr, zi], [-zi, zr]], and the same for G;
// the inverse x-DFT is [gr | gi] @ [cxr ; -cxi].  TK is 32 unless the
// field is too large for the two buffers in shared memory.
//
// Precision.  `highest`: float32 FMAs on CUDA cores, 4 x 4 outputs per
// thread, k-steps of 16.  `bf16x3`: where the TPU kernel splits (the
// factors, d, zr/zi, pr/pi, gr/gi) every operand is split once, as it is
// staged, into hi = bf16_rn(a) and lo = bf16_rn(a - hi), and each product
// is hi.hi + hi.lo + lo.hi, as the TPU kernel's three passes through its
// matrix unit (origin_tpu/ops/pallas_prec.py:make_dot).  Here the three
// passes run on the bf16 tensor cores through WMMA (m16n16k16, float
// accumulation, one sum per pass, added (hh + hl) + lh at the end as
// ops/prec.py:dot3 adds them; see gemm_bf16x3): a product of two bf16
// values is exact in float32, so this is what the plain version's float32
// matmuls of the bf16-valued halves compute, up to the order of the sums.
//
// What bounds it on an H100: 20.3 M multiply-adds per channel at
// 3681 x 100 x 200 with a 25 x 25 FSF (75 G), three passes in bf16x3:
// 0.454 ms at the 989 TFLOP/s of the bf16 tensor cores, while the bytes
// (the cube in, out, the (FY, FXr) complex spectra and the factors,
// ~1.0 GB) take 0.30 ms.  Measured there (NVIDIA H100 80GB HBM3, 700 W,
// chip_smoke.py phase a): bf16x3 10.3 ms, 4.4% of that bound, where the
// same chain on CUDA cores took 22 ms and cuBLAS's float32 chain takes
// 7.5 ms.  The tensor cores are not what holds it: every operand
// element is loaded through `la` / `lb` (the factor matrices from L2,
// once per output tile), split and stored twice to shared memory for
// every 16-deep step, and each step waits on two barriers, with two
// blocks (16 warps) per SM to cover them.  Deeper k-steps or a second
// stage buffer would halve the barriers but need more than 128
// registers, and one block per SM ran slower.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int NT = 256;         // threads per block
constexpr int BM = 64;          // GEMM output tile rows
constexpr int BN = 64;          // GEMM output tile columns
// `highest`: float32 FMAs on CUDA cores
constexpr int BK = 16;          // k-step
constexpr int TM = 4;           // rows per thread
constexpr int TN = 4;           // columns per thread
constexpr int SA = BM + 4;      // padded row of the staged A tile
// bf16x3: bf16 tensor cores through WMMA; 8 warps own the 64 x 64 tile
// as 4 row blocks x 2 column blocks of 16 x 32, two fragments per warp
constexpr int WF = 16;          // fragment m = n = k
constexpr int KX = 16;          // k-step (32 needs ~172 registers)
constexpr int LA = KX + 8;      // padded row of a staged A half, [BM][LA]
constexpr int LB = BN + 8;      // padded row of a staged B half, [KX][LB]
constexpr int LC = 2 * WF + 4;  // padded row of a warp's 16 x 32 result
// WMMA wants ldm a multiple of 8 bf16 / 4 floats and 32-byte aligned
// fragment bases; the paddings also keep ldmatrix free of bank conflicts
static_assert(LA % 8 == 0 && LB % 8 == 0 && LC % 4 == 0, "WMMA ldm");
static_assert((BM * LA * 2) % 32 == 0 && (KX * LB * 2) % 32 == 0,
              "WMMA fragment alignment");

constexpr size_t F32_STAGE = (BK * SA + BK * BN) * sizeof(float);
constexpr size_t X3_OPERANDS = 2 * (BM * LA + KX * LB) * sizeof(bf16);
constexpr size_t X3_RESULTS = (NT / 32) * WF * LC * sizeof(float);
constexpr size_t X3_STAGE =
    X3_OPERANDS > X3_RESULTS ? X3_OPERANDS : X3_RESULTS;

// C = A @ B over an (M, N) output with depth K, one 64 x 64 tile at a
// time.  la(i, k) and lb(k, j) load operand elements (from global or
// shared memory), ep(i, j, v) consumes each result.  float32 FMAs on
// CUDA cores; `stage` holds A as [BK][SA] and B as [BK][BN].
template <class LA_, class LB_, class EP>
__device__ void gemm_f32(int M, int N, int K, LA_ la, LB_ lb, EP ep,
                         float* stage) {
  float* ah = stage;
  float* bh = ah + BK * SA;
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
          ah[k * SA + i] = (m0 + i < M && k0 + k < K) ? la(m0 + i, k0 + k)
                                                       : 0.f;
        }
        for (int e = tid; e < BK * BN; e += NT) {
          const int k = e / BN, j = e % BN;
          bh[k * BN + j] = (k0 + k < K && n0 + j < N) ? lb(k0 + k, n0 + j)
                                                       : 0.f;
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
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
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

// This thread's R elements of a W-wide operand tile at (r0, c0): element
// e = tid + r NT is (e / W, e % W), loaded through `ld`, 0 past (rows,
// cols).
template <int R, int W, class L>
__device__ __forceinline__ void fetch(float (&v)[R], L ld, int r0, int c0,
                                      int rows, int cols) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = threadIdx.x + r * NT, i = r0 + e / W, j = c0 + e % W;
    v[r] = (i < rows && j < cols) ? ld(i, j) : 0.f;
  }
}

// Stores the fetched elements split, hi = bf16_rn(v) and
// lo = bf16_rn(v - hi), into two [.][P] bf16 tiles.
template <int R, int W, int P>
__device__ __forceinline__ void stash(const float (&v)[R], bf16* hi,
                                      bf16* lo) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = threadIdx.x + r * NT, o = e / W * P + e % W;
    const bf16 h = __float2bfloat16_rn(v[r]);
    hi[o] = h;
    lo[o] = __float2bfloat16_rn(v[r] - __bfloat162float(h));
  }
}

// The same contract in bf16x3 on the tensor cores.  Each operand element
// is split once as it is staged: `stage` holds A-hi, A-lo as [BM][LA] and
// B-hi, B-lo as [KX][LB], and the next k-step's elements are loaded into
// registers while the warps multiply the current one.  Per k-step a warp
// runs hi.hi, hi.lo and lo.hi on each of its two 16 x 16 fragments.
// hi.lo and lo.hi go to their own float accumulators.  hi.hi starts each
// k-step from zero and is added to a float32 sum: the tensor cores' own
// additions are not float32's, and an accumulator carried over a deep K
// drifts from the plain version (K ~ 6,900 in the kx-tile-of-2 gpu test
// case cost the split check its margin).  The three are summed at the end
// as ops/prec.py:dot3 sums them, (hh + hl) + lh.  The fragments' element
// map is opaque, so each warp stores its 16 x 32 result to a float
// scratch (aliasing the operands once the k-loop is done) and reads it
// back by rows for `ep`.
template <class LA_, class LB_, class EP>
__device__ __forceinline__ void gemm_bf16x3(int M, int N, int K, LA_ la,
                                            LB_ lb, EP ep, float* stage) {
  bf16* ah = reinterpret_cast<bf16*>(stage);
  bf16* al = ah + BM * LA;
  bf16* bh = al + BM * LA;
  bf16* bl = bh + KX * LB;
  constexpr int RA = BM * KX / NT, RB = KX * BN / NT;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp % 4, wn = warp / 4;
  float* cs = stage + warp * WF * LC;
  float va[RA], vb[RB];
  for (int m0 = 0; m0 < M; m0 += BM) {
    for (int n0 = 0; n0 < N; n0 += BN) {
      wmma::fragment<wmma::accumulator, WF, WF, WF, float> hh[2], hl[2],
          lh[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        wmma::fill_fragment(hh[t], 0.f);
        wmma::fill_fragment(hl[t], 0.f);
        wmma::fill_fragment(lh[t], 0.f);
      }
      fetch<RA, KX>(va, la, m0, 0, M, K);
      fetch<RB, BN>(vb, lb, 0, n0, K, N);
      for (int k0 = 0; k0 < K; k0 += KX) {
        stash<RA, KX, LA>(va, ah, al);
        stash<RB, BN, LB>(vb, bh, bl);
        __syncthreads();
        if (k0 + KX < K) {
          fetch<RA, KX>(va, la, m0, k0 + KX, M, K);
          fetch<RB, BN>(vb, lb, k0 + KX, n0, K, N);
        }
        // one trip while KX == WF; in this form ptxas fits the function in
        // 128 registers (the same code without the loop spilled 4 bytes)
#pragma unroll
        for (int kk = 0; kk < KX; kk += WF) {
          wmma::fragment<wmma::matrix_a, WF, WF, WF, bf16, wmma::row_major>
              a_h, a_l;
          wmma::load_matrix_sync(a_h, ah + wm * WF * LA + kk, LA);
          wmma::load_matrix_sync(a_l, al + wm * WF * LA + kk, LA);
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            wmma::fragment<wmma::matrix_b, WF, WF, WF, bf16,
                           wmma::row_major> b_h, b_l;
            const int off = kk * LB + (2 * wn + t) * WF;
            wmma::load_matrix_sync(b_h, bh + off, LB);
            wmma::load_matrix_sync(b_l, bl + off, LB);
            // this k-step's hi.hi from zero, added to hh in float32
            wmma::fragment<wmma::accumulator, WF, WF, WF, float> p;
            wmma::fill_fragment(p, 0.f);
            wmma::mma_sync(p, a_h, b_h, p);
#pragma unroll
            for (int q = 0; q < p.num_elements; ++q) hh[t].x[q] += p.x[q];
            wmma::mma_sync(hl[t], a_h, b_l, hl[t]);
            wmma::mma_sync(lh[t], a_l, b_h, lh[t]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
#pragma unroll
        for (int q = 0; q < hh[t].num_elements; ++q)
          hh[t].x[q] = (hh[t].x[q] + hl[t].x[q]) + lh[t].x[q];
        wmma::store_matrix_sync(cs + t * WF, hh[t], LC, wmma::mem_row_major);
      }
      __syncwarp();
      const int c = n0 + 2 * wn * WF + lane;
#pragma unroll 4
      for (int i = 0; i < WF; ++i) {
        const int r = m0 + wm * WF + i;
        if (r < M && c < N) ep(r, c, cs[i * LC + lane]);
      }
      __syncthreads();  // the next tile's staging overwrites the scratch
    }
  }
}

template <bool X3, class LA_, class LB_, class EP>
__device__ __forceinline__ void block_gemm(int M, int N, int K, LA_ la,
                                           LB_ lb, EP ep, float* stage) {
  if constexpr (X3)
    gemm_bf16x3(M, N, K, la, lb, ep, stage);
  else
    gemm_f32(M, N, K, la, lb, ep, stage);
}

// Byte offset of the GEMM stage: past the two float buffers, rounded up
// to 128 bytes, since (ny + fy) * 2 tk floats need not be a multiple of
// the 32 bytes a WMMA fragment's base must be aligned to.
__host__ __device__ inline size_t stage_offset(int ny, int fy, int tk) {
  return ((size_t)(ny + fy) * 2 * tk * sizeof(float) + 127) / 128 * 128;
}

size_t smem_bytes(int ny, int fy, int tk, bool x3) {
  return stage_offset(ny, fy, tk) + (x3 ? X3_STAGE : F32_STAGE);
}

// bf16x3: two blocks per SM, so at most 128 registers a thread; the form
// takes all 128 and spills under this cap at k-steps of 32.  `highest`
// names no minimum (0), which leaves it at 64 registers: with a minimum of
// 1 or 2 ptxas gave it 93, and it ran slower.
template <bool X3>
__global__ void __launch_bounds__(NT, X3 ? 2 : 0)
spatial_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ kr, const float* __restrict__ ki,
               const float* __restrict__ axr, const float* __restrict__ axi,
               const float* __restrict__ ayr, const float* __restrict__ ayi,
               const float* __restrict__ byr, const float* __restrict__ byi,
               const float* __restrict__ cxr, const float* __restrict__ cxi,
               float* __restrict__ out, int ny, int nx, int fy, int fxr,
               int tk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = 2 * tk;               // columns: tk real, then tk imag
  float* zg = reinterpret_cast<float*>(smem);  // (ny, ld): Z, then G
  float* yp = zg + ny * ld;                    // (fy, ld): Y, then P
  float* stage = reinterpret_cast<float*>(smem + stage_offset(ny, fy, tk));
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
          const int c = j < tk ? j : j - tk;  // j < 2 tk: no division
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
          const int c = j < tk ? j : j - tk;
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
          const int c = j < tk ? j : j - tk;
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
          const int c = k < tk ? k : k - tk;
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
