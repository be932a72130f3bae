// Row-max similarity on Hopper (sm_90a): out[i] = max_j P[i] . R[j].
//
// Replaces nnal_tpu/ops/similarity_pallas.py::max_similarity_pallas (body
// _make_rowmax_kernel): P (n, d) and R (m, d) are L2-normalized float32
// rows; the n x m similarity block never reaches device memory.
//
// Bound: operations.  The work is 2*n*m*d FLOPs over (n + m)*d*4 bytes;
// at the core-set shapes (d = 4096, m >= 256) that is hundreds of FLOPs
// per byte, far above the H100's float32 ridge.  The f32 oracle
// (rtol 1e-5) rules out TF32 tensor cores, so the ceiling is the
// non-tensor float32 FMA rate.
//
// Design: a classic register-blocked SIMT GEMM.  Each block owns BM = 128
// pool rows and loops over ALL of R in BN = 128-row tiles; that loop is
// the TPU kernel's sequential j grid axis, so the running row max lives in
// registers and no cross-block reduction is needed.  d streams through
// shared memory in BK = 8 chunks; each of the 256 threads accumulates an
// 8 x 8 sub-tile with plain FMAs, folds it into 8 running row maxima after
// each R tile (columns past m are skipped, the -inf mask of the TPU
// kernel), and the 16 threads sharing a row reduce with warp shuffles.
// Rows past n are bounds-checked, so the caller pads nothing.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int TM = 8;
constexpr int TN = 8;
constexpr int THREADS = 256;  // (BM / TM) x (BN / TN) = 16 x 16

// Load a (128 rows x BK) tile of a row-major (rows, d) matrix into
// smem[BK][128] (k-major, so the compute loop reads contiguous rows).
// Each thread moves 4 consecutive k of one row; out-of-range reads are 0.
template <bool VEC>
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          int rows, int d, int row0, int k0,
                                          float (*dst)[128]) {
  const int r = threadIdx.x >> 1;
  const int kk = (threadIdx.x & 1) * 4;
  const int row = row0 + r;
  const int k = k0 + kk;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (row < rows) {
    const float* p = src + (size_t)row * d + k;
    if (VEC && k + 3 < d) {
      const float4 q = *reinterpret_cast<const float4*>(p);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = (k + e < d) ? p[e] : 0.f;
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) dst[kk + e][r] = v[e];
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
rowmax_kernel(const float* __restrict__ P, const float* __restrict__ R,
              float* __restrict__ out, int n, int m, int d) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tx = threadIdx.x % 16;  // column group
  const int ty = threadIdx.x / 16;  // row group
  const int row0 = blockIdx.x * BM;

  float rmax[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) rmax[i] = -CUDART_INF_F;

  for (int n0 = 0; n0 < m; n0 += BN) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += BK) {
      load_tile<VEC>(P, n, d, row0, k0, As);
      load_tile<VEC>(R, m, d, n0, k0, Bs);
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float a[TM], b[TN];
        const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * TM]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&As[k][ty * TM + 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * TN]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&Bs[k][tx * TN + 4]);
        a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
        a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
        b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
        b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if (n0 + tx * TN + j < m) {
#pragma unroll
        for (int i = 0; i < TM; ++i) rmax[i] = fmaxf(rmax[i], acc[i][j]);
      }
    }
  }

  // the 16 threads of a row group are lanes tx = 0..15 of one half warp
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float v = rmax[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    const int row = row0 + ty * TM + i;
    if (tx == 0 && row < n) out[row] = v;
  }
}

}  // namespace

extern "C" int rowmax_similarity_f32(const void* P, const void* R, void* out,
                                     int n, int m, int d, int vec,
                                     void* stream) {
  if (n == 0) return 0;
  const dim3 grid((n + BM - 1) / BM);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    rowmax_kernel<true><<<grid, THREADS, 0, s>>>(
        (const float*)P, (const float*)R, (float*)out, n, m, d);
  } else {
    rowmax_kernel<false><<<grid, THREADS, 0, s>>>(
        (const float*)P, (const float*)R, (float*)out, n, m, d);
  }
  return (int)cudaGetLastError();
}
