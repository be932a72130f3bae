// Patch gather + per-modality normalization on Hopper (sm_90a).
//
// Replaces nnal_tpu/ops/gather_pallas.py::gather_patches_pallas (the
// double-buffered HBM->VMEM DMA kernel) and implements the contract of
// nnal_tpu/data/patches.py::gather_patches_normalized: for each raveled
// voxel index on the original shape, the (d1, d2, d3) window of every
// padded modality, normalized (v - mu[j]) / sd[j], laid out
// (n, d1, d2, m*d3) with modalities major over depth.  Window starts are
// clamped to [0, Dp - d] as lax.dynamic_slice does (even patch dims).
//
// Bound: bytes.  Every output element is written once and costs one read
// of the volume; the volume of a subject (a few MB) stays in the 50 MB L2,
// so the written bytes dominate.  Design: one thread per output element
// with the channel index fastest, so neighbouring threads write
// neighbouring addresses (coalesced stores); the gathered reads hit L2.
// The TPU kernel's explicit DMA pipeline has no counterpart: the SMs'
// many resident warps hide the L2 latency instead.  Any (d1, d2, d3) is
// supported (the TPU kernel only d3 == 1).  The division is IEEE (no fast
// math), so the result is bit-equal to the plain PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(256)
gather_patches_kernel(const float* __restrict__ vol,
                      const int64_t* __restrict__ inds,
                      const float* __restrict__ mu,
                      const float* __restrict__ sd,
                      float* __restrict__ out, int64_t total, int d1,
                      int d2, int d3, int m, int64_t D1p, int64_t D2p,
                      int64_t D3p, int64_t s2, int64_t s3) {
  const int C = m * d3;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t o = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       o < total; o += step) {
    const int ch = (int)(o % C);
    int64_t r = o / C;
    const int c = (int)(r % d2);
    r /= d2;
    const int a = (int)(r % d1);
    const int64_t i = r / d1;
    const int j = ch / d3;
    const int t = ch % d3;
    const int64_t idx = inds[i];
    const int64_t z = idx % s3;
    const int64_t rem = idx / s3;
    const int64_t y = rem % s2;
    const int64_t x = rem / s2;
    const int64_t x0 = clamp64(x, 0, D1p - d1);
    const int64_t y0 = clamp64(y, 0, D2p - d2);
    const int64_t z0 = clamp64(z, 0, D3p - d3);
    const float v =
        vol[((j * D1p + x0 + a) * D2p + (y0 + c)) * D3p + (z0 + t)];
    out[o] = (v - mu[j]) / sd[j];
  }
}

}  // namespace

extern "C" int gather_patches_normalized_f32(
    const void* vol, const void* inds, const void* mu, const void* sd,
    void* out, long long n, int d1, int d2, int d3, int m, long long D1p,
    long long D2p, long long D3p, long long s2, long long s3,
    void* stream) {
  const int64_t total = (int64_t)n * d1 * d2 * m * d3;
  if (total == 0) return 0;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  gather_patches_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      (const float*)vol, (const int64_t*)inds, (const float*)mu,
      (const float*)sd, (float*)out, total, d1, d2, d3, m, D1p, D2p, D3p,
      s2, s3);
  return (int)cudaGetLastError();
}
