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
// Bound: bytes.  Every output element is written once; a subject's volume
// (a few MB) stays in the 50 MB L2, so the written bytes dominate:
// 4 * n * d1 * d2 * m * d3 bytes at 3.35 TB/s.
//
// Design: the kernel reads a y-contiguous copy of the padded volume,
// (m, D1p, D3p, D2p) -- the TPU kernel's own layout, without its 128-lane
// padding -- which the wrapper makes once per volume.  A window row
// (fixed channel (j, t) and x) is then d2 contiguous floats.  One block of
// four warps per patch; each thread unravels the patch's index in 32-bit
// arithmetic (the wrapper checks that every extent fits in int32), and
// lane c owns window column y0 + c (columns past 32 in further passes).
// The patch's work is cut into units of (VEC channels, up to ROWS
// x-rows), dealt round-robin to the warps: a 25x25x2 patch is 4 units,
// one per warp.  In a unit each lane first issues its VEC * ROWS
// independent coalesced loads, then normalizes them with the unit's mu/sd
// (loaded once) and stores each x-row's VEC channels as one VEC-float
// word (VEC = 2 when m * d3 is even, else 1), so a warp's store covers a
// contiguous run of the patch's d1*d2*m*d3 output.  Per element that is
// one load, part of one store and the IEEE divide; no shared memory or
// barrier stands between a load and its store.  (A block per patch that
// staged the window in shared memory, and a warp per patch walking
// (x, channel) rows, both ran about twice as slow or worse on the card:
// their serial index -> loads -> stores chains and per-element index and
// mu/sd loads left the card issuing instructions, not moving bytes;
// PERF.md.)  Any (d1, d2, d3) is supported (the TPU kernel only
// d3 == 1).  The division is IEEE (no fast math), so the result is
// bit-equal to the plain PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

// The per-volume constants, built once per volume and patch shape by the
// wrapper and passed by pointer.  It stays outside the anonymous namespace:
// a C entry point that takes an internal type loses its external linkage.
struct GatherParams {
  int d1, d2, d3, m;    // patch shape, modalities
  int D1p, D2p, D3p;    // padded volume extents (copy is (m, D1p, D3p, D2p))
  int s2, s3;           // original shape's last two extents (unravel)
};

namespace {

constexpr int WARPS = 4;      // per patch
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 8;       // x-rows of a unit: VEC * ROWS loads in flight

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <int VEC> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };

// VEC consecutive channels per unit (VEC = 2 when m * d3 is even): a lane
// stores them as one VEC-float word, so a warp's store covers a
// contiguous run of the output.
template <int VEC>
__global__ void __launch_bounds__(THREADS)
gather_patches_kernel(const float* __restrict__ vol,
                      const int64_t* __restrict__ inds,
                      const float* __restrict__ mu,
                      const float* __restrict__ sd,
                      float* __restrict__ out, const GatherParams p) {
  const int C = p.m * p.d3;
  const int chunks = (p.d1 + ROWS - 1) / ROWS;
  const int units = (C / VEC) * chunks;
  const int warp = threadIdx.x / 32;
  if (warp >= units) return;
  const int lane = threadIdx.x % 32;
  const int idx = (int)inds[blockIdx.x];
  const int rem = idx / p.s3;
  const int z0 = clampi(idx - rem * p.s3, 0, p.D3p - p.d3);
  const int x = rem / p.s2;
  const int y0 = clampi(rem - x * p.s2, 0, p.D2p - p.d2);
  const int x0 = clampi(x, 0, p.D1p - p.d1);
  float* o = out + (size_t)blockIdx.x * p.d1 * p.d2 * C;
  const int vol_step = p.D3p * p.D2p;   // next x-row of a channel
  const int out_step = p.d2 * C;
  for (int unit = warp; unit < units; unit += WARPS) {
    const int ch0 = (unit / chunks) * VEC;
    const int a0 = (unit - (ch0 / VEC) * chunks) * ROWS;
    const int na = min(ROWS, p.d1 - a0);
    const float* src[VEC];
    float mu_c[VEC], sd_c[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int j = (ch0 + e) / p.d3;
      const int t = ch0 + e - j * p.d3;
      mu_c[e] = __ldg(mu + j);
      sd_c[e] = __ldg(sd + j);
      src[e] = vol + ((j * p.D1p + x0 + a0) * p.D3p + z0 + t) * p.D2p + y0;
    }
    for (int c = lane; c - lane < p.d2; c += 32) {
      if (c >= p.d2) continue;
      float v[ROWS][VEC];
#pragma unroll
      for (int u = 0; u < ROWS; ++u)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (u < na) v[u][e] = src[e][u * vol_step + c];
      float* dst = o + (a0 * p.d2 + c) * C + ch0;
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        if (u < na) {
          float r[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) r[e] = (v[u][e] - mu_c[e]) / sd_c[e];
          *reinterpret_cast<typename Vec<VEC>::T*>(dst + u * out_step) =
              *reinterpret_cast<typename Vec<VEC>::T*>(r);
        }
      }
    }
  }
}

}  // namespace

extern "C" int gather_patches_normalized_f32(
    const void* vol, const void* inds, const void* mu, const void* sd,
    void* out, int n, const GatherParams* params, void* stream) {
  if (n == 0) return 0;
  const bool pairs = (params->m * params->d3) % 2 == 0;
  (pairs ? gather_patches_kernel<2> : gather_patches_kernel<1>)
      <<<n, THREADS, 0, (cudaStream_t)stream>>>(
          (const float*)vol, (const int64_t*)inds, (const float*)mu,
          (const float*)sd, (float*)out, *params);
  return (int)cudaGetLastError();
}
