// Row-max similarity on Hopper (sm_90a): out[i] = max_j P[i] . R[j].
//
// Replaces nnal_tpu/ops/similarity_pallas.py::max_similarity_pallas (body
// _make_rowmax_kernel): P (n, d) and R (m, d) are L2-normalized float32
// rows; the n x m similarity block never reaches device memory.
//
// Bound: operations.  The work is 2*n*m*d multiply-adds over (n + m)*d*4
// bytes; at the core-set shapes (d = 4096, m >= 256) that is hundreds of
// FLOPs per byte.  Plain TF32 keeps 10 mantissa bits and cannot meet the
// f32 oracle (1e-5), so the main path computes in split-precision TF32
// ("3xTF32") on the tensor cores: a = a_hi + a_lo with both halves rounded
// to TF32 (cvt.rna), and a.b ~ a_hi.b_hi + a_hi.b_lo + a_lo.b_hi (a_lo.b_lo,
// ~2^-22 |a||b|, is dropped).  Three TF32 products at 495 TFLOP/s bound the
// call at 3 * 2nmd / 495e12 s: 1.67 ms at P 65,536 x 4096, R 512 x 4096,
// against 4.10 ms for plain f32 FMAs at 67 TFLOP/s.
//
// Design (rowmax_wgmma_kernel, d % 4 == 0 and 16-byte aligned rows):
// - A persistent grid; each block owns bands of BM = 128 pool rows and
//   loops over ALL of R in BN = 128-row tiles (the TPU kernel's sequential
//   j axis), so the running row max lives in registers: no (n, m) block in
//   memory, no second pass, no atomics.
// - One thread of a producer warpgroup issues TMA loads (128-byte
//   swizzle, zero fill past n, m and d) of the P tile and the R_hi / R_lo
//   tiles into a ring of STAGES shared-memory stages, signalled by
//   mbarriers; setmaxnreg hands the producer's registers to the consumers.
// - Two consumer warpgroups, 64 rows each, read their P fragment from
//   shared memory into registers, split it into hi/lo there (P is read
//   once per R tile, never pre-split in memory), and issue
//   wgmma.m64n128k8.f32.tf32.tf32 with A from registers and B (R_hi, R_lo,
//   split once per call by split_tf32_kernel) from shared memory.
// - The tensor cores accumulate with truncation, so the sum of each BK = 32
//   slice of d is promoted into an f32 register sum with round-to-nearest
//   adds; the bias then grows per slice, not per instruction.
// - After each R tile the columns < m fold into two row maxima per thread
//   (columns past m are skipped, the -inf mask of the TPU kernel); a
//   two-step shuffle finishes each row.  Rows past n are bounds-checked.
// Unaligned rows or d % 4 != 0 (which TMA cannot describe) take
// rowmax_simt_kernel: a register-blocked f32 FMA GEMM with the same
// structure and plain loads.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------ SIMT path

constexpr int SB = 128;  // rows of P and of R per tile
constexpr int SK = 8;
constexpr int ST = 8;    // each thread: ST x ST sub-tile
constexpr int SIMT_THREADS = 256;

// Load a (128 rows x SK) tile of a row-major (rows, d) matrix into
// smem[SK][128], k-major; out-of-range reads are 0.
__device__ __forceinline__ void simt_tile(const float* __restrict__ src,
                                          int rows, int d, int row0, int k0,
                                          float (*dst)[SB]) {
  const int r = threadIdx.x >> 1;
  const int kk = (threadIdx.x & 1) * 4;
  const int row = row0 + r;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int k = k0 + kk + e;
    dst[kk + e][r] = (row < rows && k < d) ? src[(size_t)row * d + k] : 0.f;
  }
}

__global__ void __launch_bounds__(SIMT_THREADS)
rowmax_simt_kernel(const float* __restrict__ P, const float* __restrict__ R,
                   float* __restrict__ out, int n, int m, int d) {
  __shared__ __align__(16) float As[SK][SB];
  __shared__ __align__(16) float Bs[SK][SB];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int row0 = blockIdx.x * SB;
  float rmax[ST];
#pragma unroll
  for (int i = 0; i < ST; ++i) rmax[i] = -CUDART_INF_F;
  for (int n0 = 0; n0 < m; n0 += SB) {
    float acc[ST][ST] = {};
    for (int k0 = 0; k0 < d; k0 += SK) {
      simt_tile(P, n, d, row0, k0, As);
      simt_tile(R, m, d, n0, k0, Bs);
      __syncthreads();
#pragma unroll
      for (int k = 0; k < SK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * ST]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&As[k][ty * ST + 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * ST]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&Bs[k][tx * ST + 4]);
        const float a[ST] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[ST] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < ST; ++i)
#pragma unroll
          for (int j = 0; j < ST; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < ST; ++j)
      if (n0 + tx * ST + j < m)
#pragma unroll
        for (int i = 0; i < ST; ++i) rmax[i] = fmaxf(rmax[i], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < ST; ++i) {
    float v = rmax[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    const int row = row0 + ty * ST + i;
    if (tx == 0 && row < n) out[row] = v;
  }
}

// ------------------------------------------------- split-precision TF32

constexpr int BM = 128;   // pool rows per band (two warpgroups of 64)
constexpr int BN = 128;   // R rows per tile (wgmma N)
constexpr int BK = 32;    // floats of d per stage: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int TILE_BYTES = BM * BK * 4;          // 16 KB, = BN * BK * 4
constexpr int STAGE_BYTES = 3 * TILE_BYTES;      // P, R_hi, R_lo
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + 1 KB alignment
constexpr int CONSUMER_WARPS = 8;
// + a producer warpgroup: setmaxnreg moves registers only between the
// warps of one block, so the producer's 4 warps release what the
// consumers take (4 x 32 x (168 - 24) = 8 x 32 x (240 - 168))
constexpr int WG_THREADS = (CONSUMER_WARPS + 4) * 32;

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__global__ void split_tf32_kernel(const float* __restrict__ R,
                                  float* __restrict__ hi,
                                  float* __restrict__ lo, long long count) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < count; i += step) {
    const float v = R[i];
    const float h = __uint_as_float(tf32_rna(v));
    hi[i] = h;
    lo[i] = __uint_as_float(tf32_rna(v - h));  // v - h is exact in f32
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the phase of the given parity to complete.  A protocol fault
// traps after 4 s (the launch then fails) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) t0 = global_ns();
    else if (global_ns() - t0 > 4000000000ull) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// K-major operand with 128-byte swizzle: 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
__device__ __forceinline__ void keep_f(float& x) {
  asm volatile("" : "+f"(x) :: "memory");
}
__device__ __forceinline__ void keep_r(uint32_t& x) {
  asm volatile("" : "+r"(x) :: "memory");
}

// d (64 rows x 128 cols, f32) {+}= a (64 x 8 TF32, registers) . b^T
// (128 x 8 TF32, shared memory, K-major).
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

__global__ void __launch_bounds__(WG_THREADS, 1)
rowmax_wgmma_kernel(const __grid_constant__ CUtensorMap map_p,
                    const __grid_constant__ CUtensorMap map_hi,
                    const __grid_constant__ CUtensorMap map_lo,
                    float* __restrict__ out, int n, int m, int d) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  // 128-byte swizzle atoms must start on a 1024-byte boundary
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int nbands = (n + BM - 1) / BM;
  const int ntiles = (m + BN - 1) / BN;
  const int nk = (d + BK - 1) / BK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    // producer: one thread keeps the ring full; the warpgroup hands its
    // registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (warp == CONSUMER_WARPS && lane == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int band = blockIdx.x; band < nbands; band += gridDim.x)
        for (int t = 0; t < ntiles; ++t)
          for (int k = 0; k < nk; ++k) {
            mbar_wait(&empty[s], phase ^ 1);
            uint8_t* st = smem + s * STAGE_BYTES;
            mbar_expect_tx(&full[s], STAGE_BYTES);
            tma_load_2d(st, &map_p, k * BK, band * BM, &full[s]);
            tma_load_2d(st + TILE_BYTES, &map_hi, k * BK, t * BN, &full[s]);
            tma_load_2d(st + 2 * TILE_BYTES, &map_lo, k * BK, t * BN,
                        &full[s]);
            if (++s == STAGES) { s = 0; phase ^= 1; }
          }
    }
    return;
  }

  // consumers: warpgroup wg holds rows wg*64 .. wg*64+63 of the band; a
  // thread's fragment rows are r and r + 8 (PTX wgmma register layout).
  // The accumulator, its f32 sum and the split fragment need ~170
  // registers, more than the 168 that 384 threads get without the raise.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int r = (warp / 4) * 64 + (warp % 4) * 16 + g;
  int s = 0;
  uint32_t phase = 0;
  float acc[64];  // wgmma accumulator; each BK slice starts it afresh
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int band = blockIdx.x; band < nbands; band += gridDim.x) {
    float rmax0 = -CUDART_INF_F, rmax1 = -CUDART_INF_F;
    for (int t = 0; t < ntiles; ++t) {
      float sum[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] = 0.f;
      for (int k = 0; k < nk; ++k) {
        mbar_wait(&full[s], phase);
        const uint8_t* st = smem + s * STAGE_BYTES;
        const float* sp = reinterpret_cast<const float*>(st);
        // P fragment from the swizzled tile: element (row, col) sits in
        // 16-byte chunk (col / 4) ^ (row % 8) of its 128-byte row
        uint32_t ahi[4][4], alo[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int c0 = ((2 * kk) ^ g) * 4 + tq;
          const int c1 = ((2 * kk + 1) ^ g) * 4 + tq;
          const float v[4] = {sp[r * BK + c0], sp[(r + 8) * BK + c0],
                              sp[r * BK + c1], sp[(r + 8) * BK + c1]};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ahi[kk][e] = tf32_rna(v[e]);
            alo[kk][e] = tf32_rna(v[e] - __uint_as_float(ahi[kk][e]));
          }
        }
        const uint64_t dhi = sw128_desc(st + TILE_BYTES);
        const uint64_t dlo = sw128_desc(st + 2 * TILE_BYTES);
#pragma unroll
        for (int i = 0; i < 64; ++i) keep_f(acc[i]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // k8 step kk starts 32 bytes further along the swizzled row
          wgmma_tf32(acc, ahi[kk], dhi + 2 * kk, kk > 0);
          wgmma_tf32(acc, ahi[kk], dlo + 2 * kk, 1);
          wgmma_tf32(acc, alo[kk], dhi + 2 * kk, 1);
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            keep_r(ahi[kk][e]);
            keep_r(alo[kk][e]);
          }
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          keep_f(acc[i]);
          sum[i] += acc[i];
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
        if (++s == STAGES) { s = 0; phase ^= 1; }
      }
      // accumulator i: row r + 8 * ((i >> 1) & 1), column
      // 8 * (i >> 2) + 2 * tq + (i & 1) of this R tile
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int col = t * BN + 8 * (i >> 2) + 2 * tq + (i & 1);
        if (col < m) {
          if ((i >> 1) & 1) rmax1 = fmaxf(rmax1, sum[i]);
          else rmax0 = fmaxf(rmax0, sum[i]);
        }
      }
    }
    // the 4 lanes tq = 0..3 share a row
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      rmax0 = fmaxf(rmax0, __shfl_xor_sync(0xffffffffu, rmax0, off));
      rmax1 = fmaxf(rmax1, __shfl_xor_sync(0xffffffffu, rmax1, off));
    }
    const int row = band * BM + r;
    if (tq == 0) {
      if (row < n) out[row] = rmax0;
      if (row + 8 < n) out[row + 8] = rmax1;
    }
  }
}

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// (rows, d) row-major float32 -> tiles of 128 rows x 32 floats, 128-byte
// swizzle, zeros past the edges.
bool make_map(CUtensorMap* map, const void* base, int rows, int d) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 4};
  const cuuint32_t box[2] = {BK, BM};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// scratch: 2 * m * d floats (R_hi, R_lo) when vec != 0, else unused.
extern "C" int rowmax_similarity_f32(const void* P, const void* R, void* out,
                                     void* scratch, int n, int m, int d,
                                     int vec, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (!vec) {
    rowmax_simt_kernel<<<(n + SB - 1) / SB, SIMT_THREADS, 0, s>>>(
        (const float*)P, (const float*)R, (float*)out, n, m, d);
    return (int)cudaGetLastError();
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // more than 48 KB of dynamic shared memory needs the opt-in attribute
  const cudaError_t e = cudaFuncSetAttribute(
      rowmax_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  float* hi = (float*)scratch;
  float* lo = hi + (size_t)m * d;
  const long long count = (long long)m * d;
  long long blocks = (count + 255) / 256;
  if (blocks > 4LL * sms) blocks = 4LL * sms;  // grid-stride beyond this
  split_tf32_kernel<<<(unsigned)blocks, 256, 0, s>>>((const float*)R, hi, lo,
                                                     count);
  CUtensorMap mp, mh, ml;
  if (!make_map(&mp, P, n, d) || !make_map(&mh, hi, m, d) ||
      !make_map(&ml, lo, m, d))
    return (int)cudaErrorInvalidValue;
  const int nbands = (n + BM - 1) / BM;
  rowmax_wgmma_kernel<<<nbands < sms ? nbands : sms, WG_THREADS, SMEM_BYTES,
                        s>>>(mp, mh, ml, (float*)out, n, m, d);
  return (int)cudaGetLastError();
}
