// Native host-side patch extraction (the port's copy of the JAX package's
// runtime/patch_gather.cc; the arithmetic is unchanged).
//
// The reference's data path is a Python per-patch loop
// (patch_utils.py:1148-1165).  Pool scoring and the finetunes gather on the
// card (kernel K2, ops/gather.py) from volumes resident in its memory;
// this C++ loop is the HOST side — extracting normalized training batches
// from volumes that live in host RAM (campaigns whose volumes exceed the
// card's memory), feeding the double-buffered host->device loader
// (data/loaders.py).
//
// Layout contract (the card's gather's):
//   volumes: m modalities, each (D1p, D2p, D3p) float32 C-order, already
//            zero-padded by the patch radii;
//   inds:    raveled C-order voxel indices on the ORIGINAL (unpadded) shape;
//   out:     (b, d1, d2, m*d3) float32, modality-concat along depth,
//            normalized per modality as (x - mu[j]) * (1 / sd[j]) — one ulp
//            from the card's (x - mu[j]) / sd[j] at most.
//
// Single-threaded; the inner copy is a d3-contiguous loop over (d1, d2)
// rows, vectorized by the compiler.

#include <cstdint>
#include <cstddef>

extern "C" {

// Gather one batch of patches.
//   vols:      array of m pointers to padded volumes
//   D1p,D2p,D3p: padded volume dims
//   s1,s2,s3:  original (unpadded) dims
//   inds:      b raveled indices on (s1,s2,s3)
//   d1,d2,d3:  patch dims
//   mu, sd:    per-modality normalization constants
//   out:       (b, d1, d2, m*d3) buffer
void gather_patches_f32(const float** vols, int64_t m,
                        int64_t D1p, int64_t D2p, int64_t D3p,
                        int64_t s1, int64_t s2, int64_t s3,
                        const int64_t* inds, int64_t b,
                        int64_t d1, int64_t d2, int64_t d3,
                        const float* mu, const float* sd,
                        float* out) {
  (void)s1; (void)D1p;
  const int64_t out_depth = m * d3;
  const int64_t patch_sz = d1 * d2 * out_depth;
  for (int64_t i = 0; i < b; ++i) {
    const int64_t idx = inds[i];
    const int64_t z = idx % s3;
    const int64_t rem = idx / s3;
    const int64_t y = rem % s2;
    const int64_t x = rem / s2;
    float* dst_patch = out + i * patch_sz;
    for (int64_t j = 0; j < m; ++j) {
      const float* vol = vols[j];
      const float inv_sd = 1.0f / sd[j];
      const float mean = mu[j];
      for (int64_t a = 0; a < d1; ++a) {
        for (int64_t c = 0; c < d2; ++c) {
          const float* src =
              vol + ((x + a) * D2p + (y + c)) * D3p + z;
          float* dst = dst_patch + ((a * d2) + c) * out_depth + j * d3;
          for (int64_t w = 0; w < d3; ++w) {
            dst[w] = (src[w] - mean) * inv_sd;
          }
        }
      }
    }
  }
}

// Gather labels from the unpadded mask at the same indices.
void gather_labels_f32(const float* mask, int64_t s2, int64_t s3,
                       const int64_t* inds, int64_t b, float* out) {
  for (int64_t i = 0; i < b; ++i) {
    out[i] = mask[inds[i]];
  }
  (void)s2; (void)s3;
}

}  // extern "C"
