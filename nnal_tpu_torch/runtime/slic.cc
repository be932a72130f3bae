// Native SLIC superpixels for the SuPix querying path.
//
// The reference oversegments slices with skimage.segmentation.slic (a C
// implementation; PW_NNAL.py:1, PW_AL.py:1168-1293).  The rebuild's
// from-scratch NumPy SLIC (scoring/superpixel.py) is the semantic oracle;
// this file is the production path: the identical algorithm — same grid
// seeds, same windowed strict-less-than assignment with centers visited in
// index order, same centroid update, double precision throughout — so the
// two implementations agree to floating-point noise, at native speed (the
// NumPy centroid update is O(H*W*n_centers) boolean work per iteration;
// here it is one O(H*W) accumulation pass).
//
// Seeds/centers are computed by the Python wrapper (identically to the
// NumPy path) and passed in, guaranteeing seed parity by construction.

#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

extern "C" {

// img: (H, W) float64 row-major; centers: (n, 3) float64 [intensity, y, x]
// (mutated in place, matching the NumPy path's center updates);
// labels_out: (H, W) int32.
void nnal_slic2d(const double* img, int H, int W, double* centers, int n,
                 int S, double compactness, int n_iter,
                 int32_t* labels_out) {
  const double ratio = compactness / (double)S;
  std::vector<double> dists((size_t)H * W);
  std::vector<double> sum_l(n), sum_y(n), sum_x(n);
  std::vector<int64_t> cnt(n);

  for (int32_t i = 0; i < (int32_t)((size_t)H * W); ++i) labels_out[i] = 0;

  for (int it = 0; it < n_iter; ++it) {
    for (size_t i = 0; i < (size_t)H * W; ++i)
      dists[i] = std::numeric_limits<double>::infinity();

    // assignment: centers visited in index order; strict < keeps the
    // earliest center on ties (matching the NumPy `d < win` update)
    for (int ci = 0; ci < n; ++ci) {
      const double c_l = centers[(size_t)ci * 3 + 0];
      const double c_y = centers[(size_t)ci * 3 + 1];
      const double c_x = centers[(size_t)ci * 3 + 2];
      const int y0 = (int)std::max(c_y - S, 0.0);
      const int y1 = (int)std::min(c_y + S + 1, (double)H);
      const int x0 = (int)std::max(c_x - S, 0.0);
      const int x1 = (int)std::min(c_x + S + 1, (double)W);
      for (int y = y0; y < y1; ++y) {
        const double dy = (double)y - c_y;
        for (int x = x0; x < x1; ++x) {
          const double dx = (double)x - c_x;
          const double d = std::fabs(img[(size_t)y * W + x] - c_l) +
                           ratio * std::sqrt(dy * dy + dx * dx);
          if (d < dists[(size_t)y * W + x]) {
            dists[(size_t)y * W + x] = d;
            labels_out[(size_t)y * W + x] = ci;
          }
        }
      }
    }

    // centroid update: one accumulation pass over the image
    for (int ci = 0; ci < n; ++ci) {
      sum_l[ci] = sum_y[ci] = sum_x[ci] = 0.0;
      cnt[ci] = 0;
    }
    for (int y = 0; y < H; ++y)
      for (int x = 0; x < W; ++x) {
        const int ci = labels_out[(size_t)y * W + x];
        sum_l[ci] += img[(size_t)y * W + x];
        sum_y[ci] += (double)y;
        sum_x[ci] += (double)x;
        ++cnt[ci];
      }
    for (int ci = 0; ci < n; ++ci)
      if (cnt[ci] > 0) {
        centers[(size_t)ci * 3 + 0] = sum_l[ci] / (double)cnt[ci];
        centers[(size_t)ci * 3 + 1] = sum_y[ci] / (double)cnt[ci];
        centers[(size_t)ci * 3 + 2] = sum_x[ci] / (double)cnt[ci];
      }
  }
}

}  // extern "C"
