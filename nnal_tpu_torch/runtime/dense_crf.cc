// Native DenseCRF: permutohedral-lattice Gaussian filtering + Potts
// mean-field inference (the port's own copy of the JAX package's
// runtime/dense_crf.cc; the code below the header is that file's).
//
// The reference post-processes 2D posterior maps with pydensecrf's C++
// solver (PW_analyze_results.py:539-592: unary -log p, Gaussian
// smoothness sxy=3/compat=3 + bilateral appearance sxy=50/srgb/compat=10,
// 5 mean-field iterations).  This file is an in-repo replacement for that
// external dependency.  The torch `meanfield_crf_2d`
// (evaluation/crf.py) is the on-device option, but its truncated message
// window (radius ~5) cannot honor the reference's sxy=50 bilateral reach;
// this lattice solver computes the FULL dense pairwise model in O(N) per
// iteration.
//
// Filtering algorithm: Adams, Baek & Davis, "Fast High-Dimensional
// Filtering Using the Permutohedral Lattice" (Computer Graphics Forum
// 2010), implemented from the paper's construction: embed d-dim features
// into the hyperplane sum(x)=0 of R^{d+1}, locate each point's enclosing
// lattice simplex by rounding + residual ranking, splat with barycentric
// weights into a hash table of occupied lattice points, blur along each of
// the d+1 lattice axes with a (0.5, 1, 0.5) kernel, and slice back out.
// Normalization is symmetric (1/sqrt of the filtered all-ones vector on
// both sides), matching pydensecrf's default NORMALIZE_SYMMETRIC, so the
// lattice's global gain cancels exactly.
//
// Single-threaded: the CRF runs slice by slice on the host.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct KeyHash {
  size_t operator()(const std::vector<short>& k) const {
    size_t h = 1469598103934665603ull;  // FNV-1a over the key coords
    for (short v : k) {
      h ^= (size_t)(unsigned short)v;
      h *= 1099511628211ull;
    }
    return h;
  }
};

class Permutohedral {
 public:
  void init(const float* feat, int N, int d) {
    N_ = N;
    d_ = d;
    offset_.assign((size_t)N * (d + 1), 0);
    bary_.assign((size_t)N * (d + 1), 0.f);

    // feature scaling so that unit feature distance ~ the lattice's
    // inherent blur stddev (paper Sec. 4.1)
    std::vector<float> scale(d);
    const float inv_std = std::sqrt(2.f / 3.f) * (float)(d + 1);
    for (int i = 0; i < d; ++i)
      scale[i] = inv_std / std::sqrt((float)((i + 1) * (i + 2)));

    std::unordered_map<std::vector<short>, int, KeyHash> table;
    std::vector<float> elevated(d + 1), rem0(d + 1), bary(d + 2);
    std::vector<int> rank(d + 1);
    std::vector<short> key(d);

    for (int n = 0; n < N; ++n) {
      const float* f = feat + (size_t)n * d;

      // embed into H_d = {x in R^{d+1} : sum(x) = 0} (telescoped E matrix)
      float sm = 0.f;
      for (int j = d; j > 0; --j) {
        float cf = f[j - 1] * scale[j - 1];
        elevated[j] = sm - (float)j * cf;
        sm += cf;
      }
      elevated[0] = sm;

      // nearest multiple-of-(d+1) rounding = nearest 0-colored point
      int color_sum = 0;
      for (int i = 0; i <= d; ++i) {
        float v = elevated[i] / (float)(d + 1);
        float up = std::ceil(v) * (float)(d + 1);
        float dn = std::floor(v) * (float)(d + 1);
        rem0[i] = (up - elevated[i] < elevated[i] - dn) ? up : dn;
        color_sum += (int)std::lround(rem0[i] / (float)(d + 1));
      }

      // rank[i] = how many residual coords exceed residual i (descending
      // sort permutation of elevated - rem0)
      for (int i = 0; i <= d; ++i) rank[i] = 0;
      for (int i = 0; i < d; ++i) {
        float di = elevated[i] - rem0[i];
        for (int j = i + 1; j <= d; ++j) {
          if (di < elevated[j] - rem0[j])
            ++rank[i];
          else
            ++rank[j];
        }
      }

      // rounding may land off the plane (color_sum != 0): walk back
      for (int i = 0; i <= d; ++i) {
        rank[i] += color_sum;
        if (rank[i] < 0) {
          rank[i] += d + 1;
          rem0[i] += (float)(d + 1);
        } else if (rank[i] > d) {
          rank[i] -= d + 1;
          rem0[i] -= (float)(d + 1);
        }
      }

      // barycentric coords of the point inside its simplex, from the
      // sorted residual differences
      for (int i = 0; i <= d + 1; ++i) bary[i] = 0.f;
      for (int i = 0; i <= d; ++i) {
        float v = (elevated[i] - rem0[i]) / (float)(d + 1);
        bary[d - rank[i]] += v;
        bary[d - rank[i] + 1] -= v;
      }
      bary[0] += 1.f + bary[d + 1];

      // enumerate the d+1 simplex vertices; canonical vertex r adds r to
      // the coords of rank <= d-r and r-(d+1) to the rest.  Keys store the
      // first d coords (the last is implied by the zero-sum invariant).
      for (int r = 0; r <= d; ++r) {
        for (int i = 0; i < d; ++i) {
          int ki = (int)std::lround(rem0[i]) + r;
          if (rank[i] > d - r) ki -= d + 1;
          key[i] = (short)ki;
        }
        int id;
        auto it = table.find(key);
        if (it == table.end()) {
          id = (int)table.size();
          table.emplace(key, id);
          keys_.insert(keys_.end(), key.begin(), key.end());
        } else {
          id = it->second;
        }
        offset_[(size_t)n * (d + 1) + r] = id;
        bary_[(size_t)n * (d + 1) + r] = bary[r];
      }
    }
    M_ = (int)table.size();

    // blur neighbors: along lattice axis j the neighbors of a point differ
    // by +-((d+1)e_j - 1) in full coordinates; in the stored d coords that
    // is +-1 everywhere except coord j which moves by -+d (axis j = d only
    // touches the implied coordinate, leaving all stored coords at +-1)
    blur_n1_.assign((size_t)(d + 1) * M_, -1);
    blur_n2_.assign((size_t)(d + 1) * M_, -1);
    std::vector<short> n1(d), n2(d);
    for (int m = 0; m < M_; ++m) {
      const short* k = &keys_[(size_t)m * d];
      for (int j = 0; j <= d; ++j) {
        for (int i = 0; i < d; ++i) {
          n1[i] = (short)(k[i] + 1);
          n2[i] = (short)(k[i] - 1);
        }
        if (j < d) {
          n1[j] = (short)(k[j] - d);
          n2[j] = (short)(k[j] + d);
        }
        auto i1 = table.find(n1);
        auto i2 = table.find(n2);
        blur_n1_[(size_t)j * M_ + m] = (i1 == table.end()) ? -1 : i1->second;
        blur_n2_[(size_t)j * M_ + m] = (i2 == table.end()) ? -1 : i2->second;
      }
    }
  }

  // out (N, vd) ~= Gaussian filter exp(-||f_i - f_j||^2 / 2) applied to
  // in (N, vd), up to the lattice's constant gain (callers normalize).
  void compute(float* out, const float* in, int vd) const {
    // row 0 of the value buffers is a zero guard: missing blur neighbors
    // (-1) index it after the +1 shift
    std::vector<float> v0((size_t)(M_ + 1) * vd, 0.f);
    std::vector<float> v1((size_t)(M_ + 1) * vd, 0.f);
    float* oldv = v0.data();
    float* newv = v1.data();

    for (int n = 0; n < N_; ++n) {
      const float* src = in + (size_t)n * vd;
      for (int r = 0; r <= d_; ++r) {
        int o = offset_[(size_t)n * (d_ + 1) + r] + 1;
        float w = bary_[(size_t)n * (d_ + 1) + r];
        float* dst = oldv + (size_t)o * vd;
        for (int k = 0; k < vd; ++k) dst[k] += w * src[k];
      }
    }

    for (int j = 0; j <= d_; ++j) {
      for (int m = 0; m < M_; ++m) {
        const float* om = oldv + (size_t)(m + 1) * vd;
        const float* a =
            oldv + (size_t)(blur_n1_[(size_t)j * M_ + m] + 1) * vd;
        const float* b =
            oldv + (size_t)(blur_n2_[(size_t)j * M_ + m] + 1) * vd;
        float* nm = newv + (size_t)(m + 1) * vd;
        for (int k = 0; k < vd; ++k) nm[k] = om[k] + 0.5f * (a[k] + b[k]);
      }
      std::swap(oldv, newv);
    }

    const float alpha = 1.f / (1.f + std::pow(2.f, (float)-d_));
    for (int n = 0; n < N_; ++n) {
      float* dst = out + (size_t)n * vd;
      for (int k = 0; k < vd; ++k) dst[k] = 0.f;
      for (int r = 0; r <= d_; ++r) {
        int o = offset_[(size_t)n * (d_ + 1) + r] + 1;
        float w = alpha * bary_[(size_t)n * (d_ + 1) + r];
        const float* src = oldv + (size_t)o * vd;
        for (int k = 0; k < vd; ++k) dst[k] += w * src[k];
      }
    }
  }

  int lattice_points() const { return M_; }

 private:
  int N_ = 0, d_ = 0, M_ = 0;
  std::vector<int> offset_, blur_n1_, blur_n2_;
  std::vector<float> bary_;
  std::vector<short> keys_;
};

// q (N, C) = softmax(-e) rowwise, numerically stable
void softmax_neg(const float* e, float* q, int N, int C) {
  for (int n = 0; n < N; ++n) {
    const float* en = e + (size_t)n * C;
    float* qn = q + (size_t)n * C;
    float mn = en[0];
    for (int c = 1; c < C; ++c)
      if (en[c] < mn) mn = en[c];
    float z = 0.f;
    for (int c = 0; c < C; ++c) {
      qn[c] = std::exp(mn - en[c]);
      z += qn[c];
    }
    for (int c = 0; c < C; ++c) qn[c] /= z;
  }
}

// symmetric normalizer: 1/sqrt(lattice * ones), pointwise
void sym_norm(const Permutohedral& lat, int N, std::vector<float>& norm) {
  std::vector<float> ones((size_t)N, 1.f);
  norm.resize(N);
  lat.compute(norm.data(), ones.data(), 1);
  for (int n = 0; n < N; ++n)
    norm[n] = 1.f / std::sqrt(norm[n] > 1e-20f ? norm[n] : 1e-20f);
}

// E[n,l] += w * sum_{l' != l} msg[n,l'] with msg = norm * lat(norm * q)
// (Potts compatibility; self-interaction included, as in pydensecrf)
void add_potts_term(const Permutohedral& lat, const std::vector<float>& norm,
                    float w, const float* q, int N, int C, float* E,
                    std::vector<float>& tmp, std::vector<float>& filt) {
  for (int n = 0; n < N; ++n)
    for (int c = 0; c < C; ++c)
      tmp[(size_t)n * C + c] = norm[n] * q[(size_t)n * C + c];
  lat.compute(filt.data(), tmp.data(), C);
  for (int n = 0; n < N; ++n) {
    float s = 0.f;
    float* fn = filt.data() + (size_t)n * C;
    for (int c = 0; c < C; ++c) {
      fn[c] *= norm[n];
      s += fn[c];
    }
    float* en = E + (size_t)n * C;
    for (int c = 0; c < C; ++c) en[c] += w * (s - fn[c]);
  }
}

}  // namespace

extern "C" {

// Raw lattice filter, exposed for oracle tests: out (N, vd) = approximate
// Gaussian filter of values (N, vd) under features feat (N, d).
void nnal_permutohedral_filter(const float* feat, const float* values, int N,
                               int d, int vd, float* out) {
  Permutohedral lat;
  lat.init(feat, N, d);
  lat.compute(out, values, vd);
}

// Dense-CRF mean field over arbitrary pre-scaled feature spaces: the
// grid-agnostic core (2D slices, 3D volumes, or any point set).
//   unary:  (N, C) row-major negative log-posteriors
//   feat_g: (N, dg) smoothness features (already divided by their sigmas)
//   feat_b: (N, db) appearance features, may be null when w_b == 0
//   q_out:  (N, C) refined marginals
// Potts compatibility, symmetric normalization (pydensecrf's default).
void nnal_dcrf_meanfield_feats(const float* unary, const float* feat_g,
                               int dg, float w_g, const float* feat_b,
                               int db, float w_b, int N, int C, int iters,
                               float* q_out) {
  const bool bilat = (w_b != 0.f) && (feat_b != nullptr) && (db > 0);

  Permutohedral lat_g;
  lat_g.init(feat_g, N, dg);
  std::vector<float> norm_g;
  sym_norm(lat_g, N, norm_g);

  Permutohedral lat_b;
  std::vector<float> norm_b;
  if (bilat) {
    lat_b.init(feat_b, N, db);
    sym_norm(lat_b, N, norm_b);
  }

  std::vector<float> q((size_t)N * C), E((size_t)N * C);
  std::vector<float> tmp((size_t)N * C), filt((size_t)N * C);
  softmax_neg(unary, q.data(), N, C);

  for (int it = 0; it < iters; ++it) {
    std::memcpy(E.data(), unary, sizeof(float) * (size_t)N * C);
    add_potts_term(lat_g, norm_g, w_g, q.data(), N, C, E.data(), tmp, filt);
    if (bilat)
      add_potts_term(lat_b, norm_b, w_b, q.data(), N, C, E.data(), tmp,
                     filt);
    softmax_neg(E.data(), q.data(), N, C);
  }
  std::memcpy(q_out, q.data(), sizeof(float) * (size_t)N * C);
}

// Dense-CRF mean field on a 2D grid.
//   unary: (H*W, C) row-major negative log-posteriors
//   img:   (H*W, ch) guide image intensities (any scale; srgb matches it),
//          may be null when w_b == 0
//   q_out: (H*W, C) refined marginals
// Pairwise model (reference pydensecrf setup, PW_analyze_results.py:539):
//   w_g * Gaussian(sxy_g)  +  w_b * Bilateral(sxy_b, srgb), Potts labels.
void nnal_dcrf2d_meanfield(const float* unary, const float* img, int H,
                           int W, int C, int ch, float sxy_g, float w_g,
                           float sxy_b, float srgb, float w_b, int iters,
                           float* q_out) {
  const int N = H * W;
  const bool bilat = (w_b != 0.f) && (img != nullptr) && (ch > 0);

  std::vector<float> fg((size_t)N * 2);
  for (int y = 0; y < H; ++y)
    for (int x = 0; x < W; ++x) {
      fg[(size_t)(y * W + x) * 2 + 0] = (float)y / sxy_g;
      fg[(size_t)(y * W + x) * 2 + 1] = (float)x / sxy_g;
    }

  std::vector<float> fb;
  int db = 0;
  if (bilat) {
    db = 2 + ch;
    fb.resize((size_t)N * db);
    for (int y = 0; y < H; ++y)
      for (int x = 0; x < W; ++x) {
        size_t n = (size_t)y * W + x;
        fb[n * db + 0] = (float)y / sxy_b;
        fb[n * db + 1] = (float)x / sxy_b;
        for (int c = 0; c < ch; ++c)
          fb[n * db + 2 + c] = img[n * ch + c] / srgb;
      }
  }
  nnal_dcrf_meanfield_feats(unary, fg.data(), 2, w_g,
                            bilat ? fb.data() : nullptr, db,
                            bilat ? w_b : 0.f, N, C, iters, q_out);
}

}  // extern "C"
