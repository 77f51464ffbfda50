// Point-in-mesh test: 2-D triangle bucket grid + z-ray parity counting.
//
// Native replacement for the reference's libmesh/TriangleHash
// (lib_shape_prior/.../libmesh/inside_mesh.py:5-60, triangle_hash.pyx),
// used for volumetric IoU (evaluate.py:44-47). Triangles are bucketed on
// their (x, y) bounding boxes over a uniform grid; each query point casts a
// +z ray and counts crossings — odd parity = inside. OpenMP over queries.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Hash {
  std::vector<float> verts;
  std::vector<int64_t> tris;
  int res;
  float min_x, min_y, inv_cell_x, inv_cell_y;
  std::vector<std::vector<int32_t>> buckets;

  void Build(const float* v, int64_t nv, const int64_t* t, int64_t nt,
             int resolution) {
    verts.assign(v, v + 3 * nv);
    tris.assign(t, t + 3 * nt);
    res = resolution;
    float max_x = -1e30f, max_y = -1e30f;
    min_x = 1e30f;
    min_y = 1e30f;
    for (int64_t i = 0; i < nv; ++i) {
      min_x = std::min(min_x, v[3 * i]);
      max_x = std::max(max_x, v[3 * i]);
      min_y = std::min(min_y, v[3 * i + 1]);
      max_y = std::max(max_y, v[3 * i + 1]);
    }
    const float pad = 1e-4f;
    min_x -= pad; min_y -= pad; max_x += pad; max_y += pad;
    inv_cell_x = res / (max_x - min_x);
    inv_cell_y = res / (max_y - min_y);
    buckets.assign(static_cast<size_t>(res) * res, {});
    for (int64_t f = 0; f < nt; ++f) {
      float tlo_x = 1e30f, thi_x = -1e30f, tlo_y = 1e30f, thi_y = -1e30f;
      for (int k = 0; k < 3; ++k) {
        const float* p = &verts[3 * tris[3 * f + k]];
        tlo_x = std::min(tlo_x, p[0]); thi_x = std::max(thi_x, p[0]);
        tlo_y = std::min(tlo_y, p[1]); thi_y = std::max(thi_y, p[1]);
      }
      int cx0 = Clamp(static_cast<int>((tlo_x - min_x) * inv_cell_x));
      int cx1 = Clamp(static_cast<int>((thi_x - min_x) * inv_cell_x));
      int cy0 = Clamp(static_cast<int>((tlo_y - min_y) * inv_cell_y));
      int cy1 = Clamp(static_cast<int>((thi_y - min_y) * inv_cell_y));
      for (int cx = cx0; cx <= cx1; ++cx)
        for (int cy = cy0; cy <= cy1; ++cy)
          buckets[static_cast<size_t>(cx) * res + cy].push_back(
              static_cast<int32_t>(f));
    }
  }

  int Clamp(int c) const { return std::max(0, std::min(res - 1, c)); }

  // Parity of +z ray crossings from point q. The (x, y) coordinates are
  // nudged by an irrational sub-cell offset so rays never pass exactly
  // through mesh vertices/edges (which would double-count crossings on
  // symmetric grids).
  bool Inside(const float* q_in) const {
    const float eps_x = 0.70710678e-5f / inv_cell_x;
    const float eps_y = 0.57735027e-5f / inv_cell_y;
    const float q[3] = {q_in[0] + eps_x, q_in[1] + eps_y, q_in[2]};
    int cx = static_cast<int>((q[0] - min_x) * inv_cell_x);
    int cy = static_cast<int>((q[1] - min_y) * inv_cell_y);
    if (cx < 0 || cx >= res || cy < 0 || cy >= res) return false;
    int crossings = 0;
    for (int32_t f : buckets[static_cast<size_t>(cx) * res + cy]) {
      const float* a = &verts[3 * tris[3 * f]];
      const float* b = &verts[3 * tris[3 * f + 1]];
      const float* c = &verts[3 * tris[3 * f + 2]];
      // 2-D barycentric test in (x, y).
      double d = (double)(b[1] - c[1]) * (a[0] - c[0]) +
                 (double)(c[0] - b[0]) * (a[1] - c[1]);
      if (std::fabs(d) < 1e-18) continue;
      double w0 = ((double)(b[1] - c[1]) * (q[0] - c[0]) +
                   (double)(c[0] - b[0]) * (q[1] - c[1])) / d;
      double w1 = ((double)(c[1] - a[1]) * (q[0] - c[0]) +
                   (double)(a[0] - c[0]) * (q[1] - c[1])) / d;
      double w2 = 1.0 - w0 - w1;
      if (w0 < 0 || w1 < 0 || w2 < 0) continue;
      double z = w0 * a[2] + w1 * b[2] + w2 * c[2];
      if (z > q[2]) ++crossings;
    }
    return (crossings % 2) == 1;
  }
};

}  // namespace

extern "C" {

Hash* inside_mesh_build(const float* verts, int64_t nv, const int64_t* tris,
                        int64_t nt, int resolution) {
  auto* h = new Hash();
  h->Build(verts, nv, tris, nt, resolution);
  return h;
}

void inside_mesh_query(const Hash* h, const float* queries, int64_t m,
                       uint8_t* out_inside) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < m; ++i)
    out_inside[i] = h->Inside(&queries[3 * i]) ? 1 : 0;
}

void inside_mesh_free(Hash* h) { delete h; }

}  // extern "C"
