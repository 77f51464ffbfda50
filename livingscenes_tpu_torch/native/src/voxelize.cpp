// Mesh voxelization via triangle-box overlap (separating axis theorem).
//
// Native replacement for the reference's libvoxelize (voxelize.pyx +
// tribox2.h, Moeller's triangle-box test). Marks every voxel whose cell
// overlaps any triangle of the mesh; vertices are expected in voxel-grid
// coordinates ([0, res] per axis).

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

struct V3 {
  float x, y, z;
  V3 operator-(const V3& o) const { return {x - o.x, y - o.y, z - o.z}; }
  V3 Cross(const V3& o) const {
    return {y * o.z - z * o.y, z * o.x - x * o.z, x * o.y - y * o.x};
  }
  float Dot(const V3& o) const { return x * o.x + y * o.y + z * o.z; }
  float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

// Project triangle verts onto axis; check interval vs box half-extent h.
static bool AxisSeparates(const V3& axis, const V3& a, const V3& b,
                          const V3& c, const V3& h) {
  float pa = axis.Dot(a), pb = axis.Dot(b), pc = axis.Dot(c);
  float mn = std::min({pa, pb, pc});
  float mx = std::max({pa, pb, pc});
  float r = h.x * std::fabs(axis.x) + h.y * std::fabs(axis.y) +
            h.z * std::fabs(axis.z);
  return mn > r || mx < -r;
}

// Separating-axis triangle/axis-aligned-box overlap; box centered at
// origin with half extents h, triangle at a,b,c (box-relative).
static bool TriBoxOverlap(const V3& a, const V3& b, const V3& c,
                          const V3& h) {
  // 1) box face normals (AABB test)
  for (int i = 0; i < 3; ++i) {
    float mn = std::min({a[i], b[i], c[i]});
    float mx = std::max({a[i], b[i], c[i]});
    float r = h[i];
    if (mn > r || mx < -r) return false;
  }
  // 2) triangle normal plane
  V3 e0 = b - a, e1 = c - b, e2 = a - c;
  V3 n = e0.Cross(e1);
  float d = n.Dot(a);
  float r = h.x * std::fabs(n.x) + h.y * std::fabs(n.y) +
            h.z * std::fabs(n.z);
  if (d > r || d < -r) return false;
  // 3) nine cross-product axes
  const V3 axes[3] = {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}};
  const V3 edges[3] = {e0, e1, e2};
  for (const V3& u : axes)
    for (const V3& e : edges) {
      V3 axis = u.Cross(e);
      if (std::fabs(axis.x) + std::fabs(axis.y) + std::fabs(axis.z) < 1e-12)
        continue;
      if (AxisSeparates(axis, a, b, c, h)) return false;
    }
  return true;
}

}  // namespace

extern "C" {

// verts in grid coordinates ([0, nx] x [0, ny] x [0, nz]); occ_out is a
// (nx, ny, nz) uint8 grid, set to 1 where a triangle overlaps the voxel.
void voxelize_mesh(const float* verts, int64_t nv, const int64_t* tris,
                   int64_t nt, int nx, int ny, int nz, uint8_t* occ_out) {
  const V3 h{0.5f, 0.5f, 0.5f};
  for (int64_t f = 0; f < nt; ++f) {
    V3 a{verts[3 * tris[3 * f]], verts[3 * tris[3 * f] + 1],
         verts[3 * tris[3 * f] + 2]};
    V3 b{verts[3 * tris[3 * f + 1]], verts[3 * tris[3 * f + 1] + 1],
         verts[3 * tris[3 * f + 1] + 2]};
    V3 c{verts[3 * tris[3 * f + 2]], verts[3 * tris[3 * f + 2] + 1],
         verts[3 * tris[3 * f + 2] + 2]};
    int x0 = std::max(0, (int)std::floor(std::min({a.x, b.x, c.x})));
    int x1 = std::min(nx - 1, (int)std::floor(std::max({a.x, b.x, c.x})));
    int y0 = std::max(0, (int)std::floor(std::min({a.y, b.y, c.y})));
    int y1 = std::min(ny - 1, (int)std::floor(std::max({a.y, b.y, c.y})));
    int z0 = std::max(0, (int)std::floor(std::min({a.z, b.z, c.z})));
    int z1 = std::min(nz - 1, (int)std::floor(std::max({a.z, b.z, c.z})));
    for (int x = x0; x <= x1; ++x)
      for (int y = y0; y <= y1; ++y)
        for (int z = z0; z <= z1; ++z) {
          V3 center{x + 0.5f, y + 0.5f, z + 0.5f};
          if (TriBoxOverlap(a - center, b - center, c - center, h))
            occ_out[(size_t)x * ny * nz + (size_t)y * nz + z] = 1;
        }
  }
}

}  // extern "C"
