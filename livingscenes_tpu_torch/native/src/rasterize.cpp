// Depth-map rasterization of triangle meshes (z-buffer, scanline-free
// bounding-box traversal with barycentric tests).
//
// Native host-op behind the framework's training-data creation pipeline —
// the role the reference fills with pyrender EGL offscreen rendering
// (utils/render.py:50 render_depth; pyrender_helper_*.py). Produces a
// depth image under a pinhole camera looking down -z in camera space;
// back-projection to partial point clouds happens in Python
// (recon/render.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// verts: (V, 3) camera-space coordinates (camera at origin, looking -z,
// y up). K = [fx, fy, cx, cy]. depth_out: (h, w) row-major, 0 = no hit.
void rasterize_depth(const float* verts, int64_t nv, const int64_t* tris,
                     int64_t nt, float fx, float fy, float cx, float cy,
                     int w, int h, float* depth_out) {
  std::fill(depth_out, depth_out + (size_t)w * h, 0.0f);
  std::vector<float> zbuf((size_t)w * h, 1e30f);

  // Project all vertices: u = fx * x / (-z) + cx, v = fy * -y / (-z) + cy
  // (image v grows downward).
  std::vector<float> px(nv), py(nv), pz(nv);
  for (int64_t i = 0; i < nv; ++i) {
    float x = verts[3 * i], y = verts[3 * i + 1], z = verts[3 * i + 2];
    float d = -z;  // positive depth in front of the camera
    pz[i] = d;
    if (d <= 1e-6f) {
      px[i] = -1e9f;
      py[i] = -1e9f;
      continue;
    }
    px[i] = fx * x / d + cx;
    py[i] = cy - fy * y / d;
  }

  for (int64_t f = 0; f < nt; ++f) {
    int64_t i0 = tris[3 * f], i1 = tris[3 * f + 1], i2 = tris[3 * f + 2];
    if (pz[i0] <= 1e-6f || pz[i1] <= 1e-6f || pz[i2] <= 1e-6f) continue;
    float x0 = px[i0], y0 = py[i0], x1 = px[i1], y1 = py[i1], x2 = px[i2],
          y2 = py[i2];
    int min_x = std::max(0, (int)std::floor(std::min({x0, x1, x2})));
    int max_x = std::min(w - 1, (int)std::ceil(std::max({x0, x1, x2})));
    int min_y = std::max(0, (int)std::floor(std::min({y0, y1, y2})));
    int max_y = std::min(h - 1, (int)std::ceil(std::max({y0, y1, y2})));
    if (min_x > max_x || min_y > max_y) continue;
    double den = (double)(y1 - y2) * (x0 - x2) + (double)(x2 - x1) * (y0 - y2);
    if (std::fabs(den) < 1e-12) continue;
    // Interpolate 1/z for perspective-correct depth.
    float iz0 = 1.0f / pz[i0], iz1 = 1.0f / pz[i1], iz2 = 1.0f / pz[i2];
    for (int yy = min_y; yy <= max_y; ++yy) {
      for (int xx = min_x; xx <= max_x; ++xx) {
        float qx = xx + 0.5f, qy = yy + 0.5f;
        double w0 = ((double)(y1 - y2) * (qx - x2) +
                     (double)(x2 - x1) * (qy - y2)) / den;
        double w1 = ((double)(y2 - y0) * (qx - x2) +
                     (double)(x0 - x2) * (qy - y2)) / den;
        double w2 = 1.0 - w0 - w1;
        if (w0 < 0 || w1 < 0 || w2 < 0) continue;
        float iz = (float)(w0 * iz0 + w1 * iz1 + w2 * iz2);
        float z = 1.0f / iz;
        size_t pix = (size_t)yy * w + xx;
        if (z < zbuf[pix]) {
          zbuf[pix] = z;
          depth_out[pix] = z;
        }
      }
    }
  }
}

}  // extern "C"
