// KD-tree nearest-neighbor queries on the host, OpenMP-parallel.
//
// Native replacement for the reference's vendored pykdtree
// (lib_shape_prior/.../libkdtree) used by the metric suite (chamfer
// distance, evaluate.py:33-40). Median-split build, iterative-recursion
// query with branch pruning. float32, 3-D points (the only case the
// pipeline needs).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Node {
  float split;       // split coordinate
  int32_t axis;      // -1 for leaf
  int32_t left, right;
  int32_t begin, end;  // leaf point range (indices into order)
};

struct Tree {
  std::vector<float> pts;      // 3 * n
  std::vector<int32_t> order;  // permutation of point ids
  std::vector<Node> nodes;
  int32_t root = -1;
  static constexpr int kLeafSize = 16;

  int32_t Build(int32_t begin, int32_t end, int depth) {
    Node node;
    node.begin = begin;
    node.end = end;
    node.left = node.right = -1;
    if (end - begin <= kLeafSize) {
      node.axis = -1;
      node.split = 0;
      nodes.push_back(node);
      return static_cast<int32_t>(nodes.size() - 1);
    }
    // Pick the axis with the largest extent.
    float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
    for (int32_t i = begin; i < end; ++i) {
      const float* p = &pts[3 * order[i]];
      for (int a = 0; a < 3; ++a) {
        lo[a] = std::min(lo[a], p[a]);
        hi[a] = std::max(hi[a], p[a]);
      }
    }
    int axis = 0;
    float ext = hi[0] - lo[0];
    for (int a = 1; a < 3; ++a)
      if (hi[a] - lo[a] > ext) {
        ext = hi[a] - lo[a];
        axis = a;
      }
    int32_t mid = (begin + end) / 2;
    std::nth_element(
        order.begin() + begin, order.begin() + mid, order.begin() + end,
        [&](int32_t a, int32_t b) { return pts[3 * a + axis] < pts[3 * b + axis]; });
    node.axis = axis;
    node.split = pts[3 * order[mid] + axis];
    int32_t self = static_cast<int32_t>(nodes.size());
    nodes.push_back(node);
    int32_t l = Build(begin, mid, depth + 1);
    int32_t r = Build(mid, end, depth + 1);
    nodes[self].left = l;
    nodes[self].right = r;
    return self;
  }

  void Query1(const float* q, float& best_d2, int32_t& best_id,
              int32_t node_id) const {
    const Node& n = nodes[node_id];
    if (n.axis < 0) {
      for (int32_t i = n.begin; i < n.end; ++i) {
        const float* p = &pts[3 * order[i]];
        float dx = p[0] - q[0], dy = p[1] - q[1], dz = p[2] - q[2];
        float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 < best_d2) {
          best_d2 = d2;
          best_id = order[i];
        }
      }
      return;
    }
    float diff = q[n.axis] - n.split;
    int32_t near = diff <= 0 ? n.left : n.right;
    int32_t far = diff <= 0 ? n.right : n.left;
    Query1(q, best_d2, best_id, near);
    if (diff * diff < best_d2) Query1(q, best_d2, best_id, far);
  }

  // k-NN: bounded max-heap over (d2, id) pairs (parity with pykdtree's
  // k>1 queries, libkdtree/pykdtree/kdtree.pyx:132).
  struct Heap {
    float* d2;     // heap-ordered, d2[0] is the current worst
    int32_t* ids;
    int32_t k, count;
    float worst() const {
      return count < k ? std::numeric_limits<float>::max() : d2[0];
    }
    void push(float d, int32_t id) {
      if (count < k) {
        int32_t i = count++;
        d2[i] = d; ids[i] = id;
        while (i > 0) {
          int32_t p = (i - 1) / 2;
          if (d2[p] >= d2[i]) break;
          std::swap(d2[p], d2[i]); std::swap(ids[p], ids[i]);
          i = p;
        }
      } else if (d < d2[0]) {
        d2[0] = d; ids[0] = id;
        int32_t i = 0;
        for (;;) {
          int32_t l = 2 * i + 1, r = l + 1, big = i;
          if (l < k && d2[l] > d2[big]) big = l;
          if (r < k && d2[r] > d2[big]) big = r;
          if (big == i) break;
          std::swap(d2[big], d2[i]); std::swap(ids[big], ids[i]);
          i = big;
        }
      }
    }
  };

  void QueryK(const float* q, Heap& heap, int32_t node_id) const {
    const Node& n = nodes[node_id];
    if (n.axis < 0) {
      for (int32_t i = n.begin; i < n.end; ++i) {
        const float* p = &pts[3 * order[i]];
        float dx = p[0] - q[0], dy = p[1] - q[1], dz = p[2] - q[2];
        heap.push(dx * dx + dy * dy + dz * dz, order[i]);
      }
      return;
    }
    float diff = q[n.axis] - n.split;
    int32_t near = diff <= 0 ? n.left : n.right;
    int32_t far = diff <= 0 ? n.right : n.left;
    QueryK(q, heap, near);
    if (diff * diff < heap.worst()) QueryK(q, heap, far);
  }
};

}  // namespace

extern "C" {

Tree* kdtree_build(const float* points, int64_t n) {
  auto* t = new Tree();
  t->pts.assign(points, points + 3 * n);
  t->order.resize(n);
  for (int64_t i = 0; i < n; ++i) t->order[i] = static_cast<int32_t>(i);
  t->root = t->Build(0, static_cast<int32_t>(n), 0);
  return t;
}

void kdtree_query(const Tree* t, const float* queries, int64_t m,
                  float* out_dist, int32_t* out_idx) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < m; ++i) {
    float best_d2 = std::numeric_limits<float>::max();
    int32_t best_id = -1;
    t->Query1(&queries[3 * i], best_d2, best_id, t->root);
    out_dist[i] = std::sqrt(best_d2);
    out_idx[i] = best_id;
  }
}

void kdtree_free(Tree* t) { delete t; }

// k-NN queries: out_dist/out_idx are (m, k), sorted ascending per query;
// slots past the point count get dist=inf, idx=-1.
void kdtree_query_k(const Tree* t, const float* queries, int64_t m,
                    int32_t k, float* out_dist, int32_t* out_idx) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < m; ++i) {
    std::vector<float> d2(k, std::numeric_limits<float>::max());
    std::vector<int32_t> ids(k, -1);
    Tree::Heap heap{d2.data(), ids.data(), k, 0};
    t->QueryK(&queries[3 * i], heap, t->root);
    // heap -> ascending order
    std::vector<int32_t> perm(heap.count);
    for (int32_t j = 0; j < heap.count; ++j) perm[j] = j;
    std::sort(perm.begin(), perm.end(),
              [&](int32_t a, int32_t b) { return d2[a] < d2[b]; });
    for (int32_t j = 0; j < k; ++j) {
      if (j < heap.count) {
        out_dist[i * k + j] = std::sqrt(d2[perm[j]]);
        out_idx[i * k + j] = ids[perm[j]];
      } else {
        out_dist[i * k + j] = std::numeric_limits<float>::infinity();
        out_idx[i * k + j] = -1;
      }
    }
  }
}

}  // extern "C"
