// Quadric-error-metric mesh simplification (Garland & Heckbert style).
//
// Native host-op replacing the reference's vendored simplifier
// (lib_shape_prior/.../libsimplify, Fast-Quadric-Mesh-Simplification).
// Fresh implementation: per-vertex plane quadrics, greedy edge collapse by a
// lazy min-heap of collapse costs, optimal-position solve with midpoint
// fallback, and a normal-flip guard.

#include <algorithm>
#include <array>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Quadric {
  // Symmetric 4x4 stored as upper triangle (10 coefficients).
  double m[10] = {0};

  void AddPlane(double a, double b, double c, double d) {
    m[0] += a * a; m[1] += a * b; m[2] += a * c; m[3] += a * d;
    m[4] += b * b; m[5] += b * c; m[6] += b * d;
    m[7] += c * c; m[8] += c * d;
    m[9] += d * d;
  }
  void Add(const Quadric& o) {
    for (int i = 0; i < 10; ++i) m[i] += o.m[i];
  }
  double Eval(double x, double y, double z) const {
    return m[0] * x * x + 2 * m[1] * x * y + 2 * m[2] * x * z + 2 * m[3] * x +
           m[4] * y * y + 2 * m[5] * y * z + 2 * m[6] * y +
           m[7] * z * z + 2 * m[8] * z + m[9];
  }
  // Solve grad(vQv) = 0 -> 3x3 linear system. Returns false if singular.
  bool Optimal(double& x, double& y, double& z) const {
    const double a00 = m[0], a01 = m[1], a02 = m[2];
    const double a11 = m[4], a12 = m[5], a22 = m[7];
    const double b0 = -m[3], b1 = -m[6], b2 = -m[8];
    const double det = a00 * (a11 * a22 - a12 * a12) -
                       a01 * (a01 * a22 - a12 * a02) +
                       a02 * (a01 * a12 - a11 * a02);
    if (std::fabs(det) < 1e-12) return false;
    const double inv = 1.0 / det;
    x = inv * (b0 * (a11 * a22 - a12 * a12) + b1 * (a02 * a12 - a01 * a22) +
               b2 * (a01 * a12 - a02 * a11));
    y = inv * (b0 * (a12 * a02 - a01 * a22) + b1 * (a00 * a22 - a02 * a02) +
               b2 * (a01 * a02 - a00 * a12));
    z = inv * (b0 * (a01 * a12 - a11 * a02) + b1 * (a01 * a02 - a00 * a12) +
               b2 * (a00 * a11 - a01 * a01));
    return std::isfinite(x) && std::isfinite(y) && std::isfinite(z);
  }
};

struct Vec3 {
  double x, y, z;
  Vec3 operator-(const Vec3& o) const { return {x - o.x, y - o.y, z - o.z}; }
  Vec3 Cross(const Vec3& o) const {
    return {y * o.z - z * o.y, z * o.x - x * o.z, x * o.y - y * o.x};
  }
  double Dot(const Vec3& o) const { return x * o.x + y * o.y + z * o.z; }
  double Norm() const { return std::sqrt(x * x + y * y + z * z); }
};

struct Candidate {
  double cost;
  int64_t v0, v1;
  uint64_t stamp;  // sum of vertex versions at push time (lazy invalidation)
  bool operator<(const Candidate& o) const { return cost > o.cost; }
};

struct Simplifier {
  std::vector<Vec3> pos;
  std::vector<Quadric> quadric;
  std::vector<uint64_t> version;
  std::vector<std::array<int64_t, 3>> faces;
  std::vector<char> face_alive;
  std::vector<std::vector<int64_t>> vertex_faces;
  int64_t alive_count = 0;
  // Min-heap managed directly (std::make/push/pop_heap) so Init can bulk
  // heapify the seed edges in O(E) instead of E log E pushes.
  std::vector<Candidate> heap;
  // Latest push stamp per (translated) edge key. A popped entry whose
  // stamp doesn't match is an OUTDATED COPY — a fresher push of the same
  // edge is already in the heap — and is dropped instead of re-costed.
  // Without this, stale copies chain-react: every pop of an old copy
  // re-pushed yet another copy, and the profile showed 7x more quadric
  // re-solves than collapses (865k re-costs for 122k collapses at 250k
  // faces). Keys use stable vertex ids (never reused), so entries for
  // retired keys are dead weight, not collisions.
  std::unordered_map<uint64_t, uint64_t> latest_stamp;
  // Retired-vertex remap (union-find with path halving): heap entries
  // naming collapsed vertices are translated to their survivors on pop
  // instead of eagerly re-pushing every incident edge per collapse.
  std::vector<int64_t> parent;
  // Profile counters (filled when LSTPU_SIMPLIFY_PROFILE=1 reads them).
  double prepass_ms = 0, seed_ms = 0;
  int64_t prepass_costs = 0, prepass_collapses = 0, heap_pops = 0;
  // Absolute deferral penalty for normal-flip-vetoed candidates. A
  // multiplicative penalty alone spins forever on the zero-cost sliver
  // edges marching-tetrahedra meshes are full of (0 * k stays at the
  // heap top); this pushes them behind all genuinely-cheap collapses.
  double veto_eps = 1e-12;

  int64_t Find(int64_t v) {
    while (parent[v] != v) {
      parent[v] = parent[parent[v]];
      v = parent[v];
    }
    return v;
  }

  static uint64_t PairKey(int64_t a, int64_t b) {
    if (a > b) std::swap(a, b);
    return (static_cast<uint64_t>(a) << 32) | static_cast<uint64_t>(b);
  }

  void Init(const float* verts, int64_t nv, const int64_t* tris, int64_t nf) {
    pos.resize(nv);
    for (int64_t i = 0; i < nv; ++i)
      pos[i] = {verts[3 * i], verts[3 * i + 1], verts[3 * i + 2]};
    quadric.assign(nv, Quadric());
    version.assign(nv, 0);
    parent.resize(nv);
    for (int64_t i = 0; i < nv; ++i) parent[i] = i;
    Vec3 lo = pos.empty() ? Vec3{0, 0, 0} : pos[0], hi = lo;
    for (const Vec3& p : pos) {
      lo = {std::min(lo.x, p.x), std::min(lo.y, p.y), std::min(lo.z, p.z)};
      hi = {std::max(hi.x, p.x), std::max(hi.y, p.y), std::max(hi.z, p.z)};
    }
    const Vec3 ext = hi - lo;
    veto_eps = 1e-9 * (ext.Dot(ext) + 1e-30);
    faces.resize(nf);
    face_alive.assign(nf, 1);
    alive_count = nf;
    // Adjacency with exact per-vertex reserve: the incremental
    // push_back build cost ~500k reallocations at 250k faces (~half of
    // a 630 ms Init).
    std::vector<int32_t> deg(nv, 0);
    for (int64_t f = 0; f < nf; ++f) {
      faces[f] = {tris[3 * f], tris[3 * f + 1], tris[3 * f + 2]};
      for (int k = 0; k < 3; ++k) ++deg[faces[f][k]];
    }
    vertex_faces.assign(nv, {});
    for (int64_t v = 0; v < nv; ++v) vertex_faces[v].reserve(deg[v] + 4);
    for (int64_t f = 0; f < nf; ++f) {
      for (int k = 0; k < 3; ++k) vertex_faces[faces[f][k]].push_back(f);
      AddFaceQuadric(f);
    }
    // Heap seeding happens in Run(), after the threshold pre-pass, so
    // only the surviving edges are costed into the heap (sort + unique
    // over packed keys — an unordered_set at this volume was ~3x
    // slower — then one O(E) make_heap).
  }

  void AddFaceQuadric(int64_t f) {
    const Vec3 &p0 = pos[faces[f][0]], &p1 = pos[faces[f][1]],
               &p2 = pos[faces[f][2]];
    Vec3 n = (p1 - p0).Cross(p2 - p0);
    double len = n.Norm();
    if (len < 1e-15) return;
    n = {n.x / len, n.y / len, n.z / len};
    double d = -n.Dot(p0);
    for (int k = 0; k < 3; ++k)
      quadric[faces[f][k]].AddPlane(n.x, n.y, n.z, d);
  }

  void PushCandidate(int64_t a, int64_t b, bool heapify = true) {
    const double cost = EdgeCost(a, b);  // ONE cost model for heap+collapse
    const uint64_t stamp = version[a] + version[b];
    latest_stamp[PairKey(a, b)] = stamp;
    heap.push_back({cost, a, b, stamp});
    if (heapify) std::push_heap(heap.begin(), heap.end());
  }

  // Cost + optimal position of collapsing (a, b).
  double EdgeCost(int64_t a, int64_t b, Vec3* p_out = nullptr) const {
    Quadric q = quadric[a];
    q.Add(quadric[b]);
    Vec3 p;
    double cost;
    if (q.Optimal(p.x, p.y, p.z)) {
      cost = q.Eval(p.x, p.y, p.z);
    } else {
      const Vec3 mid{(pos[a].x + pos[b].x) / 2, (pos[a].y + pos[b].y) / 2,
                     (pos[a].z + pos[b].z) / 2};
      double c0 = q.Eval(pos[a].x, pos[a].y, pos[a].z);
      double c1 = q.Eval(pos[b].x, pos[b].y, pos[b].z);
      double cm = q.Eval(mid.x, mid.y, mid.z);
      cost = std::min({c0, c1, cm});
      p = cost == c0 ? pos[a] : (cost == c1 ? pos[b] : mid);
    }
    if (p_out) *p_out = p;
    return cost;
  }

  // Collapse v1 into v0 at position p with combined quadric q.
  void CollapseEdge(int64_t v0, int64_t v1, const Vec3& p) {
    Quadric q = quadric[v0];
    q.Add(quadric[v1]);
    pos[v0] = p;
    quadric[v0] = q;
    version[v0]++;
    parent[v1] = v0;
    for (int64_t f : vertex_faces[v1]) {
      if (!face_alive[f]) continue;
      auto& fc = faces[f];
      bool has0 = fc[0] == v0 || fc[1] == v0 || fc[2] == v0;
      if (has0) {
        face_alive[f] = 0;
        --alive_count;
      } else {
        for (int k = 0; k < 3; ++k)
          if (fc[k] == v1) fc[k] = v0;
        vertex_faces[v0].push_back(f);
      }
    }
    vertex_faces[v1].clear();
    // Compact v0's face list: without this, dead faces accumulate on
    // collapse "super-vertices" and FlipsNormal/neighbor scans degrade
    // to O(n) per collapse (measured 38 s on a 200k-face mesh).
    auto& vf = vertex_faces[v0];
    vf.erase(std::remove_if(vf.begin(), vf.end(),
                            [&](int64_t f) { return !face_alive[f]; }),
             vf.end());
  }

  // Bulk reduction before the heap phase: most collapses on a dense
  // isosurface mesh are "cheap" ones whose exact greedy order doesn't
  // matter. Per round, cost every edge once, pick the cost quantile
  // that yields the needed collapse count, and sweep the faces in scan
  // order collapsing edges under that threshold (a per-round dirty
  // guard keeps the sweep from cascading through just-moved
  // neighborhoods; the same normal-flip veto applies). The exact
  // lazy-heap phase then only handles the last ~4x reduction, where
  // order matters. Profile at 250k->5k faces: the heap phase alone
  // spent ~1.5 s (711k pops / 347k re-costs of a 12 MB heap); the
  // sweep does the same collapses with linear scans.
  struct PreEdge {
    double cost;
    int64_t a, b;
    Vec3 p;  // optimal collapse position at cost time
  };

  void ThresholdPrePass(int64_t stop_faces) {
    std::vector<char> dirty(pos.size(), 0);
    std::vector<PreEdge> edges;
    std::vector<double> costs;
    for (int round = 0; round < 12 && alive_count > stop_faces; ++round) {
      // One cost pass per round. The sweep below reuses these cached
      // (cost, position) pairs: the dirty guard already skips any edge
      // whose endpoint moved this round, and for clean endpoints the
      // cached cost IS the current cost — so the old second
      // EdgeCost-per-edge sweep (half the prepass time) is pure waste.
      edges.clear();
      for (int64_t f = 0; f < (int64_t)faces.size(); ++f) {
        if (!face_alive[f]) continue;
        const auto& fc = faces[f];
        for (int k = 0; k < 3; ++k) {
          int64_t a = fc[k], b = fc[(k + 1) % 3];
          if (a < b) {
            PreEdge e{0, a, b, {}};
            e.cost = EdgeCost(a, b, &e.p);
            edges.push_back(e);
            ++prepass_costs;
          }
        }
      }
      if (edges.empty()) break;
      // Each collapse removes ~2 faces; aim the threshold at the cost
      // quantile covering the remaining need, times an overshoot: the
      // measured per-round yield of the bare need-quantile is only
      // ~30% (dirty-blocked and flip-vetoed edges), forcing many full
      // re-cost rounds. The alive_count > stop_faces check bounds
      // actual collapsing either way, and the heap phase fixes any
      // order roughness on the last 4x (measured equal-chamfer at
      // overshoot 5, docs/ROUND5_NOTES.md §5).
      static const double overshoot = [] {
        const char* e = std::getenv("LSTPU_SIMPLIFY_OVERSHOOT");
        return e ? std::atof(e) : 5.0;
      }();
      int64_t need = (alive_count - stop_faces) / 2 + 1;
      costs.resize(edges.size());
      for (size_t i = 0; i < edges.size(); ++i) costs[i] = edges[i].cost;
      size_t idx = std::min<size_t>(
          static_cast<int64_t>(overshoot * (double)need),
          costs.size() - 1);
      std::nth_element(costs.begin(), costs.begin() + idx, costs.end());
      const double thr = costs[idx];
      std::fill(dirty.begin(), dirty.end(), 0);
      int64_t collapsed = 0;
      for (const PreEdge& e : edges) {
        if (alive_count <= stop_faces) break;
        if (e.cost > thr) continue;
        if (dirty[e.a] || dirty[e.b]) continue;
        // Endpoints untouched this round -> cached cost/position exact.
        if (FlipsNormal(e.a, e.b, e.p)) continue;
        CollapseEdge(e.a, e.b, e.p);
        // Mark BOTH endpoints: e.b is dead now, and later cached edges
        // still name it — without dirty[e.b] they would "revive" it.
        dirty[e.a] = 1;
        dirty[e.b] = 1;
        ++collapsed;
        ++prepass_collapses;
      }
      if (collapsed < need / 20) break;  // stalled: let the heap finish
    }
  }

  void SeedHeap() {
    std::vector<uint64_t> keys;
    keys.reserve(3 * alive_count);
    for (int64_t f = 0; f < (int64_t)faces.size(); ++f) {
      if (!face_alive[f]) continue;
      for (int k = 0; k < 3; ++k)
        keys.push_back(PairKey(faces[f][k], faces[f][(k + 1) % 3]));
    }
    std::sort(keys.begin(), keys.end());
    keys.erase(std::unique(keys.begin(), keys.end()), keys.end());
    heap.reserve(keys.size() + 64);
    latest_stamp.reserve(2 * keys.size());
    for (uint64_t key : keys)
      PushCandidate(static_cast<int64_t>(key >> 32),
                    static_cast<int64_t>(key & 0xffffffffu),
                    /*heapify=*/false);
    std::make_heap(heap.begin(), heap.end());
  }

  // Would collapsing (v0, v1) -> p flip any surviving face's normal?
  bool FlipsNormal(int64_t v0, int64_t v1, const Vec3& p) const {
    for (int64_t vid : {v0, v1}) {
      for (int64_t f : vertex_faces[vid]) {
        if (!face_alive[f]) continue;
        const auto& fc = faces[f];
        bool has0 = fc[0] == v0 || fc[1] == v0 || fc[2] == v0;
        bool has1 = fc[0] == v1 || fc[1] == v1 || fc[2] == v1;
        if (has0 && has1) continue;  // face dies with the collapse
        Vec3 a = pos[fc[0]], b = pos[fc[1]], c = pos[fc[2]];
        Vec3 before = (b - a).Cross(c - a);
        // Degenerate (near-zero-area) faces can't define an orientation;
        // never let them veto a collapse (marching-tetrahedra output
        // contains many near-degenerate slivers).
        if (before.Dot(before) < 1e-24f) continue;
        // Replace vid with p.
        Vec3 a2 = fc[0] == vid ? p : a, b2 = fc[1] == vid ? p : b,
             c2 = fc[2] == vid ? p : c;
        Vec3 after = (b2 - a2).Cross(c2 - a2);
        if (before.Dot(after) < 0) return true;
      }
    }
    return false;
  }

  void Run(int64_t target_faces, double aggressiveness) {
    // Phase 1: threshold sweeps down to ~4x the target (linear scans,
    // no heap). Phase 2: exact greedy lazy-heap for the order-sensitive
    // tail. Lazy heap maintenance: collapses do NOT re-push incident
    // edges (the eager variant pushed ~19 candidates per collapse —
    // ~500k heap pushes + quadric solves for a 57k->5k run, the
    // dominant cost by profile). Instead, entries are translated
    // through the union-find on pop; a stale entry (version stamp
    // mismatch) is re-costed and re-pushed once, only when it actually
    // surfaces; outdated duplicates are dropped via latest_stamp.
    // `aggressiveness` (same direction as Fast-Quadric's knob: higher =
    // more eager bulk collapsing) sets where the cheap threshold sweeps
    // hand over to the exact heap: stop at (1 + 15/agg) x target faces.
    // The default 5.0 gives the measured-optimal 4x handover; smaller
    // values leave more work to the order-exact heap (higher quality,
    // slower), larger values collapse nearly everything in bulk.
    const double agg = std::max(aggressiveness, 1e-3);
    const double mult = 1.0 + 15.0 / agg;
    auto tp0 = std::chrono::steady_clock::now();
    ThresholdPrePass(std::max<int64_t>(
        static_cast<int64_t>(mult * (double)target_faces), 1024));
    auto tp1 = std::chrono::steady_clock::now();
    SeedHeap();
    auto tp2 = std::chrono::steady_clock::now();
    prepass_ms =
        std::chrono::duration<double, std::milli>(tp1 - tp0).count();
    seed_ms = std::chrono::duration<double, std::milli>(tp2 - tp1).count();
    int64_t budget = 100 * (int64_t)faces.size() + (1 << 20);
    while (alive_count > target_faces && !heap.empty() && budget-- > 0) {
      ++heap_pops;
      std::pop_heap(heap.begin(), heap.end());
      Candidate c = heap.back();
      heap.pop_back();
      int64_t v0 = Find(c.v0), v1 = Find(c.v1);
      if (v0 == v1) continue;  // edge collapsed away entirely
      const uint64_t key = PairKey(v0, v1);
      auto it = latest_stamp.find(key);
      if (it != latest_stamp.end() && it->second != c.stamp)
        continue;  // outdated copy; the latest push is elsewhere in heap
      if (it == latest_stamp.end() ||
          c.stamp != version[v0] + version[v1]) {
        PushCandidate(v0, v1);  // re-cost with current quadrics, once
        continue;
      }

      Vec3 p;
      EdgeCost(v0, v1, &p);
      if (FlipsNormal(v0, v1, p)) {
        // Defer rather than drop: the neighborhood may open up after
        // nearby collapses. The penalty keeps a permanently vetoed
        // edge from spinning at the heap top (budget bounds the
        // pathological all-vetoed case).
        heap.push_back({c.cost * 2.0 + veto_eps, v0, v1, c.stamp});
        std::push_heap(heap.begin(), heap.end());
        continue;
      }

      CollapseEdge(v0, v1, p);
    }
  }

  // Compact to output arrays.
  void Output(std::vector<float>& out_verts, std::vector<int64_t>& out_tris) {
    std::unordered_map<int64_t, int64_t> remap;
    for (int64_t f = 0; f < (int64_t)faces.size(); ++f) {
      if (!face_alive[f]) continue;
      const auto& fc = faces[f];
      if (fc[0] == fc[1] || fc[1] == fc[2] || fc[0] == fc[2]) continue;
      int64_t ids[3];
      for (int k = 0; k < 3; ++k) {
        auto it = remap.find(fc[k]);
        if (it == remap.end()) {
          int64_t nid = static_cast<int64_t>(remap.size());
          remap.emplace(fc[k], nid);
          out_verts.push_back(static_cast<float>(pos[fc[k]].x));
          out_verts.push_back(static_cast<float>(pos[fc[k]].y));
          out_verts.push_back(static_cast<float>(pos[fc[k]].z));
          ids[k] = nid;
        } else {
          ids[k] = it->second;
        }
      }
      out_tris.push_back(ids[0]);
      out_tris.push_back(ids[1]);
      out_tris.push_back(ids[2]);
    }
  }
};

}  // namespace

extern "C" {

struct SimplifyResult {
  std::vector<float> verts;
  std::vector<int64_t> tris;
};

SimplifyResult* simplify_mesh(const float* verts, int64_t nv,
                              const int64_t* tris, int64_t nf,
                              int64_t target_faces, double aggressiveness) {
  auto* res = new SimplifyResult();
  if (nf <= target_faces) {
    res->verts.assign(verts, verts + 3 * nv);
    res->tris.assign(tris, tris + 3 * nf);
    return res;
  }
  // LSTPU_SIMPLIFY_PROFILE=1: phase times to stderr (perf observability;
  // scripts/profile_simplify.py aggregates them).
  static const bool profile = [] {
    const char* e = std::getenv("LSTPU_SIMPLIFY_PROFILE");
    return e && e[0] == '1';
  }();
  using Clock = std::chrono::steady_clock;
  auto ms = [](Clock::time_point a, Clock::time_point b) {
    return std::chrono::duration<double, std::milli>(b - a).count();
  };
  auto t0 = Clock::now();
  Simplifier s;
  s.Init(verts, nv, tris, nf);
  auto t1 = Clock::now();
  s.Run(target_faces, aggressiveness);
  auto t2 = Clock::now();
  s.Output(res->verts, res->tris);
  auto t3 = Clock::now();
  if (profile) {
    std::fprintf(
        stderr,
        "[simplify] nf=%lld target=%lld init=%.1fms run=%.1fms "
        "(prepass=%.1fms seed=%.1fms heap=%.1fms, prepass_costs=%lld "
        "prepass_collapses=%lld heap_pops=%lld) output=%.1fms\n",
        (long long)nf, (long long)target_faces, ms(t0, t1), ms(t1, t2),
        s.prepass_ms, s.seed_ms, ms(t1, t2) - s.prepass_ms - s.seed_ms,
        (long long)s.prepass_costs, (long long)s.prepass_collapses,
        (long long)s.heap_pops, ms(t2, t3));
  }
  return res;
}

int64_t simplify_num_vertices(const SimplifyResult* r) {
  return static_cast<int64_t>(r->verts.size() / 3);
}
int64_t simplify_num_triangles(const SimplifyResult* r) {
  return static_cast<int64_t>(r->tris.size() / 3);
}
void simplify_copy(const SimplifyResult* r, float* verts_out,
                   int64_t* tris_out) {
  std::memcpy(verts_out, r->verts.data(), r->verts.size() * sizeof(float));
  std::memcpy(tris_out, r->tris.data(), r->tris.size() * sizeof(int64_t));
}
void simplify_free(SimplifyResult* r) { delete r; }

}  // extern "C"
