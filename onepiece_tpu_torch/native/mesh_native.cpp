// Native mesh algorithms: quadric-error-metric simplification and
// connected-component pruning.
//
// TPU-side code handles the array-shaped mesh work (marching cubes,
// clustering simplification); these two algorithms are inherently
// sequential (global priority queue / union-find) and run on the host,
// exactly as the reference does in C++
// (ref: src/Geometry/MeshSimplification.cpp:157 `QuadricSimplification`,
//  :658-733 pruning helpers). Algorithms follow Garland-Heckbert '97 QEM;
// implementation is original.
//
// Exposed as a plain C ABI consumed through ctypes (no pybind11 in the
// environment).
//
// The port's own copy of onepiece_tpu/native/mesh_native.cpp, unchanged
// below this note: built with the same flags on one machine, both
// libraries give bit-equal outputs. Built and loaded by
// onepiece_tpu_torch/_native.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct Quadric {
  // symmetric 4x4, stored upper-triangular: a2 ab ac ad b2 bc bd c2 cd d2
  double q[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  void add_plane(double a, double b, double c, double d) {
    q[0] += a * a; q[1] += a * b; q[2] += a * c; q[3] += a * d;
    q[4] += b * b; q[5] += b * c; q[6] += b * d;
    q[7] += c * c; q[8] += c * d; q[9] += d * d;
  }
  void add(const Quadric &o) {
    for (int i = 0; i < 10; ++i) q[i] += o.q[i];
  }
  double eval(double x, double y, double z) const {
    return q[0] * x * x + 2 * q[1] * x * y + 2 * q[2] * x * z + 2 * q[3] * x +
           q[4] * y * y + 2 * q[5] * y * z + 2 * q[6] * y +
           q[7] * z * z + 2 * q[8] * z + q[9];
  }
  // solve for minimising position; returns false if singular
  bool optimum(double out[3]) const {
    double m[9] = {q[0], q[1], q[2], q[1], q[4], q[5], q[2], q[5], q[7]};
    double b[3] = {-q[3], -q[6], -q[8]};
    // 3x3 solve via adjugate
    double det = m[0] * (m[4] * m[8] - m[5] * m[7]) -
                 m[1] * (m[3] * m[8] - m[5] * m[6]) +
                 m[2] * (m[3] * m[7] - m[4] * m[6]);
    if (std::fabs(det) < 1e-12) return false;
    double inv = 1.0 / det;
    out[0] = inv * (b[0] * (m[4] * m[8] - m[5] * m[7]) -
                    m[1] * (b[1] * m[8] - m[5] * b[2]) +
                    m[2] * (b[1] * m[7] - m[4] * b[2]));
    out[1] = inv * (m[0] * (b[1] * m[8] - m[5] * b[2]) -
                    b[0] * (m[3] * m[8] - m[5] * m[6]) +
                    m[2] * (m[3] * b[2] - b[1] * m[6]));
    out[2] = inv * (m[0] * (m[4] * b[2] - b[1] * m[7]) -
                    m[1] * (m[3] * b[2] - b[1] * m[6]) +
                    b[0] * (m[3] * m[7] - m[4] * m[6]));
    return true;
  }
};

struct EdgeCand {
  double cost;
  int u, v;
  uint64_t stamp;  // validity check: sum of vertex versions at push time
  bool operator<(const EdgeCand &o) const { return cost > o.cost; }  // min-heap
};

struct DSU {
  std::vector<int> p;
  explicit DSU(int n) : p(n) {
    for (int i = 0; i < n; ++i) p[i] = i;
  }
  int find(int x) {
    while (p[x] != x) x = p[x] = p[p[x]];
    return x;
  }
  void unite(int a, int b) { p[find(a)] = find(b); }
};

}  // namespace

extern "C" {

// Simplify to ~target_faces. Buffers are caller-allocated; out arrays must
// hold at least the input sizes. Returns 0 on success.
int qem_simplify(const float *verts, int nv, const int *faces, int nf,
                 int target_faces, float *out_verts, int *out_nv,
                 int *out_faces, int *out_nf) {
  std::vector<double> vx(nv * 3);
  for (int i = 0; i < nv * 3; ++i) vx[i] = verts[i];
  std::vector<int> f(faces, faces + (size_t)nf * 3);
  std::vector<char> vdead(nv, 0), fdead(nf, 0);
  std::vector<uint64_t> version(nv, 0);
  std::vector<Quadric> Q(nv);
  std::vector<std::vector<int>> vfaces(nv);

  for (int i = 0; i < nf; ++i) {
    int a = f[i * 3], b = f[i * 3 + 1], c = f[i * 3 + 2];
    if (a == b || b == c || a == c) {
      fdead[i] = 1;
      continue;
    }
    double *pa = &vx[a * 3], *pb = &vx[b * 3], *pc = &vx[c * 3];
    double e1[3] = {pb[0] - pa[0], pb[1] - pa[1], pb[2] - pa[2]};
    double e2[3] = {pc[0] - pa[0], pc[1] - pa[1], pc[2] - pa[2]};
    double n[3] = {e1[1] * e2[2] - e1[2] * e2[1], e1[2] * e2[0] - e1[0] * e2[2],
                   e1[0] * e2[1] - e1[1] * e2[0]};
    double len = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    if (len < 1e-15) {
      fdead[i] = 1;
      continue;
    }
    for (double &x : n) x /= len;
    double d = -(n[0] * pa[0] + n[1] * pa[1] + n[2] * pa[2]);
    Quadric plane;
    plane.add_plane(n[0], n[1], n[2], d);
    Q[a].add(plane);
    Q[b].add(plane);
    Q[c].add(plane);
    vfaces[a].push_back(i);
    vfaces[b].push_back(i);
    vfaces[c].push_back(i);
  }

  auto edge_cost = [&](int u, int v, double pos[3]) {
    Quadric q = Q[u];
    q.add(Q[v]);
    if (!q.optimum(pos)) {
      // fall back to best of endpoints / midpoint
      double cu = q.eval(vx[u * 3], vx[u * 3 + 1], vx[u * 3 + 2]);
      double cv = q.eval(vx[v * 3], vx[v * 3 + 1], vx[v * 3 + 2]);
      double mid[3] = {(vx[u * 3] + vx[v * 3]) / 2,
                       (vx[u * 3 + 1] + vx[v * 3 + 1]) / 2,
                       (vx[u * 3 + 2] + vx[v * 3 + 2]) / 2};
      double cm = q.eval(mid[0], mid[1], mid[2]);
      if (cu <= cv && cu <= cm) {
        pos[0] = vx[u * 3]; pos[1] = vx[u * 3 + 1]; pos[2] = vx[u * 3 + 2];
        return cu;
      }
      if (cv <= cm) {
        pos[0] = vx[v * 3]; pos[1] = vx[v * 3 + 1]; pos[2] = vx[v * 3 + 2];
        return cv;
      }
      pos[0] = mid[0]; pos[1] = mid[1]; pos[2] = mid[2];
      return cm;
    }
    return q.eval(pos[0], pos[1], pos[2]);
  };

  std::priority_queue<EdgeCand> heap;
  std::unordered_set<uint64_t> edges;
  auto ekey = [](int a, int b) {
    if (a > b) std::swap(a, b);
    return ((uint64_t)a << 32) | (uint32_t)b;
  };
  for (int i = 0; i < nf; ++i) {
    if (fdead[i]) continue;
    for (int k = 0; k < 3; ++k) {
      int a = f[i * 3 + k], b = f[i * 3 + (k + 1) % 3];
      if (edges.insert(ekey(a, b)).second) {
        double pos[3];
        double c = edge_cost(a, b, pos);
        heap.push({c, std::min(a, b), std::max(a, b), version[a] + version[b]});
      }
    }
  }

  int live_faces = 0;
  for (int i = 0; i < nf; ++i)
    if (!fdead[i]) live_faces++;

  while (live_faces > target_faces && !heap.empty()) {
    EdgeCand e = heap.top();
    heap.pop();
    if (vdead[e.u] || vdead[e.v]) continue;
    if (version[e.u] + version[e.v] != e.stamp) continue;  // stale entry
    double pos[3];
    edge_cost(e.u, e.v, pos);
    // collapse v into u at pos
    int u = e.u, v = e.v;
    vx[u * 3] = pos[0];
    vx[u * 3 + 1] = pos[1];
    vx[u * 3 + 2] = pos[2];
    Q[u].add(Q[v]);
    vdead[v] = 1;
    version[u]++;
    // rewrite v's faces
    for (int fi : vfaces[v]) {
      if (fdead[fi]) continue;
      int *tri = &f[fi * 3];
      for (int k = 0; k < 3; ++k)
        if (tri[k] == v) tri[k] = u;
      if (tri[0] == tri[1] || tri[1] == tri[2] || tri[0] == tri[2]) {
        fdead[fi] = 1;
        live_faces--;
      } else {
        vfaces[u].push_back(fi);
      }
    }
    vfaces[v].clear();
    // refresh u's edges
    std::unordered_set<int> nbrs;
    for (int fi : vfaces[u]) {
      if (fdead[fi]) continue;
      for (int k = 0; k < 3; ++k) {
        int w = f[fi * 3 + k];
        if (w != u && !vdead[w]) nbrs.insert(w);
      }
    }
    for (int w : nbrs) {
      double p2[3];
      double c = edge_cost(u, w, p2);
      heap.push({c, std::min(u, w), std::max(u, w), version[u] + version[w]});
    }
  }

  // compact output
  std::vector<int> remap(nv, -1);
  int nvo = 0;
  for (int i = 0; i < nv; ++i) {
    if (!vdead[i]) {
      remap[i] = nvo;
      out_verts[nvo * 3] = (float)vx[i * 3];
      out_verts[nvo * 3 + 1] = (float)vx[i * 3 + 1];
      out_verts[nvo * 3 + 2] = (float)vx[i * 3 + 2];
      nvo++;
    }
  }
  int nfo = 0;
  for (int i = 0; i < nf; ++i) {
    if (fdead[i]) continue;
    out_faces[nfo * 3] = remap[f[i * 3]];
    out_faces[nfo * 3 + 1] = remap[f[i * 3 + 1]];
    out_faces[nfo * 3 + 2] = remap[f[i * 3 + 2]];
    nfo++;
  }
  *out_nv = nvo;
  *out_nf = nfo;
  return 0;
}

// Mark faces belonging to connected components with >= min_faces faces.
// keep[f] is written 1/0. Returns number of kept faces.
int prune_components(const int *faces, int nf, int nv, int min_faces,
                     uint8_t *keep) {
  DSU dsu(nv);
  for (int i = 0; i < nf; ++i) {
    dsu.unite(faces[i * 3], faces[i * 3 + 1]);
    dsu.unite(faces[i * 3 + 1], faces[i * 3 + 2]);
  }
  std::unordered_map<int, int> comp_faces;
  for (int i = 0; i < nf; ++i) comp_faces[dsu.find(faces[i * 3])]++;
  int kept = 0;
  for (int i = 0; i < nf; ++i) {
    bool k = comp_faces[dsu.find(faces[i * 3])] >= min_faces;
    keep[i] = k ? 1 : 0;
    if (k) kept++;
  }
  return kept;
}

}  // extern "C"
