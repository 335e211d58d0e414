// scenekit — native host-side scene preprocessing for raytracer_tpu.
//
// The reference builds its per-mesh BVH in native code (a single-thread
// CUDA SAH builder, reference Core/Mesh.cuh:121-219). Like the
// reference, this project does scene preprocessing natively: this library provides a top-down binned-SAH
// BVH4 builder (higher quality than the pure-XLA LBVH fallback in
// raytracer_tpu/ops/bvh.py, and ~100x faster than the Python collapse).
//
// Exposed via a C ABI consumed with ctypes (raytracer_tpu/scene/native.py).
//
// Output layout matches raytracer_tpu/ops/bvh4.Bvh4:
//   bounds   f32[n4, 4, 6]  child boxes (min3, max3); empty slots +inf/-inf
//   children i32[n4, 4]     >=0 internal | -1 empty | <=-2 leaf range code
//                           code = -(2 + lo*8 + (count-1)), count in 1..8
//   prim     i32[T]         leaf-slot -> original triangle id
//
// Build: g++ -O3 -shared -fPIC -o libscenekit.so scenekit.cpp

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

static inline Vec3 vmin(Vec3 a, Vec3 b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(Vec3 a, Vec3 b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Box {
  Vec3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
  Vec3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void grow(const Box& b) {
    lo = vmin(lo, b.lo);
    hi = vmax(hi, b.hi);
  }
  void grow(Vec3 p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float area() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return dx * dy + dy * dz + dz * dx;
  }
};

// Binary SAH tree node over a contiguous range of the prim permutation.
struct Node {
  Box box;
  int lo = 0, count = 0;   // leaf range (in permuted order)
  int left = -1, right = -1;
  bool leaf() const { return left < 0; }
};

struct Builder {
  const float* verts;
  const int32_t* faces;
  int T;
  int max_leaf;
  std::vector<Box> tri_box;
  std::vector<Vec3> centroid;
  std::vector<int32_t> perm;
  std::vector<Node> nodes;

  Box range_box(int lo, int n) const {
    Box b;
    for (int i = 0; i < n; ++i) b.grow(tri_box[perm[lo + i]]);
    return b;
  }

  int build(int lo, int n) {
    int id = (int)nodes.size();
    nodes.push_back({});
    Node nd;
    nd.box = range_box(lo, n);
    nd.lo = lo;
    nd.count = n;
    if (n <= max_leaf) {
      nodes[id] = nd;
      return id;
    }

    // Binned SAH over the centroid bounds, 16 bins, 3 axes.
    Box cb;
    for (int i = 0; i < n; ++i) cb.grow(centroid[perm[lo + i]]);
    const int NB = 16;
    float best_cost = FLT_MAX;
    int best_axis = -1, best_split = -1;
    float cb_lo[3] = {cb.lo.x, cb.lo.y, cb.lo.z};
    float cb_hi[3] = {cb.hi.x, cb.hi.y, cb.hi.z};
    for (int axis = 0; axis < 3; ++axis) {
      float lo_a = cb_lo[axis], hi_a = cb_hi[axis];
      if (hi_a - lo_a < 1e-12f) continue;
      float inv = NB / (hi_a - lo_a);
      Box bins[NB];
      int cnt[NB] = {0};
      for (int i = 0; i < n; ++i) {
        int t = perm[lo + i];
        float c = axis == 0 ? centroid[t].x : axis == 1 ? centroid[t].y : centroid[t].z;
        int b = std::min(NB - 1, std::max(0, (int)((c - lo_a) * inv)));
        bins[b].grow(tri_box[t]);
        cnt[b]++;
      }
      // Sweep SAH (cost = nL*areaL + nR*areaR, reference
      // Core/Mesh.cuh:222-240 uses the same unnormalized form).
      Box right_acc[NB];
      Box acc;
      for (int b = NB - 1; b >= 1; --b) {
        acc.grow(bins[b]);
        right_acc[b] = acc;
      }
      Box left_acc;
      int nl = 0;
      for (int b = 0; b < NB - 1; ++b) {
        left_acc.grow(bins[b]);
        nl += cnt[b];
        int nr = n - nl;
        if (nl == 0 || nr == 0) continue;
        float cost = nl * left_acc.area() + nr * right_acc[b + 1].area();
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_split = b;
        }
      }
    }

    int mid;
    if (best_axis < 0) {
      mid = lo + n / 2;  // degenerate: median split
    } else {
      float lo_a = cb_lo[best_axis], hi_a = cb_hi[best_axis];
      float inv = NB / (hi_a - lo_a);
      auto bin_of = [&](int t) {
        float c = best_axis == 0 ? centroid[t].x
                 : best_axis == 1 ? centroid[t].y
                                  : centroid[t].z;
        return std::min(NB - 1, std::max(0, (int)((c - lo_a) * inv)));
      };
      int32_t* first = perm.data() + lo;
      int32_t* split = std::partition(
          first, first + n, [&](int t) { return bin_of(t) <= best_split; });
      mid = lo + (int)(split - first);
      if (mid == lo || mid == lo + n) mid = lo + n / 2;
    }

    nd.left = build(lo, mid - lo);
    nd.right = build(mid, lo + n - mid);
    nodes[id] = nd;
    return id;
  }
};

}  // namespace

extern "C" {

// Returns n4 (number of BVH4 nodes), or -1 on error. Output buffers must
// be sized for the worst case: bounds[T*24], children[T*4], prim[T].
int scenekit_build_bvh4(const float* verts, int32_t V, const int32_t* faces,
                        int32_t T, int32_t max_leaf, float* out_bounds,
                        int32_t* out_children, int32_t* out_prim) {
  if (T <= 0 || max_leaf < 1 || max_leaf > 8) return -1;
  Builder b;
  b.verts = verts;
  b.faces = faces;
  b.T = T;
  b.max_leaf = max_leaf;
  b.tri_box.resize(T);
  b.centroid.resize(T);
  b.perm.resize(T);
  for (int t = 0; t < T; ++t) {
    Box box;
    Vec3 c{0, 0, 0};
    for (int k = 0; k < 3; ++k) {
      const float* p = verts + 3 * faces[3 * t + k];
      Vec3 v{p[0], p[1], p[2]};
      box.grow(v);
      c.x += v.x;
      c.y += v.y;
      c.z += v.z;
    }
    // Degenerate-box padding (reference AABB::padToMinimums,
    // Core/AABB.cuh:181-186): flat boxes would always fail the strict
    // slab test.
    const float pad = 5e-7f;
    if (box.hi.x - box.lo.x < 1e-6f) { box.lo.x -= pad; box.hi.x += pad; }
    if (box.hi.y - box.lo.y < 1e-6f) { box.lo.y -= pad; box.hi.y += pad; }
    if (box.hi.z - box.lo.z < 1e-6f) { box.lo.z -= pad; box.hi.z += pad; }
    b.tri_box[t] = box;
    b.centroid[t] = {c.x / 3.f, c.y / 3.f, c.z / 3.f};
    b.perm[t] = t;
  }
  b.nodes.reserve(2 * T);
  b.build(0, T);

  // Collapse the binary SAH tree to BVH4 (same scheme as
  // raytracer_tpu/ops/bvh4.build_bvh4: expand binary children one more
  // level; subtrees with count <= max_leaf become leaf-range children).
  const auto& nodes = b.nodes;
  auto expand = [&](int id, int* out) {
    int m = 0;
    const Node& nd = nodes[id];
    for (int c : {nd.left, nd.right}) {
      if (nodes[c].leaf() || nodes[c].count <= b.max_leaf) {
        out[m++] = c;
      } else {
        out[m++] = nodes[c].left;
        out[m++] = nodes[c].right;
      }
    }
    return m;
  };

  std::vector<int> b4_of(nodes.size(), -1);
  std::vector<int> order;
  if (nodes[0].leaf() || nodes[0].count <= b.max_leaf) {
    for (int s = 0; s < 4; ++s) {
      for (int k = 0; k < 6; ++k)
        out_bounds[s * 6 + k] = k < 3 ? FLT_MAX : -FLT_MAX;
      out_children[s] = -1;
    }
    const Node& r = nodes[0];
    out_bounds[0] = r.box.lo.x; out_bounds[1] = r.box.lo.y; out_bounds[2] = r.box.lo.z;
    out_bounds[3] = r.box.hi.x; out_bounds[4] = r.box.hi.y; out_bounds[5] = r.box.hi.z;
    out_children[0] = -(2 + r.lo * 8 + (r.count - 1));
    std::memcpy(out_prim, b.perm.data(), sizeof(int32_t) * T);
    return 1;
  }

  order.push_back(0);
  b4_of[0] = 0;
  std::vector<int> stack{0};
  while (!stack.empty()) {
    int id = stack.back();
    stack.pop_back();
    int ch[4];
    int m = expand(id, ch);
    for (int s = 0; s < m; ++s) {
      int c = ch[s];
      if (!nodes[c].leaf() && nodes[c].count > b.max_leaf && b4_of[c] < 0) {
        b4_of[c] = (int)order.size();
        order.push_back(c);
        stack.push_back(c);
      }
    }
  }

  int n4 = (int)order.size();
  for (int i = 0; i < n4; ++i) {
    int id = order[i];
    float* bb = out_bounds + (size_t)i * 24;
    int32_t* cc = out_children + (size_t)i * 4;
    for (int s = 0; s < 4; ++s) {
      for (int k = 0; k < 3; ++k) bb[s * 6 + k] = FLT_MAX;
      for (int k = 3; k < 6; ++k) bb[s * 6 + k] = -FLT_MAX;
      cc[s] = -1;
    }
    int ch[4];
    int m = expand(id, ch);
    for (int s = 0; s < m; ++s) {
      const Node& cn = nodes[ch[s]];
      bb[s * 6 + 0] = cn.box.lo.x;
      bb[s * 6 + 1] = cn.box.lo.y;
      bb[s * 6 + 2] = cn.box.lo.z;
      bb[s * 6 + 3] = cn.box.hi.x;
      bb[s * 6 + 4] = cn.box.hi.y;
      bb[s * 6 + 5] = cn.box.hi.z;
      if (cn.leaf() || cn.count <= b.max_leaf) {
        cc[s] = -(2 + cn.lo * 8 + (cn.count - 1));
      } else {
        cc[s] = b4_of[ch[s]];
      }
    }
  }
  std::memcpy(out_prim, b.perm.data(), sizeof(int32_t) * T);
  return n4;
}
}
