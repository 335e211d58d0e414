// Per-lane path loop of the fused integrator, shared by the CUDA kernel
// (pathtrace_cuda.cu) and the CPU target (pathtrace_cpu.cc).
//
// One call of trace_lane runs one pixel's whole sample x bounce loop, the
// shape of the reference's megakernel (CUDAKernels.h:102-166): camera ray,
// Russian roulette, sphere sweep, brute-force pass over the large
// triangles, BVH traversal with a per-lane stack, the four materials, and
// accumulation. The formulas and their order are those of the XLA
// wavefront integrator (models/wavefront.py with ops/intersect.py,
// ops/materials.py and ops/tonemap.py), and the random numbers are the
// ktf counter stream (utils/ktf.py), so a lane's result can be compared
// with the XLA integrators run with rng_impl="ktf".
#pragma once

#include <cmath>
#include <cstdint>

#if defined(__CUDACC__)
#define PT_HD __host__ __device__ __forceinline__
#else
#define PT_HD inline
#endif

namespace pt {

constexpr float kBig = 3.0e38f;
constexpr float kTwoPi = 6.28318530717958647692f;
// Stack entries per lane; ops/fused_kernel.py refuses trees whose bound
// (Bvh4.stack_depth) exceeds it, and a lane that would still overflow
// returns NaN instead of a wrong radiance.
constexpr int kStackCap = 128;
constexpr int kCamFloats = 19;  // ll(3) hor(3) ver(3) pos(3) right(3) up(3) lens_r
constexpr int kTriFloats = 12;  // v0(3) pad e1(3) pad e2(3) pad
constexpr int kMatFloats = 8;   // albedo(3) emission(3) roughness ior

// ktf purpose tags (utils/ktf.py).
constexpr uint32_t kJitter = 1, kLens = 2, kRR = 3, kScatter = 4, kDielectric = 5;
// Material type tags (scene/types.py).
constexpr int32_t kLambertian = 0, kMetal = 1, kDielectricMat = 2, kLight = 3;

struct SceneView {
  const float* cam;          // [19]
  const float* sph;          // [S,4] center(3) radius
  const int32_t* sph_mat;    // [S]
  int32_t n_sph;
  const float* mat;          // [M,8]
  const int32_t* mat_type;   // [M]
  int32_t n_mat;
  const float* node_box;     // [N4,6,K] per node: lo x,y,z then hi x,y,z, K children each
  const int32_t* node_child; // [N4,K] >=0 node, -1 empty, <=-2 leaf -(2 + first*8 + count-1)
  int32_t width;             // K (4 or 8)
  const float* tri;          // [T,12]
  const int32_t* tri_mat;    // [T]
  const float* brute;        // [Tb,12] large triangles, tested before the tree
  const int32_t* brute_mat;  // [Tb]
  int32_t n_brute;
};

struct Config {
  int32_t width, height, spp, max_bounces, min_bounces, emission_quirk;
  float rr_max_prob, t_min;
  uint32_t k0, k1;
  int32_t sample_offset;
};

// ---- ktf: Threefry-2x32, 20 rounds (utils/ktf.py) -------------------

PT_HD uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

PT_HD void threefry(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1,
                    uint32_t* o0, uint32_t* o1) {
  const uint32_t ks2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
#define PT_ROUND(r) x0 += x1; x1 = rotl(x1, r); x1 ^= x0;
#define PT_ROUNDS_A PT_ROUND(13) PT_ROUND(15) PT_ROUND(26) PT_ROUND(6)
#define PT_ROUNDS_B PT_ROUND(17) PT_ROUND(29) PT_ROUND(16) PT_ROUND(24)
  PT_ROUNDS_A x0 += k1; x1 += ks2 + 1u;
  PT_ROUNDS_B x0 += ks2; x1 += k0 + 2u;
  PT_ROUNDS_A x0 += k0; x1 += k1 + 3u;
  PT_ROUNDS_B x0 += k1; x1 += ks2 + 4u;
  PT_ROUNDS_A x0 += ks2; x1 += k0 + 5u;
#undef PT_ROUNDS_B
#undef PT_ROUNDS_A
#undef PT_ROUND
  *o0 = x0;
  *o1 = x1;
}

PT_HD float u01(uint32_t bits) { return (float)(bits >> 9) * (1.0f / 8388608.0f); }

struct Sampler {
  uint32_t k0, k1, pixel, sample, bounce;
  PT_HD void pair(uint32_t purpose, float* a, float* b) const {
    uint32_t x0, x1;
    threefry(k0, k1, pixel, (sample << 9) | (bounce << 4) | purpose, &x0, &x1);
    *a = u01(x0);
    *b = u01(x1);
  }
  PT_HD float uniform(uint32_t purpose) const {
    float a, b;
    pair(purpose, &a, &b);
    return a;
  }
};

// ---- small vector helpers -------------------------------------------

PT_HD float dot3(const float* a, const float* b) { return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]; }

PT_HD void reflect3(const float* v, const float* n, float* out) {
  const float k = 2.0f * dot3(v, n);
  for (int i = 0; i < 3; ++i) out[i] = v[i] - k * n[i];
}

// ---- triangles and boxes --------------------------------------------

struct Ray {
  float o[3], d[3], inv[3];
};

struct TriHit {
  float t;
  int32_t mat;
  bool found;
  float n[3];  // unnormalised geometric normal cross(e1, e2)
};

// Moller-Trumbore (ops/triangle.py): accepted when t in [t_min, hit.t).
PT_HD void intersect_tri(const float* r, int32_t mat, const Ray& ray, float t_min, TriHit* hit) {
  const float *v0 = r, *e1 = r + 4, *e2 = r + 8;
  const float* d = ray.d;
  const float hx = d[1] * e2[2] - d[2] * e2[1];
  const float hy = d[2] * e2[0] - d[0] * e2[2];
  const float hz = d[0] * e2[1] - d[1] * e2[0];
  const float a = e1[0] * hx + e1[1] * hy + e1[2] * hz;
  if (!(fabsf(a) >= 1e-8f)) return;
  const float f = 1.0f / a;
  const float sx = ray.o[0] - v0[0], sy = ray.o[1] - v0[1], sz = ray.o[2] - v0[2];
  const float u = f * (sx * hx + sy * hy + sz * hz);
  if (!(u >= 0.0f && u <= 1.0f)) return;
  const float qx = sy * e1[2] - sz * e1[1];
  const float qy = sz * e1[0] - sx * e1[2];
  const float qz = sx * e1[1] - sy * e1[0];
  const float v = f * (d[0] * qx + d[1] * qy + d[2] * qz);
  if (!(v >= 0.0f && u + v <= 1.0f)) return;
  const float t = f * (e2[0] * qx + e2[1] * qy + e2[2] * qz);
  if (!(t >= t_min && t < hit->t)) return;
  hit->t = t;
  hit->mat = mat;
  hit->found = true;
  hit->n[0] = e1[1] * e2[2] - e1[2] * e2[1];
  hit->n[1] = e1[2] * e2[0] - e1[0] * e2[2];
  hit->n[2] = e1[0] * e2[1] - e1[1] * e2[0];
}

// Sorting networks by tree width, as ops/bvh4.SORT_PAIRS: the same
// compare-exchange order gives the same child order on key ties.
PT_HD void cswap(float* key, int32_t* id, int i, int j) {
  if (key[i] > key[j]) {
    const float tk = key[i]; key[i] = key[j]; key[j] = tk;
    const int32_t tc = id[i]; id[i] = id[j]; id[j] = tc;
  }
}

template <int K> PT_HD void sort_children(float* key, int32_t* id);

template <> PT_HD void sort_children<4>(float* key, int32_t* id) {
  cswap(key, id, 0, 2); cswap(key, id, 1, 3); cswap(key, id, 0, 1); cswap(key, id, 2, 3);
  cswap(key, id, 1, 2);
}

template <> PT_HD void sort_children<8>(float* key, int32_t* id) {
  cswap(key, id, 0, 1); cswap(key, id, 2, 3); cswap(key, id, 4, 5); cswap(key, id, 6, 7);
  cswap(key, id, 0, 2); cswap(key, id, 1, 3); cswap(key, id, 4, 6); cswap(key, id, 5, 7);
  cswap(key, id, 1, 2); cswap(key, id, 5, 6);
  cswap(key, id, 0, 4); cswap(key, id, 1, 5); cswap(key, id, 2, 6); cswap(key, id, 3, 7);
  cswap(key, id, 2, 4); cswap(key, id, 3, 5);
  cswap(key, id, 1, 2); cswap(key, id, 3, 4); cswap(key, id, 5, 6);
}

// Closest triangle hit: brute-force pass, then the K-wide tree from the
// root. Children that the ray enters are visited nearest first: the
// nearest is taken next and the others are pushed far to near. Returns
// false when the lane's stack would overflow.
template <int K>
PT_HD bool trace_tris(const SceneView& s, const Ray& ray, float t_min, TriHit* hit) {
  for (int i = 0; i < s.n_brute; ++i)
    intersect_tri(s.brute + i * kTriFloats, s.brute_mat[i], ray, t_min, hit);
  int32_t stack[kStackCap];
  int sp = 0;
  int32_t task = 0;
  for (;;) {
    if (task >= 0) {
      const float* box = s.node_box + (size_t)task * 6 * K;
      const int32_t* ch = s.node_child + (size_t)task * K;
      float key[K];
      int32_t id[K];
      int cnt = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int32_t c = ch[k];
        const float t0x = (box[0 * K + k] - ray.o[0]) * ray.inv[0];
        const float t0y = (box[1 * K + k] - ray.o[1]) * ray.inv[1];
        const float t0z = (box[2 * K + k] - ray.o[2]) * ray.inv[2];
        const float t1x = (box[3 * K + k] - ray.o[0]) * ray.inv[0];
        const float t1y = (box[4 * K + k] - ray.o[1]) * ray.inv[1];
        const float t1z = (box[5 * K + k] - ray.o[2]) * ray.inv[2];
        const float tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                 fmaxf(fminf(t0z, t1z), t_min));
        const float tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                                 fminf(fmaxf(t0z, t1z), hit->t));
        const bool h = (c != -1) && (tmax > tmin);
        key[k] = h ? tmin : kBig;
        id[k] = c;
        cnt += h ? 1 : 0;
      }
      sort_children<K>(key, id);
      if (cnt > 0) {
        if (sp + cnt - 1 > kStackCap) return false;
#pragma unroll
        for (int k = K - 1; k > 0; --k)
          if (k < cnt) stack[sp++] = id[k];
        task = id[0];
        continue;
      }
    } else {
      const int32_t code = -task - 2;
      const int32_t first = code >> 3, count = (code & 7) + 1;
      for (int i = 0; i < count; ++i)
        intersect_tri(s.tri + (size_t)(first + i) * kTriFloats, s.tri_mat[first + i], ray, t_min,
                      hit);
    }
    if (sp == 0) break;
    task = stack[--sp];
  }
  return true;
}

// ---- the path loop ---------------------------------------------------

// Mean radiance of one pixel over cfg.spp samples (NaN on stack overflow).
PT_HD void trace_lane(const SceneView& s, const Config& cfg, int32_t px, int32_t py,
                      float* out) {
  const float* cam = s.cam;
  const float *ll = cam, *hor = cam + 3, *ver = cam + 6, *pos = cam + 9;
  const float *right = cam + 12, *up = cam + 15;
  const float lens_r = cam[18];

  Sampler smp;
  smp.k0 = cfg.k0;
  smp.k1 = cfg.k1;
  smp.pixel = (uint32_t)(py * cfg.width + px);

  float acc[3] = {0.0f, 0.0f, 0.0f};
  float tp[3] = {1.0f, 1.0f, 1.0f};
  Ray ray;
  int32_t bounce = 0;
  bool active = false;
  int32_t sample = 0;
  while (sample < cfg.spp) {
    smp.sample = (uint32_t)(sample + cfg.sample_offset);
    if (!active) {
      // Thin-lens camera ray (camera.generate_rays), drawn at bounce 0.
      bounce = 0;
      smp.bounce = 0;
      float l1, l2, ju, jv;
      smp.pair(kLens, &l1, &l2);
      const float lr = sqrtf(l1), th = kTwoPi * l2;
      const float rdx = lens_r * (lr * cosf(th)), rdy = lens_r * (lr * sinf(th));
      smp.pair(kJitter, &ju, &jv);
      const float u = ((float)px + ju) / (float)cfg.width;
      const float v = ((float)py + jv) / (float)cfg.height;
      for (int i = 0; i < 3; ++i) {
        const float off = right[i] * rdx + up[i] * rdy;
        ray.o[i] = pos[i] + off;
        ray.d[i] = ll[i] + u * hor[i] + v * ver[i] - pos[i] - off;
        tp[i] = 1.0f;
      }
      active = true;
    }
    smp.bounce = (uint32_t)bounce;

    // Russian roulette (CUDAKernels.h:113-121).
    const bool do_rr = bounce >= cfg.min_bounces;
    const float survival = fminf(fmaxf(fmaxf(tp[0], tp[1]), tp[2]), cfg.rr_max_prob);
    const float u_rr = smp.uniform(kRR);
    if (do_rr && u_rr > survival) {
      ++sample;
      active = false;
      continue;
    }
    if (do_rr) {
      const float scale = 1.0f / fmaxf(survival, 1e-12f);
      for (int i = 0; i < 3; ++i) tp[i] = tp[i] * scale;
    }

    // Spheres (ops/sphere.intersect_spheres).
    const float* d = ray.d;
    const float a = dot3(d, d);
    float t_sph = kBig;
    int32_t sid = 0;
    for (int k = 0; k < s.n_sph; ++k) {
      const float* sc = s.sph + 4 * k;
      const float oc[3] = {ray.o[0] - sc[0], ray.o[1] - sc[1], ray.o[2] - sc[2]};
      const float half_b = dot3(oc, d);
      const float c = dot3(oc, oc) - sc[3] * sc[3];
      const float disc = half_b * half_b - a * c;
      const float sq = sqrtf(fmaxf(disc, 0.0f));
      const float root_near = (-half_b - sq) / a;
      const float root_far = (-half_b + sq) / a;
      const bool near_ok = root_near >= cfg.t_min && root_near <= kBig;
      const bool far_ok = root_far >= cfg.t_min && root_far <= kBig;
      const float root = near_ok ? root_near : root_far;
      const float t_s = (disc >= 0.0f && (near_ok || far_ok)) ? root : kBig;
      if (t_s < t_sph) {
        t_sph = t_s;
        sid = k;
      }
    }

    // Triangles: only hits nearer than the sphere count.
    for (int i = 0; i < 3; ++i) ray.inv[i] = 1.0f / d[i];
    TriHit th;
    th.t = t_sph;
    th.found = false;
    th.mat = 0;
    const bool ok = s.width == 8 ? trace_tris<8>(s, ray, cfg.t_min, &th)
                                 : trace_tris<4>(s, ray, cfg.t_min, &th);
    if (!ok) {
      out[0] = out[1] = out[2] = NAN;
      return;
    }

    // Hit attributes (ops/intersect.shade_hit).
    const float t_hit = th.found ? th.t : t_sph;
    const bool ray_hit = t_hit < kBig;
    float point[3], nrm[3];
    bool front;
    int32_t mat_id;
    for (int i = 0; i < 3; ++i) point[i] = ray.o[i] + t_hit * d[i];
    if (th.found) {
      const float len = sqrtf(fmaxf(dot3(th.n, th.n), 1e-40f));
      float g[3];
      for (int i = 0; i < 3; ++i) g[i] = th.n[i] / len;
      front = dot3(d, g) < 0.0f;
      for (int i = 0; i < 3; ++i) nrm[i] = front ? g[i] : -g[i];
      mat_id = th.mat;
    } else {
      const float* sc = s.sph + 4 * sid;
      const float r = sc[3] != 0.0f ? sc[3] : 1.0f;
      float outw[3];
      for (int i = 0; i < 3; ++i) outw[i] = (point[i] - sc[i]) / r;
      front = dot3(d, outw) < 0.0f;
      for (int i = 0; i < 3; ++i) nrm[i] = front ? outw[i] : -outw[i];
      mat_id = s.sph_mat[sid];
    }

    // Material (ops/materials.lookup_params; unknown ids read as zeros).
    int32_t mtype = 0;
    float alb[3] = {0.0f, 0.0f, 0.0f}, emi[3] = {0.0f, 0.0f, 0.0f};
    float rough = 0.0f, ior = 1.0f;
    if (mat_id >= 0 && mat_id < s.n_mat) {
      const float* m = s.mat + kMatFloats * mat_id;
      mtype = s.mat_type[mat_id];
      for (int i = 0; i < 3; ++i) {
        alb[i] = m[i];
        emi[i] = m[3 + i];
      }
      rough = m[6];
      ior = m[7];
    }

    // Scatter (ops/materials.scatter_params).
    float uv[3];
    {
      float u1, u2;
      smp.pair(kScatter, &u1, &u2);
      const float z = 1.0f - 2.0f * u1;
      const float r = sqrtf(fmaxf(1.0f - z * z, 0.0f));
      const float phi = kTwoPi * u2;
      uv[0] = r * cosf(phi);
      uv[1] = r * sinf(phi);
      uv[2] = z;
    }
    const float u_die = smp.uniform(kDielectric);

    const bool is_lam = mtype == kLambertian, is_metal = mtype == kMetal;
    const bool is_die = mtype == kDielectricMat, is_light = mtype == kLight;
    float dir[3];
    bool scattered = is_lam;
    if (is_metal) {
      float refl[3];
      reflect3(d, nrm, refl);
      const float len = sqrtf(fmaxf(dot3(refl, refl), 1e-40f));
      for (int i = 0; i < 3; ++i) dir[i] = refl[i] / len + rough * uv[i];
      scattered = dot3(dir, nrm) > 0.0f;
    } else if (is_die) {
      const float ri = front ? 1.0f / ior : ior;
      const float len = sqrtf(a);
      float ui[3], neg_ui[3];
      for (int i = 0; i < 3; ++i) {
        ui[i] = d[i] / len;
        neg_ui[i] = -ui[i];
      }
      const float cos_t = fminf(dot3(neg_ui, nrm), 1.0f);
      const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
      const float r0q = (1.0f - ri) / (1.0f + ri);
      const float r0 = r0q * r0q;
      const float schlick = r0 + (1.0f - r0) * powf(1.0f - cos_t, 5.0f);
      if (ri * sin_t > 1.0f || schlick > u_die) {
        reflect3(ui, nrm, dir);
      } else {
        float perp[3];
        for (int i = 0; i < 3; ++i) perp[i] = ri * (ui[i] + cos_t * nrm[i]);
        const float par = -sqrtf(fmaxf(fabsf(1.0f - dot3(perp, perp)), 1e-12f));
        for (int i = 0; i < 3; ++i) dir[i] = perp[i] + par * nrm[i];
      }
      scattered = true;
    } else {
      for (int i = 0; i < 3; ++i) dir[i] = nrm[i] + uv[i];
      if (fabsf(dir[0]) < 1e-8f && fabsf(dir[1]) < 1e-8f && fabsf(dir[2]) < 1e-8f)
        for (int i = 0; i < 3; ++i) dir[i] = nrm[i];
    }

    // Accumulate and advance (the wavefront body's order).
    const bool cont = ray_hit && scattered && (bounce + 1 < cfg.max_bounces);
    if (!cont) {
      float c[3] = {0.0f, 0.0f, 0.0f};
      if (!ray_hit) {
        const float len = sqrtf(fmaxf(a, 1e-40f));
        const float t = 0.5f * (d[1] / len + 1.0f);
        const float sky[3] = {(1.0f - t) + t * 0.5f, (1.0f - t) + t * 0.7f, (1.0f - t) + t * 1.0f};
        for (int i = 0; i < 3; ++i) c[i] = tp[i] * sky[i];
      } else if (is_light) {
        for (int i = 0; i < 3; ++i) c[i] = cfg.emission_quirk ? emi[i] : tp[i] * emi[i];
      }
      for (int i = 0; i < 3; ++i) acc[i] = acc[i] + c[i];
      ++sample;
      active = false;
    } else {
      for (int i = 0; i < 3; ++i) {
        tp[i] = tp[i] * (is_die ? 1.0f : alb[i]);
        ray.o[i] = point[i];
        ray.d[i] = dir[i];
      }
      ++bounce;
    }
  }
  for (int i = 0; i < 3; ++i) out[i] = acc[i] / (float)cfg.spp;
}

}  // namespace pt
