// XLA FFI binding shared by the CPU and CUDA targets of the fused path
// loop: operand order, attributes and the SceneView they describe.
#pragma once

#include <cstdint>

#include "pathtrace.h"
#include "xla/ffi/api/ffi.h"

namespace pt {

namespace ffi = xla::ffi;
using F32 = ffi::Buffer<ffi::F32>;
using S32 = ffi::Buffer<ffi::S32>;

// Operands: px, py, keys [k0, k1, sample_offset], cam, spheres, sphere
// materials, materials, material types, node boxes, node children,
// triangles, triangle materials, brute triangles, brute materials.
#define PT_FFI_OPERANDS                                                      \
  .Arg<pt::S32>().Arg<pt::S32>().Arg<pt::S32>().Arg<pt::F32>()               \
      .Arg<pt::F32>().Arg<pt::S32>().Arg<pt::F32>().Arg<pt::S32>()           \
      .Arg<pt::F32>().Arg<pt::S32>().Arg<pt::F32>().Arg<pt::S32>()           \
      .Arg<pt::F32>().Arg<pt::S32>()                                         \
      .Ret<pt::F32>()                                                        \
      .Attr<int32_t>("width").Attr<int32_t>("height").Attr<int32_t>("spp")   \
      .Attr<int32_t>("max_bounces").Attr<int32_t>("min_bounces")             \
      .Attr<int32_t>("emission_quirk").Attr<float>("rr_max_prob")            \
      .Attr<float>("t_min")

#define PT_FFI_PARAMS                                                        \
  pt::S32 px, pt::S32 py, pt::S32 keys, pt::F32 cam, pt::F32 sph,            \
      pt::S32 sph_mat, pt::F32 mat, pt::S32 mat_type, pt::F32 node_box,      \
      pt::S32 node_child, pt::F32 tri, pt::S32 tri_mat, pt::F32 brute,       \
      pt::S32 brute_mat, pt::ffi::Result<pt::F32> out, int32_t width,        \
      int32_t height, int32_t spp, int32_t max_bounces, int32_t min_bounces, \
      int32_t emission_quirk, float rr_max_prob, float t_min

inline SceneView make_view(F32 cam, F32 sph, S32 sph_mat, F32 mat, S32 mat_type, F32 node_box,
                           S32 node_child, F32 tri, S32 tri_mat, F32 brute, S32 brute_mat) {
  SceneView s;
  s.cam = cam.typed_data();
  s.sph = sph.typed_data();
  s.sph_mat = sph_mat.typed_data();
  s.n_sph = (int32_t)sph_mat.element_count();
  s.mat = mat.typed_data();
  s.mat_type = mat_type.typed_data();
  s.n_mat = (int32_t)mat_type.element_count();
  s.node_box = node_box.typed_data();
  s.node_child = node_child.typed_data();
  auto dims = node_child.dimensions();
  s.width = dims.size() == 2 ? (int32_t)dims[1] : 0;
  s.tri = tri.typed_data();
  s.tri_mat = tri_mat.typed_data();
  s.brute = brute.typed_data();
  s.brute_mat = brute_mat.typed_data();
  s.n_brute = (int32_t)brute_mat.element_count();
  return s;
}

inline Config make_config(int32_t width, int32_t height, int32_t spp, int32_t max_bounces,
                          int32_t min_bounces, int32_t emission_quirk, float rr_max_prob,
                          float t_min) {
  Config c;
  c.width = width;
  c.height = height;
  c.spp = spp;
  c.max_bounces = max_bounces;
  c.min_bounces = min_bounces;
  c.emission_quirk = emission_quirk;
  c.rr_max_prob = rr_max_prob;
  c.t_min = t_min;
  c.k0 = c.k1 = 0;
  c.sample_offset = 0;
  return c;
}

inline ffi::Error check_shapes(const SceneView& s, S32 px, S32 py, S32 keys, F32 cam,
                               ffi::Result<F32>& out) {
  if (s.width != 4 && s.width != 8) return ffi::Error::InvalidArgument("tree width must be 4 or 8");
  if (px.element_count() != py.element_count() || 3 * px.element_count() != out->element_count())
    return ffi::Error::InvalidArgument("px, py and out disagree on the lane count");
  if (keys.element_count() != 3) return ffi::Error::InvalidArgument("keys must hold 3 words");
  if (cam.element_count() != kCamFloats) return ffi::Error::InvalidArgument("camera must hold 19 floats");
  return ffi::Error::Success();
}

}  // namespace pt
