// CPU target of the fused path loop: the same per-lane code as the CUDA
// kernel (pathtrace.h), run lane after lane on the host.
#include "pathtrace_ffi.h"

namespace {

pt::ffi::Error PathTraceCpu(PT_FFI_PARAMS) {
  const pt::SceneView s = pt::make_view(cam, sph, sph_mat, mat, mat_type, node_box, node_child,
                                        tri, tri_mat, brute, brute_mat);
  pt::ffi::Error err = pt::check_shapes(s, px, py, keys, cam, out);
  if (err.failure()) return err;
  pt::Config c = pt::make_config(width, height, spp, max_bounces, min_bounces, emission_quirk,
                                 rr_max_prob, t_min);
  const int32_t* kw = keys.typed_data();
  c.k0 = (uint32_t)kw[0];
  c.k1 = (uint32_t)kw[1];
  c.sample_offset = kw[2];
  const int64_t n = (int64_t)px.element_count();
  const int32_t* pxs = px.typed_data();
  const int32_t* pys = py.typed_data();
  float* o = out->typed_data();
  for (int64_t i = 0; i < n; ++i) pt::trace_lane(s, c, pxs[i], pys[i], o + 3 * i);
  return pt::ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(PathTraceCpuHandler, PathTraceCpu,
                              pt::ffi::Ffi::Bind() PT_FFI_OPERANDS);
