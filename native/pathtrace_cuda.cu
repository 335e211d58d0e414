// CUDA target of the fused path loop: one thread per lane (pixel), each
// running its pixel's whole sample x bounce loop (pathtrace.h), as the
// reference's megakernel does (CUDAKernels.h:147-166). Lanes arrive in an
// order where each warp covers a compact screen tile (models/fused.py), so
// a warp's camera rays and first bounces stay coherent; the scene tables
// are read through L1 and L2.
#include <cuda_runtime.h>

#include <string>

#include "pathtrace_ffi.h"

namespace {

constexpr int kThreads = 128;

__global__ void path_trace_kernel(pt::SceneView s, pt::Config c, const int32_t* __restrict__ keys,
                                  const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                                  float* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  c.k0 = (uint32_t)__ldg(keys);
  c.k1 = (uint32_t)__ldg(keys + 1);
  c.sample_offset = __ldg(keys + 2);
  pt::trace_lane(s, c, __ldg(px + i), __ldg(py + i), out + 3 * i);
}

pt::ffi::Error PathTraceCuda(cudaStream_t stream, PT_FFI_PARAMS) {
  const pt::SceneView s = pt::make_view(cam, sph, sph_mat, mat, mat_type, node_box, node_child,
                                        tri, tri_mat, brute, brute_mat);
  pt::ffi::Error err = pt::check_shapes(s, px, py, keys, cam, out);
  if (err.failure()) return err;
  const pt::Config c = pt::make_config(width, height, spp, max_bounces, min_bounces,
                                       emission_quirk, rr_max_prob, t_min);
  const int64_t n = (int64_t)px.element_count();
  if (n == 0) return pt::ffi::Error::Success();
  // Launch on the device that holds the output (one handler call per
  // device under shard_map).
  cudaPointerAttributes attr;
  if (cudaPointerGetAttributes(&attr, out->typed_data()) == cudaSuccess &&
      attr.type == cudaMemoryTypeDevice)
    cudaSetDevice(attr.device);
  else
    cudaGetLastError();  // clear the query's error; launch on the current device
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  path_trace_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      s, c, keys.typed_data(), px.typed_data(), py.typed_data(), out->typed_data(), n);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess)
    return pt::ffi::Error::Internal(std::string("path_trace_kernel launch: ") + cudaGetErrorString(e));
  return pt::ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(PathTraceCudaHandler, PathTraceCuda,
                              pt::ffi::Ffi::Bind()
                                  .Ctx<pt::ffi::PlatformStream<cudaStream_t>>() PT_FFI_OPERANDS);
