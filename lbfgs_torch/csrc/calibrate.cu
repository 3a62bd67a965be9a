// The launch-calibration kernel, by hand for Hopper (sm_90a).
//
// Replaces the JAX package's harness calibration kernel
// (bench_kernels.py:108, ``kern``: o = x + 1 on one 8x128 block, launched
// through pl.pallas_call).  One block of 1024 threads adds 1 to 1024
// float32 elements: it moves 8 KiB, so its time per launch is what every
// kernel launch costs the host and the card beyond its work.  The port's
// profiling module (utils/profiling.null_launch) launches it back to back,
// and with one synchronising read per launch, to split the host share of
// an iteration into launches and reads.

#include <cuda_runtime.h>

namespace {

constexpr int kElems = 1024;

__global__ void __launch_bounds__(kElems)
null_kernel(const float* __restrict__ x, float* __restrict__ o) {
  o[threadIdx.x] = x[threadIdx.x] + 1.0f;
}

}  // namespace

extern "C" {

int lbfgs_null_elems() { return kElems; }

int lbfgs_null_launch(const void* x, void* o, void* stream) {
  null_kernel<<<1, kElems, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(o));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
