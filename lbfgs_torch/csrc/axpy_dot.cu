// K17: fused axpy + dot, by hand for Hopper (sm_90a).
//
// Replaces lbfgs_tpu/ops/fused.py:_axpy_dot_kernel (axpy_dot_pallas).  For
// every element i
//
//     z_i = y_i + c * x_i
//
// and, in the same pass, per-block partials of z.w.  The product and the
// sum are rounded one by one (__fmul_rn / __fadd_rn and their f64 forms),
// so nvcc cannot contract them into an fma and z is the plain version's
// (y + c*x in torch, c rounded to the vectors' type) bit for bit.  No
// solver path runs it: the JAX package keeps it for scan-mode composition
// and as the pattern of a reduction-carrying elementwise kernel.
//
// What bounds it on the H100: bytes.  It reads y, x and w and writes z (16
// bytes per element in f32) for three operations, so it streams each
// operand once, coalesced (thread t of a block touches element
// base + k*256 + t), and takes the dot in the same pass instead of
// re-reading z.  The cross-block sum uses no atomics: each block writes its
// partial and the caller adds the [blocks] partials in a fixed order.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kBlockElems = kThreads * kPerThread;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  // fixed shuffle tree: the same inputs always add in the same order
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// y + c*x, each operation rounded to nearest (no fma)
__device__ __forceinline__ float axpy_rn(float y, float c, float x) {
  return __fadd_rn(y, __fmul_rn(c, x));
}

__device__ __forceinline__ double axpy_rn(double y, double c, double x) {
  return __dadd_rn(y, __dmul_rn(c, x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
axpy_dot_kernel(const T* __restrict__ y, const T* __restrict__ x, T c, const T* __restrict__ w,
                T* __restrict__ z, T* __restrict__ partials, long long n) {
  __shared__ T red[kThreads / 32];
  const long long base = static_cast<long long>(blockIdx.x) * kBlockElems;
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = base + k * kThreads + threadIdx.x;
    if (i < n) {
      const T zv = axpy_rn(y[i], c, x[i]);
      z[i] = zv;
      acc += zv * w[i];
    }
  }
  acc = warp_sum(acc);
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) red[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    T a = T(0);
    for (int v = 0; v < kThreads / 32; ++v) a += red[v];
    partials[blockIdx.x] = a;
  }
}

template <typename T>
int launch_axpy_dot(const void* y, const void* x, double c, const void* w, void* z,
                    void* partials, long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n + kBlockElems - 1) / kBlockElems);
  axpy_dot_kernel<T><<<blocks, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<const T*>(x), static_cast<T>(c),
      static_cast<const T*>(w), static_cast<T*>(z), static_cast<T*>(partials), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int lbfgs_axpy_dot_block_elems() { return kBlockElems; }

// c arrives as a double and is rounded to the vectors' type, as torch
// rounds a Python scalar in y + c*x
int lbfgs_axpy_dot_f32(const void* y, const void* x, double c, const void* w, void* z,
                       void* partials, long long n, void* stream) {
  return launch_axpy_dot<float>(y, x, c, w, z, partials, n, stream);
}

int lbfgs_axpy_dot_f64(const void* y, const void* x, double c, const void* w, void* z,
                       void* partials, long long n, void* stream) {
  return launch_axpy_dot<double>(y, x, c, w, z, partials, n, stream);
}

}  // extern "C"
