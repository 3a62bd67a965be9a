// K10: OWL-QN's pseudo-gradient and its squared norm, by hand for Hopper
// (sm_90a).
//
// Replaces lbfgs_tpu/ops/fused.py:_pseudo_grad_norm_kernel (launched by
// owlqn_pseudo_gradient_norm_pallas).  For every element i, with the
// L1 weight c and the global window [lo, hi) (Andrew & Gao Eq. 4,
// src/orthantwise.rs:82-112):
//
//     outside the window      pg_i = g_i
//     x_i != 0                pg_i = g_i + sign(x_i) * c
//     x_i == 0                pg_i = g_i + c   if g_i + c < 0
//                                    g_i - c   if g_i - c > 0
//                                    0         otherwise
//
// and per-block partials of pg.pg.  sign() here is the plain sign, NaN
// for NaN, as the JAX kernel's jnp.sign: a NaN iterate gives a NaN pg.
//
// What bounds it on the H100: bytes.  It reads x and g and writes pg
// (12 bytes per element in f32) for a handful of compares and one add,
// so the design streams each operand once, coalesced (thread t of a block
// touches element base + k*256 + t), and takes the norm in the same pass
// instead of re-reading pg.  The cross-block sum uses no atomics: each
// block writes its partial and the caller adds the [blocks] partials in
// a fixed order, so runs repeat bit for bit.

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
pseudo_grad_norm_kernel(const T* __restrict__ x, const T* __restrict__ g, T c,
                        long long lo, long long hi, T* __restrict__ pg,
                        T* __restrict__ partials, long long n) {
  __shared__ T red[kThreads / 32];
  const long long base = static_cast<long long>(blockIdx.x) * kBlockElems;
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = base + k * kThreads + threadIdx.x;
    if (i < n) {
      const T xv = x[i];
      const T gv = g[i];
      T p = gv;
      if (i >= lo && i < hi) {
        if (xv != T(0)) {
          // +-1 for a number, the NaN itself for NaN
          const T sgn = xv > T(0) ? T(1) : (xv < T(0) ? T(-1) : xv);
          p = gv + sgn * c;
        } else {
          const T right = gv + c;
          const T left = gv - c;
          p = right < T(0) ? right : (left > T(0) ? left : T(0));
        }
      }
      pg[i] = p;
      acc += p * p;
    }
  }
  acc = warp_sum(acc);
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) red[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    T a = T(0);
    for (int w = 0; w < kThreads / 32; ++w) a += red[w];
    partials[blockIdx.x] = a;
  }
}

template <typename T>
int launch_pseudo_grad_norm(const void* x, const void* g, double c, long long lo, long long hi,
                            void* pg, void* partials, long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kBlockElems - 1) / kBlockElems;
  pseudo_grad_norm_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                               reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T>(c), lo, hi,
      static_cast<T*>(pg), static_cast<T*>(partials), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int lbfgs_pseudo_grad_norm_block_elems() { return kBlockElems; }

// c arrives as a double and is rounded to the vectors' type, as the JAX
// kernel rounds its c to float32
int lbfgs_pseudo_grad_norm_f32(const void* x, const void* g, double c, long long lo,
                               long long hi, void* pg, void* partials, long long n,
                               void* stream) {
  return launch_pseudo_grad_norm<float>(x, g, c, lo, hi, pg, partials, n, stream);
}

int lbfgs_pseudo_grad_norm_f64(const void* x, const void* g, double c, long long lo,
                               long long hi, void* pg, void* partials, long long n,
                               void* stream) {
  return launch_pseudo_grad_norm<double>(x, g, c, lo, hi, pg, partials, n, stream);
}

}  // extern "C"
