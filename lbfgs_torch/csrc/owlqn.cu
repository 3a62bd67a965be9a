// OWL-QN's elementwise kernels, by hand for Hopper (sm_90a):
//
//   K10    pseudo_grad_kernel<T, true, false>  pg and per-block partials of pg.pg
//   K11    pseudo_grad_kernel<T, false, false> pg alone
//   K10 b  pseudo_grad_kernel<T, true, true>   K10 per instance of a batch
//   K11 b  pseudo_grad_kernel<T, false, true>  K11 per instance of a batch
//   K9     trial_step_kernel<T>                the projected trial point
//   K9 b   trial_step_batched_kernel<T>        K9 per instance of a batch
//
// K10 and K11 replace lbfgs_tpu/ops/fused.py:_pseudo_grad_norm_kernel and
// :_pseudo_grad_kernel (owlqn_pseudo_gradient_norm_pallas and
// owlqn_pseudo_gradient_pallas).  For every element i, with the L1 weight c
// and the global window [lo, hi) (Andrew & Gao Eq. 4,
// src/orthantwise.rs:82-112):
//
//     outside the window      pg_i = g_i
//     x_i != 0                pg_i = g_i + sign(x_i) * c
//     x_i == 0                pg_i = g_i + c   if g_i + c < 0
//                                    g_i - c   if g_i - c > 0
//                                    0         otherwise
//
// sign() here is the plain sign, NaN for NaN, as the JAX kernel's
// jnp.sign: a NaN iterate gives a NaN pg.  K11 is K10's body with the norm
// compiled out (kNorm), so the two give the same pg bit for bit.
//
// K10 b (kBatched) replaces _pseudo_grad_norm_kernel under the batched
// runner's vmap (lbfgs_tpu/batched.py:28-33, the init): K10 over [B, n]
// instances, blockIdx.y the instance and blockIdx.x its block, laid out
// and summed as K10 lays out the same n, so an instance's pg and partials
// are solo K10's bit for bit.  The window is the same for every instance,
// in its own indices.  A block whose instance is frozen (live[b] == 0)
// returns before it loads or stores anything.  Bound: bytes, as K10.
// K11 b is K10 b with the norm compiled out: it replaces
// _pseudo_grad_kernel under the vmap (the generic objectives' init,
// lbfgs_tpu/solver.py:1196-1197, and the runner's finalize,
// lbfgs_tpu/batched.py:64-69), and an instance's pg is solo K11's.
//
// K9 replaces lbfgs_tpu/ops/fused.py:_trial_step_kernel
// (owlqn_trial_step_pallas): x = xp + stp*d, then zero inside [lo, hi)
// where msign(x) != msign(wp), msign mapping NaN and +-0 to 0 (the
// reference's signum).  The step is rounded as round(xp + round(stp*d))
// with __fmul_rn / __fadd_rn, so nvcc cannot contract it into an fma: the
// point is the plain version's bit for bit, and the one that the Triton
// kernels K7, K8 and K14 (launched without contraction) project.
//
// K9 b replaces _trial_step_kernel under the vmap (each trial point of a
// generic objective's batched OWL-QN search, lbfgs_tpu/linesearch.py:282):
// K9 over [B, n] instances, blockIdx.y the instance, each with its own
// step from a [B] array of the vectors' type.  It takes no orthant array:
// as K8 b's pg form does, it rebuilds the search's orthant in registers
// from (xp, pg), wp = signum(-pg) where xp == 0, else signum(xp)
// (choose_orthant), which is what the solo search hands K9, so an
// instance's point is solo K9's bit for bit, and the [B, n] orthant is
// never written or read.  A frozen instance's block returns before it
// loads or stores anything.
//
// What bounds them on the H100: bytes.  K10 and K11 read x and g and
// write pg (12 bytes per element in f32), K9 reads xp, d and wp and writes
// x (16 bytes; K9 b reads pg in wp's place), for a handful of compares
// and adds.  So each streams its operands once, coalesced (thread t of a block touches element
// base + k*256 + t), and K10 takes the norm in the same pass instead of
// re-reading pg.  The cross-block sum uses no atomics: each block writes
// its partial and the caller adds the [blocks] partials in a fixed order,
// so runs repeat bit for bit.

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

// xp + stp*d, each operation rounded to nearest (no fma)
__device__ __forceinline__ float step_rn(float xp, float stp, float d) {
  return __fadd_rn(xp, __fmul_rn(stp, d));
}

__device__ __forceinline__ double step_rn(double xp, double stp, double d) {
  return __dadd_rn(xp, __dmul_rn(stp, d));
}

// the reference's signum: +-1, and 0 at +-0 and NaN
template <typename T>
__device__ __forceinline__ T msign(T v) {
  return v > T(0) ? T(1) : (v < T(0) ? T(-1) : T(0));
}

template <typename T, bool kNorm, bool kBatched>
__global__ void __launch_bounds__(kThreads)
pseudo_grad_kernel(const T* __restrict__ x, const T* __restrict__ g, T c, long long lo,
                   long long hi, T* __restrict__ pg, T* __restrict__ partials, long long n,
                   const unsigned char* __restrict__ live) {
  __shared__ T red[kThreads / 32];
  if constexpr (kBatched) {
    // instance b's rows, and its row of [B, gridDim.x] partials
    const long long b = blockIdx.y;
    if (!live[b]) return;
    x += b * n;
    g += b * n;
    pg += b * n;
    if constexpr (kNorm) partials += b * gridDim.x;
  }
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
      if constexpr (kNorm) acc += p * p;
    }
  }
  if constexpr (kNorm) {
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
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
trial_step_kernel(const T* __restrict__ xp, const T* __restrict__ d, const T* __restrict__ wp,
                  T stp, long long lo, long long hi, T* __restrict__ out, long long n) {
  const long long base = static_cast<long long>(blockIdx.x) * kBlockElems;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = base + k * kThreads + threadIdx.x;
    if (i < n) {
      T xv = step_rn(xp[i], stp, d[i]);
      if (i >= lo && i < hi && msign(xv) != msign(wp[i])) xv = T(0);
      out[i] = xv;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
trial_step_batched_kernel(const T* __restrict__ xp, const T* __restrict__ d,
                          const T* __restrict__ pg, const T* __restrict__ stp, long long lo,
                          long long hi, T* __restrict__ out, long long n,
                          const unsigned char* __restrict__ live) {
  // instance b's rows and its step
  const long long b = blockIdx.y;
  if (!live[b]) return;
  const T s = stp[b];
  xp += b * n;
  d += b * n;
  pg += b * n;
  out += b * n;
  const long long base = static_cast<long long>(blockIdx.x) * kBlockElems;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = base + k * kThreads + threadIdx.x;
    if (i < n) {
      const T xpv = xp[i];
      T xv = step_rn(xpv, s, d[i]);
      if (i >= lo && i < hi) {
        // the orthant of the search (choose_orthant), then K9's test
        const T w = xpv == T(0) ? msign(-pg[i]) : msign(xpv);
        if (msign(xv) != w) xv = T(0);
      }
      out[i] = xv;
    }
  }
}

unsigned grid(long long n) { return static_cast<unsigned>((n + kBlockElems - 1) / kBlockElems); }

template <typename T, bool kNorm>
int launch_pseudo_grad(const void* x, const void* g, double c, long long lo, long long hi,
                       void* pg, void* partials, long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  pseudo_grad_kernel<T, kNorm, false>
      <<<grid(n), kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T>(c), lo, hi,
          static_cast<T*>(pg), static_cast<T*>(partials), n, nullptr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kNorm>
int launch_pseudo_grad_batched(const void* x, const void* g, double c, long long lo,
                               long long hi, const void* live, void* pg, void* partials,
                               long long n, int batch, void* stream) {
  if (n <= 0 || batch < 1 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 blocks(grid(n), static_cast<unsigned>(batch));
  pseudo_grad_kernel<T, kNorm, true>
      <<<blocks, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T>(c), lo, hi,
          static_cast<T*>(pg), static_cast<T*>(partials), n,
          static_cast<const unsigned char*>(live));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_trial_step(const void* xp, const void* d, const void* wp, double stp, long long lo,
                      long long hi, void* out, long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  trial_step_kernel<T><<<grid(n), kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xp), static_cast<const T*>(d), static_cast<const T*>(wp),
      static_cast<T>(stp), lo, hi, static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_trial_step_batched(const void* xp, const void* d, const void* pg, const void* stp,
                              long long lo, long long hi, const void* live, void* out,
                              long long n, int batch, void* stream) {
  if (n <= 0 || batch < 1 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 blocks(grid(n), static_cast<unsigned>(batch));
  trial_step_batched_kernel<T><<<blocks, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xp), static_cast<const T*>(d), static_cast<const T*>(pg),
      static_cast<const T*>(stp), lo, hi, static_cast<T*>(out), n,
      static_cast<const unsigned char*>(live));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int lbfgs_owlqn_block_elems() { return kBlockElems; }

// c and stp arrive as doubles and are rounded to the vectors' type, as the
// JAX kernels round theirs to float32 (exact for a value of that type)
int lbfgs_pseudo_grad_norm_f32(const void* x, const void* g, double c, long long lo,
                               long long hi, void* pg, void* partials, long long n,
                               void* stream) {
  return launch_pseudo_grad<float, true>(x, g, c, lo, hi, pg, partials, n, stream);
}

int lbfgs_pseudo_grad_norm_f64(const void* x, const void* g, double c, long long lo,
                               long long hi, void* pg, void* partials, long long n,
                               void* stream) {
  return launch_pseudo_grad<double, true>(x, g, c, lo, hi, pg, partials, n, stream);
}

// K10 b: x, g, pg [batch, n]; live [batch]; partials [batch, blocks]
int lbfgs_pseudo_grad_norm_batched_f32(const void* x, const void* g, double c, long long lo,
                                       long long hi, const void* live, void* pg,
                                       void* partials, long long n, int batch, void* stream) {
  return launch_pseudo_grad_batched<float, true>(x, g, c, lo, hi, live, pg, partials, n, batch,
                                                 stream);
}

int lbfgs_pseudo_grad_norm_batched_f64(const void* x, const void* g, double c, long long lo,
                                       long long hi, const void* live, void* pg,
                                       void* partials, long long n, int batch, void* stream) {
  return launch_pseudo_grad_batched<double, true>(x, g, c, lo, hi, live, pg, partials, n,
                                                  batch, stream);
}

// K11 b: x, g, pg [batch, n]; live [batch]
int lbfgs_pseudo_grad_batched_f32(const void* x, const void* g, double c, long long lo,
                                  long long hi, const void* live, void* pg, long long n,
                                  int batch, void* stream) {
  return launch_pseudo_grad_batched<float, false>(x, g, c, lo, hi, live, pg, nullptr, n, batch,
                                                  stream);
}

int lbfgs_pseudo_grad_batched_f64(const void* x, const void* g, double c, long long lo,
                                  long long hi, const void* live, void* pg, long long n,
                                  int batch, void* stream) {
  return launch_pseudo_grad_batched<double, false>(x, g, c, lo, hi, live, pg, nullptr, n,
                                                   batch, stream);
}

int lbfgs_pseudo_grad_f32(const void* x, const void* g, double c, long long lo, long long hi,
                          void* pg, long long n, void* stream) {
  return launch_pseudo_grad<float, false>(x, g, c, lo, hi, pg, nullptr, n, stream);
}

int lbfgs_pseudo_grad_f64(const void* x, const void* g, double c, long long lo, long long hi,
                          void* pg, long long n, void* stream) {
  return launch_pseudo_grad<double, false>(x, g, c, lo, hi, pg, nullptr, n, stream);
}

int lbfgs_owlqn_trial_step_f32(const void* xp, const void* d, const void* wp, double stp,
                               long long lo, long long hi, void* out, long long n,
                               void* stream) {
  return launch_trial_step<float>(xp, d, wp, stp, lo, hi, out, n, stream);
}

int lbfgs_owlqn_trial_step_f64(const void* xp, const void* d, const void* wp, double stp,
                               long long lo, long long hi, void* out, long long n,
                               void* stream) {
  return launch_trial_step<double>(xp, d, wp, stp, lo, hi, out, n, stream);
}

// K9 b: xp, d, pg, out [batch, n]; stp [batch] of the vectors' type; live [batch]
int lbfgs_owlqn_trial_step_batched_f32(const void* xp, const void* d, const void* pg,
                                       const void* stp, long long lo, long long hi,
                                       const void* live, void* out, long long n, int batch,
                                       void* stream) {
  return launch_trial_step_batched<float>(xp, d, pg, stp, lo, hi, live, out, n, batch, stream);
}

int lbfgs_owlqn_trial_step_batched_f64(const void* xp, const void* d, const void* pg,
                                       const void* stp, long long lo, long long hi,
                                       const void* live, void* out, long long n, int batch,
                                       void* stream) {
  return launch_trial_step_batched<double>(xp, d, pg, stp, lo, hi, live, out, n, batch,
                                           stream);
}

}  // extern "C"
