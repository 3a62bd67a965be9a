// K3, K6 and K13: the compact two-loop's direction combine, by hand for
// Hopper (sm_90a).
//
// K3 replaces lbfgs_tpu/ops/fused.py:_combine_kernel (launched by
// _combine_single).  Computes, for every element i of the vectors,
//
//     r_i = gamma * g_i + sum_j cs_j * S[j, i] + sum_j cy_j * Y[j, i]
//
// and, as byproducts of the same pass, per-block partials of r.r (the
// squared direction norm) and r.g (the next line search's dginit when the
// caller folds the two-loop's sign into gamma and the coefficients).
//
// K13 (kOw = true) replaces lbfgs_tpu/ops/fused.py:_combine_ow_kernel:
// the same body, with OWL-QN's direction constraint applied in the pass.
// There g holds the pseudo-gradient pg, and inside the global window
// [lo, hi) an element whose sign disagrees with -pg is zeroed
// (rc = pi(r; -pg), src/orthantwise.rs:140-161).  Its three partials are
// r.r BEFORE the constraint (the reference's dnorm, src/lbfgs.rs:544),
// rc.rc (the zero-direction check) and rc.pg (the next search's dginit).
// Signs are compared with msign, which maps NaN to 0 as the reference's
// signum does.
//
// K6 (kFix = true) replaces lbfgs_tpu/ops/fused.py:_combine_fix_kernel:
// K3's body, which also persists the damped ring row in the same pass,
//
//     Y[end, i] = round(ca * Y[end, i] + cb * g_i)
//
// with (ca, cb) after the coefficients.  The caller has folded the
// damping into gamma and cy[end], so the combination reads the row as it
// was; each thread reads its element of the row before it writes it.  The
// products and the sum are rounded one by one (__fmul_rn/__fadd_rn and
// their f64 forms: no contraction into an fma), and the result is
// rounded to the history type to nearest even, so the row equals the
// plain version's bit for bit.  It costs one row write (2 bytes per
// element with a bf16 history) and no read.
//
// The combination itself is written with __fmul_rn/__fadd_rn (and the f64
// forms) in the order acc_s += cs_j*S_j, acc_y += cy_j*Y_j, then
// gamma*g + (acc_s + acc_y): nvcc would otherwise contract the products
// into fmas, and r would differ in the last bits from the Triton fusions
// K15 and K16 (launched without contraction), which compute the same sums
// in the same order.  So K3's r is K15's bit for bit, K13's rc K16's, and
// which of the two the solver runs does not change the trajectory.  The
// partial sums r.r, r.g are reassociated by the block reduction anyway
// and keep nvcc's default.
//
// K3 b, K13 b and K6 b, the batched runner's forms (combine_batched_kernel,
// below), are K3, K13 and K6 over [B, n] instances with blockIdx.y as the
// instance, at any depth as the solo forms.
//
// The rings are [m, n] with a row stride ld: n, or n rounded up to a
// multiple of 16 elements (the package's padded ring, whose pad columns
// are zero and never read here); row j of instance b starts at element
// (b*m + j)*ld.
//
// Any history depth: the 2m+1 coefficients (2m+3 for K6) sit in shared
// memory.  Up to kStaticM ring rows that is a static array, as it always
// was; a deeper ring runs the same body (kDyn) with the array sized at
// launch, (3 + 2m) * sizeof(T) bytes.  The array sized at launch for every
// depth kept the bits but ran K3 at m = 6 in 0.245 ms against 0.228 (H100
// 80GB HBM3, 700 W, in turns).  Past the default 48 KB (m > 3,070 in
// float64) the launch raises the kernel's limit; the H100's 227 KB per
// block holds m up to about 14,500 in float64 and 29,000 in float32, and a
// deeper ring's launch is refused.
//
// What bounds it on the H100: bytes.  It reads g and the 2m history rows
// and writes r, doing 2m+1 multiply-adds per element: with f32 vectors
// and a bf16 history at m = 6 that is 4 + 24 + 4 = 32 bytes per element
// against ~13 flops, far below the card's flop-per-byte balance.  The
// design therefore streams every operand exactly once, coalesced (thread
// t of a block touches element base + k*256 + t of each row), keeps the
// 2m+1 coefficients in shared memory, widens the bf16 history in
// registers, and never writes an intermediate.  The constraint costs no
// bytes: the window test is on the element's global index and pg is the
// g already loaded.  The cross-block sums are not done with atomics: each
// block writes its partials and the caller adds the [blocks, k] partials
// in a fixed order, so runs repeat bit for bit.  Vectorised loads and
// more work per thread are left for later tuning.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kBlockElems = kThreads * kPerThread;
// ring rows whose coefficients fit the static shared array
constexpr int kStaticM = 64;

template <typename T, typename H>
__device__ __forceinline__ T widen(H v) {
  return static_cast<T>(v);
}

template <>
__device__ __forceinline__ float widen<float, __nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename H, typename T>
__device__ __forceinline__ H narrow(T v) {
  return static_cast<H>(v);
}

template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16, float>(float v) {
  return __float2bfloat16_rn(v);
}

// products and sums rounded on their own: nvcc never contracts these
// intrinsics into an fma, whatever --fmad says
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// a * b + c * d with every operation rounded on its own (never an fma)
template <typename T>
__device__ __forceinline__ T blend_rn(T a, T b, T c, T d) {
  return add_rn(mul_rn(a, b), mul_rn(c, d));
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  // fixed shuffle tree: the same inputs always add in the same order
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// sign with NaN and +-0 mapped to 0 (the reference's signum)
template <typename T>
__device__ __forceinline__ int msign(T v) {
  return v > T(0) ? 1 : (v < T(0) ? -1 : 0);
}

// coef = [gamma, cs_0 .. cs_{m-1}, cy_0 .. cy_{m-1}] (kFix: then ca, cb);
// partials = [gridDim.x, kOw ? 3 : 2]; only K6 writes Y (row fix_end)
template <typename T, typename H, bool kOw, bool kFix, bool kDyn>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const T* __restrict__ g, const H* __restrict__ S, H* __restrict__ Y,
               const T* __restrict__ coef, T* __restrict__ r, T* __restrict__ partials,
               long long n, long long ld, int m, long long lo, long long hi, int fix_end) {
  constexpr int kParts = kOw ? 3 : 2;
  // the coefficients: the static array, or (kDyn) the one sized at launch
  __shared__ T c_static[kDyn ? 1 : 3 + 2 * kStaticM];
  extern __shared__ __align__(16) unsigned char c_dyn[];
  T* const c = kDyn ? reinterpret_cast<T*>(c_dyn) : c_static;
  __shared__ T red[kParts][kThreads / 32];
  const int ncoef = kFix ? 3 + 2 * m : 1 + 2 * m;
  for (int i = threadIdx.x; i < ncoef; i += kThreads) c[i] = coef[i];
  __syncthreads();

  const long long base = static_cast<long long>(blockIdx.x) * kBlockElems;
  T acc[kParts];
#pragma unroll
  for (int p = 0; p < kParts; ++p) acc[p] = T(0);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = base + k * kThreads + threadIdx.x;
    if (i < n) {
      const T gv = g[i];
      T acc_s = T(0);
      T acc_y = T(0);
      T y_end = T(0);
      // the combination rounds as K15, K16 and the plain versions do: each
      // product and each add on its own, in their order
      for (int j = 0; j < m; ++j) {
        acc_s = add_rn(acc_s, mul_rn(c[1 + j], widen<T, H>(S[j * ld + i])));
        const T yj = widen<T, H>(Y[j * ld + i]);
        acc_y = add_rn(acc_y, mul_rn(c[1 + m + j], yj));
        if constexpr (kFix) {
          if (j == fix_end) y_end = yj;
        }
      }
      const T rv = add_rn(mul_rn(c[0], gv), add_rn(acc_s, acc_y));
      if constexpr (kFix) {
        Y[fix_end * ld + i] = narrow<H, T>(blend_rn(c[1 + 2 * m], y_end, c[2 + 2 * m], gv));
      }
      acc[0] += rv * rv;
      if constexpr (kOw) {
        const bool kill = i >= lo && i < hi && msign(rv) != -msign(gv);
        const T rc = kill ? T(0) : rv;
        r[i] = rc;
        acc[1] += rc * rc;
        acc[2] += rc * gv;
      } else {
        r[i] = rv;
        acc[1] += rv * gv;
      }
    }
  }

  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int p = 0; p < kParts; ++p) {
    const T v = warp_sum(acc[p]);
    if ((threadIdx.x & 31) == 0) red[p][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int p = 0; p < kParts; ++p) {
      T a = T(0);
      for (int w = 0; w < kThreads / 32; ++w) a += red[p][w];
      partials[kParts * blockIdx.x + p] = a;
    }
  }
}

template <typename T, typename H, bool kOw, bool kFix>
int launch_combine(const void* g, const void* S, void* Y, const void* coef, void* r,
                   void* partials, long long n, long long ld, int m, long long lo,
                   long long hi, int fix_end, void* stream) {
  if (n <= 0 || ld < n || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (kFix && (fix_end < 0 || fix_end >= m)) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kBlockElems - 1) / kBlockElems;
  const bool dyn = m > kStaticM;
  const long long smem = dyn ? (3LL + 2LL * m) * static_cast<long long>(sizeof(T)) : 0;
  const auto kernel =
      dyn ? combine_kernel<T, H, kOw, kFix, true> : combine_kernel<T, H, kOw, kFix, false>;
  if (smem > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    // past the default: ask for it (refused beyond the card's per-block
    // limit, which ends the launch with that error)
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(smem),
           reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(g), static_cast<const H*>(S), static_cast<H*>(Y),
      static_cast<const T*>(coef), static_cast<T*>(r), static_cast<T*>(partials), n, ld, m,
      lo, hi, fix_end);
  return static_cast<int>(cudaGetLastError());
}

// K3 b replaces lbfgs_tpu/ops/fused.py:_combine_kernel under the batched
// runner's vmap: K3 over a batch of B independent instances, [B, n]
// vectors, [B, m, n] rings and one coefficient row [gamma, cs, cy] per
// instance.  blockIdx.y is the instance and blockIdx.x its block of
// kBlockElems elements, laid out and summed as K3 lays out and sums the
// same n, so an instance's r and partials are solo K3's on that instance
// bit for bit.  Each block stages its instance's coefficients in shared
// memory: the static array up to kStaticM ring rows, above it (kDyn) the
// array sized at launch, as the solo kernel does, so any depth runs.  A
// block whose instance is frozen (live[b] == 0) returns before it loads or
// stores anything.  Bound: bytes, as K3 (32 bytes per element with f32
// vectors and a bf16 ring at m = 6).  B at most 65,535 (the grid's y
// limit).
//
// K13 b (kOw = true) replaces lbfgs_tpu/ops/fused.py:_combine_ow_kernel
// under the same vmap: K13's body per instance, g holding the instance's
// pseudo-gradient, the window [lo, hi) the same for every instance in its
// own indices, and K13's three partials (r.r before the constraint,
// rc.rc, rc.pg), so an instance's rc is solo K13's bit for bit.
//
// K6 b (kFix = true) replaces lbfgs_tpu/ops/fused.py:_combine_fix_kernel
// under the vmap: K6's body per instance, the coefficient row [gamma, cs,
// cy, ca, cb], and ring row fix_end (shared by the instances, which run
// in lockstep) of each live instance rewritten as round(ca * Y[fix_end] +
// cb * g) from the row as read, by K6's arithmetic, so an instance's r and
// damped row are solo K6's bit for bit (34 bytes per element at m = 6).
template <typename T, typename H, bool kOw, bool kFix, bool kDyn>
__global__ void __launch_bounds__(kThreads)
combine_batched_kernel(const T* __restrict__ g, const H* __restrict__ S, H* __restrict__ Y,
                       const T* __restrict__ coef, const unsigned char* __restrict__ live,
                       T* __restrict__ r, T* __restrict__ partials, long long n,
                       long long ld, int m, long long lo, long long hi, int fix_end) {
  constexpr int kParts = kOw ? 3 : 2;
  const long long b = blockIdx.y;
  if (!live[b]) return;
  __shared__ T c_static[kDyn ? 1 : (kFix ? 3 : 1) + 2 * kStaticM];
  extern __shared__ __align__(16) unsigned char c_dyn[];
  T* const c = kDyn ? reinterpret_cast<T*>(c_dyn) : c_static;
  __shared__ T red[kParts][kThreads / 32];
  const int ncoef = kFix ? 3 + 2 * m : 1 + 2 * m;
  for (int i = threadIdx.x; i < ncoef; i += kThreads) c[i] = coef[b * ncoef + i];
  __syncthreads();
  g += b * n;
  r += b * n;
  S += b * m * ld;
  Y += b * m * ld;

  const long long base = static_cast<long long>(blockIdx.x) * kBlockElems;
  T acc[kParts];
#pragma unroll
  for (int p = 0; p < kParts; ++p) acc[p] = T(0);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = base + k * kThreads + threadIdx.x;
    if (i < n) {
      const T gv = g[i];
      T acc_s = T(0);
      T acc_y = T(0);
      T y_end = T(0);
      // K3's combination, product by product and add by add
      for (int j = 0; j < m; ++j) {
        acc_s = add_rn(acc_s, mul_rn(c[1 + j], widen<T, H>(S[j * ld + i])));
        const T yj = widen<T, H>(Y[j * ld + i]);
        acc_y = add_rn(acc_y, mul_rn(c[1 + m + j], yj));
        if constexpr (kFix) {
          if (j == fix_end) y_end = yj;
        }
      }
      const T rv = add_rn(mul_rn(c[0], gv), add_rn(acc_s, acc_y));
      if constexpr (kFix) {
        // K6's damped row, from the row as read
        Y[fix_end * ld + i] = narrow<H, T>(blend_rn(c[1 + 2 * m], y_end, c[2 + 2 * m], gv));
      }
      acc[0] += rv * rv;
      if constexpr (kOw) {
        // K13's constraint against -pg inside the window
        const bool kill = i >= lo && i < hi && msign(rv) != -msign(gv);
        const T rc = kill ? T(0) : rv;
        r[i] = rc;
        acc[1] += rc * rc;
        acc[2] += rc * gv;
      } else {
        r[i] = rv;
        acc[1] += rv * gv;
      }
    }
  }

  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int p = 0; p < kParts; ++p) {
    const T v = warp_sum(acc[p]);
    if ((threadIdx.x & 31) == 0) red[p][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T* const out = partials + kParts * (b * gridDim.x + blockIdx.x);
#pragma unroll
    for (int p = 0; p < kParts; ++p) {
      T a = T(0);
      for (int w = 0; w < kThreads / 32; ++w) a += red[p][w];
      out[p] = a;
    }
  }
}

template <typename T, typename H, bool kOw, bool kFix>
int launch_combine_batched(const void* g, const void* S, void* Y, const void* coef,
                           const void* live, void* r, void* partials, long long n,
                           long long ld, int m, long long lo, long long hi, int fix_end,
                           int batch, void* stream) {
  if (n <= 0 || ld < n || m < 1 || batch < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kFix && (fix_end < 0 || fix_end >= m)) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kBlockElems - 1) / kBlockElems;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // the coefficients in the static array up to kStaticM rows, else in one
  // sized at launch (the solo launch's rule)
  const bool dyn = m > kStaticM;
  const long long smem =
      dyn ? ((kFix ? 3LL : 1LL) + 2LL * m) * static_cast<long long>(sizeof(T)) : 0;
  const auto kernel = dyn ? combine_batched_kernel<T, H, kOw, kFix, true>
                          : combine_batched_kernel<T, H, kOw, kFix, false>;
  if (smem > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(batch));
  kernel<<<grid, kThreads, static_cast<size_t>(smem), reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(g), static_cast<const H*>(S), static_cast<H*>(Y),
      static_cast<const T*>(coef), static_cast<const unsigned char*>(live),
      static_cast<T*>(r), static_cast<T*>(partials), n, ld, m, lo, hi, fix_end);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int lbfgs_combine_block_elems() { return kBlockElems; }

const char* lbfgs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#define LBFGS_COMBINE_ENTRY(SFX, T, H)                                                      \
  int lbfgs_combine_##SFX(const void* g, const void* S, void* Y, const void* coef, void* r, \
                          void* partials, long long n, long long ld, int m, void* stream) { \
    return launch_combine<T, H, false, false>(g, S, Y, coef, r, partials, n, ld, m, 0, 0,  \
                                              0, stream);                                  \
  }                                                                                         \
  int lbfgs_combine_fix_##SFX(const void* g, const void* S, void* Y, const void* coef,     \
                              void* r, void* partials, long long n, long long ld, int m,   \
                              int end, void* stream) {                                     \
    return launch_combine<T, H, false, true>(g, S, Y, coef, r, partials, n, ld, m, 0, 0,   \
                                             end, stream);                                 \
  }                                                                                         \
  int lbfgs_combine_ow_##SFX(const void* g, const void* S, void* Y, const void* coef,      \
                             void* r, void* partials, long long n, long long ld, int m,    \
                             long long lo, long long hi, void* stream) {                   \
    return launch_combine<T, H, true, false>(g, S, Y, coef, r, partials, n, ld, m, lo, hi, \
                                             0, stream);                                   \
  }                                                                                         \
  int lbfgs_combine_batched_##SFX(const void* g, const void* S, void* Y, const void* coef,   \
                                  const void* live, void* r, void* partials, long long n,  \
                                  long long ld, int m, int batch, void* stream) {          \
    return launch_combine_batched<T, H, false, false>(g, S, Y, coef, live, r, partials, n, \
                                                      ld, m, 0, 0, 0, batch, stream);      \
  }                                                                                         \
  int lbfgs_combine_fix_batched_##SFX(const void* g, const void* S, void* Y,               \
                                      const void* coef, const void* live, void* r,         \
                                      void* partials, long long n, long long ld, int m,    \
                                      int end, int batch, void* stream) {                  \
    return launch_combine_batched<T, H, false, true>(g, S, Y, coef, live, r, partials, n,  \
                                                     ld, m, 0, 0, end, batch, stream);     \
  }                                                                                         \
  int lbfgs_combine_ow_batched_##SFX(const void* g, const void* S, void* Y,                \
                                     const void* coef, const void* live, void* r,          \
                                     void* partials, long long n, long long ld, int m,     \
                                     long long lo, long long hi, int batch, void* stream) {\
    return launch_combine_batched<T, H, true, false>(g, S, Y, coef, live, r, partials, n,  \
                                                     ld, m, lo, hi, 0, batch, stream);     \
  }

LBFGS_COMBINE_ENTRY(f32_bf16, float, __nv_bfloat16)
LBFGS_COMBINE_ENTRY(f32_f32, float, float)
LBFGS_COMBINE_ENTRY(f64_f64, double, double)

#undef LBFGS_COMBINE_ENTRY

}  // extern "C"
