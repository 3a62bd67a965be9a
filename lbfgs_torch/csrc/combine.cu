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
constexpr int kMaxM = 64;

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
template <typename T, typename H, bool kOw, bool kFix>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const T* __restrict__ g, const H* __restrict__ S, H* __restrict__ Y,
               const T* __restrict__ coef, T* __restrict__ r, T* __restrict__ partials,
               long long n, int m, long long lo, long long hi, int fix_end) {
  constexpr int kParts = kOw ? 3 : 2;
  __shared__ T c[3 + 2 * kMaxM];
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
        acc_s = add_rn(acc_s, mul_rn(c[1 + j], widen<T, H>(S[j * n + i])));
        const T yj = widen<T, H>(Y[j * n + i]);
        acc_y = add_rn(acc_y, mul_rn(c[1 + m + j], yj));
        if constexpr (kFix) {
          if (j == fix_end) y_end = yj;
        }
      }
      const T rv = add_rn(mul_rn(c[0], gv), add_rn(acc_s, acc_y));
      if constexpr (kFix) {
        Y[fix_end * n + i] = narrow<H, T>(blend_rn(c[1 + 2 * m], y_end, c[2 + 2 * m], gv));
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
                   void* partials, long long n, int m, long long lo, long long hi,
                   int fix_end, void* stream) {
  if (n <= 0 || m < 1 || m > kMaxM) return static_cast<int>(cudaErrorInvalidValue);
  if (kFix && (fix_end < 0 || fix_end >= m)) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kBlockElems - 1) / kBlockElems;
  combine_kernel<T, H, kOw, kFix><<<static_cast<unsigned>(blocks), kThreads, 0,
                                    reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(g), static_cast<const H*>(S), static_cast<H*>(Y),
      static_cast<const T*>(coef), static_cast<T*>(r), static_cast<T*>(partials), n, m,
      lo, hi, fix_end);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int lbfgs_combine_block_elems() { return kBlockElems; }

int lbfgs_combine_max_m() { return kMaxM; }

const char* lbfgs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#define LBFGS_COMBINE_ENTRY(SFX, T, H)                                                      \
  int lbfgs_combine_##SFX(const void* g, const void* S, void* Y, const void* coef, void* r, \
                          void* partials, long long n, int m, void* stream) {              \
    return launch_combine<T, H, false, false>(g, S, Y, coef, r, partials, n, m, 0, 0, 0,   \
                                              stream);                                     \
  }                                                                                         \
  int lbfgs_combine_fix_##SFX(const void* g, const void* S, void* Y, const void* coef,     \
                              void* r, void* partials, long long n, int m, int end,        \
                              void* stream) {                                              \
    return launch_combine<T, H, false, true>(g, S, Y, coef, r, partials, n, m, 0, 0, end,  \
                                             stream);                                      \
  }                                                                                         \
  int lbfgs_combine_ow_##SFX(const void* g, const void* S, void* Y, const void* coef,      \
                             void* r, void* partials, long long n, int m, long long lo,    \
                             long long hi, void* stream) {                                 \
    return launch_combine<T, H, true, false>(g, S, Y, coef, r, partials, n, m, lo, hi, 0,  \
                                             stream);                                      \
  }

LBFGS_COMBINE_ENTRY(f32_bf16, float, __nv_bfloat16)
LBFGS_COMBINE_ENTRY(f32_f32, float, float)
LBFGS_COMBINE_ENTRY(f64_f64, double, double)

#undef LBFGS_COMBINE_ENTRY

}  // extern "C"
