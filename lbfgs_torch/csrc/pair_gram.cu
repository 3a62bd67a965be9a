// K5 and K12: the correction pair and its Gram products, by hand for
// Hopper (sm_90a).
//
// K5 replaces lbfgs_tpu/ops/fused.py:_pair_gram_kernel (launched by
// _pair_gram_single).  It runs when the objective has a fused trial but no
// one-pass epilogue.  For every element i, with the new pair
//
//     s_i = stp * d_i      (exact on the projection-free path)
//     y_i = gx_i - gp_i    and the two-loop's steepest direction d0_i = -gx_i
//
// it writes s and y into ring row `end` of S and Y (in place, rounded to
// the history type with round-to-nearest-even; the other rows are only
// read) and accumulates, for every ring row j, the six products
//
//     S_j.y, S_j.s, S_j.d0, Y_j.y, Y_j.s, Y_j.d0
//
// where row `end` is the new pair UNROUNDED, as it is held in registers.
// With kGp it also accumulates S_j.gp and Y_j.gp, the damped update's
// basis column; those go to a partials array of their own, so the six
// base columns are the same values, bit for bit, with or without it.
// Nothing here decides "x not changed": the trial's changed count does.
//
// K12 (kXg) replaces lbfgs_tpu/ops/fused.py:_pair_gram_xg_kernel
// (pair_gram_update_xg_pallas), OWL-QN's composed branch for generic
// objectives: the step is orthant-projected, so the pair is
//
//     s_i = x_i - xp_i     y_i = gx_i - gp_i     d0_i = -pg_i
//
// and everything else is K5's body.  As in the TPU kernel the products of
// row `end` use the unrounded pair (lbfgs_tpu/ops/fused.py:1081-1082).
//
// What bounds them on the H100: bytes.  K5 reads d, gx, gp and the m-1 old
// rows of each ring and writes one row of each: with f32 vectors, a bf16
// history and m = 6 that is 12 + 20 + 4 = 36 bytes per element (K12 reads
// five vectors: 48 bytes), against 6m (8m) multiply-adds.  So each thread
// keeps its elements' s, y, d0 and gp in registers and streams the ring
// rows past them once, coalesced (thread t of a block touches element
// base + k*256 + t of each row).  The cross-block sums use no atomics:
// each block writes its partials, one block reduction per ring row, and
// the caller adds the [blocks, 6m] (and [blocks, 2m]) partials in a fixed
// order, so runs repeat bit for bit.  Vectorised loads and fewer block
// reductions are left for later tuning.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;
constexpr int kBlockElems = kThreads * kPerThread;

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

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  // fixed shuffle tree: the same inputs always add in the same order
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Adds acc[0..K) over the block in a fixed order and stores the K sums at
// out (thread 0).  Ends with a barrier, so red may be reused at once.
template <typename T, int K>
__device__ __forceinline__ void block_sums(const T (&acc)[K], T (*red)[kWarps], T* out) {
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int p = 0; p < K; ++p) {
    const T v = warp_sum(acc[p]);
    if ((threadIdx.x & 31) == 0) red[p][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int p = 0; p < K; ++p) {
      T a = T(0);
      for (int w = 0; w < kWarps; ++w) a += red[p][w];
      out[p] = a;
    }
  }
  __syncthreads();
}

// partials = [gridDim.x, 6m]: per ring row j, (S_j.y, S_j.s, S_j.d0,
// Y_j.y, Y_j.s, Y_j.d0); gpartials = [gridDim.x, 2m]: (S_j.gp, Y_j.gp).
// K5: a = d (b and pg unused); K12 (kXg): a = x, b = xp (stp unused)
template <typename T, typename H, bool kGp, bool kXg>
__global__ void __launch_bounds__(kThreads)
pair_gram_kernel(T stp, const T* __restrict__ a, const T* __restrict__ b,
                 const T* __restrict__ gx, const T* __restrict__ gp,
                 const T* __restrict__ pg, H* __restrict__ S, H* __restrict__ Y,
                 T* __restrict__ partials, T* __restrict__ gpartials, long long n, int m,
                 int end) {
  __shared__ T red[6][kWarps];
  const long long base = static_cast<long long>(blockIdx.x) * kBlockElems;
  T s[kPerThread], y[kPerThread], d0[kPerThread], g0[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = base + k * kThreads + threadIdx.x;
    if (i < n) {
      if constexpr (kXg) {
        s[k] = a[i] - b[i];
        d0[k] = -pg[i];
      } else {
        s[k] = stp * a[i];
        d0[k] = -gx[i];
      }
      const T gpv = gp[i];
      y[k] = gx[i] - gpv;
      g0[k] = gpv;
      // the new pair into ring row `end`, rounded to the history type
      S[end * n + i] = narrow<H, T>(s[k]);
      Y[end * n + i] = narrow<H, T>(y[k]);
    } else {
      s[k] = y[k] = d0[k] = g0[k] = T(0);
    }
  }
  for (int j = 0; j < m; ++j) {
    T acc[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
    T gacc[2] = {T(0), T(0)};
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const long long i = base + k * kThreads + threadIdx.x;
      if (i < n) {
        // row `end` is never read: its products use the unrounded pair
        const T sj = j == end ? s[k] : widen<T, H>(S[j * n + i]);
        const T yj = j == end ? y[k] : widen<T, H>(Y[j * n + i]);
        acc[0] += sj * y[k];
        acc[1] += sj * s[k];
        acc[2] += sj * d0[k];
        acc[3] += yj * y[k];
        acc[4] += yj * s[k];
        acc[5] += yj * d0[k];
        if constexpr (kGp) {
          gacc[0] += sj * g0[k];
          gacc[1] += yj * g0[k];
        }
      }
    }
    block_sums<T, 6>(acc, red, partials + (6LL * m) * blockIdx.x + 6 * j);
    if constexpr (kGp) {
      block_sums<T, 2>(gacc, red, gpartials + (2LL * m) * blockIdx.x + 2 * j);
    }
  }
}

template <typename T, typename H, bool kGp, bool kXg>
int launch_pair_gram(double stp, const void* a, const void* b, const void* gx, const void* gp,
                     const void* pg, void* S, void* Y, void* partials, void* gpartials,
                     long long n, int m, int end, void* stream) {
  if (n <= 0 || m < 1 || end < 0 || end >= m) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kBlockElems - 1) / kBlockElems;
  pair_gram_kernel<T, H, kGp, kXg><<<static_cast<unsigned>(blocks), kThreads, 0,
                                     reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<T>(stp), static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(gx), static_cast<const T*>(gp), static_cast<const T*>(pg),
      static_cast<H*>(S), static_cast<H*>(Y), static_cast<T*>(partials),
      static_cast<T*>(gpartials), n, m, end);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename H>
int pair_gram(double stp, const void* d, const void* gx, const void* gp, void* S, void* Y,
              void* partials, void* gpartials, long long n, int m, int end, int with_gp,
              void* stream) {
  if (with_gp) {
    return launch_pair_gram<T, H, true, false>(stp, d, nullptr, gx, gp, nullptr, S, Y,
                                               partials, gpartials, n, m, end, stream);
  }
  return launch_pair_gram<T, H, false, false>(stp, d, nullptr, gx, gp, nullptr, S, Y,
                                              partials, gpartials, n, m, end, stream);
}

}  // namespace

extern "C" {

int lbfgs_pair_gram_block_elems() { return kBlockElems; }

// stp arrives as a double and is rounded to the vectors' type (exact for a
// step that is already of that type)
#define LBFGS_PAIR_GRAM_ENTRY(SFX, T, H)                                                  \
  int lbfgs_pair_gram_##SFX(double stp, const void* d, const void* gx, const void* gp,    \
                            void* S, void* Y, void* partials, void* gpartials,           \
                            long long n, int m, int end, int with_gp, void* stream) {     \
    return pair_gram<T, H>(stp, d, gx, gp, S, Y, partials, gpartials, n, m, end, with_gp, \
                           stream);                                                      \
  }

LBFGS_PAIR_GRAM_ENTRY(f32_bf16, float, __nv_bfloat16)
LBFGS_PAIR_GRAM_ENTRY(f32_f32, float, float)
LBFGS_PAIR_GRAM_ENTRY(f64_f64, double, double)

#undef LBFGS_PAIR_GRAM_ENTRY

#define LBFGS_PAIR_GRAM_XG_ENTRY(SFX, T, H)                                               \
  int lbfgs_pair_gram_xg_##SFX(const void* x, const void* xp, const void* gx,            \
                               const void* gp, const void* pg, void* S, void* Y,         \
                               void* partials, long long n, int m, int end,              \
                               void* stream) {                                           \
    return launch_pair_gram<T, H, false, true>(0.0, x, xp, gx, gp, pg, S, Y, partials,   \
                                               nullptr, n, m, end, stream);              \
  }

LBFGS_PAIR_GRAM_XG_ENTRY(f32_bf16, float, __nv_bfloat16)
LBFGS_PAIR_GRAM_XG_ENTRY(f32_f32, float, float)
LBFGS_PAIR_GRAM_XG_ENTRY(f64_f64, double, double)

#undef LBFGS_PAIR_GRAM_XG_ENTRY

}  // extern "C"
