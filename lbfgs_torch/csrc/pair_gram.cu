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
// K12 replaces lbfgs_tpu/ops/fused.py:_pair_gram_xg_kernel
// (pair_gram_update_xg_pallas), OWL-QN's composed branch for generic
// objectives: the step is orthant-projected, so the pair is
//
//     s_i = x_i - xp_i     y_i = gx_i - gp_i     d0_i = -pg_i
//
// and the products are K5's.  As in the TPU kernel the products of row
// `end` use the unrounded pair (lbfgs_tpu/ops/fused.py:1081-1082).
//
// What bounds them on the H100: bytes.  K5 reads d, gx, gp and the m-1 old
// rows of each ring and writes one row of each: with f32 vectors, a bf16
// history and m = 6 that is 12 + 20 + 4 = 36 bytes per element (K12 reads
// five vectors: 48 bytes), against 6m (8m) multiply-adds.
//
// K5's design: few cross-thread reductions, wide loads in flight
// together.  A tile holds kThreads * V elements, V = 16 bytes of the
// vectors' type (4 floats, 2 doubles), and thread t holds elements
// [t*V, t*V + V) of each tile: one 16-byte load of each vector, one
// V-element load of each ring row (8 bytes for bf16), neighbouring threads
// on neighbouring addresses, every load of a tile issued before its first
// product.  (The ragged tail, and every tile where n is not a multiple of
// V or an array is not so aligned, take one load per element.)  Each
// block loops over a contiguous run of `tiles` tiles; a thread keeps one
// sum per (ring row, product) in registers across them, adding each
// tile's products folded over its V elements.  The cross-thread
// reductions (warp shuffles, then one pass over shared memory) run once
// per sum per block, after its last tile, and each block writes its
// [6m] ([2m]) partials; the caller adds the [blocks, 6m] ([blocks, 2m])
// arrays in a fixed order, so runs repeat bit for bit (no atomics).  The
// ring rows go in groups of kGroup: block (b, g) takes rows [g*kGroup,
// g*kGroup + kGroup), so that a group's sums fit the registers.  A
// history deeper than one group reads the vectors once per group: 3v more
// bytes per element for each group after the first (v the vectors' bytes;
// f32 vectors, bf16 history, m = 12: 72 bytes per element against the 60
// of one pass).  The main path's m = 6 and the north star's m = 3 take one
// group.
//
// K12 keeps the first design (one 1024-element tile per block and one
// block reduction per ring row), its sums bit for bit what they were.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;
constexpr int kBlockElems = kThreads * kPerThread;
// the deepest history K5 takes (fused.MAX_M)
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

// ---------------------------------------------------------------------------
// K12: one tile per block
// ---------------------------------------------------------------------------

// partials = [gridDim.x, 6m]: per ring row j, (S_j.y, S_j.s, S_j.d0,
// Y_j.y, Y_j.s, Y_j.d0)
template <typename T, typename H>
__global__ void __launch_bounds__(kThreads)
pair_gram_xg_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    const T* __restrict__ gx, const T* __restrict__ gp,
                    const T* __restrict__ pg, H* __restrict__ S, H* __restrict__ Y,
                    T* __restrict__ partials, long long n, int m, int end) {
  __shared__ T red[6][kWarps];
  const long long base = static_cast<long long>(blockIdx.x) * kBlockElems;
  T s[kPerThread], y[kPerThread], d0[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = base + k * kThreads + threadIdx.x;
    if (i < n) {
      s[k] = a[i] - b[i];
      d0[k] = -pg[i];
      const T gpv = gp[i];
      y[k] = gx[i] - gpv;
      // the new pair into ring row `end`, rounded to the history type
      S[end * n + i] = narrow<H, T>(s[k]);
      Y[end * n + i] = narrow<H, T>(y[k]);
    } else {
      s[k] = y[k] = d0[k] = T(0);
    }
  }
  for (int j = 0; j < m; ++j) {
    T acc[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
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
      }
    }
    block_sums<T, 6>(acc, red, partials + (6LL * m) * blockIdx.x + 6 * j);
  }
}

// ---------------------------------------------------------------------------
// K5: blocks that loop over tiles, sums in registers
// ---------------------------------------------------------------------------

// elements a thread holds per tile: 16 bytes of the vectors' type
template <typename T>
constexpr int kV = 16 / static_cast<int>(sizeof(T));
// ring rows per group: the sums of 8 rows (48, or 64 with . gp) fit a
// thread's registers beside its tile in either type
constexpr int kGroup = 8;
// blocks of kThreads each SM must hold (__launch_bounds__): 2 keeps a
// bf16 form of up to 6 rows within 128 registers without a spill, with
// two blocks in flight on each SM (on an H100 80GB HBM3 that ran the
// . gp form at m = 6 15% faster than one; left to itself ptxas also fit
// the 3-column form into 80 registers and spilled).  At 8 rows, or with
// a 4- or 8-byte history, the loaded rows and the sums need more than 128.
template <typename H, int MP>
constexpr int kMinBlocks = sizeof(H) == 2 && MP <= 6 ? 2 : 1;

// Every operation of K5's sums rounds explicitly, so nvcc cannot contract
// the two instantiations' products differently.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// the unsigned type one load of B bytes moves
template <int B> struct Raw;
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

// V consecutive elements p[i .. i+V) widened to T: one load of V*sizeof(E)
// bytes where `vec` (the run aligned and inside n), else one load per
// element, 0 past n.
template <typename T, typename E, int V>
__device__ __forceinline__ void load_run(const E* p, long long i, long long n, bool vec,
                                         T (&out)[V]) {
  if (vec) {
    using R = typename Raw<V * static_cast<int>(sizeof(E))>::type;
    const R raw = *reinterpret_cast<const R*>(p + i);
    E e[V];
    memcpy(e, &raw, sizeof(R));
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = widen<T, E>(e[v]);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = i + v < n ? widen<T, E>(p[i + v]) : T(0);
  }
}

// The run r rounded to H into p[i .. i+V): one store where `vec`, else
// one per element inside n.
template <typename H, typename T, int V>
__device__ __forceinline__ void store_run(H* p, long long i, long long n, bool vec,
                                          const T (&r)[V]) {
  H e[V];
#pragma unroll
  for (int v = 0; v < V; ++v) e[v] = narrow<H, T>(r[v]);
  if (vec) {
    using R = typename Raw<V * static_cast<int>(sizeof(H))>::type;
    R raw;
    memcpy(&raw, e, sizeof(R));
    *reinterpret_cast<R*>(p + i) = raw;
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (i + v < n) p[i + v] = e[v];
  }
}

// a . b over a thread's run, in a fixed order
template <typename T, int V>
__device__ __forceinline__ T fold(const T (&a)[V], const T (&b)[V]) {
  T p = mul_rn(a[0], b[0]);
#pragma unroll
  for (int v = 1; v < V; ++v) p = fma_rn(a[v], b[v], p);
  return p;
}

// One ring row's six base products over the thread's run, each added into
// its sum.  Both K5 launches inline this one function, so the 3-column
// launch and the . gp launch add the same values in the same order.
template <typename T, int V>
__device__ __forceinline__ void base_products(const T (&sj)[V], const T (&yj)[V],
                                              const T (&s)[V], const T (&y)[V],
                                              const T (&d0)[V], T (&acc)[6]) {
  acc[0] = add_rn(acc[0], fold(sj, y));
  acc[1] = add_rn(acc[1], fold(sj, s));
  acc[2] = add_rn(acc[2], fold(sj, d0));
  acc[3] = add_rn(acc[3], fold(yj, y));
  acc[4] = add_rn(acc[4], fold(yj, s));
  acc[5] = add_rn(acc[5], fold(yj, d0));
}

// One tile's work for the thread's run p[i .. i+V): the loads, the pair,
// every ring row's products added into the sums, the pair stored into row
// `end` (where `writes`).  kVec: the run is whole and every array aligned
// for one load per run (the main path): all the rows' loads are issued
// before any product, so a tile's loads are in flight together.
// Otherwise one load per element, 0 past n.
template <bool kVec, typename T, typename H, int MP, bool kGp>
__device__ __forceinline__ void pair_gram_tile(T stp, const T* __restrict__ d,
                                               const T* __restrict__ gx,
                                               const T* __restrict__ gp, H* __restrict__ S,
                                               H* __restrict__ Y, long long i, long long n,
                                               int m, int j0, int end, bool writes,
                                               T (&acc)[MP][6], T (&gacc)[MP][2]) {
  constexpr int V = kV<T>;
  using RawH = typename Raw<V * static_cast<int>(sizeof(H))>::type;
  T dv[V], gxv[V], gpv[V], s[V], y[V], d0[V];
  load_run(d, i, n, kVec, dv);
  load_run(gx, i, n, kVec, gxv);
  load_run(gp, i, n, kVec, gpv);
  RawH sraw[MP], yraw[MP];
  if constexpr (kVec) {
#pragma unroll
    for (int r = 0; r < MP; ++r) {
      const int j = j0 + r;
      // row `end` is never read: its products use the unrounded pair
      if (j < m && j != end) {
        const long long off = static_cast<long long>(j) * n + i;
        sraw[r] = *reinterpret_cast<const RawH*>(S + off);
        yraw[r] = *reinterpret_cast<const RawH*>(Y + off);
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    s[v] = mul_rn(stp, dv[v]);
    y[v] = sub_rn(gxv[v], gpv[v]);
    d0[v] = -gxv[v];
  }
#pragma unroll
  for (int r = 0; r < MP; ++r) {
    const int j = j0 + r;
    if (j < m) {
      T sj[V], yj[V];
      if (j == end) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          sj[v] = s[v];
          yj[v] = y[v];
        }
      } else if constexpr (kVec) {
        H se[V], ye[V];
        memcpy(se, &sraw[r], sizeof(RawH));
        memcpy(ye, &yraw[r], sizeof(RawH));
#pragma unroll
        for (int v = 0; v < V; ++v) {
          sj[v] = widen<T, H>(se[v]);
          yj[v] = widen<T, H>(ye[v]);
        }
      } else {
        const long long off = static_cast<long long>(j) * n;
        load_run(S + off, i, n, false, sj);
        load_run(Y + off, i, n, false, yj);
      }
      base_products(sj, yj, s, y, d0, acc[r]);
      if constexpr (kGp) {
        gacc[r][0] = add_rn(gacc[r][0], fold(sj, gpv));
        gacc[r][1] = add_rn(gacc[r][1], fold(yj, gpv));
      }
    }
  }
  if (writes) {
    // the new pair into ring row `end`, rounded to the history type,
    // after the tile's reads
    const long long off = static_cast<long long>(end) * n;
    store_run(S + off, i, n, kVec, s);
    store_run(Y + off, i, n, kVec, y);
  }
}

// grid (blocks, groups).  Block (b, g) loops over tiles [b*tiles,
// min((b+1)*tiles, ntiles)) and ring rows [g*kGroup, g*kGroup + MP) inside
// m (MP: pair_gram_sd_rows).  partials = [blocks, 6m]: per ring row j,
// (S_j.y, S_j.s, S_j.d0, Y_j.y, Y_j.s, Y_j.d0); gpartials = [blocks, 2m]:
// (S_j.gp, Y_j.gp).  vec: every array starts on a 16-byte (vectors) or
// V-element (rings) boundary and n is a multiple of V, so every whole run
// takes one load per array.
template <typename T, typename H, int MP, bool kGp>
__global__ void __launch_bounds__(kThreads, kMinBlocks<H, MP>)
pair_gram_sd_kernel(T stp, const T* __restrict__ d, const T* __restrict__ gx,
                    const T* __restrict__ gp, H* __restrict__ S, H* __restrict__ Y,
                    T* __restrict__ partials, T* __restrict__ gpartials, long long n, int m,
                    int end, long long tiles, bool vec) {
  constexpr int V = kV<T>;
  constexpr long long kTile = static_cast<long long>(kThreads) * V;
  constexpr int kSums = (kGp ? 8 : 6) * MP;
  __shared__ T red[kSums][kWarps];
  const int j0 = blockIdx.y * kGroup;
  // the group that holds row `end` stores the pair
  const bool writes = end >= j0 && end < j0 + MP;
  const long long ntiles = (n + kTile - 1) / kTile;
  const long long t0 = static_cast<long long>(blockIdx.x) * tiles;
  const long long t1 = t0 + tiles < ntiles ? t0 + tiles : ntiles;
  T acc[MP][6], gacc[MP][2];
#pragma unroll
  for (int r = 0; r < MP; ++r) {
#pragma unroll
    for (int k = 0; k < 6; ++k) acc[r][k] = T(0);
    gacc[r][0] = gacc[r][1] = T(0);
  }
  for (long long t = t0; t < t1; ++t) {
    const long long i = t * kTile + static_cast<long long>(threadIdx.x) * V;
    if (i >= n) break;  // past the ragged end of the last tile
    if (vec && i + V <= n) {
      pair_gram_tile<true, T, H, MP, kGp>(stp, d, gx, gp, S, Y, i, n, m, j0, end, writes, acc,
                                          gacc);
    } else {
      pair_gram_tile<false, T, H, MP, kGp>(stp, d, gx, gp, S, Y, i, n, m, j0, end, writes, acc,
                                           gacc);
    }
  }
  // one reduction per sum per block: warp shuffles, then one pass over
  // shared memory, each sum added over the warps in a fixed order
  const int warp = threadIdx.x / 32;
  const bool lane0 = (threadIdx.x & 31) == 0;
#pragma unroll
  for (int r = 0; r < MP; ++r) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const T v = warp_sum(acc[r][k]);
      if (lane0) red[6 * r + k][warp] = v;
    }
    if constexpr (kGp) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const T v = warp_sum(gacc[r][k]);
        if (lane0) red[6 * MP + 2 * r + k][warp] = v;
      }
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < kSums; p += kThreads) {
    T a = red[p][0];
    for (int w = 1; w < kWarps; ++w) a = add_rn(a, red[p][w]);
    if (p < 6 * MP) {
      const int j = j0 + p / 6;
      if (j < m) partials[6LL * m * blockIdx.x + 6 * j + p % 6] = a;
    } else {
      const int q = p - 6 * MP;
      const int j = j0 + q / 2;
      if (j < m) gpartials[2LL * m * blockIdx.x + 2 * j + q % 2] = a;
    }
  }
}

template <typename T, typename H, int MP, bool kGp>
int launch_pair_gram_sd(T stp, const T* d, const T* gx, const T* gp, H* S, H* Y, T* partials,
                        T* gpartials, long long n, int m, int end, long long tiles,
                        long long blocks, bool vec, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>((m + kGroup - 1) / kGroup));
  pair_gram_sd_kernel<T, H, MP, kGp><<<grid, kThreads, 0, stream>>>(
      stp, d, gx, gp, S, Y, partials, gpartials, n, m, end, tiles, vec);
  return static_cast<int>(cudaGetLastError());
}

// MP, the ring rows a block holds: m itself at the depths users run
// (1-4 and 6: the north star's 3, the main path's 6), 6 for m = 5, and
// groups of kGroup rows beyond 6.  A padded row costs registers: its sums
// and its loaded rows are live through the whole loop.
template <typename T, typename H, bool kGp>
int pair_gram_sd_rows(T stp, const T* d, const T* gx, const T* gp, H* S, H* Y, T* partials,
                      T* gpartials, long long n, int m, int end, long long tiles,
                      long long blocks, bool vec, cudaStream_t stream) {
  const auto launch = [&](auto rows) {
    return launch_pair_gram_sd<T, H, decltype(rows)::value, kGp>(
        stp, d, gx, gp, S, Y, partials, gpartials, n, m, end, tiles, blocks, vec, stream);
  };
  switch (m > 6 ? kGroup : m == 5 ? 6 : m) {
    case 1: return launch(std::integral_constant<int, 1>());
    case 2: return launch(std::integral_constant<int, 2>());
    case 3: return launch(std::integral_constant<int, 3>());
    case 4: return launch(std::integral_constant<int, 4>());
    case 6: return launch(std::integral_constant<int, 6>());
    default: return launch(std::integral_constant<int, kGroup>());
  }
}

bool aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<unsigned long long>(p) % bytes == 0;
}

// tile, tiles and blocks are the wrapper's launch (fused.pair_gram_grid):
// refused unless the tile is this instantiation's and the blocks' runs of
// `tiles` tiles cover n exactly once
template <typename T, typename H>
int pair_gram_sd(double stp, const void* d, const void* gx, const void* gp, void* S, void* Y,
                 void* partials, void* gpartials, long long n, int m, int end, int with_gp,
                 long long tile, long long tiles, long long blocks, void* stream) {
  constexpr long long kTile = static_cast<long long>(kThreads) * kV<T>;
  if (n <= 0 || m < 1 || m > kMaxM || end < 0 || end >= m || tile != kTile || tiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long ntiles = (n + kTile - 1) / kTile;
  if (blocks != (ntiles + tiles - 1) / tiles || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = aligned(d, 16) && aligned(gx, 16) && aligned(gp, 16) &&
                   aligned(S, kV<T> * sizeof(H)) && aligned(Y, kV<T> * sizeof(H)) &&
                   n % kV<T> == 0;
  const auto run = with_gp ? pair_gram_sd_rows<T, H, true> : pair_gram_sd_rows<T, H, false>;
  return run(static_cast<T>(stp), static_cast<const T*>(d), static_cast<const T*>(gx),
             static_cast<const T*>(gp), static_cast<H*>(S), static_cast<H*>(Y),
             static_cast<T*>(partials), static_cast<T*>(gpartials), n, m, end, tiles, blocks,
             vec, reinterpret_cast<cudaStream_t>(stream));
}

template <typename T, typename H>
int pair_gram_xg(const void* x, const void* xp, const void* gx, const void* gp, const void* pg,
                 void* S, void* Y, void* partials, long long n, int m, int end, void* stream) {
  if (n <= 0 || m < 1 || end < 0 || end >= m) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kBlockElems - 1) / kBlockElems;
  pair_gram_xg_kernel<T, H><<<static_cast<unsigned>(blocks), kThreads, 0,
                              reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(xp), static_cast<const T*>(gx),
      static_cast<const T*>(gp), static_cast<const T*>(pg), static_cast<H*>(S),
      static_cast<H*>(Y), static_cast<T*>(partials), n, m, end);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K12's block: kThreads * kPerThread elements
int lbfgs_pair_gram_block_elems() { return kBlockElems; }

// stp arrives as a double and is rounded to the vectors' type (exact for a
// step that is already of that type)
#define LBFGS_PAIR_GRAM_ENTRY(SFX, T, H)                                                    \
  int lbfgs_pair_gram_##SFX(double stp, const void* d, const void* gx, const void* gp,      \
                            void* S, void* Y, void* partials, void* gpartials,             \
                            long long n, int m, int end, int with_gp, long long tile,      \
                            long long tiles, long long blocks, void* stream) {             \
    return pair_gram_sd<T, H>(stp, d, gx, gp, S, Y, partials, gpartials, n, m, end,         \
                              with_gp, tile, tiles, blocks, stream);                       \
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
    return pair_gram_xg<T, H>(x, xp, gx, gp, pg, S, Y, partials, n, m, end, stream);     \
  }

LBFGS_PAIR_GRAM_XG_ENTRY(f32_bf16, float, __nv_bfloat16)
LBFGS_PAIR_GRAM_XG_ENTRY(f32_f32, float, float)
LBFGS_PAIR_GRAM_XG_ENTRY(f64_f64, double, double)

#undef LBFGS_PAIR_GRAM_XG_ENTRY

}  // extern "C"
