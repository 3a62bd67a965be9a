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
// `end` use the unrounded pair (lbfgs_tpu/ops/fused.py:1081-1082).  With
// kGp (damped OWL-QN where the one-pass epilogue K14 does not run: a ring
// deeper than the Triton kernels take) it also accumulates S_j.gp, Y_j.gp
// and the two scalars gp.gp, gp.pg that K14's . gp form returns, into a
// partials array of their own: the six base products are the same code
// as without it.
//
// K12 b (kBatched) replaces _pair_gram_xg_kernel under the batched
// runner's vmap (lbfgs_tpu/batched.py:28-70: OWL-QN's undamped pair
// update for generic objectives, lbfgs_tpu/solver.py:661-692): K12 over
// [B, n] instances with [B, m, n] rings, the instance the grid's third
// index.  Each instance's blocks are laid out as the solo launch lays out
// the same n, and write its own [blocks, 6m] partials, so its ring row and
// partials are solo K12's bit for bit.  The ring row `end` is the one the
// lockstep batch shares.  A block whose instance is frozen (live[b] == 0)
// returns before it loads or stores anything.  It has no . gp form: the
// damped generic branch composes its pair in torch, as the JAX package's
// does.
//
// K5 b (kBatched, not kXg) replaces _pair_gram_kernel under the same vmap
// (the pair + Gram pass of an objective with a fused trial but no one-pass
// epilogue, lbfgs_tpu/solver.py:640-674): K5 over [B, n] instances, each
// with its own step (stps[b]), laid out and masked as K12 b, with and
// without the . gp column (kGp, its [blocks, 2m] partials per instance
// beside the [blocks, 6m] ones).  An instance's ring row and partials
// are solo K5's bit for bit, and its . gp launch's six base columns the
// 3-column launch's.
//
// What bounds them on the H100: bytes.  K5 reads d, gx, gp and the m-1 old
// rows of each ring and writes one row of each: with f32 vectors, a bf16
// history and m = 6 that is 12 + 20 + 4 = 36 bytes per element (K12 reads
// five vectors: 20 + 20 + 4 = 44 bytes), against 6m (8m) multiply-adds.
//
// One design, one body (pair_gram_kernel): few cross-thread reductions,
// wide loads in flight together.  The two kernels differ only in how the
// pair is formed (PairIn: K5 from stp, d, gx, gp; K12, kXg, from x, xp,
// gx, gp, pg).  A tile holds kThreads * V elements, V = 16 bytes of the
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
// [6m] ([2m], K12's [2 + 2m]) partials; the caller adds the [blocks, 6m]
// arrays in a fixed order, so runs repeat bit for bit (no atomics).  The
// ring rows go in groups of kGroup: block (g, b) takes rows [g*kGroup,
// g*kGroup + kGroup) of run b, so that a group's sums fit the registers.
// A history deeper than one group reads the vectors once per group: 3v
// (K12: 5v) more bytes per element for each group after the first, v the
// vectors' bytes.  The group is the grid's fastest index, so the groups
// of one run are launched side by side and the later ones find the run's
// vectors in the L2.  The main path's m = 6 and the north star's m = 3
// take one group; any depth takes ceil(m / kGroup) groups.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// most runs of tiles on the grid's y axis
constexpr long long kMaxBlocks = 65535;

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

// elements a thread holds per tile: 16 bytes of the vectors' type
template <typename T>
constexpr int kV = 16 / static_cast<int>(sizeof(T));
// ring rows per group: a bf16 form's sums of 6 rows (36, or 48 with
// . gp) and its loads fit 128 registers, so two blocks stay in flight on
// each SM at every depth (on an H100 80GB HBM3 groups of 8, which need
// 148-166 registers and so hold one block per SM, ran the . gp forms of
// K5 and K12 at m = 80 28-31% slower: PERF.md, section 6)
constexpr int kGroup = 6;
// blocks of kThreads each SM must hold (__launch_bounds__): 2 keeps a
// bf16 form within 128 registers without a spill, with two blocks in
// flight on each SM (on an H100 80GB HBM3 that ran K5's . gp form at
// m = 6 15% faster than one; left to itself ptxas also fit the 3-column
// form into 80 registers and spilled).  With a 4- or 8-byte history the
// loaded rows and the sums need more than 128.
template <typename H>
constexpr int kMinBlocks = sizeof(H) == 2 ? 2 : 1;

// Every operation of the sums rounds explicitly, so nvcc cannot contract
// the instantiations' products differently.
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
// its sum.  Every launch inlines this one function, so the 3-column launch
// and the . gp launch add the same values in the same order.
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

// The vectors a launch forms its pair from.  K5: s = stp*a (a = d),
// y = gx - gp, d0 = -gx.  K12 (kXg): s = a - b (a = x, b = xp), y = gx - gp,
// d0 = -pg.  K5 b takes each instance's step from stps.  The pointers a
// launch does not read are null.
template <typename T>
struct PairIn {
  T stp;
  const T* a;
  const T* b;
  const T* gx;
  const T* gp;
  const T* pg;
  const T* stps = nullptr;
};

// One tile's work for the thread's run p[i .. i+V): the loads, the pair,
// every ring row's products added into the sums, the pair stored into row
// `end` (where `writes`).  kVec: the run is whole and every array aligned
// for one load per run (the main path): all the rows' loads are issued
// before any product, so a tile's loads are in flight together.
// Otherwise one load per element, 0 past n.  K12's . gp form also adds
// gp.gp and gp.pg into gs where `scalars` (the blocks of the first group).
template <bool kVec, bool kXg, typename T, typename H, int MP, bool kGp>
__device__ __forceinline__ void pair_gram_tile(T stp, const T* __restrict__ a,
                                               const T* __restrict__ b,
                                               const T* __restrict__ gx,
                                               const T* __restrict__ gp,
                                               const T* __restrict__ pg, H* __restrict__ S,
                                               H* __restrict__ Y, long long i, long long n,
                                               long long ld, int m, int j0, int end, bool writes,
                                               bool scalars, T (&acc)[MP][6],
                                               T (&gacc)[MP][2], T (&gs)[2]) {
  constexpr int V = kV<T>;
  using RawH = typename Raw<V * static_cast<int>(sizeof(H))>::type;
  T av[V], bv[V], gxv[V], gpv[V], pgv[V], s[V], y[V], d0[V];
  load_run(a, i, n, kVec, av);
  if constexpr (kXg) load_run(b, i, n, kVec, bv);
  load_run(gx, i, n, kVec, gxv);
  load_run(gp, i, n, kVec, gpv);
  if constexpr (kXg) load_run(pg, i, n, kVec, pgv);
  RawH sraw[MP], yraw[MP];
  if constexpr (kVec) {
#pragma unroll
    for (int r = 0; r < MP; ++r) {
      const int j = j0 + r;
      // row `end` is never read: its products use the unrounded pair
      if (j < m && j != end) {
        const long long off = static_cast<long long>(j) * ld + i;
        sraw[r] = *reinterpret_cast<const RawH*>(S + off);
        yraw[r] = *reinterpret_cast<const RawH*>(Y + off);
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if constexpr (kXg) {
      s[v] = sub_rn(av[v], bv[v]);
      d0[v] = -pgv[v];
    } else {
      s[v] = mul_rn(stp, av[v]);
      d0[v] = -gxv[v];
    }
    y[v] = sub_rn(gxv[v], gpv[v]);
  }
  if constexpr (kXg && kGp) {
    if (scalars) {
      gs[0] = add_rn(gs[0], fold(gpv, gpv));
      gs[1] = add_rn(gs[1], fold(gpv, pgv));
    }
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
        const long long off = static_cast<long long>(j) * ld;
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
    const long long off = static_cast<long long>(end) * ld;
    store_run(S + off, i, n, kVec, s);
    store_run(Y + off, i, n, kVec, y);
  }
}

// grid (groups, blocks): the group is the fastest index, so the groups of
// one run of tiles launch side by side.  Block (g, b) loops over tiles
// [b*tiles, min((b+1)*tiles, ntiles)) and ring rows [g*kGroup, g*kGroup +
// MP) inside m (MP: pair_gram_rows).  partials = [blocks, 6m]: per ring
// row j, (S_j.y, S_j.s, S_j.d0, Y_j.y, Y_j.s, Y_j.d0); gpartials =
// [blocks, 2m]: (S_j.gp, Y_j.gp), after K12's gp.gp and gp.pg ([blocks,
// 2 + 2m]; only the first group's blocks add those).  Ring row j starts
// at element j*ld: ld is n, or n rounded up to a multiple of 16 (the
// package's padded ring; its pad columns are never read or written here).
// vec: every array starts on a 16-byte (vectors) or V-element (rings)
// boundary and n and ld are multiples of V, so every whole run takes one
// load per array.
//
// kBatched (K12 b, K5 b): the grid's third index is the instance; its
// vectors, rings and [blocks, 6m] (. gp: [blocks, 2m]) partials are at
// offsets of its index times n, m*ld and blocks*6m (blocks*2m), K5 b's step
// is stps[instance], and a frozen instance's blocks return at once.
template <typename T, typename H, int MP, bool kGp, bool kXg, bool kBatched>
__global__ void __launch_bounds__(kThreads, kMinBlocks<H>)
pair_gram_kernel(T stp, const T* __restrict__ a, const T* __restrict__ b,
                 const T* __restrict__ gx, const T* __restrict__ gp, const T* __restrict__ pg,
                 H* __restrict__ S, H* __restrict__ Y, T* __restrict__ partials,
                 T* __restrict__ gpartials, long long n, long long ld, int m, int end,
                 long long tiles, bool vec, const unsigned char* __restrict__ live,
                 const T* __restrict__ stps) {
  static_assert(!kBatched || !(kXg && kGp), "K12 b has no . gp column");
  constexpr int kScalars = kXg && kGp ? 2 : 0;
  if constexpr (kBatched) {
    const long long inst = blockIdx.z;
    if (!live[inst]) return;
    const long long off = inst * n;
    if constexpr (kXg) {
      b += off;
      pg += off;
    } else {
      stp = stps[inst];
    }
    a += off;
    gx += off;
    gp += off;
    S += inst * m * ld;
    Y += inst * m * ld;
    partials += inst * gridDim.y * 6LL * m;
    if constexpr (kGp) gpartials += inst * gridDim.y * (2LL * m + kScalars);
  }
  constexpr int V = kV<T>;
  constexpr long long kTile = static_cast<long long>(kThreads) * V;
  constexpr int kSums = (kGp ? 8 : 6) * MP + kScalars;
  __shared__ T red[kSums][kWarps];
  const long long run = blockIdx.y;
  const int j0 = blockIdx.x * kGroup;
  // the group that holds row `end` stores the pair
  const bool writes = end >= j0 && end < j0 + MP;
  const bool scalars = j0 == 0;
  const long long ntiles = (n + kTile - 1) / kTile;
  const long long t0 = run * tiles;
  const long long t1 = t0 + tiles < ntiles ? t0 + tiles : ntiles;
  T acc[MP][6], gacc[MP][2], gs[2] = {T(0), T(0)};
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
      pair_gram_tile<true, kXg, T, H, MP, kGp>(stp, a, b, gx, gp, pg, S, Y, i, n, ld, m, j0,
                                               end, writes, scalars, acc, gacc, gs);
    } else {
      pair_gram_tile<false, kXg, T, H, MP, kGp>(stp, a, b, gx, gp, pg, S, Y, i, n, ld, m,
                                                j0, end, writes, scalars, acc, gacc, gs);
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
#pragma unroll
  for (int k = 0; k < kScalars; ++k) {
    const T v = warp_sum(gs[k]);
    if (lane0) red[8 * MP + k][warp] = v;
  }
  __syncthreads();
  // K12's . gp partials hold gp.gp and gp.pg before the rows
  const long long gstride = 2LL * m + kScalars;
  for (int p = threadIdx.x; p < kSums; p += kThreads) {
    T sum = red[p][0];
    for (int w = 1; w < kWarps; ++w) sum = add_rn(sum, red[p][w]);
    if (p < 6 * MP) {
      const int j = j0 + p / 6;
      if (j < m) partials[6LL * m * run + 6 * j + p % 6] = sum;
    } else if (p < 8 * MP) {
      const int q = p - 6 * MP;
      const int j = j0 + q / 2;
      if (j < m) gpartials[gstride * run + kScalars + 2 * j + q % 2] = sum;
    } else if (scalars) {
      gpartials[gstride * run + (p - 8 * MP)] = sum;
    }
  }
}

template <typename T, typename H, int MP, bool kGp, bool kXg, bool kBatched>
int launch_pair_gram(const PairIn<T>& in, H* S, H* Y, T* partials, T* gpartials, long long n,
                     long long ld, int m, int end, long long tiles, long long blocks, bool vec,
                     const unsigned char* live, int batch, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((m + kGroup - 1) / kGroup),
                  static_cast<unsigned>(blocks), static_cast<unsigned>(batch));
  pair_gram_kernel<T, H, MP, kGp, kXg, kBatched><<<grid, kThreads, 0, stream>>>(
      in.stp, in.a, in.b, in.gx, in.gp, in.pg, S, Y, partials, gpartials, n, ld, m, end,
      tiles, vec, live, in.stps);
  return static_cast<int>(cudaGetLastError());
}

// MP, the ring rows a block holds: m itself at the depths users run
// (1-4 and 6: the north star's 3, the main path's 6), and groups of
// kGroup rows for m = 5 and beyond 6.  A padded row costs registers: its
// sums and its loaded rows are live through the whole loop.
template <typename T, typename H, bool kGp, bool kXg, bool kBatched = false>
int pair_gram_rows(const PairIn<T>& in, H* S, H* Y, T* partials, T* gpartials, long long n,
                   long long ld, int m, int end, long long tiles, long long blocks, bool vec,
                   cudaStream_t stream, const unsigned char* live, int batch) {
  const auto launch = [&](auto rows) {
    return launch_pair_gram<T, H, decltype(rows)::value, kGp, kXg, kBatched>(
        in, S, Y, partials, gpartials, n, ld, m, end, tiles, blocks, vec, live, batch, stream);
  };
  switch (m < 5 ? m : kGroup) {
    case 1: return launch(std::integral_constant<int, 1>());
    case 2: return launch(std::integral_constant<int, 2>());
    case 3: return launch(std::integral_constant<int, 3>());
    case 4: return launch(std::integral_constant<int, 4>());
    default: return launch(std::integral_constant<int, kGroup>());
  }
}

bool aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<unsigned long long>(p) % bytes == 0;
}

// tile, tiles and blocks are the wrapper's launch (fused.pair_gram_grid):
// refused unless the tile is this instantiation's and the blocks' runs of
// `tiles` tiles cover n exactly once
template <typename T>
bool launch_ok(long long n, long long ld, int m, int end, long long tile, long long tiles,
               long long blocks) {
  constexpr long long kTile = static_cast<long long>(kThreads) * kV<T>;
  if (n <= 0 || ld < n || m < 1 || end < 0 || end >= m || tile != kTile || tiles < 1)
    return false;
  const long long ntiles = (n + kTile - 1) / kTile;
  return blocks == (ntiles + tiles - 1) / tiles && blocks <= kMaxBlocks;
}

// whether every whole run takes one load per array: each array on a
// 16-byte (vectors) or V-element (rings) boundary and n and the ring's
// row stride ld multiples of V, which keeps every ring row and every
// instance's rows of a batch so aligned too
template <typename T, typename H, bool kXg>
bool vec_ok(const PairIn<T>& in, const void* S, const void* Y, long long n, long long ld) {
  bool vec = aligned(in.a, 16) && aligned(in.gx, 16) && aligned(in.gp, 16) &&
             aligned(S, kV<T> * sizeof(H)) && aligned(Y, kV<T> * sizeof(H)) &&
             n % kV<T> == 0 && ld % kV<T> == 0;
  if (kXg) vec = vec && aligned(in.b, 16) && aligned(in.pg, 16);
  return vec;
}

template <typename T, typename H, bool kXg>
int pair_gram(const PairIn<T>& in, void* S, void* Y, void* partials, void* gpartials,
              long long n, long long ld, int m, int end, int with_gp, long long tile,
              long long tiles, long long blocks, void* stream) {
  if (!launch_ok<T>(n, ld, m, end, tile, tiles, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = vec_ok<T, H, kXg>(in, S, Y, n, ld);
  const auto run = with_gp ? pair_gram_rows<T, H, true, kXg> : pair_gram_rows<T, H, false, kXg>;
  return run(in, static_cast<H*>(S), static_cast<H*>(Y), static_cast<T*>(partials),
             static_cast<T*>(gpartials), n, ld, m, end, tiles, blocks, vec,
             reinterpret_cast<cudaStream_t>(stream), nullptr, 1);
}

// K12 b: the vectors [batch, n], the rings [batch, m, n], partials
// [batch, blocks, 6m]; the launch of each instance is the solo one's
template <typename T, typename H>
int pair_gram_xg_batched(const PairIn<T>& in, void* S, void* Y, const void* live,
                         void* partials, long long n, long long ld, int m, int end,
                         long long tile, long long tiles, long long blocks, int batch,
                         void* stream) {
  if (!launch_ok<T>(n, ld, m, end, tile, tiles, blocks) || batch < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return pair_gram_rows<T, H, false, true, true>(
      in, static_cast<H*>(S), static_cast<H*>(Y), static_cast<T*>(partials), nullptr, n, ld,
      m, end, tiles, blocks, vec_ok<T, H, true>(in, S, Y, n, ld),
      reinterpret_cast<cudaStream_t>(stream), static_cast<const unsigned char*>(live), batch);
}

// K5 b: the vectors [batch, n], the steps [batch], the rings [batch, m,
// n], partials [batch, blocks, 6m] (. gp: [batch, blocks, 2m]); the launch
// of each instance is the solo one's
template <typename T, typename H>
int pair_gram_sd_batched(const PairIn<T>& in, void* S, void* Y, const void* live,
                         void* partials, void* gpartials, long long n, long long ld, int m,
                         int end, int with_gp, long long tile, long long tiles,
                         long long blocks, int batch, void* stream) {
  if (!launch_ok<T>(n, ld, m, end, tile, tiles, blocks) || batch < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = vec_ok<T, H, false>(in, S, Y, n, ld);
  const auto* lv = static_cast<const unsigned char*>(live);
  const auto cs = reinterpret_cast<cudaStream_t>(stream);
  if (with_gp)
    return pair_gram_rows<T, H, true, false, true>(
        in, static_cast<H*>(S), static_cast<H*>(Y), static_cast<T*>(partials),
        static_cast<T*>(gpartials), n, ld, m, end, tiles, blocks, vec, cs, lv, batch);
  return pair_gram_rows<T, H, false, false, true>(
      in, static_cast<H*>(S), static_cast<H*>(Y), static_cast<T*>(partials), nullptr, n, ld,
      m, end, tiles, blocks, vec, cs, lv, batch);
}

}  // namespace

extern "C" {

// K5.  stp arrives as a double and is rounded to the vectors' type (exact
// for a step that is already of that type)
#define LBFGS_PAIR_GRAM_ENTRY(SFX, T, H)                                                    \
  int lbfgs_pair_gram_##SFX(double stp, const void* d, const void* gx, const void* gp,      \
                            void* S, void* Y, void* partials, void* gpartials,             \
                            long long n, long long ld, int m, int end, int with_gp,        \
                            long long tile, long long tiles, long long blocks,             \
                            void* stream) {                                                \
    const PairIn<T> in{static_cast<T>(stp), static_cast<const T*>(d), nullptr,             \
                       static_cast<const T*>(gx), static_cast<const T*>(gp), nullptr};     \
    return pair_gram<T, H, false>(in, S, Y, partials, gpartials, n, ld, m, end, with_gp,    \
                                  tile, tiles, blocks, stream);                            \
  }

LBFGS_PAIR_GRAM_ENTRY(f32_bf16, float, __nv_bfloat16)
LBFGS_PAIR_GRAM_ENTRY(f32_f32, float, float)
LBFGS_PAIR_GRAM_ENTRY(f64_f64, double, double)

#undef LBFGS_PAIR_GRAM_ENTRY

// K12
#define LBFGS_PAIR_GRAM_XG_ENTRY(SFX, T, H)                                               \
  int lbfgs_pair_gram_xg_##SFX(const void* x, const void* xp, const void* gx,            \
                               const void* gp, const void* pg, void* S, void* Y,         \
                               void* partials, void* gpartials, long long n,             \
                               long long ld, int m, int end, int with_gp, long long tile, \
                               long long tiles, long long blocks, void* stream) {        \
    const PairIn<T> in{T(0), static_cast<const T*>(x), static_cast<const T*>(xp),        \
                       static_cast<const T*>(gx), static_cast<const T*>(gp),             \
                       static_cast<const T*>(pg)};                                       \
    return pair_gram<T, H, true>(in, S, Y, partials, gpartials, n, ld, m, end, with_gp,   \
                                 tile, tiles, blocks, stream);                           \
  }

LBFGS_PAIR_GRAM_XG_ENTRY(f32_bf16, float, __nv_bfloat16)
LBFGS_PAIR_GRAM_XG_ENTRY(f32_f32, float, float)
LBFGS_PAIR_GRAM_XG_ENTRY(f64_f64, double, double)

#undef LBFGS_PAIR_GRAM_XG_ENTRY

// K12 b
#define LBFGS_PAIR_GRAM_XG_BATCHED_ENTRY(SFX, T, H)                                          \
  int lbfgs_pair_gram_xg_batched_##SFX(const void* x, const void* xp, const void* gx,       \
                                       const void* gp, const void* pg, void* S, void* Y,    \
                                       const void* live, void* partials, long long n,       \
                                       long long ld, int m, int end, long long tile,        \
                                       long long tiles, long long blocks, int batch,        \
                                       void* stream) {                                      \
    const PairIn<T> in{T(0), static_cast<const T*>(x), static_cast<const T*>(xp),           \
                       static_cast<const T*>(gx), static_cast<const T*>(gp),                \
                       static_cast<const T*>(pg)};                                          \
    return pair_gram_xg_batched<T, H>(in, S, Y, live, partials, n, ld, m, end, tile, tiles,  \
                                      blocks, batch, stream);                               \
  }

LBFGS_PAIR_GRAM_XG_BATCHED_ENTRY(f32_bf16, float, __nv_bfloat16)
LBFGS_PAIR_GRAM_XG_BATCHED_ENTRY(f32_f32, float, float)
LBFGS_PAIR_GRAM_XG_BATCHED_ENTRY(f64_f64, double, double)

#undef LBFGS_PAIR_GRAM_XG_BATCHED_ENTRY

// K5 b
#define LBFGS_PAIR_GRAM_BATCHED_ENTRY(SFX, T, H)                                             \
  int lbfgs_pair_gram_batched_##SFX(const void* stp, const void* d, const void* gx,         \
                                    const void* gp, void* S, void* Y, const void* live,     \
                                    void* partials, void* gpartials, long long n,           \
                                    long long ld, int m, int end, int with_gp,              \
                                    long long tile, long long tiles, long long blocks,      \
                                    int batch, void* stream) {                              \
    const PairIn<T> in{T(0),    static_cast<const T*>(d),  nullptr,                         \
                       static_cast<const T*>(gx), static_cast<const T*>(gp), nullptr,       \
                       static_cast<const T*>(stp)};                                         \
    return pair_gram_sd_batched<T, H>(in, S, Y, live, partials, gpartials, n, ld, m, end,   \
                                      with_gp, tile, tiles, blocks, batch, stream);         \
  }

LBFGS_PAIR_GRAM_BATCHED_ENTRY(f32_bf16, float, __nv_bfloat16)
LBFGS_PAIR_GRAM_BATCHED_ENTRY(f32_f32, float, float)
LBFGS_PAIR_GRAM_BATCHED_ENTRY(f64_f64, double, double)

#undef LBFGS_PAIR_GRAM_BATCHED_ENTRY

}  // extern "C"
