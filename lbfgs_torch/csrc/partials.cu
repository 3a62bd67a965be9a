// R: the second stage of every kernel's partial sums, by hand for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: on the TPU a Pallas kernel carries its sums
// across its sequential grid, and the JAX package adds what is left with
// jnp.sum (lbfgs_tpu/ops/fused.py:285-296, obj_reduce).  On the card the
// kernels' programs run in parallel, so each writes its own row of a
// [programs, C] partials array (per instance: [B, programs, C]) and R adds
// the rows.  The port added it so that the K-lane probes (K2 s, K8 s and
// their batched forms) can sum all their lanes in one launch without
// changing any lane's bits: torch's column sum picks its order by the
// array's width, so a lane summed beside others came out in other bits
// than the one-lane kernel's.
//
// The order of addition for one column depends on its row count P alone,
// never on the number of columns C, on the batch B or on the grid.  With
// L = min(kLanes, P rounded up to a power of two) lanes, lane l adds rows
// l, l + kLanes, l + 2*kLanes, ... of the column in turn, from +0; then
// the lanes are added pairwise, lane l with lane l + h for h = L/2, ...,
// 1.  Every add is rounded on its own (__fadd_rn, __dadd_rn): no
// contraction, no atomics.  A column placed in any array, at any C and in
// any instance of a batch, gives the same bits, and so does a column that
// a one-lane kernel and a K-lane kernel write alike.  The wide form reads
// float32 partials and adds them in float64 (the wide objective scalar).
//
// What bounds it: launch latency.  At n = 2^24 a kernel's partials are P
// = 16384 rows of 1-5 columns (at most 4 + 6m), a few hundred kilobytes,
// which the card reads in well under a microsecond.  So R is one launch
// that spreads a column over up to 1024 threads: with L > 32 one block of
// L threads per output, each lane one thread, the pairwise adds in shared
// memory and the last five in a warp's shuffles; with L <= 32 (the batched
// kernels' few programs an instance) groups of L threads inside a warp,
// 256 / L outputs a block, the adds in shuffles of width L.  Each thread's
// loads along its lane are independent and unrolled, so a lane of 16 rows
// costs about one memory round trip.  A block per column reads its column
// one 4-byte word per 32-byte sector, and only C blocks run, so from
// kTileCols columns, more than kLanes rows and kTileMinElems values an
// instance (the Gram products' 4 + 6m columns over 16384 programs; at
// 4224 x 40 one launch is still the faster on an H100) R takes two
// launches instead, in the same order: the lanes of
// 32 columns a block, each warp reading 32 neighbouring columns of one
// row, into a [B, kLanes, C] scratch array that the wrapper allocates;
// then the pairwise adds, 32 columns a block, each thread taking 32 lanes
// of its column through the first five levels (leaves in bit-reversed
// order, so at most six sums live) and shared memory the last five.  A
// lane above P is +0, and x + (+0) is x (no sum here is ever -0), so 1024
// lanes give the bits of L lanes whatever P.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 1024;
constexpr int kGroupThreads = 256;
constexpr int kTileCols = 32;
constexpr long long kTileMinElems = 1LL << 18;

// whether B instances of [P, C] take the two-launch form
inline bool two_launches(long long P, long long C) {
  return C >= kTileCols && P > kLanes && P * C >= kTileMinElems;
}

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// lane l of one column: rows l, l + kLanes, ... in turn, from +0
template <typename In, typename Acc>
__device__ __forceinline__ Acc lane_sum(const In* __restrict__ col, long long P, long long sP,
                                        int lane) {
  Acc acc = Acc(0);
#pragma unroll 4
  for (long long r = lane; r < P; r += kLanes) acc = add_rn(acc, static_cast<Acc>(col[r * sP]));
  return acc;
}

// L > 32: block q is output q = b*C + c, thread t lane t
template <typename In, typename Acc>
__global__ void __launch_bounds__(kLanes)
partials_block_kernel(const In* __restrict__ x, Acc* __restrict__ out, long long P, long long C,
                      long long sB, long long sP, long long sC, int lanes) {
  __shared__ Acc red[kLanes];
  const long long q = blockIdx.x;
  const int t = threadIdx.x;
  red[t] = lane_sum<In, Acc>(x + (q / C) * sB + (q % C) * sC, P, sP, t);
  __syncthreads();
  for (int h = lanes >> 1; h >= 32; h >>= 1) {
    if (t < h) red[t] = add_rn(red[t], red[t + h]);
    __syncthreads();
  }
  if (t < 32) {
    Acc v = red[t];
    for (int h = 16; h > 0; h >>= 1) v = add_rn(v, __shfl_down_sync(0xffffffffu, v, h));
    if (t == 0) out[q] = v;
  }
}

// L <= 32: groups of L threads, kGroupThreads / L outputs a block
template <typename In, typename Acc>
__global__ void __launch_bounds__(kGroupThreads)
partials_group_kernel(const In* __restrict__ x, Acc* __restrict__ out, long long P, long long C,
                      long long sB, long long sP, long long sC, long long outputs, int lanes) {
  const int t = threadIdx.x;
  const int lane = t & (lanes - 1);
  const long long q = static_cast<long long>(blockIdx.x) * (kGroupThreads / lanes) + t / lanes;
  Acc v = Acc(0);
  if (q < outputs) v = lane_sum<In, Acc>(x + (q / C) * sB + (q % C) * sC, P, sP, lane);
  for (int h = lanes >> 1; h > 0; h >>= 1)
    v = add_rn(v, __shfl_down_sync(0xffffffffu, v, h, lanes));
  if (q < outputs && lane == 0) out[q] = v;
}

// two_launches(P, C), the first launch: block (b, column tile, lane
// tile) sums lanes ltile*32 + (thread / 32) of columns ctile*32 + (thread
// % 32) into the scratch array [B, kLanes, C]
template <typename In, typename Acc>
__global__ void __launch_bounds__(kTileCols * 32)
partials_lanes_kernel(const In* __restrict__ x, Acc* __restrict__ lanes, long long P,
                      long long C, long long sB, long long sP, long long sC, long long ctiles) {
  const int c_in = threadIdx.x % kTileCols, l_in = threadIdx.x / kTileCols;
  const long long blk = blockIdx.x;
  const int lane = static_cast<int>(blk % (kLanes / 32)) * 32 + l_in;
  const long long rest = blk / (kLanes / 32);
  const long long b = rest / ctiles, c = (rest % ctiles) * kTileCols + c_in;
  if (c < C)
    lanes[(b * kLanes + lane) * C + c] = lane_sum<In, Acc>(x + b * sB + c * sC, P, sP, lane);
}

// the leaf j = bit-reversal of i over five bits
__device__ __forceinline__ constexpr int rev5(int i) {
  return ((i & 1) << 4) | ((i & 2) << 2) | (i & 4) | ((i & 8) >> 2) | ((i & 16) >> 4);
}

// second launch: block (b, column tile); thread (t, c) adds lanes t + 32j,
// j = 0..31, of column c by the levels h = 512 .. 32 (leaves in
// bit-reversed order: positions 2i and 2i + 1 are lanes l and l + 512,
// and so on up), then the levels 16 .. 1 in shared memory
template <typename Acc>
__global__ void __launch_bounds__(kTileCols * 32)
partials_tree_kernel(const Acc* __restrict__ lanes, Acc* __restrict__ out, long long C,
                     long long ctiles) {
  __shared__ Acc red[32][kTileCols + 1];
  const int c_in = threadIdx.x % kTileCols, t = threadIdx.x / kTileCols;
  const long long b = blockIdx.x / ctiles, c = (blockIdx.x % ctiles) * kTileCols + c_in;
  const bool live = c < C;
  const Acc* col = lanes + b * kLanes * C + (live ? c : 0);
  Acc pend[5], v = Acc(0);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    v = live ? col[static_cast<long long>(t + 32 * rev5(i)) * C] : Acc(0);
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      if (!((i >> k) & 1)) {
        pend[k] = v;
        break;
      }
      v = add_rn(pend[k], v);
    }
  }
  red[t][c_in] = v;
  __syncthreads();
  for (int h = 16; h > 0; h >>= 1) {
    if (t < h) red[t][c_in] = add_rn(red[t][c_in], red[t + h][c_in]);
    __syncthreads();
  }
  if (t == 0 && live) out[b * C + c] = red[0][c_in];
}

template <typename In, typename Acc>
int launch_partials(const void* x, void* out, long long B, long long P, long long C,
                    long long sB, long long sP, long long sC, void* scratch, void* stream) {
  if (B < 0 || P < 0 || C < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long outputs = B * C;
  if (outputs == 0) return 0;
  int lanes = 1;
  while (lanes < P && lanes < kLanes) lanes <<= 1;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const In* xi = static_cast<const In*>(x);
  Acc* o = static_cast<Acc*>(out);
  if (two_launches(P, C)) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const long long ctiles = (C + kTileCols - 1) / kTileCols;
    if (B * ctiles * (kLanes / 32) > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    Acc* w = static_cast<Acc*>(scratch);
    partials_lanes_kernel<In, Acc>
        <<<static_cast<unsigned>(B * ctiles * (kLanes / 32)), kTileCols * 32, 0, s>>>(
            xi, w, P, C, sB, sP, sC, ctiles);
    const int code = static_cast<int>(cudaGetLastError());
    if (code != 0) return code;
    partials_tree_kernel<Acc><<<static_cast<unsigned>(B * ctiles), kTileCols * 32, 0, s>>>(
        w, o, C, ctiles);
  } else if (lanes > 32) {
    if (outputs > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    partials_block_kernel<In, Acc><<<static_cast<unsigned>(outputs), lanes, 0, s>>>(
        xi, o, P, C, sB, sP, sC, lanes);
  } else {
    const long long per = kGroupThreads / lanes;
    const long long blocks = (outputs + per - 1) / per;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    partials_group_kernel<In, Acc><<<static_cast<unsigned>(blocks), kGroupThreads, 0, s>>>(
        xi, o, P, C, sB, sP, sC, outputs, lanes);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int lbfgs_partials_lanes() { return kLanes; }

// elements of the scratch array (of the sums' type) a launch needs: B *
// kLanes * C in the two-launch form, else 0
long long lbfgs_partials_scratch(long long B, long long P, long long C) {
  return two_launches(P, C) ? B * kLanes * C : 0;
}

// out[b, c] = the fixed-order sum over p of x[b*sB + p*sP + c*sC] (strides
// in elements), for b < B and c < C; out is a contiguous [B, C]; scratch
// holds lbfgs_partials_scratch(B, P, C) sums (may be null where that is 0)
int lbfgs_partials_f32(const void* x, void* out, long long B, long long P, long long C,
                       long long sB, long long sP, long long sC, void* scratch, void* stream) {
  return launch_partials<float, float>(x, out, B, P, C, sB, sP, sC, scratch, stream);
}

int lbfgs_partials_f64(const void* x, void* out, long long B, long long P, long long C,
                       long long sB, long long sP, long long sC, void* scratch, void* stream) {
  return launch_partials<double, double>(x, out, B, P, C, sB, sP, sC, scratch, stream);
}

// the wide form: float32 partials added in float64, a float64 out
int lbfgs_partials_f32_wide(const void* x, void* out, long long B, long long P, long long C,
                            long long sB, long long sP, long long sC, void* scratch,
                            void* stream) {
  return launch_partials<float, double>(x, out, B, P, C, sB, sP, sC, scratch, stream);
}

}  // extern "C"
