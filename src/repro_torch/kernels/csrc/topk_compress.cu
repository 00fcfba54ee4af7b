// Batched top-|x| compression for Hopper (sm_90a), d <= 1408: one warp per
// sender row, several rows a CTA, no block barrier.
//
// Replaces the TPU kernel src/repro/kernels/topk_compress.py::topk_compress_tiled
// (_topk_kernel), the single-tile launch for d <= 1408.  Contract:
// src/repro/kernels/ref.py::topk_compress_ref, bit for bit -- the k largest
// |x| in ascending index order, ties at the threshold magnitude filled
// lowest index first (lax.top_k's rule), values with their sign, -0.0 tied
// with +0.0.
//
// What bounds it here: nothing the card is short of.  A w8a round moves
// 20 x 300 floats in and 20 x 30 (value, index) pairs out (about 29 KB), so
// the time is launch latency plus the dependency chain of the select.  The
// design keeps that chain inside one warp: no shared-memory round trip and
// no __syncthreads anywhere.
//
// Design.  Non-negative floats order like their int32 patterns, so the
// exact pattern p of a row's k-th largest |x| is the largest value with
// count(pattern >= p) >= k.  Lane l of the row's warp holds the patterns of
// coordinates l, l + 32, ... in registers (at most 44 at d = 1408; the
// template NPER is the next size up) and their sign bits in one 64-bit
// word.  The select finds p bit by bit over the 31 magnitude bits, each
// count one pass over the lane's registers and one __reduce_add_sync
// (redux.sync).  (Four 8-bit digit rounds through a per-warp shared
// histogram measured slower on the card; PERF.md §6.)  Then the pack,
// one step per 32 coordinates: __ballot_sync of "above p" and of "equal to
// p", and __popc of each mask below the lane give every survivor its slot,
// sure_before + min(ties_before, k - n_sure): ownership is strided, so
// index order falls out of the ballots directly.  Nothing depends on k at
// build time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 1408;  // SINGLE_TILE_MAX_D, the dispatcher's bound
constexpr int kWarps = 4;    // rows a CTA (TOPK_WARPS in topk_compress.py)
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kMag = 0x7fffffffu;

// Patterns are >= 0; a coordinate past d holds -1, which no count, sure
// test or tie test matches (every candidate and p are >= 0).
template <int NPER>
__device__ __forceinline__ int count_ge(const int (&pat)[NPER], int cand) {
  int c = 0;
#pragma unroll
  for (int j = 0; j < NPER; ++j) c += pat[j] >= cand;
  return c;
}

template <int NPER>
__device__ __forceinline__ int select_bits(const int (&pat)[NPER], int k) {
  int p = 0;
#pragma unroll 1
  for (int b = 30; b >= 0; --b) {
    const int cand = p | (1 << b);
    if (__reduce_add_sync(kFull, count_ge(pat, cand)) >= k) p = cand;
  }
  return p;
}

template <int NPER>
__global__ void __launch_bounds__(kWarps * 32)
topk_warp_kernel(const float* __restrict__ x, float* __restrict__ vals,
                 int32_t* __restrict__ idx, int m, int d, int k) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= m) return;  // the whole warp leaves: no barrier waits for it
  const float* xr = x + (size_t)row * d;
  float* vr = vals + (size_t)row * k;
  int32_t* ir = idx + (size_t)row * k;

  int pat[NPER];
  uint64_t signs = 0;
#pragma unroll
  for (int j = 0; j < NPER; ++j) {
    const int i = 32 * j + lane;
    const unsigned u = i < d ? __float_as_uint(__ldg(xr + i)) : 0u;
    pat[j] = i < d ? (int)(u & kMag) : -1;
    signs |= (uint64_t)(u >> 31) << j;
  }

  const int p = select_bits(pat, k);
  int n_sure = 0;
#pragma unroll
  for (int j = 0; j < NPER; ++j) n_sure += pat[j] > p;
  const int budget = k - __reduce_add_sync(kFull, n_sure);  // tie slots

  const unsigned below = (1u << lane) - 1u;
  int sure_before = 0, tie_before = 0;
#pragma unroll
  for (int j = 0; j < NPER; ++j) {
    const int q = pat[j];
    const bool sure = q > p, tie = q == p;
    const unsigned ms = __ballot_sync(kFull, sure);
    const unsigned mt = __ballot_sync(kFull, tie);
    const int tie_rank = tie_before + __popc(mt & below);
    if (sure || (tie && tie_rank < budget)) {
      const int slot =
          sure_before + __popc(ms & below) + min(tie_rank, budget);
      vr[slot] = __uint_as_float((unsigned)q |
                                 ((unsigned)(signs >> j) & 1u) << 31);
      ir[slot] = 32 * j + lane;
    }
    sure_before += __popc(ms);
    tie_before += __popc(mt);
    if (sure_before + min(tie_before, budget) >= k) break;  // warp-uniform
  }
}

}  // namespace

// x (m, d) float32, vals (m, k) float32, idx (m, k) int32.
extern "C" int topk_compress_launch(const float* x, float* vals, int32_t* idx,
                                    int m, int d, int k, void* stream) {
  if (m <= 0) return (int)cudaGetLastError();
  if (d < 1 || d > kMaxD || k < 1 || k > d) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((m + kWarps - 1) / kWarps), block(32 * kWarps);
  cudaStream_t s = (cudaStream_t)stream;
  const int nper = (d + 31) / 32;
#define TOPK_WARP_CASE(N)                                                 \
  if (nper <= N) {                                                        \
    topk_warp_kernel<N><<<grid, block, 0, s>>>(x, vals, idx, m, d, k);    \
    return (int)cudaGetLastError();                                       \
  }
  TOPK_WARP_CASE(1)
  TOPK_WARP_CASE(2)
  TOPK_WARP_CASE(4)
  TOPK_WARP_CASE(8)
  TOPK_WARP_CASE(12)
  TOPK_WARP_CASE(16)
  TOPK_WARP_CASE(24)
  TOPK_WARP_CASE(32)
  TOPK_WARP_CASE(44)
#undef TOPK_WARP_CASE
  return (int)cudaErrorInvalidValue;
}
