// Sharded top-|x| compression for Hopper (sm_90a): a grid of
// (coordinate block x sender row) CTAs, any d.
//
// Replaces the TPU kernels src/repro/kernels/topk_compress.py::
// topk_compress_sharded, pass 1 (_hist_kernel) and pass 2 (_pack_kernel).
// Contract: src/repro/kernels/ref.py::topk_compress_ref for every row of an
// (m, d) stack, bit for bit -- the k largest |x| in ascending index order,
// ties at the k-th magnitude filled lowest index first across the whole
// row, values with their sign, -0.0 tied with +0.0.
//
// What bounds it here: a row is read five times (three radix rounds, the
// count and the pack); at (20, 5000) that is 400 KB a read, so the bytes
// are small and the time is the chain of eight dependent launches with a
// few microseconds each.  The least work reads x once and writes the
// payload once.
//
// Design.  The fp32 pattern of |x| (the sign bit cleared) orders like the
// magnitude, so the exact pattern p of a row's k-th largest |x| is found by
// a radix select over its 31 bits in three rounds, (21, 10), (11, 10),
// (0, 11) as in the reference:
//   * hist_kernel: every CTA counts, in a shared-memory histogram, the
//     next nbits of each pattern whose higher bits equal the row's prefix,
//     then adds its counts into the row's histogram in global memory with
//     integer atomics (so the counts, and everything after, are exact and
//     the same from run to run);
//   * select_kernel: one CTA per row finds the bucket holding the k-th
//     magnitude from suffix sums of the histogram and extends the prefix.
// After the third round the prefix is p, and the count above it is the
// number of sure survivors (pattern > p).  Then
//   * count_kernel: every CTA counts its block's sure coordinates and ties
//     (pattern == p);
//   * pack_kernel: every CTA sums the counts of the blocks before it (block
//     order is index order), so a survivor i lands in slot
//     sure_before(i) + min(ties_before(i), k - n_sure), and a tie is kept
//     when ties_before(i) < k - n_sure.  Inside a block each thread owns a
//     contiguous chunk, and block-wide exclusive scans give its offsets.
// One CTA per row would leave most of the card idle at the mesh runtime's
// (2, 65536), so every pass spreads a row over blocks of kBlock coordinates.
// Nothing depends on k at build time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlock = 1024;  // coordinates per CTA (SHARDED_BLOCK)
constexpr int kPer = kBlock / kThreads;
constexpr int kMaxBuckets = 2048;
// radix rounds over the 31 magnitude bits: (shift, nbits), as the reference
constexpr int kRounds = 3;
constexpr int kShift[kRounds] = {21, 11, 0};
constexpr int kBits[kRounds] = {10, 10, 11};

__device__ __forceinline__ uint32_t magnitude(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// Block-wide sum of one int per thread, returned to every thread.
__device__ int block_sum(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kWarps ? red[lane] : 0;
    t = warp_sum(t);
    if (lane == 0) red[kWarps] = t;
  }
  __syncthreads();
  const int total = red[kWarps];
  __syncthreads();  // red is reused by the next call
  return total;
}

// Block-wide exclusive prefix sum in thread order; *total gets the sum.
__device__ int block_exclusive_scan(int v, int* red, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int inc = warp_inclusive_scan(v, lane);
  if (lane == 31) red[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kWarps ? red[lane] : 0;
    const int tinc = warp_inclusive_scan(t, lane);
    if (lane < kWarps) red[lane] = tinc - t;  // exclusive warp offsets
    if (lane == kWarps - 1) red[kWarps] = tinc;
  }
  __syncthreads();
  const int out = red[warp] + inc - v;
  *total = red[kWarps];
  __syncthreads();
  return out;
}

// Pass 1, one radix round: bucket counts of the next nbits of every pattern
// in the row's prefix band.  state[2 * row] is the row's prefix.
__global__ void __launch_bounds__(kThreads)
hist_kernel(const float* __restrict__ x, int d, int shift, int nbits,
            const int* __restrict__ state, int* __restrict__ hist) {
  __shared__ int sh[kMaxBuckets];
  const int row = blockIdx.y;
  const int nbk = 1 << nbits;
  for (int b = threadIdx.x; b < nbk; b += kThreads) sh[b] = 0;
  __syncthreads();
  const uint32_t prefix = (uint32_t)state[2 * row];
  const float* xr = x + (size_t)row * d;
  const int lo = blockIdx.x * kBlock, hi = min(d, lo + kBlock);
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
    const uint32_t q = magnitude(xr[i]);
    if ((q >> (shift + nbits)) == prefix) {
      atomicAdd(&sh[(q >> shift) & (nbk - 1)], 1);
    }
  }
  __syncthreads();
  int* hr = hist + (size_t)row * nbk;
  for (int b = threadIdx.x; b < nbk; b += kThreads) {
    if (sh[b] != 0) atomicAdd(&hr[b], sh[b]);
  }
}

// Pass 1, after each round: the bucket q holding the row's k-th magnitude is
// the largest with above + S[q] >= k, S[q] the count in buckets >= q and
// above (state[2 * row + 1]) the count strictly above the prefix band.
__global__ void __launch_bounds__(kThreads)
select_kernel(int* __restrict__ state, const int* __restrict__ hist,
              int nbits, int k) {
  __shared__ int red[kWarps + 1];
  const int row = blockIdx.x;
  const int nbk = 1 << nbits;
  const int per = nbk / kThreads;
  const int* hr = hist + (size_t)row * nbk;
  const int prefix = state[2 * row];
  const int above = state[2 * row + 1];
  const int b0 = threadIdx.x * per;
  int mine = 0;
  for (int j = 0; j < per; ++j) mine += hr[b0 + j];
  int total;
  const int before = block_exclusive_scan(mine, red, &total);
  // count in the buckets of the threads after this one, then walk down
  int s = total - before - mine;
  for (int j = per - 1; j >= 0; --j) {
    const int g = hr[b0 + j];
    s += g;  // S[b0 + j]
    if (above + s >= k && above + s - g < k) {
      state[2 * row] = (prefix << nbits) | (b0 + j);
      state[2 * row + 1] = above + s - g;
    }
  }
}

// Pass 2a: each block's count of sure coordinates (pattern > p) and ties.
__global__ void __launch_bounds__(kThreads)
count_kernel(const float* __restrict__ x, int d, const int* __restrict__ state,
             int nb, int* __restrict__ sure_cnt, int* __restrict__ tie_cnt) {
  __shared__ int red[kWarps + 1];
  const int row = blockIdx.y;
  const uint32_t p = (uint32_t)state[2 * row];
  const float* xr = x + (size_t)row * d;
  const int lo = blockIdx.x * kBlock, hi = min(d, lo + kBlock);
  int sure = 0, tie = 0;
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
    const uint32_t q = magnitude(xr[i]);
    sure += q > p;
    tie += q == p;
  }
  sure = block_sum(sure, red);
  tie = block_sum(tie, red);
  if (threadIdx.x == 0) {
    sure_cnt[(size_t)row * nb + blockIdx.x] = sure;
    tie_cnt[(size_t)row * nb + blockIdx.x] = tie;
  }
}

// Pass 2b: pack this block's survivors at their slots of the row's payload.
__global__ void __launch_bounds__(kThreads)
pack_kernel(const float* __restrict__ x, float* __restrict__ vals,
            int32_t* __restrict__ idx, int d, int k,
            const int* __restrict__ state, int nb,
            const int* __restrict__ sure_cnt, const int* __restrict__ tie_cnt) {
  __shared__ int red[kWarps + 1];
  const int row = blockIdx.y, blk = blockIdx.x;
  const uint32_t p = (uint32_t)state[2 * row];
  const int budget = k - state[2 * row + 1];  // tie slots, lowest index first
  const float* xr = x + (size_t)row * d;
  float* vr = vals + (size_t)row * k;
  int32_t* ir = idx + (size_t)row * k;

  // the counts of the blocks before this one
  int sure_blocks = 0, tie_blocks = 0;
  for (int b = threadIdx.x; b < blk; b += kThreads) {
    sure_blocks += sure_cnt[(size_t)row * nb + b];
    tie_blocks += tie_cnt[(size_t)row * nb + b];
  }
  sure_blocks = block_sum(sure_blocks, red);
  tie_blocks = block_sum(tie_blocks, red);

  // contiguous ownership: thread t holds coordinates [lo, hi)
  const int lo = min(d, blk * kBlock + (int)threadIdx.x * kPer);
  const int hi = min(d, lo + kPer);
  int n_sure = 0, n_tie = 0;
  for (int i = lo; i < hi; ++i) {
    const uint32_t q = magnitude(xr[i]);
    n_sure += q > p;
    n_tie += q == p;
  }
  int unused;
  const int sure_before = sure_blocks + block_exclusive_scan(n_sure, red, &unused);
  const int tie_before = tie_blocks + block_exclusive_scan(n_tie, red, &unused);

  int slot = sure_before + min(tie_before, budget);
  int tie_rank = tie_before;
  for (int i = lo; i < hi; ++i) {
    const float v = xr[i];
    const uint32_t q = magnitude(v);
    bool keep = q > p;
    if (q == p) keep = tie_rank++ < budget;
    if (keep) {
      vr[slot] = v;
      ir[slot] = i;
      ++slot;
    }
  }
}

}  // namespace

// scratch: int32, m * (1024 + 1024 + 2048 + 2 + 2 * nb) with
// nb = ceil(d / 1024): the three rounds' histograms, the (prefix, count
// above) state, then the per-block sure and tie counts.
extern "C" int topk_sharded_launch(const float* x, float* vals, int32_t* idx,
                                   int* scratch, int m, int d, int k,
                                   void* stream) {
  if (m <= 0 || d <= 0) return (int)cudaGetLastError();
  if (m > 65535 || k < 1 || k > d) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = (d + kBlock - 1) / kBlock;
  int* hist[kRounds];
  int* at = scratch;
  for (int r = 0; r < kRounds; ++r) {
    hist[r] = at;
    at += (size_t)m << kBits[r];
  }
  int* state = at;
  int* sure_cnt = state + 2 * (size_t)m;
  int* tie_cnt = sure_cnt + (size_t)m * nb;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, (size_t)(state + 2 * (size_t)m - scratch) * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;

  const dim3 grid(nb, m);
  for (int r = 0; r < kRounds; ++r) {
    hist_kernel<<<grid, kThreads, 0, s>>>(x, d, kShift[r], kBits[r], state,
                                          hist[r]);
    select_kernel<<<m, kThreads, 0, s>>>(state, hist[r], kBits[r], k);
  }
  count_kernel<<<grid, kThreads, 0, s>>>(x, d, state, nb, sure_cnt, tie_cnt);
  pack_kernel<<<grid, kThreads, 0, s>>>(x, vals, idx, d, k, state, nb,
                                        sure_cnt, tie_cnt);
  return (int)cudaGetLastError();
}
