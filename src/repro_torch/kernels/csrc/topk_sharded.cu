// Top-|x| compression for Hopper (sm_90a) past the single-tile bound
// (d > 1408): one launch, a thread block cluster per sender row, no global
// scratch.
//
// Replaces the TPU kernels src/repro/kernels/topk_compress.py::
// topk_compress_sharded, pass 1 (_hist_kernel) and pass 2 (_pack_kernel).
// Contract: src/repro/kernels/ref.py::topk_compress_ref for every row of an
// (m, d) stack, bit for bit -- the k largest |x| in ascending index order,
// ties at the k-th magnitude filled lowest index first across the whole
// row, values with their sign, -0.0 tied with +0.0.
//
// What bounds it here: the least work reads x once and writes the payload
// once (at (20, 5000), k = 500: 0.48 MB, 0.14 us at 3.35 TB/s), so the
// time is latency: the launch, the passes over a CTA's slice and the
// barriers between the select's rounds (a barrier.cluster costs about as
// much as a pass over a few thousand coordinates here).  The design keeps
// every step in one launch and every exchange on chip, and a row that one
// CTA serves well takes no cluster barrier at all.
//
// Design.  The fp32 pattern of |x| (the sign bit cleared) orders like the
// magnitude, so the exact pattern p of a row's k-th largest |x| is found by
// a radix select over its 31 bits in three rounds, (21, 10), (11, 10),
// (0, 11) as in the reference.  A row is a cluster of C CTAs (C from
// topk_plan, by d and m), and CTA q owns the slice [q * S, (q + 1) * S) of
// the row, S = ceil(d / C) rounded up to 4.
//   - The load reads the slice once (16-byte loads where d % 4 == 0, a few
//     in flight a thread) and keeps its first `keep` coordinates in shared
//     memory behind the fixed part (kSliceAt), as many as the card's
//     per-block limit allows (layout(): 49820 on an H100); the rest, where
//     a slice outgrows it, is re-read from L2 by each later pass (batched
//     loads, the streamed part spread over every warp).
//   - A round: each CTA counts, in its own shared-memory histogram of the
//     round, the next nbits of each pattern whose higher bits equal the
//     prefix so far (the first round's counts come with the load).  With
//     C > 1, one barrier.cluster, then each thread sums its bins over the
//     C CTAs' histograms (vector loads from distributed shared memory:
//     integer sums, exact and the same from run to run).  Warp 0 then finds
//     the bucket that holds the k-th magnitude (a two-level suffix scan by
//     shuffles) and extends the prefix.
//   - After the third round the prefix is p, and the count above it is the
//     number of sure survivors n_sure; k - n_sure ties are kept, lowest
//     index first.  Each warp counts the sure coordinates and ties of its
//     pieces of the slice (one of the resident part, one of the streamed
//     part), warp 0 turns the counts into offsets in index order, the CTA's
//     totals go to every CTA of the cluster (remote stores, one more
//     barrier.cluster), and each CTA adds the totals of the CTAs before it.
//   - The pack: each warp walks its pieces 32 coordinates at a time;
//     __ballot_sync of "above p" and "equal to p" and __popc below the lane
//     give each survivor its slot, sure_before + min(ties_before,
//     k - n_sure).
// Four cluster barriers when C > 1, none when C = 1; every remote access
// comes before the last, so no CTA leaves while another still reads its
// shared memory.  Nothing depends on k at build time.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
// radix rounds over the 31 magnitude bits, (shift, nbits) = (21, 10),
// (11, 10), (0, 11) as the reference; round r's histogram starts at
// hist_at(r)
constexpr int kRounds = 3;
constexpr int kShift0 = 21;
constexpr int kHistInts = 1024 + 1024 + 2048;
// global loads a thread keeps in flight over the streamed part
constexpr int kBatch = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kMag = 0x7fffffffu;

// The fixed part of a CTA's shared memory, in front of the resident slice.
struct Shared {
  int local[kHistInts];           // this CTA's histogram of each round
  int total[kHistInts];           // the cluster's (C > 1)
  int cta_cnt[2 * kMaxCluster];   // (sure, tie) of every CTA of the cluster
  int warp_off[4 * kWarps];       // offsets of each warp's two pieces
  int state[2];                   // (prefix, count above the bucket)
};
constexpr int kSliceAt = 33168;
static_assert(sizeof(Shared) <= kSliceAt, "slice overlaps the fixed part");
static_assert(kSliceAt % 16 == 0, "16-byte slice stores");

__device__ __forceinline__ int shift_of(int r) {
  return r == 0 ? kShift0 : r == 1 ? 11 : 0;
}
__device__ __forceinline__ int bits_of(int r) { return r < 2 ? 10 : 11; }
__device__ __forceinline__ int hist_at(int r) {
  return r == 0 ? 0 : r == 1 ? 1024 : 2048;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

__device__ __forceinline__ int warp_suffix_sum(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_down_sync(kFull, v, o);
    if (lane + o < 32) v += t;
  }
  return v;
}

// The bucket of a round's histogram (32 * PER bins) that holds the k-th
// magnitude, found by one warp: the largest b with above + S[b] >= k, S[b]
// the count in bins >= b.  Lane l sums bins [l * PER, (l + 1) * PER)
// (16-byte loads, rotated so that the 8 lanes of a phase hit distinct
// banks), a suffix scan across the lanes finds the lane whose range
// crosses k, and the same again inside that range, PER / 32 bins a lane.
// *above becomes the count above the bucket.
template <int PER>
__device__ __forceinline__ int find_bucket(const int* hist, int k,
                                           int* above, int lane) {
  const int4* h4 = reinterpret_cast<const int4*>(hist + lane * PER);
  int mine = 0;
#pragma unroll
  for (int j = 0; j < PER / 4; ++j) {
    const int4 v = h4[(j + lane) % (PER / 4)];
    mine += v.x + v.y + v.z + v.w;
  }
  int after = *above + warp_suffix_sum(mine, lane) - mine;
  const int L =
      __ffs(__ballot_sync(kFull, after + mine >= k && after < k)) - 1;
  after = __shfl_sync(kFull, after, L);
  constexpr int kPer2 = PER / 32;
  const int c0 = L * PER + lane * kPer2;
  int mine2 = 0;
#pragma unroll
  for (int j = 0; j < kPer2; ++j) mine2 += hist[c0 + j];
  int s = after + warp_suffix_sum(mine2, lane) - mine2;
  int bin = -1, at = 0;
#pragma unroll
  for (int j = kPer2 - 1; j >= 0; --j) {
    const int g = hist[c0 + j];
    if (s + g >= k && s < k) {
      bin = c0 + j;
      at = s;
    }
    s += g;
  }
  const int L2 = __ffs(__ballot_sync(kFull, bin >= 0)) - 1;
  *above = __shfl_sync(kFull, at, L2);
  return __shfl_sync(kFull, bin, L2);
}

__device__ __forceinline__ void add(int2& a, int2 b) {
  a.x += b.x;
  a.y += b.y;
}
__device__ __forceinline__ void add(int4& a, int4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// The sum over the cluster's C CTAs of the V (int2 or int4) at `at` in
// each one's shared memory: up to 8 remote loads in flight at once, each
// CTA starting at its own rank so that the loads spread over the cluster.
template <typename V>
__device__ __forceinline__ V cluster_sum(cg::cluster_group& cluster,
                                         int* at, int C, int q) {
  V acc = {};
  for (int j0 = 0; j0 < C; j0 += 8) {
    V v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int rank = q + j0 + j;
      rank = rank >= C ? rank - C : rank;
      if (j0 + j < C) {
        v[j] = *reinterpret_cast<const V*>(cluster.map_shared_rank(at, rank));
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j0 + j < C) add(acc, v[j]);
    }
  }
  return acc;
}

__device__ __forceinline__ uint4 bits4(float4 w) {
  return make_uint4(__float_as_uint(w.x), __float_as_uint(w.y),
                    __float_as_uint(w.z), __float_as_uint(w.w));
}

// f(raw bits) for every coordinate of the slice, in no order: the resident
// part [0, R) from shared memory (or, with LOAD, from x, keeping it in sp),
// the streamed part [R, n) from x, a batch of loads in flight a thread.
// With VEC, R and n are multiples of 4 and xs is 16-byte aligned.
template <bool VEC, bool LOAD, typename F>
__device__ __forceinline__ void visit(uint32_t* sp, const float* xs, int R,
                                      int n, F&& f) {
  const int tid = threadIdx.x;
  if (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(xs);
    uint4* s4 = reinterpret_cast<uint4*>(sp);
    constexpr int kB = kBatch / 2;
    for (int v0 = LOAD ? tid : R / 4 + tid; v0 < n / 4; v0 += kB * kThreads) {
      uint4 u[kB];
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        const int v = v0 + b * kThreads;
        if (v < n / 4) u[b] = bits4(__ldg(x4 + v));
      }
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        const int v = v0 + b * kThreads;
        if (v < n / 4) {
          if (LOAD && 4 * v < R) s4[v] = u[b];
          f(u[b].x);
          f(u[b].y);
          f(u[b].z);
          f(u[b].w);
        }
      }
    }
    if (!LOAD) {
      for (int v = tid; v < R / 4; v += kThreads) {
        const uint4 u = s4[v];
        f(u.x);
        f(u.y);
        f(u.z);
        f(u.w);
      }
    }
  } else {
    for (int i0 = LOAD ? tid : R + tid; i0 < n; i0 += kBatch * kThreads) {
      uint32_t u[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int i = i0 + b * kThreads;
        if (i < n) u[b] = __float_as_uint(__ldg(xs + i));
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int i = i0 + b * kThreads;
        if (i < n) {
          if (LOAD && i < R) sp[i] = u[b];
          f(u[b]);
        }
      }
    }
    if (!LOAD) {
      for (int i = tid; i < R; i += kThreads) f(sp[i]);
    }
  }
}

// Raw bits of a warp's batch of kBatch steps of 32 coordinates from base,
// 0 past hi: from shared memory, or from x (STREAMED) with every load in
// flight at once.
template <bool STREAMED>
__device__ __forceinline__ void load_batch(const uint32_t* sp, const float* xs,
                                           int base, int hi, int lane,
                                           uint32_t (&u)[kBatch]) {
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    const int i = base + 32 * b + lane;
    u[b] = i < hi ? (STREAMED ? __float_as_uint(__ldg(xs + i)) : sp[i]) : 0u;
  }
}

// The sure coordinates (pattern > p) and ties of [lo, hi), summed over the
// warp.
template <bool STREAMED>
__device__ __forceinline__ int2 count_piece(const uint32_t* sp,
                                            const float* xs, int lo, int hi,
                                            uint32_t p, int lane) {
  int sure = 0, tie = 0;
  for (int base = lo; base < hi; base += 32 * kBatch) {
    uint32_t u[kBatch];
    load_batch<STREAMED>(sp, xs, base, hi, lane, u);
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const bool in = base + 32 * b + lane < hi;
      sure += in && (u[b] & kMag) > p;
      tie += in && (u[b] & kMag) == p;
    }
  }
  return make_int2(__reduce_add_sync(kFull, sure),
                   __reduce_add_sync(kFull, tie));
}

// The survivors of [lo, hi) at their slots of the row's payload; sure and
// tie count the sure coordinates and ties of the row before lo.
template <bool STREAMED>
__device__ __forceinline__ void pack_piece(const uint32_t* sp, const float* xs,
                                           int lo, int hi, uint32_t p,
                                           int budget, int k, int sure,
                                           int tie, int first, float* vr,
                                           int32_t* ir, int lane) {
  const unsigned below = (1u << lane) - 1u;
  for (int base = lo; base < hi; base += 32 * kBatch) {
    if (sure + min(tie, budget) >= k) return;  // the payload is full
    uint32_t u[kBatch];
    load_batch<STREAMED>(sp, xs, base, hi, lane, u);
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = base + 32 * b + lane;
      const uint32_t m = u[b] & kMag;
      const bool is_sure = i < hi && m > p, is_tie = i < hi && m == p;
      const unsigned ms = __ballot_sync(kFull, is_sure);
      const unsigned mt = __ballot_sync(kFull, is_tie);
      const int tie_rank = tie + __popc(mt & below);
      if (is_sure || (is_tie && tie_rank < budget)) {
        const int slot = sure + __popc(ms & below) + min(tie_rank, budget);
        vr[slot] = __uint_as_float(u[b]);
        ir[slot] = first + i;
      }
      sure += __popc(ms);
      tie += __popc(mt);
    }
  }
}

// [lo, hi) of a part of length len split over the warps in whole steps
__device__ __forceinline__ int2 piece(int start, int len, int warp) {
  const int seg = ((len + kWarps - 1) / kWarps + 31) & ~31;
  const int lo = min(len, warp * seg);
  return make_int2(start + lo, start + min(len, lo + seg));
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
topk_cluster_kernel(const float* __restrict__ x, float* __restrict__ vals,
                    int32_t* __restrict__ idx, int d, int k, int slice,
                    int keep) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& sh = *reinterpret_cast<Shared*>(smem);
  uint32_t* sp = reinterpret_cast<uint32_t*>(smem + kSliceAt);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int q = (int)cluster.block_rank();
  const int row = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lo = min(d, q * slice);
  const int n = min(d, lo + slice) - lo;
  const int R = min(n, keep);  // resident [0, R), streamed [R, n)
  const float* xs = x + (size_t)row * d + lo;

  for (int v = tid; v < kHistInts / 4; v += kThreads) {
    reinterpret_cast<int4*>(sh.local)[v] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();
  // the load, with the first round's histogram (every pattern in the band)
  visit<VEC, true>(sp, xs, R, n, [&](uint32_t u) {
    atomicAdd(&sh.local[(u & kMag) >> kShift0], 1);
  });

  uint32_t prefix = 0;
  int above = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int shift = shift_of(r), nbits = bits_of(r), nbk = 1 << nbits;
    int* local = sh.local + hist_at(r);
    if (r > 0) {
      visit<VEC, false>(sp, xs, R, n, [&](uint32_t u) {
        const uint32_t m = u & kMag;
        if ((m >> (shift + nbits)) == prefix) {
          atomicAdd(&local[(m >> shift) & (nbk - 1)], 1);
        }
      });
    }
    const int* hist = local;
    if (C > 1) {
      cluster_sync();  // every CTA's histogram of the round is complete
      int* total = sh.total + hist_at(r);
      if (nbk == 1024) {
        reinterpret_cast<int2*>(total)[tid] =
            cluster_sum<int2>(cluster, local + 2 * tid, C, q);
      } else {
        reinterpret_cast<int4*>(total)[tid] =
            cluster_sum<int4>(cluster, local + 4 * tid, C, q);
      }
      hist = total;
    }
    __syncthreads();  // the round's histogram is complete in this CTA
    if (warp == 0) {
      const int bin = nbits == 10 ? find_bucket<32>(hist, k, &above, lane)
                                  : find_bucket<64>(hist, k, &above, lane);
      if (lane == 0) {
        sh.state[0] = (int)((prefix << nbits) | (uint32_t)bin);
        sh.state[1] = above;
      }
    }
    __syncthreads();
    prefix = (uint32_t)sh.state[0];
    above = sh.state[1];
  }
  const uint32_t p = prefix;
  const int budget = k - above;  // tie slots, lowest index first

  // each warp's pieces of the resident and the streamed part
  const int2 pa = piece(0, R, warp), pb = piece(R, n - R, warp);
  const int2 ca = count_piece<false>(sp, xs, pa.x, pa.y, p, lane);
  const int2 cb = count_piece<true>(sp, xs, pb.x, pb.y, p, lane);
  if (lane == 0) {
    sh.warp_off[warp] = ca.x;
    sh.warp_off[kWarps + warp] = ca.y;
    sh.warp_off[2 * kWarps + warp] = cb.x;
    sh.warp_off[3 * kWarps + warp] = cb.y;
  }
  __syncthreads();
  if (warp == 0) {
    // index order: the resident pieces by warp, then the streamed ones
    int in[4], inc[4], sum[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      in[j] = lane < kWarps ? sh.warp_off[j * kWarps + lane] : 0;
      inc[j] = warp_inclusive_scan(in[j], lane);
      sum[j] = __shfl_sync(kFull, inc[j], 31);
    }
    if (lane < kWarps) {
      sh.warp_off[lane] = inc[0] - in[0];
      sh.warp_off[kWarps + lane] = inc[1] - in[1];
      sh.warp_off[2 * kWarps + lane] = sum[0] + inc[2] - in[2];
      sh.warp_off[3 * kWarps + lane] = sum[1] + inc[3] - in[3];
    }
    if (lane < C) {
      int* dst = cluster.map_shared_rank(sh.cta_cnt, lane);
      dst[2 * q] = sum[0] + sum[2];
      dst[2 * q + 1] = sum[1] + sum[3];
    }
  }
  if (C > 1) {
    cluster_sync();  // the last remote access is above this line
  } else {
    __syncthreads();
  }

  int sure = 0, tie = 0;
  for (int j = 0; j < q; ++j) {
    sure += sh.cta_cnt[2 * j];
    tie += sh.cta_cnt[2 * j + 1];
  }
  float* vr = vals + (size_t)row * k;
  int32_t* ir = idx + (size_t)row * k;
  pack_piece<false>(sp, xs, pa.x, pa.y, p, budget, k,
                    sure + sh.warp_off[warp], tie + sh.warp_off[kWarps + warp],
                    lo, vr, ir, lane);
  pack_piece<true>(sp, xs, pb.x, pb.y, p, budget, k,
                   sure + sh.warp_off[2 * kWarps + warp],
                   tie + sh.warp_off[3 * kWarps + warp], lo, vr, ir, lane);
}

using Kernel = void (*)(const float*, float*, int32_t*, int, int, int, int);

// The coordinates a CTA of a cluster of `cluster` owns (ceil(d / cluster),
// rounded up to 4 for 16-byte loads) and the first `keep` of them it holds
// in shared memory on the current card: all of them, or as many as fit
// behind the fixed part within the card's per-block limit.
cudaError_t layout(int d, int cluster, int* slice, int* keep) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  if (limit < kSliceAt) return cudaErrorInvalidValue;
  *slice = ((d + cluster - 1) / cluster + 3) & ~3;
  const int most = (limit - kSliceAt) / 16 * 4;
  *keep = *slice < most ? *slice : most;
  return cudaSuccess;
}

}  // namespace

// The launch topk_sharded_launch makes at (d, cluster) on the current card:
// out = (slice, keep, dynamic shared memory bytes a CTA).  Launches
// nothing.
extern "C" int topk_sharded_plan(int d, int cluster, int* out) {
  if (d < 1 || cluster < 1 || cluster > kMaxCluster) {
    return (int)cudaErrorInvalidValue;
  }
  int slice = 0, keep = 0;
  const cudaError_t err = layout(d, cluster, &slice, &keep);
  if (err != cudaSuccess) return (int)err;
  out[0] = slice;
  out[1] = keep;
  out[2] = kSliceAt + 4 * keep;
  return 0;
}

// x (m, d) float32, vals (m, k) float32, idx (m, k) int32; cluster the CTAs
// a row (1..16), from topk_plan.  One launch; no scratch.
extern "C" int topk_sharded_launch(const float* x, float* vals, int32_t* idx,
                                   int m, int d, int k, int cluster,
                                   void* stream) {
  if (m <= 0) return (int)cudaGetLastError();
  if (d < 1 || k < 1 || k > d || cluster < 1 || cluster > kMaxCluster ||
      (long long)m * cluster > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const bool vec = d % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  int slice = 0, keep = 0;
  cudaError_t err = layout(d, cluster, &slice, &keep);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = kSliceAt + (size_t)keep * 4;
  const Kernel fn =
      vec ? topk_cluster_kernel<true> : topk_cluster_kernel<false>;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess && cluster > 8) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(m * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fn, x, vals, idx, d, k, slice, keep);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
