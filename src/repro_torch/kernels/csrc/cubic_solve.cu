// Batched Algorithm-2 cubic sub-problem solve for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/cubic_step.py::cubic_step
// (_cubic_kernel), looped by cubic_solve_fused.  One launch runs the whole
// Algorithm-2 loop for all m workers:
//
//   G = g + gamma * H s + (M gamma^2 / 2) * ||s|| * s
//   while ||G|| > tol and it < max_iters:  s <- s - lr * G;  recompute G
//
// Each worker stops on its own condition, which is the per-element
// semantics of the reference's vmapped lax.while_loop (src/repro/core/
// cubic.py::solve_cubic_gd).  With max_iters = 1 and tol = -1 it is one
// cubic_step.  H is any float32 (m, d, d): nothing assumes it symmetric.
//
// Design: a worker is a thread block cluster of C CTAs (cudaLaunchKernelEx
// with a cluster dimension), and CTA q of the cluster owns rows
// [q * ceil(d / C), (q + 1) * ceil(d / C)) of its worker's H and of G.  Each
// CTA keeps a copy of the whole iterate s (two buffers, the current one and
// the next).  An iteration is one pass over the CTA's rows and one cluster
// barrier:
//   - each warp takes kRows rows at once (16-byte loads, shuffle sums), forms
//     G_i and, ahead of the stop decision, s_i - lr * G_i, and stores that
//     into the next-iterate buffer of every CTA of the cluster (distributed
//     shared memory, st.shared::cluster through map_shared_rank; the
//     kRows * C stores spread over the warp's lanes);
//   - each warp sends its partial sums of G_i^2 and of the new s_i^2 to a
//     slot of every CTA of the cluster (lane p to CTA p); barrier.cluster
//     (release/acquire);
//   - every warp of every CTA then sums the same slots in the same order, so
//     ||G|| and the next ||s|| are bitwise the same across the cluster and
//     its CTAs take the same stop decision and leave together.  On a stop,
//     the current buffer is the answer and the speculative next one is
//     dropped.
// The slots and iterate buffers alternate by parity, so one barrier a
// iteration orders every write against every read.  No atomics: the sums'
// order is fixed, and a run repeats its bits.
//
// Three modes, chosen on the host (cubic_solve_plan):
//   - kResident: the CTA's rows of H, ceil(d / C) * d floats, fit in its
//     shared memory (227 KB), so they are loaded once and kept for the whole
//     solve -- the TPU kernel's "whole state resident" design, which one CTA
//     could not hold at w8a (d = 300: 360 KB) but a cluster of two can
//     (180 KB each).  Then H costs no device memory traffic, and what
//     bounds an iteration is latency: the passes of a warp over its rows
//     (each a chain of shared-memory loads and shuffle sums), the stores
//     to the other CTAs and the cluster barrier.  So C is the smallest
//     cluster that holds the slice and leaves each warp one pass of kRows
//     rows (ceil(d / C) <= 64): at d = 300 that is C = 5, 60 rows a CTA.
//     A larger C only adds stores and barrier distance.
//   - kStreamed: H streams from device memory every iteration (at d = 5000
//     and m = 20, 2.0 GB an iteration: 0.6 ms at 3.35 TB/s), and that bounds
//     the kernel: sum_w iters_w * d^2 * 4 B over 3.35 TB/s.  One CTA a worker
//     reached 1.15 TB/s with 112 of 132 SMs idle; here C is the largest
//     cluster size for which all m clusters are resident at once
//     (cudaOccupancyMaxActiveClusters), so the m * C CTAs cover the card and
//     each keeps 2 * kRows 16-byte loads a lane in flight.  s stays in
//     shared memory, 2 * d floats.
//   - kStreamedGlobalS: past d = 28544, where the two iterate buffers
//     (2 * d floats) and the slots no longer fit a CTA's 227 KB of shared
//     memory, they live in device memory (the wrapper's (m, 2, d) scratch,
//     read through L2 with ld.cg), and each CTA writes its rows there once.
//     So the kernel has no width limit: it serves any d whose (m, d, d) H
//     the card holds.
// __launch_bounds__(512, 2) keeps a thread within 64 registers, so two CTAs
// can share an SM where the shared memory allows it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;  // rows of H each warp sums at once
constexpr int kMaxCluster = 16;
constexpr int kSlots = kMaxCluster * kWarps;  // a (G^2, s^2) pair per warp
constexpr int kSlotFloats = 2 * 2 * kSlots;   // two parities of float2

enum Mode { kResident = 0, kStreamed = 1, kStreamedGlobalS = 2 };

struct Args {
  const float* g;
  const float* H;
  const float* s0;
  const float* lr;
  float* s_out;
  int32_t* iters_out;
  float* s_glob;  // (m, 2, d), kStreamedGlobalS only
  int d;
  int dpad;  // d rounded up to a multiple of 4 (shared-memory rows)
  int rows_per_cta;
  int max_iters;
  float half_m_gamma2;
  float gamma;
  float tol;
};

__device__ __forceinline__ float warp_sum(float v) {
  // a butterfly: every lane ends with the same bits (a + b == b + a)
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float dot4(const float4& h, const float4& s) {
  return h.x * s.x + h.y * s.y + h.z * s.z + h.w * s.w;
}

// The sum of the n = C * kWarps slots of one parity, in one fixed order:
// the same bits in every lane, warp and CTA of the cluster.
__device__ __forceinline__ float2 slot_total(const float2* slots, int n,
                                             int lane) {
  float a = 0.0f, b = 0.0f;
  for (int i = lane; i < n; i += 32) {
    const float2 v = slots[i];
    a += v.x;
    b += v.y;
  }
  return make_float2(warp_sum(a), warp_sum(b));
}

// Lane partials of (H s)_r for the kRows rows r0 .. r0 + kRows - 1 (rows
// past row1 repeat row1 - 1, and their sums are dropped).
template <int kMode, bool kVec4>
__device__ __forceinline__ void row_dots(const float* Hw, const float* Hs,
                                         const float* s, int d, int dpad,
                                         int r0, int row0, int row1, int lane,
                                         float (&acc)[kRows]) {
#pragma unroll
  for (int q = 0; q < kRows; ++q) acc[q] = 0.0f;
  if constexpr (kMode == kResident) {
    const float4* s4 = reinterpret_cast<const float4*>(s);
    const float4* h4[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      h4[q] = reinterpret_cast<const float4*>(
          Hs + (size_t)(min(r0 + q, row1 - 1) - row0) * dpad);
    }
    for (int j = lane; j < (dpad >> 2); j += 32) {
      const float4 sv = s4[j];
#pragma unroll
      for (int q = 0; q < kRows; ++q) acc[q] += dot4(h4[q][j], sv);
    }
  } else if constexpr (kVec4) {
    const float4* h4[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      h4[q] = reinterpret_cast<const float4*>(
          Hw + (size_t)min(r0 + q, row1 - 1) * d);
    }
    const float4* s4 = reinterpret_cast<const float4*>(s);
#pragma unroll 2
    for (int j = lane; j < (d >> 2); j += 32) {
      float4 h[kRows];
#pragma unroll
      for (int q = 0; q < kRows; ++q) h[q] = __ldg(h4[q] + j);
      const float4 sv = kMode == kStreamed ? s4[j] : __ldcg(s4 + j);
#pragma unroll
      for (int q = 0; q < kRows; ++q) acc[q] += dot4(h[q], sv);
    }
  } else {
    const float* hr[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      hr[q] = Hw + (size_t)min(r0 + q, row1 - 1) * d;
    }
#pragma unroll 4
    for (int j = lane; j < d; j += 32) {
      const float sj = kMode == kStreamed ? s[j] : __ldcg(s + j);
#pragma unroll
      for (int q = 0; q < kRows; ++q) acc[q] += __ldg(hr[q] + j) * sj;
    }
  }
}

template <int kMode, bool kVec4>
__global__ void __launch_bounds__(kThreads, 2)
cubic_solve_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int q = (int)cluster.block_rank();
  const int w = blockIdx.x / C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = a.d, dpad = a.dpad;
  const int row0 = min(d, q * a.rows_per_cta);
  const int row1 = min(d, row0 + a.rows_per_cta);

  float2* slots = reinterpret_cast<float2*>(smem);  // [2][kSlots]
  float* sbuf = smem + kSlotFloats;                 // [2][dpad]
  float* gs = sbuf + 2 * dpad;                      // [rows_per_cta], resident
  float* Hs = gs + ((a.rows_per_cta + 3) & ~3);     // [row1 - row0][dpad]
  const float* Hw = a.H + (size_t)w * d * d;
  const float* gw = a.g + (size_t)w * d;
  const float* s0w = a.s0 + (size_t)w * d;
  float* sg = a.s_glob + (size_t)w * 2 * d;
  const float step = a.lr[w];

  // stage s0 (and, resident, this CTA's rows of g and of H, zero-padded)
  if constexpr (kMode == kStreamedGlobalS) {
    for (int i = row0 + threadIdx.x; i < row1; i += kThreads) sg[i] = s0w[i];
  } else {
    for (int i = threadIdx.x; i < dpad; i += kThreads) {
      sbuf[i] = i < d ? s0w[i] : 0.0f;
      sbuf[dpad + i] = 0.0f;
    }
  }
  if constexpr (kMode == kResident) {
    for (int i = row0 + threadIdx.x; i < row1; i += kThreads) {
      gs[i - row0] = gw[i];
    }
    for (int r = row0 + warp; r < row1; r += kWarps) {
      const float* src = Hw + (size_t)r * d;
      float* dst = Hs + (size_t)(r - row0) * dpad;
      if constexpr (kVec4) {
        for (int j = lane; j < (d >> 2); j += 32) {
          reinterpret_cast<float4*>(dst)[j] =
              __ldg(reinterpret_cast<const float4*>(src) + j);
        }
      } else {
        for (int j = lane; j < dpad; j += 32) {
          dst[j] = j < d ? __ldg(src + j) : 0.0f;
        }
      }
    }
  }
  cluster.sync();  // every CTA of the cluster runs: its shared memory is live

  // ||s0||^2 from the CTAs' rows, through the slots of parity 1
  {
    float ss = 0.0f;
    for (int i = row0 + threadIdx.x; i < row1; i += kThreads) {
      ss += s0w[i] * s0w[i];
    }
    ss = warp_sum(ss);
    if (lane < C) {
      *cluster.map_shared_rank(slots + kSlots + q * kWarps + warp, lane) =
          make_float2(0.0f, ss);
    }
  }
  cluster.sync();
  float ss_total = slot_total(slots + kSlots, C * kWarps, lane).y;

  int it = 0, cur = 0;
  while (it < a.max_iters) {
    const float coef = a.half_m_gamma2 * sqrtf(ss_total);
    const float* s = kMode == kStreamedGlobalS ? sg + cur * d
                                               : sbuf + cur * dpad;
    float* s_next = kMode == kStreamedGlobalS ? sg + (cur ^ 1) * d
                                              : sbuf + (cur ^ 1) * dpad;
    float gg = 0.0f, ss = 0.0f;  // this lane's rows: G_i^2 and new s_i^2
    for (int r0 = row0 + warp * kRows; r0 < row1; r0 += kWarps * kRows) {
      float acc[kRows];
      row_dots<kMode, kVec4>(Hw, Hs, s, d, dpad, r0, row0, row1, lane, acc);
      float dot = 0.0f;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float v = warp_sum(acc[j]);
        if (lane == j) dot = v;
      }
      const int i = r0 + lane;
      float sn = 0.0f;
      if (lane < kRows && i < row1) {
        const float si = kMode == kStreamedGlobalS ? __ldcg(s + i) : s[i];
        const float gi = kMode == kResident ? gs[i - row0] : gw[i];
        const float G = gi + a.gamma * dot + coef * si;
        sn = si - step * G;
        gg += G * G;
        ss += sn * sn;
        if constexpr (kMode == kStreamedGlobalS) s_next[i] = sn;
      }
      if constexpr (kMode != kStreamedGlobalS) {
        // the kRows new s_i to the C CTAs: lane l stores row l % kRows to
        // CTAs l / kRows, l / kRows + 32 / kRows, ...
        const float snq = __shfl_sync(0xffffffffu, sn, lane % kRows);
        const int iq = r0 + lane % kRows;
        if (iq < row1) {
          for (int p = lane / kRows; p < C; p += 32 / kRows) {
            *cluster.map_shared_rank(s_next + iq, p) = snq;
          }
        }
      }
    }
    const float2 part = make_float2(warp_sum(gg), warp_sum(ss));
    float2* par = slots + (it & 1) * kSlots;
    if (lane < C) {
      *cluster.map_shared_rank(par + q * kWarps + warp, lane) = part;
    }
    cluster.sync();
    const float2 total = slot_total(par, C * kWarps, lane);
    if (!(sqrtf(total.x) > a.tol)) break;  // the same in every CTA
    cur ^= 1;
    ++it;
    ss_total = total.y;
  }
  // no CTA touches another's shared memory after the last cluster.sync
  const float* s = kMode == kStreamedGlobalS ? sg + cur * d : sbuf + cur * dpad;
  for (int i = row0 + threadIdx.x; i < row1; i += kThreads) {
    a.s_out[(size_t)w * d + i] = kMode == kStreamedGlobalS ? __ldcg(s + i)
                                                           : s[i];
  }
  if (q == 0 && threadIdx.x == 0) a.iters_out[w] = it;
}

using Kernel = void (*)(const Args);

Kernel kernel_of(int mode, bool vec4) {
  switch (mode) {
    case kResident:
      return vec4 ? cubic_solve_kernel<kResident, true>
                  : cubic_solve_kernel<kResident, false>;
    case kStreamed:
      return vec4 ? cubic_solve_kernel<kStreamed, true>
                  : cubic_solve_kernel<kStreamed, false>;
    default:
      return vec4 ? cubic_solve_kernel<kStreamedGlobalS, true>
                  : cubic_solve_kernel<kStreamedGlobalS, false>;
  }
}

int round4(int d) { return (d + 3) & ~3; }

size_t smem_bytes(int mode, int d, int rows) {
  const size_t dpad = (size_t)round4(d);
  size_t floats = kSlotFloats;
  if (mode != kStreamedGlobalS) floats += 2 * dpad;
  if (mode == kResident) floats += round4(rows) + (size_t)rows * dpad;
  return floats * sizeof(float);
}

cudaError_t configure(Kernel fn, int cluster, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cluster > 8) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return err;
}

void launch_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                   int clusters, int cluster, size_t smem,
                   cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(clusters * cluster);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// How many clusters of this size and mode the card holds at once (0 when
// it holds none).
int max_active_clusters(int mode, bool vec4, int d, int cluster) {
  const int rows = (d + cluster - 1) / cluster;
  const size_t smem = smem_bytes(mode, d, rows);
  const Kernel fn = kernel_of(mode, vec4);
  if (configure(fn, cluster, smem) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  launch_config(&cfg, &attr, 1, cluster, smem, 0);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, (void*)fn, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

}  // namespace

// The launch plan of m workers at width d, by the rules in the header:
// plan[0] the cluster size C, plan[1] the mode (0 resident, 1 streamed, 2
// streamed with s in device memory), plan[2] the shared memory of a CTA in
// bytes, plan[3] how many such clusters the card holds at once.
extern "C" int cubic_solve_plan(int m, int d, int* plan) {
  int dev = 0, budget = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&budget,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return (int)err;
  if (m < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const bool vec4 = d % 4 == 0;
  const int sizes[] = {1, 2, 3, 4, 5, 6, 7, 8, 16};
  int chosen = 0, mode = kResident;
  // resident: the smallest cluster that holds H and gives each warp one
  // pass of kRows rows an iteration, else the smallest that holds H
  for (int one_pass = 1; one_pass >= 0 && chosen == 0; --one_pass) {
    for (int c : sizes) {
      const int rows = (d + c - 1) / c;
      if (c > d || (one_pass && rows > kWarps * kRows)) continue;
      if (smem_bytes(kResident, d, rows) <= (size_t)budget &&
          max_active_clusters(kResident, vec4, d, c) > 0) {
        chosen = c;
        break;
      }
    }
  }
  if (chosen == 0) {
    // streamed: the largest cluster with all m clusters resident at once
    mode = smem_bytes(kStreamed, d, 0) > (size_t)budget ? kStreamedGlobalS
                                                         : kStreamed;
    for (int i = (int)(sizeof(sizes) / sizeof(sizes[0])) - 1; i >= 0; --i) {
      const int c = sizes[i];
      if (c <= d && max_active_clusters(mode, vec4, d, c) >= m) {
        chosen = c;
        break;
      }
    }
    if (chosen == 0) chosen = 1;  // more workers than the card holds: waves
  }
  plan[0] = chosen;
  plan[1] = mode;
  plan[2] = (int)smem_bytes(mode, d, (d + chosen - 1) / chosen);
  plan[3] = max_active_clusters(mode, vec4, d, chosen);
  return (int)cudaGetLastError();
}

// g, s0, s_out (m, d); H (m, d, d); lr (m,); iters_out (m,) int32;
// s_glob (m, 2, d) scratch for mode 2, else null; cluster and mode from
// cubic_solve_plan.
extern "C" int cubic_solve_launch(const float* g, const float* H,
                                  const float* s0, const float* lr,
                                  float* s_out, int32_t* iters_out,
                                  float* s_glob, int m, int d,
                                  float half_m_gamma2, float gamma, float tol,
                                  int max_iters, int cluster, int mode,
                                  void* stream) {
  if (m < 1 || d < 1) return (int)cudaGetLastError();
  if (cluster < 1 || cluster > kMaxCluster || cluster > d || mode < 0 ||
      mode > kStreamedGlobalS ||
      (mode == kStreamedGlobalS && s_glob == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int rows = (d + cluster - 1) / cluster;
  const size_t smem = smem_bytes(mode, d, rows);
  const bool vec4 = d % 4 == 0 && (reinterpret_cast<uintptr_t>(H) & 15) == 0;
  const Kernel fn = kernel_of(mode, vec4);
  cudaError_t err = configure(fn, cluster, smem);
  if (err != cudaSuccess) return (int)err;
  Args a{g, H, s0, lr, s_out, iters_out, s_glob, d, round4(d), rows,
         max_iters, half_m_gamma2, gamma, tol};
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  launch_config(&cfg, &attr, m, cluster, smem, (cudaStream_t)stream);
  err = cudaLaunchKernelEx(&cfg, fn, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
