// Batched Algorithm-2 cubic sub-problem solve for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/cubic_step.py::cubic_step
// (_cubic_kernel), looped by cubic_solve_fused.  One launch runs the whole
// Algorithm-2 loop for all m workers, one CTA per worker:
//
//   G = g + gamma * H s + (M gamma^2 / 2) * ||s|| * s
//   while ||G|| > tol and it < max_iters:  s <- s - lr * G;  recompute G
//
// Each CTA stops on its own condition, which is the per-element semantics of
// the reference's vmapped lax.while_loop (src/repro/core/cubic.py::
// solve_cubic_gd).  With max_iters = 1 and tol = -1 it is one cubic_step.
//
// What bounds it here: the H matvec, 2 d^2 flops per iteration, with H
// re-read every iteration.  At w8a (d = 300) one H is 300^2 * 4 B = 360 KB,
// more than the 227 KB of shared memory a block can use, so the TPU
// kernel's "whole state resident" design does not carry over: H rows are
// streamed from global memory, where all 20 Hessians (7.2 MB) stay in the
// 50 MB L2 across iterations.  s, g and G live in shared memory.  Each warp
// takes kRows whole rows at a time (coalesced float4 loads, shuffle
// reductions), so enough loads are in flight to hide L2 latency; ||s|| and
// ||G|| are block reductions with a barrier between the matvec and the
// update.  Only
// m = 20 CTAs run on 132 SMs, so most of the card idles: splitting a
// worker's rows across a thread block cluster is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;  // rows of H each warp reduces at once

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sum of one float per thread, returned to every thread.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kWarps ? red[lane] : 0.0f;
    t = warp_sum(t);
    if (lane == 0) red[kWarps] = t;
  }
  __syncthreads();
  const float total = red[kWarps];
  __syncthreads();  // red is reused by the next call
  return total;
}

// G[r] = gs[r] + gamma * (H s)[r] + coef * s[r] for this warp's rows.  A
// warp takes kRows rows at once, so each lane keeps kRows loads of H in
// flight (float4 loads when d is a multiple of 4): the loop is bound by how
// many bytes are in flight from L2, not by arithmetic.
template <bool kVec4>
__device__ __forceinline__ void matvec_rows(const float* __restrict__ Hw,
                                            const float* s, const float* gs,
                                            float* G, int d, float gamma,
                                            float coef, int warp, int lane) {
  for (int r0 = warp * kRows; r0 < d; r0 += kWarps * kRows) {
    float acc[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) acc[q] = 0.0f;
    if (kVec4) {
      const int d4 = d >> 2;
      const float4* s4 = reinterpret_cast<const float4*>(s);
      const float4* H4 = reinterpret_cast<const float4*>(Hw);
      for (int j = lane; j < d4; j += 32) {
        const float4 sv = s4[j];
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          if (r0 + q < d) {
            const float4 h = __ldg(H4 + (size_t)(r0 + q) * d4 + j);
            acc[q] += h.x * sv.x + h.y * sv.y + h.z * sv.z + h.w * sv.w;
          }
        }
      }
    } else {
      for (int j = lane; j < d; j += 32) {
        const float sj = s[j];
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          if (r0 + q < d) acc[q] += __ldg(Hw + (size_t)(r0 + q) * d + j) * sj;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const float a = warp_sum(acc[q]);
      if (lane == 0 && r0 + q < d) {
        G[r0 + q] = gs[r0 + q] + gamma * a + coef * s[r0 + q];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
cubic_solve_kernel(const float* __restrict__ g, const float* __restrict__ H,
                   const float* __restrict__ s0, const float* __restrict__ lr,
                   float* __restrict__ s_out, int32_t* __restrict__ iters_out,
                   int d, float half_m_gamma2, float gamma, float tol,
                   int max_iters) {
  extern __shared__ __align__(16) float smem[];
  float* s = smem;          // (d,) iterate
  float* gs = smem + d;     // (d,) gradient
  float* G = smem + 2 * d;  // (d,) sub-problem gradient at s
  __shared__ float red[kWarps + 1];

  const int w = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* Hw = H + (size_t)w * d * d;
  const float step = lr[w];
  // float4 rows need d % 4 == 0 and a 16-byte aligned H
  const bool vec4 = (d & 3) == 0 && (reinterpret_cast<uintptr_t>(H) & 15) == 0;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    s[i] = s0[(size_t)w * d + i];
    gs[i] = g[(size_t)w * d + i];
  }
  // the block_sum barriers below publish s and gs to every thread

  int it = 0;
  while (it < max_iters) {
    float ss = 0.0f;
    for (int i = threadIdx.x; i < d; i += kThreads) ss += s[i] * s[i];
    const float coef = half_m_gamma2 * sqrtf(block_sum(ss, red));

    if (vec4) {
      matvec_rows<true>(Hw, s, gs, G, d, gamma, coef, warp, lane);
    } else {
      matvec_rows<false>(Hw, s, gs, G, d, gamma, coef, warp, lane);
    }
    __syncthreads();

    float gg = 0.0f;
    for (int i = threadIdx.x; i < d; i += kThreads) gg += G[i] * G[i];
    if (!(sqrtf(block_sum(gg, red)) > tol)) break;  // uniform over the block

    for (int i = threadIdx.x; i < d; i += kThreads) s[i] -= step * G[i];
    ++it;
    // the next block_sum's barriers order these writes before the matvec
  }
  __syncthreads();
  for (int i = threadIdx.x; i < d; i += kThreads) s_out[(size_t)w * d + i] = s[i];
  if (threadIdx.x == 0) iters_out[w] = it;
}

}  // namespace

extern "C" int cubic_solve_launch(const float* g, const float* H,
                                  const float* s0, const float* lr,
                                  float* s_out, int32_t* iters_out, int m,
                                  int d, float half_m_gamma2, float gamma,
                                  float tol, int max_iters, void* stream) {
  const size_t smem = (size_t)3 * d * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      cubic_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (m > 0) {
    cubic_solve_kernel<<<m, kThreads, smem, (cudaStream_t)stream>>>(
        g, H, s0, lr, s_out, iters_out, d, half_m_gamma2, gamma, tol,
        max_iters);
  }
  return (int)cudaGetLastError();
}
