// Per-coordinate ascending sort over the workers, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/robust_agg.py::sort_workers_fused
// (_rowsort_kernel, _bitonic_sort_cols), the sort behind trimmed_mean_fused
// and coordinate_median_fused.  Contract: torch.sort(x, dim=0,
// stable=True).values bit for bit, which is jnp.sort(x, axis=0): ascending,
// NaN after every number, equal values (+0.0 and -0.0 among them) in worker
// order.  The TPU kernel's bitonic network is not stable, so it puts +0.0
// and -0.0 in either order; top-k payloads are mostly zeros and a negated
// update turns +0.0 into -0.0, so that network is not copied.
//
// What bounds it here: nothing the card is short of.  The paper's stack is
// (20, 300) floats, 24 KB in and out; the m^2 compares per coordinate
// (120K in all) take a few microseconds, so launch latency sets the time.
//
// Design: a rank sort.  Thread (r, c) holds x[r, c] and counts the workers
// s whose x[s, c] comes before it -- smaller in the order, or equal with
// s < r.  That count is its slot in the sorted column, and it writes x[r, c]
// there.  Distinct (value, worker) keys give distinct slots, so the output
// is a permutation of each column and the stable one.  Adjacent threads take
// adjacent coordinates, so every load of x[s, c] is coalesced across a warp.
// No comparison goes through fminf/fmaxf, which drop NaN.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxGridY = 65535;

// a comes before b in torch.sort's ascending order: NaN after every number
__device__ __forceinline__ bool before(float a, float b) {
  return a < b || (isnan(b) && !isnan(a));
}

__global__ void __launch_bounds__(kThreads)
sort_workers_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int m, int d) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= d) return;
  for (int r = blockIdx.y; r < m; r += gridDim.y) {
    const float v = x[(size_t)r * d + c];
    int rank = 0;
    for (int s = 0; s < m; ++s) {
      const float u = x[(size_t)s * d + c];
      rank += before(u, v) || (s < r && !before(v, u));
    }
    out[(size_t)rank * d + c] = v;
  }
}

}  // namespace

extern "C" int sort_workers_launch(const float* x, float* out, int m, int d,
                                   void* stream) {
  if (m > 0 && d > 0) {
    const dim3 grid((d + kThreads - 1) / kThreads, m < kMaxGridY ? m : kMaxGridY);
    sort_workers_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(x, out, m,
                                                                     d);
  }
  return (int)cudaGetLastError();
}
