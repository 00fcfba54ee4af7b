// Krum scores for Hopper (sm_90a): one CTA per worker.
//
// Replaces the TPU kernel src/repro/kernels/robust_agg.py::krum_scores_fused
// (_krum_kernel).  Contract: src/repro/kernels/ref.py::krum_scores_ref --
// score(i) is the sum of the k = max(m - n_byz - 2, 1) smallest d2[i, j],
// where d2[i, j] = ||x_i - x_j||^2 and the diagonal takes +1e30, as
// src/repro/core/aggregation.py::krum_select adds it.  Only the (m,) scores
// are the result; the argmin runs in PyTorch, as in the reference.
//
// What bounds it here: nothing the card is short of.  The paper's stack is
// (20, 300) floats (24 KB in, 80 B out, 3 m^2 d = 360K operations), so the
// time is launch latency plus one CTA's serial work: m/8 distance sums per
// warp, then m compares per thread to rank the row.
//
// Design: the TPU kernel's power-of-two padded (P, P) tile and its bitonic
// column sort are not copied.
// * Distances.  Warp w of CTA i computes d2[i, j] for j = w, w + 8, ...;
//   lane l sums (x_i[c] - x_j[c])^2 over c = l, l + 32, ... in order, and a
//   fixed xor-shuffle tree adds the 32 lane sums.  The tree depends on
//   neither i nor j, and (a - b)^2 == (b - a)^2 bitwise, so d2[i, j] and
//   d2[j, i] are bitwise equal, as the reference's symmetric tile is.  The
//   row goes to the scratch d2 (m, m), which the wrapper allocates.
// * Selection.  Each thread ranks its entries of the row in a total order
//   (ascending, NaN after every number, equal values by column index); the
//   entries ranked below k land at sel[i, rank], and thread 0 sums
//   sel[i, 0..k) in ascending order.  Ranking costs m compares per entry,
//   so the kernel serves any m without a shared-memory bound.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kBig = 1e30f;  // krum_select's jnp.eye(m) * 1e30

// a comes before b in torch.sort's ascending order: NaN after every number
__device__ __forceinline__ bool before(float a, float b) {
  return a < b || (isnan(b) && !isnan(a));
}

__global__ void __launch_bounds__(kThreads)
krum_scores_kernel(const float* __restrict__ x, float* __restrict__ d2,
                   float* __restrict__ sel, float* __restrict__ scores, int m,
                   int d, int k) {
  const int i = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* xi = x + (size_t)i * d;
  float* row = d2 + (size_t)i * m;

  for (int j = warp; j < m; j += kWarps) {
    const float* xj = x + (size_t)j * d;
    float acc = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float diff = xi[c] - xj[c];
      acc = fmaf(diff, diff, acc);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    }
    if (lane == 0) row[j] = (j == i) ? acc + kBig : acc;
  }
  __syncthreads();  // the row, written to global memory, is read block-wide

  float* srow = sel + (size_t)i * k;
  for (int j = threadIdx.x; j < m; j += kThreads) {
    const float v = row[j];
    int rank = 0;
    for (int l = 0; l < m; ++l) {
      const float u = row[l];
      rank += before(u, v) || (l < j && !before(v, u));
    }
    if (rank < k) srow[rank] = v;
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int r = 0; r < k; ++r) s += srow[r];
    scores[i] = s;
  }
}

}  // namespace

extern "C" int krum_scores_launch(const float* x, float* d2, float* sel,
                                  float* scores, int m, int d, int k,
                                  void* stream) {
  if (m > 0) {
    krum_scores_kernel<<<m, kThreads, 0, (cudaStream_t)stream>>>(
        x, d2, sel, scores, m, d, k);
  }
  return (int)cudaGetLastError();
}
