// Sparse-domain center for Hopper (sm_90a): the weighted sum of m top-k
// wire payloads, sum_i w_i * scatter(vals_i, idx_i), into a (d,) vector,
// with no (m, d) array.
//
// Replaces the TPU kernel src/repro/kernels/robust_agg.py::
// aggregate_sparse_gridded (_sparse_agg_kernel; its stream preparation
// _sorted_stream also runs outside the Pallas call).  Contract:
// src/repro/kernels/ref.py::sparse_aggregate_ref, bit for bit: each value
// is multiplied by its worker's weight first (one f32 rounding), and every
// coordinate adds its contributions to 0.0 in stream order -- worker order,
// then position within the row -- one f32 rounding per add.  Duplicate
// indices within a row, rows in any order, all-zero payloads and zero
// weights are all served; indices must lie in [0, d).
//
// What bounds it here: nothing the card is short of.  At m = 20, k = 500,
// d = 5000 it reads 80 KB of payload and writes 20 KB, so its time is the
// chain of dependent loads of each thread's searches.
//
// Design: the wrapper sorts every row by index with a stable sort (PyTorch,
// before the launch), which keeps a row's duplicates in their order.  Then
// one thread per output coordinate c walks the m rows in worker order; in
// each row a binary search finds the first entry of c, and the run of c is
// added in order.  Each coordinate has one owner, so no atomics, and the
// sum's order is the contract's on every run.  __fmul_rn/__fadd_rn keep
// nvcc from contracting the weight's product and the add into an FMA, which
// would round once instead of twice.  The rows are small and every block
// searches the same ones, so they stay in L1/L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sparse_agg_kernel(const float* __restrict__ vals,
                  const int32_t* __restrict__ idx,
                  const float* __restrict__ weights, float* __restrict__ out,
                  int m, int k, int d) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= d) return;
  float acc = 0.0f;
  for (int r = 0; r < m; ++r) {
    const int32_t* ir = idx + (size_t)r * k;
    int lo = 0, hi = k;  // first position with ir[pos] >= c
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (ir[mid] < c) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const float* vr = vals + (size_t)r * k;
    for (int j = lo; j < k && ir[j] == c; ++j) {
      const float v = weights != nullptr ? __fmul_rn(vr[j], weights[r]) : vr[j];
      acc = __fadd_rn(acc, v);
    }
  }
  out[c] = acc;
}

}  // namespace

// vals (m, k) f32 and idx (m, k) int32, every row sorted by index (stably);
// weights (m,) f32 or null; out (d,) f32.
extern "C" int sparse_agg_launch(const float* vals, const int32_t* idx,
                                 const float* weights, float* out, int m,
                                 int k, int d, void* stream) {
  if (d > 0) {
    sparse_agg_kernel<<<(d + kThreads - 1) / kThreads, kThreads, 0,
                        (cudaStream_t)stream>>>(vals, idx, weights, out, m, k,
                                                d);
  }
  return (int)cudaGetLastError();
}
