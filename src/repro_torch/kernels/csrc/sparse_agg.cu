// Sparse-domain center for Hopper (sm_90a): the weighted sum of m top-k
// wire payloads, sum_i w_i * scatter(vals_i, idx_i), into a (d,) vector,
// with no (m, d) array.  One launch a call, at every d.
//
// Replaces the TPU kernel src/repro/kernels/robust_agg.py::
// aggregate_sparse_gridded (_sparse_agg_kernel; its stream preparation
// _sorted_stream also runs outside the Pallas call), and on the card also
// the reference's scatter branch at d <= 4096, whose scatter-add has no
// fixed order there.  Contract: src/repro/kernels/ref.py::
// sparse_aggregate_ref, bit for bit: each value is multiplied by its
// worker's weight first (one f32 rounding), and every coordinate adds its
// contributions to 0.0 in stream order -- worker order, then position
// within the row -- one f32 rounding per add.  Duplicate indices within a
// row, rows in any order, all-zero payloads and zero weights are all
// served; an index outside [0, d) is summed nowhere.
//
// What bounds it here: the bytes are few (at m = 20, k = 500, d = 5000 it
// reads 80 KB of payload and writes 20 KB: 0.03 us at 3.35 TB/s), so its
// time is latency: the launch, one round trip to L2 for the payload, and
// the barriers between its passes.
//
// Design: CTA b owns the kThreads coordinates from b * kThreads on, one a
// thread, and reads the whole payload stream (it is small and stays in
// L2).  The stream goes through in chunks of at most kChunk entries and
// kMaxRows rows; each thread loads its kVec 16-byte slots of indices and
// values of the chunk at once, so a chunk costs one L2 round trip, and
// keeps them in registers.  Two shared-memory tables of (row of the chunk)
// x (coordinate of the CTA) then order the chunk without sorting it:
//   scatter: every entry that falls in the CTA's range counts itself into
//            cnt[row][coordinate] with a 32-bit atomicAdd (order-free), and
//            the entry that finds the count at 0 stores its value into
//            val[row][coordinate];
//   sum:     after one barrier, the thread of each coordinate walks the
//            chunk's rows in worker order; where a row holds one entry of
//            its coordinate it adds val times its worker's weight (one
//            __fmul_rn) with one __fadd_rn into a sum it carries across
//            chunks.  A count above 1 -- duplicates within a row -- is rare
//            (top-k rows hold distinct indices): its thread walks that
//            row's part of the chunk and adds each match in order.
// The row of an entry comes from a division by k done as a multiply and
// shifts (Granlund and Montgomery's method, exact for every 32-bit
// position), and 32-bit shared-memory atomics keep the scatter short.
// So every coordinate has one owner, the sum's order is the contract's on
// every run, and nothing depends on the order of the atomics; no search, no
// sort and no dependent chain through global memory on the common path:
// two barriers a chunk, one chunk at w8a's and at drive A's payloads.
// __fmul_rn/__fadd_rn keep nvcc from contracting the weight's product and
// the add into an FMA, which would round once instead of twice.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;                  // = coordinates a CTA owns
constexpr int kVec = 5;                        // 16-byte slots a thread holds
constexpr int kChunk = 4 * kVec * kThreads;    // entries a chunk holds at most
constexpr int kMaxRows = 20;                   // rows a chunk spans at most
constexpr size_t kSmemBytes =
    (size_t)kMaxRows * kThreads * (sizeof(int) + sizeof(float)) +
    kMaxRows * sizeof(float);

// e / k for any 32-bit e, as a multiply-high and two shifts.
struct Divisor {
  unsigned mul;
  int sh1, sh2;
};

__device__ __forceinline__ int divide(int e, const Divisor& k) {
  const unsigned t = __umulhi((unsigned)e, k.mul);
  return (int)((t + (((unsigned)e - t) >> k.sh1)) >> k.sh2);
}

__device__ __forceinline__ int lane_of(const int4& v, int t) {
  return t == 0 ? v.x : t == 1 ? v.y : t == 2 ? v.z : v.w;
}

__device__ __forceinline__ float lane_of(const float4& v, int t) {
  return t == 0 ? v.x : t == 1 ? v.y : t == 2 ? v.z : v.w;
}

// vals and idx 16-byte aligned (the wrapper sees to it); n = m * k < 2^31.
__global__ void __launch_bounds__(kThreads)
sparse_agg_kernel(const float* __restrict__ vals,
                  const int32_t* __restrict__ idx,
                  const float* __restrict__ weights, float* __restrict__ out,
                  int m, int k, int d, Divisor kdiv) {
  extern __shared__ __align__(16) int smem[];
  int* cnt = smem;  // [kMaxRows][kThreads]
  float* val = reinterpret_cast<float*>(cnt + kMaxRows * kThreads);  // same
  float* wrow = val + kMaxRows * kThreads;  // [kMaxRows]
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kThreads;
  const int n = m * k;
  const bool weighted = weights != nullptr;
  for (int r = 0; r < kMaxRows; ++r) cnt[r * kThreads + tid] = 0;
  __syncthreads();

  float acc = 0.0f;
  for (int e0 = 0; e0 < n;) {
    const int r_first = divide(e0, kdiv);
    const int base = e0 & ~3;
    const int e1 = (int)min((long long)n,
                            min((long long)base + kChunk,
                                (long long)(r_first + kMaxRows) * k));
    const int nrows = divide(e1 - 1, kdiv) - r_first + 1;
    if (tid < nrows) wrow[tid] = weighted ? weights[r_first + tid] : 1.0f;

    // the chunk's slots, all loads in flight at once
    int4 iv[kVec];
    float4 vv[kVec];
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const int e = base + 4 * (u * kThreads + tid);
      iv[u] = make_int4(-1, -1, -1, -1);
      vv[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (e + 3 < n) {
        iv[u] = __ldg(reinterpret_cast<const int4*>(idx + e));
        vv[u] = __ldg(reinterpret_cast<const float4*>(vals + e));
      } else if (e < n) {  // the stream's ragged end
        iv[u].x = idx[e];
        vv[u].x = vals[e];
        if (e + 1 < n) { iv[u].y = idx[e + 1]; vv[u].y = vals[e + 1]; }
        if (e + 2 < n) { iv[u].z = idx[e + 2]; vv[u].z = vals[e + 2]; }
      }
    }

    // scatter: count each (row, coordinate); the first to count stores
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int e = base + 4 * (u * kThreads + tid) + t;
        const int c = lane_of(iv[u], t);
        if (e >= e0 && e < e1 && c < d &&
            (unsigned)c - (unsigned)c0 < (unsigned)kThreads) {
          const int slot =
              (divide(e, kdiv) - r_first) * kThreads + (c - c0);
          if (atomicAdd(&cnt[slot], 1) == 0) val[slot] = lane_of(vv[u], t);
        }
      }
    }
    __syncthreads();

    // sum: this thread's coordinate, rows in worker order
    const int c = c0 + tid;
#pragma unroll 4
    for (int rr = 0; rr < nrows; ++rr) {
      const int slot = rr * kThreads + tid;
      const int count = cnt[slot];
      if (count == 0) continue;
      if (count == 1) {
        const float v = val[slot];
        acc = __fadd_rn(acc, weighted ? __fmul_rn(v, wrow[rr]) : v);
      } else {
        const int row = (r_first + rr) * k;
        const int j_end = min(k, e1 - row);
        for (int j = max(0, e0 - row); j < j_end; ++j) {
          if (idx[row + j] == c) {
            const float v = vals[row + j];
            acc = __fadd_rn(acc, weighted ? __fmul_rn(v, wrow[rr]) : v);
          }
        }
      }
      cnt[slot] = 0;
    }
    __syncthreads();  // the tables and wrow are reused by the next chunk
    e0 = e1;
  }
  if (c0 + tid < d) out[c0 + tid] = acc;
}

}  // namespace

// vals (m, k) f32 and idx (m, k) int32, contiguous and 16-byte aligned, rows
// in any order; weights (m,) f32 or null; out (d,) f32.
extern "C" int sparse_agg_launch(const float* vals, const int32_t* idx,
                                 const float* weights, float* out, int m,
                                 int k, int d, void* stream) {
  if (m < 0 || k < 0 || (long long)m * k >= (1LL << 31) ||
      ((reinterpret_cast<uintptr_t>(vals) | reinterpret_cast<uintptr_t>(idx))
       & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      sparse_agg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  // Granlund and Montgomery: with l = ceil(log2 k), mul = floor(2^32 (2^l
  // - k) / k) + 1, e / k = (t + ((e - t) >> min(l, 1))) >> max(l - 1, 0)
  // where t = umulhi(e, mul), for every 32-bit e
  int l = 0;
  while (k > 0 && (1LL << l) < k) ++l;
  const Divisor kdiv{
      (unsigned)(((1ULL << 32) * ((1ULL << l) - (unsigned long long)k)) /
                     (unsigned long long)(k > 0 ? k : 1) + 1),
      l < 1 ? l : 1, l > 1 ? l - 1 : 0};
  if (d > 0) {
    sparse_agg_kernel<<<(d + kThreads - 1) / kThreads, kThreads, kSmemBytes,
                        (cudaStream_t)stream>>>(vals, idx, weights, out, m, k,
                                                d, kdiv);
  }
  return (int)cudaGetLastError();
}
