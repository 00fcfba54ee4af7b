// RMSNorm over the rows of an (N, d) matrix, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm
// (_rms_kernel).  Contract: src/repro/kernels/ref.py::rmsnorm_ref, which is
// src/repro/models/layers.py::rms_norm line for line --
//   out = x * rsqrt(mean(x^2) + eps) * (1 + w),
// computed in float32 from x and w of either type, the result in x's type
// (float32 or bfloat16, rounded to nearest even).  Any N, unlike the TPU
// kernel's N % block_rows == 0: the decode path normalises N = batch rows.
//
// What bounds it here: bytes.  Each element is read, squared and summed,
// then read again, scaled and written: a few operations per 2-byte element,
// far below the card's ~20 float32 operations per byte of HBM.  At the
// model's prefill shape, (4096, 5376) bf16, x in and out is 88 MB, 0.026 ms
// at 3.35 TB/s.
//
// Design: one CTA per row, as the TPU kernel keeps a row tile whole in VMEM.
// Pass 1 sums x^2 in float32 (16-byte loads where the row allows them), a
// warp-shuffle tree and a shared-memory sum across the warps; pass 2 reads
// the row again (from L1/L2: a 5376-wide bf16 row is 10.5 KB) and writes it
// scaled.  The sum is taken in another order than the plain version's, so
// the two agree to float32 rounding before the cast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename TX, typename TW, bool kVector>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
               TX* __restrict__ out, int d, float eps) {
  __shared__ float partial[kWarps];
  __shared__ float scale_s;
  const size_t row = blockIdx.x;
  const TX* xr = x + row * (size_t)d;
  TX* orow = out + row * (size_t)d;
  constexpr int kN = 16 / sizeof(TX);  // elements per 16-byte load

  float ss = 0.f;
  if (kVector) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = threadIdx.x; i < d / kN; i += kThreads) {
      const uint4 a = xv[i];
      const TX* av = reinterpret_cast<const TX*>(&a);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const float f = to_float(av[j]);
        ss = fmaf(f, f, ss);
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float f = to_float(xr[i]);
      ss = fmaf(f, f, ss);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) total += partial[i];
    scale_s = rsqrtf(total / (float)d + eps);
  }
  __syncthreads();
  const float r = scale_s;

  if (kVector) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* ov = reinterpret_cast<uint4*>(orow);
    for (int i = threadIdx.x; i < d / kN; i += kThreads) {
      const uint4 a = xv[i];
      const TX* av = reinterpret_cast<const TX*>(&a);
      uint4 o;
      TX* op = reinterpret_cast<TX*>(&o);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const float wj = 1.f + to_float(w[i * kN + j]);
        op[j] = from_float<TX>(to_float(av[j]) * r * wj);
      }
      ov[i] = o;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float wi = 1.f + to_float(w[i]);
      orow[i] = from_float<TX>(to_float(xr[i]) * r * wi);
    }
  }
}

template <typename TX, typename TW>
int launch_typed(const void* x, const void* w, void* out, int n, int d,
                 float eps, int vector, cudaStream_t stream) {
  const dim3 grid(n);
  if (vector)
    rmsnorm_kernel<TX, TW, true><<<grid, kThreads, 0, stream>>>(
        (const TX*)x, (const TW*)w, (TX*)out, d, eps);
  else
    rmsnorm_kernel<TX, TW, false><<<grid, kThreads, 0, stream>>>(
        (const TX*)x, (const TW*)w, (TX*)out, d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x (n, d) and out (n, d) of x_dtype, w (d,) of w_dtype; dtype codes:
// 0 float32, 1 bfloat16.  vector != 0 asks for 16-byte loads: the caller
// checks that x and out are 16-byte aligned and d a multiple of 16 bytes.
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out, int n,
                              int d, float eps, int x_dtype, int w_dtype,
                              int vector, void* stream) {
  if (n <= 0 || d <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0 && w_dtype == 0)
    return launch_typed<float, float>(x, w, out, n, d, eps, vector, s);
  if (x_dtype == 0 && w_dtype == 1)
    return launch_typed<float, __nv_bfloat16>(x, w, out, n, d, eps, vector, s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch_typed<__nv_bfloat16, float>(x, w, out, n, d, eps, vector, s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(x, w, out, n, d, eps,
                                                      vector, s);
  return (int)cudaErrorInvalidValue;
}
