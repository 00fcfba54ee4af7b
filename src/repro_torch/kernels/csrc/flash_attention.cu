// Flash attention (online softmax; causal and sliding window) for Hopper
// (sm_90a), on the model's (B, S, H, Dh) layout with grouped kv heads.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (_fa_kernel), reached through src/repro/kernels/ops.py::
// attention_bshd.  Contract: src/repro/kernels/ref.py::flash_attention_ref,
// which is src/repro/models/attention.py::reference_attention at
// q_offset = 0 --
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, g] / sqrt(Dh)) v[b, j, g]
// over the keys j that the mask keeps (j < S; j <= i when causal; j > i - W
// when the window W > 0), with g = h / (H / Hkv) the query head's kv head.
// Masked logits take the finite -1e30 and the denominator max(l, 1e-30), as
// the TPU kernel has them, so no row gives NaN.  Logits, the running max,
// sum-exp and accumulator are float32; q, k, v and out are float32 or
// bfloat16 (out in q's type, rounded to nearest even).  Any S: the last
// tiles are masked, where the TPU kernel asserts S % block == 0.
//
// What bounds it on this card: operations.  A global causal layer of the
// gemma3-27b prefill (S = 4096, H = 32, Dh = 128) is 137 GFLOP against 100
// MB of q, k, v and out.  This first kernel is SIMT float32 (67 TFLOP/s at
// the most); the card's bf16 tensor cores (989 TFLOP/s through wgmma, fed by
// TMA) are the later redesign.
//
// Design.  One CTA of 256 threads per (64-query tile, query head, batch),
// the heaviest causal tiles launched first.  The query tile and one 64-key
// tile live in shared memory as float32 (rows padded to Dh + 4 floats so
// 16-byte reads by neighbouring threads fall in distinct banks); K and then
// V take the same buffer in turn, and the probabilities a (64, 64) tile of
// their own: 85 KB at Dh = 128, two CTAs an SM.  The CTA walks only the key
// tiles the causal and window masks leave visible (the TPU kernel's
// pl.when skip, done by bounds instead of a test per grid step).  Thread
// (ty, tx) of a 16 x 16 grid owns query rows 4ty..4ty+3: it computes their
// logits against keys tx + 16j (j < 4), keeps their running max and sum-exp
// (each row's 16 threads reduce by xor shuffles), and accumulates their
// output columns 4tx + 64g.. (Dh / 16 columns a row) from the probabilities
// and V in shared memory.  kv head g is read in place: repeat_kv is never
// materialised.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;  // queries and keys per tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store4(float* dst, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float a, float b,
                                       float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = packed;
}

// Rows row0 .. row0 + 63 of one head (row stride `stride` elements) into a
// float32 tile of row stride D + 4; rows at or past S read as zeros, so a
// masked key's V row is 0 and never NaN.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ base,
                                          long stride, int row0, int S,
                                          float* tile) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < kTile * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    float* dst = tile + r * (D + 4) + c;
    if (row0 + r < S) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(base + (long)(row0 + r) * stride + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; j += 4)
        store4(dst + j, to_float(e[j]), to_float(e[j + 1]),
               to_float(e[j + 2]), to_float(e[j + 3]));
    } else {
#pragma unroll
      for (int j = 0; j < kVec; j += 4) store4(dst + j, 0.f, 0.f, 0.f, 0.f);
    }
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kTile * (D + 4) + kTile * (kTile + 4));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int S, int H,
             int Hkv, int causal, int window, float scale) {
  constexpr int kS = D + 4;       // row stride of the Q and K/V tiles
  constexpr int kP = kTile + 4;   // row stride of the probability tile
  constexpr int kGroups = D / 64; // float4 column groups a thread owns
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* KVs = Qs + kTile * kS;
  float* Ps = KVs + kTile * kS;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / Hkv);
  const int q0 = qt * kTile;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;

  const long q_stride = (long)H * D;
  const long kv_stride = (long)Hkv * D;
  const T* qb = q + ((long)b * S * H + h) * D;
  const T* kb = k + ((long)b * S * Hkv + g) * D;
  const T* vb = v + ((long)b * S * Hkv + g) * D;

  // the key tiles any row of this query tile can see
  const int q_last = min(q0 + kTile, S) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_last = causal ? q_last : S - 1;
  const int kt_first = k_first / kTile;
  const int kt_last = k_last / kTile;

  load_tile<T, D>(qb, q_stride, q0, S, Qs);

  float m[4], l[4], acc[4][4 * kGroups];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kGroups; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last tile's V and P reads are done
    load_tile<T, D>(kb, kv_stride, k0, S, KVs);
    __syncthreads();

    // logits of rows 4ty + i against keys tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qf[4], kf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qf[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * kS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kf[j] = *reinterpret_cast<const float4*>(KVs + (tx + 16 * j) * kS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qf[i].x, kf[j].x, s[i][j]);
          s[i][j] = fmaf(qf[i].y, kf[j].y, s[i][j]);
          s[i][j] = fmaf(qf[i].z, kf[j].z, s[i][j]);
          s[i][j] = fmaf(qf[i].w, kf[j].w, s[i][j]);
        }
    }

    // mask, online softmax, probabilities to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool keep = kpos < S;
        if (causal) keep = keep && kpos <= qpos;
        if (window > 0) keep = keep && kpos > qpos - window;
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kGroups; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * kP + tx + 16 * j] = s[i][j];
    }

    __syncthreads();  // every K read is done: V takes the buffer
    load_tile<T, D>(vb, kv_stride, k0, S, KVs);
    __syncthreads();

    // acc[rows 4ty + i][columns 64gr + 4tx + e] += P . V
#pragma unroll 2
    for (int c = 0; c < kTile; c += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * kP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vr = KVs + (c + cc) * kS + tx * 4;
        float4 v4[kGroups];
#pragma unroll
        for (int gr = 0; gr < kGroups; ++gr)
          v4[gr] = *reinterpret_cast<const float4*>(vr + 64 * gr);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = cc == 0   ? p4[i].x
                          : cc == 1 ? p4[i].y
                          : cc == 2 ? p4[i].z
                                    : p4[i].w;
#pragma unroll
          for (int gr = 0; gr < kGroups; ++gr) {
            acc[i][4 * gr + 0] = fmaf(p, v4[gr].x, acc[i][4 * gr + 0]);
            acc[i][4 * gr + 1] = fmaf(p, v4[gr].y, acc[i][4 * gr + 1]);
            acc[i][4 * gr + 2] = fmaf(p, v4[gr].z, acc[i][4 * gr + 2]);
            acc[i][4 * gr + 3] = fmaf(p, v4[gr].w, acc[i][4 * gr + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = out + (((long)b * S + qpos) * H + h) * D + tx * 4;
#pragma unroll
    for (int gr = 0; gr < kGroups; ++gr)
      store4(orow + 64 * gr, acc[i][4 * gr + 0] / den,
             acc[i][4 * gr + 1] / den, acc[i][4 * gr + 2] / den,
             acc[i][4 * gr + 3] / den);
  }
}

template <typename T, int D>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 int B, int S, int H, int Hkv, int causal, int window,
                 cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  const float scale = 1.0f / sqrtf((float)D);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, H, Hkv, causal,
      window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out (B, S, H, D) and k, v (B, S, Hkv, D), contiguous and 16-byte
// aligned, all of one dtype (0 float32, 1 bfloat16); D is 64 or 128 and
// H a multiple of Hkv.  window 0 means no sliding window.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int Hkv, int D, int causal,
                                      int window, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaGetLastError();
  if (Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && D == 64)
    return launch_typed<float, 64>(q, k, v, out, B, S, H, Hkv, causal, window,
                                   s);
  if (dtype == 0 && D == 128)
    return launch_typed<float, 128>(q, k, v, out, B, S, H, Hkv, causal,
                                    window, s);
  if (dtype == 1 && D == 64)
    return launch_typed<__nv_bfloat16, 64>(q, k, v, out, B, S, H, Hkv, causal,
                                           window, s);
  if (dtype == 1 && D == 128)
    return launch_typed<__nv_bfloat16, 128>(q, k, v, out, B, S, H, Hkv,
                                            causal, window, s);
  return (int)cudaErrorInvalidValue;
}
