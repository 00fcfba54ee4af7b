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
// MB of q, k, v and out.  Two routes, chosen by dtype inside the one entry
// point, each for Dh in {64, 128, 256}:
//
// bf16 -- the tensor cores (flash_kernel_tc).  One CTA of three warpgroups
// per (128-query tile, query head, batch), the heaviest causal tiles first:
// warpgroup 0 is the producer, one thread of which brings Q once and then
// each visible K and V tile by TMA (128-byte swizzle, a 64-column box per
// 128 bytes of a row, rows past S filled with zeros) into a ring of two
// stages, mbarriers signalling arrival (full) and release (empty);
// warpgroups 1 and 2 each own 64 query rows.  A consumer computes
// S = Q.K^T with wgmma m64nNk16 (both operands in shared memory, K-major),
// masks and runs the online softmax in float32 registers in the
// accumulator's layout (a row lives in a quad of threads: max and sum by
// two xor shuffles), then O += P.V with P from registers and V in shared
// memory (transposed, MN-major).  The contract's probabilities are
// float32, so P goes in as two bf16 halves, P_hi = bf16(P) and
// P_lo = bf16(P - P_hi), two wgmmas into one accumulator: the product
// then carries about 2^-17 of P's relative error, not bf16's 2^-9, for
// 1.5x the tensor work of the function.  The epilogue divides by
// max(l, 1e-30), rounds to nearest-even bf16, stages the tile in the
// warpgroup's own (now dead) Q buffer and stores 16 bytes a thread.
// Keys a tile: 128 at Dh 64 and 128, 64 at Dh 256.  Registers a consumer
// thread (setmaxnreg: the producer drops to 24, the consumers rise to 240;
// 384 threads launch at 168): O accumulator Dh / 2 floats, S kN / 2, P as
// bf16 pairs 2 * kN / 4 -- Dh 64: 32 + 64 + 64, Dh 128: 64 + 64 + 64,
// Dh 256: 128 + 32 + 32, plus about 30 for addresses and statistics.
// Shared memory: Q 2 * 64 * Dh * 2 bytes, two stages of K and V at
// kN * Dh * 2 bytes each: 80, 160 and 192 KB, one CTA an SM.  kv head g
// is read in place by the tensor map's head coordinate.
//
// float32 -- SIMT (flash_kernel): the tensor cores take float32 only as
// TF32, which cannot meet the float32 contract.  One CTA of 256 threads
// per (64-query tile, query head, batch), the heaviest causal tiles
// launched first.  The query tile and one 64-key tile live in shared
// memory as float32 (rows padded to Dh + 4 floats so 16-byte reads by
// neighbouring threads fall in distinct banks); K and then V take the same
// buffer in turn, and the probabilities a (64, 64) tile of their own: 85
// KB at Dh = 128, two CTAs an SM (150 KB and one at Dh = 256).  Thread
// (ty, tx) of a 16 x 16 grid owns query rows 4ty..4ty+3: it computes their
// logits against keys tx + 16j (j < 4), keeps their running max and
// sum-exp (each row's 16 threads reduce by xor shuffles), and accumulates
// their output columns 4tx + 64g.. (Dh / 16 columns a row) from the
// probabilities and V in shared memory.
//
// Both walk only the key tiles that the causal and window masks leave
// visible to some row of the query tile (the TPU kernel's pl.when skip,
// done by bounds instead of a test per grid step), and read kv head g in
// place: repeat_kv is never materialised.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run
                   // time (cudaGetDriverEntryPoint), so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;  // queries and keys per tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float v) { return v; }

__device__ __forceinline__ void store4(float* dst, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
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

// At D = 256 the tiles take 150,528 bytes, so one CTA fits an SM and the
// register cap that a second CTA would impose only causes spills.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, D == 256 ? 1 : 2)
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

namespace {
namespace tc {

constexpr int kRows = 64;                     // query rows a consumer owns
constexpr int kConsumers = 2;                 // consumer warpgroups a CTA
constexpr int kQTile = kRows * kConsumers;    // query rows a CTA
constexpr int kThreadsTC = 128 * (1 + kConsumers);
constexpr int kStages = 2;                    // the K/V ring
constexpr int kBox = 64;                      // bf16 columns in 128 bytes
constexpr int kBoxRowBytes = 128;
constexpr int kRegion = kRows * kBoxRowBytes; // one 64 x 64 Q box: 8 KB
constexpr float kNegInf = -1e30f;

template <int D>
struct Cfg {
  static constexpr int kN = D == 256 ? 64 : 128;  // keys a tile
  static constexpr int kChunks = D / kBox;        // 64-column boxes a row
  static constexpr int kQBytes = kConsumers * kRows * D * 2;
  static constexpr int kKVBytes = kN * D * 2;     // one K or V tile
  static constexpr int kBarBytes = 8 * (1 + 2 * kStages);
  // + 1024: the dynamic base is rounded up to the swizzle's 1024 bytes
  static constexpr int kSmem =
      kQBytes + 2 * kStages * kKVBytes + kBarBytes + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed.
// A wait of more than 2^34 cycles (about 9 s) can only be a lost arrival:
// trap, so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// One box (64 columns x rows) of a (D, heads, S, B) bf16 map into shared
// memory at dst, completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile (base 1024-
// byte aligned): start address, leading and stride byte offsets in 16-byte
// units, layout 1 (128-byte swizzle).  K-major (Q, K): SBO = 1024 (eight
// 128-byte rows), LBO unused; a step of 16 columns adds 32 bytes to the
// start.  MN-major (V): LBO = the stride between 64-column boxes, SBO =
// 1024 (eight keys).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin an accumulator across an asynchronous wgmma: no instruction that
// touches it may move across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC4(i) \
  "+f"(d[i]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define ACC16(i) ACC4(i), ACC4((i) + 4), ACC4((i) + 8), ACC4((i) + 12)
#define ACC32 ACC16(0), ACC16(16)
#define ACC64 ACC32, ACC16(32), ACC16(48)
#define ACC128 ACC64, ACC16(64), ACC16(80), ACC16(96), ACC16(112)

#define WGMMA_D32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"
#define WGMMA_D64                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define WGMMA_D128                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"  \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "   \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "   \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "   \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, " \
  "%124, %125, %126, %127}"

// d (=, or += when scale_d) A.B^T, m64nNk16, bf16 in, float32 out: A (64 x
// 16) and B (N x 16) in shared memory, both K-major.  S = Q.K^T.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32
      : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC64
      : "l"(a), "l"(b), "r"(scale_d));
}

// d += A.B, m64nNk16: A (64 x 16 bf16) from registers in the mma fragment
// layout, B (16 x N) in shared memory, MN-major (transposed).  O += P.V.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " WGMMA_D128
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : ACC128
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

template <int D>
__global__ void __launch_bounds__(kThreadsTC, 1)
flash_kernel_tc(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                __nv_bfloat16* __restrict__ out, int S, int H, int Hkv,
                int causal, int window, float scale_log2) {
  using C = Cfg<D>;
  constexpr int kN = C::kN;
  constexpr int kChunks = C::kChunks;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t q_s = smem_u32(smem);
  const uint32_t k_s = q_s + C::kQBytes;
  const uint32_t v_s = k_s + kStages * C::kKVBytes;
  const uint32_t q_bar = v_s + kStages * C::kKVBytes;
  const uint32_t full0 = q_bar + 8;              // full[s] = full0 + 8 s
  const uint32_t empty0 = full0 + 8 * kStages;   // empty[s] = empty0 + 8 s

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / Hkv);
  const int q0 = qt * kQTile;
  // the key tiles any row of this query tile can see
  const int q_last = min(q0 + kQTile, S) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_last = causal ? q_last : S - 1;
  const int kt_first = k_first / kN;
  const int n_tiles = k_last / kN - kt_first + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_bar, C::kQBytes);
      for (int w = 0; w < kConsumers; ++w)
        for (int c = 0; c < kChunks; ++c)
          tma_load(q_s + (w * kChunks + c) * kRegion, &q_map, q_bar, c * kBox,
                   h, q0 + w * kRows, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        mbar_wait(empty0 + 8 * s, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, 2 * C::kKVBytes);
        const int k0 = (kt_first + i) * kN;
        for (int c = 0; c < kChunks; ++c) {
          const uint32_t off = s * C::kKVBytes + c * kN * kBoxRowBytes;
          tma_load(k_s + off, &k_map, full0 + 8 * s, c * kBox, g, k0, b);
          tma_load(v_s + off, &v_map, full0 + 8 * s, c * kBox, g, k0, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int wq_lo = q0 + cw * kRows;          // this warpgroup's rows
    const int wq_hi = min(wq_lo + kRows, S) - 1;
    const int wk_first = window > 0 ? max(0, wq_lo - window + 1) : 0;
    const int wk_last = causal ? wq_hi : S - 1;
    // accumulator layout: value i of a thread sits at row r0 + 8 ((i/2)%2)
    // and column 8 (i/4) + 2 (lane%4) + i%2 of the 64-row tile
    const int r0 = wq_lo + 16 * warp + lane / 4;
    const int c0 = 2 * (lane % 4);
    const uint32_t qa = q_s + cw * kChunks * kRegion;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};

    mbar_wait(q_bar, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const int k0 = (kt_first + i) * kN;
      mbar_wait(full0 + 8 * s, (i / kStages) & 1);
      if (wq_lo <= wq_hi && k0 <= wk_last && k0 + kN - 1 >= wk_first) {
        const uint32_t ks = k_s + s * C::kKVBytes;
        const uint32_t vs = v_s + s * C::kKVBytes;
        float sc[kN / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk / 4) * kRegion + (kk % 4) * 32;
          const uint32_t koff =
              (kk / 4) * kN * kBoxRowBytes + (kk % 4) * 32;
          wgmma_ss(sc, desc_sw128(qa + off, 16, 1024),
                   desc_sw128(ks + koff, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // scale (log2 domain), mask, online softmax
        const bool edge = k0 + kN > S || (causal && k0 + kN - 1 > wq_lo) ||
                          (window > 0 && k0 < wq_hi - window + 1);
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < kN / 2; ++j) {
          float x = sc[j] * scale_log2;
          if (edge) {
            const int kpos = k0 + 8 * (j / 4) + c0 + (j % 2);
            const int qpos = r0 + 8 * ((j / 2) % 2);
            bool keep = kpos < S;
            if (causal) keep = keep && kpos <= qpos;
            if (window > 0) keep = keep && kpos > qpos - window;
            x = keep ? x : kNegInf;
          }
          sc[j] = x;
          mx[(j / 2) % 2] = fmaxf(mx[(j / 2) % 2], x);
        }
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          corr[r] = exp2f(m[r] - mx[r]);
          m[r] = mx[r];
          l[r] *= corr[r];
        }
#pragma unroll
        for (int j = 0; j < kN / 2; ++j) {
          sc[j] = exp2f(sc[j] - m[(j / 2) % 2]);
          l[(j / 2) % 2] += sc[j];
        }
#pragma unroll
        for (int j = 0; j < D / 2; ++j) o[j] *= corr[(j / 2) % 2];

        // P as two bf16 halves in the A fragment layout: register q of
        // key chunk j holds columns 16 j + 8 (q / 2) + c0 + {0, 1} of row
        // r0 + 8 (q % 2), which are S's values 8 j + 2 q and 8 j + 2 q + 1
        uint32_t p_hi[kN / 16][4], p_lo[kN / 16][4];
#pragma unroll
        for (int j = 0; j < kN / 16; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float a = sc[8 * j + 2 * q], c = sc[8 * j + 2 * q + 1];
            const __nv_bfloat162 hi = __floats2bfloat162_rn(a, c);
            const float2 hf = __bfloat1622float2(hi);
            p_hi[j][q] = *reinterpret_cast<const uint32_t*>(&hi);
            p_lo[j][q] = pack_bf16(a - hf.x, c - hf.y);
          }
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kN / 16; ++j) {
          const uint64_t vd =
              desc_sw128(vs + j * 16 * kBoxRowBytes, kN * kBoxRowBytes, 1024);
          wgmma_rs(o, p_hi[j], vd);
          wgmma_rs(o, p_lo[j], vd);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
      }
      mbar_arrive(empty0 + 8 * s);
    }

    // epilogue: O / max(l, 1e-30) -> bf16, staged in this warpgroup's Q
    // buffer (same swizzle), then 16 bytes a thread to out
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    uint8_t* stage = smem + cw * kChunks * kRegion;
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw));  // Q reads are done
#pragma unroll
    for (int j = 0; j < D / 2; j += 2) {
      const int row = 16 * warp + lane / 4 + 8 * ((j / 2) % 2);
      const int col = 8 * (j / 4) + c0;
      const int grp = (col % kBox) / 8;
      uint32_t* dst = reinterpret_cast<uint32_t*>(
          stage + (col / kBox) * kRegion + row * kBoxRowBytes +
          ((grp ^ (row % 8)) * 16) + (col % 8) * 2);
      *dst = pack_bf16(o[j] * inv[(j / 2) % 2], o[j + 1] * inv[(j / 2) % 2]);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw));
    constexpr int kGroups = D / 8;  // 16-byte groups a row
    for (int idx = t; idx < kRows * kGroups; idx += 128) {
      const int row = idx / kGroups;
      const int grp = idx % kGroups;
      if (wq_lo + row >= S) break;
      const uint4 val = *reinterpret_cast<const uint4*>(
          stage + (grp / 8) * kRegion + row * kBoxRowBytes +
          (((grp % 8) ^ (row % 8)) * 16));
      *reinterpret_cast<uint4*>(
          out + (((long)b * S + wq_lo + row) * H + h) * D + grp * 8) = val;
    }
  }
}

#undef ACC4
#undef ACC16
#undef ACC32
#undef ACC64
#undef ACC128
#undef WGMMA_D32
#undef WGMMA_D64
#undef WGMMA_D128

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (in libcuda), looked up once through the runtime.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (B, S, heads, D) bf16 tensor as a 4-d map (D innermost), boxes of 64
// columns x `rows` rows of one head, 128-byte swizzle, rows past S read as
// zeros.
bool encode(CUtensorMap* map, const void* ptr, int B, int S, int heads, int D,
            int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBox, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int Hkv, int causal, int window,
           cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap qm, km, vm;
  if (!encode(&qm, q, B, S, H, D, kRows) ||
      !encode(&km, k, B, S, Hkv, D, C::kN) ||
      !encode(&vm, v, B, S, Hkv, D, C::kN))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kQTile - 1) / kQTile, H, B);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  flash_kernel_tc<D><<<grid, kThreadsTC, C::kSmem, stream>>>(
      qm, km, vm, (__nv_bfloat16*)out, S, H, Hkv, causal, window, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace

// q, out (B, S, H, D) and k, v (B, S, Hkv, D), contiguous and 16-byte
// aligned, all of one dtype (0 float32: SIMT; 1 bfloat16: tensor cores); D
// is 64, 128 or 256 and H a multiple of Hkv.  window 0 means no sliding
// window.
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
  if (dtype == 0 && D == 256)
    return launch_typed<float, 256>(q, k, v, out, B, S, H, Hkv, causal,
                                    window, s);
  if (dtype == 1 && D == 64)
    return tc::launch<64>(q, k, v, out, B, S, H, Hkv, causal, window, s);
  if (dtype == 1 && D == 128)
    return tc::launch<128>(q, k, v, out, B, S, H, Hkv, causal, window, s);
  if (dtype == 1 && D == 256)
    return tc::launch<256>(q, k, v, out, B, S, H, Hkv, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
