// Per-coordinate ascending sort over the workers, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/robust_agg.py::sort_workers_fused
// (_rowsort_kernel, _bitonic_sort_cols), the sort behind trimmed_mean_fused
// and coordinate_median_fused.  Contract: torch.sort(x, dim=0,
// stable=True).values bit for bit, which is jnp.sort(x, axis=0): ascending,
// NaN after every number, equal values (+0.0 and -0.0 among them) in worker
// order, and the output copies the input's bits (NaN payloads, the sign of
// zero).  The TPU kernel's bitonic network sorts the values themselves, so
// it puts +0.0 and -0.0 in either order; this one sorts unique keys.
//
// What bounds it here: bytes in principle -- the stack is read once and
// written once, 8·m·d bytes -- but at the reference's model-scale stacks
// ((128, 1,000,000) is 512 MB) the network's m·log²m compares a column on
// 64-bit keys take more issue slots than the bytes take time: each
// compare-and-swap is two 64-bit compares and four selects.  So the design
// keeps HBM streaming while the compares run, spends no memory traffic on
// them, and keeps the keys in registers.
//
// Design: one CTA per tile of T columns, T = 256 / L (at least one; L
// threads a column, below); sort_plan states the same rule.
// * Load once.  The (m, T) slab comes from HBM by cp.async into shared
//   memory, each warp's request covering whole rows of the tile: 16-byte
//   copies where d % 4 == 0 and the swizzle below keeps 4-word groups
//   whole (P <= 128), 4-byte ones otherwise.  Several CTAs fit an SM, so
//   one CTA's load overlaps another's sort.
// * Unique keys.  Each value maps to an orderable 32-bit word (±0 to one
//   word, every NaN to one word above +inf), joined with the worker index
//   into a 64-bit key.  Keys are unique, so any network gives the stable
//   order.  Rows pad to a power of two P with all-ones keys, which sort
//   after every real key, NaN's included.
// * Sort in registers.  A column's P keys sit in L threads, E consecutive
//   keys each (E = 16; P itself up to 16; 32 from P = 4096).  The network
//   is bitonic with every compare ascending (each merge first compares i
//   with its mirror i ^ (k - 1), then i with i ^ j), its stages unrolled
//   at compile time: partners within a thread swap in registers, partners
//   in another lane of the warp come by shuffles, and only the widest
//   stages, for P > 512 where a column spans several warps, go through
//   shared memory.
// * Write once.  Each thread gathers the input bits of its sorted keys from
//   the slab (the key's low word is the row), the slab takes them back in
//   sorted order, and the tile leaves in the same whole-row stores.
// The slab's words are XOR-swizzled by the key-owning lane, so the key
// loads and the sorted write-back hit 32 distinct banks.
// Limit: P <= 16384 (m <= 16384): the slab and the cross-warp key buffer of
// one column then take 192 KB of the 227 KB a block may hold.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPad = 16384;
constexpr unsigned long long kPad = ~0ull;  // after every real key

template <int P>
struct Layout {
  static constexpr int E = P <= 16 ? P : (P < 4096 ? 16 : 32);  // keys a thread
  static constexpr int L = P / E;                 // threads a column
  static constexpr int LW = L < 32 ? L : 32;      // of them in one warp
  static constexpr int WC = 32 / LW;              // columns a warp
  static constexpr int T = (L > 256 ? L : 256) / L;  // columns a CTA
  static constexpr int THREADS = T * L;
  // the slab's words XOR-swizzled by the lane owning the row's key, when a
  // 32-word swizzle block holds whole rows of one lane's keys
  static constexpr bool SWZ = E * T % 32 == 0;
  // 16-byte copies where a swizzle keeps 4-word groups whole
  static constexpr bool VEC = T >= 4 && (!SWZ || WC >= 4);
};

// word of (row r, column c) in the slab
template <int P>
__device__ __forceinline__ unsigned slab_at(unsigned r, unsigned c) {
  using C = Layout<P>;
  const unsigned w = r * C::T + c;
  return C::SWZ ? w ^ (((r / C::E) & (C::LW - 1)) * C::WC) : w;
}

// the value's place in torch.sort's order as an unsigned word: ±0 one word,
// every NaN one word above +inf
__device__ __forceinline__ uint32_t order_word(uint32_t u) {
  const uint32_t a = u & 0x7fffffffu;
  if (a > 0x7f800000u) return 0xffffffffu;
  if (a == 0u) return 0x80000000u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// a, b <- min, max (ptxas makes each a 64-bit compare and two selects)
__device__ __forceinline__ void cas(unsigned long long& a,
                                    unsigned long long& b) {
  const bool swap = b < a;
  const unsigned long long lo = swap ? b : a;
  b = swap ? a : b;
  a = lo;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// one network stage through shared memory, for partners in another warp:
// each key meets the key of lane l ^ lmask, in register e (or E-1-e on a
// mirror stage); the lower index keeps the smaller.  Laid out [e][l], so a
// warp's 32 lanes touch 32 consecutive keys.
template <int E, int L>
__device__ __forceinline__ void smem_stage(unsigned long long (&key)[E],
                                           unsigned long long* xbuf, int cl,
                                           int l, int lmask, bool lower,
                                           bool mirror) {
#pragma unroll
  for (int e = 0; e < E; ++e) xbuf[(cl * E + e) * L + l] = key[e];
  __syncthreads();
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int pe = mirror ? E - 1 - e : e;
    const unsigned long long o = xbuf[(cl * E + pe) * L + (l ^ lmask)];
    if ((o < key[e]) == lower) key[e] = o;
  }
  __syncthreads();
}

// the stages of the network, K and J known at compile time: each merge of
// blocks of K first compares i with its mirror i ^ (K - 1), then i with
// i ^ J for J = K/4 .. 1; the lower index keeps the smaller key
template <int P, int J>
__device__ __forceinline__ void xor_stage(unsigned long long (&key)[Layout<P>::E],
                                          unsigned long long* xbuf, int cl,
                                          int l) {
  using C = Layout<P>;
  constexpr int E = C::E;
  if constexpr (J < E) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if ((e & J) == 0) cas(key[e], key[e | J]);
    }
  } else if constexpr (J < E * C::LW) {
    const bool lower = (l & (J / E)) == 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const unsigned long long o =
          __shfl_xor_sync(0xffffffffu, key[e], (J / E) * C::WC);
      if ((o < key[e]) == lower) key[e] = o;
    }
  } else {
    smem_stage<E, C::L>(key, xbuf, cl, l, J / E, (l & (J / E)) == 0, false);
  }
}

template <int P, int K>
__device__ __forceinline__ void mirror_stage(
    unsigned long long (&key)[Layout<P>::E], unsigned long long* xbuf, int cl,
    int l) {
  using C = Layout<P>;
  constexpr int E = C::E;
  if constexpr (K <= E) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (e < (e ^ (K - 1))) cas(key[e], key[e ^ (K - 1)]);
    }
  } else if constexpr (K <= E * C::LW) {
    const bool lower = (l & (K / (2 * E))) == 0;
#pragma unroll
    for (int e = 0; e < E / 2; ++e) {
      // the partner lane's key E-1-e meets this lane's key e, and the
      // other way round
      const unsigned long long a =
          __shfl_xor_sync(0xffffffffu, key[E - 1 - e], (K / E - 1) * C::WC);
      const unsigned long long b =
          __shfl_xor_sync(0xffffffffu, key[e], (K / E - 1) * C::WC);
      if ((a < key[e]) == lower) key[e] = a;
      if ((b < key[E - 1 - e]) == lower) key[E - 1 - e] = b;
    }
  } else {
    smem_stage<E, C::L>(key, xbuf, cl, l, K / E - 1,
                        (l & (K / (2 * E))) == 0, true);
  }
}

template <int P, int J>
__device__ __forceinline__ void cleaners(unsigned long long (&key)[Layout<P>::E],
                                         unsigned long long* xbuf, int cl,
                                         int l) {
  if constexpr (J >= 1) {
    xor_stage<P, J>(key, xbuf, cl, l);
    cleaners<P, J / 2>(key, xbuf, cl, l);
  }
}

template <int P, int K>
__device__ __forceinline__ void merges(unsigned long long (&key)[Layout<P>::E],
                                       unsigned long long* xbuf, int cl,
                                       int l) {
  if constexpr (K <= P) {
    mirror_stage<P, K>(key, xbuf, cl, l);
    cleaners<P, K / 4>(key, xbuf, cl, l);
    merges<P, 2 * K>(key, xbuf, cl, l);
  }
}

// a tile's slab, from x (load, by cp.async) or to out (store): whole rows
// of the tile a warp request
template <int P, bool LOAD>
__device__ __forceinline__ void move_slab(uint32_t* slab, const float* x,
                                          float* out, int m, int d, int c0,
                                          bool vec) {
  using C = Layout<P>;
  constexpr int T = C::T;
  const int tid = threadIdx.x;
  if (C::VEC && vec) {
    constexpr int TV = T >= 4 ? T / 4 : 1, STEP = C::THREADS / TV;
    const int c = 4 * (tid % TV);
    if (c0 + c >= d) return;
#pragma unroll 4
    for (int r = tid / TV; r < m; r += STEP) {
      uint32_t* s = &slab[slab_at<P>(r, c)];
      const size_t g = (size_t)r * d + c0 + c;
      if (LOAD) {
        cp_async16(s, x + g);
      } else {
        *reinterpret_cast<uint4*>(out + g) = *reinterpret_cast<const uint4*>(s);
      }
    }
  } else {
    constexpr int STEP = C::THREADS / T;
    const int c = tid % T;
    if (c0 + c >= d) return;
#pragma unroll 4
    for (int r = tid / T; r < m; r += STEP) {
      uint32_t* s = &slab[slab_at<P>(r, c)];
      const size_t g = (size_t)r * d + c0 + c;
      if (LOAD) {
        cp_async4(s, x + g);
      } else {
        reinterpret_cast<uint32_t*>(out)[g] = *s;
      }
    }
  }
}

template <int P>
__global__ void __launch_bounds__(Layout<P>::THREADS)
sort_workers_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int m, int d, int vec) {
  using C = Layout<P>;
  constexpr int E = C::E, L = C::L, WC = C::WC, T = C::T;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* slab = reinterpret_cast<uint32_t*>(smem);
  unsigned long long* xbuf = reinterpret_cast<unsigned long long*>(
      smem + 4 * ((m * T + 31) & ~31));

  const int tid = threadIdx.x, lane = tid & 31;
  int cl, l;  // the column in the tile, the lane in the column
  if (L <= 32) {
    cl = (tid >> 5) * WC + lane % WC;
    l = lane / WC;
  } else {
    cl = tid / L;
    l = tid % L;
  }
  const int c0 = blockIdx.x * T;
  move_slab<P, true>(slab, x, out, m, d, c0, vec);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // rows past m read row m - 1 and take the padding key: no branches
  unsigned long long key[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int r = l * E + e;
    const uint32_t u = slab[slab_at<P>(min(r, m - 1), cl)];
    key[e] = r < m ? ((unsigned long long)order_word(u) << 32) | (unsigned)r
                   : kPad;
  }

  merges<P, 2>(key, xbuf, cl, l);

  // the input bits of each sorted key, back into the slab in sorted order
  uint32_t val[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    val[e] = slab[slab_at<P>(min((uint32_t)key[e], (uint32_t)(m - 1)), cl)];
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int p = l * E + e;
    if (p < m) slab[slab_at<P>(p, cl)] = val[e];
  }
  __syncthreads();
  move_slab<P, false>(slab, x, out, m, d, c0, vec);
}

// let a kernel take dyn bytes of dynamic shared memory (past 48 KB only
// when asked)
template <class K>
cudaError_t allow_smem(K kernel, size_t dyn) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
}

template <int P>
int launch(const float* x, float* out, int m, int d, int tile,
           cudaStream_t stream) {
  using C = Layout<P>;
  if (tile != C::T) return (int)cudaErrorInvalidValue;
  const size_t smem = 4 * (size_t)((m * C::T + 31) & ~31) +
                      (C::L > 32 ? 8 * (size_t)P * C::T : 0);
  const cudaError_t err = allow_smem(sort_workers_kernel<P>, smem);
  if (err != cudaSuccess) return (int)err;
  // whole 16-byte groups: rows and the stack 16-byte aligned
  const int vec = d % 4 == 0 && ((uintptr_t)x & 15) == 0 &&
                  ((uintptr_t)out & 15) == 0;
  const unsigned grid = (unsigned)((d + C::T - 1) / C::T);
  sort_workers_kernel<P><<<grid, C::THREADS, smem, stream>>>(x, out, m, d,
                                                             vec);
  return (int)cudaGetLastError();
}

}  // namespace

// tile: columns a CTA, sort_plan's (the kernel's own for P, the next power
// of two ≥ max(m, 2); any other is refused)
extern "C" int sort_workers_launch(const float* x, float* out, int m, int d,
                                   int tile, void* stream) {
  if (m <= 0 || d <= 0) return (int)cudaSuccess;
  if (m > kMaxPad) return (int)cudaErrorInvalidValue;
  int P = 2;
  while (P < m) P <<= 1;
  cudaStream_t s = (cudaStream_t)stream;
  switch (P) {
    case 2: return launch<2>(x, out, m, d, tile, s);
    case 4: return launch<4>(x, out, m, d, tile, s);
    case 8: return launch<8>(x, out, m, d, tile, s);
    case 16: return launch<16>(x, out, m, d, tile, s);
    case 32: return launch<32>(x, out, m, d, tile, s);
    case 64: return launch<64>(x, out, m, d, tile, s);
    case 128: return launch<128>(x, out, m, d, tile, s);
    case 256: return launch<256>(x, out, m, d, tile, s);
    case 512: return launch<512>(x, out, m, d, tile, s);
    case 1024: return launch<1024>(x, out, m, d, tile, s);
    case 2048: return launch<2048>(x, out, m, d, tile, s);
    case 4096: return launch<4096>(x, out, m, d, tile, s);
    case 8192: return launch<8192>(x, out, m, d, tile, s);
    default: return launch<16384>(x, out, m, d, tile, s);
  }
}
