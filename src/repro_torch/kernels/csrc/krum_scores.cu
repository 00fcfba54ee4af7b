// Krum scores for Hopper (sm_90a): tiled pair distances, then a row select.
//
// Replaces the TPU kernel src/repro/kernels/robust_agg.py::krum_scores_fused
// (_krum_kernel).  Contract: src/repro/kernels/ref.py::krum_scores_ref --
// score(i) is the ascending sum of the k = max(m - n_byz - 2, 1) smallest
// d2[i, j], where d2[i, j] = sum_c (x_i[c] - x_j[c])^2 and the diagonal
// takes +1e30, as src/repro/core/aggregation.py::krum_select adds it.
// d2[i, j] and d2[j, i] are bitwise equal, as the reference's symmetric
// tile is.  Only the (m,) scores are the result; the argmin runs in
// PyTorch, as in the reference.
//
// What bounds it here: float32 operations.  The least work is 3 operations
// (difference, square, add) per coordinate of each of the m(m-1)/2
// unordered pairs; at (128, 1,000,000) that is 0.364 ms at 67 TFLOP/s,
// against 0.153 ms to read the 512 MB stack once.  The stack outgrows the
// 50 MB L2 there, so each row has to come from HBM about once, not once
// per partner.
//
// Design, two launches on the caller's stream (one when a single tile and
// a single slice hold all of d2, as at the paper's (20, 300)):
// * krum_scores_kernel_pairs.  A CTA owns a T x T tile of d2 with i <= j
//   (T = 32 or 64, krum_plan's) and one slice of the columns.  It stages
//   the two row tiles a chunk of columns at a time (64 for T = 32, 32 for
//   T = 64) into shared-memory slots, several chunks in flight, by 16-byte
//   cp.async into row-major 16-byte units XOR-swizzled by row, so the
//   compute's 16-byte loads of 4 rows hit distinct banks.  Each thread
//   keeps a 4 x 4 register block of fmaf(diff, diff, acc) and takes 4
//   columns a load.  Blocks wholly past m, and below the diagonal of a
//   diagonal tile, are skipped; the threads they free split each chunk's
//   16-byte units G ways, and the G partial blocks are added in a fixed
//   order at the end.  The tiles over a slice run side by side, so a
//   column slice comes from HBM once and its re-reads hit L2.  The split
//   S over d (krum_plan) fills whole waves of the card's resident CTAs;
//   each tile's sum for slice s goes to part[s][i][j] and, the same
//   register, to part[s][j][i].  With S = 1, part is d2 itself.  With one
//   tile and one slice, the CTA also ranks d2 (a warp a row, by counting).
// * krum_scores_kernel_select, one CTA per row i.  It adds the S partials
//   of each d2[i, j] in slice order (part[s][j][i] holds the same bits as
//   part[s][i][j], so d2[j, i] comes out bitwise equal to d2[i, j]), adds
//   1e30 on the diagonal, writes the row of d2, and ranks it in shared
//   memory in the order of torch.sort: ascending, NaN after every number,
//   ties by column, as unique 64-bit keys (the value's orderable word,
//   then the column) -- up to m = 64 by counting each key's lower keys,
//   beyond by a bitonic network.  Thread 0 sums the k lowest in ascending
//   order.
// Sums are deterministic run to run.  Float32 SIMT, not the tensor cores:
// the Gram form |x_i|^2 + |x_j|^2 - 2<x_i, x_j> cancels when Byzantine rows
// cluster, and TF32 keeps about three digits, so neither holds the 1e-5 of
// the contract.
// Limit: m <= 16384 (the select's row of values and keys, 192 KB of shared
// memory).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a pair CTA
constexpr int kR = 4;          // rows and columns of a thread's block
constexpr int kMaxM = 16384;
constexpr float kBig = 1e30f;  // krum_select's jnp.eye(m) * 1e30
constexpr unsigned long long kPad = ~0ull;

constexpr int kBatch = 16;     // partial sums a select thread loads at once
constexpr int kRankMax = 64;   // the select ranks by counting up to this m

// a staged row tile: T rows of CHUNK floats (64 for T = 32, 32 for T =
// 64), row-major in 16-byte units, unit u of row r at r * UNITS + (u ^ ((r /
// 4) % 8)): a thread's 4 rows of one unit, and 8 threads' rows 4 apart,
// fall in distinct banks
template <int T>
struct PairTile {
  static constexpr int CHUNK = T == 32 ? 64 : 32;  // columns staged at once
  static constexpr int UNITS = CHUNK / 4;
  static constexpr int TILE = T * CHUNK;  // floats
  // slots of both row tiles (twice as many of one on a diagonal tile):
  // 48 KB or 64 KB, so 4 CTAs of T = 32, or the 3 that T = 64's registers
  // allow, fit an SM
  static constexpr int STAGES = T == 32 ? 3 : 4;
  static constexpr int SMEM = 4 * STAGES * 2 * TILE;
  // the epilogue's G partial blocks (4096 floats), then, fused, d2 and each
  // warp's keys and selection
  static_assert(4096 + T * T + 24 * T <= STAGES * 2 * TILE, "pair smem");
};

template <int T>
__device__ __forceinline__ int unit_at(int r, int u) {
  return r * PairTile<T>::UNITS + (u ^ ((r >> 2) & 7));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

// the value's place in torch.sort's order as an unsigned word: ±0 one word,
// every NaN one word above +inf
__device__ __forceinline__ uint32_t order_word(uint32_t u) {
  const uint32_t a = u & 0x7fffffffu;
  if (a > 0x7f800000u) return 0xffffffffu;
  if (a == 0u) return 0x80000000u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// tile t of the upper triangle, in the order (0,0), (0,1), (1,1), (0,2), ...
__device__ __forceinline__ void tile_of(int t, int& ti, int& tj) {
  int j = (int)((sqrtf(8.f * (float)t + 1.f) - 1.f) * 0.5f);
  while ((j + 1) * (j + 2) / 2 <= t) ++j;
  while (j * (j + 1) / 2 > t) --j;
  tj = j;
  ti = t - j * (j + 1) / 2;
}

// block b of a tile's nbi x nbj register blocks, or of its upper triangle
__device__ __forceinline__ void block_of(int b, bool diag, int nbi, int nbj,
                                         int& bi, int& bj) {
  if (diag) {
    bi = 0;
    while (b >= nbi - bi) {
      b -= nbi - bi;
      ++bi;
    }
    bj = bi + b;
  } else {
    bi = b / nbj;
    bj = b % nbj;
  }
}

// a thread's share of staging a row tile: 16-byte unit u of rows r,
// r + STEP, ...; a row's units go to neighbouring threads
template <int T>
struct Stager {
  static constexpr int UNITS = PairTile<T>::UNITS, STEP = kThreads / UNITS;
  const float* src;  // x[r0 + r][4 u]
  int r, u;
  int rows;  // of the thread's rows, those below m
  __device__ __forceinline__ Stager(const float* x, int r0, int m, int d) {
    r = threadIdx.x / UNITS;
    u = threadIdx.x % UNITS;
    src = x + (size_t)(r0 + r) * d + 4 * u;
    const int left = min(T, m - r0) - r;
    rows = left > 0 ? (left + STEP - 1) / STEP : 0;
  }
  // the chunk at col0 into S: zeros past d, nothing past m.  vec: d % 4 ==
  // 0 and x 16-byte aligned, so a unit is one 16-byte copy
  __device__ __forceinline__ void stage(float* S, int col0, int d, bool vec,
                                        size_t step) const {
    const int c = col0 + 4 * u;
#pragma unroll
    for (int it = 0; it < T / STEP; ++it) {
      if (it < rows) {
        float* dst = S + 4 * unit_at<T>(r + STEP * it, u);
        const float* g = src + it * step + col0;
        if (vec) {
          if (c < d) {
            cp_async16(dst, g);
          } else {
            *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
          }
        } else {
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            if (c + w < d) {
              cp_async4(dst + w, g + w);
            } else {
              dst[w] = 0.f;
            }
          }
        }
      }
    }
  }
};

// the slice's chunks through NS shared-memory slots, NS - 1 of them in
// flight; each slot holds the chunk of the i rows, and of the j rows when
// sb is given (an off-diagonal tile).  acc[r][c] += (x_i - x_j)^2 over the
// columns of the thread's 16-byte units g, g + G, ... of each chunk
template <int T, int NS>
__device__ __forceinline__ void accumulate(float* stage, const Stager<T>& sa,
                                           const Stager<T>* sb, int cbeg,
                                           int cend, int d, bool vec, int bi,
                                           int bj, bool active, int g, int G,
                                           float (&acc)[kR][kR]) {
  constexpr int TILE = PairTile<T>::TILE, CHUNK = PairTile<T>::CHUNK;
  const int slot = (sb ? 2 : 1) * TILE;
  const size_t step = (size_t)Stager<T>::STEP * d;
  auto load = [&](int ch) {
    float* S = stage + ((ch - cbeg) % NS) * slot;
    sa.stage(S, ch * CHUNK, d, vec, step);
    if (sb) sb->stage(S + TILE, ch * CHUNK, d, vec, step);
  };
#pragma unroll
  for (int p = 0; p < NS - 1; ++p) {
    if (cbeg + p < cend) load(cbeg + p);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  const int sa_sw = bi & 7, sb_sw = bj & 7;
  for (int ch = cbeg; ch < cend; ++ch) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(NS - 2));
    __syncthreads();  // chunk ch is in, and every thread is done with ch - 1
    if (ch + NS - 1 < cend) load(ch + NS - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    const float* S = stage + ((ch - cbeg) % NS) * slot;
    const float* A = S + bi * kR * CHUNK;
    const float* B = S + (sb ? TILE : 0) + bj * kR * CHUNK;
    if (active) {
      for (int q = g; q < PairTile<T>::UNITS; q += G) {
        float4 a[kR], b[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          a[r] = *reinterpret_cast<const float4*>(A + r * CHUNK +
                                                  4 * (q ^ sa_sw));
          b[r] = *reinterpret_cast<const float4*>(B + r * CHUNK +
                                                  4 * (q ^ sb_sw));
        }
#pragma unroll
        for (int w = 0; w < 4; ++w) {
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            const float av = w == 0 ? a[r].x : w == 1 ? a[r].y
                           : w == 2 ? a[r].z : a[r].w;
#pragma unroll
            for (int c = 0; c < kR; ++c) {
              const float bv = w == 0 ? b[c].x : w == 1 ? b[c].y
                             : w == 2 ? b[c].z : b[c].w;
              const float diff = av - bv;
              acc[r][c] = fmaf(diff, diff, acc[r][c]);
            }
          }
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
}

// registers within 64 (T = 32) or 85 (T = 64): 4 or 3 CTAs an SM, as
// krum_plan's waves count them
template <int T>
__global__ void __launch_bounds__(kThreads, T == 32 ? 4 : 3)
krum_scores_kernel_pairs(const float* __restrict__ x, float* __restrict__ part,
                         float* __restrict__ scores, int m, int d, int k,
                         int chunks_per_slice, int nchunks) {
  extern __shared__ __align__(16) float stage[];  // PairTile<T>::STAGES slots
  int ti, tj;
  tile_of(blockIdx.x, ti, tj);
  const int i0 = ti * T, j0 = tj * T;
  const bool diag = ti == tj;
  const int s = blockIdx.y;
  const int cbeg = s * chunks_per_slice;
  const int cend = min(cbeg + chunks_per_slice, nchunks);

  const int nbi = (min(T, m - i0) + kR - 1) / kR;
  const int nbj = (min(T, m - j0) + kR - 1) / kR;
  const int nb = diag ? nbi * (nbi + 1) / 2 : nbi * nbj;
  int G = 1;  // ways the threads split a chunk's 16-byte units
  while (2 * G * nb <= kThreads && 2 * G <= PairTile<T>::UNITS) G *= 2;
  const int tid = threadIdx.x;
  const bool active = tid < nb * G;
  const int b = tid % nb, g = tid / nb;
  int bi, bj;
  block_of(b, diag, nbi, nbj, bi, bj);

  float acc[kR][kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
#pragma unroll
    for (int c = 0; c < kR; ++c) acc[r][c] = 0.f;
  }
  const Stager<T> sa(x, i0, m, d);
  const bool vec = d % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  if (diag) {
    accumulate<T, 2 * PairTile<T>::STAGES>(stage, sa, nullptr, cbeg, cend, d,
                                           vec, bi, bj, active, g, G, acc);
  } else {
    const Stager<T> sb(x, j0, m, d);
    accumulate<T, PairTile<T>::STAGES>(stage, sa, &sb, cbeg, cend, d, vec, bi,
                                       bj, active, g, G, acc);
  }

  // the G partial blocks, added in the order of g
  float* red = stage;  // G * nb * 16 <= 4096 floats
  if (active) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
#pragma unroll
      for (int c = 0; c < kR; ++c) red[(g * nb + b) * 16 + r * kR + c] = acc[r][c];
    }
  }
  __syncthreads();
  // k > 0: one tile and one slice hold all of d2, and this CTA also ranks
  // it (in D, the m x m d2 in shared memory) instead of the select kernel
  float* D = stage + 4096;
  float* ps = part + (size_t)s * m * m;
  for (int e = tid; e < nb * 16; e += kThreads) {
    const int eb = e >> 4, rc = e & 15;
    float v = red[eb * 16 + rc];
#pragma unroll 4
    for (int h = 1; h < G; ++h) v += red[(h * nb + eb) * 16 + rc];
    int ei, ej;
    block_of(eb, diag, nbi, nbj, ei, ej);
    const int i = i0 + ei * kR + rc / kR, j = j0 + ej * kR + rc % kR;
    if (i < m && j < m && (!diag || i <= j)) {
      if (k > 0 && i == j) v += kBig;
      ps[(size_t)i * m + j] = v;
      ps[(size_t)j * m + i] = v;
      if (k > 0) {
        D[i * m + j] = v;
        D[j * m + i] = v;
      }
    }
  }
  if (k == 0) return;
  __syncthreads();
  // row i to warp i % 8: each lane ranks its entries among the row's keys
  // (the select kernel's order), the k lowest land at sel[rank], and lane
  // 0 adds them in ascending order
  const int lane = tid & 31, warp = tid >> 5;
  unsigned long long* wk =
      reinterpret_cast<unsigned long long*>(stage + 4096 + T * T) + warp * T;
  float* sel = stage + 4096 + T * T + 2 * kThreads / 32 * T + warp * T;
  for (int i = warp; i < m; i += kThreads / 32) {
    for (int j = lane; j < m; j += 32) {
      wk[j] = ((unsigned long long)order_word(__float_as_uint(D[i * m + j]))
               << 32) | (unsigned)j;
    }
    __syncwarp();
    for (int j = lane; j < m; j += 32) {
      const unsigned long long kj = wk[j];
      int rank = 0;
#pragma unroll 8
      for (int c = 0; c < m; ++c) rank += wk[c] < kj;
      if (rank < k) sel[rank] = D[i * m + j];
    }
    __syncwarp();
    if (lane == 0) {
      float sum = 0.f;
#pragma unroll 8
      for (int r = 0; r < k; ++r) sum += sel[r];
      scores[i] = sum;
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(1024)
krum_scores_kernel_select(const float* part, float* d2,
                          float* __restrict__ scores, int m, int slices, int k,
                          int P) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  float* vals = reinterpret_cast<float*>(smem + 8 * (size_t)P);
  // slices > 1: nt * kBatch staged partials; then, m <= kRankMax, the
  // selection (k floats)
  float* buf = vals + ((m + 3) & ~3);
  const int i = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const size_t mm = (size_t)m * m;
  const float* row = part + (size_t)i * m;

  // d2[i, j]: the S partials added in slice order.  They are loaded
  // kBatch a thread at a time into shared memory, a block of columns by a
  // run of slices, so the loads are in flight together.
  const int jw = min(m, nt), sw = nt * kBatch / jw;
  for (int ja = 0; ja < m; ja += jw) {
    const int j = ja + tid;
    float v = 0.f;
    if (tid < jw && j < m) v = row[j];
    for (int sa = 1; sa < slices; sa += sw) {
      __syncthreads();
      // all kBatch loads in flight before any store: through the read-only
      // path, which the compiler knows no shared-memory store can touch
      // (with slices > 1, part is scratch this kernel never writes)
      float got[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int e = q * nt + tid, so = e / jw, jo = e % jw;
        got[q] = sa + so < slices && ja + jo < m
                     ? __ldg(row + (sa + so) * mm + ja + jo)
                     : 0.f;
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) buf[q * nt + tid] = got[q];
      __syncthreads();
      if (tid < jw && j < m) {
        const int n = min(sw, slices - sa);
#pragma unroll 8
        for (int so = 0; so < n; ++so) v += buf[so * jw + tid];
      }
    }
    if (tid < jw && j < m) {
      if (j == i) v += kBig;
      vals[j] = v;
      d2[(size_t)i * m + j] = v;
    }
  }
  __syncthreads();
  for (int j = tid; j < P; j += nt) {
    keys[j] = j < m ? ((unsigned long long)order_word(__float_as_uint(vals[j]))
                       << 32) | (unsigned)j
                    : kPad;
  }
  __syncthreads();
  // the k lowest: up to kRankMax, their values to sel[rank]; beyond, the
  // keys sorted in place
  float* sel = buf;
  if (m <= kRankMax) {
    // each entry's rank, the keys below it, counted by rs neighbouring
    // lanes over every rs-th key and added by shuffles
    int rs = 1;
    while (rs < 32 && 2 * rs * m <= nt) rs *= 2;
    const int part_of = tid % rs, groups = nt / rs;
    for (int it = 0; it < (m + groups - 1) / groups; ++it) {
      const int j0 = tid / rs + it * groups;
      const int j = min(j0, m - 1);  // every lane of the warp shuffles
      const unsigned long long kj = keys[j];
      int rank = 0;
#pragma unroll 8
      for (int c = part_of; c < m; c += rs) rank += keys[c] < kj;
      for (int o = 1; o < rs; o <<= 1) {
        rank += __shfl_xor_sync(0xffffffffu, rank, o);
      }
      if (j0 < m && part_of == 0 && rank < k) sel[rank] = vals[j];
    }
  } else {
    for (int kk = 2; kk <= P; kk <<= 1) {
      for (int jj = kk >> 1; jj > 0; jj >>= 1) {
        for (int t = tid; t < P / 2; t += nt) {
          const int lo = 2 * t - (t & (jj - 1)), hi = lo + jj;
          const unsigned long long a = keys[lo], c = keys[hi];
          if ((c < a) == ((lo & kk) == 0)) {
            keys[lo] = c;
            keys[hi] = a;
          }
        }
        __syncthreads();
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
    if (m <= kRankMax) {
#pragma unroll 8
      for (int r = 0; r < k; ++r) sum += sel[r];
    } else {
#pragma unroll 8
      for (int r = 0; r < k; ++r) sum += vals[(uint32_t)keys[r]];
    }
    scores[i] = sum;
  }
}

// let a kernel take dyn bytes of dynamic shared memory (past 48 KB only
// when asked)
template <class K>
cudaError_t allow_smem(K kernel, size_t dyn) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
}

}  // namespace

// tile, slices, chunks_per_slice: krum_plan's; part is (slices, m, m)
// scratch, or d2 itself when slices == 1
extern "C" int krum_scores_launch(const float* x, float* part, float* d2,
                                  float* scores, int m, int d, int k,
                                  int tile, int slices, int chunks_per_slice,
                                  void* stream) {
  if (m <= 0) return (int)cudaSuccess;
  if (m > kMaxM || k < 1 || k > m || slices < 1 || chunks_per_slice < 0 ||
      (tile != 32 && tile != 64) || (slices > 1 && part == d2)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int nt = (m + tile - 1) / tile;
  const dim3 grid((unsigned)(nt * (nt + 1) / 2), (unsigned)slices);
  const int chunk = tile == 32 ? PairTile<32>::CHUNK : PairTile<64>::CHUNK;
  const int nchunks = (d + chunk - 1) / chunk;
  cudaError_t err;
  // one tile and one slice: the pair CTA ranks d2 itself
  const int fused = nt == 1 && slices == 1 ? k : 0;
  if (tile == 32) {
    err = allow_smem(krum_scores_kernel_pairs<32>, PairTile<32>::SMEM);
    if (err != cudaSuccess) return (int)err;
    krum_scores_kernel_pairs<32><<<grid, kThreads, PairTile<32>::SMEM, st>>>(
        x, part, scores, m, d, fused, chunks_per_slice, nchunks);
  } else {
    err = allow_smem(krum_scores_kernel_pairs<64>, PairTile<64>::SMEM);
    if (err != cudaSuccess) return (int)err;
    krum_scores_kernel_pairs<64><<<grid, kThreads, PairTile<64>::SMEM, st>>>(
        x, part, scores, m, d, fused, chunks_per_slice, nchunks);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || fused) return (int)err;
  int P = 2;
  while (P < m) P <<= 1;
  // a thread a compare of the network, and at least 256 to stage the
  // partial sums
  const int threads = P / 2 > 1024 ? 1024 : P / 2 < 256 ? 256 : P / 2;
  // keys, values, and the staged partials or the selection
  const size_t staged = slices > 1 ? (size_t)threads * kBatch : 0;
  const size_t ranked = m <= kRankMax ? (size_t)m : 0;
  const size_t smem = 8 * (size_t)P + 4 * (size_t)((m + 3) & ~3) +
                      4 * (staged > ranked ? staged : ranked);
  err = allow_smem(krum_scores_kernel_select, smem);
  if (err != cudaSuccess) return (int)err;
  krum_scores_kernel_select<<<m, threads, smem, st>>>(part, d2, scores, m,
                                                       slices, k, P);
  return (int)cudaGetLastError();
}
