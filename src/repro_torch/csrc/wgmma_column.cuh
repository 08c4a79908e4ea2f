// One output block-column of a block-sparse product on Hopper's tensor
// cores, shared by B1 (block_sparse.cu), B2 (fused_gate_up.cu) and B4
// (block_sparse_col.cu) for bf16 x against an int8 payload, and by B5's
// bf16 path (quant_matmul.cu), whose dense int8 weight is a packed weight
// with every 128x128 block live.
//
// The payload is the pack layout: column j's surviving blocks lie
// contiguously, (mb, 128, 128) int8 row-major (k, n), with block_rows[j, s]
// the k block of slot s and counts[j] the live slots.  A CTA owns output
// block-column j for kBM = 64 * NC rows of x and walks its slots:
//
// - a producer warp keeps a ring of S stages in flight: each stage is one
//   1-D bulk copy of the 16 KB int8 block and two 2-D TMA loads of the
//   matching x tile (kBM rows x 128 k, bf16, 128-byte swizzle; rows past M
//   arrive as zeros and are never read from device memory), all completing
//   on the stage's "full" mbarrier by transaction bytes;
// - NC consumer warpgroups convert the int8 block exactly to bf16 (|w| <=
//   127) straight into the MN-major 128B-swizzle layout that the wgmma B
//   descriptor reads, double-buffered: block i+1 converts while the wgmma
//   of block i runs; each warpgroup then multiplies its 64 rows by the
//   block with eight m64n128k16 wgmma (fp32 accumulators in registers) and
//   releases the stage on its "empty" mbarrier.
//
// Prefill (NC = 2): one CTA per (column, 128-row M tile), so each surviving
// block is streamed once per 128 rows; setmaxnreg gives the producer
// warpgroup 40 registers and the consumers 232.  Decode (NC = 1, M <= 64):
// the column's slots are split over a thread-block cluster of ``split``
// CTAs (rank r takes slots r, r + split, ...); after a cluster barrier rank
// 0 adds the other ranks' partial sums over the live rows from their shared
// memory, in rank order, and applies the epilogue.  No float atomics: two
// launches on the same operands give the same bits.  B2 (GATED) walks the
// gate slots, then the up slots, into two accumulators and writes
// act(hg * sg) * (hu * su).
//
// A stack of E experts (a MoE layer's (E, K, N) leaf, B1/B2/B4): one launch
// with gridDim.z = E, every operand rectangular over the stack -- blocks
// (E, N/128 * mb, 128, 128), rows (E, N/128, mb), counts (E, N/128), scales
// (E, N), x (E, M, K), y (E, M, N), one mb for the whole stack.  CTA z takes
// expert z's lists (``expert``), y rows and x rows: x's TMA map spans all
// E * M rows, so a tile's rows past M (its expert's) hold the next expert's
// rows or zeros past the last one; they are never stored, and a wgmma row
// never mixes into another, so every stored row equals a single-expert
// launch's bit for bit in the same regime.  A cluster is (split, 1, 1), so
// its CTAs share blockIdx.z.
//
// DENSE (B5): slot s of column j is k block s of a dense (K, N) int8
// weight, ``g.mb`` = ceil(K / 128) slots for every column (a kernel
// argument: nothing is read from the device).  Its stage is one 2-D TMA
// load of the (128 k x 128 n) box at (j * 128, s * 128) through a tensor
// map over the weight with its row stride and no swizzle, which lands as
// the row-major 128x128 image a bulk copy lands for a packed block, so the
// conversion and the wgmma are the packed path's.  TMA zero-fills k >= K
// and n >= N (x's map zero-fills k >= K too); the epilogue writes
// act(sum * scales[n]) for n < N only.  The other kernels instantiate
// DENSE = false and compile to what they were.
#pragma once

#include "hopper.cuh"

namespace wcol {

constexpr int kBK = 128;                       // block rows (the contraction)
constexpr int kBN = 128;                       // block columns (one output block-column)
constexpr uint32_t kRawBytes = kBK * kBN;      // one int8 block
constexpr uint32_t kCvtBytes = kBK * kBN * 2;  // the block in bf16
constexpr uint32_t kAtomBytes = kBK * 128;     // one 64-column atom of the converted block
constexpr int kMaxSplit = 8;                   // CTAs of a cluster (the portable limit)

struct ColList {              // one packed weight's operands
  const int8_t* blocks;       // (N/128 * mb, 128, 128)
  const int* rows;            // (N/128, mb)
  const int* counts;          // (N/128,)
  const float* scales;        // (N,) or null
  int mb;
};

// expert z's lists of a stack of ``n_cols``-column weights
__device__ __forceinline__ ColList expert(const ColList& c, int z, int n_cols) {
  const size_t col0 = static_cast<size_t>(z) * n_cols;
  return ColList{c.blocks + col0 * c.mb * kRawBytes, c.rows + col0 * c.mb, c.counts + col0,
                 c.scales != nullptr ? c.scales + col0 * kBN : nullptr, c.mb};
}

template <int NC, int S>
struct Geometry {
  static constexpr int kBM = 64 * NC;
  static constexpr uint32_t kXBytes = kBM * kBK * 2;       // one x tile
  static constexpr uint32_t kX = 0;                        // S x tiles
  static constexpr uint32_t kRaw = kX + S * kXBytes;       // S int8 blocks
  static constexpr uint32_t kCvt = kRaw + S * kRawBytes;   // 2 converted blocks
  static constexpr uint32_t kBars = kCvt + 2 * kCvtBytes;  // full[S], empty[S]
  static constexpr uint32_t kSmem = kBars + 2 * S * 8 + 1024;  // + alignment slack
  static constexpr int kThreads = 128 * (NC + 1);
  static_assert(kSmem <= 232448, "more shared memory than a CTA may have");
};

// int8 block (k-major rows of 128 n) -> bf16 in the MN-major 128B-swizzle
// layout: atom n / 64, row k at k * 128 bytes, 16-byte chunk q = (n % 64) / 8
// stored at chunk q ^ (k % 8).  Exact: 0x4B000000 | (w + 128) is the fp32
// 2^23 + w + 128, and the integer w (|w| <= 128) keeps all its bits in the
// upper half of its fp32 pattern, which is its bf16.
__device__ __forceinline__ void convert_block(const int8_t* raw, unsigned char* cvt, int t,
                                              int nthreads) {
  for (int c = t; c < static_cast<int>(kRawBytes / 16); c += nthreads) {
    const int k = c >> 3, n0 = (c & 7) << 4;
    const uint4 v = *reinterpret_cast<const uint4*>(raw + 16 * c);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t o[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t u = w[i] ^ 0x80808080u;
      const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.0f;
      const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.0f;
      const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.0f;
      const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.0f;
      o[2 * i] = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
      o[2 * i + 1] = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
    }
    const int q = (n0 & 63) >> 3;  // even: this chunk fills q and q + 1
    unsigned char* row = cvt + (n0 >> 6) * kAtomBytes + k * 128;
    *reinterpret_cast<uint4*>(row + ((q ^ (k & 7)) << 4)) = make_uint4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<uint4*>(row + (((q + 1) ^ (k & 7)) << 4)) =
        make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// d += x tile rows (this warpgroup's 64) @ converted block, eight k16 steps.
// A: K-major 128B swizzle as TMA wrote it, two 64-k atoms of kBM rows
// (SBO 1024: eight rows of 128 bytes; k16 step = +32 bytes in the atom).
// B: MN-major, LBO = the 64-column atom stride, SBO = eight k rows.
template <int BM>
__device__ __forceinline__ void mma_block(float (&d)[64], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t da = desc_sw128(a + (kk >> 2) * (BM * 128) + (kk & 3) * 32, 16, 1024);
    const uint64_t db = desc_sw128(b + kk * 16 * 128, kAtomBytes, 1024);
    wgmma_m64n128k16_bf16(d, da, db);
  }
}

// y rows of this thread (row0 and row0 + 8) of block-column j
template <bool GATED>
__device__ __forceinline__ void store_tile(const float (&hg)[64], const float (&hu)[64],
                                           const ColList& g, const ColList& u,
                                           __nv_bfloat16* __restrict__ y, int M, int N, int j,
                                           int row0, int lane, int act) {
#pragma unroll
  for (int c = 0; c < kBN / 8; ++c) {
    const int n = j * kBN + 8 * c + 2 * (lane & 3);
    const float sg0 = g.scales != nullptr ? g.scales[n] : 1.0f;
    const float sg1 = g.scales != nullptr ? g.scales[n + 1] : 1.0f;
    float su0 = 1.0f, su1 = 1.0f;
    if (GATED && u.scales != nullptr) su0 = u.scales[n], su1 = u.scales[n + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row0 + 8 * h;
      if (m >= M) continue;
      float v0 = hg[4 * c + 2 * h] * sg0, v1 = hg[4 * c + 2 * h + 1] * sg1;
      if (GATED) {
        v0 = apply_act(act, v0) * (hu[4 * c + 2 * h] * su0);
        v1 = apply_act(act, v1) * (hu[4 * c + 2 * h + 1] * su1);
      }
      __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
      *reinterpret_cast<__nv_bfloat162*>(y + static_cast<size_t>(m) * N + n) = p;
    }
  }
}

// y rows of this thread (row0 and row0 + 8) of block-column j of a DENSE
// (B5) product: act(sum * scales[n]) in bf16 for n < N; a column past N
// reads no scale and writes nothing.  y's row stride is N, so a bf16 pair
// is stored whole only when N is even (the pair is then 4-byte aligned).
__device__ __forceinline__ void store_dense(const float (&h)[64], const float* __restrict__ scales,
                                            __nv_bfloat16* __restrict__ y, int M, int N, int j,
                                            int row0, int lane, int act) {
#pragma unroll
  for (int c = 0; c < kBN / 8; ++c) {
    const int n = j * kBN + 8 * c + 2 * (lane & 3);
    if (n >= N) continue;
    const bool two = n + 1 < N;
    const float s0 = scales[n], s1 = two ? scales[n + 1] : 0.0f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = row0 + 8 * e;
      if (m >= M) continue;
      const float v0 = apply_act(act, h[4 * c + 2 * e] * s0);
      __nv_bfloat16* dst = y + static_cast<size_t>(m) * N + n;
      if (!two) {
        dst[0] = __float2bfloat16(v0);
        continue;
      }
      const float v1 = apply_act(act, h[4 * c + 2 * e + 1] * s1);
      if ((N & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
      } else {
        dst[0] = __float2bfloat16(v0);
        dst[1] = __float2bfloat16(v1);
      }
    }
  }
}

// The kernel body (see the file comment).  ``split`` > 1 needs NC == 1 and
// a cluster launch of ``split`` CTAs along x.  blockIdx.z picks the expert
// of a stack (0 for one weight; M is one expert's rows).  DENSE reads the
// weight through ``wmap`` (g.blocks, rows and counts unused), needs !GATED
// and takes no stack.
template <int NC, int S, bool GATED, bool DENSE = false>
__device__ __forceinline__ void column_body(const CUtensorMap* xmap, const ColList& g_stack,
                                            const ColList& u_stack,
                                            __nv_bfloat16* __restrict__ y_stack, int M, int N,
                                            int split, int act, unsigned char* smem_raw,
                                            const CUtensorMap* wmap = nullptr) {
  using G = Geometry<NC, S>;
  static_assert(NC == 1 || NC == 2, "one or two consumer warpgroups");
  static_assert(!(DENSE && GATED), "a dense weight is one operand");
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::kBars);
  uint64_t* empty = full + S;

  const int j = blockIdx.x / split;
  const int rank = blockIdx.x % split;
  const int m0 = blockIdx.y * G::kBM;
  const int z = DENSE ? 0 : static_cast<int>(blockIdx.z);
  const ColList g = DENSE ? g_stack : expert(g_stack, z, N / kBN);
  const ColList u = GATED ? expert(u_stack, z, N / kBN) : g;
  __nv_bfloat16* __restrict__ y = y_stack + static_cast<size_t>(z) * M * N;
  const int xrow = z * M + m0;  // this tile's first row in x's map of E * M rows
  int cg;
  if constexpr (DENSE)
    cg = g.mb;
  else
    cg = g.counts[j];
  const int cu = GATED ? u.counts[j] : 0;
  const int ng = cg > rank ? (cg - rank + split - 1) / split : 0;  // this rank's gate slots
  const int nu = cu > rank ? (cu - rank + split - 1) / split : 0;  // and up slots
  const int nl = ng + nu;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NC);  // one arrival per consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float hg[64], hu[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) hg[i] = hu[i] = 0.0f;

  if (warp >= 4 * NC) {
    // -- producer ---------------------------------------------------------------
    if constexpr (NC == 2) setmaxnreg_dec<40>();
    if (warp == 4 * NC && lane == 0) {
      for (int i = 0; i < nl; ++i) {
        const int st = i % S;
        if (i >= S) mbar_wait(&empty[st], ((i / S) - 1) & 1);
        if constexpr (DENSE) {
          const int k0 = (rank + i * split) * kBK;
          unsigned char* xd = smem + G::kX + st * G::kXBytes;
          mbar_arrive_expect_tx(&full[st], kRawBytes + G::kXBytes);
          tma_load_2d(smem + G::kRaw + st * kRawBytes, wmap, j * kBN, k0, &full[st]);
          tma_load_2d(xd, xmap, k0, xrow, &full[st]);
          tma_load_2d(xd + G::kBM * 128, xmap, k0 + 64, xrow, &full[st]);
          continue;
        }
        const bool gate = i < ng;
        const size_t b = static_cast<size_t>(j) * (gate ? g.mb : u.mb) + rank +
                         (gate ? i : i - ng) * split;
        const int k0 = (gate ? g.rows : u.rows)[b] * kBK;
        unsigned char* xd = smem + G::kX + st * G::kXBytes;
        mbar_arrive_expect_tx(&full[st], kRawBytes + G::kXBytes);
        const int8_t* src = (gate ? g.blocks : u.blocks) + b * kRawBytes;
        bulk_copy_g2s(smem + G::kRaw + st * kRawBytes, src, kRawBytes, &full[st]);
        tma_load_2d(xd, xmap, k0, xrow, &full[st]);
        tma_load_2d(xd + G::kBM * 128, xmap, k0 + 64, xrow, &full[st]);
      }
    }
  } else {
    // -- consumers --------------------------------------------------------------
    if constexpr (NC == 2) setmaxnreg_inc<232>();
    constexpr int kNT = 128 * NC;
    const int t = threadIdx.x, wg = t >> 7;
    const uint32_t cvt = smem_u32(smem + G::kCvt);
    if (nl > 0) {
      mbar_wait(&full[0], 0);
      convert_block(reinterpret_cast<const int8_t*>(smem + G::kRaw), smem + G::kCvt, t, kNT);
      fence_proxy_async();
      named_bar_sync(1, kNT);
    }
    // one slot: issue its wgmma into ``acc``, convert the next block while
    // they run, then release the stage
    auto step = [&](int i, float(&acc)[64]) {
      const int st = i % S;
      const uint32_t a = smem_u32(smem + G::kX + st * G::kXBytes) + wg * 64 * 128;
      fence_regs(acc);
      wgmma_fence();
      mma_block<G::kBM>(acc, a, cvt + (i & 1) * kCvtBytes);
      wgmma_commit();
      if (i + 1 < nl) {
        const int s2 = (i + 1) % S;
        mbar_wait(&full[s2], ((i + 1) / S) & 1);
        convert_block(reinterpret_cast<const int8_t*>(smem + G::kRaw + s2 * kRawBytes),
                      smem + G::kCvt + ((i + 1) & 1) * kCvtBytes, t, kNT);
        fence_proxy_async();
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[st]);
      named_bar_sync(1, kNT);  // the next converted block is whole; this one is free
    };
    // the gate slots into hg, then (B2) the up slots into hu: each loop
    // names its accumulator statically, so no wgmma sits in a divergent path
    int i = 0;
    for (; i < ng; ++i) step(i, hg);
    if constexpr (GATED)
      for (; i < nl; ++i) step(i, hu);
    if (split == 1) {
      const int row0 = m0 + t / 32 * 16 + lane / 4;
      if constexpr (DENSE)
        store_dense(hg, g.scales, y, M, N, j, row0, lane, act);
      else
        store_tile<GATED>(hg, hu, g, u, y, M, N, j, row0, lane, act);
    }
  }

  if constexpr (NC == 1) {
    if (split > 1) {
      // ranks 1.. leave their live rows in their shared memory (the
      // converted blocks are free: every wgmma has completed); rank 0 adds
      // them in rank order and writes y
      float* part = reinterpret_cast<float*>(smem + G::kCvt);  // [GATED + 1][64][128]
      const bool consumer = warp < 4;
      const int r0 = warp * 16 + lane / 4;
      if (consumer && rank != 0) {
#pragma unroll
        for (int c = 0; c < kBN / 8; ++c)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h;
            if (m0 + r >= M) continue;
            const int idx = r * kBN + 8 * c + 2 * (lane & 3);
            *reinterpret_cast<float2*>(part + idx) =
                make_float2(hg[4 * c + 2 * h], hg[4 * c + 2 * h + 1]);
            if (GATED)
              *reinterpret_cast<float2*>(part + 64 * kBN + idx) =
                  make_float2(hu[4 * c + 2 * h], hu[4 * c + 2 * h + 1]);
          }
      }
      cluster_sync();
      if (consumer && rank == 0) {
        for (int p = 1; p < split; ++p) {
          const uint32_t base = peer_addr(part, p);
#pragma unroll
          for (int c = 0; c < kBN / 8; ++c)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = r0 + 8 * h;
              if (m0 + r >= M) continue;
              const int idx = r * kBN + 8 * c + 2 * (lane & 3);
              const float2 v = ld_peer_f2(base + 4 * idx);
              hg[4 * c + 2 * h] += v.x;
              hg[4 * c + 2 * h + 1] += v.y;
              if (GATED) {
                const float2 w = ld_peer_f2(base + 4 * (64 * kBN + idx));
                hu[4 * c + 2 * h] += w.x;
                hu[4 * c + 2 * h + 1] += w.y;
              }
            }
        }
        if constexpr (DENSE)
          store_dense(hg, g.scales, y, M, N, j, m0 + r0, lane, act);
        else
          store_tile<GATED>(hg, hu, g, u, y, M, N, j, m0 + r0, lane, act);
      }
      cluster_sync();  // no CTA exits while rank 0 still reads its shared memory
    }
  }
}

// -- host side ---------------------------------------------------------------------

// x (M, K) bf16 with row stride ldx (K when 0) as boxes of 64 k x box_rows
// rows, 128B swizzle, zeros outside the tensor
inline bool encode_x_map(CUtensorMap* map, const void* x, int M, int K, int box_rows,
                         int ldx = 0) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ldx > 0 ? ldx : K) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a dense int8 weight (K, N) with row stride ldw bytes as boxes of 128 n x
// 128 k, no swizzle (row-major in shared memory), zeros outside the tensor
inline bool encode_w_map(CUtensorMap* map, const void* w, int K, int N, int ldw) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ldw)};
  const cuuint32_t box[2] = {kBN, kBK};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch ``kern`` (a __global__ wrapper of column_body<NC, S, *>) over
// (n_cols * split, M tiles, n_stack experts), with a cluster of ``split``
// CTAs along x when split > 1.  bm is the host's regime: 128 (NC = 2, split 1) or 64 (NC = 1,
// split 1..8).  static: B1 and B4 pass kernels of one type from two
// libraries, and the static ``configured`` of an inline template would be
// one process-wide (unique) symbol -- one library's flag would skip the
// other's shared-memory attribute.
template <int NC, int S, typename Kern, typename... Args>
static int launch_column(Kern kern, int M, int n_cols, int split, int n_stack,
                         cudaStream_t stream, Args... args) {
  using G = Geometry<NC, S>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(G::kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_cols * split, (M + G::kBM - 1) / G::kBM, n_stack);
  cfg.blockDim = dim3(G::kThreads, 1, 1);
  cfg.dynamicSmemBytes = G::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// the regimes the host may pick: (bm, split) -> (NC, valid)
inline bool valid_regime(int bm, int split) {
  return (bm == 128 && split == 1) || (bm == 64 && split >= 1 && split <= kMaxSplit);
}

}  // namespace wcol
