// One output tile of a dense product  acc = x @ w,  of B5's CUDA-core
// regime (quant_matmul.cu: fp32 x, or bf16 x whose strides TMA cannot
// take; the FC nets' B7 and B8 run stream_tile.cuh instead).
//
// A CTA of kThreads threads owns Tile::kCols output columns (32 bytes of
// weights per row: 8 fp32, 16 int16 or 32 int8 columns) for BM rows
// and walks the whole K dimension in tiles of Tile::kBK rows.  Thread (kr, c)
// owns column c of the CTA and, inside every K tile, the Tile::kKPer
// weight rows k = kr * kKPer .. + kKPer - 1: it loads those weights from
// device memory straight into registers (each 32-byte row segment is one
// full sector, a warp reads 32 / kCols of them per load) and multiplies
// each by all BM activation rows, which the CTA stages in shared memory.
// So every weight byte is read once per CTA and used BM times -- the
// paper's batch processing (Section 4.2) on Hopper: the weight tile stays
// in registers while the batch rows sweep past it.  Narrow CTAs give a
// layer of 1500 fp32 columns 188 CTAs, and each thread keeps the next
// tile's weights (32 bytes of fp32 or int16, 8 of int8) and activations in
// flight while the current tile multiplies.
//
// At the end the kKR partial sums of each output (one per k-row group) are
// added in shared memory in a fixed order, so a result does not depend on
// scheduling.  The ragged M, K and N edges are masked (no padding of the
// operands); rows are addressed through leading dimensions, so a column
// section of a wider weight needs no copy.
#pragma once

#include "common.cuh"

namespace dtile {

constexpr int kThreads = 256;
constexpr int kMaxBM = 32;  // rows per CTA at most

// Thread layout for a weight type: kCols columns (32 bytes) per CTA, kKR =
// kThreads / kCols k-row groups of kKPer rows each, kBK = kKR * kKPer rows
// of K per tile.  fp32 and 16-bit weights keep 32 bytes per thread in
// flight (kKPer 8 and 16, kBK 256); int8 keeps kKPer 8 (kBK 64), since 32
// rows per thread cost the registers that occupancy needs.
template <typename WT>
struct Tile {
  static constexpr int kCols = 32 / static_cast<int>(sizeof(WT));
  static constexpr int kKR = kThreads / kCols;
  static constexpr int kKPer = sizeof(WT) == 1 ? 8 : 32 / static_cast<int>(sizeof(WT));
  static constexpr int kBK = kKR * kKPer;
  static_assert(kKPer % 4 == 0, "the MAC loop reads four activations per load");
};

// MAC arithmetic per accumulator type: fp32 FMA on the CUDA cores.
template <typename Acc> struct Mac;

template <> struct Mac<float> {
  using Stage = float;
  using Vec4 = float4;
  template <typename T> __device__ static float load(T v) { return to_float(v); }
  __device__ static void mac(float& acc, float a, float w) { acc = fmaf(a, w, acc); }
};

// The activation tile while K is walked; the partial sums after (at most
// 32 KB).  16-byte aligned: the MAC loop reads the tile four values at a time.
template <int BM, typename Acc, typename WT>
union __align__(16) Smem {
  typename Mac<Acc>::Stage xs[BM][Tile<WT>::kBK];  // activation tile, row-major like x
  Acc red[kThreads * BM];                          // partial sums, [kr][r][c]
};

// Computes the CTA's tile and calls epi(m, n, sum) once for every output
// (m < M, n < N) of it.  Must be called by all kThreads threads of a CTA
// launched on grid (ceil(N / Tile<WT>::kCols), ceil(M / BM)).
template <int BM, typename Acc, typename XT, typename WT, typename Epi>
__device__ __forceinline__ void tile_product(const XT* __restrict__ x, int ldx,
                                             const WT* __restrict__ w, int ldw,
                                             int M, int K, int N, Smem<BM, Acc, WT>& sm, Epi epi) {
  using M_ = Mac<Acc>;
  using Stage = typename M_::Stage;
  constexpr int kCols = Tile<WT>::kCols, kKR = Tile<WT>::kKR, kKPer = Tile<WT>::kKPer;
  constexpr int kBK = Tile<WT>::kBK;
  // activation staging: each pass of the CTA covers kRowsPerPass whole rows
  // of the tile; thread t stages column xk of row t * kRowsPerPass + xr0
  static_assert(kThreads % kBK == 0, "a staging pass covers whole tile rows");
  constexpr int kRowsPerPass = kThreads / kBK;
  constexpr int kXPer = (BM + kRowsPerPass - 1) / kRowsPerPass;
  const int xr0 = threadIdx.x / kBK, xk = threadIdx.x % kBK;
  const int c = threadIdx.x % kCols;
  const int kr = threadIdx.x / kCols;
  const int n = blockIdx.x * kCols + c;
  const int m0 = blockIdx.y * BM;
  const bool n_ok = n < N;
  const int rows = min(BM, M - m0);

  Acc acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = Acc(0);

  // The next tile's weights (kKPer rows of this thread's column) and its
  // share of the activation tile are loaded into registers while the
  // current tile multiplies.
  Stage wnext[kKPer], xnext[kXPer];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kKPer; ++j) {
      const int k = k0 + kr * kKPer + j;
      wnext[j] = (n_ok && k < K) ? M_::load(w[static_cast<size_t>(k) * ldw + n]) : Stage(0);
    }
#pragma unroll
    for (int t = 0; t < kXPer; ++t) {
      const int r = t * kRowsPerPass + xr0, k = k0 + xk;
      xnext[t] = (r < rows && k < K) ? M_::load(x[static_cast<size_t>(m0 + r) * ldx + k])
                                     : Stage(0);
    }
  };

  load_tile(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    Stage wcur[kKPer];
#pragma unroll
    for (int j = 0; j < kKPer; ++j) wcur[j] = wnext[j];
#pragma unroll
    for (int t = 0; t < kXPer; ++t) {
      const int r = t * kRowsPerPass + xr0;
      if (r < BM) sm.xs[r][xk] = xnext[t];
    }
    if (k0 + kBK < K) load_tile(k0 + kBK);  // in flight while this tile multiplies
    __syncthreads();
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      // one address per k-row group (a broadcast), four values per load
      const auto* xr = reinterpret_cast<const typename M_::Vec4*>(&sm.xs[r][kr * kKPer]);
#pragma unroll
      for (int j = 0; j < kKPer / 4; ++j) {
        const auto v = xr[j];
        M_::mac(acc[r], v.x, wcur[4 * j]);
        M_::mac(acc[r], v.y, wcur[4 * j + 1]);
        M_::mac(acc[r], v.z, wcur[4 * j + 2]);
        M_::mac(acc[r], v.w, wcur[4 * j + 3]);
      }
    }
    __syncthreads();  // xs is rewritten by the next tile (or by red below)
  }

#pragma unroll
  for (int r = 0; r < BM; ++r) sm.red[(kr * BM + r) * kCols + c] = acc[r];
  __syncthreads();
  for (int o = threadIdx.x; o < rows * kCols; o += kThreads) {
    const int r = o / kCols, oc = o % kCols;
    const int on = blockIdx.x * kCols + oc;
    Acc s = sm.red[r * kCols + oc];
    for (int g = 1; g < kKR; ++g) s += sm.red[(g * BM + r) * kCols + oc];
    if (on < N) epi(m0 + r, on, s);
  }
}

// BM for M rows: the smallest power of two >= M, at most kMaxBM.
inline int pick_bm(int M) {
  int bm = 1;
  while (bm < M && bm < kMaxBM) bm *= 2;
  return bm;
}

// Instantiates LAUNCH(BM) for the BM that pick_bm(M) selects.
#define DTILE_DISPATCH_BM(M, LAUNCH)      \
  switch (dtile::pick_bm(M)) {            \
    case 1: return LAUNCH(1);             \
    case 2: return LAUNCH(2);             \
    case 4: return LAUNCH(4);             \
    case 8: return LAUNCH(8);             \
    case 16: return LAUNCH(16);           \
    default: return LAUNCH(32);           \
  }

}  // namespace dtile
