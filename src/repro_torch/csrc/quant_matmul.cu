// B5 and B8: the quantized-weight products of Sections 4.1 / 5.3, for Hopper.
//
// B5 replaces repro/kernels/quant_matmul.py:quant_matmul:
//     y = act((x @ w_q) * scales),  w_q int8 (K, N), scales (N,) fp32.
// The int8 payload is read once (one byte per weight) and converted exactly
// for the MACs; the per-column scale factors out of the K sum, so it and
// the activation run once in the epilogue -- the reference's deferred
// dequantization.  Bound on this card: at decode (M = 8) every weight byte
// feeds 8 MACs, so the int8 stream bounds it (K * N bytes over 3.35 TB/s;
// the 2048 x 32000 head is 65.5 MB, 0.0196 ms); at a 2032-token prefill
// under --compress quant each weight byte feeds 2032 MACs and the bf16
// tensor-core rate bounds it.
//
// bf16 x whose operands TMA can address (the head and every --compress
// quant leaf of the served models) runs on the tensor cores: a dense int8
// weight is a packed weight whose every 128x128 block is live, so
// quant_matmul_wgmma_kernel is wgmma_column.cuh's column body with its
// DENSE producer -- one 2-D TMA load per (128 k x 128 n) weight box
// through an mbarrier ring, the box converted exactly to bf16 and
// multiplied on wgmma with fp32 sums, act(sum * scale) in the epilogue;
// 128-row tiles at prefill (each weight byte streamed once per 128 rows),
// one 64-row tile with a column's k blocks split over a cluster at decode,
// in the regime kernels/quant_matmul.regime picks from shapes.  fp32 x,
// and bf16 x that TMA cannot address (K * 2, ldx * 2 or ldw not a multiple
// of 16), run the CUDA-core kernel below.
//
// B8 replaces repro/kernels/quant_matmul.py:q78_matmul_kernel, the paper's
// FPGA MAC array: int16 Q7.8 x int16 Q7.8 -> int32 Q15.16, no rounding and
// no epilogue.  The sum must wrap modulo 2^32 as the reference's int32 dot
// does; signed overflow is undefined in C++, so the accumulator is
// uint32_t and is reinterpreted as int32 only at the store.  Integer sums
// do not depend on order, so the result is bit-exact at any tiling.
// Hopper has no int16 MMA; the MACs run on the CUDA cores.  Bound: the
// int16 weight stream (2 bytes per weight) at the nets' batches of 1..32.
//
// The CUDA-core kernels (B8, and B5's dense_tile regime) walk K in a loop
// over output tiles 32 weight bytes wide (32 int8 or 16 int16 columns;
// dense_tile.cuh), the weight tile in registers serving every row of the
// CTA; ragged M, K, N are masked, and the weight is addressed through a
// row stride so that a column section of it (forward_q78_sectioned) needs
// no copy.
#include "dense_tile.cuh"
#include "wgmma_column.cuh"

template <int NC, int S>
__global__ void __launch_bounds__(wcol::Geometry<NC, S>::kThreads, 1)
quant_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap wmap, const wcol::ColList w,
                          __nv_bfloat16* __restrict__ y, int M, int N, int split, int act) {
  extern __shared__ __align__(1024) unsigned char smem[];
  wcol::column_body<NC, S, false, true>(&xmap, w, w, y, M, N, split, act, smem, &wmap);
}

template <int BM, typename XT>
__global__ void __launch_bounds__(dtile::kThreads)
quant_matmul_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scales, XT* __restrict__ y, int M, int K, int N,
                    int ldx, int ldw, int act) {
  __shared__ dtile::Smem<BM, float, int8_t> sm;
  dtile::tile_product<BM, float>(x, ldx, w, ldw, M, K, N, sm, [=](int m, int n, float s) {
    y[static_cast<size_t>(m) * N + n] = from_float<XT>(apply_act(act, s * scales[n]));
  });
}

template <int BM>
__global__ void __launch_bounds__(dtile::kThreads)
q78_matmul_kernel(const int16_t* __restrict__ a, const int16_t* __restrict__ w,
                  int32_t* __restrict__ y, int M, int K, int N, int lda, int ldw) {
  __shared__ dtile::Smem<BM, uint32_t, int16_t> sm;
  dtile::tile_product<BM, uint32_t>(a, lda, w, ldw, M, K, N, sm, [=](int m, int n, uint32_t s) {
    y[static_cast<size_t>(m) * N + n] = static_cast<int32_t>(s);  // two's complement: wraps
  });
}

template <int BM, typename XT>
static int launch_quant_bm(const void* x, const int8_t* w, const float* scales, void* y, int M,
                           int K, int N, int ldx, int ldw, int act, cudaStream_t stream) {
  constexpr int kCols = dtile::Tile<int8_t>::kCols;
  const dim3 grid((N + kCols - 1) / kCols, (M + BM - 1) / BM);
  quant_matmul_kernel<BM, XT><<<grid, dtile::kThreads, 0, stream>>>(
      static_cast<const XT*>(x), w, scales, static_cast<XT*>(y), M, K, N, ldx, ldw, act);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT>
static int launch_quant(const void* x, const int8_t* w, const float* scales, void* y, int M,
                        int K, int N, int ldx, int ldw, int act, cudaStream_t stream) {
#define LAUNCH(BM) launch_quant_bm<BM, XT>(x, w, scales, y, M, K, N, ldx, ldw, act, stream)
  DTILE_DISPATCH_BM(M, LAUNCH)
#undef LAUNCH
}

template <int BM>
static int launch_q78_bm(const int16_t* a, const int16_t* w, int32_t* y, int M, int K, int N,
                         int lda, int ldw, cudaStream_t stream) {
  constexpr int kCols = dtile::Tile<int16_t>::kCols;
  const dim3 grid((N + kCols - 1) / kCols, (M + BM - 1) / BM);
  q78_matmul_kernel<BM><<<grid, dtile::kThreads, 0, stream>>>(a, w, y, M, K, N, lda, ldw);
  return static_cast<int>(cudaGetLastError());
}

// x (M, K) f32|bf16 with row stride ldx; w (K, N) int8 with row stride ldw;
// scales (N,) f32; y (M, N) contiguous in x's dtype; act an Act code.  bm
// 0 selects the CUDA-core kernel; bm 128 (split 1) or 64 (split 1..8) the
// wgmma regime, which takes bf16 x and w 16-byte aligned with K * 2,
// ldx * 2 and ldw multiples of 16.  Returns a cudaError_t code (0 =
// launched).
extern "C" int quant_matmul_launch(const void* x, const int8_t* w, const float* scales, void* y,
                                   int M, int K, int N, int ldx, int ldw, int act, int x_dtype,
                                   int bm, int split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return 0;
  if (bm != 0) {
    if (x_dtype != DT_BF16 || K <= 0 || !wcol::valid_regime(bm, split))
      return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap xmap, wmap;
    if (!wcol::encode_x_map(&xmap, x, M, K, bm, ldx) || !wcol::encode_w_map(&wmap, w, K, N, ldw))
      return static_cast<int>(cudaErrorInvalidValue);
    const int n_cols = (N + wcol::kBN - 1) / wcol::kBN;
    const wcol::ColList wl{nullptr, nullptr, nullptr, scales, (K + wcol::kBK - 1) / wcol::kBK};
    auto* yb = static_cast<__nv_bfloat16*>(y);
    if (bm == 128)
      return wcol::launch_column<2, 3>(quant_matmul_wgmma_kernel<2, 3>, M, n_cols, 1, s, xmap,
                                       wmap, wl, yb, M, N, 1, act);
    return wcol::launch_column<1, 4>(quant_matmul_wgmma_kernel<1, 4>, M, n_cols, split, s, xmap,
                                     wmap, wl, yb, M, N, split, act);
  }
  if (x_dtype == DT_F32) return launch_quant<float>(x, w, scales, y, M, K, N, ldx, ldw, act, s);
  if (x_dtype == DT_BF16) return launch_quant<__nv_bfloat16>(x, w, scales, y, M, K, N, ldx, ldw, act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// a (M, K) int16 with row stride lda; w (K, N) int16 with row stride ldw;
// y (M, N) int32 contiguous.  Returns a cudaError_t code (0 = launched).
extern "C" int q78_matmul_launch(const int16_t* a, const int16_t* w, int32_t* y, int M, int K,
                                 int N, int lda, int ldw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return 0;
#define LAUNCH(BM) launch_q78_bm<BM>(a, w, y, M, K, N, lda, ldw, s)
  DTILE_DISPATCH_BM(M, LAUNCH)
#undef LAUNCH
}
