// B7: weight-stationary fully-connected layer  y = act(x @ w + b)  for Hopper.
//
// Replaces repro/kernels/batched_ffn.py:batched_ffn (the Pallas kernel whose
// grid keeps a (bk, bn) weight tile in VMEM while the batch tiles sweep past
// it: the paper's batch processing, Sections 4.2 / 5.5).  Here one CTA owns
// an output tile 32 weight bytes wide (8 fp32 columns) for up to 32 batch
// rows and walks K in a loop (dense_tile.cuh): each weight element is
// loaded once into the register of the thread that owns it and multiplied
// by every batch row of the CTA, so one weight tile serves all B rows.  The fp32 accumulator stays in
// registers; bias and activation run once in the epilogue.
//
// Bound on this card: the paper's nets run at batches of 1..32, i.e. at
// most 32 MACs per weight (fp32: 8 FLOP per byte), far below the H100's
// balance point, so the layer is bound by its weight stream (K * N * 4
// bytes over 3.35 TB/s).  MACs run in fp32 on the CUDA cores, not TF32, as
// the reference accumulates in fp32.  Ragged M, K and N (784, 561, 10, 6,
// 300, 750, ...) are masked in the kernel; nothing is padded.
#include "dense_tile.cuh"

template <int BM, typename XT>
__global__ void __launch_bounds__(dtile::kThreads)
batched_ffn_kernel(const XT* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b, XT* __restrict__ y, int M, int K, int N,
                   int ldx, int ldw, int act) {
  __shared__ dtile::Smem<BM, float, float> sm;
  dtile::tile_product<BM, float>(x, ldx, w, ldw, M, K, N, sm, [=](int m, int n, float s) {
    y[static_cast<size_t>(m) * N + n] = from_float<XT>(apply_act(act, s + b[n]));
  });
}

template <int BM, typename XT>
static int launch_bm(const void* x, const float* w, const float* b, void* y, int M, int K, int N,
                     int ldx, int ldw, int act, cudaStream_t stream) {
  constexpr int kCols = dtile::Tile<float>::kCols;
  const dim3 grid((N + kCols - 1) / kCols, (M + BM - 1) / BM);
  batched_ffn_kernel<BM, XT><<<grid, dtile::kThreads, 0, stream>>>(
      static_cast<const XT*>(x), w, b, static_cast<XT*>(y), M, K, N, ldx, ldw, act);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT>
static int launch(const void* x, const float* w, const float* b, void* y, int M, int K, int N,
                  int ldx, int ldw, int act, cudaStream_t stream) {
#define LAUNCH(BM) launch_bm<BM, XT>(x, w, b, y, M, K, N, ldx, ldw, act, stream)
  DTILE_DISPATCH_BM(M, LAUNCH)
#undef LAUNCH
}

// x (M, K) f32|bf16 with row stride ldx; w (K, N) f32 with row stride ldw;
// b (N,) f32; y (M, N) contiguous in x's dtype; act an Act code.
// Returns a cudaError_t code (0 = launched).
extern "C" int batched_ffn_launch(const void* x, const float* w, const float* b, void* y, int M,
                                  int K, int N, int ldx, int ldw, int act, int x_dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return 0;
  if (x_dtype == DT_F32) return launch<float>(x, w, b, y, M, K, N, ldx, ldw, act, s);
  if (x_dtype == DT_BF16) return launch<__nv_bfloat16>(x, w, b, y, M, K, N, ldx, ldw, act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
