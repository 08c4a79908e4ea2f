// B4: block-sparse (optionally int8) matmul  y = (x @ W) * scales  for
// Hopper, for a packed weight that carries no pack-time walk.
//
// Replaces repro/kernels/block_sparse.py:block_sparse_matmul (line 84; the
// Pallas per-column kernel _bsmm_kernel), the reference's route for a packed
// weight without a walk.  The TPU kernel runs a static (batch tile, column,
// max_blocks) grid and skips steps past counts[j].
//
// What bounds it on this card: at decode (M <= 64) every payload byte feeds
// at most M MACs, so the weight stream bounds it (surviving payload + scales
// + x + y over 3.35 TB/s); at prefill (M up to 2032) each block serves every
// row, and the bf16 tensor-core rate bounds it.
//
// Design: B1's.  B4 takes exactly B1's operands (the pack layout, block_rows
// and counts), and B1's Hopper schedule never reads the walk either: a CTA
// loops over block_rows[j, 0 .. counts[j]-1] of its output block-column,
// the walk staying on the host.  So bf16 x against an int8 payload runs
// wgmma_column.cuh's column body under B4's own kernel name (the profiler
// and the launch counters tell the two apart): a producer warp keeps a ring
// of bulk copies (payload) and TMA loads (x) in flight on mbarriers, the
// consumers convert each block exactly to bf16 and multiply on wgmma with
// fp32 sums; 128-row tiles at prefill, one 64-row tile with a column's
// slots split over a cluster at decode, the regime picked by the host from
// shapes (kernels/block_sparse.launch_plan).  Same body, same regime: on
// the same operands B4's output equals B1's bit for bit.  Pairs with an
// fp32 operand (fp32 x, or the fp32 payload of --compress block_sparse) run
// fp32 CUDA-core FMAs (fma_column.cuh): fp32 weights are never rounded to
// bf16.
//
// Hazards handled: a column with counts[j] == 0 writes zeros (the output
// comes from torch.empty); a cluster rank with no slot adds zeros; the
// ragged M edge is masked (x rows past M arrive as zeros, never read).
#include "fma_column.cuh"
#include "wgmma_column.cuh"

template <int NC, int S>
__global__ void __launch_bounds__(wcol::Geometry<NC, S>::kThreads, 1)
bsmm_col_kernel(const __grid_constant__ CUtensorMap xmap, const wcol::ColList w,
                __nv_bfloat16* __restrict__ y, int M, int N, int split) {
  extern __shared__ __align__(1024) unsigned char smem[];
  wcol::column_body<NC, S, false>(&xmap, w, w, y, M, N, split, 0, smem);
}

// x (M, K) f32|bf16, 16-byte aligned; blocks (N/128 * mb, 128, 128)
// int8|f32; block_rows (N/128, mb) int32; counts (N/128,) int32; scales (N,)
// f32 or null; y (M, N) in x's dtype.  bm 0 selects the CUDA-core FMA
// body (fp32 x or an f32 payload); bm 128 (split 1) or 64 (split 1..8) the
// wgmma body, which takes bf16 x against an int8 payload.  The host picks
// the body (kernels/block_sparse.body_plan).  n_experts > 1: a stack of
// that many weights, every operand with that lead dim (x (E, M, K), y (E,
// M, N)), one launch.
// Returns a cudaError_t code (0 = launched).
extern "C" int bsmm_col_launch(const void* x, const void* blocks, const int* block_rows,
                               const int* counts, const float* scales, void* y, int M, int K,
                               int N, int mb, int n_experts, int x_dtype, int w_dtype, int bm,
                               int split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || n_experts <= 0) return 0;
  if (bm != 0) {
    if (w_dtype != DT_I8 || x_dtype != DT_BF16 || !wcol::valid_regime(bm, split))
      return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap xmap;
    if (!wcol::encode_x_map(&xmap, x, n_experts * M, K, bm))
      return static_cast<int>(cudaErrorInvalidValue);
    const wcol::ColList w{static_cast<const int8_t*>(blocks), block_rows, counts, scales, mb};
    auto* yb = static_cast<__nv_bfloat16*>(y);
    if (bm == 128)
      return wcol::launch_column<2, 3>(bsmm_col_kernel<2, 3>, M, N / 128, 1, n_experts, s, xmap,
                                       w, yb, M, N, 1);
    return wcol::launch_column<1, 4>(bsmm_col_kernel<1, 4>, M, N / 128, split, n_experts, s,
                                     xmap, w, yb, M, N, split);
  }
#define B4_ARGS x, blocks, block_rows, counts, scales, y, M, K, N, mb, n_experts, s
  if (w_dtype == DT_I8 && x_dtype == DT_F32) return fcol::launch_column_fma<float, int8_t>(B4_ARGS);
  if (w_dtype == DT_F32) {
    if (x_dtype == DT_BF16) return fcol::launch_column_fma<__nv_bfloat16, float>(B4_ARGS);
    if (x_dtype == DT_F32) return fcol::launch_column_fma<float, float>(B4_ARGS);
  }
#undef B4_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
