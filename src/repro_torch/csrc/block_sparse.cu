// B1: block-sparse (optionally int8) matmul  y = (x @ W) * scales  for Hopper.
//
// Replaces repro/kernels/block_sparse.py:block_sparse_matmul_mc (the Pallas
// walk kernel).  The TPU kernel walks a pack-time block list because its
// grid runs in order on one core; on Hopper the CTAs run in parallel, so
// the schedule is per output block-column: a CTA loops over
// block_rows[j, 0 .. counts[j]-1] (the walk stays on the host).
//
// What bounds it on this card: at decode (M <= 64) every payload byte feeds
// at most M MACs, far below the ~295 FLOP/byte balance point, so the
// weight stream bounds it (surviving payload + scales + x + y over
// 3.35 TB/s); at prefill (M up to 2032) each block serves every row, and
// the bf16 tensor-core rate bounds it.  The design for bf16 x against an
// int8 payload (the served pair; wgmma_column.cuh): wgmma on bf16 operands
// with fp32 sums, the int8 block converted exactly to bf16 into the layout
// the B descriptor reads, a producer warp keeping a ring of bulk copies
// (payload) and TMA loads (x) in flight on mbarriers.  Prefill (bm 128):
// one CTA per (column, 128-row tile), two consumer warpgroups, each block
// streamed once per 128 rows.  Decode (bm 64): one 64-row tile, a column's
// slots split over a cluster of ``split`` CTAs whose partial sums rank 0
// adds from their shared memory, so that a column's blocks stream in
// parallel.  The host picks bm and split from shapes it knows
// (kernels/block_sparse.py:launch_plan); no float atomics, so two launches
// give the same bits.  Pairs with an fp32 operand run fp32 CUDA-core FMAs
// (fma_column.cuh): fp32 weights are never rounded to bf16.
//
// Hazards handled: a column with counts[j] == 0 writes zeros (the output
// comes from torch.empty); a cluster rank with no slot adds zeros; the
// ragged M edge is masked (x rows past M arrive as zeros, never read).
#include "fma_column.cuh"
#include "wgmma_column.cuh"

template <int NC, int S>
__global__ void __launch_bounds__(wcol::Geometry<NC, S>::kThreads, 1)
bsmm_kernel(const __grid_constant__ CUtensorMap xmap, const wcol::ColList w,
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
extern "C" int bsmm_launch(const void* x, const void* blocks, const int* block_rows,
                           const int* counts, const float* scales, void* y, int M, int K, int N,
                           int mb, int n_experts, int x_dtype, int w_dtype, int bm, int split,
                           void* stream) {
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
      return wcol::launch_column<2, 3>(bsmm_kernel<2, 3>, M, N / 128, 1, n_experts, s, xmap, w,
                                       yb, M, N, 1);
    return wcol::launch_column<1, 4>(bsmm_kernel<1, 4>, M, N / 128, split, n_experts, s, xmap, w,
                                     yb, M, N, split);
  }
#define B1_ARGS x, blocks, block_rows, counts, scales, y, M, K, N, mb, n_experts, s
  if (w_dtype == DT_I8 && x_dtype == DT_F32) return fcol::launch_column_fma<float, int8_t>(B1_ARGS);
  if (w_dtype == DT_F32) {
    if (x_dtype == DT_BF16) return fcol::launch_column_fma<__nv_bfloat16, float>(B1_ARGS);
    if (x_dtype == DT_F32) return fcol::launch_column_fma<float, float>(B1_ARGS);
  }
#undef B1_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
