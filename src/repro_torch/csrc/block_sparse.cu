// B1: block-sparse (optionally int8) matmul  y = x @ W  for Hopper.
//
// Replaces repro/kernels/block_sparse.py:block_sparse_matmul_mc (the Pallas
// walk kernel).  The TPU kernel walks a pack-time block list because its
// grid runs in order on one core; on Hopper the CTAs run in parallel, so
// the natural schedule is one CTA per (output block-column j, M-tile) that
// loops over block_rows[j, 0 .. counts[j]-1] (block_column.cuh).
//
// Bound on this card: at decode M <= max_batch, so every payload byte is
// used for at most M MACs and the kernel is bound by the weight stream
// (surviving int8 payload + scales + x + y over 3.35 TB/s).  The design
// reads only surviving blocks, one byte per int8 weight, with the next
// block's copy in flight (cp.async double buffer) while the current one
// multiplies.  It does not yet use the tensor cores (wgmma) or TMA.
//
// Hazards handled: a column with counts[j] == 0 writes zeros (the output
// comes from torch.empty); the ragged M edge is masked (no padding of x).
#include "block_column.cuh"

template <typename XT, typename WT>
__global__ void __launch_bounds__(bcol::kThreads)
bsmm_kernel(const XT* __restrict__ x, const WT* __restrict__ blocks,
            const int* __restrict__ block_rows, const int* __restrict__ counts,
            const float* __restrict__ scales, XT* __restrict__ y, int M, int K, int N, int mb) {
  using namespace bcol;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WT* wbuf = reinterpret_cast<WT*>(smem_raw);
  float* xs = reinterpret_cast<float*>(smem_raw + 2 * sizeof(WT) * kBK * kBN);

  const int j = blockIdx.x;
  const int m0 = blockIdx.y * kMTile;
  float acc[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.0f;

  stream_column<XT, WT>(x, M, K, m0, blocks + static_cast<size_t>(j) * mb * kBK * kBN,
                        block_rows + static_cast<size_t>(j) * mb, counts[j], wbuf, xs, acc);

  const int n = j * kBN + threadIdx.x % kBN;
  const int r0 = (threadIdx.x / kBN) * kRowsPerThread;
  const float sc = scales != nullptr ? scales[n] : 1.0f;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int m = m0 + r0 + r;
    if (m < M) y[static_cast<size_t>(m) * N + n] = from_float<XT>(acc[r] * sc);
  }
}

template <typename XT, typename WT>
static int launch(const void* x, const void* blocks, const int* rows, const int* counts,
                  const float* scales, void* y, int M, int K, int N, int mb, cudaStream_t stream) {
  using namespace bcol;
  const size_t smem = smem_bytes<WT>();
  auto kern = bsmm_kernel<XT, WT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(N / kBN, (M + kMTile - 1) / kMTile);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const XT*>(x), static_cast<const WT*>(blocks),
                                          rows, counts, scales, static_cast<XT*>(y), M, K, N, mb);
  return static_cast<int>(cudaGetLastError());
}

// x (M, K) f32|bf16; blocks (N/128 * mb, 128, 128) int8|f32; block_rows
// (N/128, mb) int32; counts (N/128,) int32; scales (N,) f32 or null;
// y (M, N) in x's dtype.  Returns a cudaError_t code (0 = launched).
extern "C" int bsmm_launch(const void* x, const void* blocks, const int* block_rows,
                           const int* counts, const float* scales, void* y, int M, int K, int N,
                           int mb, int x_dtype, int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0) return 0;
  if (w_dtype == DT_I8) {
    if (x_dtype == DT_BF16) return launch<__nv_bfloat16, int8_t>(x, blocks, block_rows, counts, scales, y, M, K, N, mb, s);
    if (x_dtype == DT_F32) return launch<float, int8_t>(x, blocks, block_rows, counts, scales, y, M, K, N, mb, s);
  } else if (w_dtype == DT_F32) {
    if (x_dtype == DT_BF16) return launch<__nv_bfloat16, float>(x, blocks, block_rows, counts, scales, y, M, K, N, mb, s);
    if (x_dtype == DT_F32) return launch<float, float>(x, blocks, block_rows, counts, scales, y, M, K, N, mb, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
