// One output block-column of a block-sparse product in fp32 on the CUDA
// cores, for the pairs with an fp32 operand (fp32 x, or the fp32 payload of
// --compress block_sparse), shared by B1, B2 and B4: fp32 weights are never
// rounded to bf16.
//
// A CTA of kThreads threads owns output block-column j for BM rows of x
// (thread t: column t % BN, rows (t / BN) * kRows .. + kRows) and loops over
// the column's live slots 0 .. count-1; each step stages the (BK, BN)
// payload block by cp.async, double-buffered so that block s+1 is in flight
// while block s multiplies, and the matching (BM, BK) x slice as fp32.
// Rows past M are zero-filled in shared memory (never read) and threads
// whose rows all lie past M skip their FMAs.  A stack of experts runs with
// gridDim.z = E, CTA z on expert z's operands (as wgmma_column.cuh lays
// them out: x (E, M, K), blocks (E, N/128 * mb, ...), y (E, M, N)).
#pragma once

#include "common.cuh"

namespace fcol {

constexpr int BK = 128;
constexpr int BN = 128;
constexpr int BM = 64;
constexpr int kThreads = 256;
constexpr int kRows = BM / (kThreads / BN);  // 32 rows per thread
constexpr int XLD = BM + 4;                  // fp32 per shared k-row of the x slice

template <typename WT>
constexpr size_t smem_bytes() {
  return 2 * sizeof(WT) * BK * BN + sizeof(float) * BK * XLD;
}

// acc[r] += x[m0 + r0 + r, :] @ W[:, n] over the column's live blocks, for
// this thread's column n and rows r0 ..; all kThreads threads call it
template <typename XT, typename WT>
__device__ __forceinline__ void stream_column(const XT* __restrict__ x, int M, int K, int m0,
                                              const WT* __restrict__ col_blocks,
                                              const int* __restrict__ col_rows, int count,
                                              unsigned char* smem, float (&acc)[kRows]) {
  WT* wbuf = reinterpret_cast<WT*>(smem);
  float* xs = reinterpret_cast<float*>(smem + 2 * sizeof(WT) * BK * BN);  // xs[k * XLD + m]
  const int tid = threadIdx.x;
  const int n = tid % BN;
  const int r0 = (tid / BN) * kRows;
  const bool active = m0 + r0 < M;  // warp-uniform

  auto fetch = [&](int s, int buf) {
    constexpr int kChunks = static_cast<int>(sizeof(WT) * BK * BN / 16);
    const char* src = reinterpret_cast<const char*>(col_blocks + static_cast<size_t>(s) * BK * BN);
    char* dst = reinterpret_cast<char*>(wbuf + buf * BK * BN);
    for (int c = tid; c < kChunks; c += kThreads) cp_async16(dst + 16 * c, src + 16 * c);
  };

  if (count > 0) fetch(0, 0);
  cp_async_commit();
  for (int s = 0; s < count; ++s) {
    const int buf = s & 1;
    if (s + 1 < count) fetch(s + 1, buf ^ 1);
    cp_async_commit();
    const int kb = col_rows[s] * BK;
    for (int i = tid; i < BM * BK; i += kThreads) {
      const int m = i / BK, k = i % BK, gm = m0 + m;
      xs[k * XLD + m] = gm < M ? to_float(x[static_cast<size_t>(gm) * K + kb + k]) : 0.0f;
    }
    cp_async_wait<1>();
    __syncthreads();
    if (active) {
      const WT* wb = wbuf + buf * BK * BN;
#pragma unroll 2
      for (int k = 0; k < BK; ++k) {
        const float w = to_float(wb[k * BN + n]);
        const float4* xr = reinterpret_cast<const float4*>(xs + k * XLD + r0);
#pragma unroll
        for (int q = 0; q < kRows / 4; ++q) {
          const float4 a = xr[q];
          acc[4 * q + 0] = fmaf(a.x, w, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(a.y, w, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(a.z, w, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(a.w, w, acc[4 * q + 3]);
        }
      }
    }
    __syncthreads();  // the next step overwrites xs and this step's buffer
  }
}

// y = x @ W * scales for one (column j, BM-row tile): B1's and B4's fp32 pairs
template <typename XT, typename WT>
__global__ void __launch_bounds__(kThreads)
column_fma_kernel(const XT* __restrict__ x, const WT* __restrict__ blocks,
                  const int* __restrict__ block_rows, const int* __restrict__ counts,
                  const float* __restrict__ scales, XT* __restrict__ y, int M, int K, int N,
                  int mb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int j = blockIdx.x;
  const int m0 = blockIdx.y * BM;
  const size_t z = blockIdx.z, n_cols = N / BN;
  x += z * M * K;
  y += z * M * N;
  blocks += z * n_cols * mb * BK * BN;
  block_rows += z * n_cols * mb;
  counts += z * n_cols;
  if (scales != nullptr) scales += z * N;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  stream_column<XT, WT>(x, M, K, m0, blocks + static_cast<size_t>(j) * mb * BK * BN,
                        block_rows + static_cast<size_t>(j) * mb, counts[j], smem, acc);
  const int n = threadIdx.x % BN, r0 = (threadIdx.x / BN) * kRows;
  const float sc = scales != nullptr ? scales[j * BN + n] : 1.0f;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int m = m0 + r0 + r;
    if (m < M) y[static_cast<size_t>(m) * N + j * BN + n] = from_float<XT>(acc[r] * sc);
  }
}

template <typename XT, typename WT>
int launch_column_fma(const void* x, const void* blocks, const int* rows, const int* counts,
                      const float* scales, void* y, int M, int K, int N, int mb, int n_stack,
                      cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<WT>();
  auto kern = column_fma_kernel<XT, WT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(N / BN, (M + BM - 1) / BM, n_stack);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const XT*>(x), static_cast<const WT*>(blocks),
                                         rows, counts, scales, static_cast<XT*>(y), M, K, N, mb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fcol
