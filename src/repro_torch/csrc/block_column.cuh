// One output block-column of a block-sparse product, shared by the B1
// (block_sparse.cu) and B2 (fused_gate_up.cu) kernels.
//
// A CTA of kThreads threads owns output block-column j (kBN columns) for an
// M-tile of kMTile rows.  It walks the column's surviving blocks
// block_rows[j, 0 .. count-1] in order; each step stages one (kBK, kBN)
// payload block in shared memory with cp.async, double-buffered so that
// block s+1 is in flight while block s multiplies, and stages the matching
// (kMTile, kBK) activation slice x[:, rows[s]*kBK : +kBK] as fp32.  The
// multiply-accumulate runs in fp32 on the CUDA cores: thread t owns output
// column t % kBN and rows (t / kBN) * kRowsPerThread .. + kRowsPerThread.
//
// Pruned blocks have no entry in the column's list, so they are never read:
// the bytes streamed are the surviving payload only.
#pragma once

#include "common.cuh"

namespace bcol {

constexpr int kBK = 128;
constexpr int kBN = 128;
constexpr int kMTile = 16;
constexpr int kThreads = 256;
constexpr int kRowGroups = kThreads / kBN;            // 2
constexpr int kRowsPerThread = kMTile / kRowGroups;  // 8
static_assert(kRowsPerThread == 8, "stream_column unrolls eight rows per thread");

// shared memory for one column stream: two payload buffers + the x slice
template <typename WT>
constexpr size_t smem_bytes() {
  return 2 * sizeof(WT) * kBK * kBN + sizeof(float) * kBK * kMTile;
}

template <typename WT>
__device__ __forceinline__ void fetch_block(WT* dst, const WT* src) {
  constexpr int kChunks = static_cast<int>(sizeof(WT) * kBK * kBN / 16);
  const char* s = reinterpret_cast<const char*>(src);
  char* d = reinterpret_cast<char*>(dst);
  for (int c = threadIdx.x; c < kChunks; c += kThreads) cp_async16(d + 16 * c, s + 16 * c);
}

// acc[r] += sum over the column's surviving blocks of x[m0 + row, :] @ block,
// for this thread's rows and column.  Must be called by all kThreads threads.
template <typename XT, typename WT>
__device__ void stream_column(const XT* __restrict__ x, int M, int K, int m0,
                              const WT* __restrict__ col_blocks,  // (mb, kBK, kBN) of column j
                              const int* __restrict__ col_rows,   // (mb,) row blocks of column j
                              int count, WT* wbuf, float* xs, float acc[kRowsPerThread]) {
  const int tid = threadIdx.x;
  const int n = tid % kBN;
  const int r0 = (tid / kBN) * kRowsPerThread;
  if (count <= 0) return;
  fetch_block(wbuf, col_blocks);
  cp_async_commit();
  for (int s = 0; s < count; ++s) {
    if (s + 1 < count)
      fetch_block(wbuf + ((s + 1) & 1) * kBK * kBN, col_blocks + static_cast<size_t>(s + 1) * kBK * kBN);
    cp_async_commit();  // possibly empty group: keeps wait_group<1> exact
    // activation slice, stored k-major (xs[k * kMTile + m]) so that one
    // thread's kRowsPerThread rows are contiguous for vector loads
    const int kb = col_rows[s] * kBK;
    for (int i = tid; i < kMTile * kBK; i += kThreads) {
      const int m = i / kBK, k = i % kBK;
      const int gm = m0 + m;
      xs[k * kMTile + m] = gm < M ? to_float(x[static_cast<size_t>(gm) * K + kb + k]) : 0.0f;
    }
    cp_async_wait<1>();
    __syncthreads();
    const WT* wb = wbuf + (s & 1) * kBK * kBN;
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      const float w = to_float(wb[k * kBN + n]);
      const float4 a = *reinterpret_cast<const float4*>(xs + k * kMTile + r0);
      const float4 b = *reinterpret_cast<const float4*>(xs + k * kMTile + r0 + 4);
      acc[0] = fmaf(a.x, w, acc[0]);
      acc[1] = fmaf(a.y, w, acc[1]);
      acc[2] = fmaf(a.z, w, acc[2]);
      acc[3] = fmaf(a.w, w, acc[3]);
      acc[4] = fmaf(b.x, w, acc[4]);
      acc[5] = fmaf(b.y, w, acc[5]);
      acc[6] = fmaf(b.z, w, acc[6]);
      acc[7] = fmaf(b.w, w, acc[7]);
    }
    __syncthreads();  // buffers and xs are rewritten by the next step
  }
}

}  // namespace bcol
