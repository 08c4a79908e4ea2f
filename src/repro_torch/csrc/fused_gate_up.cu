// B2: fused gated-FFN projection  y = act(x @ Wg * sg) * (x @ Wu * su).
//
// Replaces repro/kernels/fused_gate_up.py:fused_gate_up (the Pallas fused
// pair).  Same column structure as B1: one CTA per (output block-column j,
// M-tile), with two fp32 accumulators.  Gate and up are pruned
// independently, so each side walks its own block list and stops at its own
// count (block_column.cuh streams the gate column, then the up column).
// The epilogue applies both scale vectors and the activation and writes
// act(hg) * hu once: the gate projection never goes to device memory.
//
// Bound on this card: the weight stream, as for B1 (both surviving
// payloads + both scale vectors + x + y over 3.35 TB/s at decode).
#include "block_column.cuh"

template <typename XT, typename WT>
__global__ void __launch_bounds__(bcol::kThreads)
fused_gate_up_kernel(const XT* __restrict__ x,
                     const WT* __restrict__ g_blocks, const int* __restrict__ g_rows,
                     const int* __restrict__ g_counts, const float* __restrict__ g_scales,
                     const WT* __restrict__ u_blocks, const int* __restrict__ u_rows,
                     const int* __restrict__ u_counts, const float* __restrict__ u_scales,
                     XT* __restrict__ y, int M, int K, int N, int mb_g, int mb_u, int act) {
  using namespace bcol;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WT* wbuf = reinterpret_cast<WT*>(smem_raw);
  float* xs = reinterpret_cast<float*>(smem_raw + 2 * sizeof(WT) * kBK * kBN);

  const int j = blockIdx.x;
  const int m0 = blockIdx.y * kMTile;
  float hg[kRowsPerThread], hu[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) hg[r] = hu[r] = 0.0f;

  stream_column<XT, WT>(x, M, K, m0, g_blocks + static_cast<size_t>(j) * mb_g * kBK * kBN,
                        g_rows + static_cast<size_t>(j) * mb_g, g_counts[j], wbuf, xs, hg);
  stream_column<XT, WT>(x, M, K, m0, u_blocks + static_cast<size_t>(j) * mb_u * kBK * kBN,
                        u_rows + static_cast<size_t>(j) * mb_u, u_counts[j], wbuf, xs, hu);

  const int n = j * kBN + threadIdx.x % kBN;
  const int r0 = (threadIdx.x / kBN) * kRowsPerThread;
  const float sg = g_scales != nullptr ? g_scales[n] : 1.0f;
  const float su = u_scales != nullptr ? u_scales[n] : 1.0f;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int m = m0 + r0 + r;
    if (m < M) y[static_cast<size_t>(m) * N + n] = from_float<XT>(apply_act(act, hg[r] * sg) * (hu[r] * su));
  }
}

template <typename XT, typename WT>
static int launch(const void* x, const void* gb, const int* gr, const int* gc, const float* gs,
                  const void* ub, const int* ur, const int* uc, const float* us, void* y,
                  int M, int K, int N, int mb_g, int mb_u, int act, cudaStream_t stream) {
  using namespace bcol;
  const size_t smem = smem_bytes<WT>();
  auto kern = fused_gate_up_kernel<XT, WT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(N / kBN, (M + kMTile - 1) / kMTile);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const WT*>(gb), gr, gc, gs,
      static_cast<const WT*>(ub), ur, uc, us, static_cast<XT*>(y), M, K, N, mb_g, mb_u, act);
  return static_cast<int>(cudaGetLastError());
}

// Gate and up share dtype, dense shape (K, N) and the 128x128 block
// geometry; each has its own (N/128 * mb, 128, 128) payload, (N/128, mb)
// rows and (N/128,) counts.  Scales are both given or both null.
extern "C" int fused_gate_up_launch(const void* x,
                                    const void* g_blocks, const int* g_rows, const int* g_counts,
                                    const float* g_scales,
                                    const void* u_blocks, const int* u_rows, const int* u_counts,
                                    const float* u_scales,
                                    void* y, int M, int K, int N, int mb_g, int mb_u, int act,
                                    int x_dtype, int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0) return 0;
#define FGU_ARGS x, g_blocks, g_rows, g_counts, g_scales, u_blocks, u_rows, u_counts, u_scales, y, M, K, N, mb_g, mb_u, act, s
  if (w_dtype == DT_I8) {
    if (x_dtype == DT_BF16) return launch<__nv_bfloat16, int8_t>(FGU_ARGS);
    if (x_dtype == DT_F32) return launch<float, int8_t>(FGU_ARGS);
  } else if (w_dtype == DT_F32) {
    if (x_dtype == DT_BF16) return launch<__nv_bfloat16, float>(FGU_ARGS);
    if (x_dtype == DT_F32) return launch<float, float>(FGU_ARGS);
  }
#undef FGU_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
