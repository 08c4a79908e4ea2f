// B2: fused gated-FFN projection  y = act(x @ Wg * sg) * (x @ Wu * su).
//
// Replaces repro/kernels/fused_gate_up.py:fused_gate_up (the Pallas fused
// pair).  Gate and up are pruned independently, so each side keeps its own
// block list, counts and mb; one launch walks the gate column's live slots
// into one fp32 accumulator and the up column's into another, and the
// epilogue applies both scale vectors and the activation and writes
// act(hg) * hu once: the gate projection never goes to device memory.
//
// What bounds it on this card: the weight stream at decode (both surviving
// payloads + both scale vectors + x + y over 3.35 TB/s), the bf16 tensor-core
// rate at prefill.  The design is B1's (wgmma_column.cuh) with two
// accumulators: wgmma on bf16 operands, the int8 blocks converted exactly to
// bf16, a producer warp streaming gate then up blocks through a ring of
// bulk copies and TMA loads; prefill (bm 128) one CTA per (column, 128-row
// tile); decode (bm 64) both slot lists split over a cluster of ``split``
// CTAs, rank 0 adding the partials and applying act(g * sg) * (u * su).
// Deterministic (no float atomics).  Pairs with an fp32 operand run fp32
// CUDA-core FMAs (fma_column.cuh).
//
// Hazards handled: counts of 0 write act(0) * 0 = 0; a cluster rank with no
// slot adds zeros; mb_g != mb_u; the ragged M edge is masked.
#include "fma_column.cuh"
#include "wgmma_column.cuh"

template <int NC, int S>
__global__ void __launch_bounds__(wcol::Geometry<NC, S>::kThreads, 1)
fused_gate_up_kernel(const __grid_constant__ CUtensorMap xmap, const wcol::ColList g,
                     const wcol::ColList u, __nv_bfloat16* __restrict__ y, int M, int N,
                     int split, int act) {
  extern __shared__ __align__(1024) unsigned char smem[];
  wcol::column_body<NC, S, true>(&xmap, g, u, y, M, N, split, act, smem);
}

// the fp32 pairs: both columns through fcol::stream_column, 64 rows per CTA
template <typename XT, typename WT>
__global__ void __launch_bounds__(fcol::kThreads)
fused_gate_up_fma_kernel(const XT* __restrict__ x,
                         const WT* __restrict__ g_blocks, const int* __restrict__ g_rows,
                         const int* __restrict__ g_counts, const float* __restrict__ g_scales,
                         const WT* __restrict__ u_blocks, const int* __restrict__ u_rows,
                         const int* __restrict__ u_counts, const float* __restrict__ u_scales,
                         XT* __restrict__ y, int M, int K, int N, int mb_g, int mb_u, int act) {
  using namespace fcol;
  extern __shared__ __align__(1024) unsigned char smem[];  // as the wgmma kernel declares it
  const int j = blockIdx.x;
  const int m0 = blockIdx.y * BM;
  const size_t z = blockIdx.z, n_cols = N / BN;  // expert z of a stack
  x += z * M * K;
  y += z * M * N;
  g_blocks += z * n_cols * mb_g * BK * BN;
  g_rows += z * n_cols * mb_g;
  g_counts += z * n_cols;
  u_blocks += z * n_cols * mb_u * BK * BN;
  u_rows += z * n_cols * mb_u;
  u_counts += z * n_cols;
  if (g_scales != nullptr) g_scales += z * N;
  if (u_scales != nullptr) u_scales += z * N;
  float hg[kRows], hu[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) hg[r] = hu[r] = 0.0f;
  stream_column<XT, WT>(x, M, K, m0, g_blocks + static_cast<size_t>(j) * mb_g * BK * BN,
                        g_rows + static_cast<size_t>(j) * mb_g, g_counts[j], smem, hg);
  stream_column<XT, WT>(x, M, K, m0, u_blocks + static_cast<size_t>(j) * mb_u * BK * BN,
                        u_rows + static_cast<size_t>(j) * mb_u, u_counts[j], smem, hu);
  const int n = j * BN + threadIdx.x % BN;
  const int r0 = (threadIdx.x / BN) * kRows;
  const float sg = g_scales != nullptr ? g_scales[n] : 1.0f;
  const float su = u_scales != nullptr ? u_scales[n] : 1.0f;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int m = m0 + r0 + r;
    if (m < M)
      y[static_cast<size_t>(m) * N + n] = from_float<XT>(apply_act(act, hg[r] * sg) * (hu[r] * su));
  }
}

template <typename XT, typename WT>
static int launch_fma(const void* x, const void* gb, const int* gr, const int* gc,
                      const float* gs,
                      const void* ub, const int* ur, const int* uc, const float* us, void* y,
                      int M, int K, int N, int mb_g, int mb_u, int act, int n_stack,
                      cudaStream_t stream) {
  constexpr size_t smem = fcol::smem_bytes<WT>();
  auto kern = fused_gate_up_fma_kernel<XT, WT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(N / fcol::BN, (M + fcol::BM - 1) / fcol::BM, n_stack);
  kern<<<grid, fcol::kThreads, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const WT*>(gb), gr, gc, gs,
      static_cast<const WT*>(ub), ur, uc, us, static_cast<XT*>(y), M, K, N, mb_g, mb_u, act);
  return static_cast<int>(cudaGetLastError());
}

// Gate and up share dtype, dense shape (K, N) and the 128x128 block
// geometry; each has its own (N/128 * mb, 128, 128) payload, (N/128, mb)
// rows and (N/128,) counts.  Scales are both given or both null.  x is
// 16-byte aligned; bm (0 for the CUDA-core FMA body), split and n_experts
// (a stack of pairs, every operand with that lead dim) as for bsmm_launch.
extern "C" int fused_gate_up_launch(const void* x,
                                    const void* g_blocks, const int* g_rows, const int* g_counts,
                                    const float* g_scales,
                                    const void* u_blocks, const int* u_rows, const int* u_counts,
                                    const float* u_scales,
                                    void* y, int M, int K, int N, int mb_g, int mb_u, int act,
                                    int x_dtype, int w_dtype, int bm, int split, int n_experts,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || n_experts <= 0) return 0;
  if (bm != 0) {
    if (w_dtype != DT_I8 || x_dtype != DT_BF16 || !wcol::valid_regime(bm, split))
      return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap xmap;
    if (!wcol::encode_x_map(&xmap, x, n_experts * M, K, bm))
      return static_cast<int>(cudaErrorInvalidValue);
    const wcol::ColList g{static_cast<const int8_t*>(g_blocks), g_rows, g_counts, g_scales, mb_g};
    const wcol::ColList u{static_cast<const int8_t*>(u_blocks), u_rows, u_counts, u_scales, mb_u};
    auto* yb = static_cast<__nv_bfloat16*>(y);
    if (bm == 128)
      return wcol::launch_column<2, 3>(fused_gate_up_kernel<2, 3>, M, N / 128, 1, n_experts, s,
                                       xmap, g, u, yb, M, N, 1, act);
    return wcol::launch_column<1, 4>(fused_gate_up_kernel<1, 4>, M, N / 128, split, n_experts, s,
                                     xmap, g, u, yb, M, N, split, act);
  }
#define FGU_ARGS x, g_blocks, g_rows, g_counts, g_scales, u_blocks, u_rows, u_counts, u_scales, y, M, K, N, mb_g, mb_u, act, n_experts, s
  if (w_dtype == DT_I8 && x_dtype == DT_F32) return launch_fma<float, int8_t>(FGU_ARGS);
  if (w_dtype == DT_F32) {
    if (x_dtype == DT_BF16) return launch_fma<__nv_bfloat16, float>(FGU_ARGS);
    if (x_dtype == DT_F32) return launch_fma<float, float>(FGU_ARGS);
  }
#undef FGU_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
