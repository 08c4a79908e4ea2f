// B4: block-sparse (optionally int8) matmul  y = x @ W  for Hopper, one
// output block-column and 64 rows of x per CTA.
//
// Replaces repro/kernels/block_sparse.py:block_sparse_matmul (the Pallas
// per-column kernel _bsmm_kernel), the reference's route for a packed
// weight that carries no pack-time walk.  The TPU kernel runs a static
// (batch tile, column, max_blocks) grid with a batch tile of up to 128
// rows and skips steps past counts[j]; here one CTA per (output
// block-column j, 64-row M-tile) loops over s = 0 .. counts[j]-1 only, so
// tail slots are never read, and pruned blocks have no slot at all.
//
// Bound on this card: at decode (M = 8) every payload byte feeds at most M
// MACs, so the weight stream bounds it (surviving payload + scales + x + y
// over 3.35 TB/s); at prefill (M up to 2032) a block is reused by every
// row, and operations bound it.  The design takes the TPU kernel's large
// batch tile onto the tensor cores: each surviving block is streamed once
// per 64 rows (B1 re-streams it every 16), the next block and its x slice
// are in flight (cp.async double buffer) while the current one multiplies,
// and the products run on mma.sync.m16n8k16 bf16 with fp32 accumulation.
// The int8 block is converted to bf16 in shared memory (exact for |w| <=
// 127), so only the order of the fp32 sums differs from the plain version.
// B operands come from ldmatrix.trans, A operands from 32-bit loads of a
// padded x slice (conflict-free).  Warps whose 16 rows lie past M skip
// their MMAs.  Pairs with an fp32 operand (fp32 x, or the fp32 payload of
// --compress block_sparse) run fp32 CUDA-core FMAs over the same 64-row
// tile (fma_column.cuh, shared with B1 and B2): fp32 weights are never
// rounded to bf16.  wgmma, TMA and a split of
// the k loop across warps at decode are later work.
//
// Hazards handled: a column with counts[j] == 0 writes zeros (the output
// comes from torch.empty); the ragged M edge is masked (x rows past M are
// zero-filled in shared memory, never read; nothing is padded).
#include "fma_column.cuh"
#include "mma.cuh"

#include <type_traits>

namespace {

constexpr int BK = 128;              // block edge (rows of a block: the contraction)
constexpr int BN = 128;              // block edge (columns: one output block-column)
constexpr int BM = 64;               // rows of x per CTA
constexpr int LD = BK + 8;           // bf16 per shared row: conflict-free fragment loads

// -- bf16 x, int8 payload: tensor cores ------------------------------------

constexpr int kMmaThreads = 128;     // 4 warps x 16 rows
constexpr size_t kRawBytes = size_t(BK) * BN;        // one int8 block
constexpr size_t kXsBytes = size_t(BM) * LD * 2;     // one bf16 x slice
constexpr size_t kWbBytes = size_t(BK) * LD * 2;     // the converted bf16 block
constexpr size_t kMmaSmem = 2 * kRawBytes + 2 * kXsBytes + kWbBytes;

// four 8x8 bf16 matrices, transposed: with lane l addressing row
// (l & 15) of a 16-row k slab at column (l >> 4) * 8, r[0..1] are the
// (b0, b1) fragments of the n8 tile at the slab's column 0, r[2..3] of
// the tile at column 8
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__global__ void __launch_bounds__(kMmaThreads)
bsmm_col_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ blocks,
                    const int* __restrict__ block_rows, const int* __restrict__ counts,
                    const float* __restrict__ scales, __nv_bfloat16* __restrict__ y, int M,
                    int K, int N, int mb) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* raw = reinterpret_cast<int8_t*>(smem);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + 2 * kRawBytes);
  __nv_bfloat16* wb = reinterpret_cast<__nv_bfloat16*>(smem + 2 * kRawBytes + 2 * kXsBytes);

  const int j = blockIdx.x;
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment row group, column pair
  const int count = counts[j];
  const int8_t* col_blocks = blocks + static_cast<size_t>(j) * mb * BK * BN;
  const int* col_rows = block_rows + static_cast<size_t>(j) * mb;
  const bool active = m0 + warp * 16 < M;  // warp-uniform

  float acc[BN / 8][4];
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;

  // block s of the column and its x slice x[m0 .. m0+63, rows[s]*BK .. +BK]
  auto load = [&](int s, int buf) {
    const int8_t* src = col_blocks + static_cast<size_t>(s) * BK * BN;
    int8_t* dst = raw + buf * kRawBytes;
    for (int c = tid; c < BK * BN / 16; c += kMmaThreads) cp_async16(dst + 16 * c, src + 16 * c);
    const int kb = col_rows[s] * BK;
    __nv_bfloat16* xd = xs + buf * BM * LD;
    for (int c = tid; c < BM * (BK / 8); c += kMmaThreads) {
      const int r = c / (BK / 8), ch = c % (BK / 8), gm = m0 + r;
      const bool ok = gm < M;
      cp_async16_zfill(xd + r * LD + ch * 8,
                       x + static_cast<size_t>(ok ? gm : 0) * K + kb + ch * 8, ok);
    }
  };

  if (count > 0) load(0, 0);
  cp_async_commit();
  for (int s = 0; s < count; ++s) {
    const int buf = s & 1;
    if (s + 1 < count) load(s + 1, buf ^ 1);
    cp_async_commit();  // possibly empty group: keeps wait_group<1> exact
    cp_async_wait<1>();  // block s and its x slice have landed
    __syncthreads();

    // int8 -> bf16, sixteen values per chunk (exact: |w| <= 127)
    const int8_t* rb = raw + buf * kRawBytes;
    for (int c = tid; c < BK * BN / 16; c += kMmaThreads) {
      const int k = c / (BN / 16), n = (c % (BN / 16)) * 16;
      const int4 v = *reinterpret_cast<const int4*>(rb + 16 * c);
      const int8_t* b = reinterpret_cast<const int8_t*>(&v);
      uint32_t o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        o[e] = pack_bf16(static_cast<float>(b[2 * e]), static_cast<float>(b[2 * e + 1]));
      uint4* d = reinterpret_cast<uint4*>(wb + k * LD + n);
      d[0] = make_uint4(o[0], o[1], o[2], o[3]);
      d[1] = make_uint4(o[4], o[5], o[6], o[7]);
    }
    __syncthreads();

    if (active) {
      const __nv_bfloat16* xa = xs + buf * BM * LD + (warp * 16 + g) * LD + 2 * tig;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        const __nv_bfloat16* p = xa + kk * 16;
        a[0] = ld32(p);
        a[1] = ld32(p + 8 * LD);
        a[2] = ld32(p + 8);
        a[3] = ld32(p + 8 * LD + 8);
        const __nv_bfloat16* wrow = wb + (kk * 16 + (lane & 15)) * LD + ((lane >> 4) << 3);
#pragma unroll
        for (int np = 0; np < BN / 16; ++np) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, wrow + np * 16);
          mma_16816(acc[2 * np], a, b[0], b[1]);
          mma_16816(acc[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // the next step overwrites wb and this step's buffers
  }

  // epilogue: element e of tile nt is row g + 8 * (e >> 1), column
  // nt * 8 + 2 * tig + (e & 1); the scales multiply the fp32 sums
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + warp * 16 + g + 8 * h;
    if (m >= M) continue;
    __nv_bfloat16* yr = y + static_cast<size_t>(m) * N + j * BN;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const int n = nt * 8 + 2 * tig;
      const float s0 = scales != nullptr ? scales[j * BN + n] : 1.0f;
      const float s1 = scales != nullptr ? scales[j * BN + n + 1] : 1.0f;
      *reinterpret_cast<uint32_t*>(yr + n) = pack_bf16(acc[nt][2 * h] * s0, acc[nt][2 * h + 1] * s1);
    }
  }
}

template <typename XT, typename WT>
int launch(const void* x, const void* blocks, const int* rows, const int* counts,
           const float* scales, void* y, int M, int K, int N, int mb, cudaStream_t stream) {
  if constexpr (std::is_same<XT, __nv_bfloat16>::value && std::is_same<WT, int8_t>::value) {
    dim3 grid(N / BN, (M + BM - 1) / BM);
    cudaError_t err = cudaFuncSetAttribute(
        bsmm_col_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMmaSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    bsmm_col_mma_kernel<<<grid, kMmaThreads, kMmaSmem, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(blocks), rows, counts,
        scales, static_cast<__nv_bfloat16*>(y), M, K, N, mb);
    return static_cast<int>(cudaGetLastError());
  } else {
    return fcol::launch_column_fma<XT, WT>(x, blocks, rows, counts, scales, y, M, K, N, mb,
                                           stream);
  }
}

}  // namespace

// x (M, K) f32|bf16 (16-byte aligned); blocks (N/128 * mb, 128, 128)
// int8|f32; block_rows (N/128, mb) int32; counts (N/128,) int32; scales (N,)
// f32 or null; y (M, N) in x's dtype.  Returns a cudaError_t code (0 =
// launched).
extern "C" int bsmm_col_launch(const void* x, const void* blocks, const int* block_rows,
                               const int* counts, const float* scales, void* y, int M, int K,
                               int N, int mb, int x_dtype, int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0) return 0;
#define B4_ARGS x, blocks, block_rows, counts, scales, y, M, K, N, mb, s
  if (w_dtype == DT_I8) {
    if (x_dtype == DT_BF16) return launch<__nv_bfloat16, int8_t>(B4_ARGS);
    if (x_dtype == DT_F32) return launch<float, int8_t>(B4_ARGS);
  } else if (w_dtype == DT_F32) {
    if (x_dtype == DT_BF16) return launch<__nv_bfloat16, float>(B4_ARGS);
    if (x_dtype == DT_F32) return launch<float, float>(B4_ARGS);
  }
#undef B4_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
