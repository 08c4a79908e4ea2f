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
// no epilogue, wrapping modulo 2^32 as the reference's int32 dot does.
// Bound: the int16 weight stream (2 bytes per weight) at the nets' batches
// of 1..32 -- 1.8 us for HAR-6's 2000 x 1500 -- provided the MACs run on
// the tensor cores: on the CUDA cores (64 IMAD a clock per SM) 16 x 2000 x
// 1500 MACs alone take ~3.2 us.  Hopper has no int16 MMA, so each operand
// is cut into bytes, a = a_h 256 + a_l (a_h = a >> 8 signed, a_l = a & 255
// unsigned), and
//     a w = (a_h w_h) 2^16 + (a_h w_l + a_l w_h) 2^8 + a_l w_l,
// four mma.sync.m16n8k32 int8 products (s8.s8, s8.u8, u8.s8, u8.u8) with
// the batch rows as A and the weight as B.  q78_stream_kernel streams the
// weight through stream_tile.cuh's ring (a grid of (column strip, K slice)
// CTAs covering the card, the K slice split over a cluster); the K slice
// of a is staged once and cut into A fragments (hi and lo bytes) in shared
// memory; each warp owns 8-column n-tiles of the strip, loads a 32 k x 8 n
// int16 block with one ldmatrix.trans (pairs of k per register) and cuts it
// into the B fragments with four byte permutes.  Within a fragment the
// k order is permuted (the same permutation for A and B, so the sum is
// unchanged): lane (g, t) holds rows 2t, 2t + 1, 8 + 2t, 9 + 2t, which is
// what ldmatrix.trans hands it.  The three int32 partials (hh, the two
// cross terms together, ll) stay inside int32 whatever the MMA's overflow
// rule: a stage has at most 128 rows, |a_l w_l| <= 65025 and |a_h w_l| +
// |a_l w_h| <= 65280; after every stage they are combined with shifts into
// a uint32_t sum, exact modulo 2^32, and reinterpreted as int32 only at the
// store.  Integer sums do not depend on order: the result is bit-exact at
// any plan.  The cluster's partials are added in rank order all the same.
//
// B5's CUDA-core kernel walks K in a loop over output tiles 32 weight bytes
// wide (32 int8 columns; dense_tile.cuh), the weight tile in registers
// serving every row of the CTA; ragged M, K, N are masked.  Both B5 and B8
// address the weight through a row stride, so a column section of it
// (forward_q78_sectioned) needs no copy.
#include "dense_tile.cuh"
#include "stream_tile.cuh"
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
      return wcol::launch_column<2, 3>(quant_matmul_wgmma_kernel<2, 3>, M, n_cols, 1, 1, s, xmap,
                                       wmap, wl, yb, M, N, 1, act);
    return wcol::launch_column<1, 4>(quant_matmul_wgmma_kernel<1, 4>, M, n_cols, split, 1, s, xmap,
                                     wmap, wl, yb, M, N, split, act);
  }
  if (x_dtype == DT_F32) return launch_quant<float>(x, w, scales, y, M, K, N, ldx, ldw, act, s);
  if (x_dtype == DT_BF16) return launch_quant<__nv_bfloat16>(x, w, scales, y, M, K, N, ldx, ldw, act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}


// -- B8 ---------------------------------------------------------------------------

namespace q78 {

// d += a (16 x 32, row) * b (32 x 8, col) on the int8 tensor cores, int32
// sums; AT and BT name the signedness of A's and B's bytes
#define Q78_MMA(NAME, AT, BT)                                                                   \
  __device__ __forceinline__ void NAME(int (&d)[4], const uint4& a, uint32_t b0, uint32_t b1) { \
    asm volatile("mma.sync.aligned.m16n8k32.row.col.s32." AT "." BT                             \
                 ".s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"       \
                 : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])                               \
                 : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));                   \
  }
Q78_MMA(mma_ss, "s8", "s8")
Q78_MMA(mma_su, "s8", "u8")
Q78_MMA(mma_us, "u8", "s8")
Q78_MMA(mma_uu, "u8", "u8")
#undef Q78_MMA

// four 8 x 8 int16 matrices (rows ``addr`` of lanes 8q .. 8q + 7 for
// matrix q), transposed: lane (g, t) gets rows 2t, 2t + 1 of column g
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// the k (0..31) of a 32-k step that fragment position fk holds: lane t's
// register of positions 4t .. 4t + 3 takes rows 2t, 2t + 1, 8 + 2t, 9 + 2t
// (+16 for positions 16..31) -- ldmatrix.trans's order, for A and B alike
__device__ __forceinline__ int frag_k(int half, int t, int j) {
  return 16 * half + 8 * (j >> 1) + 2 * t + (j & 1);
}

// shared memory of a launch: the ring, the A fragments (1 KB per 32 k per
// 16 rows: hi and lo bytes), a's raw rows and the cluster's receive area
template <int MT>
__host__ __device__ constexpr int smem_bytes(int sb, int ks) {
  const int ksr = stile::slice_rows(ks, sb);
  return stile::ring_bytes(sb) + (ksr / 32) * MT * 1024 + 16 * MT * stile::raw_pitch(ksr, 2) +
         stile::cluster_sum_bytes(16 * MT * sb / 2);
}

// MT 16-row tiles of a (BM = 16 MT rows), NTW n-tiles of 8 columns per warp
// (a strip of sb = 128 NTW bytes: 8 warps x NTW x 8 int16 columns)
template <int MT, int NTW>
__global__ void __launch_bounds__(stile::kThreads, 1)
q78_stream_kernel(const int16_t* __restrict__ a, const int16_t* __restrict__ w,
                  int32_t* __restrict__ y, int M, int K, int N, int lda, int ldw,
                  stile::Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int BM = 16 * MT, SB = 128 * NTW, COLS = SB / 2;
  constexpr int ROWS = stile::stage_rows(SB), KPS = ROWS / 32;  // k steps of 32 per stage
  const int split = plan.split;
  const int rank = blockIdx.x % split;
  const int n0 = (blockIdx.x / split) * COLS;
  const int m0 = blockIdx.y * BM;
  const int k_lo = min(K, rank * plan.ks), k_hi = min(K, k_lo + plan.ks), nk = k_hi - k_lo;
  const int ksr = stile::slice_rows(plan.ks, SB);
  uint32_t* afr = reinterpret_cast<uint32_t*>(smem + stile::ring_bytes(SB));  // [ksr/32][MT][32][8]
  unsigned char* raw = smem + stile::ring_bytes(SB) + (ksr / 32) * MT * 1024;
  const int rp = stile::raw_pitch(ksr, 2);
  const auto* ab = reinterpret_cast<const unsigned char*>(a);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  int hh[MT][NTW][4], mid[MT][NTW][4], ll[MT][NTW][4];
  uint32_t tot[MT][NTW][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NTW; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) hh[mt][i][e] = mid[mt][i][e] = ll[mt][i][e] = 0, tot[mt][i][e] = 0;

  auto prologue = [&] {
    stile::load_x_raw(raw, ab, 2, size_t(lda) * 2, m0, M, BM, k_lo, nk, rp);
  };
  stile::ClusterSum cs;
  auto issued = [&] {
    if (split > 1)
      cs = stile::cluster_sum_begin(smem + smem_bytes<MT>(SB, plan.ks) -
                                        stile::cluster_sum_bytes(BM * COLS),
                                    BM * COLS, split, rank);
  };
  // A fragments of every 32-k step: lane (g, t)'s a0..a3 (rows g, g + 8;
  // positions 4t.., 16 + 4t..), hi bytes then lo bytes.  A register holds
  // k pairs (2t, 2t + 1) and (8 + 2t, 9 + 2t): two 4-byte loads when the
  // row lies 4-byte aligned in shared memory, cut into bytes as the B side
  // is; rows past M are zeros, and so is the staged row past the slice.
  auto ready = [&] {
    const int words = (ksr / 32) * MT * 128;
    for (int i = tid; i < words; i += stile::kThreads) {
      const int reg = i & 3, ln = (i >> 2) & 31, mt = (i >> 7) % MT, kst = (i >> 7) / MT;
      const int row = 16 * mt + (ln >> 2) + 8 * (reg & 1);
      uint32_t hw = 0, lw = 0;
      if (m0 + row < M) {
        const int k0 = 32 * kst + frag_k(reg >> 1, ln & 3, 0);  // then k0 + 1, k0 + 8, k0 + 9
        const int sh = stile::x_shift(ab, 2, size_t(lda) * 2, m0 + row, k_lo);
        const unsigned char* r = raw + row * rp + sh;
        uint32_t p0, p1;
        if (sh == 0) {
          p0 = *reinterpret_cast<const uint32_t*>(r + 2 * k0);
          p1 = *reinterpret_cast<const uint32_t*>(r + 2 * k0 + 16);
        } else {
          const uint16_t* h = reinterpret_cast<const uint16_t*>(r);
          p0 = h[k0] | (static_cast<uint32_t>(h[k0 + 1]) << 16);
          p1 = h[k0 + 8] | (static_cast<uint32_t>(h[k0 + 9]) << 16);
        }
        lw = __byte_perm(p0, p1, 0x6420);
        hw = __byte_perm(p0, p1, 0x7531);
      }
      uint32_t* f = afr + ((kst * MT + mt) * 32 + ln) * 8;
      f[reg] = hw;
      f[4 + reg] = lw;
    }
    __syncthreads();
  };
  auto consume = [&](const unsigned char* st, int s) {
#pragma unroll
    for (int kk = 0; kk < KPS; ++kk) {
      uint4 ah[MT], al[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint4* f = reinterpret_cast<const uint4*>(afr + (((s * KPS + kk) * MT + mt) * 32 + lane) * 8);
        ah[mt] = f[0];
        al[mt] = f[1];
      }
#pragma unroll
      for (int i = 0; i < NTW; ++i) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, smem_u32(st + (32 * kk + lane) * stile::ring_pitch(SB) + 16 * (warp + 8 * i)));
        const uint32_t bl0 = __byte_perm(r[0], r[1], 0x6420), bh0 = __byte_perm(r[0], r[1], 0x7531);
        const uint32_t bl1 = __byte_perm(r[2], r[3], 0x6420), bh1 = __byte_perm(r[2], r[3], 0x7531);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_ss(hh[mt][i], ah[mt], bh0, bh1);
          mma_su(mid[mt][i], ah[mt], bl0, bl1);
          mma_us(mid[mt][i], al[mt], bh0, bh1);
          mma_uu(ll[mt][i], al[mt], bl0, bl1);
        }
      }
    }
    // fold the stage's int32 partials into the wrapping sum
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < NTW; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          tot[mt][i][e] += (static_cast<uint32_t>(hh[mt][i][e]) << 16) +
                           (static_cast<uint32_t>(mid[mt][i][e]) << 8) +
                           static_cast<uint32_t>(ll[mt][i][e]);
          hh[mt][i][e] = mid[mt][i][e] = ll[mt][i][e] = 0;
        }
  };
  stile::run_ring(smem, reinterpret_cast<const unsigned char*>(w), size_t(ldw) * 2, n0 * 2,
                  max(0, min(SB, (N - n0) * 2)), k_lo, k_hi, SB, plan.width, prologue, issued,
                  ready, consume);

  // lane (g, t) of n-tile j holds rows (g, g + 8) x columns (8 j + 2t, + 1)
  const int g = lane >> 2, t = lane & 3;
  auto store = [&](int r, int c, uint32_t v) {
    if (m0 + r < M && n0 + c < N)
      y[static_cast<size_t>(m0 + r) * N + n0 + c] = static_cast<int32_t>(v);  // wraps
  };
  if (split == 1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < NTW; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          store(16 * mt + g + 8 * (e >> 1), 8 * (warp + 8 * i) + 2 * t + (e & 1), tot[mt][i][e]);
    return;
  }
  stile::cluster_sum_ready();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NTW; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        stile::cluster_sum_push(
            cs, (16 * mt + g + 8 * (e >> 1)) * COLS + 8 * (warp + 8 * i) + 2 * t + (e & 1),
            tot[mt][i][e]);
  stile::cluster_sum_wait(cs);
  const uint32_t* recv = reinterpret_cast<const uint32_t*>(cs.recv);
  for (int o = cs.lo + tid; o < cs.hi; o += stile::kThreads) {
    uint32_t v = 0;
    for (int p = 0; p < split; ++p) v += recv[p * cs.per + (o - cs.lo)];
    store(o / COLS, o % COLS, v);
  }
}

template <int MT, int NTW>
int launch(const int16_t* a, const int16_t* w, int32_t* y, int M, int K, int N, int lda, int ldw,
           stile::Plan plan, cudaStream_t stream) {
  const int smem = smem_bytes<MT>(plan.sb, plan.ks);
  if (smem > stile::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  return stile::launch(q78_stream_kernel<MT, NTW>, configured, (2 * N + plan.sb - 1) / plan.sb,
                       plan.split, (M + 16 * MT - 1) / (16 * MT), smem, stream, a, w, y, M, K, N,
                       lda, ldw, plan);
}

template <int MT>
int launch_mt(const int16_t* a, const int16_t* w, int32_t* y, int M, int K, int N, int lda,
              int ldw, stile::Plan plan, cudaStream_t s) {
  if (plan.sb == 128) return launch<MT, 1>(a, w, y, M, K, N, lda, ldw, plan, s);
  if (plan.sb == 256) return launch<MT, 2>(a, w, y, M, K, N, lda, ldw, plan, s);
  return launch<MT, 4>(a, w, y, M, K, N, lda, ldw, plan, s);
}

}  // namespace q78

// Shared memory a launch of M rows takes (bytes); the host's
// stream_smem_bytes mirrors it.
extern "C" int q78_matmul_smem_bytes(int M, int sb, int ks) {
  return M <= 16 ? q78::smem_bytes<1>(sb, ks) : q78::smem_bytes<2>(sb, ks);
}

// a (M, K) int16 with row stride lda; w (K, N) int16 with row stride ldw;
// y (M, N) int32 contiguous; (sb, split, width, ks) the stream plan
// (kernels/batched_ffn.stream_plan; 16 rows a tile up to M = 16, else 32).
// Returns a cudaError_t code (0 = launched).
extern "C" int q78_matmul_launch(const int16_t* a, const int16_t* w, int32_t* y, int M, int K,
                                 int N, int lda, int ldw, int sb, int split, int width, int ks,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const stile::Plan plan{sb, split, width, ks};
  if (!stile::valid_plan(plan, 32)) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0) return 0;
  if (M <= 16) return q78::launch_mt<1>(a, w, y, M, K, N, lda, ldw, plan, s);
  return q78::launch_mt<2>(a, w, y, M, K, N, lda, ldw, plan, s);
}
