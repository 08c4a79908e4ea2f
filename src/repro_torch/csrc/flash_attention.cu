// B6: GQA flash attention forward (long prefill), causal and sliding-window
// masks, an optional logit softcap, bf16 K/V or int8 K/V with
// per-(position, head) fp32 scales.
//
// Replaces repro/kernels/flash_attention.py:flash_attention (line 105; the
// Pallas kernel body _flash_kernel).  Query i sits at position i and key j
// at j; the causal mask keeps j <= i, a window keeps j > i - window.  The G
// query heads that share a KV head fold into the rows, as the TPU kernel
// folds them: row r of a (b, kvh) is position r / G, head kvh * G + r % G,
// so each K/V tile read into shared memory serves all G heads.  Tiles
// wholly outside the causal or window band are never loaded (half the work
// of a causal prefill); a masked score adds exactly nothing (p = 0), so a
// row that sees no key writes 0 (l = 0, clamped at 1e-30).  No atomics and
// no split over keys: two launches give the same bits.
//
// Bound on this card: operations.  Every visible (query head, key) pair
// costs 4 * hd flops (QK^T and PV); a causal 2048-token prefill of
// tinyllama-1.1b (32 heads over 4 KV heads, hd 64) does 17.2 GFLOP on
// 18.9 MB of q, k, v and o, glm4-9b's (32 over 2, hd 128) 34.4 GFLOP on
// 35.7 MB: far right of the bf16 ridge.  So the products
// run on the tensor cores, and the exp of a score -- at hd 64 about what
// its two products cost on the SM's special-function units -- has to run
// under them.
//
// bf16 K/V (the served path), flash_fwd_wgmma_kernel<HD>: warp-specialised
// TMA + wgmma, one template for the served head dims 64 (tinyllama,
// llama3.2), 128 (glm4) and 256 (gemma3).  A CTA owns 128 folded rows of one
// (b, kvh): two consumer warpgroups of 64 rows and a producer warp.
// - Head-dim panels: Q, K and V sit in shared memory as HD / 64 panels of
//   64 columns, one 128-byte swizzle row per query or key (a TMA box may
//   not span more than the swizzle's 128 bytes).  hd 64 is one panel: the
//   single-head-dim kernel this template replaced, instruction for
//   instruction.
// - The producer keeps a ring of (K, V) tiles of BK keys in flight by TMA
//   (one 4-D tensor map per operand, (hd, KVH, Sk, B), HD / 64 boxes of
//   (64, 1, BK, 1) per operand and tile, 128-byte swizzle), on "full" /
//   "empty" mbarriers.  Keys past Sk arrive as zeros and are masked by the
//   real Sk.  BK is 128 at hd 64 (3 stages of 32 KB beside 16 KB of Q), 64
//   at hd 128 and 32 at hd 256 (4 stages of 32 KB beside 32 or 64 KB of Q).
// - Q is loaded by the consumers themselves: 16-byte loads into registers
//   (the first panel issued before the barriers are set up), stored in the
//   K-major 128B-swizzle layout (any G; a 5-D tensor map would need G | 128).
// - S = Q K^T: wgmma m64nBKk16 (n 128, 64 or 32), both operands from
//   shared memory as TMA wrote them (Q the K-major A, the K tile the
//   K-major B), HD / 16 k steps, every fourth the next panel.
// - O += P V: one wgmma m64n64k16 per panel with A from registers: S's fp32
//   accumulator of a 64x16 slice, rounded to bf16 pairs, is the A fragment,
//   so P never touches shared memory; V is the MN-major B (keys are the
//   contraction, hd contiguous), its TMA swizzle rows the operand's atoms.
// - Softmax under the tensor cores: each warpgroup issues tile j+1's S and
//   tile j's PV together, waits for S only, and runs tile j+1's online
//   softmax (exp2, log2(e)/sqrt(hd) folded into one fp32 scale) while PV
//   runs; the two warpgroups of a CTA interleave on the SM besides.
// - Tiles wholly inside the band run unmasked; only the diagonal,
//   window-edge and ragged-Sk tiles apply masks.  The longest causal
//   q-tiles start first (the q tile is the grid's slow axis).
// - One CTA per SM: a consumer thread holds BK / 2 scores, HD / 2 output
//   sums and BK / 4 P words: 64 + 32 + 32 at hd 64, 32 + 64 + 16 at hd 128,
//   16 + 128 + 8 at hd 256.  ptxas allocates 168 registers a thread (384
//   threads a CTA) whatever setmaxnreg grants the consumers after it: hd 64
//   and 128 do not spill, hd 256 does (548 bytes; PERF.md has the times,
//   making hd 256 fast is later work).
//
// int8 K/V (off the main path: the served prefill attends the prompt's own
// bf16 K/V before they are quantized into the cache), flash_fwd_kernel<HD>
// at hd 64, 128 and 256: the first port's design.  One CTA of 4 warps per
// 64 folded rows, 64-key tiles double-buffered by cp.async, converted
// exactly to bf16 (|x| <= 127) in shared memory, mma.sync.m16n8k16; the
// scales multiply the fp32 scores (K) and P (V), and P * v_scale enters PV
// as a bf16 pair hi + lo (~16 significant bits, two MMAs), close to the
// fp32 P and dequantized V of the Pallas kernel's int8 branch.  Moving it
// onto TMA + wgmma needs the conversion in the consumer's path, later work.
//
// Numerics (both): scores are the fp32 sum of exact bf16 products; the
// fp32 state (m, l, O) stays in registers; P is rounded to bf16 before PV,
// as both reference paths do for bf16 V.  A softcap (cap > 0, gemma2-style)
// replaces each scaled score x by cap * tanh(x / cap) before the mask and
// the online softmax, as the reference's jnp flash does
// (repro/models/layers.py:236); it is a runtime argument, so one build
// serves capped and uncapped models.
#include "hopper.cuh"
#include "mma.cuh"

#include <math_constants.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int BM = 16 * kWarps;  // folded query rows per CTA
constexpr int BK = 64;           // keys per tile
constexpr int kPad = 8;          // bf16 padding per shared row: conflict-free fragment loads

template <int HD>
struct Layout {
  static constexpr int LD = HD + kPad;                          // bf16 per shared row
  static constexpr size_t q_bytes = size_t(BM) * LD * 2;        // the Q tile
  static constexpr size_t tile_bytes = size_t(BK) * LD * 2;     // one bf16 K or V tile
  static constexpr size_t tile8_bytes = size_t(BK) * HD;        // one int8 K or V tile
  // one pipeline stage: int8 K and V plus their scales
  static constexpr size_t stage_bytes = 2 * tile8_bytes + 2 * BK * sizeof(float);
  // Q, two stages, and the converted bf16 K and V tiles
  static constexpr size_t smem_bytes = q_bytes + 2 * stage_bytes + 2 * tile_bytes;
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,  // (B, Sq, H, HD)
                 const int8_t* __restrict__ kg,        // (B, Sk, KVH, HD)
                 const int8_t* __restrict__ vg,
                 const float* __restrict__ k_scale,    // (B, Sk, KVH)
                 const float* __restrict__ v_scale,
                 __nv_bfloat16* __restrict__ out,      // (B, Sq, H, HD)
                 int Sq, int Sk, int H, int KVH, int causal, int window, float scale,
                 float cap) {
  using L = Layout<HD>;
  constexpr int LD = L::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* stages = smem + L::q_bytes;
  // the bf16 tiles the MMAs read, converted from the current stage
  __nv_bfloat16* kb = reinterpret_cast<__nv_bfloat16*>(stages + 2 * L::stage_bytes);
  __nv_bfloat16* vb = kb + BK * LD;

  const int G = H / KVH;
  const int rows = Sq * G;  // folded (position, group) rows of one (b, kvh)
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal tiles start first
  const int b = blockIdx.y / KVH, kvh = blockIdx.y % KVH;
  const int r0 = qt * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment row group, column pair

  auto q_row = [&](int r) {  // element offset of folded row r in q / out
    return ((static_cast<size_t>(b) * Sq + r / G) * H + kvh * G + r % G) * HD;
  };

  // the key band this tile's rows can see: tiles [t_begin, t_end)
  const int r_last = min(r0 + BM, rows) - 1;
  const int q_first = r0 / G, q_last = r_last / G;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int t_begin = k_begin / BK;
  const int t_end = k_end > k_begin ? (k_end + BK - 1) / BK : t_begin;

  auto load_tile = [&](int t, int s) {
    unsigned char* base = stages + s * L::stage_bytes;
    const int n0 = t * BK;
    int8_t* k8 = reinterpret_cast<int8_t*>(base);
    int8_t* v8 = k8 + BK * HD;
    float* ks = reinterpret_cast<float*>(base + 2 * L::tile8_bytes);
    float* vs = ks + BK;
    constexpr int CH = HD / 16;
    for (int i = tid; i < BK * CH; i += kThreads) {
      const int n = i / CH, c = i % CH, key = n0 + n;
      const bool ok = key < Sk;
      const size_t off = ((static_cast<size_t>(b) * Sk + key) * KVH + kvh) * HD + c * 16;
      cp_async16_zfill(k8 + n * HD + c * 16, ok ? kg + off : kg, ok);
      cp_async16_zfill(v8 + n * HD + c * 16, ok ? vg + off : vg, ok);
    }
    for (int n = tid; n < BK; n += kThreads) {
      const int key = n0 + n;
      const bool ok = key < Sk;
      const size_t off = (static_cast<size_t>(b) * Sk + key) * KVH + kvh;
      ks[n] = ok ? k_scale[off] : 0.0f;
      vs[n] = ok ? v_scale[off] : 0.0f;
    }
  };

  // Q tile (rows past Sq * G zero-filled), then the first K/V tile
  {
    constexpr int CH = HD / 8;
    for (int i = tid; i < BM * CH; i += kThreads) {
      const int rr = i / CH, c = i % CH, r = r0 + rr;
      const bool ok = r < rows;
      cp_async16_zfill(qs + rr * LD + c * 8, ok ? q + q_row(r) + c * 8 : q, ok);
    }
    cp_async_commit();
  }
  if (t_begin < t_end) load_tile(t_begin, 0);
  cp_async_commit();
  cp_async_wait<1>();  // the Q group has landed
  __syncthreads();

  const int wr = warp * 16;  // this warp's first row in the tile
  uint32_t qf[HD / 16][4];   // A fragments of the warp's 16 Q rows
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const __nv_bfloat16* p = qs + (wr + g) * LD + kk * 16 + 2 * tig;
    qf[kk][0] = ld32(p);
    qf[kk][1] = ld32(p + 8 * LD);
    qf[kk][2] = ld32(p + 8);
    qf[kk][3] = ld32(p + 8 * LD + 8);
  }

  // this thread's two rows: g and g + 8 of the warp's 16
  const int row_a = r0 + wr + g, row_b = row_a + 8;
  const int qpos[2] = {row_a / G, row_b / G};
  float m[2] = {-1e30f, -1e30f};
  float l[2] = {0.0f, 0.0f};  // this thread's partial row sums (quad-reduced at the end)
  float acc[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;

  for (int t = t_begin; t < t_end; ++t) {
    const int s = (t - t_begin) & 1;
    if (t + 1 < t_end) load_tile(t + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile t has landed
    __syncthreads();

    unsigned char* base = stages + s * L::stage_bytes;
    const int8_t* k8 = reinterpret_cast<const int8_t*>(base);
    const int8_t* v8 = k8 + BK * HD;
    const float* ks = reinterpret_cast<const float*>(base + 2 * L::tile8_bytes);
    const float* vs = ks + BK;
    // int8 -> bf16 is exact for |x| <= 127; four values per step
    for (int i = tid; i < BK * HD / 4; i += kThreads) {
      const int n = (i * 4) / HD, d = (i * 4) % HD;
      const char4 k4 = *reinterpret_cast<const char4*>(k8 + n * HD + d);
      const char4 v4 = *reinterpret_cast<const char4*>(v8 + n * HD + d);
      uint32_t* kd = reinterpret_cast<uint32_t*>(kb + n * LD + d);
      uint32_t* vd = reinterpret_cast<uint32_t*>(vb + n * LD + d);
      kd[0] = pack_bf16(static_cast<float>(k4.x), static_cast<float>(k4.y));
      kd[1] = pack_bf16(static_cast<float>(k4.z), static_cast<float>(k4.w));
      vd[0] = pack_bf16(static_cast<float>(v4.x), static_cast<float>(v4.y));
      vd[1] = pack_bf16(static_cast<float>(v4.z), static_cast<float>(v4.w));
    }
    __syncthreads();
    const __nv_bfloat16* kt = kb;
    const __nv_bfloat16* vt = vb;

    // S = Q K^T for the warp's 16 rows x 64 keys
    float sc[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const __nv_bfloat16* p = kt + (nt * 8 + g) * LD + kk * 16 + 2 * tig;
        mma_16816(sc[nt], qf[kk], ld32(p), ld32(p + 8));
      }
    }

    // scale, mask, online softmax (element e: row g + 8 * (e >> 1), key column
    // nt * 8 + 2 * tig + (e & 1))
    const int n0 = t * BK;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * tig + (e & 1);
        const int key = n0 + col;
        const int qp = qpos[e >> 1];
        bool keep = key < Sk;
        if (causal) keep = keep && key <= qp;
        if (window > 0) keep = keep && key > qp - window;
        float x = sc[nt][e] * scale;
        x *= ks[col];
        if (cap > 0.0f) x = cap * tanhf(x / cap);
        x = keep ? x : -CUDART_INF_F;  // exp(-inf - m) = 0 with m >= -1e30: p = 0
        sc[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = expf(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[nt][e] - m[e >> 1]);
        l[e >> 1] += p;
        sc[nt][e] = p * vs[nt * 8 + 2 * tig + (e & 1)];
      }
    }

    // O += P V: P's accumulator fragments are PV's A fragments.  int8 V is
    // exact in bf16, so P * v_scale goes in as two bf16 terms (hi + lo, ~16
    // significant bits): the fp32 P of the Pallas kernel's int8 branch
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pf[4], pl[4];
      split_bf16(sc[2 * kk][0], sc[2 * kk][1], pf[0], pl[0]);
      split_bf16(sc[2 * kk][2], sc[2 * kk][3], pf[1], pl[1]);
      split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], pf[2], pl[2]);
      split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], pf[3], pl[3]);
      const __nv_bfloat16* vr = vt + (kk * 16 + 2 * tig) * LD + g;
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        const __nv_bfloat16* p = vr + nt * 8;
        const uint32_t b0 = ld_col_pair(p, LD), b1 = ld_col_pair(p + 8 * LD, LD);
        mma_16816(acc[nt], pf, b0, b1);
        mma_16816(acc[nt], pl, b0, b1);
      }
    }
    __syncthreads();  // the next iteration's load overwrites this stage
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = h ? row_b : row_a;
    if (r >= rows) continue;
    const float den = fmaxf(l[h], 1e-30f);
    __nv_bfloat16* o = out + q_row(r);
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      *reinterpret_cast<uint32_t*>(o + nt * 8 + 2 * tig) =
          pack_bf16(acc[nt][2 * h] / den, acc[nt][2 * h + 1] / den);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
           void* out, int B, int Sq, int Sk, int H, int KVH, int causal, int window, float scale,
           float cap, cudaStream_t stream) {
  constexpr size_t smem = Layout<HD>::smem_bytes;
  auto kern = flash_fwd_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = Sq * (H / KVH);
  dim3 grid((rows + BM - 1) / BM, B * KVH);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const __nv_bfloat16*>(q),
                                         static_cast<const int8_t*>(k),
                                         static_cast<const int8_t*>(v), ks, vs,
                                         static_cast<__nv_bfloat16*>(out), Sq, Sk, H, KVH,
                                         causal, window, scale, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// -- bf16 K/V: TMA + wgmma, warp-specialised ----------------------------------

namespace fwg {

constexpr int kRows = 128;    // folded query rows per CTA: two consumer warpgroups of 64
constexpr int kThreads = 384; // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kPanel = 64;    // bf16 of one 128-byte swizzle row: a head dim's panel

// the tile geometry of head dim HD.  Q, K and V sit in shared memory as
// HD / 64 panels of 64 head-dim columns, each panel one 128-byte swizzle row
// per query or key (TMA boxes may not exceed the 128-byte swizzle span).
// The key tile shrinks as the head dim grows, so that a consumer thread's
// scores, P words and HD / 2 output sums fit the 168 registers ptxas
// allocates: 128 keys at hd 64, 64 at hd 128, 32 at hd 256 (faster than
// 128 and 64 on the card, PERF.md).
template <int HD>
struct Cfg {
  static constexpr int BK = HD == 64 ? 128 : (HD == 128 ? 64 : 32);  // keys per K/V tile
  static constexpr int kStages = HD == 64 ? 3 : 4;        // (K, V) tiles in flight
  static constexpr int kPanels = HD / kPanel;
  static constexpr uint32_t kPanelBytes = BK * 128;        // one panel of a K or V tile
  static constexpr uint32_t kTileBytes = BK * HD * 2;      // one K or V tile
  static constexpr uint32_t kQPanel = kRows * 128;         // one panel of Q
  static constexpr uint32_t kQ = 0;                         // Q: kPanels panels
  static constexpr uint32_t kStage0 = kRows * HD * 2;      // stage s: K, then V
  static constexpr uint32_t kStageBytes = 2 * kTileBytes;
  static constexpr uint32_t kBars = kStage0 + kStages * kStageBytes;  // full[], empty[]
  static constexpr uint32_t kSmem = kBars + 2 * kStages * 8 + 1024;   // + alignment slack
  static_assert(HD % kPanel == 0 && HD <= 256, "head dim 64, 128 or 256");
  static_assert(kSmem <= 232448, "more shared memory than a CTA may have");
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// s (64 rows x BK keys of this warpgroup) = Q K^T: Q the K-major A (SBO
// 1024: eight 128-byte rows; a k16 step is +32 bytes in the swizzle row,
// every fourth step the next panel), the K tile the K-major B (BK key rows,
// the same layout)
template <int HD>
__device__ __forceinline__ void qk_tile(float (&s)[Cfg<HD>::BK / 2], uint32_t qa, uint32_t ka) {
  using C = Cfg<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint64_t da = desc_sw128(qa + (kk / 4) * C::kQPanel + (kk % 4) * 32, 16, 1024);
    const uint64_t db = desc_sw128(ka + (kk / 4) * C::kPanelBytes + (kk % 4) * 32, 16, 1024);
    if constexpr (C::BK == 128)
      wgmma_m64n128k16_bf16<0>(s, da, db, kk);
    else if constexpr (C::BK == 64)
      wgmma_m64n64k16_bf16<0>(s, da, db, kk);
    else
      wgmma_m64n32k16_bf16<0>(s, da, db, kk);
  }
}

// o += P V: P's bf16 pairs p[4 kk .. 4 kk + 3] are the A fragment of keys
// 16 kk .. 16 kk + 15; V the MN-major B, one m64n64 product per 64-column
// panel (one swizzle atom wide, SBO = eight key rows, a k16 step = 16 key
// rows), o[c] that panel's sums
template <int HD>
__device__ __forceinline__ void pv_tile(float (&o)[Cfg<HD>::kPanels][32],
                                        const uint32_t (&p)[Cfg<HD>::BK / 4], uint32_t va) {
  using C = Cfg<HD>;
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk)
#pragma unroll
    for (int c = 0; c < C::kPanels; ++c)
      wgmma_m64n64k16_rs(o[c], p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                         desc_sw128(va + c * C::kPanelBytes + kk * 16 * 128, C::kTileBytes,
                                    1024));
}

// the online softmax of one tile: s[4c + e] is row h = e / 2 (this thread's
// qpos[h]), key n0 + 8c + 2 (lane % 4) + e % 2.  m is the running max in
// the exp2 domain; s becomes p; l (this thread's partial sums) and the
// factor alpha that rescales the older sums are updated
template <bool MASK, int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int n0, const int (&qpos)[2],
                                             int Sk, int causal, int window, float scale_log2) {
  const int lane = threadIdx.x & 31;
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int c = 0; c < BK / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * c + e];
      if constexpr (MASK) {
        const int key = n0 + 8 * c + 2 * (lane & 3) + (e & 1);
        const int qp = qpos[e >> 1];
        bool keep = key < Sk;
        if (causal) keep = keep && key <= qp;
        if (window > 0) keep = keep && key > qp - window;
        x = keep ? x : -CUDART_INF_F;  // exp2(-inf) = 0: p = 0
        s[4 * c + e] = x;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float mn = fmaxf(m[h], mx[h] * scale_log2);  // m starts at -1e30: finite
    alpha[h] = ex2(m[h] - mn);
    m[h] = mn;
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const float p = ex2(fmaf(s[i], scale_log2, -m[(i >> 1) & 1]));
    l[(i >> 1) & 1] += p;
    s[i] = p;
  }
}

// the softcap of one tile's raw scores: s = cap * tanh(s * pre), pre =
// scale / cap (the caller then takes log2(e) alone as the exp2 scale)
template <int BK>
__device__ __forceinline__ void softcap_tile(float (&s)[BK / 2], float cap, float pre) {
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = cap * tanhf(s[i] * pre);
}

// p (bf16 pairs) from s: pairs 4 kk + {0, 1, 2, 3} are the A fragment of
// keys 16 kk .. 16 kk + 15 (rows g, g + 8 at columns 2 t, then at + 8)
template <int BK>
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2], uint32_t (&p)[BK / 4]) {
#pragma unroll
  for (int i = 0; i < BK / 4; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// tile j + 1's softmax runs while tile j's PV is on the tensor cores
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __nv_bfloat16* __restrict__ q,  // (B, Sq, H, HD)
                       __nv_bfloat16* __restrict__ out,      // (B, Sq, H, HD)
                       int Sq, int Sk, int H, int KVH, int causal, int window,
                       float scale_log2, float cap, float cap_pre) {
  using C = Cfg<HD>;
  constexpr int BK = C::BK, kStages = C::kStages, kPanels = C::kPanels;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBars);
  uint64_t* empty = full + kStages;

  const int G = H / KVH;
  const int rows = Sq * G;  // folded (position, group) rows of one (b, kvh)
  const int b = blockIdx.x / KVH, kvh = blockIdx.x % KVH;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // the longest causal tiles start first

  // the key band this CTA's rows can see: tiles t_begin .. t_begin + n - 1
  const int q_first = r0 / G, q_last = (min(r0 + kRows, rows) - 1) / G;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int t_begin = k_begin / BK;
  const int n = k_end > k_begin ? (k_end + BK - 1) / BK - t_begin : 0;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr0 = r0 + (warp >> 2) * 64;  // a consumer warpgroup's first folded row
  auto q_off = [&](int r) {               // element offset of folded row r in q / out
    return ((static_cast<size_t>(b) * Sq + r / G) * H + kvh * G + r % G) * HD;
  };
  // Q's first panel of the consumer warpgroups' rows, in flight while the
  // barriers are set up (panel c: 16-byte chunk i & 7 of row i >> 3 at
  // column 64 c)
  auto load_q = [&](uint4 (&qv)[4], int c) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = (threadIdx.x & 127) + 128 * j, r = wr0 + (i >> 3);
      qv[j] = r < rows
                  ? *reinterpret_cast<const uint4*>(q + q_off(r) + c * kPanel + (i & 7) * 8)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  uint4 qv[4];
  if (warp < 8) load_q(qv, 0);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // -- producer ---------------------------------------------------------------
    setmaxnreg_dec<40>();
    if (warp == 8 && lane == 0) {
      for (int i = 0; i < n; ++i) {
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(&empty[st], ((i / kStages) - 1) & 1);
        unsigned char* kt = smem + C::kStage0 + st * C::kStageBytes;
        const int key0 = (t_begin + i) * BK;
        mbar_arrive_expect_tx(&full[st], C::kStageBytes);
#pragma unroll
        for (int c = 0; c < kPanels; ++c)
          tma_load_4d(kt + c * C::kPanelBytes, &kmap, c * kPanel, kvh, key0, b, &full[st]);
#pragma unroll
        for (int c = 0; c < kPanels; ++c)
          tma_load_4d(kt + C::kTileBytes + c * C::kPanelBytes, &vmap, c * kPanel, kvh, key0, b,
                      &full[st]);
      }
    }
  } else {
    // -- consumers --------------------------------------------------------------
    setmaxnreg_inc<232>();
    const int wg = warp >> 2;

    // Q: the warpgroup's 64 rows into the K-major 128B-swizzle layout, panel
    // by panel (row rr at rr * 128 bytes of its panel, 16-byte chunk c at
    // c ^ rr % 8); rows past Sq * G are zeros and are never written back
    unsigned char* qs = smem + C::kQ + wg * 64 * 128;
#pragma unroll
    for (int c = 0; c < kPanels; ++c) {
      if (c > 0) load_q(qv, c);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = (threadIdx.x & 127) + 128 * j, rr = i >> 3, ch = i & 7;
        *reinterpret_cast<uint4*>(qs + c * C::kQPanel + rr * 128 + ((ch ^ (rr & 7)) << 4)) =
            qv[j];
      }
    }
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);

    const int ra = wr0 + (warp & 3) * 16 + (lane >> 2);  // this thread's rows: ra, ra + 8
    const int qpos[2] = {ra / G, (ra + 8) / G};
    // a tile runs unmasked if every key in it is real and visible to every
    // row of the warpgroup
    const int wq_first = wr0 / G, wq_last = (min(wr0 + 64, rows) - 1) / G;
    const uint32_t qa = smem_u32(qs);
    const uint32_t stages = smem_u32(smem + C::kStage0);

    float s[BK / 2], o[kPanels][32], m[2] = {-1e30f, -1e30f}, l[2] = {0.0f, 0.0f}, alpha[2];
    uint32_t p[BK / 4];
#pragma unroll
    for (int c = 0; c < kPanels; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.0f;

    auto softmax = [&](int i) {
      if (cap > 0.0f) softcap_tile<BK>(s, cap, cap_pre);
      const int n0 = (t_begin + i) * BK;
      const bool inside = n0 + BK <= Sk && (!causal || n0 + BK - 1 <= wq_first) &&
                          (window <= 0 || n0 > wq_last - window);
      if (inside)
        softmax_tile<false, BK>(s, m, l, alpha, n0, qpos, Sk, causal, window, scale_log2);
      else
        softmax_tile<true, BK>(s, m, l, alpha, n0, qpos, Sk, causal, window, scale_log2);
    };
    auto k_tile = [&](int i) { return stages + (i % kStages) * C::kStageBytes; };
    auto fence_o = [&]() {
#pragma unroll
      for (int c = 0; c < kPanels; ++c) fence_regs(o[c]);
    };

    if (n > 0) {
      mbar_wait(&full[0], 0);
      wgmma_fence();
      qk_tile<HD>(s, qa, k_tile(0));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      softmax(0);
      pack_p<BK>(s, p);
      for (int i = 0; i + 1 < n; ++i) {
        mbar_wait(&full[(i + 1) % kStages], ((i + 1) / kStages) & 1);
        fence_regs(s);
        fence_o();
        fence_regs(p);
        wgmma_fence();
        qk_tile<HD>(s, qa, k_tile(i + 1));
        wgmma_commit();
        pv_tile<HD>(o, p, k_tile(i) + C::kTileBytes);
        wgmma_commit();
        wgmma_wait<1>();  // S of tile i + 1 is in
        fence_regs(s);
        softmax(i + 1);
        wgmma_wait<0>();  // PV of tile i is in: its stage is free
        fence_o();
        fence_regs(p);
        if (lane == 0) mbar_arrive(&empty[i % kStages]);
#pragma unroll
        for (int c = 0; c < kPanels; ++c)
#pragma unroll
          for (int j = 0; j < 32; ++j) o[c][j] *= alpha[(j >> 1) & 1];
        pack_p<BK>(s, p);
      }
      fence_o();
      fence_regs(p);
      wgmma_fence();
      pv_tile<HD>(o, p, k_tile(n - 1) + C::kTileBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_o();
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int r = ra + 8 * h;
      if (r >= rows) continue;
      const float inv = 1.0f / fmaxf(l[h], 1e-30f);  // one division per row
      __nv_bfloat16* orow = out + q_off(r);
#pragma unroll
      for (int c = 0; c < kPanels; ++c)
#pragma unroll
        for (int cc = 0; cc < kPanel / 8; ++cc)
          *reinterpret_cast<uint32_t*>(orow + c * kPanel + 8 * cc + 2 * (lane & 3)) =
              pack_bf16(o[c][4 * cc + 2 * h] * inv, o[c][4 * cc + 2 * h + 1] * inv);
    }
  }
}

// k or v (B, Sk, KVH, HD) bf16 as boxes of (64 head-dim columns, 1 head, BK
// keys, 1 batch), 128B swizzle, zeros outside the tensor
template <int HD>
inline bool encode_kv_map(CUtensorMap* map, const void* kv, int B, int Sk, int KVH) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t row = HD * 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD), static_cast<cuuint64_t>(KVH),
                              static_cast<cuuint64_t>(Sk), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {row, row * KVH, row * KVH * Sk};
  const cuuint32_t box[4] = {kPanel, 1, Cfg<HD>::BK, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(kv), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk, int H,
           int KVH, int causal, int window, float scale, float cap, cudaStream_t stream) {
  if (Sk <= 0)  // no key: every row writes 0
    return static_cast<int>(
        cudaMemsetAsync(out, 0, static_cast<size_t>(B) * Sq * H * HD * 2, stream));
  const int tiles = (Sq * (H / KVH) + kRows - 1) / kRows;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap kmap, vmap;
  if (!encode_kv_map<HD>(&kmap, k, B, Sk, KVH) || !encode_kv_map<HD>(&vmap, v, B, Sk, KVH))
    return static_cast<int>(cudaErrorInvalidValue);
  // set on every call, as the attribute is per device
  auto kern = flash_fwd_wgmma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Cfg<HD>::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float log2e = 1.4426950408889634f;
  // capped: the scores are scaled inside the cap, and exp2 takes log2(e) alone
  kern<<<dim3(B * KVH, tiles), kThreads, Cfg<HD>::kSmem, stream>>>(
      kmap, vmap, static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(out), Sq, Sk,
      H, KVH, causal, window, cap > 0.0f ? log2e : scale * log2e, cap,
      cap > 0.0f ? scale / cap : 0.0f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fwg

// q/out (B, Sq, H, hd) bf16; k/v (B, Sk, KVH, hd) bf16, or int8 with
// (B, Sk, KVH) f32 scales; all 16-byte aligned; hd 64, 128 or 256 (the head
// dims of the served models).  window <= 0: no window; softcap <= 0: no
// cap.  Returns a cudaError_t code (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const float* k_scale, const float* v_scale, void* out,
                                      int B, int Sq, int Sk, int H, int KVH, int hd, int causal,
                                      int window, float scale, float softcap, int kv_dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0) return 0;
  if (kv_dtype == DT_I8) {
    switch (hd) {
      case 64: return launch<64>(q, k, v, k_scale, v_scale, out, B, Sq, Sk, H, KVH, causal,
                                 window, scale, softcap, s);
      case 128: return launch<128>(q, k, v, k_scale, v_scale, out, B, Sq, Sk, H, KVH, causal,
                                   window, scale, softcap, s);
      case 256: return launch<256>(q, k, v, k_scale, v_scale, out, B, Sq, Sk, H, KVH, causal,
                                   window, scale, softcap, s);
    }
  }
  if (kv_dtype == DT_BF16) {
    switch (hd) {
      case 64:
        return fwg::launch<64>(q, k, v, out, B, Sq, Sk, H, KVH, causal, window, scale, softcap,
                               s);
      case 128:
        return fwg::launch<128>(q, k, v, out, B, Sq, Sk, H, KVH, causal, window, scale, softcap,
                                s);
      case 256:
        return fwg::launch<256>(q, k, v, out, B, Sq, Sk, H, KVH, causal, window, scale, softcap,
                                s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
