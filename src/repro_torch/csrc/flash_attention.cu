// B6: GQA flash attention forward (long prefill), causal and sliding-window
// masks, bf16 K/V or int8 K/V with per-(position, head) fp32 scales.
//
// Replaces repro/kernels/flash_attention.py:flash_attention (the Pallas
// kernel body _flash_kernel).  Query i sits at position i and key j at j;
// the causal mask keeps j <= i, a window keeps j > i - window.
//
// Bound on this card: operations.  Every visible (query head, key) pair
// costs 4 * hd flops (QK^T and PV); a causal 2048-token prefill of
// tinyllama-1.1b (32 heads over 4 KV heads, hd 64) does 17.2 GFLOP on
// 18.9 MB of q, k, v and o, far right of the bf16 ridge.  So the products
// run on the tensor cores: mma.sync.m16n8k16 bf16 with fp32 accumulation
// (Hopper runs these Ampere-era instructions; wgmma and TMA are later
// work).
//
// Design.  One CTA of 4 warps per (batch x KV head, 64 query rows).  The G
// query heads that share a KV head fold into the rows, as the TPU kernel
// folds them: row r of a (b, kvh) is position r / G, head kvh * G + r % G,
// so each K/V tile read into shared memory serves all G heads.  Each warp
// owns 16 rows; the sequential kv grid axis of the TPU kernel becomes a
// loop over 64-key tiles, double-buffered into shared memory by cp.async
// (zero-filled past Sk: the ragged tail is masked by the real Sk, nothing
// is padded).  The online-softmax state (m, l, acc) lives in fp32
// registers, laid out as the mma accumulator fragments; P goes from the
// QK^T accumulators straight into the A fragments of PV.  Tiles wholly
// outside the causal or window band are never loaded (half the work of a
// causal prefill); a masked score adds exactly nothing (p = 0), so a row
// that sees no key writes 0 (l = 0, clamped at 1e-30).
//
// Numerics: scores are the fp32 sum of exact bf16 products, scaled by
// 1/sqrt(hd) in fp32; P is rounded to bf16 before PV, as both reference
// paths do for bf16 V.  int8 K/V convert exactly to bf16 (|x| <= 127) in
// shared memory and run the same MMAs; their scales multiply the fp32
// scores (K) and P (V), and P * v_scale enters PV as a bf16 pair hi + lo
// (~16 significant bits, two MMAs), close to the fp32 P and dequantized V
// of the Pallas kernel's int8 branch.
#include "mma.cuh"

#include <math_constants.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int BM = 16 * kWarps;  // folded query rows per CTA
constexpr int BK = 64;           // keys per tile
constexpr int kPad = 8;          // bf16 padding per shared row: conflict-free fragment loads

template <int HD, bool QUANT>
struct Layout {
  static constexpr int LD = HD + kPad;                          // bf16 per shared row
  static constexpr size_t q_bytes = size_t(BM) * LD * 2;        // the Q tile
  static constexpr size_t tile_bytes = size_t(BK) * LD * 2;     // one bf16 K or V tile
  static constexpr size_t tile8_bytes = size_t(BK) * HD;        // one int8 K or V tile
  // one pipeline stage: bf16 K and V, or int8 K and V plus their scales
  static constexpr size_t stage_bytes =
      QUANT ? 2 * tile8_bytes + 2 * BK * sizeof(float) : 2 * tile_bytes;
  // Q, two stages, and for int8 the converted bf16 K and V tiles
  static constexpr size_t smem_bytes = q_bytes + 2 * stage_bytes + (QUANT ? 2 * tile_bytes : 0);
};

template <int HD, bool QUANT>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,  // (B, Sq, H, HD)
                 const void* __restrict__ k_,          // (B, Sk, KVH, HD) bf16 | int8
                 const void* __restrict__ v_,
                 const float* __restrict__ k_scale,    // (B, Sk, KVH) if QUANT
                 const float* __restrict__ v_scale,
                 __nv_bfloat16* __restrict__ out,      // (B, Sq, H, HD)
                 int Sq, int Sk, int H, int KVH, int causal, int window, float scale) {
  using L = Layout<HD, QUANT>;
  using KT = typename std::conditional<QUANT, int8_t, __nv_bfloat16>::type;
  constexpr int LD = L::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* stages = smem + L::q_bytes;
  // int8: the bf16 tiles the MMAs read, converted from the current stage
  __nv_bfloat16* kb = reinterpret_cast<__nv_bfloat16*>(stages + 2 * L::stage_bytes);
  __nv_bfloat16* vb = kb + BK * LD;
  const KT* kg = static_cast<const KT*>(k_);
  const KT* vg = static_cast<const KT*>(v_);

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
    if constexpr (QUANT) {
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
    } else {
      __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(base);
      __nv_bfloat16* vt = kt + BK * LD;
      constexpr int CH = HD / 8;
      for (int i = tid; i < BK * CH; i += kThreads) {
        const int n = i / CH, c = i % CH, key = n0 + n;
        const bool ok = key < Sk;
        const size_t off = ((static_cast<size_t>(b) * Sk + key) * KVH + kvh) * HD + c * 8;
        cp_async16_zfill(kt + n * LD + c * 8, ok ? kg + off : kg, ok);
        cp_async16_zfill(vt + n * LD + c * 8, ok ? vg + off : vg, ok);
      }
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
    const __nv_bfloat16* kt;
    const __nv_bfloat16* vt;
    const float* ks = nullptr;
    const float* vs = nullptr;
    if constexpr (QUANT) {
      const int8_t* k8 = reinterpret_cast<const int8_t*>(base);
      const int8_t* v8 = k8 + BK * HD;
      ks = reinterpret_cast<const float*>(base + 2 * L::tile8_bytes);
      vs = ks + BK;
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
      kt = kb;
      vt = vb;
    } else {
      kt = reinterpret_cast<const __nv_bfloat16*>(base);
      vt = kt + BK * LD;
    }

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
        if constexpr (QUANT) x *= ks[col];
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
        float pv = p;
        if constexpr (QUANT) pv *= vs[nt * 8 + 2 * tig + (e & 1)];
        sc[nt][e] = pv;
      }
    }

    // O += P V: P's accumulator fragments are PV's A fragments.  int8 V is
    // exact in bf16, so there P * v_scale goes in as two bf16 terms (hi + lo,
    // ~16 significant bits): the fp32 P of the Pallas kernel's int8 branch
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pf[4], pl[4];
      split_bf16<QUANT>(sc[2 * kk][0], sc[2 * kk][1], pf[0], pl[0]);
      split_bf16<QUANT>(sc[2 * kk][2], sc[2 * kk][3], pf[1], pl[1]);
      split_bf16<QUANT>(sc[2 * kk + 1][0], sc[2 * kk + 1][1], pf[2], pl[2]);
      split_bf16<QUANT>(sc[2 * kk + 1][2], sc[2 * kk + 1][3], pf[3], pl[3]);
      const __nv_bfloat16* vr = vt + (kk * 16 + 2 * tig) * LD + g;
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        const __nv_bfloat16* p = vr + nt * 8;
        const uint32_t b0 = ld_col_pair(p, LD), b1 = ld_col_pair(p + 8 * LD, LD);
        mma_16816(acc[nt], pf, b0, b1);
        if constexpr (QUANT) mma_16816(acc[nt], pl, b0, b1);
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

template <int HD, bool QUANT>
int launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
           void* out, int B, int Sq, int Sk, int H, int KVH, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = Layout<HD, QUANT>::smem_bytes;
  auto kern = flash_fwd_kernel<HD, QUANT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = Sq * (H / KVH);
  dim3 grid((rows + BM - 1) / BM, B * KVH);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const __nv_bfloat16*>(q), k, v, ks, vs,
                                         static_cast<__nv_bfloat16*>(out), Sq, Sk, H, KVH,
                                         causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/out (B, Sq, H, hd) bf16; k/v (B, Sk, KVH, hd) bf16, or int8 with
// (B, Sk, KVH) f32 scales; hd 64 (the head dim of the served models; the
// kernel is written for any multiple of 16).  window <= 0: no window.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const float* k_scale, const float* v_scale, void* out,
                                      int B, int Sq, int Sk, int H, int KVH, int hd, int causal,
                                      int window, float scale, int kv_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0) return 0;
#define FA_ARGS q, k, v, k_scale, v_scale, out, B, Sq, Sk, H, KVH, causal, window, scale, s
  if (hd == 64 && kv_dtype == DT_I8) return launch<64, true>(FA_ARGS);
  if (hd == 64 && kv_dtype == DT_BF16) return launch<64, false>(FA_ARGS);
#undef FA_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
