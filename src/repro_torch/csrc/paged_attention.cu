// B3: single-pass multi-query decode attention over the paged KV pool.
//
// Replaces repro/kernels/flash_attention.py:paged_decode_attention (the
// Pallas kernel body _paged_decode_kernel).  One CTA per (sequence b, KV
// head kvh) holds the T*G query rows that share that KV head (T new tokens
// per sequence times G = H / KVH grouped heads; row r = t * G + g).  It
// walks the sequence's pages through the page table, dequantizes int8 K/V
// on load with the per-(slot, head) scales, and keeps an fp32 online
// softmax (m, l, acc) with the reference's -1e30 mask constant.  Row r is
// query position pos[b] + r / G (causal) and sees kv_pos <= that position,
// optionally inside a sliding window and through a tanh softcap.
//
// The loop stops after the last page that covers pos + T - 1.  Pages past
// it are fully masked, and a fully masked page adds exactly nothing to the
// running statistics (alpha = 1, p = 0), so the result equals a sweep over
// all pages_per_seq pages.
//
// Bound on this card: bytes -- the pages read (K and V payload plus their
// scales), q and o over 3.35 TB/s.  Each page crosses device memory once
// per step whatever T is.  This first version keeps one CTA per (b, kvh);
// splitting the page loop across CTAs (flash-decoding) comes later.
#include "common.cuh"

constexpr int kThreads = 128;

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const QT* __restrict__ q,          // (B, T, H, hd)
                    const KT* __restrict__ k_pages,    // (num_pages, ps, KVH, hd)
                    const KT* __restrict__ v_pages,
                    const float* __restrict__ k_scales,  // (num_pages, ps, KVH) or null
                    const float* __restrict__ v_scales,
                    const int* __restrict__ table,     // (B, P), clamped by the wrapper
                    const int* __restrict__ pos,       // (B,)
                    QT* __restrict__ out,              // (B, T, H, hd)
                    int T, int H, int KVH, int hd, int P, int ps,
                    int causal, int window, float softcap, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int G = H / KVH;
  const int R = T * G;
  const int ks_stride = hd + 1;  // padded: the score loop reads ks by slot
  float* qs = smem;                  // R * hd
  float* ks = qs + R * hd;           // ps * (hd + 1)
  float* vs = ks + ps * ks_stride;   // ps * hd
  float* sc = vs + ps * hd;          // R * ps
  float* m_s = sc + R * ps;          // R
  float* l_s = m_s + R;              // R
  float* a_s = l_s + R;              // R
  float* acc = a_s + R;              // R * hd

  const int b = blockIdx.x / KVH;
  const int kvh = blockIdx.x % KVH;
  const int tid = threadIdx.x;

  for (int i = tid; i < R * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    const int t = r / G, g = r % G;
    const size_t off = ((static_cast<size_t>(b) * T + t) * H + kvh * G + g) * hd + d;
    qs[i] = to_float(q[off]) * scale;
    acc[i] = 0.0f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = -1e30f;
    l_s[r] = 0.0f;
  }
  __syncthreads();

  const int p0 = pos[b];
  const int last_pos = causal ? p0 + T - 1 : p0;
  int n_pages = last_pos / ps + 1;
  if (n_pages > P) n_pages = P;

  for (int p = 0; p < n_pages; ++p) {
    const size_t phys = static_cast<size_t>(table[static_cast<size_t>(b) * P + p]);
    for (int i = tid; i < ps * hd; i += kThreads) {
      const int slot = i / hd, d = i % hd;
      const size_t row = (phys * ps + slot) * KVH + kvh;
      float kv = to_float(k_pages[row * hd + d]);
      float vv = to_float(v_pages[row * hd + d]);
      if (k_scales != nullptr) {
        kv *= k_scales[row];
        vv *= v_scales[row];
      }
      ks[slot * ks_stride + d] = kv;
      vs[slot * hd + d] = vv;
    }
    __syncthreads();
    for (int i = tid; i < R * ps; i += kThreads) {
      const int r = i / ps, slot = i % ps;
      const float* qr = qs + r * hd;
      const float* kr = ks + slot * ks_stride;
      float s = 0.0f;
      for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kr[d], s);
      if (softcap > 0.0f) s = tanhf(s / softcap) * softcap;
      const int kv_pos = p * ps + slot;
      const int q_pos = causal ? p0 + r / G : p0;
      bool keep = kv_pos <= q_pos;
      if (window > 0) keep = keep && kv_pos > q_pos - window;
      sc[i] = keep ? s : -1e30f;
    }
    __syncthreads();
    for (int r = tid; r < R; r += kThreads) {
      const float m_prev = m_s[r];
      float m_new = m_prev;
      for (int slot = 0; slot < ps; ++slot) m_new = fmaxf(m_new, sc[r * ps + slot]);
      float sum = 0.0f;
      for (int slot = 0; slot < ps; ++slot) {
        const float e = expf(sc[r * ps + slot] - m_new);
        sc[r * ps + slot] = e;
        sum += e;
      }
      const float alpha = expf(m_prev - m_new);
      l_s[r] = l_s[r] * alpha + sum;
      m_s[r] = m_new;
      a_s[r] = alpha;
    }
    __syncthreads();
    for (int i = tid; i < R * hd; i += kThreads) {
      const int r = i / hd, d = i % hd;
      float v = acc[i] * a_s[r];
      for (int slot = 0; slot < ps; ++slot) v = fmaf(sc[r * ps + slot], vs[slot * hd + d], v);
      acc[i] = v;
    }
    __syncthreads();
  }

  for (int i = tid; i < R * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    const int t = r / G, g = r % G;
    const size_t off = ((static_cast<size_t>(b) * T + t) * H + kvh * G + g) * hd + d;
    out[off] = from_float<QT>(acc[i] / fmaxf(l_s[r], 1e-30f));
  }
}

extern "C" size_t paged_decode_smem_bytes(int R, int hd, int ps) {
  return sizeof(float) * (static_cast<size_t>(R) * hd * 2 + static_cast<size_t>(ps) * (hd + 1) +
                          static_cast<size_t>(ps) * hd + static_cast<size_t>(R) * ps + 3 * R);
}

template <typename QT, typename KT>
static int launch(const void* q, const void* kp, const void* vp, const float* ksc,
                  const float* vsc, const int* table, const int* pos, void* out, int B, int T,
                  int H, int KVH, int hd, int P, int ps, int causal, int window, float softcap,
                  float scale, cudaStream_t stream) {
  const size_t smem = paged_decode_smem_bytes(T * (H / KVH), hd, ps);
  auto kern = paged_decode_kernel<QT, KT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<B * KVH, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(kp), static_cast<const KT*>(vp), ksc, vsc,
      table, pos, static_cast<QT*>(out), T, H, KVH, hd, P, ps, causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

// q/out (B, T, H, hd) f32|bf16; k/v pages (num_pages, ps, KVH, hd) in
// q's dtype, or int8 with (num_pages, ps, KVH) f32 scale pools.
extern "C" int paged_decode_launch(const void* q, const void* k_pages, const void* v_pages,
                                   const float* k_scales, const float* v_scales,
                                   const int* table, const int* pos, void* out,
                                   int B, int T, int H, int KVH, int hd, int P, int ps,
                                   int causal, int window, float softcap, float scale,
                                   int q_dtype, int kv_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
#define PDA_ARGS q, k_pages, v_pages, k_scales, v_scales, table, pos, out, B, T, H, KVH, hd, P, ps, causal, window, softcap, scale, s
  if (kv_dtype == DT_I8) {
    if (q_dtype == DT_BF16) return launch<__nv_bfloat16, int8_t>(PDA_ARGS);
    if (q_dtype == DT_F32) return launch<float, int8_t>(PDA_ARGS);
  } else if (kv_dtype == q_dtype) {
    if (q_dtype == DT_BF16) return launch<__nv_bfloat16, __nv_bfloat16>(PDA_ARGS);
    if (q_dtype == DT_F32) return launch<float, float>(PDA_ARGS);
  }
#undef PDA_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
