// B3: single-pass multi-query decode attention over the paged KV pool,
// pages split over a thread-block cluster and fed by TMA.
//
// Replaces repro/kernels/flash_attention.py:paged_decode_attention (the
// Pallas kernel body _paged_decode_kernel).  The T*G query rows that share
// a KV head (T new tokens per sequence times G = H / KVH grouped heads; row
// r = t * G + g) attend to the sequence's pages through the page table:
// int8 K/V are dequantized by the per-(slot, head) scales, the online
// softmax (m, l, acc) is fp32 with the reference's -1e30 mask constant, row
// r is query position pos[b] + r / G (causal) and sees kv_pos <= that
// position, optionally inside a sliding window and through a tanh softcap.
//
// Bound on this card: bytes and latency.  At T*G = 8 rows and hd 64 a key
// costs about 2 KFLOP against 136 bytes (int8 K and V plus two scales), far
// left of the ridge, and a decode step's pages are a few hundred KB: the
// time is the launch, the latency of the first page, and how many pages
// are in flight.  So the design spreads a sequence's pages over many SMs
// and keeps several pages of each in flight; the arithmetic stays on the
// CUDA cores in fp32 (for every q dtype; no tensor cores needed).
//
// - Grid (split * B * KVH).  The ``split`` CTAs of one (b, kvh) form a
//   cluster; ``split`` (<= 8) comes from shapes on the host
//   (kernels/flash_attention.paged_split), never from pos, which lies on
//   the card.  The live pages run from the first that the window lets any
//   row see to the last that covers pos + T - 1 (pages outside add exactly
//   nothing: a fully masked page leaves alpha = 1 and p = 0 once a row has
//   seen a key); rank r takes live pages r, r + split, ...
// - In each CTA a producer warp reads the rank's table entries (32 at a
//   time; without a window the first 32 go out beside pos, as the rank's
//   pages do not depend on it) and keeps a ring of ``stages`` pages in
//   flight: one 4-D TMA box (hd, 1 head, ps slots, 1 page) each for K and
//   V, completing on the stage's "full" mbarrier by transaction bytes, and
//   for int8 the page's 2 * ps scales by 4-byte cp.async, tracked by the
//   same barrier (one noinc arrival per producer lane).  The tensor maps
//   are prefetched at entry.  A one-page launch is still a chain of
//   dependent loads (pos, table, page, output).
// - ``groups`` groups of four consumer warps (1, 2 or 4) score the rank's
//   pages, group g taking its pages g, g + groups, ..., each group with its
//   own online softmax state: at these sizes a page is a chain of dependent
//   instructions, so several pages are scored at once.  The host takes as
//   many groups as the head dim's registers, the ring and shared memory
//   allow and as keep the launch in one wave
//   (kernels/flash_attention.paged_groups).  The four warps of a group own
//   T*G / 4 rows each and take them two at a time: lane (key, half) forms
//   both rows' dot products over its half of hd for one key of a 16-key
//   chunk (the halves meet by one shuffle), then holds the score of row
//   ``half``; max and sum are 16-lane shuffles; p * v_scale goes through
//   the warp's shared buffer; each lane keeps hd / 32 columns of both rows'
//   accumulators.  int8 converts to fp32 exactly by the 2^23 magic number
//   (as wgmma_column.cuh's conversion does); exp2 with log2(e) applied to
//   the capped score.  A group's warps release the stage on its "empty"
//   mbarrier; no block-wide barrier per page.
// - After the pages, one barrier over the consumers; group 0 adds the other
//   groups' states to its own in group order.  With split > 1, after a
//   cluster barrier rank 0 reads every rank's (m, l, acc) from distributed
//   shared memory in rank order and writes out; a rank or group with no
//   page holds (-1e30, 0, 0) and adds nothing.  No atomics: two launches
//   give the same bits.
#include <math_constants.h>

#include <type_traits>

#include "hopper.cuh"

namespace pda {

constexpr int kGroupWarps = 4;    // consumer warps of a group (its rows)
constexpr int kMaxSplit = 8;      // CTAs of a cluster (the portable limit)
constexpr int kChunk = 16;        // keys of one scoring pass (lanes of a row)
constexpr float kMasked = -1e30f;  // the reference's mask constant
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr size_t round_up(size_t n, size_t a) { return (n + a - 1) / a * a; }

// groups of consumer warps a CTA may run: a thread of the hd 64 kernel
// needs under 120 registers (4 groups, 544 threads), of hd 128 under 227
// (2 groups), of hd 256 up to 166 (1 group)
__host__ __device__ constexpr int max_groups(int hd) { return hd == 64 ? 4 : hd == 128 ? 2 : 1; }
__host__ __device__ constexpr int threads(int groups) { return 32 * (kGroupWarps * groups + 1); }

// The shared-memory layout (kernels/flash_attention.paged_smem_bytes
// mirrors it): q (R x hd fp32, pre-scaled), each group's acc (R x hd fp32),
// each group's m, then l (R each), each consumer warp's p (2 x 16), then
// the ring -- per stage the K and V
// tiles (ps x hd of the pool's type, 128-byte aligned for TMA) and, for
// int8, the K and V scales -- then the full and empty mbarriers; 128 bytes
// of slack align the base.
struct Layout {
  int R, hd, ps, elem, quant, stages, groups;
  __host__ __device__ size_t tile() const { return round_up(size_t(ps) * hd * elem, 128); }
  __host__ __device__ size_t scales() const { return quant ? round_up(size_t(ps) * 4, 128) : 0; }
  __host__ __device__ size_t stage() const { return 2 * tile() + 2 * scales(); }
  __host__ __device__ size_t acc() const { return size_t(R) * hd * 4; }
  __host__ __device__ size_t m() const { return (1 + size_t(groups)) * R * hd * 4; }
  __host__ __device__ size_t l() const { return m() + size_t(groups) * R * 4; }
  __host__ __device__ size_t p() const { return l() + size_t(groups) * R * 4; }
  __host__ __device__ size_t ring() const {
    return round_up(p() + size_t(groups) * kGroupWarps * 2 * kChunk * 4, 128);
  }
  __host__ __device__ size_t bars() const { return ring() + size_t(stages) * stage(); }
  __host__ __device__ size_t total() const { return bars() + 2 * size_t(stages) * 8 + 128; }
};

// four consecutive pool elements as fp32; int8 exactly: 0x4B000000 | (w +
// 128) is the fp32 2^23 + w + 128
__device__ __forceinline__ void load4(const int8_t* p, float* f) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.0f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.0f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.0f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.0f;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);  // a bf16 is the top half of its fp32
  f[0] = __uint_as_float(u.x << 16), f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16), f[3] = __uint_as_float(u.y & 0xffff0000u);
}
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
}

// two consecutive pool elements as fp32
__device__ __forceinline__ void load2(const int8_t* p, float* f) {
  const uint32_t u = static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p)) ^ 0x8080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.0f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.0f;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float* f) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  f[0] = __uint_as_float(u << 16), f[1] = __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ void load2(const float* p, float* f) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  f[0] = v.x, f[1] = v.y;
}

// N (2, 4, 8) consecutive pool elements as fp32
template <int N, typename KT>
__device__ __forceinline__ void loadn(const KT* p, float* f) {
  if constexpr (N == 2) {
    load2(p, f);
  } else {
#pragma unroll
    for (int e = 0; e < N; e += 4) load4(p + e, f + e);
  }
}

template <int HD, typename QT, typename KT>
__global__ void __launch_bounds__(threads(max_groups(HD)))
paged_decode_kernel(const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const QT* __restrict__ q,              // (B, T, H, HD)
                    const float* __restrict__ k_scales,    // (num_pages, ps, pool_kvh) or null
                    const float* __restrict__ v_scales,
                    const int* __restrict__ table,         // (B, P), clamped by the wrapper
                    const int* __restrict__ pos,           // (B,)
                    QT* __restrict__ out,                  // (B, T, H, HD)
                    int T, int H, int KVH, int pool_kvh, int kv_off, int P, int ps,
                    int causal, int window, float softcap, float scale, int split, int stages,
                    int groups) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int kHalf = HD / 2;  // columns of a lane's half of a dot product
  constexpr int kPV = HD / 32;   // accumulator columns per lane
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~static_cast<uintptr_t>(127));
  const int G = H / KVH, R = T * G;
  const Layout L{R, HD, ps, static_cast<int>(sizeof(KT)), kQuant, stages, groups};
  float* qs = reinterpret_cast<float*>(smem);
  float* acc0 = reinterpret_cast<float*>(smem + L.acc());  // group g's at + g * R * HD
  float* m0 = reinterpret_cast<float*>(smem + L.m());      // group g's at + g * R
  float* l0 = reinterpret_cast<float*>(smem + L.l());
  float* pb0 = reinterpret_cast<float*>(smem + L.p());
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars());
  uint64_t* empty = full + stages;

  const int rank = blockIdx.x % split;
  const int b = blockIdx.x / split / KVH, kvh = blockIdx.x / split % KVH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp / kGroupWarps;  // groups: the producer warp
  const int* trow = table + static_cast<size_t>(b) * P;
  // the producer's first 32 table entries: without a window the rank's
  // pages do not depend on pos, so their loads go out beside pos's
  int phys_pre = 0;
  if (grp == groups) {
    if (lane == 0) {
      prefetch_tensormap(&kmap);
      prefetch_tensormap(&vmap);
    }
    if (window <= 0 && rank + lane * split < P) phys_pre = trow[rank + lane * split];
  }
  const int p0 = pos[b];
  const int last_pos = causal ? p0 + T - 1 : p0;
  const int end = max(1, min(last_pos / ps + 1, P));
  const int first = window > 0 ? min(max(p0 - window + 1, 0) / ps, end - 1) : 0;
  const int live = end - first;
  const int mine = live > rank ? (live - rank + split - 1) / split : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], kQuant ? 33 : 1);  // the TMA issue (+ 32 cp.async lanes)
      mbar_init(&empty[s], kGroupWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int n_consumers = kGroupWarps * groups * 32;
  const int rpw = (R + kGroupWarps - 1) / kGroupWarps;
  const int r_lo = min(R, warp % kGroupWarps * rpw), r_hi = min(R, r_lo + rpw);  // its rows
  auto q_off = [&](int r) {
    return ((static_cast<size_t>(b) * T + r / G) * H + kvh * G + r % G) * HD;
  };

  if (grp == groups) {
    // -- producer ------------------------------------------------------------------
    const uint32_t tx = 2u * ps * HD * static_cast<uint32_t>(sizeof(KT));
    for (int base = 0; base < mine; base += 32) {
      const int li = base + lane;
      int phys_l = phys_pre;
      if (base > 0 || window > 0) phys_l = li < mine ? trow[first + rank + li * split] : 0;
      const int cnt = min(32, mine - base);
      for (int jj = 0; jj < cnt; ++jj) {
        const int i = base + jj, st = i % stages;
        if (i >= stages) mbar_wait(&empty[st], ((i / stages) - 1) & 1);
        const int phys = __shfl_sync(0xffffffffu, phys_l, jj);
        unsigned char* sb = smem + L.ring() + st * L.stage();
        if constexpr (kQuant) {
          float* ksd = reinterpret_cast<float*>(sb + 2 * L.tile());
          float* vsd = ksd + L.scales() / 4;
          for (int l = lane; l < ps; l += 32) {
            const size_t row = (static_cast<size_t>(phys) * ps + l) * pool_kvh + kv_off + kvh;
            cp_async4(ksd + l, k_scales + row);
            cp_async4(vsd + l, v_scales + row);
          }
          cp_async_mbar_arrive_noinc(&full[st]);
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[st], tx);
          tma_load_4d(sb, &kmap, 0, kv_off + kvh, 0, phys, &full[st]);
          tma_load_4d(sb + L.tile(), &vmap, 0, kv_off + kvh, 0, phys, &full[st]);
        }
        __syncwarp();
      }
    }
  } else {
    // -- consumers -----------------------------------------------------------------
    for (int i = threadIdx.x; i < R * HD; i += n_consumers) {
      const int r = i / HD;
      qs[i] = to_float(q[q_off(r) + i % HD]) * scale;
      for (int g = 0; g < groups; ++g) acc0[g * R * HD + i] = 0.0f;
    }
    for (int i = threadIdx.x; i < groups * R; i += n_consumers) {
      m0[i] = kMasked;
      l0[i] = 0.0f;
    }
    named_bar_sync(1, n_consumers);
    float* acc = acc0 + grp * R * HD;
    float* m_s = m0 + grp * R;
    float* l_s = l0 + grp * R;
    // lane (kk, h): key kk of a 16-key chunk; in the scores, d half h of
    // both rows of a pass, then row r0 + h of the softmax; in PV, columns
    // lane * kPV .. of both rows
    const int h = lane >> 4, kk = lane & (kChunk - 1);
    float* pbuf = pb0 + warp * 2 * kChunk;  // this warp's p * v_scale, [2 rows][16 keys]
    for (int i = grp; i < mine; i += groups) {
      const int st = i % stages;
      mbar_wait(&full[st], (i / stages) & 1);
      const unsigned char* sb = smem + L.ring() + st * L.stage();
      const KT* kt = reinterpret_cast<const KT*>(sb);
      const KT* vt = reinterpret_cast<const KT*>(sb + L.tile());
      const float* ksc = reinterpret_cast<const float*>(sb + 2 * L.tile());
      const float* vsc = ksc + L.scales() / 4;
      const int kv0 = (first + rank + i * split) * ps;
      for (int r0 = r_lo; r0 < r_hi; r0 += 2) {
        const bool two = r0 + 1 < r_hi;
        const int r = r0 + h;  // this lane's row in the softmax
        const bool rv = r < r_hi;
        const int q_pos = causal ? p0 + r / G : p0;
        const float* qa = qs + r0 * HD + h * kHalf;
        const float* qb = two ? qa + HD : qa;  // row r0 + 1 (r0 again where there is none)
        for (int c0 = 0; c0 < ps; c0 += kChunk) {
          const int key = c0 + kk;
          float sa = 0.0f, sb2 = 0.0f;  // half-h dot products of rows r0, r0 + 1
          if (key < ps) {
            const KT* kr = kt + static_cast<size_t>(key) * HD + h * kHalf;
            float a2[2] = {0.0f, 0.0f}, b2[2] = {0.0f, 0.0f};
#pragma unroll
            for (int jd = 0; jd < kHalf / 8; ++jd) {
              // lanes start at different columns: fewer bank conflicts on K
              const int d = ((jd + kk) & (kHalf / 8 - 1)) * 8;
              float kv[8];
              load4(kr + d, kv);
              load4(kr + d + 4, kv + 4);
              const float4 x0 = *reinterpret_cast<const float4*>(qa + d);
              const float4 x1 = *reinterpret_cast<const float4*>(qa + d + 4);
              const float4 y0 = *reinterpret_cast<const float4*>(qb + d);
              const float4 y1 = *reinterpret_cast<const float4*>(qb + d + 4);
              a2[0] = fmaf(x0.x, kv[0], a2[0]);
              a2[1] = fmaf(x0.y, kv[1], a2[1]);
              b2[0] = fmaf(y0.x, kv[0], b2[0]);
              b2[1] = fmaf(y0.y, kv[1], b2[1]);
              a2[0] = fmaf(x0.z, kv[2], a2[0]);
              a2[1] = fmaf(x0.w, kv[3], a2[1]);
              b2[0] = fmaf(y0.z, kv[2], b2[0]);
              b2[1] = fmaf(y0.w, kv[3], b2[1]);
              a2[0] = fmaf(x1.x, kv[4], a2[0]);
              a2[1] = fmaf(x1.y, kv[5], a2[1]);
              b2[0] = fmaf(y1.x, kv[4], b2[0]);
              b2[1] = fmaf(y1.y, kv[5], b2[1]);
              a2[0] = fmaf(x1.z, kv[6], a2[0]);
              a2[1] = fmaf(x1.w, kv[7], a2[1]);
              b2[0] = fmaf(y1.z, kv[6], b2[0]);
              b2[1] = fmaf(y1.w, kv[7], b2[1]);
            }
            sa = a2[0] + a2[1];
            sb2 = b2[0] + b2[1];
          }
          sa += __shfl_xor_sync(0xffffffffu, sa, 16);  // the other d half
          sb2 += __shfl_xor_sync(0xffffffffu, sb2, 16);
          float s = -CUDART_INF_F;  // no key or no row: p = 0 whatever the row's max
          if (rv && key < ps) {
            float dot = h ? sb2 : sa;
            if (kQuant) dot *= ksc[key];
            if (softcap > 0.0f) dot = tanhf(dot / softcap) * softcap;
            const int kv_pos = kv0 + key;
            bool keep = kv_pos <= q_pos;
            if (window > 0) keep = keep && kv_pos > q_pos - window;
            s = keep ? dot * kLog2e : kMasked;
          }
          float mx = s;
#pragma unroll
          for (int o = kChunk / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          const float m_prev = rv ? m_s[r] : kMasked;
          const float l_prev = rv ? l_s[r] : 0.0f;
          const float m_new = fmaxf(m_prev, mx);
          const float p = exp2f(s - m_new);
          float sum = p;
#pragma unroll
          for (int o = kChunk / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
          const float alpha = exp2f(m_prev - m_new);
          const float alpha_o = __shfl_xor_sync(0xffffffffu, alpha, 16);  // the other row's
          pbuf[h * kChunk + kk] = (kQuant && key < ps) ? p * vsc[key] : p;
          __syncwarp();
          const float al0 = h ? alpha_o : alpha, al1 = h ? alpha : alpha_o;
          float* ar = acc + r0 * HD + lane * kPV;
          float a0[kPV], a1[kPV];
#pragma unroll
          for (int e = 0; e < kPV; ++e) {
            a0[e] = ar[e] * al0;
            a1[e] = two ? ar[HD + e] * al1 : 0.0f;
          }
          const int nk = min(kChunk, ps - c0);
#pragma unroll 4
          for (int k = 0; k < nk; ++k) {
            const float pk0 = pbuf[k], pk1 = pbuf[kChunk + k];
            float v[kPV];
            loadn<kPV>(vt + static_cast<size_t>(c0 + k) * HD + lane * kPV, v);
#pragma unroll
            for (int e = 0; e < kPV; ++e) {
              a0[e] = fmaf(pk0, v[e], a0[e]);
              a1[e] = fmaf(pk1, v[e], a1[e]);
            }
          }
#pragma unroll
          for (int e = 0; e < kPV; ++e) {
            ar[e] = a0[e];
            if (two) ar[HD + e] = a1[e];
          }
          if (rv && kk == 0) {
            m_s[r] = m_new;
            l_s[r] = l_prev * alpha + sum;
          }
          __syncwarp();
        }
      }
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    if (groups > 1) {
      // group 0 adds the other groups' states for its rows, in group order
      named_bar_sync(1, n_consumers);
      if (grp == 0) {
        for (int r = r_lo; r < r_hi; ++r) {
          float M = kMasked;
          for (int g = 0; g < groups; ++g) M = fmaxf(M, m0[g * R + r]);
          float Lsum = 0.0f;
          for (int g = 0; g < groups; ++g) Lsum = fmaf(l0[g * R + r], exp2f(m0[g * R + r] - M), Lsum);
          for (int d = lane; d < HD; d += 32) {
            float A = 0.0f;
            for (int g = 0; g < groups; ++g)
              A = fmaf(acc0[(g * R + r) * HD + d], exp2f(m0[g * R + r] - M), A);
            acc0[r * HD + d] = A;
          }
          __syncwarp();
          if (lane == 0) m0[r] = M, l0[r] = Lsum;
          __syncwarp();
        }
      }
    }
    if (split == 1 && grp == 0) {
      for (int i = lane; i < (r_hi - r_lo) * HD; i += 32) {
        const int r = r_lo + i / HD, d = i % HD;
        out[q_off(r) + d] = from_float<QT>(acc0[r * HD + d] / fmaxf(l0[r], 1e-30f));
      }
    }
  }

  if (split > 1) {
    // every rank's state is whole; rank 0 combines them in rank order
    cluster_sync();
    if (rank == 0 && grp == 0) {
      for (int r = r_lo; r < r_hi; ++r) {
        float mp[kMaxSplit], w[kMaxSplit];
        float M = kMasked;
#pragma unroll
        for (int pr = 0; pr < kMaxSplit; ++pr)
          if (pr < split) {
            mp[pr] = ld_peer_f32(peer_addr(m0 + r, pr));
            M = fmaxf(M, mp[pr]);
          }
        float Lsum = 0.0f;
#pragma unroll
        for (int pr = 0; pr < kMaxSplit; ++pr)
          if (pr < split) {
            w[pr] = exp2f(mp[pr] - M);
            Lsum = fmaf(ld_peer_f32(peer_addr(l0 + r, pr)), w[pr], Lsum);
          }
        const float l_tot = fmaxf(Lsum, 1e-30f);
        for (int d = lane; d < HD; d += 32) {
          float A = 0.0f;
#pragma unroll
          for (int pr = 0; pr < kMaxSplit; ++pr)
            if (pr < split) A = fmaf(ld_peer_f32(peer_addr(acc0 + r * HD + d, pr)), w[pr], A);
          out[q_off(r) + d] = from_float<QT>(A / l_tot);
        }
      }
    }
    cluster_sync();  // no CTA exits while rank 0 still reads its shared memory
  }
}

// one pool (num_pages, ps, KVH, hd) as boxes of (hd, 1 head, ps slots, 1
// page), no swizzle; the box lands as ps rows of hd elements
inline bool encode_page_map(CUtensorMap* map, const void* pool, int num_pages, int ps, int KVH,
                            int hd, int elem, CUtensorMapDataType type) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * elem;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(KVH),
                              static_cast<cuuint64_t>(ps), static_cast<cuuint64_t>(num_pages)};
  const cuuint64_t strides[3] = {row, row * KVH, row * KVH * ps};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(hd), 1, static_cast<cuuint32_t>(ps), 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(pool), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename KT> constexpr CUtensorMapDataType map_type();
template <> constexpr CUtensorMapDataType map_type<int8_t>() { return CU_TENSOR_MAP_DATA_TYPE_UINT8; }
template <> constexpr CUtensorMapDataType map_type<__nv_bfloat16>() {
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}
template <> constexpr CUtensorMapDataType map_type<float>() { return CU_TENSOR_MAP_DATA_TYPE_FLOAT32; }

template <int HD, typename QT, typename KT>
static int launch(const void* q, const void* kp, const void* vp, const float* ksc,
                  const float* vsc, const int* table, const int* pos, void* out, int B, int T,
                  int H, int KVH, int pool_kvh, int kv_off, int P, int ps, int num_pages,
                  int causal, int window, float softcap, float scale, int split, int stages,
                  int groups, cudaStream_t stream) {
  // a group waits on the stage of its next page, ``groups`` pages on: more
  // groups than stages would let that stage's barrier be two phases behind,
  // which its parity cannot tell
  if (groups < 1 || groups > max_groups(HD) || groups > stages)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L{T * (H / KVH), HD, ps, static_cast<int>(sizeof(KT)),
                 std::is_same<KT, int8_t>::value, stages, groups};
  CUtensorMap kmap, vmap;
  if (!encode_page_map(&kmap, kp, num_pages, ps, pool_kvh, HD, sizeof(KT), map_type<KT>()) ||
      !encode_page_map(&vmap, vp, num_pages, ps, pool_kvh, HD, sizeof(KT), map_type<KT>()))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = paged_decode_kernel<HD, QT, KT>;
  // set on every call, as the attribute is per device
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.total()));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split * B * KVH, 1, 1);
  cfg.blockDim = dim3(threads(groups), 1, 1);
  cfg.dynamicSmemBytes = L.total();
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, kmap, vmap, static_cast<const QT*>(q), ksc, vsc, table,
                           pos, static_cast<QT*>(out), T, H, KVH, pool_kvh, kv_off, P, ps, causal,
                           window, softcap, scale, split, stages, groups);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
static int launch_hd(int q_dtype, int kv_dtype, const void* q, const void* kp, const void* vp,
                     const float* ksc, const float* vsc, const int* table, const int* pos,
                     void* out, int B, int T, int H, int KVH, int pool_kvh, int kv_off, int P,
                     int ps, int num_pages, int causal, int window, float softcap, float scale,
                     int split, int stages, int groups, cudaStream_t s) {
#define PDA_ARGS q, kp, vp, ksc, vsc, table, pos, out, B, T, H, KVH, pool_kvh, kv_off, P, ps, num_pages, causal, window, softcap, scale, split, stages, groups, s
  if (kv_dtype == DT_I8) {
    if (q_dtype == DT_BF16) return launch<HD, __nv_bfloat16, int8_t>(PDA_ARGS);
    if (q_dtype == DT_F32) return launch<HD, float, int8_t>(PDA_ARGS);
  } else if (kv_dtype == q_dtype) {
    if (q_dtype == DT_BF16) return launch<HD, __nv_bfloat16, __nv_bfloat16>(PDA_ARGS);
    if (q_dtype == DT_F32) return launch<HD, float, float>(PDA_ARGS);
  }
#undef PDA_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace pda

// bytes of dynamic shared memory of a launch over R = T * G rows
extern "C" size_t paged_decode_smem_bytes(int R, int hd, int ps, int kv_dtype, int stages,
                                          int groups) {
  const int elem = kv_dtype == DT_I8 ? 1 : kv_dtype == DT_BF16 ? 2 : 4;
  return pda::Layout{R, hd, ps, elem, kv_dtype == DT_I8, stages, groups}.total();
}

// q/out (B, T, H, hd) f32|bf16; k/v pages (num_pages, ps, pool_kvh, hd) in
// q's dtype, or int8 with (num_pages, ps, pool_kvh) f32 scale pools, of
// which the launch reads KV heads [kv_off, kv_off + KVH) (a rank's heads
// of a pool that holds them all), H / KVH query heads each; pools 16-byte
// aligned; hd 64, 128 or 256; ps <= 256; split 1..8 CTAs per (b, kvh) in a
// cluster; stages >= 1 pages in flight per CTA; groups 1..max_groups(hd)
// groups of four consumer warps.  Returns a cudaError_t code (0 =
// launched).
extern "C" int paged_decode_launch(const void* q, const void* k_pages, const void* v_pages,
                                   const float* k_scales, const float* v_scales,
                                   const int* table, const int* pos, void* out,
                                   int B, int T, int H, int KVH, int hd, int P, int ps,
                                   int num_pages, int causal, int window, float softcap,
                                   float scale, int q_dtype, int kv_dtype, int pool_kvh,
                                   int kv_off, int split, int stages, int groups,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0) return 0;
  if (split < 1 || split > pda::kMaxSplit || stages < 1 || ps < 1 || ps > 256 || P < 1 ||
      kv_off < 0 || kv_off + KVH > pool_kvh)
    return static_cast<int>(cudaErrorInvalidValue);
#define PDA_ARGS q_dtype, kv_dtype, q, k_pages, v_pages, k_scales, v_scales, table, pos, out, B, T, H, KVH, pool_kvh, kv_off, P, ps, num_pages, causal, window, softcap, scale, split, stages, groups, s
  if (hd == 64) return pda::launch_hd<64>(PDA_ARGS);
  if (hd == 128) return pda::launch_hd<128>(PDA_ARGS);
  if (hd == 256) return pda::launch_hd<256>(PDA_ARGS);
#undef PDA_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
