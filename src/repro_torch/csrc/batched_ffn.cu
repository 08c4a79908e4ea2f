// B7: weight-stationary fully-connected layer  y = act(x @ w + b)  for Hopper.
//
// Replaces repro/kernels/batched_ffn.py:batched_ffn (the Pallas kernel whose
// grid keeps a (bk, bn) weight tile in VMEM while the batch tiles sweep past
// it: the paper's batch processing, Sections 4.2 / 5.5).  Bound on this
// card: at the paper's batches (1..32) a weight feeds at most 32 MACs
// (fp32: 8 FLOP per byte), far below the H100's balance point, so the
// layer is bound by its weight stream (K * N * 4 bytes over 3.35 TB/s:
// 3.6 us for HAR-6's 2000 x 1500).
//
// Design (stream_tile.cuh): every weight byte is read once per launch,
// through a cp.async ring of 16 KB stages, by a grid of (column strip, K
// slice) CTAs that covers the card, each strip's K sum split over a
// cluster; the CTA's K slice of x is staged once in shared memory as fp32
// (bf16 x converted there).  Each of the 256 threads owns 4 columns and
// RM = min(BM, 8) rows of the tile, and takes MG = BM / RM quads of 4 k
// rows of every stage: a quad's 4 x 4 weights, read from shared memory as
// float4, meet RM rows of x, 16 RM fp32 FMAs per 4 + RM shared loads, so
// FMA issue stays under the stream at BM = 32 (32 * 2000 * 1500 FMAs over
// 132 SMs at 128 a clock: ~3 us) and the k groups' partials the CTA adds
// at the end stay small (4 KB per row a thread, over the ring).  The MACs are fp32 FMA
// on the CUDA cores, never TF32, as the reference sums in fp32.  Partial
// sums are added in a fixed order: over the CTA's k-row groups in shared
// memory, then over the cluster's ranks in rank order (each rank finishes
// a slice of the outputs; no atomics: two launches give the same bits).  Bias and activation run once,
// after the cluster's sum.  Ragged M, K and N are masked (zero-filled
// copies); nothing is padded.
#include "stream_tile.cuh"

namespace {

constexpr int kMaxOut = 16;  // outputs a thread sums: BM * (512 / 4) / 256

// rows a thread multiplies (RM) and the tile's row groups (MG = BM / RM)
template <int BM> __host__ __device__ constexpr int rows_per_thread() { return BM < 8 ? BM : 8; }

// shared memory of a launch: the ring, x's K slice in fp32 (and bf16 x as
// it came) and the cluster's receive area; the k groups' partials at the
// end (4096 RM bytes, at most 32 KB) reuse the ring
template <int BM, typename XT>
__host__ __device__ constexpr int smem_bytes(int sb, int ks) {
  const int ksr = stile::slice_rows(ks, sb);
  const int raw = sizeof(XT) == 4 ? 0 : BM * stile::raw_pitch(ksr, 2);
  return stile::ring_bytes(sb) + BM * ksr * 4 + raw + stile::cluster_sum_bytes(BM * sb / 4);
}

template <int BM, typename XT>
__global__ void __launch_bounds__(stile::kThreads, 1)
batched_ffn_kernel(const XT* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b, XT* __restrict__ y, int M, int K, int N, int ldx,
                   int ldw, int act, stile::Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int RM = rows_per_thread<BM>(), MG = BM / RM;
  const int sb = plan.sb, split = plan.split;
  const int rank = blockIdx.x % split;
  const int cols = sb / 4, cg_n = sb / 16;  // fp32 columns and float4 groups of a strip
  const int kg_n = stile::kThreads / (cg_n * MG);  // k groups: a stage has kg_n * MG 4-row quads
  const int n0 = (blockIdx.x / split) * cols;
  const int m0 = blockIdx.y * BM;
  const int k_lo = min(K, rank * plan.ks), k_hi = min(K, k_lo + plan.ks), nk = k_hi - k_lo;
  const int ksr = stile::slice_rows(plan.ks, sb);
  const int rows = stile::stage_rows(sb);
  const int outs = BM * cols;
  float* xs = reinterpret_cast<float*>(smem + stile::ring_bytes(sb));  // [BM][ksr]
  unsigned char* raw = smem + stile::ring_bytes(sb) + BM * ksr * 4;    // bf16 x as it came
  const int rp = stile::raw_pitch(ksr, 2);
  const auto* xb = reinterpret_cast<const unsigned char*>(x);
  const int tid = threadIdx.x;
  // this thread's 4 columns, its k group and its RM rows of the tile
  const int cg = tid % cg_n, kq = (tid / cg_n) % kg_n, mg = tid / (cg_n * kg_n);

  float acc[RM][4];
#pragma unroll
  for (int r = 0; r < RM; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;

  auto prologue = [&] {
    if constexpr (sizeof(XT) == 4)
      stile::load_x_raw(reinterpret_cast<unsigned char*>(xs), xb, 4, size_t(ldx) * 4, m0, M, BM,
                        k_lo, nk, ksr * 4);
    else
      stile::load_x_raw(raw, xb, 2, size_t(ldx) * 2, m0, M, BM, k_lo, nk, rp);
  };
  stile::ClusterSum cs;
  auto issued = [&] {
    if (split > 1)
      cs = stile::cluster_sum_begin(smem + smem_bytes<BM, XT>(sb, plan.ks) -
                                        stile::cluster_sum_bytes(outs),
                                    outs, split, rank);
  };
  auto ready = [&] {
    if constexpr (sizeof(XT) == 2) {  // a warp a row; zeros past the slice were staged
      for (int m = tid >> 5; m < min(BM, M - m0); m += stile::kThreads / 32) {
        const unsigned char* r = raw + m * rp + stile::x_shift(xb, 2, size_t(ldx) * 2, m0 + m, k_lo);
        for (int k = tid & 31; k < ksr; k += 32)
          xs[m * ksr + k] = to_float(*reinterpret_cast<const XT*>(r + 2 * k));
      }
      __syncthreads();
    }
  };
  // quad q of a stage (rows 4q .. 4q + 3) for j = 0 .. MG - 1: q = kq + kg_n j
  auto consume = [&](const unsigned char* st, int s) {
#pragma unroll
    for (int j = 0; j < MG; ++j) {
      const int q = kq + kg_n * j;
      float4 wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wv[i] = *reinterpret_cast<const float4*>(st + (4 * q + i) * stile::ring_pitch(sb) + 16 * cg);
      const float* xk = xs + (mg * RM) * ksr + s * rows + 4 * q;
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(xk + r * ksr);
        const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[r][0] = fmaf(xa[i], wv[i].x, acc[r][0]);
          acc[r][1] = fmaf(xa[i], wv[i].y, acc[r][1]);
          acc[r][2] = fmaf(xa[i], wv[i].z, acc[r][2]);
          acc[r][3] = fmaf(xa[i], wv[i].w, acc[r][3]);
        }
      }
    }
  };
  stile::run_ring(smem, reinterpret_cast<const unsigned char*>(w), size_t(ldw) * 4, n0 * 4,
                  max(0, min(sb, (N - n0) * 4)), k_lo, k_hi, sb, plan.width, prologue, issued,
                  ready, consume);

  // the k groups' partials [kq][m][c], added in kq order (four running
  // sums, then their pairs: a fixed order with four loads in flight)
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int r = 0; r < RM; ++r)
    *reinterpret_cast<float4*>(red + (kq * BM + mg * RM + r) * cols + 4 * cg) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  float sum[kMaxOut];
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) {
    const int o = tid + i * stile::kThreads;
    float s4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (o < outs)
      for (int g = 0; g < kg_n; g += 4)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (g + e < kg_n) s4[e] += red[(g + e) * outs + o];
    sum[i] = (s4[0] + s4[1]) + (s4[2] + s4[3]);
  }
  auto finish = [&](int o, float v) {
    const int m = m0 + o / cols, n = n0 + o % cols;
    if (m < M && n < N) y[static_cast<size_t>(m) * N + n] = from_float<XT>(apply_act(act, v + b[n]));
  };
  if (split == 1) {
#pragma unroll
    for (int i = 0; i < kMaxOut; ++i)
      if (tid + i * stile::kThreads < outs) finish(tid + i * stile::kThreads, sum[i]);
    return;
  }
  stile::cluster_sum_ready();
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i)
    if (tid + i * stile::kThreads < outs)
      stile::cluster_sum_push(cs, tid + i * stile::kThreads, __float_as_uint(sum[i]));
  stile::cluster_sum_wait(cs);
  for (int o = cs.lo + tid; o < cs.hi; o += stile::kThreads) {
    float v = 0.0f;
    for (int p = 0; p < split; ++p) v += cs.recv[p * cs.per + (o - cs.lo)];
    finish(o, v);
  }
}

template <int BM, typename XT>
int launch_bm(const void* x, const float* w, const float* b, void* y, int M, int K, int N, int ldx,
              int ldw, int act, stile::Plan plan, cudaStream_t stream) {
  const int smem = smem_bytes<BM, XT>(plan.sb, plan.ks);
  if (smem > stile::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int n_strips = (N * 4 + plan.sb - 1) / plan.sb;
  static bool configured = false;
  return stile::launch(batched_ffn_kernel<BM, XT>, configured, n_strips, plan.split, (M + BM - 1) / BM, smem,
                       stream, static_cast<const XT*>(x), w, b, static_cast<XT*>(y), M, K, N, ldx,
                       ldw, act, plan);
}

// the BM a launch of M rows takes: the smallest power of two >= M, at most 32
int pick_bm(int M) {
  int bm = 1;
  while (bm < M && bm < 32) bm *= 2;
  return bm;
}

#define BFFN_DISPATCH_BM(M, CALL) \
  switch (pick_bm(M)) {           \
    case 1: return CALL(1);       \
    case 2: return CALL(2);       \
    case 4: return CALL(4);       \
    case 8: return CALL(8);       \
    case 16: return CALL(16);     \
    default: return CALL(32);     \
  }

template <typename XT>
int smem_for(int M, int sb, int ks) {
#define SMEM(BM) smem_bytes<BM, XT>(sb, ks)
  BFFN_DISPATCH_BM(M, SMEM)
#undef SMEM
}

template <typename XT>
int launch(const void* x, const float* w, const float* b, void* y, int M, int K, int N, int ldx,
           int ldw, int act, stile::Plan plan, cudaStream_t s) {
#define LAUNCH(BM) launch_bm<BM, XT>(x, w, b, y, M, K, N, ldx, ldw, act, plan, s)
  BFFN_DISPATCH_BM(M, LAUNCH)
#undef LAUNCH
}

}  // namespace

// Shared memory a launch takes (bytes), the host's stream_smem_bytes mirrors it.
extern "C" int batched_ffn_smem_bytes(int M, int sb, int ks, int x_dtype) {
  return x_dtype == DT_F32 ? smem_for<float>(M, sb, ks) : smem_for<__nv_bfloat16>(M, sb, ks);
}

// Clusters of ``split`` CTAs (32 rows, fp32 x, ``smem`` bytes) the card
// keeps resident at once: what stream_plan's cluster capacity rests on.
extern "C" int stream_max_clusters(int split, int smem) {
  return stile::max_active_clusters(batched_ffn_kernel<32, float>, split, smem);
}

// x (M, K) f32|bf16 with row stride ldx; w (K, N) f32 with row stride ldw;
// b (N,) f32; y (M, N) contiguous in x's dtype; act an Act code; (sb,
// split, width, ks) the stream plan (kernels/batched_ffn.stream_plan).
// Returns a cudaError_t code (0 = launched).
extern "C" int batched_ffn_launch(const void* x, const float* w, const float* b, void* y, int M,
                                  int K, int N, int ldx, int ldw, int act, int x_dtype, int sb,
                                  int split, int width, int ks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const stile::Plan plan{sb, split, width, ks};
  if (!stile::valid_plan(plan, 4) || width < 4) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0) return 0;
  if (x_dtype == DT_F32) return launch<float>(x, w, b, y, M, K, N, ldx, ldw, act, plan, s);
  if (x_dtype == DT_BF16) return launch<__nv_bfloat16>(x, w, b, y, M, K, N, ldx, ldw, act, plan, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
