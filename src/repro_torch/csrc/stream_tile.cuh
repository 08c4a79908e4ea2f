// The weight stream of the paper's FC-net layers on Hopper, shared by B7
// (batched_ffn.cu: y = act(x @ w + b), fp32 w) and B8 (quant_matmul.cu:
// Q7.8 x Q7.8 -> wrapping int32, int16 w).
//
// Regime: a batch of M <= 32 rows per CTA tile (the paper's Table 2 sweeps
// 1..32) against a dense (K, N) weight read from device memory once per
// launch.  At that batch a weight byte feeds at most 32 MACs, so the
// weight stream bounds both kernels, and the whole launch lasts a few
// microseconds: the stream has to start at once on every SM and keep
// enough bytes in flight to cover the memory latency.
//
// - Work units are (column strip, K slice).  A strip is ``sb`` = 128, 256
//   or 512 bytes of columns; its K sum is split over a thread-block cluster
//   of ``split`` CTAs (rank r takes rows [r ks, (r + 1) ks)).  The host
//   (kernels/batched_ffn.stream_plan) picks sb and split from shapes so
//   that the grid covers the card.
// - Each CTA streams its slice through a ring of kStages stages of 16 KB
//   (kStageBytes: ``stage_rows(sb)`` rows of the strip) fed by cp.async,
//   up to kStages - 1 stages (80+ KB) in flight.  The copy width (16, 8, 4
//   bytes, or 2 for int16 whose stride or offset is odd) is the largest
//   that the weight's address and row stride allow, picked on the host;
//   pieces past N or past the slice are zero-filled (cp.async's src-size),
//   so ragged K and N are masked without padding and nothing past a row
//   is read.  A width-2 weight is copied by plain loads (no cp.async of
//   2 bytes exists): the ring then runs without overlap.  A stage is 1024
//   16-byte chunks, four a thread at the same place in every stage, so a
//   thread works out its chunks' addresses once (Chunks).
// - The CTA's K slice of x (at most 32 rows) is staged once in shared
//   memory as the first copy group, so it is in flight with the first
//   weight stages: a 16-byte aligned row by 16-byte cp.async, any other by
//   4-byte cp.async from its aligned word down (a bf16 or int16 row may
//   start at 2 mod 4: the first word then holds the 2 bytes before it, in
//   the same aligned word, which are never used).
// - The consumer (B7's fp32 FMAs, B8's int8 tensor-core products) is the
//   kernel's.  Every rank ends with partial sums of the CTA tile and
//   pushes them into the owner of each output (ClusterSum below); each
//   rank finishes a slice, adding the ranks' partials in rank order, so a
//   result never depends on scheduling.  (Rank 0 alone reading its peers
//   after a cluster barrier, as wgmma_column.cuh does, serialises the
//   remote loads on one CTA and needs a second cluster barrier before any
//   CTA may exit.)
//
// Ring rows are padded by 16 bytes (kPad): ldmatrix's eight 16-byte rows
// then fall in distinct banks, and 16-byte copies stay aligned.
#pragma once

#include "hopper.cuh"

namespace stile {

constexpr int kThreads = 256;
constexpr int kStages = 6;
constexpr int kStageBytes = 16384;  // strip bytes x rows of one stage
constexpr int kPad = 16;
constexpr int kMaxSplit = 8;
constexpr int kMaxSmem = 232448;    // a CTA's shared memory on sm_90

__host__ __device__ constexpr int stage_rows(int sb) { return kStageBytes / sb; }
__host__ __device__ constexpr int ring_pitch(int sb) { return sb + kPad; }
__host__ __device__ constexpr int stage_bytes(int sb) { return stage_rows(sb) * ring_pitch(sb); }
__host__ __device__ constexpr int ring_bytes(int sb) { return kStages * stage_bytes(sb); }
__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }
// rows of a K slice as staged: whole stages, so a partial last stage
// multiplies zeros
__host__ __device__ constexpr int slice_rows(int ks, int sb) { return round_up(ks, stage_rows(sb)); }
// a raw (native dtype) x row of ``ksr`` elements of ``xe`` bytes, its
// leading shift and a 16-byte pitch
__host__ __device__ constexpr int raw_pitch(int ksr, int xe) { return round_up(ksr * xe + 4, 16); }

// The launch a plan gives: strip bytes, cluster size, copy width, rows
// per rank.
struct Plan {
  int sb, split, width, ks;
};

// cp.async of ``W`` bytes that reads ``valid`` of them (0..W) and zero-fills
// the rest; 16 bytes bypass L1 (.cg), the weights are read once
template <int W>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src, int valid) {
  const uint32_t d = smem_u32(dst);
  if constexpr (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(W),
                 "r"(valid)
                 : "memory");
}

// This thread's share of every stage: a stage is 1024 16-byte chunks
// (stage_rows(sb) rows of sb bytes), four per thread, at the same place in
// every stage -- so their rows, offsets and widths are worked out once.
struct Chunks {
  const unsigned char* src[4];  // the chunk in the slice's first stage
  int dst[4];                   // its byte offset in a ring slot
  int row[4];                   // its row in a stage
  int bytes[4];                 // its bytes inside N (0..16)
};

__device__ __forceinline__ Chunks make_chunks(const unsigned char* w, size_t ldw_b, int n0b, int nb,
                                              int k_lo, int sb) {
  Chunks c;
  const int per_row = sb / 16;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = threadIdx.x + j * kThreads;
    const int r = q / per_row, off = (q % per_row) * 16;
    c.row[j] = r;
    c.dst[j] = r * ring_pitch(sb) + off;
    c.bytes[j] = max(0, min(16, nb - off));
    c.src[j] = w + static_cast<size_t>(k_lo + r) * ldw_b + n0b + off;
  }
  return c;
}

// Stage ``st`` of the slice (rows k0 = k_lo + st * stage_rows(sb), ``soff``
// = st * stage_rows(sb) * ldw_b bytes on from the first) into slot ``dst``,
// each chunk in pieces of ``W`` bytes; rows at or past k_end and bytes past
// N arrive as zeros.
template <int W>
__device__ __forceinline__ void load_stage_w(unsigned char* dst, const Chunks& c, size_t soff,
                                             int k0, int k_end) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int bytes = k0 + c.row[j] < k_end ? c.bytes[j] : 0;
    const unsigned char* src = c.src[j] + soff;
#pragma unroll
    for (int q = 0; q < 16 / W; ++q) {
      const int valid = max(0, min(W, bytes - q * W));
      unsigned char* d = dst + c.dst[j] + q * W;
      if constexpr (W == 2)
        *reinterpret_cast<uint16_t*>(d) =
            valid > 0 ? *reinterpret_cast<const uint16_t*>(src + q * W) : 0;
      else
        cp_async_zfill<W>(d, valid > 0 ? src + q * W : c.src[0], valid);
    }
  }
}

__device__ __forceinline__ void load_stage(unsigned char* dst, const Chunks& c, size_t soff,
                                           int k0, int k_end, int width) {
  switch (width) {
    case 16: load_stage_w<16>(dst, c, soff, k0, k_end); break;
    case 8: load_stage_w<8>(dst, c, soff, k0, k_end); break;
    case 4: load_stage_w<4>(dst, c, soff, k0, k_end); break;
    default: load_stage_w<2>(dst, c, soff, k0, k_end); break;
  }
}

// Rows [m0, m0 + bm) of x (elements of xe bytes, row stride ldx), columns
// [k_lo, k_lo + nk), into ``dst`` (row pitch ``pitch`` bytes, a multiple
// of 16): a row that starts 16-byte aligned by 16-byte cp.async, any other
// by 4-byte cp.async from its aligned word down, so that element k of row
// m lands at dst + m * pitch + shift(m) + (k - k_lo) * xe, shift(m) the
// row's start mod 4.  Bytes past the slice arrive as zeros; rows at or
// past M are not staged (their products are never stored, and B8 reads
// them as zeros).
__device__ __forceinline__ void load_x_raw(unsigned char* dst, const unsigned char* x, int xe,
                                           size_t ldx_b, int m0, int M, int bm, int k_lo, int nk,
                                           int pitch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll 1
  for (int m = warp; m < min(bm, M - m0); m += kThreads / 32) {  // a warp a row
    const uintptr_t row = reinterpret_cast<uintptr_t>(x) +
                          static_cast<size_t>(m0 + m) * ldx_b + static_cast<size_t>(k_lo) * xe;
    const int shift = static_cast<int>(row & 3);
    const int bytes = nk * xe + shift;
    unsigned char* d = dst + m * pitch;
    if ((row & 15) == 0) {
      for (int q = lane; q < pitch / 16; q += 32) {
        const int valid = max(0, min(16, bytes - 16 * q));
        cp_async_zfill<16>(d + 16 * q, valid > 0 ? reinterpret_cast<const void*>(row + 16 * q)
                                                 : static_cast<const void*>(x), valid);
      }
    } else {
      const uintptr_t base = row & ~uintptr_t(3);
      for (int q = lane; q < pitch / 4; q += 32) {
        const int valid = max(0, min(4, bytes - 4 * q));
        cp_async_zfill<4>(d + 4 * q, valid > 0 ? reinterpret_cast<const void*>(base + 4 * q)
                                               : static_cast<const void*>(x), valid);
      }
    }
  }
}

__device__ __forceinline__ int x_shift(const unsigned char* x, int xe, size_t ldx_b, int gm,
                                       int k_lo) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(x) + static_cast<size_t>(gm) * ldx_b +
                           static_cast<size_t>(k_lo) * xe) & 3);
}

// The ring's schedule for one CTA.  ``prologue()`` stages x (one copy
// group, the oldest); ``issued()`` runs once the first stages are in flight
// (set-up that need not delay them: the cluster's barrier); ``ready()``
// runs once x has landed (a conversion in shared memory); ``consume(slot,
// s)`` multiplies stage s.  Stage s of the slice (rows k_lo + s * rows ..)
// goes to slot s % kStages.
template <typename Prologue, typename Issued, typename Ready, typename Consume>
__device__ __forceinline__ void run_ring(unsigned char* ring, const unsigned char* w, size_t ldw_b,
                                         int n0b, int nb, int k_lo, int k_hi, int sb, int width,
                                         Prologue prologue, Issued issued, Ready ready,
                                         Consume consume) {
  const int rows = stage_rows(sb);
  const int n_st = k_hi > k_lo ? (k_hi - k_lo + rows - 1) / rows : 0;
  const size_t stride = static_cast<size_t>(rows) * ldw_b;
  const Chunks c = make_chunks(w, ldw_b, n0b, nb, k_lo, sb);
  prologue();
  cp_async_commit();
#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_st) load_stage(ring + s * stage_bytes(sb), c, s * stride, k_lo + s * rows, k_hi, width);
    cp_async_commit();
  }
  issued();
  cp_async_wait<kStages - 1>();  // x has landed
  __syncthreads();
  ready();
#pragma unroll 1
  for (int s = 0; s < n_st; ++s) {
    cp_async_wait<kStages - 2>();  // stage s has landed
    __syncthreads();               // ... for every thread; slot (s - 1) % kStages is free
    const int nx = s + kStages - 1;
    if (nx < n_st)
      load_stage(ring + (nx % kStages) * stage_bytes(sb), c, nx * stride, k_lo + nx * rows, k_hi,
                 width);
    cp_async_commit();
    consume(ring + (s % kStages) * stage_bytes(sb), s);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring and x are free: the caller's partial sums may reuse them
}

// -- the cluster's sum ----------------------------------------------------------
//
// With split > 1 each rank finishes a slice of the CTA tile's ``outs``
// outputs (rank q: [q per, (q + 1) per)).  Every rank pushes its partial
// sum of each output into the owner's receive buffer, row ``rank`` of
// recv[split][per]: to a peer by st.async, which completes on the owner's
// mbarrier by transaction bytes, to itself by a plain store (a CTA barrier
// orders those); the owner waits on its own barrier and adds the rows in
// rank order, so a result never depends on scheduling.  No rank reads
// another's shared memory, so no barrier guards a CTA's exit; one cluster
// barrier (arrived at the start, waited for before the first push) orders
// the barriers' initialisation before any push.

struct ClusterSum {
  uint64_t* bar;  // this rank's receive barrier
  float* recv;    // recv[split][per] (fp32 or uint32 bits)
  int per, lo, hi, rank, split;
};

__device__ __forceinline__ ClusterSum cluster_sum_begin(unsigned char* at, int outs, int split,
                                                        int rank) {
  ClusterSum c;
  c.bar = reinterpret_cast<uint64_t*>(at);
  c.recv = reinterpret_cast<float*>(at + 16);
  c.per = (outs + split - 1) / split;
  c.lo = min(outs, rank * c.per);
  c.hi = min(outs, c.lo + c.per);
  c.rank = rank;
  c.split = split;
  if (threadIdx.x == 0) {
    mbar_init(c.bar, 1);
    fence_mbar_init();  // the initialised barrier, to the cluster
    mbar_arrive_expect_tx(c.bar, static_cast<uint32_t>(4 * (split - 1) * (c.hi - c.lo)));
  }
  // relaxed: only the barrier's initialisation has to reach the peers, and
  // its fence did that (a release arrive would fence every thread)
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
  return c;
}

// before the first push: every rank's barrier is initialised
__device__ __forceinline__ void cluster_sum_ready() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// this rank's partial of output o, 4 bytes, to its owner
__device__ __forceinline__ void cluster_sum_push(const ClusterSum& c, int o, uint32_t bits) {
  const int q = o / c.per;
  float* slot = c.recv + c.rank * c.per + (o - q * c.per);
  if (q == c.rank) {
    *reinterpret_cast<uint32_t*>(slot) = bits;
    return;
  }
  const uint32_t dst = peer_addr(slot, q);
  const uint32_t bar = peer_addr(c.bar, q);
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(dst),
               "r"(bits), "r"(bar)
               : "memory");
}

// every rank's partials of this rank's slice have landed (a CTA barrier for
// its own, an acquire at cluster scope for the peers': their pushes
// release at cluster scope); traps, as mbar_wait does, rather than hang
// the card on a fault
__device__ __forceinline__ void cluster_sum_wait(const ClusterSum& c) {
  __syncthreads();
  const uint32_t addr = smem_u32(c.bar);
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) asm volatile("trap;\n");
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr)
        : "memory");
  }
}

// the receive area's bytes (barrier + recv) for ``outs`` outputs
__host__ __device__ constexpr int cluster_sum_bytes(int outs) {
  return 16 + round_up(4 * (outs + kMaxSplit), 16);
}

// Launch ``kern`` on grid (n_strips * split, tiles_y) with a cluster of
// ``split`` CTAs along x when split > 1, kThreads threads and ``smem``
// bytes of dynamic shared memory.  ``configured`` is the kernel's own flag
// (kernels of one signature share a Kern type, so the flag cannot live
// here): its shared-memory limit is raised on its first launch.
template <typename Kern, typename... Args>
static int launch(Kern kern, bool& configured, int n_strips, int split, int tiles_y, int smem,
                  cudaStream_t stream, Args... args) {
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_strips * split, tiles_y, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of ``split`` CTAs of ``kern`` with ``smem`` bytes can
// be resident at once (cudaOccupancyMaxActiveClusters), or -1 on error.
template <typename Kern>
static int max_active_clusters(Kern kern, int split, int smem) {
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem) !=
      cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split * 64, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kern, &cfg) != cudaSuccess) return -1;
  return n;
}

// A plan the kernels take: strips of 128/256/512 bytes, 1..8 CTAs a
// cluster, a width of 16/8/4/2 bytes, and a slice of whole k quanta.
inline bool valid_plan(const Plan& p, int quantum) {
  return (p.sb == 128 || p.sb == 256 || p.sb == 512) && p.split >= 1 && p.split <= kMaxSplit &&
         (p.width == 16 || p.width == 8 || p.width == 4 || p.width == 2) && p.ks > 0 &&
         p.ks % quantum == 0;
}

}  // namespace stile
