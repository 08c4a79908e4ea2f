// Tensor-core and copy helpers of the port's one mma.sync kernel: B6 over
// int8 K/V (flash_attention.cu).
//
// mma.sync.m16n8k16 bf16 with fp32 accumulation (an Ampere-era instruction
// that Hopper runs), the bf16 packing its fragments take, and a cp.async
// that zero-fills a ragged tail instead of reading past it.
#pragma once

#include "common.cuh"

// 16-byte cp.async that writes zeros (reads nothing) when !valid.
__device__ __forceinline__ void cp_async16_zfill(void* smem_dst, const void* gmem_src,
                                                 bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem_src),
               "r"(n));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 of one column and consecutive rows (row stride ld) as a pair
__device__ __forceinline__ uint32_t ld_col_pair(const __nv_bfloat16* p, int ld) {
  const uint16_t* u = reinterpret_cast<const uint16_t*>(p);
  return static_cast<uint32_t>(u[0]) | (static_cast<uint32_t>(u[ld]) << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) rounded to a bf16 pair hi, and the pair of what rounding dropped,
// lo = (a, b) - hi, so that hi + lo keeps ~16 significant bits
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));
}

// C += A (16x16, row) * B (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
