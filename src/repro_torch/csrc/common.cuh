// Shared helpers for the port's hand-written Hopper kernels (sm_90a).
//
// Each kernel source is built on its own into a shared library with a plain
// C interface (nvcc ... -shared -Xcompiler -fPIC) and loaded with ctypes by
// repro_torch/kernels/build.py.  Every C entry point launches on the stream
// it is given, allocates nothing, and returns cudaGetLastError() so that a
// refused launch (too many threads, too much shared memory) surfaces in the
// Python wrapper instead of being lost.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes shared with the Python wrappers (kernels/build.py DTYPE_CODES)
enum DType : int { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(int8_t v) { return static_cast<float>(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// 16-byte global -> shared copy that bypasses L1 (cp.async.cg), Ampere+.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem_src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Gate activations (weight_plan.GATE_ACTS); gelu is the tanh approximation,
// which is what jax.nn.gelu computes by default.
enum Act : int { ACT_LINEAR = 0, ACT_RELU = 1, ACT_SIGMOID = 2, ACT_GELU = 3, ACT_SILU = 4, ACT_TANH = 5 };

__device__ __forceinline__ float apply_act(int act, float x) {
  switch (act) {
    case ACT_RELU: return fmaxf(x, 0.0f);
    case ACT_SIGMOID: return 1.0f / (1.0f + expf(-x));
    case ACT_GELU: {
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
    }
    case ACT_SILU: return x / (1.0f + expf(-x));
    case ACT_TANH: return tanhf(x);
    default: return x;
  }
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
