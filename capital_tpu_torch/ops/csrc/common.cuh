// Shared helpers of the port's hand-written Hopper kernels: dtype codes,
// accumulation types and the exact conversions between bf16, f32 and f64.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes passed from Python (ops/hopper.py:_DTYPE_CODE)
enum DType : int { DT_BF16 = 0, DT_F32 = 1, DT_F64 = 2 };

// uplo codes: 0 none, 1 upper ('U'), 2 lower ('L')
enum Uplo : int { UPLO_NONE = 0, UPLO_U = 1, UPLO_L = 2 };

typedef __nv_bfloat16 bf16;

// f32 accumulation for bf16 and f32 operands, f64 for f64
template <typename T> struct AccOf { typedef float type; };
template <> struct AccOf<double> { typedef double type; };

// exact widening to the accumulation type
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }

// round-to-nearest-even casts between the three types
template <typename To> struct Cast;
template <> struct Cast<bf16> {
  __device__ __forceinline__ static bf16 from(bf16 x) { return x; }
  __device__ __forceinline__ static bf16 from(float x) { return __float2bfloat16_rn(x); }
  // through f32, as PyTorch's own f64 -> bf16 conversion rounds
  __device__ __forceinline__ static bf16 from(double x) { return __float2bfloat16_rn((float)x); }
};
template <> struct Cast<float> {
  __device__ __forceinline__ static float from(bf16 x) { return __bfloat162float(x); }
  __device__ __forceinline__ static float from(float x) { return x; }
  __device__ __forceinline__ static float from(double x) { return (float)x; }
};
template <> struct Cast<double> {
  __device__ __forceinline__ static double from(bf16 x) { return (double)__bfloat162float(x); }
  __device__ __forceinline__ static double from(float x) { return (double)x; }
  __device__ __forceinline__ static double from(double x) { return x; }
};

template <typename T> __device__ __forceinline__ T zero_of() { return Cast<T>::from(0.0f); }

// is element (r, c) of a window inside the kept triangle?
__device__ __forceinline__ bool in_tri(int uplo, long long r, long long c) {
  return uplo == UPLO_NONE || (uplo == UPLO_U ? r <= c : r >= c);
}

// 16-byte shared-memory vectors
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// 16 bytes from global to shared memory without passing through registers
// (cp.async, cached in L2 only); the host pass never runs the fallback
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
#else
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// every copy this thread committed has landed (a barrier then publishes them)
__device__ __forceinline__ void cp_async_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 0;\n" ::);
#endif
}
