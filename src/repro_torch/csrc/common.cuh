// Shared device helpers for the port's hand-written Hopper kernels.
//
// Each kernel source is compiled on its own by nvcc into a shared library
// with a plain C interface (loaded from Python with ctypes), so every
// exported function returns the cudaError_t of its launch as an int and
// `error_string` turns that code into text.
#pragma once

#include <cstdint>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

// Saturating, round-to-nearest-even float -> E4M3 code (cvt.rn.satfinite):
// the code `x.to(torch.float8_e4m3fn)` gives for a value already clipped to
// +-448, which is where the plain versions put every element.
__device__ __forceinline__ uint8_t to_e4m3(float x) {
  return static_cast<uint8_t>(__nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3));
}

// Exact E4M3 code -> float (every E4M3 value is a half).
__device__ __forceinline__ float from_e4m3(uint8_t q) {
  __half_raw h = __nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(q), __NV_E4M3);
  return __half2float(__half(h));
}

__device__ __forceinline__ int sign_of(float x) { return (x > 0.f) - (x < 0.f); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// y[i] = sum over z of part[z * mn + i], z = 0, 1, ... in order: the
// deterministic second pass of a product split over K (partials [splits, mn]).
__global__ void sum_splits_kernel(const float* __restrict__ part, float* __restrict__ y,
                                  long long mn, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[z * mn + i];
  y[i] = s;
}

inline cudaError_t sum_splits(const float* part, float* y, long long mn, int splits,
                              cudaStream_t st) {
  sum_splits_kernel<<<static_cast<unsigned>((mn + 255) / 256), 256, 0, st>>>(part, y, mn,
                                                                          splits);
  return cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
