// Fused block-dequant fp8 matmul for Hopper (sm_90a): the general route.
//
// Replaces the TPU kernel src/repro/kernels/fp8_matmul/kernel.py:
// matmul_fp8_pallas (body _matmul_kernel):
//
//   y[M, N] = x[M, K] @ (w_q[K, N] * scale[K/bs, N/bs] per bs x bs block)
//
// with x bf16, fp16 or fp32 (widened to fp32 as the reference does), w_q
// E4M3 codes, fp32 scales, any quant block bs that divides K and N, and an
// fp32 result (the caller casts).  The tensor-core routes take bf16, fp16
// and fp32 x at every block that is a multiple of 16 (fp8_matmul_decode.cu
// below 16 kernel rows, fp8_matmul_wgmma.cu from there on); kernel.py's
// route sends this kernel only the blocks that are not (8, 40, 66 ...).
// Bound on the H100: at few rows of x the weight bytes dominate — one byte
// per weight — so the kernel streams w_q once: each thread block owns 128
// output columns and 8 rows of x, each lane reads 4 adjacent E4M3 codes
// (one 32-bit load, a warp covers 128 contiguous bytes of a weight row),
// and the 8 warps split the rows of every bs-row slab.  x goes through
// shared memory as fp32 in chunks of at most 256 rows of a slab.  Partial
// sums per slab are scaled once by that slab's block scale (the TPU
// kernel's "one scale per weight tile"), then the warps reduce through
// shared memory.  With few column tiles the K slabs are split across
// blockIdx.z to fill the 132 SMs, and a second small kernel adds the
// per-split partials in a fixed order, so results are deterministic.
//
// fp32 FMAs on the CUDA cores, no tensor cores, no TMA: simple and right
// for every operand, and 2.6x cuBLAS bf16 at M = 8 [4096,13696] on the
// H100; every product whose block is a multiple of 16 takes the
// tensor-core kernels instead.
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;        // rows of x per thread block
constexpr int kCols = 128;      // output columns per thread block (4 per lane)
constexpr int kChunk = 256;     // rows of a slab whose x the shared buffer holds

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w,
              const float* __restrict__ scales, float* __restrict__ out, int M, int K,
              int N, int bs, int kb_per_split) {
  __shared__ float xs[kRows][kChunk];
  __shared__ float red[kWarps][kRows][kCols];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * kCols;
  const int m0 = blockIdx.y * kRows;
  const int nkb = K / bs, nsb = N / bs;
  const int kb0 = blockIdx.z * kb_per_split;
  const int kb1 = min(nkb, kb0 + kb_per_split);
  const int col = n0 + lane * 4;
  const bool col_ok = col < N;

  float acc[kRows][4];
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  for (int kb = kb0; kb < kb1; ++kb) {
    float part[kRows][4];
#pragma unroll
    for (int m = 0; m < kRows; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[m][j] = 0.f;
    for (int c0 = 0; c0 < bs; c0 += kChunk) {  // one chunk unless bs > 256
      const int len = min(kChunk, bs - c0);
      const size_t k0 = static_cast<size_t>(kb) * bs + c0;
      __syncthreads();
      for (int e = threadIdx.x; e < kRows * len; e += kThreads) {
        const int m = e / len, r = e - m * len;
        xs[m][r] = (m0 + m < M) ? to_float(x[static_cast<size_t>(m0 + m) * K + k0 + r]) : 0.f;
      }
      __syncthreads();
      if (!col_ok) continue;
      const uint8_t* wrow = w + k0 * N + col;
#pragma unroll 4
      for (int r = warp; r < len; r += kWarps) {
        const uint32_t pk =
            *reinterpret_cast<const uint32_t*>(wrow + static_cast<size_t>(r) * N);
        float wf[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) wf[j] = from_e4m3(static_cast<uint8_t>(pk >> (8 * j)));
#pragma unroll
        for (int m = 0; m < kRows; ++m) {
          const float xv = xs[m][r];
#pragma unroll
          for (int j = 0; j < 4; ++j) part[m][j] = fmaf(xv, wf[j], part[m][j]);
        }
      }
    }
    if (!col_ok) continue;
    float sc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[j] = scales[static_cast<size_t>(kb) * nsb + (col + j) / bs];
#pragma unroll
    for (int m = 0; m < kRows; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(part[m][j], sc[j], acc[m][j]);
  }

#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp][m][lane * 4 + j] = acc[m][j];
  __syncthreads();
  float* o = out + static_cast<size_t>(blockIdx.z) * M * N;
  for (int e = threadIdx.x; e < kRows * kCols; e += kThreads) {
    const int m = e / kCols, c = e - m * kCols;
    if (m0 + m < M && n0 + c < N) {
      float s = 0.f;
      for (int wi = 0; wi < kWarps; ++wi) s += red[wi][m][c];
      o[static_cast<size_t>(m0 + m) * N + n0 + c] = s;
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const float* scales, float* out, int M,
                   int K, int N, int bs, int kb_per_split, dim3 grid, cudaStream_t st) {
  matmul_kernel<T><<<grid, kThreads, 0, st>>>(static_cast<const T*>(x),
                                              static_cast<const uint8_t*>(w), scales, out, M,
                                              K, N, bs, kb_per_split);
  return cudaGetLastError();
}

}  // namespace

// x: [M, K] of x_dtype (0 bf16, 1 fp16, 2 fp32); w: E4M3 codes [K, N]
// (4-byte aligned, N % 4 == 0); scales: fp32 [K/bs, N/bs]; y: fp32 [M, N].
// K and N are multiples of bs.  With splits > 1, scratch holds fp32
// [splits, M, N] and each split covers kb_per_split slabs of bs rows.
extern "C" int matmul_fp8(const void* x, const void* w, const float* scales, float* y,
                          float* scratch, int M, int K, int N, int bs, int splits,
                          int kb_per_split, int x_dtype, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (bs <= 0 || (M + kRows - 1) / kRows > 65535 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kCols - 1) / kCols, (M + kRows - 1) / kRows, splits);
  float* out = splits > 1 ? scratch : y;
  cudaError_t err;
  switch (x_dtype) {
    case 0: err = launch<__nv_bfloat16>(x, w, scales, out, M, K, N, bs, kb_per_split, grid, st); break;
    case 1: err = launch<__half>(x, w, scales, out, M, K, N, bs, kb_per_split, grid, st); break;
    case 2: err = launch<float>(x, w, scales, out, M, K, N, bs, kb_per_split, grid, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(sum_splits(scratch, y, static_cast<long long>(M) * N, splits, st));
}
