// Fused block-dequant fp8 matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fp8_matmul/kernel.py:
// matmul_fp8_pallas (body _matmul_kernel):
//
//   y[M, N] = x[M, K] @ (w_q[K, N] * scale[K/bs, N/bs] per bs x bs block)
//
// with x bf16, w_q E4M3 codes, fp32 scales and an fp32 result (the caller
// casts).  Bound on the H100: at decode (M = slots = 8) the weight bytes
// dominate by far — one byte per weight, the whole reason to store fp8 —
// so the kernel is built to stream w_q once: each thread block owns 128
// output columns and 8 rows of x, each lane reads 4 adjacent E4M3 codes
// (one 32-bit load, a warp covers 128 contiguous bytes of a weight row),
// and the 8 warps split the rows of every bs-row slab.  Partial sums per
// slab are scaled once by that slab's block scale (the TPU kernel's
// "one scale per weight tile"), then the warps reduce through shared
// memory.  With few column tiles (decode) the K slabs are split across
// blockIdx.z to fill the 132 SMs, and a second small kernel adds the
// per-split partials in a fixed order, so results are deterministic.
//
// This is the simple, right first version: fp32 FMAs on the CUDA cores, no
// tensor cores, no TMA.  At prefill (M >= 128) it is bound by those FMAs,
// far above the tensor-core bound; wgmma is a later change.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;        // rows of x per thread block
constexpr int kCols = 128;      // output columns per thread block (4 per lane)
constexpr int kMaxBlock = 256;  // largest quant block edge the x slab holds

__global__ void __launch_bounds__(kThreads)
matmul_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
              const float* __restrict__ scales, float* __restrict__ out, int M, int K,
              int N, int bs, int kb_per_split) {
  __shared__ float xs[kRows][kMaxBlock];
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
    __syncthreads();
    for (int e = threadIdx.x; e < kRows * bs; e += kThreads) {
      const int m = e / bs, r = e - m * bs;
      xs[m][r] = (m0 + m < M)
                     ? __bfloat162float(x[static_cast<size_t>(m0 + m) * K +
                                          static_cast<size_t>(kb) * bs + r])
                     : 0.f;
    }
    __syncthreads();
    if (!col_ok) continue;
    float part[kRows][4];
#pragma unroll
    for (int m = 0; m < kRows; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[m][j] = 0.f;
    const uint8_t* wrow = w + static_cast<size_t>(kb) * bs * N + col;
#pragma unroll 4
    for (int r = warp; r < bs; r += kWarps) {
      const uint32_t pk = *reinterpret_cast<const uint32_t*>(wrow + static_cast<size_t>(r) * N);
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

__global__ void sum_splits_kernel(const float* __restrict__ part, float* __restrict__ y,
                                  long long mn, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[z * mn + i];
  y[i] = s;
}

}  // namespace

// x: bf16 [M, K]; w: E4M3 codes [K, N] (4-byte aligned, N % 4 == 0);
// scales: fp32 [K/bs, N/bs]; y: fp32 [M, N].  K and N are multiples of bs,
// bs <= 256.  With splits > 1, scratch holds fp32 [splits, M, N] and each
// split covers kb_per_split slabs of bs rows.
extern "C" int matmul_fp8(const void* x, const void* w, const float* scales, float* y,
                          float* scratch, int M, int K, int N, int bs, int splits,
                          int kb_per_split, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (bs > kMaxBlock || (M + kRows - 1) / kRows > 65535 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kCols - 1) / kCols, (M + kRows - 1) / kRows, splits);
  matmul_kernel<<<grid, kThreads, 0, st>>>(static_cast<const __nv_bfloat16*>(x),
                                           static_cast<const uint8_t*>(w), scales,
                                           splits > 1 ? scratch : y, M, K, N, bs,
                                           kb_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long mn = static_cast<long long>(M) * N;
  sum_splits_kernel<<<static_cast<unsigned>((mn + 255) / 256), 256, 0, st>>>(scratch, y, mn,
                                                                          splits);
  return static_cast<int>(cudaGetLastError());
}
