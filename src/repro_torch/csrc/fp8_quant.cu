// Block absmax + saturating E4M3 cast for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fp8_quant/kernel.py:
// quantize_fp8_pallas (body _quant_kernel).  Per bs x bs block:
//
//   scale = max(max|w|, 1e-12) * (alpha * (1/qmax))   (= alpha * s0)
//   q     = e4m3(clip(w / scale, +-qmax))
//
// A NaN in a block gives it a NaN scale and NaN codes, and an inf an inf
// scale (w / inf is +-0, inf / inf NaN), as in the reference: the absmax,
// the 1e-12 floor and the clip keep NaN (common.cuh: fmax_nan, fmin_nan).
//
// Bound on the H100: bytes — 4 read and 1 written per element against ~15
// instructions (0.084 ms at [4096,13696] for 3.35 TB/s).
//
// quant_tile_kernel (bs = 128, w 16-byte aligned; kernel.py::quant_instance
// chooses): one thread block of 256 threads per 128 x 128 tile, the tile
// held in registers.  Warp k owns rows 16k .. 16k+15 and lane l columns
// 4l .. 4l+3 of each, so a thread issues its 16 independent 16-byte
// streaming loads (__ldcs) before it uses any and HBM sees each element
// once; addresses come from (tile, warp, lane, row) with no division per
// element.  The absmax: over the thread's 64 values, the warp (shuffles),
// then 8 warp partials in shared memory behind one barrier, which every
// thread reduces itself.  The cast from registers: the exact division (IEEE
// __fdiv_rn, not a reciprocal multiply: the codes are then bit-equal to the
// plain version's), the clip, then two codes per cvt.rn.satfinite.e4m3x2
// and four packed into one 32-bit streaming store, so a warp writes a whole
// 128-byte row segment per store.  84 registers a thread (ptxas): 2 tiles
// an SM, ~17 MB of loads in flight on the card, far more than HBM's latency
// needs; 3 tiles an SM and 512-thread blocks ran no faster.
//
// quant_general_kernel (any other block, or an unaligned w): one thread
// block per block, scalar loads, the absmax pass, then the cast re-reading
// w (from L1 / L2 where it is still there).
//
// Rounding follows the plain version (granularity.quantize_store at
// scale_from_absmax) exactly: 1/qmax is the float32 reciprocal the caller
// passes and alpha multiplies it before amax does (the reference's XLA
// compile evaluates alpha * amax / qmax in that order), the element division
// is IEEE and the cast rounds to nearest even, so codes and scales are
// bit-equal to it.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;               // quant_tile_kernel's block edge
constexpr int kRows = kTile / kWarps;    // rows of a tile per warp

__device__ __forceinline__ float clip(float x, float qmax) {
  return fmin_nan(fmax_nan(x, -qmax), qmax);
}

// scale = max(m, 1e-12) * (alpha * (1/qmax)), NaN kept
__device__ __forceinline__ float block_scale(float m, float alpha, float qmax_recip) {
  return __fmul_rn(fmax_nan(m, 1e-12f), __fmul_rn(alpha, qmax_recip));
}

__device__ __forceinline__ float abs_max4(float m, float4 v) {
  return fmax_nan(fmax_nan(m, fmax_nan(fabsf(v.x), fabsf(v.y))),
                  fmax_nan(fabsf(v.z), fabsf(v.w)));
}

// four codes, column order in memory (the conversion puts .x in the low byte)
__device__ __forceinline__ unsigned int pack4(float4 v, float scale, float qmax) {
  const __nv_fp8x2_storage_t lo = __nv_cvt_float2_to_fp8x2(
      make_float2(clip(__fdiv_rn(v.x, scale), qmax), clip(__fdiv_rn(v.y, scale), qmax)),
      __NV_SATFINITE, __NV_E4M3);
  const __nv_fp8x2_storage_t hi = __nv_cvt_float2_to_fp8x2(
      make_float2(clip(__fdiv_rn(v.z, scale), qmax), clip(__fdiv_rn(v.w, scale), qmax)),
      __NV_SATFINITE, __NV_E4M3);
  return static_cast<unsigned int>(lo) | (static_cast<unsigned int>(hi) << 16);
}

__global__ void __launch_bounds__(kThreads, 2)
quant_tile_kernel(const float* __restrict__ w, const float* __restrict__ alpha,
                  uint8_t* __restrict__ q, float* __restrict__ scales, int O, int nbo,
                  float qmax, float qmax_recip) {
  const int tile = blockIdx.x;
  const int ti = tile / nbo, tj = tile - ti * nbo;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long off = (static_cast<long long>(ti) * kTile + warp * kRows) * O +
                        static_cast<long long>(tj) * kTile + lane * 4;

  float4 v[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    v[r] = __ldcs(reinterpret_cast<const float4*>(w + off + static_cast<long long>(r) * O));

  float m = 0.f;
#pragma unroll
  for (int r = 0; r < kRows; ++r) m = abs_max4(m, v[r]);
  m = warp_max(m);
  __shared__ float part[kWarps];
  if (lane == 0) part[warp] = m;
  __syncthreads();
  m = part[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) m = fmax_nan(m, part[i]);
  const float scale = block_scale(m, alpha[0], qmax_recip);
  if (threadIdx.x == 0) scales[tile] = scale;

#pragma unroll
  for (int r = 0; r < kRows; ++r)
    __stcs(reinterpret_cast<unsigned int*>(q + off + static_cast<long long>(r) * O),
           pack4(v[r], scale, qmax));
}

__global__ void __launch_bounds__(kThreads)
quant_general_kernel(const float* __restrict__ w, const float* __restrict__ alpha,
                     uint8_t* __restrict__ q, float* __restrict__ scales, int O, int bs,
                     int nbo, float qmax, float qmax_recip) {
  const long long tile = blockIdx.x;
  const int ti = static_cast<int>(tile / nbo);
  const int tj = static_cast<int>(tile % nbo);
  const long long base = static_cast<long long>(ti) * bs * O + static_cast<long long>(tj) * bs;
  const int n = bs * bs;

  float amax = 0.f;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int r = e / bs;
    amax = fmax_nan(amax, fabsf(w[base + static_cast<long long>(r) * O + (e - r * bs)]));
  }
  __shared__ float part[kWarps];
  __shared__ float s_scale;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  amax = warp_max(amax);
  if (lane == 0) part[warp] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = part[0];
    for (int i = 1; i < kWarps; ++i) m = fmax_nan(m, part[i]);
    s_scale = block_scale(m, alpha[0], qmax_recip);
    scales[tile] = s_scale;
  }
  __syncthreads();
  const float scale = s_scale;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int r = e / bs;
    const long long idx = base + static_cast<long long>(r) * O + (e - r * bs);
    q[idx] = to_e4m3(clip(__fdiv_rn(w[idx], scale), qmax));
  }
}

}  // namespace

// w: fp32 [I, O] (multiples of bs); alpha: fp32 [1] on the device;
// q: e4m3 codes [I, O]; scales: fp32 [I/bs, O/bs].  instance: 1 for
// quant_tile_kernel (bs = 128, w 16-byte aligned), 0 for the general one.
extern "C" int quantize_fp8(const float* w, const float* alpha, uint8_t* q, float* scales,
                            int I, int O, int bs, int instance, float qmax, float qmax_recip,
                            void* stream) {
  if (bs < 1 || instance < 0 || instance > 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(I / bs) * (O / bs);
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto st = static_cast<cudaStream_t>(stream);
  if (instance == 1) {
    if (bs != kTile || O % kTile || reinterpret_cast<uintptr_t>(w) % 16 ||
        reinterpret_cast<uintptr_t>(q) % 4)
      return static_cast<int>(cudaErrorInvalidValue);
    quant_tile_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        w, alpha, q, scales, O, O / bs, qmax, qmax_recip);
  } else {
    quant_general_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        w, alpha, q, scales, O, bs, O / bs, qmax, qmax_recip);
  }
  return static_cast<int>(cudaGetLastError());
}
