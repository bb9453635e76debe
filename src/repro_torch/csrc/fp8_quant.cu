// One-pass block absmax + saturating E4M3 cast for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fp8_quant/kernel.py:
// quantize_fp8_pallas (body _quant_kernel).  Per bs x bs block:
//
//   scale = max(max|w|, 1e-12) * (alpha * (1/qmax))   (= alpha * s0)
//   q     = e4m3(clip(w / scale, +-qmax))
//
// Bound on the H100: bytes — 4 read + 1 written per element against ~5
// operations.  Design: one thread block per weight block.  The block reads
// its tile once for the absmax (warp shuffles, then shared memory), and a
// second time for the cast; the second read of the 64 KB tile hits L1/L2,
// so HBM sees one read of w and one write of q, as in the TPU kernel.
//
// Rounding follows the plain version (granularity.quantize_store at
// scale_from_absmax) exactly: 1/qmax is the float32 reciprocal the caller
// passes and alpha multiplies it before amax does (the reference's XLA
// compile evaluates alpha * amax / qmax in that order), the element division
// is IEEE (__fdiv_rn) and the cast rounds to nearest even, so codes and
// scales are bit-equal to it.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
quant_kernel(const float* __restrict__ w, const float* __restrict__ alpha,
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
    amax = fmaxf(amax, fabsf(w[base + static_cast<long long>(r) * O + (e - r * bs)]));
  }
  __shared__ float part[kWarps];
  __shared__ float s_scale;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  amax = warp_max(amax);
  if (lane == 0) part[warp] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = part[0];
    for (int i = 1; i < kWarps; ++i) m = fmaxf(m, part[i]);
    s_scale = __fmul_rn(fmaxf(m, 1e-12f), __fmul_rn(alpha[0], qmax_recip));
    scales[tile] = s_scale;
  }
  __syncthreads();
  const float scale = s_scale;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int r = e / bs;
    const long long idx = base + static_cast<long long>(r) * O + (e - r * bs);
    q[idx] = to_e4m3(fminf(fmaxf(__fdiv_rn(w[idx], scale), -qmax), qmax));
  }
}

}  // namespace

// w: fp32 [I, O] (multiples of bs); alpha: fp32 [1] on the device;
// q: e4m3 codes [I, O]; scales: fp32 [I/bs, O/bs].
extern "C" int quantize_fp8(const float* w, const float* alpha, uint8_t* q, float* scales,
                            int I, int O, int bs, float qmax, float qmax_recip,
                            void* stream) {
  const long long blocks = static_cast<long long>(I / bs) * (O / bs);
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  quant_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(w, alpha, q, scales, O, bs, O / bs,
                                                      qmax, qmax_recip);
  return static_cast<int>(cudaGetLastError());
}
