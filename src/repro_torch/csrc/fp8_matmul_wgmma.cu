// Block-dequant fp8 matmul on Hopper's tensor cores (sm_90a): the prefill
// route of the port's fp8 matmul.
//
// Replaces, for M >= TC_MIN_ROWS rows of x, the TPU kernel
// src/repro/kernels/fp8_matmul/kernel.py: matmul_fp8_pallas (body
// _matmul_kernel):
//
//   y[M, N] = x[M, K] @ (w_q[K, N] * scale[K/128, N/128] per 128 x 128 block)
//
// with x bf16, w_q E4M3 codes, fp32 scales and an fp32 result (the caller
// casts).  Bound on the H100: at prefill (M = 8 x 128 = 1024) the
// operations, 2MKN, far above the bytes, so the products must run on the
// tensor cores.  Every E4M3 value is exactly a bf16 and x already is one,
// so the fp8 weights are converted to bf16 on chip and multiplied with bf16
// wgmma (m64n128k16, fp32 accumulate); fp8 wgmma would need x cast to fp8,
// another result.  A thread block owns 128 output columns = one quant
// block, so one scale per 128-row K slab: the slab's product goes to its
// own accumulator and is added as acc += part * scale[kb, nb] in fp32, the
// arithmetic of _matmul_kernel up to summation order.
//
// The block computes its tile transposed, y^T = W^T x^T: wgmma's A operand
// is the weight tile, converted from fp8 straight into registers in wgmma's
// fragment layout, and its B operand the x tile [128 rows][64 k] bf16,
// K-major and 128-byte swizzled in shared memory as TMA writes it.  So the
// converted weights never go back through shared memory (no proxy fence, no
// barrier between the warpgroups), and no transpose bit is needed.
//
// Pipeline: a ring of kStages (x tile, fp8 w tile) pairs in shared memory
// with full / empty mbarriers.  One lane of the producer warpgroup issues
// the TMA loads; two consumer warpgroups each own 64 of the block's 128
// weight columns for all 128 rows of x.  A consumer converts the next
// tile's fragments while the current tile's wgmma runs (wait_group 1) and
// folds a slab's partial sum in once its second tile's wgmma is done.
#include "hopper.cuh"

namespace {

constexpr int kBlock = 128;          // quant block edge: one scale per slab
constexpr int kBN = 128;             // weight (output) columns per thread block
constexpr int kBM = 128;             // rows of x per thread block
constexpr int kBK = 64;              // K depth of one tile: 128 bytes of bf16
constexpr int kStages = 6;           // ring depth
constexpr int kConsumers = 256;      // warpgroups 0 and 1; warpgroup 2 is the producer
constexpr int kThreads = kConsumers + 128;
constexpr int kXBytes = kBM * kBK * 2;  // 16 KB x tile (TMA, swizzled)
constexpr int kWBytes = kBK * kBN;      // 8 KB fp8 w tile (TMA, swizzled)
constexpr int kStageBytes = kXBytes + kWBytes;
constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + alignment slack

// Pin the accumulator registers in program order around wgmma (the asm that
// waits does not name them).
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] (+)= A[64 x 16] . B[16 x 128], A from registers (bf16 pairs in
// wgmma's fragment), B K-major bf16 in shared memory; scale_d = 0
// overwrites d.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// Byte offset of (k, n) in the fp8 w tile [64 k][128 n] as TMA writes it
// with the 128-byte swizzle (16-byte chunk c of row k at c ^ (k % 8)).
__device__ __forceinline__ int w_offset(int k, int n) {
  return k * kBN + ((((n >> 4) ^ (k & 7)) << 4) | (n & 15));
}

// wgmma's A fragment for the 16-deep step kk of the transposed w tile: this
// thread's rows are weight columns n, n + 1 (row g and g + 8 of its warp's
// 16), its k columns 2t, 2t + 1, 2t + 8, 2t + 9.  Four 2-byte loads (conflict
// free on the swizzled tile), two byte permutes, four exact conversions.
__device__ __forceinline__ void load_a(const uint8_t* wt, int kk, int n, int t,
                                       uint32_t (&a)[4]) {
  const int k = kk * 16 + 2 * t;
  const uint32_t l0 = *reinterpret_cast<const uint16_t*>(wt + w_offset(k, n));
  const uint32_t l1 = *reinterpret_cast<const uint16_t*>(wt + w_offset(k + 1, n));
  const uint32_t l8 = *reinterpret_cast<const uint16_t*>(wt + w_offset(k + 8, n));
  const uint32_t l9 = *reinterpret_cast<const uint16_t*>(wt + w_offset(k + 9, n));
  const uint32_t p = __byte_perm(l0, l1, 0x5140);  // k, k+1 of column n; then of n + 1
  const uint32_t q = __byte_perm(l8, l9, 0x5140);
  a[0] = e4m3x2_to_bf16x2(p);
  a[1] = e4m3x2_to_bf16x2(p >> 16);
  a[2] = e4m3x2_to_bf16x2(q);
  a[3] = e4m3x2_to_bf16x2(q >> 16);
}

// Store one warpgroup's accumulator D[64 weight columns][128 rows of x]:
// this thread holds columns n, n + 1 of rows m0 + 8 j + 2 t (+ 1).
__device__ __forceinline__ void store_tile(const float (&acc)[64], float* y, int m0, int n,
                                           int M, int N, int t) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int m = m0 + 8 * j + 2 * t;
    if (m < M)
      *reinterpret_cast<float2*>(y + static_cast<size_t>(m) * N + n) =
          make_float2(acc[4 * j], acc[4 * j + 2]);
    if (m + 1 < M)
      *reinterpret_cast<float2*>(y + static_cast<size_t>(m + 1) * N + n) =
          make_float2(acc[4 * j + 1], acc[4 * j + 3]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_x,
                    const __grid_constant__ CUtensorMap tmap_w, const float* __restrict__ scales,
                    float* __restrict__ y, int M, int K, int N) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * kBM, nb = blockIdx.y, n0 = nb * kBN;
  const int nsb = N / kBlock, ntiles = K / kBK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // producer: one lane keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == kConsumers / 32 && lane == 0) {
      for (int kt = 0; kt < ntiles; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(&empty[s], ((kt / kStages) - 1) & 1);
        uint8_t* st = smem + s * kStageBytes;
        mbar_expect_tx(&full[s], kXBytes + kWBytes);
        tma_load(st, &tmap_x, &full[s], kt * kBK, m0);
        tma_load(st + kXBytes, &tmap_w, &full[s], n0, kt * kBK);
      }
    }
    return;
  }

  // consumers: warpgroup wg computes weight columns n0 + 64 wg .. + 63 for
  // the block's 128 rows of x, as D = W^T X^T with W^T from registers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int n = 64 * wg + 16 * (warp & 3) + 2 * g;  // this thread's columns n, n + 1
  float acc[64], part[64], sc = 0.f;
  uint32_t a0[4][4], a1[4][4];  // A fragments of the slab's two tiles
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;

  for (int kt = 0; kt < ntiles; kt += 2) {  // one 128-row slab: tiles kt, kt + 1
    const int s0 = kt % kStages, s1 = (kt + 1) % kStages;
    const float sc_slab = __ldg(scales + static_cast<size_t>(kt >> 1) * nsb + nb);
    const uint8_t* st0 = smem + s0 * kStageBytes;
    const uint8_t* st1 = smem + s1 * kStageBytes;
    mbar_wait(&full[s0], (kt / kStages) & 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) load_a(st0 + kXBytes, kk, n, t, a0[kk]);
    if (kt > 0) {  // the previous slab is done: fold it in, free its last stage
      wgmma_wait<0>();
      fence_operands(part);
      if (lane == 0) mbar_arrive(&empty[(kt - 1) % kStages]);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = fmaf(part[i], sc, acc[i]);
    }
    sc = sc_slab;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(part, a0[kk], sw128_desc(smem_u32(st0) + kk * 32), kk > 0);
    wgmma_commit();

    mbar_wait(&full[s1], ((kt + 1) / kStages) & 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) load_a(st1 + kXBytes, kk, n, t, a1[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(part, a1[kk], sw128_desc(smem_u32(st1) + kk * 32), 1);
    wgmma_commit();
    wgmma_wait<1>();  // the slab's first tile is done: free its stage (and a0)
    if (lane == 0) mbar_arrive(&empty[s0]);
  }
  wgmma_wait<0>();
  fence_operands(part);
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = fmaf(part[i], sc, acc[i]);
  store_tile(acc, y, m0, n0 + n, M, N, t);
}

}  // namespace

// x: bf16 [M, K], 16-byte aligned; w: E4M3 codes [K, N], 16-byte aligned;
// scales: fp32 [K/128, N/128]; y: fp32 [M, N].  K and N are multiples of
// 128 (the quant block).  The tensor maps are encoded per call (rows of x
// beyond M read as zeros).
extern "C" int matmul_fp8_wgmma(const void* x, const void* w, const float* scales, float* y,
                                int M, int K, int N, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (K % kBlock || N % kBlock || N / kBN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tmap_x, tmap_w;
  if (!encode(&tmap_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, kBM, kBK,
              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&tmap_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, K, N, kBK, kBN,
              CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(matmul_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + kBM - 1) / kBM, N / kBN);
  matmul_wgmma_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      tmap_x, tmap_w, scales, y, M, K, N);
  return static_cast<int>(cudaGetLastError());
}
