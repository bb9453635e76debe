// Block-dequant fp8 matmul for decode on Hopper's tensor cores (sm_90a):
// the decode route of the port's fp8 matmul.
//
// Replaces, for 1 <= M < TC_MIN_ROWS (16) rows of bf16 x and quant block
// 128, the TPU kernel src/repro/kernels/fp8_matmul/kernel.py:
// matmul_fp8_pallas (body _matmul_kernel):
//
//   y[M, N] = x[M, K] @ (w_q[K, N] * scale[K/128, N/128] per 128 x 128 block)
//
// with x bf16, w_q E4M3 codes, fp32 scales and an fp32 result (the caller
// casts).  Bound on the H100: the weight bytes.  At M = 8 a weight byte
// carries 16 operations, far below the ~295 at which the tensor cores
// would bind, so the kernel is built to read each fp8 weight from HBM once
// with enough bytes in flight to stream at the card's rate, and to spend
// as few instructions per byte as it can on the way into the products.
//
// Arithmetic: the reference's, up to summation order.  Every E4M3 value is
// exactly a bf16 and x already is one, so the weights are converted to bf16
// on chip and multiplied with bf16 mma.sync (m16n8k16, fp32 accumulate);
// each 128-row K slab's product goes to its own accumulator and is added as
// acc += part * scale[kb, nb] in fp32.  fp8 tensor-core products would need
// x cast to fp8: another result.
//
// Layout: the block computes its tile transposed, y^T = W^T x^T.  The A
// operand is the weight tile, converted from its swizzled fp8 copy in
// shared memory straight into mma's register fragment (as the prefill
// kernel's load_a does for wgmma); B is x, n = 8 rows for M <= 8 and two
// n = 8 tiles for 9 <= M <= 15.  Rows of x beyond M are TMA's zero fill;
// rows of y beyond M are never written.
//
// Bytes in flight: a ring of kStages (fp8 weight tile [128 k][BN columns],
// x slab [8 or 16 rows][128 k] bf16) stages with full / empty mbarriers.
// One producer lane issues the TMA loads; four consumer warps each own
// BN / 4 weight columns of every slab.  A stage is 8 KB (BN = 64) or 16 KB
// (BN = 128) of weights plus 2-4 KB of x, so several blocks share an SM
// and each keeps kStages slabs in flight.
//
// Filling 132 SMs: a block owns BN output columns and a contiguous range
// of K slabs.  kernel.py::decode_plan picks BN and the K split from the
// shapes (at least 132 blocks at every wide decode width); with more than
// one split each block writes its partial sums to scratch and a second
// small kernel adds them in a fixed order, so results are deterministic.
#include "hopper.cuh"

namespace {

constexpr int kBlock = 128;     // quant block edge = the K depth of a stage
constexpr int kStages = 4;      // ring depth
constexpr int kConsumerWarps = 4;
constexpr int kThreads = (kConsumerWarps + 1) * 32;  // + one producer warp
constexpr int kXHalf = 64;      // bf16 k per x box: 128 bytes, one swizzle row

// Byte offset of (k, n) in the fp8 w tile [128 k][BN n] as TMA writes it:
// BN = 128 with the 128-byte swizzle (16-byte chunk c of row k at
// c ^ (k % 8)); BN = 64 with the 64-byte swizzle (chunk c at
// c ^ ((k / 2) % 4)).
template <int BN>
__device__ __forceinline__ int w_offset(int k, int n) {
  if constexpr (BN == 128)
    return k * 128 + ((((n >> 4) ^ (k & 7)) << 4) | (n & 15));
  else
    return k * 64 + ((((n >> 4) ^ ((k >> 1) & 3)) << 4) | (n & 15));
}

// mma's A fragment for the 16-deep step kk of the transposed w tile: this
// thread's rows g and g + 8 are weight columns n, n + 1, its k columns 2t,
// 2t + 1, 2t + 8, 2t + 9.  Four 2-byte loads (conflict free on the swizzled
// tile), two byte permutes, four exact conversions.
template <int BN>
__device__ __forceinline__ void load_a(const uint8_t* wt, int kk, int n, int t,
                                       uint32_t (&a)[4]) {
  const int k = kk * 16 + 2 * t;
  const uint32_t l0 = *reinterpret_cast<const uint16_t*>(wt + w_offset<BN>(k, n));
  const uint32_t l1 = *reinterpret_cast<const uint16_t*>(wt + w_offset<BN>(k + 1, n));
  const uint32_t l8 = *reinterpret_cast<const uint16_t*>(wt + w_offset<BN>(k + 8, n));
  const uint32_t l9 = *reinterpret_cast<const uint16_t*>(wt + w_offset<BN>(k + 9, n));
  const uint32_t p = __byte_perm(l0, l1, 0x5140);  // k, k+1 of column n; then of n + 1
  const uint32_t q = __byte_perm(l8, l9, 0x5140);
  a[0] = e4m3x2_to_bf16x2(p);
  a[1] = e4m3x2_to_bf16x2(p >> 16);
  a[2] = e4m3x2_to_bf16x2(q);
  a[3] = e4m3x2_to_bf16x2(q >> 16);
}

// mma's B fragment for step kk: x row m, k = 16 kk + 2t (+1) and + 8 (+9).
// The x slab is two TMA boxes [rows][64 k] bf16 with the 128-byte swizzle
// (16-byte chunk c of row m at c ^ (m % 8)), `box` bytes apart.
__device__ __forceinline__ void load_b(const uint8_t* xt, int box, int kk, int m, int t,
                                       uint32_t (&b)[2]) {
  const uint8_t* row = xt + (kk >> 2) * box + m * 128 + 4 * t;
  const int c = 2 * (kk & 3);
  b[0] = *reinterpret_cast<const uint32_t*>(row + ((c ^ (m & 7)) << 4));
  b[1] = *reinterpret_cast<const uint32_t*>(row + (((c + 1) ^ (m & 7)) << 4));
}

// d[16 x 8] += A[16 x 16] . B[16 x 8], bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// NT n = 8 tiles of x rows (1 for M <= 8, 2 for M <= 16); BN weight
// columns per block, BN / 4 per consumer warp (RG row groups of 16).
template <int BN, int NT>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const __grid_constant__ CUtensorMap tmap_x,
              const __grid_constant__ CUtensorMap tmap_w, const float* __restrict__ scales,
              float* __restrict__ out, int M, int N, int nkb, int kb_per_split) {
  constexpr int kRG = BN / 64;
  constexpr int kWBytes = kBlock * BN;
  constexpr int kXBox = 8 * NT * kXHalf * 2;
  constexpr int kStageBytes = kWBytes + 2 * kXBox;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * BN;
  const int kb0 = blockIdx.y * kb_per_split;
  const int nslab = min(nkb, kb0 + kb_per_split) - kb0;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // producer: one lane keeps the ring full
    if (lane == 0) {
      for (int i = 0; i < nslab; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
        uint8_t* st = smem + s * kStageBytes;
        const int k0 = (kb0 + i) * kBlock;
        mbar_expect_tx(&full[s], kStageBytes);
        tma_load(st, &tmap_w, &full[s], n0, k0);
        tma_load(st + kWBytes, &tmap_x, &full[s], k0, 0);
        tma_load(st + kWBytes + kXBox, &tmap_x, &full[s], k0 + kXHalf, 0);
      }
    }
    return;
  }

  // consumers: warp w computes weight columns n0 + w BN/4 .. + BN/4 - 1 for
  // every row of x, as D = W^T X^T with W^T from registers
  const int g = lane >> 2, t = lane & 3;
  const int nw = warp * (BN / kConsumerWarps);
  const float* sc_col = scales + n0 / kBlock;
  const int nsb = N / kBlock;
  float acc[kRG][NT][4];
#pragma unroll
  for (int r = 0; r < kRG; ++r)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][j][e] = 0.f;

  for (int i = 0; i < nslab; ++i) {
    const int s = i % kStages;
    const float sc = __ldg(sc_col + static_cast<size_t>(kb0 + i) * nsb);
    const uint8_t* wt = smem + s * kStageBytes;
    const uint8_t* xt = wt + kWBytes;
    float part[kRG][NT][4];
#pragma unroll
    for (int r = 0; r < kRG; ++r)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[r][j][e] = 0.f;
    mbar_wait(&full[s], (i / kStages) & 1);
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk) {
      uint32_t b[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) load_b(xt, kXBox, kk, 8 * j + g, t, b[j]);
#pragma unroll
      for (int r = 0; r < kRG; ++r) {
        uint32_t a[4];
        load_a<BN>(wt, kk, nw + 16 * r + 2 * g, t, a);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(part[r][j], a, b[j]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
    for (int r = 0; r < kRG; ++r)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][j][e] = fmaf(part[r][j][e], sc, acc[r][j][e]);
  }

  // D row g is weight column n, row g + 8 is n + 1; D column is x row m
  float* o = out + static_cast<size_t>(blockIdx.y) * M * N;
#pragma unroll
  for (int r = 0; r < kRG; ++r) {
    const int n = n0 + nw + 16 * r + 2 * g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int m = 8 * j + 2 * t;
      if (m < M)
        *reinterpret_cast<float2*>(o + static_cast<size_t>(m) * N + n) =
            make_float2(acc[r][j][0], acc[r][j][2]);
      if (m + 1 < M)
        *reinterpret_cast<float2*>(o + static_cast<size_t>(m + 1) * N + n) =
            make_float2(acc[r][j][1], acc[r][j][3]);
    }
  }
}

template <int BN, int NT>
cudaError_t launch(const CUtensorMap& tmap_x, const CUtensorMap& tmap_w, const float* scales,
                   float* out, int M, int N, int nkb, int splits, int kb_per_split,
                   cudaStream_t st) {
  constexpr int kSmem = kStages * (kBlock * BN + 2 * 8 * NT * kXHalf * 2) + 1024;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<BN, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid(N / BN, splits);
  decode_kernel<BN, NT><<<grid, kThreads, kSmem, st>>>(tmap_x, tmap_w, scales, out, M, N, nkb,
                                                       kb_per_split);
  return cudaGetLastError();
}

}  // namespace

// x: bf16 [M, K], 1 <= M <= 16, 16-byte aligned; w: E4M3 codes [K, N],
// 16-byte aligned; scales: fp32 [K/128, N/128]; y: fp32 [M, N].  K and N
// are multiples of 128; bn (64 or 128) output columns per block; splits
// blocks along K, each over kb_per_split 128-row slabs (splits *
// kb_per_split >= K/128); with splits > 1, scratch holds fp32
// [splits, M, N].  The tensor maps are encoded per call.
extern "C" int matmul_fp8_decode(const void* x, const void* w, const float* scales, float* y,
                                 float* scratch, int M, int K, int N, int bn, int splits,
                                 int kb_per_split, void* stream) {
  if (M == 0 || N == 0) return 0;
  const int nkb = K / kBlock;
  if (M < 0 || M > 16 || K % kBlock || N % kBlock || (bn != 64 && bn != 128) ||
      splits < 1 || splits > 65535 || kb_per_split < 1 ||
      static_cast<long long>(splits) * kb_per_split < nkb)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nt = M <= 8 ? 1 : 2;
  CUtensorMap tmap_x, tmap_w;
  if (!encode(&tmap_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, 8 * nt, kXHalf,
              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&tmap_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, K, N, kBlock, bn,
              bn == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = splits > 1 ? scratch : y;
  cudaError_t err;
  if (bn == 128)
    err = nt == 1 ? launch<128, 1>(tmap_x, tmap_w, scales, out, M, N, nkb, splits, kb_per_split, st)
                  : launch<128, 2>(tmap_x, tmap_w, scales, out, M, N, nkb, splits, kb_per_split, st);
  else
    err = nt == 1 ? launch<64, 1>(tmap_x, tmap_w, scales, out, M, N, nkb, splits, kb_per_split, st)
                  : launch<64, 2>(tmap_x, tmap_w, scales, out, M, N, nkb, splits, kb_per_split, st);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(sum_splits(scratch, y, static_cast<long long>(M) * N, splits, st));
}
