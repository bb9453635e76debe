// Block-dequant fp8 matmul for decode on Hopper's tensor cores (sm_90a):
// the decode route of the port's fp8 matmul.
//
// Replaces, for 1 <= M < TC_MIN_ROWS (16) rows of bf16 or fp16 x and any
// quant block bs that is a multiple of 16, the TPU kernel
// src/repro/kernels/fp8_matmul/kernel.py: matmul_fp8_pallas (body
// _matmul_kernel):
//
//   y[M, N] = x[M, K] @ (w_q[K, N] * scale[K/bs, N/bs] per bs x bs block)
//
// with w_q E4M3 codes, fp32 scales and an fp32 result (the caller casts;
// kernel.py splits fp32 x into three bf16 parts and stacks them as rows).
// Bound on the H100: the weight bytes.  At M = 8 a weight byte carries 16
// operations, far below the ~295 at which the tensor cores would bind, so
// the kernel is built to read each fp8 weight from HBM once with enough
// bytes in flight to stream at the card's rate, and to spend as few
// instructions per byte as it can on the way into the products.
//
// Arithmetic: the reference's, up to summation order.  Every E4M3 value is
// exactly a bf16 and a half, and x already is one, so the weights are
// converted to x's type on chip and multiplied with mma.sync (m16n8k16,
// fp32 accumulate); each bs-row K block's product goes to its own
// accumulator and is added as acc += part * scale[kb, nb] in fp32.  fp8
// tensor-core products would need x cast to fp8: another result.
//
// Layout: the block computes its tile transposed, y^T = W^T x^T.  The A
// operand is the weight tile, converted from its swizzled fp8 copy in
// shared memory straight into mma's register fragment (as the prefill
// kernel's load_a does for wgmma); B is x, n = 8 rows for M <= 8 and two
// n = 8 tiles for 9 <= M <= 15.  Rows of x beyond M, and K rows and weight
// columns beyond the edges, are TMA's zero fill; rows of y beyond M and
// columns beyond N are never written.
//
// Bytes in flight: a ring of kStages (fp8 weight tile [128 k][BN columns],
// x slab [8 or 16 rows][128 k]) stages with full / empty mbarriers.  One
// producer lane issues the TMA loads; four consumer warps each own BN / 4
// weight columns of every stage.  A stage is 8 KB (BN = 64) or 16 KB
// (BN = 128) of weights plus 2-4 KB of x, so several blocks share an SM
// and each keeps kStages stages in flight.
//
// The quant block: a stage is 128 rows of K whatever bs is.  At bs = 128
// (the slab instances, kSlab) a stage is one block and its part is folded
// in once.  Otherwise (the general instances) the part is folded in at
// every bs boundary of K, after any k16 step (bs = 16, 32, 64, 96 ...) or
// after several stages (256, 512 ...), and at the end of the block's K
// range; each thread's two weight columns n, n + 1 lie in one column block
// (n even, bs a multiple of 16), so it reads one scale per row group.
//
// Filling 132 SMs: a block owns BN output columns and a contiguous range
// of stages.  kernel.py::decode_plan picks BN and the K split from the
// shapes (at least 132 blocks at every wide decode width); with more than
// one split each block writes its partial sums to scratch and a second
// small kernel adds them in a fixed order, so results are deterministic.
#include "hopper.cuh"

namespace {

constexpr int kStageK = 128;    // K depth of a stage (= the quant block of the slab instances)
constexpr int kSteps = kStageK / 16;  // k16 steps a stage
constexpr int kStages = 4;      // ring depth
constexpr int kConsumerWarps = 4;
constexpr int kThreads = (kConsumerWarps + 1) * 32;  // + one producer warp
constexpr int kXHalf = 64;      // 16-bit k per x box: 128 bytes, one swizzle row

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
// tile), two byte permutes, four exact conversions to x's type T.
template <int BN, typename T>
__device__ __forceinline__ void load_a(const uint8_t* wt, int kk, int n, int t,
                                       uint32_t (&a)[4]) {
  const int k = kk * 16 + 2 * t;
  const uint32_t l0 = *reinterpret_cast<const uint16_t*>(wt + w_offset<BN>(k, n));
  const uint32_t l1 = *reinterpret_cast<const uint16_t*>(wt + w_offset<BN>(k + 1, n));
  const uint32_t l8 = *reinterpret_cast<const uint16_t*>(wt + w_offset<BN>(k + 8, n));
  const uint32_t l9 = *reinterpret_cast<const uint16_t*>(wt + w_offset<BN>(k + 9, n));
  const uint32_t p = __byte_perm(l0, l1, 0x5140);  // k, k+1 of column n; then of n + 1
  const uint32_t q = __byte_perm(l8, l9, 0x5140);
  a[0] = e4m3x2_to<T>(p);
  a[1] = e4m3x2_to<T>(p >> 16);
  a[2] = e4m3x2_to<T>(q);
  a[3] = e4m3x2_to<T>(q >> 16);
}

// mma's B fragment for step kk: x row m, k = 16 kk + 2t (+1) and + 8 (+9).
// The x slab is two TMA boxes [rows][64 k] of 16-bit values with the
// 128-byte swizzle (16-byte chunk c of row m at c ^ (m % 8)), `box` bytes
// apart.
__device__ __forceinline__ void load_b(const uint8_t* xt, int box, int kk, int m, int t,
                                       uint32_t (&b)[2]) {
  const uint8_t* row = xt + (kk >> 2) * box + m * 128 + 4 * t;
  const int c = 2 * (kk & 3);
  b[0] = *reinterpret_cast<const uint32_t*>(row + ((c ^ (m & 7)) << 4));
  b[1] = *reinterpret_cast<const uint32_t*>(row + (((c + 1) ^ (m & 7)) << 4));
}

// d[16 x 8] += A[16 x 16] . B[16 x 8], bf16 or fp16 (T) in, fp32 accumulate.
template <typename T>
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  if constexpr (std::is_same_v<T, __half>)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The 16 k of step kk of the stage whose w tile is at wt (its x slab
// follows): part += W^T X^T for this thread's RG row groups and NT x tiles.
template <int BN, int NT, typename T>
__device__ __forceinline__ void mma_step(float (&part)[BN / 64][NT][4], const uint8_t* wt,
                                         int kk, int nw, int g, int t) {
  constexpr int kXBox = 8 * NT * kXHalf * 2;
  const uint8_t* xt = wt + kStageK * BN;
  uint32_t b[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) load_b(xt, kXBox, kk, 8 * j + g, t, b[j]);
#pragma unroll
  for (int r = 0; r < BN / 64; ++r) {
    uint32_t a[4];
    load_a<BN, T>(wt, kk, nw + 16 * r + 2 * g, t, a);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_16816<T>(part[r][j], a, b[j]);
  }
}

// acc += part * scale and part = 0, row group r's scale at sc_col[r][off].
template <int RG, int NT>
__device__ __forceinline__ void fold_part(float (&acc)[RG][NT][4], float (&part)[RG][NT][4],
                                          const float* (&sc_col)[RG], size_t off) {
#pragma unroll
  for (int r = 0; r < RG; ++r) {
    const float sc = __ldg(sc_col[r] + off);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[r][j][e] = fmaf(part[r][j][e], sc, acc[r][j][e]);
        part[r][j][e] = 0.f;
      }
  }
}

// NT n = 8 tiles of x rows (1 for M <= 8, 2 for M <= 16); BN weight
// columns per block, BN / 4 per consumer warp (RG row groups of 16); T the
// 16-bit type of x.  kSlab: bs = 128, one scale a stage (K and N multiples
// of 128); else any bs that is a multiple of 16 and divides K and N.  The
// block runs stages kb0 .. kb0 + kb_per_split - 1 of the nst = ceil(K/128).
template <int BN, int NT, typename T, bool kSlab>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const __grid_constant__ CUtensorMap tmap_x,
              const __grid_constant__ CUtensorMap tmap_w, const float* __restrict__ scales,
              float* __restrict__ out, int M, int K, int N, int bs, int nst,
              int kb_per_split) {
  constexpr int kRG = BN / 64;
  constexpr int kWBytes = kStageK * BN;
  constexpr int kXBox = 8 * NT * kXHalf * 2;
  constexpr int kStageBytes = kWBytes + 2 * kXBox;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * BN;
  const int kb0 = blockIdx.y * kb_per_split;
  const int nslab = min(nst, kb0 + kb_per_split) - kb0;

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
        const int k0 = (kb0 + i) * kStageK;
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
  const int nsb = kSlab ? N / kStageK : N / bs;
  float acc[kRG][NT][4], part[kRG][NT][4];
#pragma unroll
  for (int r = 0; r < kRG; ++r)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][j][e] = part[r][j][e] = 0.f;

  if constexpr (kSlab) {
    const float* sc_col = scales + n0 / kStageK;
    for (int i = 0; i < nslab; ++i) {
      const int s = i % kStages;
      const float sc = __ldg(sc_col + static_cast<size_t>(kb0 + i) * nsb);
      const uint8_t* wt = smem + s * kStageBytes;
#pragma unroll
      for (int r = 0; r < kRG; ++r)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[r][j][e] = 0.f;
      mbar_wait(&full[s], (i / kStages) & 1);
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) mma_step<BN, NT, T>(part, wt, kk, nw, g, t);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int r = 0; r < kRG; ++r)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][j][e] = fmaf(part[r][j][e], sc, acc[r][j][e]);
    }
  } else {
    // this thread's scale column for each row group (column 0 past N: its
    // part is zero fill and never stored)
    const float* sc_col[kRG];
#pragma unroll
    for (int r = 0; r < kRG; ++r) {
      const int n = n0 + nw + 16 * r + 2 * g;
      sc_col[r] = scales + (n < N ? n / bs : 0);
    }
    const int bs16 = bs / 16, kend = K / 16;  // k16 steps a quant block; of K
    int kg = kb0 * kSteps;                    // the next k16 step of K
    int kb = kg / bs16;                       // its quant block row
    int left = bs16 - kg % bs16;              // steps left in that block
    for (int i = 0; i < nslab; ++i, kg += kSteps) {
      const int s = i % kStages;
      const uint8_t* wt = smem + s * kStageBytes;
      mbar_wait(&full[s], (i / kStages) & 1);
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        if (kg + kk < kend) {  // past K: zero fill, skipped
          if (left == 0) {
            fold_part(acc, part, sc_col, static_cast<size_t>(kb++) * nsb);
            left = bs16;
          }
          mma_step<BN, NT, T>(part, wt, kk, nw, g, t);
          --left;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    // the last part: a quant block's end or the end of this block's K range
    fold_part(acc, part, sc_col, static_cast<size_t>(kb) * nsb);
  }

  // D row g is weight column n, row g + 8 is n + 1; D column is x row m
  float* o = out + static_cast<size_t>(blockIdx.y) * M * N;
#pragma unroll
  for (int r = 0; r < kRG; ++r) {
    const int n = n0 + nw + 16 * r + 2 * g;
    if (!kSlab && n >= N) continue;
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

struct Args {
  CUtensorMap tmap_x, tmap_w;
  const float* scales;
  float* out;
  int M, K, N, bs, nst, splits, kb_per_split;
  cudaStream_t st;
};

template <int BN, int NT, typename T, bool kSlab>
cudaError_t launch(const Args& a) {
  constexpr int kSmem = kStages * (kStageK * BN + 2 * 8 * NT * kXHalf * 2) + 1024;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<BN, NT, T, kSlab>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid((a.N + BN - 1) / BN, a.splits);
  decode_kernel<BN, NT, T, kSlab><<<grid, kThreads, kSmem, a.st>>>(
      a.tmap_x, a.tmap_w, a.scales, a.out, a.M, a.K, a.N, a.bs, a.nst, a.kb_per_split);
  return cudaGetLastError();
}

template <typename T, bool kSlab>
cudaError_t launch_tile(const Args& a, int bn, int nt) {
  if (bn == 128) return nt == 1 ? launch<128, 1, T, kSlab>(a) : launch<128, 2, T, kSlab>(a);
  return nt == 1 ? launch<64, 1, T, kSlab>(a) : launch<64, 2, T, kSlab>(a);
}

}  // namespace

// x: [M, K] bf16 (x_f16 = 0) or fp16 (1), 1 <= M <= 16, 16-byte aligned;
// w: E4M3 codes [K, N], 16-byte aligned; scales: fp32 [K/bs, N/bs];
// y: fp32 [M, N].  bs is a multiple of 16 that divides K and N; bn (64 or
// 128) output columns per block; splits blocks along K, each over
// kb_per_split 128-row stages (splits * kb_per_split >= ceil(K/128)); with
// splits > 1, scratch holds fp32 [splits, M, N].  The tensor maps are
// encoded per call.
extern "C" int matmul_fp8_decode(const void* x, const void* w, const float* scales, float* y,
                                 float* scratch, int M, int K, int N, int bs, int x_f16,
                                 int bn, int splits, int kb_per_split, void* stream) {
  if (M == 0 || N == 0) return 0;
  const int nst = (K + kStageK - 1) / kStageK;
  if (M < 0 || M > 16 || K <= 0 || bs <= 0 || bs % 16 || K % bs || N % bs ||
      (bn != 64 && bn != 128) || splits < 1 || splits > 65535 || kb_per_split < 1 ||
      static_cast<long long>(splits) * kb_per_split < nst)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nt = M <= 8 ? 1 : 2;
  Args a;
  if (!encode(&a.tmap_x, x_f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
              2, x, M, K, 8 * nt, kXHalf, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&a.tmap_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, K, N, kStageK, bn,
              bn == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B))
    return static_cast<int>(cudaErrorInvalidValue);
  a.scales = scales;
  a.out = splits > 1 ? scratch : y;
  a.M = M, a.K = K, a.N = N, a.bs = bs, a.nst = nst, a.splits = splits;
  a.kb_per_split = kb_per_split;
  a.st = static_cast<cudaStream_t>(stream);
  const bool slab = bs == kStageK;
  cudaError_t err;
  if (x_f16)
    err = slab ? launch_tile<__half, true>(a, bn, nt) : launch_tile<__half, false>(a, bn, nt);
  else
    err = slab ? launch_tile<__nv_bfloat16, true>(a, bn, nt)
               : launch_tile<__nv_bfloat16, false>(a, bn, nt);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(sum_splits(scratch, y, static_cast<long long>(M) * N, splits, a.st));
}
