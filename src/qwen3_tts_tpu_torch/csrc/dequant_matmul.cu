// Row-major int8 weight-only matmul with the weight dequantized on chip
// (kernel B).
//
// Replaces the TPU kernel qwen3_tts_tpu/ops/pallas_matmul.py::
// _dequant_matmul_kernel (launched by _qmm_2d, wrapper
// quantized_matmul_pallas). Same function:
//
//   out = x @ w^T,   w[n, k] = bf16(q[n, k] * scale[n, k / gs] + bias[n, k / gs])
//
// x [M, K] bf16, q [N, K] uint8, scale/bias [N, G] f32, out [M, N] bf16.
// The weight is formed in f32 (product, then sum, each rounded as the plain
// version rounds them, no FMA contraction), rounded to bf16 BEFORE the
// product, multiplied on the tensor cores with f32 sums, and the output is
// rounded to bf16.
//
// What bounds it on an H100: device-memory bytes. Each weight costs 1.125
// bytes at gs = 64 (its u8 code plus its group's f32 scale and bias) and
// takes 2*M operations, so below M of about 300 rows HBM3's 3.35 TB/s is
// the limit. Streaming at that rate against ~1 us of memory latency needs
// some 25 KB of loads in flight on every one of the 132 SMs, and a decode
// weight of 1-12 MB cut into 64-row tiles gives only 16-96 blocks. Exact
// dequantization costs ~4.5 instructions a code, so at M = 1 the
// instruction throughput of the SMs is the next limit.
//
// The ring path, for K a multiple of 64, gs a multiple of 16 and x, q
// 16-byte aligned:
// - Split-K. The host plan (ops/dequant_matmul.py::plan_kernel_b) cuts K
//   into k_splits ranges of whole 64-wide slices and whole groups: about
//   2.5 blocks per SM at M <= 64, one wave of 2 per SM at 128 rows. Grid
//   (ceil(N / 64), ceil(M / TM), k_splits), 4 warps a block, 16 weight rows
//   a warp. With more than one split, each block writes its f32 partial
//   tile to a workspace [k_splits][tiles][TM][64], and one thread fences
//   and takes a ticket from the tile's counter; the block that draws the
//   last ticket sums the partials in split order 0..S-1 (whichever block
//   came last), rounds to bf16, writes out and resets the counter to 0. So
//   a call is one launch, and its results repeat bit for bit.
// - A ring of kStages slices in dynamic shared memory, filled by cp.async:
//   16-byte .cg copies of the [64 x 64] codes and the x rows of each slice,
//   and once, in the first group, 4-byte copies of the split's scale/bias
//   table (64 rows x its groups). With kStages - 1 slices in flight a block
//   keeps 20-80 KB of loads outstanding. cp.async rather than TMA: the
//   scale/bias rows are short gathers and the ragged N edge a per-row
//   predicate, which a TMA box does not express, and it needs no tensor map
//   (cuTensorMapEncodeTiled).
// - Swapped operands on mma.sync.m16n8k16 (bf16 in, f32 sums): out^T =
//   W x^T. 16 weight rows are the A operand, dequantized from the codes
//   straight into A-fragment registers, so the bf16 weight never touches
//   shared memory (as Marlin does for 4-bit codes); x^T is the B operand, 8
//   rows of M per n8 fragment, so M = 1..8 costs one fragment, 24 three and
//   128 sixteen. One block covers up to 128 rows of M (TM = 8 * NF), so at
//   M <= 128 the weight crosses device memory once; above, grid.y walks
//   128-row tiles. Inside each k16 step the fragment's k positions are
//   permuted, the same way in A and B (which leaves the sum unchanged), so
//   that a thread owns 16 contiguous k of each slice: one 16-byte shared
//   load of codes per weight row and two of activations per x row, free of
//   bank conflicts (x rows padded to 144 bytes), and one group per thread.
// - Programmatic dependent launch: the kernel is launched so that its
//   blocks are scheduled while the kernel before it finishes, and waits
//   for that kernel before it touches global memory.
//
// The simple path, for every other shape (K not a multiple of 64, gs not a
// multiple of 16, unaligned pointers): one block of 4 warps owns a TM x 64
// output tile (TM = 16 at M <= 16, else 64), stages x and the dequantized
// weight in shared memory and multiplies with wmma, walking all of K. Edges
// in M, N and K are masked there. The host picks the path by shape.
//
// The float32 instance (entry dequant_matmul_f32, for float32 models: the
// reference keeps the dequantized weight in x.dtype, so the product is
// f32 x f32) cannot use the bf16 tensor-core fragments and takes no TF32
// (it keeps about three digits; the float32 checks hold 1e-5 of the
// output's range). At M = 1 it is bound by the same bytes (x and out cost
// 4 bytes an element); above about 11 rows by the 67 TFLOP/s of f32 FMAs
// on the CUDA cores. Its ring path takes the bf16 ring's shapes:
// - Split-K, the workspace, the ticket and the last block's reduction in
//   split order as above, from its own host plan (plan_kernel_b with f32).
// - The same cp.async ring: 16-byte copies of each slice's [64 x 64] codes
//   (rows padded to 80 bytes, so a quarter-warp's 16-byte loads of 8 rows
//   hit 8 different bank groups) and of the block's f32 x rows (256 bytes),
//   the split's scale/bias table once.
// - Weights in registers, once per block. A lane owns 2 weight rows (4 in
//   the 32-row instance), and the 128 threads are 4 (8) parts of each
//   slice's 64 k. Each 4 k it dequantizes its weights exactly as the plain
//   version does, __fadd_rn(__fmul_rn(code, s), b) with no contraction, and
//   FMAs them into acc[TM][2 or 4] for EVERY row of M the block covers (TM
//   = 1..64), with x broadcast from shared memory (one 16-byte load feeds
//   8 or 16 FMAs). So at M <= 64 the weight crosses device memory and is
//   formed once per block; above, grid.y walks 32-row tiles (at 512 rows
//   12% faster than 2 rows a lane on the same tiles). There the ring runs at
//   ~3/4 of cuBLAS's full-f32 rate on a dense weight of the same shape,
//   which itself reaches ~60-65% of the 67 TFLOP/s (PERF.md).
// - The parts are summed in part order through shared memory, then the
//   splits in split order: repeats are bit-identical.
// - Programmatic dependent launch as above.
// Every other shape takes the simple f32 kernel: one block owns a TM x 64
// tile (TM = 4 at M <= 4, else 16), stages x and the f32 weight in shared
// memory and sums f32 FMAs in k order over all of K.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

// ---------------------------------------------------------------- ring path

constexpr int kTN = 64;                 // weight rows (output columns) a block
constexpr int kTK = 64;                 // K of one ring slice
constexpr int kThreads = 128;           // 4 warps, 16 weight rows each
constexpr int kXStride = kTK * 2 + 16;  // bytes per staged x row (144)
constexpr int kSbGroupsMax = 128;       // groups of one split (the plan keeps to it)

// Scale and bias of a block's rows over its split's groups, [2][kTN][stride]
// floats; an odd row stride keeps 8 rows of a column in 8 banks.
__host__ __device__ constexpr int sb_stride(int groups) { return groups | 1; }
__host__ __device__ constexpr int sb_bytes(int groups) {
  return 2 * kTN * sb_stride(groups) * 4;
}

// One instance: NF 8-row fragments of M, 4 warps of 16 weight rows a block.
template <int NF>
struct Ring {
  static constexpr int kRows = 8 * NF;  // rows of M a block covers (TM)
  static constexpr int kStages = NF <= 4 ? 6 : 4;
  static constexpr int kStageBytes = kTN * kTK + kRows * kXStride;
  static constexpr int kSmem = kStages * kStageBytes;  // then the scale/bias table
  static constexpr int kTile = kRows * kTN;            // floats of a partial tile
  // independent accumulator chains at M <= 32: products of one k16 step on
  // all fragments back to back, and at M <= 16 the four k16 steps on chains
  // of their own (at larger M, fragment after fragment measured faster)
  static constexpr int kGroup = NF <= 4 ? NF : 1;
  static constexpr int kChains = NF == 1 ? 4 : (NF == 2 ? 2 : 1);
  // the last block's reduction: float4 outputs per thread (a tile has
  // 16 * kRows of them) and splits loaded per batch, 16 float4 in flight
  static constexpr int kRedU = NF <= 4 ? NF : 8;
  static constexpr int kRedA = NF <= 4 ? 16 / NF : 2;
};

// Two codes (bytes lo and lo + 1 of word) -> two bf16 weights packed for an
// mma fragment register, byte lo in the low half. A code becomes its exact
// f32 value as 2^23 + code - 2^23.
__device__ __forceinline__ uint32_t dequant2(uint32_t word, int lo, float s,
                                             float b) {
  const float c0 =
      __uint_as_float(__byte_perm(word, 0x4b000000u, 0x7540 | lo)) - 8388608.f;
  const float c1 =
      __uint_as_float(__byte_perm(word, 0x4b000000u, 0x7540 | (lo + 1))) -
      8388608.f;
  const __nv_bfloat162 w = __floats2bfloat162_rn(
      __fadd_rn(__fmul_rn(c0, s), b), __fadd_rn(__fmul_rn(c1, s), b));
  return *reinterpret_cast<const uint32_t*>(&w);
}

// Not volatile: independent products may be interleaved by the compiler.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store_bf16(__nv_bfloat16* out, int n, int N,
                                           float v) {
  if (n < N) out[n] = __float2bfloat16_rn(v);
}

// (__launch_bounds__ with a minimum of 1 block per SM: without it ptxas
// spilled at M <= 16 and the 128-row instance ran 20% slower)
template <int NF>
__global__ void __launch_bounds__(kThreads, 1) ring_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
    const float* __restrict__ scale, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
    int* __restrict__ counters, int M, int K, int N, int gs, int k_unit,
    int sb_groups) {
  using R = Ring<NF>;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int ticket;

  // Launched with programmatic stream serialization, so that the launch
  // overlaps the end of the kernel before; this one touches global memory
  // only once that kernel has finished.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;  // fragment row group
  const int t = tid & 3;          // thread in group: owns k 16t..16t+15 of a slice
  const int n0 = blockIdx.x * kTN;
  const int m0 = blockIdx.y * R::kRows;
  const int rows = min(R::kRows, M - m0);
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int units = K / k_unit;
  const int kb = static_cast<int>(static_cast<long long>(split) * units / splits) * k_unit;
  const int ke = static_cast<int>(static_cast<long long>(split + 1) * units / splits) * k_unit;
  const int slices = (ke - kb) / kTK;
  const int G = K / gs;
  const int ra = warp * 16 + g;  // this thread's weight rows in the tile: ra, ra + 8
  const int g0 = kb / gs;        // the split's first group
  const int sbs = sb_stride(sb_groups);
  float* sbt = reinterpret_cast<float*>(smem + R::kSmem);

  // Copies a thread starts for each slice, as offsets from the split's
  // first: codes of rows cr and cr + 32 at byte cc, and x rows xr + 16j
  // (j < xn) at column xc. Rows of x past M and weight rows past N are not
  // loaded: their garbage reaches only output entries that are never stored.
  const int cr = tid >> 2;
  const int cc = (tid & 3) * 16;
  const uint8_t* qsrc = q + (size_t)(n0 + cr) * K + kb + cc;
  const bool q0 = n0 + cr < N;
  const bool q1 = n0 + cr + 32 < N;
  const int xr = tid >> 3;
  const int xc = (tid & 7) * 8;
  const int xn = xr < rows ? (rows - xr + 15) / 16 : 0;
  const __nv_bfloat16* xsrc = x + (size_t)(m0 + xr) * K + kb + xc;
  auto load = [&](int stage, int s) {
    uint8_t* base = smem + stage * R::kStageBytes;
    const int k = s * kTK;
    if (q0) cp_async16(base + cr * kTK + cc, qsrc + k);
    if (q1) cp_async16(base + (cr + 32) * kTK + cc, qsrc + (size_t)32 * K + k);
    uint8_t* xs = base + kTN * kTK + xr * kXStride + xc * 2;
    for (int j = 0; j < xn; ++j)
      cp_async16(xs + j * 16 * kXStride, xsrc + (size_t)j * 16 * K + k);
  };

  float acc[R::kChains][NF][4];
#pragma unroll
  for (int c = 0; c < R::kChains; ++c)
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][f][e] = 0.f;

  // The first group of copies: slice 0 and the split's scale/bias table
  // (consecutive threads on consecutive groups of a row, 2^lg threads a
  // row); then a group for each of slices 1..
  if (slices > 0) load(0, 0);
  const int gspan = (ke - kb) / gs;
  const int lg = 32 - __clz(gspan - 1);  // gspan <= 2^lg <= kThreads
  const int col = tid & ((1 << lg) - 1);
  for (int row = tid >> lg; row < 2 * kTN; row += kThreads >> lg) {
    const int n = n0 + (row & (kTN - 1));  // scale rows, then bias rows
    if (col < gspan && n < N)
      cp_async4(sbt + row * sbs + col,
                (row < kTN ? scale : bias) + (size_t)n * G + g0 + col);
  }
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < R::kStages - 1; ++s) {
    if (s < slices) load(s, s);
    cp_async_commit();
  }

  // this thread's group, relative to g0, and its k offset inside it
  int grp = 16 * t / gs;
  int rem = 16 * t - grp * gs;
  for (int i = 0; i < slices; ++i) {
    cp_async_wait<R::kStages - 2>();  // slice i has landed ...
    __syncthreads();  // ... for every thread, and slice i - 1's stage is free
    const int next = i + R::kStages - 1;
    if (next < slices) load(next % R::kStages, next);
    cp_async_commit();

    const uint8_t* base = smem + (i % R::kStages) * R::kStageBytes;
    const uint4 qa = *reinterpret_cast<const uint4*>(base + ra * kTK + t * 16);
    const uint4 qb = *reinterpret_cast<const uint4*>(base + (ra + 8) * kTK + t * 16);
    const float sa = sbt[ra * sbs + grp];
    const float sb = sbt[(ra + 8) * sbs + grp];
    const float ba = sbt[(kTN + ra) * sbs + grp];
    const float bb = sbt[(kTN + ra + 8) * sbs + grp];
    rem += kTK;
    while (rem >= gs) {
      rem -= gs;
      ++grp;
    }
    // k16 step j: fragment k positions 2t, 2t+1, 2t+8, 2t+9 hold the
    // slice's k = 16t + 4j + 0..3, codes byte 0..3 of word j
    uint32_t a[4][4];
#define DEQUANT_STEP(j, wa, wb)                                   \
  a[j][0] = dequant2(wa, 0, sa, ba); /* row g,     k +0, +1 */ \
  a[j][1] = dequant2(wb, 0, sb, bb); /* row g + 8, k +0, +1 */ \
  a[j][2] = dequant2(wa, 2, sa, ba); /* row g,     k +2, +3 */ \
  a[j][3] = dequant2(wb, 2, sb, bb); /* row g + 8, k +2, +3 */
    DEQUANT_STEP(0, qa.x, qb.x)
    DEQUANT_STEP(1, qa.y, qb.y)
    DEQUANT_STEP(2, qa.z, qb.z)
    DEQUANT_STEP(3, qa.w, qb.w)
#undef DEQUANT_STEP
    const uint8_t* xs = base + kTN * kTK + g * kXStride + t * 32;
#pragma unroll
    for (int f0 = 0; f0 < NF; f0 += R::kGroup) {
      uint4 xv[R::kGroup][2];  // x^T fragments: k 16t..16t+7, 16t+8..16t+15
#pragma unroll
      for (int u = 0; u < R::kGroup; ++u) {
        xv[u][0] = *reinterpret_cast<const uint4*>(xs + (f0 + u) * 8 * kXStride);
        xv[u][1] = *reinterpret_cast<const uint4*>(xs + (f0 + u) * 8 * kXStride + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int u = 0; u < R::kGroup; ++u) {
          const uint4& v = xv[u][j >> 1];
          mma_bf16(acc[j % R::kChains][f0 + u], a[j], (j & 1) ? v.z : v.x,
                   (j & 1) ? v.w : v.y);
        }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int c = 1; c < R::kChains; ++c)
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][f][e] += acc[c][f][e];

  // accumulator e of fragment f: weight row ra (e < 2) or ra + 8, x row
  // 8f + 2t + (e & 1) of the tile
  if (splits == 1) {
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + ra + (e < 2 ? 0 : 8);
        const int m = m0 + 8 * f + 2 * t + (e & 1);
        if (m < M) store_bf16(out + (size_t)m * N, n, N, acc[0][f][e]);
      }
    return;
  }
  // the partial tile, [kRows][kTN] f32, at ws[split][tile]
  const int tiles = gridDim.x * gridDim.y;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  float* part = ws + ((size_t)split * tiles + tile) * R::kTile;
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ml = 8 * f + 2 * t + (e & 1);
      if (ml < rows) part[ml * kTN + ra + (e < 2 ? 0 : 8)] = acc[0][f][e];
    }
  // the block's stores, then one thread's fence and ticket (as cooperative
  // groups' grid sync orders a block's writes)
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    ticket = atomicAdd(counters + tile, 1);
    __threadfence();
  }
  __syncthreads();
  if (ticket != splits - 1) return;
  // the last block: the tile's sums over the splits in order 0..S-1 (from
  // 0 + split 0), four outputs a float4, kRedU float4 a thread at a time,
  // with the partials of kRedA splits loaded before they are added
  constexpr int U = R::kRedU;
  constexpr int A = R::kRedA;
  const float4* w4 = reinterpret_cast<const float4*>(ws) + (size_t)tile * (R::kTile / 4);
  const size_t step4 = (size_t)tiles * (R::kTile / 4);
  const int n4 = rows * (kTN / 4);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i0 = tid; i0 < n4; i0 += U * kThreads) {
    float4 sum[U];
#pragma unroll
    for (int u = 0; u < U; ++u) sum[u] = zero4;
    int s = 0;
    for (; s + A <= splits; s += A) {
      float4 v[A][U];
#pragma unroll
      for (int a = 0; a < A; ++a)
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = i0 + u * kThreads;
          v[a][u] = i < n4 ? __ldcg(w4 + (s + a) * step4 + i) : zero4;
        }
#pragma unroll
      for (int a = 0; a < A; ++a)
#pragma unroll
        for (int u = 0; u < U; ++u) add4(sum[u], v[a][u]);
    }
    for (; s < splits; ++s) {
      float4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * kThreads;
        v[u] = i < n4 ? __ldcg(w4 + s * step4 + i) : zero4;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) add4(sum[u], v[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n4) {
        __nv_bfloat16* row = out + (size_t)(m0 + i / (kTN / 4)) * N;
        const int n = n0 + (i % (kTN / 4)) * 4;
        store_bf16(row, n, N, sum[u].x);
        store_bf16(row, n + 1, N, sum[u].y);
        store_bf16(row, n + 2, N, sum[u].z);
        store_bf16(row, n + 3, N, sum[u].w);
      }
    }
  }
  if (tid == 0) counters[tile] = 0;
}

constexpr int kMaxDevices = 64;

template <int NF>
cudaError_t launch_ring(const __nv_bfloat16* x, const uint8_t* q, const float* s,
                        const float* b, __nv_bfloat16* out, float* ws,
                        int* counters, int M, int K, int N, int gs, int k_splits,
                        int k_unit, int sb_groups, cudaStream_t stream) {
  using R = Ring<NF>;
  static bool smem_set[kMaxDevices] = {};  // the attribute, once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sb_groups < 1 || sb_groups > kSbGroupsMax) return cudaErrorInvalidValue;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(ring_kernel<NF>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               R::kSmem + sb_bytes(kSbGroupsMax));
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kTN - 1) / kTN, (M + R::kRows - 1) / R::kRows, k_splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = R::kSmem + sb_bytes(sb_groups);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ring_kernel<NF>, x, q, s, b, out, ws, counters,
                           M, K, N, gs, k_unit, sb_groups);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// -------------------------------------------------------------- simple path

using namespace nvcuda;

constexpr int LDS = kTK + 8;  // bf16 row stride: 144 bytes keeps fragments 32-byte aligned
constexpr int LDO = kTN + 4;  // f32 row stride of the output staging tile

// Dequantize 16 codes of one group into 16 bf16 weights in shared memory.
__device__ __forceinline__ void dequant16(const uint4& qv, float s, float b,
                                          __nv_bfloat16* dst) {
  const unsigned words[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const float c = float((words[e / 4] >> (8 * (e % 4))) & 0xffu);
    dst[e] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(c, s), b));
  }
}

template <int TM, bool VEC>
__global__ void __launch_bounds__(kThreads) simple_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
    const float* __restrict__ scale, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ out, int M, int K, int N, int gs) {
  __shared__ __align__(32) __nv_bfloat16 xs[TM * LDS];
  __shared__ __align__(32) __nv_bfloat16 ws[kTN * LDS];
  __shared__ __align__(32) float os[TM * LDO];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * kTN;
  const int G = K / gs;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  // VEC: thread -> weight rows tid/4 and tid/4 + 32, 16-code piece tid%4
  constexpr int kPieces = kTN * kTK / 16 / kThreads;  // 2
  uint4 qv[kPieces];
  float sv[kPieces], bv[kPieces];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int p = 0; p < kPieces; ++p) {
      const int n = n0 + tid / 4 + p * (kThreads / 4);
      const int k = k0 + (tid % 4) * 16;
      if (n < N && k < K) {
        qv[p] = *reinterpret_cast<const uint4*>(q + (size_t)n * K + k);
        const size_t sb = (size_t)n * G + k / gs;
        sv[p] = scale[sb];
        bv[p] = bias[sb];
      } else {
        qv[p] = make_uint4(0, 0, 0, 0);
        sv[p] = bv[p] = 0.f;
      }
    }
  };
  if (VEC) fetch(0);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[TM / 16];
#pragma unroll
  for (int i = 0; i < TM / 16; ++i) wmma::fill_fragment(acc[i], 0.f);

  for (int k0 = 0; k0 < K; k0 += kTK) {
    if (VEC) {  // 8 activations per 16-byte load
      for (int i = tid; i < TM * kTK / 8; i += kThreads) {
        const int r = i / (kTK / 8);
        const int c = (i % (kTK / 8)) * 8;
        const int m = m0 + r;
        const int k = k0 + c;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (m < M && k < K)
          v = *reinterpret_cast<const uint4*>(x + (size_t)m * K + k);
        *reinterpret_cast<uint4*>(xs + r * LDS + c) = v;
      }
    } else {
      for (int i = tid; i < TM * kTK; i += kThreads) {
        const int r = i / kTK;
        const int c = i % kTK;
        const int m = m0 + r;
        const int k = k0 + c;
        xs[r * LDS + c] = (m < M && k < K) ? x[(size_t)m * K + k] : zero;
      }
    }
    if (VEC) {
#pragma unroll
      for (int p = 0; p < kPieces; ++p)
        dequant16(qv[p], sv[p], bv[p],
                  ws + (tid / 4 + p * (kThreads / 4)) * LDS + (tid % 4) * 16);
    } else {
      for (int i = tid; i < kTN * kTK; i += kThreads) {
        const int r = i / kTK;
        const int c = i % kTK;
        const int n = n0 + r;
        const int k = k0 + c;
        float w = 0.f;
        if (n < N && k < K) {
          const size_t sb = (size_t)n * G + k / gs;
          w = __fadd_rn(__fmul_rn(float(q[(size_t)n * K + k]), scale[sb]),
                        bias[sb]);
        }
        ws[r * LDS + c] = __float2bfloat16_rn(w);
      }
    }
    __syncthreads();
    if (VEC && k0 + kTK < K) fetch(k0 + kTK);  // in flight during the products
#pragma unroll
    for (int kk = 0; kk < kTK; kk += 16) {
      // B[k][n] = w[n][k]: the [n][k] tile read column-major
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> b;
      wmma::load_matrix_sync(b, ws + warp * 16 * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < TM / 16; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(a, xs + i * 16 * LDS + kk, LDS);
        wmma::mma_sync(acc[i], a, b, acc[i]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM / 16; ++i)
    wmma::store_matrix_sync(os + i * 16 * LDO + warp * 16, acc[i], LDO,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < TM * kTN; i += kThreads) {
    const int r = i / kTN;
    const int c = i % kTN;
    const int m = m0 + r;
    const int n = n0 + c;
    if (m < M && n < N) out[(size_t)m * N + n] = __float2bfloat16(os[r * LDO + c]);
  }
}

template <int TM>
cudaError_t launch_simple(const __nv_bfloat16* x, const uint8_t* q, const float* s,
                          const float* b, __nv_bfloat16* out, int M, int K, int N,
                          int gs, cudaStream_t stream) {
  const dim3 grid((N + kTN - 1) / kTN, (M + TM - 1) / TM);
  const bool vec = K % 16 == 0 && gs % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (vec)
    simple_kernel<TM, true><<<grid, kThreads, 0, stream>>>(x, q, s, b, out, M, K, N, gs);
  else
    simple_kernel<TM, false><<<grid, kThreads, 0, stream>>>(x, q, s, b, out, M, K, N, gs);
  return cudaGetLastError();
}

// ---------------------------------------------------------- f32 simple path

constexpr int kF32TK = 64;                       // K of one staged tile
constexpr int kF32Threads = 256;
constexpr int kF32RowGroups = kF32Threads / kTN;  // 4: a thread's rows step by it

// One block owns a TM x 64 output tile and walks all of K in 64-wide tiles:
// x [TM][64] and the weight [64][64], dequantized in f32 as the ring path
// forms it (product, then sum, each rounded), staged in shared memory. A
// thread owns one output column and the rows rg, rg + 4, ...; each output
// is one thread's f32 FMAs in k order, so repeats are bit-identical. A
// thread issues all its loads of a tile before it uses any, so they are in
// flight together (loaded one after another, a tile cost a memory round
// trip per element).
template <int TM>
__global__ void __launch_bounds__(kF32Threads) f32_kernel(
    const float* __restrict__ x, const uint8_t* __restrict__ q,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ out, int M, int K, int N, int gs) {
  constexpr int kRowsPer = TM / kF32RowGroups;
  constexpr int kXPer = TM * kF32TK / kF32Threads;   // x elements a thread stages
  constexpr int kWPer = kTN * kF32TK / kF32Threads;  // weights a thread stages
  __shared__ float xs[TM][kF32TK];
  __shared__ float wt[kTN][kF32TK + 1];  // odd stride: a warp's columns in 32 banks

  const int tid = threadIdx.x;
  const int col = tid % kTN;
  const int rg = tid / kTN;  // one per warp pair: x reads are broadcasts
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * kTN;
  const int G = K / gs;

  float acc[kRowsPer];
#pragma unroll
  for (int j = 0; j < kRowsPer; ++j) acc[j] = 0.f;

  // a thread's elements of a tile: index tid + j * kF32Threads, at row
  // r0 + j * (kF32Threads / kF32TK) and column c (the same for every j)
  const int c = tid % kF32TK;
  const int r0 = tid / kF32TK;
  constexpr int kRowStep = kF32Threads / kF32TK;
  for (int k0 = 0; k0 < K; k0 += kF32TK) {
    const int k = k0 + c;
    float xv[kXPer];
#pragma unroll
    for (int j = 0; j < kXPer; ++j) {
      const int m = m0 + r0 + j * kRowStep;
      xv[j] = (m < M && k < K) ? x[(size_t)m * K + k] : 0.f;
    }
    uint8_t qv[kWPer];
    float sv[kWPer], bv[kWPer];
#pragma unroll
    for (int j = 0; j < kWPer; ++j) {
      const int n = n0 + r0 + j * kRowStep;
      const bool in = n < N && k < K;
      const size_t sb = in ? (size_t)n * G + k / gs : 0;
      qv[j] = in ? q[(size_t)n * K + k] : 0;
      sv[j] = in ? scale[sb] : 0.f;
      bv[j] = in ? bias[sb] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kXPer; ++j) xs[r0 + j * kRowStep][c] = xv[j];
#pragma unroll
    for (int j = 0; j < kWPer; ++j)
      wt[r0 + j * kRowStep][c] = __fadd_rn(__fmul_rn(float(qv[j]), sv[j]), bv[j]);
    __syncthreads();
#pragma unroll 16
    for (int kk = 0; kk < kF32TK; ++kk) {
      const float w = wt[col][kk];
#pragma unroll
      for (int j = 0; j < kRowsPer; ++j)
        acc[j] = fmaf(xs[rg + j * kF32RowGroups][kk], w, acc[j]);
    }
    __syncthreads();
  }
  const int n = n0 + col;
#pragma unroll
  for (int j = 0; j < kRowsPer; ++j) {
    const int m = m0 + rg + j * kF32RowGroups;
    if (m < M && n < N) out[(size_t)m * N + n] = acc[j];
  }
}

template <int TM>
cudaError_t launch_f32(const float* x, const uint8_t* q, const float* s, const float* b,
                       float* out, int M, int K, int N, int gs, cudaStream_t stream) {
  const dim3 grid((N + kTN - 1) / kTN, (M + TM - 1) / TM);
  f32_kernel<TM><<<grid, kF32Threads, 0, stream>>>(x, q, s, b, out, M, K, N, gs);
  return cudaGetLastError();
}


// -------------------------------------------------------------- f32 ring path

constexpr int kF32RingThreads = 128;     // 4 warps
constexpr int kF32QRow = kTK + 16;       // bytes a staged code row (80)
constexpr int kF32XRow = kTK * 4;        // bytes a staged x row (256)

// One instance: TM rows of M a block (1, 2, 4, 8, 16, 32 or 64). A lane
// owns kRN weight rows (2; 4 in the 32-row instance, which the plan also
// gives every row tile above 64 rows: twice the FMAs per x load), so the
// 128 threads are kKP parts of each slice's 64 k, kKPart k each.
template <int TM>
struct RingF32 {
  static constexpr int kRN = TM == 32 ? 4 : 2;
  static constexpr int kLanes = kTN / kRN;                // threads of a part: 32 or 16
  static constexpr int kKP = kF32RingThreads / kLanes;   // 4 or 8
  static constexpr int kKPart = kTK / kKP;               // 16 or 8
  static constexpr int kSteps = kKPart / 4;              // 4-k steps of a part
  static constexpr int kStages = TM <= 8 ? 8 : TM == 32 ? 5 : 4;
  static constexpr int kStageBytes = kTN * kF32QRow + TM * kF32XRow;
  static constexpr int kSmem = kStages * kStageBytes;  // then the scale/bias table
  static constexpr int kTile = TM * kTN;               // floats of a partial tile
  // blocks an SM holds (ops/dequant_matmul.py::f32_blocks_per_sm counts on it)
  static constexpr int kMinBlocks = TM <= 16 ? 3 : 2;
  // the last block's reduction: float4 a thread per batch (a tile has
  // 16 * TM), splits loaded per batch (16 float4 in flight)
  static constexpr int kRedU = TM >= 16 ? TM / 8 : 1;
  static constexpr int kRedA = 16 / kRedU;
  static_assert(kKP * kTile * 4 <= kSmem, "the parts' sums reuse the ring");
};

// One code (byte c of word) as its exact f32 value: 2^23 + code - 2^23.
__device__ __forceinline__ float code_f32(uint32_t word, int c) {
  return __uint_as_float(__byte_perm(word, 0x4b000000u, 0x7540 | c)) - 8388608.f;
}

// A lane's codes of one weight row in a slice: its part's kKPart bytes as
// kKPart / 4 words, one 16- or 8-byte shared load.
template <int KPART>
struct Codes {
  uint32_t w[KPART / 4];
  __device__ __forceinline__ void load(const uint8_t* p) {
    if constexpr (KPART == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    } else {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x;
      w[1] = v.y;
    }
  }
};

template <int TM>
__global__ void __launch_bounds__(kF32RingThreads, RingF32<TM>::kMinBlocks) ring_f32_kernel(
    const float* __restrict__ x, const uint8_t* __restrict__ q,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ out, float* __restrict__ ws, int* __restrict__ counters,
    int M, int K, int N, int gs, int k_unit, int sb_groups) {
  using R = RingF32<TM>;
  constexpr int RN = R::kRN;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int ticket;

  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  const int tid = threadIdx.x;
  const int part = tid / R::kLanes;  // k kKPart*part .. + kKPart of each slice
  const int ln = tid % R::kLanes;    // weight rows ln + kLanes * r, r < RN
  const int n0 = blockIdx.x * kTN;
  const int m0 = blockIdx.y * TM;
  const int rows = min(TM, M - m0);
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int units = K / k_unit;
  const int kb = static_cast<int>(static_cast<long long>(split) * units / splits) * k_unit;
  const int ke = static_cast<int>(static_cast<long long>(split + 1) * units / splits) * k_unit;
  const int slices = (ke - kb) / kTK;
  const int G = K / gs;
  const int g0 = kb / gs;
  const int sbs = sb_stride(sb_groups);
  float* sbt = reinterpret_cast<float*>(smem + R::kSmem);

  // Copies a thread starts for each slice, as offsets from the split's
  // first: codes of rows cr and cr + 32 at byte cc, and x rows xr + 8j
  // (j < xn) at column xc. Rows of x past M and weight rows past N are not
  // loaded: their garbage reaches only output entries that are never stored.
  const int cr = tid >> 2;
  const int cc = (tid & 3) * 16;
  const uint8_t* qsrc = q + (size_t)(n0 + cr) * K + kb + cc;
  const bool q0 = n0 + cr < N;
  const bool q1 = n0 + cr + 32 < N;
  const int xr = tid >> 4;
  const int xc = (tid & 15) * 4;
  const int xn = xr < rows ? (rows - xr + 7) / 8 : 0;
  const float* xsrc = x + (size_t)(m0 + xr) * K + kb + xc;
  auto load = [&](int stage, int s) {
    uint8_t* base = smem + stage * R::kStageBytes;
    const int k = s * kTK;
    if (q0) cp_async16(base + cr * kF32QRow + cc, qsrc + k);
    if (q1) cp_async16(base + (cr + 32) * kF32QRow + cc, qsrc + (size_t)32 * K + k);
    uint8_t* xs = base + kTN * kF32QRow + xr * kF32XRow + xc * 4;
    for (int j = 0; j < xn; ++j)
      cp_async16(xs + j * 8 * kF32XRow, xsrc + (size_t)j * 8 * K + k);
  };

  float acc[TM][RN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int r = 0; r < RN; ++r) acc[m][r] = 0.f;

  // The first group of copies: slice 0 and the split's scale/bias table (as
  // the bf16 ring); then a group for each of slices 1 .. kStages - 2.
  if (slices > 0) load(0, 0);
  const int gspan = (ke - kb) / gs;
  const int lg = 32 - __clz(gspan - 1);  // gspan <= 2^lg <= kF32RingThreads
  const int col = tid & ((1 << lg) - 1);
  for (int row = tid >> lg; row < 2 * kTN; row += kF32RingThreads >> lg) {
    const int n = n0 + (row & (kTN - 1));  // scale rows, then bias rows
    if (col < gspan && n < N)
      cp_async4(sbt + row * sbs + col, (row < kTN ? scale : bias) + (size_t)n * G + g0 + col);
  }
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < R::kStages - 1; ++s) {
    if (s < slices) load(s, s);
    cp_async_commit();
  }

  // this thread's group, relative to g0, and its k offset inside it (a
  // part lies in one group: gs is a multiple of 16)
  int grp = R::kKPart * part / gs;
  int rem = R::kKPart * part - grp * gs;
  for (int i = 0; i < slices; ++i) {
    cp_async_wait<R::kStages - 2>();  // slice i has landed ...
    __syncthreads();  // ... for every thread, and slice i - 1's stage is free
    const int next = i + R::kStages - 1;
    if (next < slices) load(next % R::kStages, next);
    cp_async_commit();

    const uint8_t* base = smem + (i % R::kStages) * R::kStageBytes;
    Codes<R::kKPart> codes[RN];
    float sc[RN], bi[RN];
#pragma unroll
    for (int r = 0; r < RN; ++r) {
      const int row = ln + R::kLanes * r;
      codes[r].load(base + row * kF32QRow + part * R::kKPart);
      sc[r] = sbt[row * sbs + grp];
      bi[r] = sbt[(kTN + row) * sbs + grp];
    }
    rem += kTK;
    while (rem >= gs) {
      rem -= gs;
      ++grp;
    }
    const float* xs =
        reinterpret_cast<const float*>(base + kTN * kF32QRow) + part * R::kKPart;
#pragma unroll
    for (int st = 0; st < R::kSteps; ++st) {  // k = kKPart * part + 4 st + j
      float w[RN][4];
#pragma unroll
      for (int r = 0; r < RN; ++r) {
        const uint32_t word = codes[r].w[st];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w[r][j] = __fadd_rn(__fmul_rn(code_f32(word, j), sc[r]), bi[r]);
      }
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + m * kTK + 4 * st);
        const float xf[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < RN; ++r) acc[m][r] = fmaf(xf[j], w[r][j], acc[m][r]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring

  // the parts' sums through shared memory [kKP][TM][kTN], added in part
  // order by all threads, 4 outputs a float4
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int m = 0; m < TM; ++m)
    if (m < rows)
#pragma unroll
      for (int r = 0; r < RN; ++r) red[(part * TM + m) * kTN + ln + R::kLanes * r] = acc[m][r];
  __syncthreads();
  const int tiles = gridDim.x * gridDim.y;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const float4* red4 = reinterpret_cast<const float4*>(red);
  const int n4 = rows * (kTN / 4);
  float4* part4 = reinterpret_cast<float4*>(ws) + ((size_t)split * tiles + tile) * (R::kTile / 4);
  for (int i = tid; i < n4; i += kF32RingThreads) {
    float4 sum = red4[i];
#pragma unroll
    for (int p = 1; p < R::kKP; ++p) add4(sum, red4[p * (R::kTile / 4) + i]);
    if (splits > 1) {
      part4[i] = sum;  // the partial tile [TM][kTN] at ws[split][tile]
    } else {
      float* row = out + (size_t)(m0 + i / (kTN / 4)) * N;
      const int n = n0 + (i % (kTN / 4)) * 4;
      if (n < N) row[n] = sum.x;
      if (n + 1 < N) row[n + 1] = sum.y;
      if (n + 2 < N) row[n + 2] = sum.z;
      if (n + 3 < N) row[n + 3] = sum.w;
    }
  }
  if (splits == 1) return;
  // the block's stores, then one thread's fence and ticket (as the bf16 ring)
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    ticket = atomicAdd(counters + tile, 1);
    __threadfence();
  }
  __syncthreads();
  if (ticket != splits - 1) return;
  // the last block: the tile's sums over the splits in order 0..S-1, kRedU
  // float4 a thread at a time, the partials of kRedA splits loaded first
  constexpr int U = R::kRedU;
  constexpr int A = R::kRedA;
  const float4* w4 = reinterpret_cast<const float4*>(ws) + (size_t)tile * (R::kTile / 4);
  const size_t step4 = (size_t)tiles * (R::kTile / 4);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i0 = tid; i0 < n4; i0 += U * kF32RingThreads) {
    float4 sum[U];
#pragma unroll
    for (int u = 0; u < U; ++u) sum[u] = zero4;
    int s = 0;
    for (; s + A <= splits; s += A) {
      float4 v[A][U];
#pragma unroll
      for (int a = 0; a < A; ++a)
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = i0 + u * kF32RingThreads;
          v[a][u] = i < n4 ? __ldcg(w4 + (s + a) * step4 + i) : zero4;
        }
#pragma unroll
      for (int a = 0; a < A; ++a)
#pragma unroll
        for (int u = 0; u < U; ++u) add4(sum[u], v[a][u]);
    }
    for (; s < splits; ++s) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * kF32RingThreads;
        if (i < n4) add4(sum[u], __ldcg(w4 + s * step4 + i));
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * kF32RingThreads;
      if (i < n4) {
        float* row = out + (size_t)(m0 + i / (kTN / 4)) * N;
        const int n = n0 + (i % (kTN / 4)) * 4;
        if (n < N) row[n] = sum[u].x;
        if (n + 1 < N) row[n + 1] = sum[u].y;
        if (n + 2 < N) row[n + 2] = sum[u].z;
        if (n + 3 < N) row[n + 3] = sum[u].w;
      }
    }
  }
  if (tid == 0) counters[tile] = 0;
}

template <int TM>
cudaError_t launch_ring_f32(const float* x, const uint8_t* q, const float* s,
                            const float* b, float* out, float* ws, int* counters, int M,
                            int K, int N, int gs, int k_splits, int k_unit, int sb_groups,
                            cudaStream_t stream) {
  using R = RingF32<TM>;
  static bool smem_set[kMaxDevices] = {};  // the attribute, once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(ring_f32_kernel<TM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               R::kSmem + sb_bytes(kSbGroupsMax));
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kTN - 1) / kTN, (M + TM - 1) / TM, k_splits);
  cfg.blockDim = dim3(kF32RingThreads);
  cfg.dynamicSmemBytes = R::kSmem + sb_bytes(sb_groups);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ring_f32_kernel<TM>, x, q, s, b, out, ws, counters, M, K,
                           N, gs, k_unit, sb_groups);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// One launch of kernel B as planned by ops/dequant_matmul.py::plan_kernel_b:
// m_frags = 0 takes the simple path; m_frags in {1, 2, 3, 4, 8, 16} the
// ring path, with k_splits splits of K in units of k_unit, each holding at
// most sb_groups groups (ws: k_splits * tiles * 8 * m_frags * 64 floats,
// and counters: one zeroed int per (N, M) tile, when k_splits > 1). Returns the CUDA error of the launch (0 =
// launched).
extern "C" int dequant_matmul_bf16(const void* x, const void* q,
                                   const void* scale, const void* bias,
                                   void* out, void* ws, void* counters, int M,
                                   int K, int N, int gs, int m_frags,
                                   int k_splits, int k_unit, int sb_groups,
                                   void* stream) {
  auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* qp = static_cast<const uint8_t*>(q);
  auto* sp = static_cast<const float*>(scale);
  auto* bp = static_cast<const float*>(bias);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* wp = static_cast<float*>(ws);
  auto* cp = static_cast<int*>(counters);
  auto st = static_cast<cudaStream_t>(stream);
  if (m_frags == 0)
    return static_cast<int>(
        M <= 16 ? launch_simple<16>(xp, qp, sp, bp, op, M, K, N, gs, st)
                : launch_simple<64>(xp, qp, sp, bp, op, M, K, N, gs, st));
#define RING_CASE(NF)                                                       \
  if (m_frags == NF)                                                        \
    return static_cast<int>(launch_ring<NF>(                                \
        xp, qp, sp, bp, op, wp, cp, M, K, N, gs, k_splits, k_unit, sb_groups, st));
  RING_CASE(1)
  RING_CASE(2)
  RING_CASE(3)
  RING_CASE(4)
  RING_CASE(8)
  RING_CASE(16)
#undef RING_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Kernel B at float32 x and out (the f32 instance), with the bf16 entry's
// arguments, as plan_kernel_b plans it with f32: rows = 0 takes the simple
// f32 kernel (the workspace and counters unused); rows in {1, 2, 4, 8, 16,
// 32, 64} the f32 ring, rows of M a block, with k_splits splits of K in
// units of k_unit, each holding at most sb_groups groups (ws: k_splits *
// tiles * rows * 64 floats and one zeroed counter per (N, M) tile when
// k_splits > 1).
extern "C" int dequant_matmul_f32(const void* x, const void* q,
                                  const void* scale, const void* bias,
                                  void* out, void* ws, void* counters, int M,
                                  int K, int N, int gs, int rows,
                                  int k_splits, int k_unit, int sb_groups,
                                  void* stream) {
  auto* xp = static_cast<const float*>(x);
  auto* qp = static_cast<const uint8_t*>(q);
  auto* sp = static_cast<const float*>(scale);
  auto* bp = static_cast<const float*>(bias);
  auto* op = static_cast<float*>(out);
  auto* wp = static_cast<float*>(ws);
  auto* cp = static_cast<int*>(counters);
  auto st = static_cast<cudaStream_t>(stream);
  if (rows == 0)
    return static_cast<int>(M <= 4 ? launch_f32<4>(xp, qp, sp, bp, op, M, K, N, gs, st)
                                   : launch_f32<16>(xp, qp, sp, bp, op, M, K, N, gs, st));
  // what the ring path takes (the plan sends nothing else)
  if (K % kTK || gs % 16 || k_unit <= 0 || k_unit % kTK || k_unit % gs || K % k_unit ||
      k_splits < 1 || k_splits > K / k_unit || sb_groups < 1 || sb_groups > kSbGroupsMax ||
      (K / k_unit + k_splits - 1) / k_splits * (k_unit / gs) > sb_groups ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(q)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
#define RING_CASE(TM)                                                                  \
  if (rows == TM)                                                                      \
    return static_cast<int>(launch_ring_f32<TM>(xp, qp, sp, bp, op, wp, cp, M, K, N, gs, \
                                                k_splits, k_unit, sb_groups, st));
  RING_CASE(1)
  RING_CASE(2)
  RING_CASE(4)
  RING_CASE(8)
  RING_CASE(16)
  RING_CASE(32)
  RING_CASE(64)
#undef RING_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
