// Grouped-layout int8 weight-only matmul for decode (kernel A).
//
// Replaces the TPU kernel qwen3_tts_tpu/ops/grouped_qmv.py::_qmv_grouped_kernel
// (launched by _qmv_2d, wrapper quantized_matmul_grouped). Same function:
//
//   out[m, n] = sum_g sg[g, n] * (x[m, g*gs:(g+1)*gs] . qg[g, :, n])
//             + sum_g bg[g, n] * xsum[m, g]
//
// x [M, K] bf16, qg [G, gs, N] uint8 (a [K, N] matrix of codes, n
// contiguous), sg/bg [G, N] f32, out [M, N] bf16. The u8 code widens to f32
// exactly, each product x * code is exact in f32, the per-group partial sum,
// the affine step and the accumulator are f32, and the output is rounded to
// bf16. No dequantized weight is ever formed, so no product needs the tensor
// cores: the arithmetic is f32 FMAs on the CUDA cores.
//
// What bounds it on an H100: device-memory bytes at M <= 64. A code costs
// 1.125 bytes at gs = 64 (the u8 plus its group's f32 scale and bias) and
// M multiply-adds; HBM3's 3.35 TB/s streams a 12 MB weight in ~4 us, which
// needs some 25 KB of loads in flight on each of the 132 SMs, while an
// N = 2048 matrix cut into output tiles gives only 16-64 blocks. At M = 64
// the ~30 T FMA/s of the CUDA cores come close to the limit as well.
//
// The ring path, for K a multiple of 64, gs in {16, 32, 64} (a 64-row slice
// holds whole groups), M <= 64 and 16-byte aligned x:
// - One block owns 128 output columns and ALL M rows, over a range of K, so
//   the weight crosses device memory once at every M. Warps are 8-row bands
//   of M (R = 1, 2, 4 or 8 rows at M <= 8) times kKP parts of each slice's
//   64 k-rows (4 parts of 16 rows at M <= 16, 2 at M <= 32, else 1), and
//   2 or 3 blocks fit an SM (__launch_bounds__ holds ptxas to it). A lane owns
//   4 adjacent columns and reads their 4 codes of a k-row as one 32-bit
//   shared word (the warp reads 128 contiguous bytes: no bank conflict),
//   widens them exactly (2^23 + code as f32, minus 2^23) and FMAs them
//   against x, broadcast from shared memory, into a per-group partial
//   part[R][4]; at the end of a group it adds part * sg + xsum * bg into
//   its running acc[R][4]. xsum[m, g] is summed once per block from global
//   x, whose loads are issued before the ring's first copies.
// - Split-K. The host plan (ops/grouped_qmv.py::plan_kernel_a) cuts K into
//   k_splits ranges of whole slices, as many as fill the SMs in the fewest
//   waves. Grid
//   (ceil(N / 128), k_splits). The block sums its kKP parts in a fixed order
//   through shared memory; with more than one split it writes its f32
//   partial tile to a workspace [k_splits][tiles][TM][128], and the block
//   that draws the tile's last ticket sums the partials in split order
//   0..S-1, rounds to bf16 and resets the counter (kernel B's scheme, with
//   one acq_rel atomic for the ticket in place of two fences): one launch
//   a call, results that repeat bit for bit.
// - A ring of kStages slices in dynamic shared memory, filled by 16-byte
//   cp.async.cg copies of the [64 x 128] codes and the block's x rows; the
//   split's scale/bias columns are copied once, in the first group.
// - Ragged N (the codec head, N = 2051) or an unaligned qg: a code row
//   starts at any byte, so each row is copied as its 16-byte-aligned-down
//   window plus 16 more bytes (144 bytes), and a lane shifts its word out of
//   two aligned words (__funnelshift_r) by the row's own offset.
// - Programmatic dependent launch, as kernel B: blocks are scheduled while
//   the kernel before finishes, and wait for it before touching memory.
//
// The simple path (this kernel's first design) takes every other shape: K
// not a multiple of 64, gs not in {16, 32, 64}, unaligned x. One block owns
// 32 output columns and 1 or 8 rows of M; 8 threads across N (4 columns
// each) times 32 lanes over the groups of K, summed through shared memory
// in a fixed order.
//
// The float32 instance (entry qmv_grouped_f32, for float32 models: the
// reference computes in x.dtype) is the same two paths with f32 x and out:
// the same f32 products and sums, no rounding at the end. The ring's x
// rows are 256 bytes (kXRow = 64 * sizeof(T)), so a 64-row stage holds
// 16 KB of x beside 8-9 KB of codes, and xsum is summed from f32 x. The
// host plan sends the same shapes to the ring at either type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

// ---------------------------------------------------------------- ring path

constexpr int kTN = 128;         // output columns a block (4 a lane)
constexpr int kTK = 64;          // K of one ring slice (whole groups)
constexpr int kSbGroupsMax = 64; // groups of one split (the plan keeps to it)
constexpr int kMaxDevices = 64;

// One instance: activation type T (bf16 or f32), BANDS bands of R rows of
// M (R < 8 only with one band).
template <typename T, int R, int BANDS, bool RAGGED>
struct Ring {
  static constexpr int kXRow = kTK * static_cast<int>(sizeof(T));  // bytes of a staged x row
  // parts of each slice's 64 k-rows, one warp per (band, part)
  static constexpr int kKP = BANDS <= 2 ? 4 : BANDS <= 4 ? 2 : 1;
  static constexpr int kThreads = 32 * BANDS * kKP;
  static constexpr int kRows = R * BANDS;  // rows of M a block covers (TM)
  static constexpr int kC = kTK / kKP;     // k-rows of a slice per warp
  static constexpr int kStages = kRows <= 8 ? 6 : 4;
  // 16-byte copies a code row: 8, or 9 for the aligned-down window
  static constexpr int kChunks = kTN / 16 + (RAGGED ? 1 : 0);
  static constexpr int kQRow = 16 * kChunks;
  static constexpr int kQBytes = kTK * kQRow;
  static constexpr int kStageBytes = kQBytes + kRows * kXRow;
  static constexpr int kXChunks = kXRow / 16;  // 16-byte copies an x row
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kTile = kRows * kTN;  // floats of a partial tile
  // blocks an SM holds: ptxas keeps the registers to it, the host plan
  // (ops/grouped_qmv.py::blocks_per_sm) counts on it
  static constexpr int kMinBlocks = BANDS == 1 ? 3 : 2;
  // the last block's reduction: float4 a thread per batch, splits a batch
  static constexpr int kRedU = kRows * (kTN / 4) >= kThreads ? kRows * (kTN / 4) / kThreads : 1;
  static constexpr int kRedA = 16 / kRedU > 0 ? 16 / kRedU : 1;
  static_assert(kKP * kTile * 4 <= kRing, "the part sums reuse the ring");
};

// Shared memory after the ring: scale and bias [2][groups][kTN] floats, then
// xsum [groups][rows].
__host__ __device__ constexpr int table_bytes(int groups, int rows) {
  return groups * (2 * kTN + rows) * 4;
}

__device__ __forceinline__ float widen(unsigned word, int c) {
  return __uint_as_float(__byte_perm(word, 0x4b000000u, 0x7540 | c)) - 8388608.f;
}

__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

// Adds the activations of 16 bytes of x to sum, in k order.
__device__ __forceinline__ void add_x16(const __nv_bfloat16*, float& sum, const uint4& v) {
  sum += bf16_lo(v.x);
  sum += bf16_hi(v.x);
  sum += bf16_lo(v.y);
  sum += bf16_hi(v.y);
  sum += bf16_lo(v.z);
  sum += bf16_hi(v.z);
  sum += bf16_lo(v.w);
  sum += bf16_hi(v.w);
}
__device__ __forceinline__ void add_x16(const float*, float& sum, const uint4& v) {
  sum += __uint_as_float(v.x);
  sum += __uint_as_float(v.y);
  sum += __uint_as_float(v.z);
  sum += __uint_as_float(v.w);
}

// The 4 codes of a lane in a staged code row. RAGGED: the row is the
// aligned-down window of a row that starts sh = qlow & 15 bytes into it.
template <bool RAGGED>
__device__ __forceinline__ unsigned code_word(const uint8_t* row, int lane,
                                              unsigned qlow) {
  if (!RAGGED) return *reinterpret_cast<const unsigned*>(row + 4 * lane);
  const uint8_t* p = row + (qlow & 12u) + 4 * lane;
  const unsigned lo = *reinterpret_cast<const unsigned*>(p);
  const unsigned hi = *reinterpret_cast<const unsigned*>(p + 4);
  return __funnelshift_r(lo, hi, 8 * (qlow & 3u));
}

// 8 k-rows into part, 4 at a time: q is the first staged code row, xs the
// band's first x row at the same k, qlow the low address bits of the first
// row's start (each next row starts N bytes later). Each part[r][e] takes
// its 8 products in k order at either type; bf16 reads the 4 activations
// of every row first, f32 (twice the registers a row) reads one
// activation a row for each k-row, which keeps its 256-thread instances
// within 128 registers (a float2 of 2 k-rows spilled at 8 rows a band).
template <typename T, int R, int QROW, int XROW, bool RAGGED>
__device__ __forceinline__ void step8(float (&part)[R][4], const uint8_t* q,
                                      const uint8_t* xs, int lane,
                                      unsigned qlow, unsigned N) {
#pragma unroll
  for (int h = 0; h < 8; h += 4) {
    unsigned w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = code_word<RAGGED>(q + (h + j) * QROW, lane, qlow + (h + j) * N);
    const uint8_t* xh = xs + h * static_cast<int>(sizeof(T));
    if constexpr (sizeof(T) == 2) {
      uint2 xv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) xv[r] = *reinterpret_cast<const uint2*>(xh + r * XROW);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float c[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) c[e] = widen(w[j], e);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const unsigned xw = j < 2 ? xv[r].x : xv[r].y;
          const float xf = (j & 1) ? bf16_hi(xw) : bf16_lo(xw);
#pragma unroll
          for (int e = 0; e < 4; ++e) part[r][e] = fmaf(xf, c[e], part[r][e]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float c[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) c[e] = widen(w[j], e);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float xf = *reinterpret_cast<const float*>(xh + r * XROW + 4 * j);
#pragma unroll
          for (int e = 0; e < 4; ++e) part[r][e] = fmaf(xf, c[e], part[r][e]);
        }
      }
    }
  }
}

// 4 outputs of a row at columns n..n+3 (those < N), rounded to bf16 or not.
__device__ __forceinline__ void store4(__nv_bfloat16* row, int n, int N,
                                       const float4& v) {
  if (n < N) row[n] = __float2bfloat16_rn(v.x);
  if (n + 1 < N) row[n + 1] = __float2bfloat16_rn(v.y);
  if (n + 2 < N) row[n + 2] = __float2bfloat16_rn(v.z);
  if (n + 3 < N) row[n + 3] = __float2bfloat16_rn(v.w);
}
__device__ __forceinline__ void store4(float* row, int n, int N, const float4& v) {
  if (n < N) row[n] = v.x;
  if (n + 1 < N) row[n + 1] = v.y;
  if (n + 2 < N) row[n + 2] = v.z;
  if (n + 3 < N) row[n + 3] = v.w;
}

template <typename T, int R, int BANDS, bool RAGGED>
__global__ void __launch_bounds__(Ring<T, R, BANDS, RAGGED>::kThreads,
                                  Ring<T, R, BANDS, RAGGED>::kMinBlocks) ring_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ qg,
    const float* __restrict__ sg, const float* __restrict__ bg,
    T* __restrict__ out, float* __restrict__ ws,
    int* __restrict__ counters, int M, int K, int N, int gs, int sb_groups) {
  using P = Ring<T, R, BANDS, RAGGED>;
  constexpr int kXRow = P::kXRow;
  constexpr int kXElems = 16 / static_cast<int>(sizeof(T));  // x elements a 16-byte copy
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int ticket;

  // Launched with programmatic stream serialization: touch global memory
  // only once the kernel before has finished.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int band = warp % BANDS;
  const int kp = warp / BANDS;
  const int n0 = blockIdx.x * kTN;
  const int ncols = min(kTN, N - n0);
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int units = K / kTK;
  const int kb = static_cast<int>(static_cast<long long>(split) * units / splits) * kTK;
  const int ke = static_cast<int>(static_cast<long long>(split + 1) * units / splits) * kTK;
  const int slices = (ke - kb) / kTK;
  const int gspan = (ke - kb) / gs;  // groups of this split
  const int g0 = kb / gs;
  const int rows = M;                // <= P::kRows (the plan)
  const int band_rows = min(R, rows - band * R);  // may be <= 0: idle band
  float* sbt = reinterpret_cast<float*>(smem + P::kRing);  // [2][sb_groups][kTN]
  float* xst = sbt + 2 * sb_groups * kTN;                  // [sb_groups][kRows]
  const uintptr_t qbase = reinterpret_cast<uintptr_t>(qg) + n0;

  // One slice: 64 code rows of the block's columns (only chunks that start
  // before the tile's last column), and the x rows < M. Chunks not copied
  // reach only outputs that are never stored.
  auto load = [&](int stage, int s) {
    uint8_t* base = smem + stage * P::kStageBytes;
    const int k0 = kb + s * kTK;
    for (int i = tid; i < kTK * P::kChunks; i += P::kThreads) {
      const int row = i / P::kChunks;
      const int c = i - row * P::kChunks;
      const uintptr_t a = qbase + static_cast<size_t>(k0 + row) * N;
      const uintptr_t src = (RAGGED ? a & ~uintptr_t(15) : a) + 16 * c;
      if (src < a + ncols)
        cp_async16(base + row * P::kQRow + 16 * c, reinterpret_cast<const void*>(src));
    }
    uint8_t* xs = base + P::kQBytes;
    for (int i = tid; i < rows * P::kXChunks; i += P::kThreads) {
      const int m = i / P::kXChunks;
      const int c = i - m * P::kXChunks;
      cp_async16(xs + m * kXRow + 16 * c, x + static_cast<size_t>(m) * K + k0 + kXElems * c);
    }
  };

  // xsum[m, g] of the split's groups comes from global x (in L2: the kernel
  // before wrote it). A thread's first (m, g) is loaded before any copy is
  // issued, so that it returns ahead of the slices instead of behind them,
  // and summed (k in order: the same sums in every block and run) once the
  // copies are on their way.
  uint4 xu[kTK / kXElems];  // gs <= kTK
  auto xsum_load = [&](int i) {
    const int g = i / rows;
    const int m = i - g * rows;
    const uint4* src = reinterpret_cast<const uint4*>(
        x + static_cast<size_t>(m) * K + kb + g * gs);
#pragma unroll
    for (int v = 0; v < kTK / kXElems; ++v)
      if (v < gs / kXElems) xu[v] = src[v];
  };
  auto xsum_store = [&](int i) {
    float sum = 0.f;
#pragma unroll
    for (int v = 0; v < kTK / kXElems; ++v)
      if (v < gs / kXElems) add_x16(x, sum, xu[v]);
    const int g = i / rows;
    xst[g * P::kRows + i - g * rows] = sum;
  };
  const int xsum_items = gspan * rows;
  if (tid < xsum_items) xsum_load(tid);

  // The first group of copies: slice 0 and the split's scale/bias columns;
  // then one group for each of slices 1 .. kStages - 2.
  if (slices > 0) load(0, 0);
  if (!RAGGED) {  // 16-byte rows of 4 columns (N % 16 == 0, aligned sg, bg)
    for (int i = tid; i < 2 * gspan * (kTN / 4); i += P::kThreads) {
      const int row = i / (kTN / 4);
      const int c = 4 * (i % (kTN / 4));
      const bool bias = row >= gspan;
      const int g = bias ? row - gspan : row;
      if (c < ncols)
        cp_async16(sbt + ((bias ? sb_groups : 0) + g) * kTN + c,
                   (bias ? bg : sg) + static_cast<size_t>(g0 + g) * N + n0 + c);
    }
  } else {
    for (int i = tid; i < 2 * gspan * kTN; i += P::kThreads) {
      const int row = i / kTN;
      const int c = i % kTN;
      const bool bias = row >= gspan;
      const int g = bias ? row - gspan : row;
      if (c < ncols)
        cp_async4(sbt + ((bias ? sb_groups : 0) + g) * kTN + c,
                  (bias ? bg : sg) + static_cast<size_t>(g0 + g) * N + n0 + c);
    }
  }
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < P::kStages - 1; ++s) {
    if (s < slices) load(s, s);
    cp_async_commit();
  }

  for (int i = tid; i < xsum_items; i += P::kThreads) {
    if (i != tid) xsum_load(i);
    xsum_store(i);
  }

  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;

  // a warp's k-rows of a slice, in runs that lie inside one group
  const int run = min(P::kC, gs);
  for (int i = 0; i < slices; ++i) {
    cp_async_wait<P::kStages - 2>();  // slice i has landed ...
    __syncthreads();  // ... for every thread, and slice i - 1's stage is free
    const int next = i + P::kStages - 1;
    if (next < slices) load(next % P::kStages, next);
    cp_async_commit();
    if (band_rows <= 0) continue;  // warp-uniform: a band past M

    const uint8_t* base = smem + (i % P::kStages) * P::kStageBytes;
    const int kw = kp * P::kC;  // the warp's first k-row in the slice
    for (int u0 = kw; u0 < kw + P::kC; u0 += run) {
      float part[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[r][e] = 0.f;
      for (int j0 = u0; j0 < u0 + run; j0 += 8) {
        const unsigned qlow = static_cast<unsigned>(qbase) +
                              static_cast<unsigned>(kb + i * kTK + j0) * static_cast<unsigned>(N);
        step8<T, R, P::kQRow, kXRow, RAGGED>(
            part, base + j0 * P::kQRow,
            base + P::kQBytes + band * R * kXRow + j0 * static_cast<int>(sizeof(T)), lane,
            qlow, static_cast<unsigned>(N));
      }
      // the group's affine step; xsum * bias once per group, by the warp
      // whose run starts it
      const int kl = i * kTK + u0;  // from the split's first k
      const int gi = kl / gs;
      const float4 s4 = *reinterpret_cast<const float4*>(sbt + gi * kTN + 4 * lane);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[r][0] = fmaf(part[r][0], s4.x, acc[r][0]);
        acc[r][1] = fmaf(part[r][1], s4.y, acc[r][1]);
        acc[r][2] = fmaf(part[r][2], s4.z, acc[r][2]);
        acc[r][3] = fmaf(part[r][3], s4.w, acc[r][3]);
      }
      if (kl == gi * gs) {
        const float4 b4 =
            *reinterpret_cast<const float4*>(sbt + (sb_groups + gi) * kTN + 4 * lane);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float xs = xst[gi * P::kRows + band * R + r];
          acc[r][0] = fmaf(xs, b4.x, acc[r][0]);
          acc[r][1] = fmaf(xs, b4.y, acc[r][1]);
          acc[r][2] = fmaf(xs, b4.z, acc[r][2]);
          acc[r][3] = fmaf(xs, b4.w, acc[r][3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring

  // the block's kKP parts, [kKP][kRows][kTN], summed in part order
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (r < band_rows)
      *reinterpret_cast<float4*>(red + (kp * P::kRows + band * R + r) * kTN + 4 * lane) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  const float4* red4 = reinterpret_cast<const float4*>(red);
  const int n4 = rows * (kTN / 4);
  auto block_sum = [&](int i) {
    float4 sum = red4[i];
#pragma unroll
    for (int p = 1; p < P::kKP; ++p) add4(sum, red4[p * (P::kTile / 4) + i]);
    return sum;
  };
  if (splits == 1) {
    for (int i = tid; i < n4; i += P::kThreads)
      store4(out + static_cast<size_t>(i >> 5) * N, n0 + 4 * (i & 31), N, block_sum(i));
    return;
  }
  const int tiles = gridDim.x;
  const int tile = blockIdx.x;
  float4* part4 = reinterpret_cast<float4*>(ws) +
                  (static_cast<size_t>(split) * tiles + tile) * (P::kTile / 4);
  for (int i = tid; i < n4; i += P::kThreads) part4[i] = block_sum(i);
  // the block's stores, then one thread's ticket
  __syncthreads();
  if (tid == 0) {  // release of the block's partials, acquire of the others'
    int t;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(t) : "l"(counters + tile) : "memory");
    ticket = t;
  }
  __syncthreads();
  if (ticket != splits - 1) return;
  // the last block: the tile's sums over the splits in order 0..S-1, kRedU
  // float4 a thread at a time, the partials of kRedA splits loaded before
  // they are added
  constexpr int U = P::kRedU;
  constexpr int A = P::kRedA;
  const float4* w4 = reinterpret_cast<const float4*>(ws) +
                     static_cast<size_t>(tile) * (P::kTile / 4);
  const size_t step4 = static_cast<size_t>(tiles) * (P::kTile / 4);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i0 = tid; i0 < n4; i0 += U * P::kThreads) {
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
          const int i = i0 + u * P::kThreads;
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
        const int i = i0 + u * P::kThreads;
        if (i < n4) add4(sum[u], __ldcg(w4 + s * step4 + i));
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * P::kThreads;
      if (i < n4)
        store4(out + static_cast<size_t>(i >> 5) * N, n0 + 4 * (i & 31), N, sum[u]);
    }
  }
  if (tid == 0) counters[tile] = 0;
}

template <typename T, int R, int BANDS, bool RAGGED>
cudaError_t launch_ring(const T* x, const uint8_t* qg, const float* sg,
                        const float* bg, T* out, float* ws,
                        int* counters, int M, int K, int N, int gs, int k_splits,
                        int sb_groups, cudaStream_t stream) {
  using P = Ring<T, R, BANDS, RAGGED>;
  static bool smem_set[kMaxDevices] = {};  // the attribute, once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(ring_kernel<T, R, BANDS, RAGGED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               P::kRing + table_bytes(kSbGroupsMax, P::kRows));
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kTN - 1) / kTN, k_splits);
  cfg.blockDim = dim3(P::kThreads);
  cfg.dynamicSmemBytes = P::kRing + table_bytes(sb_groups, P::kRows);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ring_kernel<T, R, BANDS, RAGGED>, x, qg, sg, bg, out,
                           ws, counters, M, K, N, gs, sb_groups);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int R, int BANDS>
cudaError_t launch_ring_any(bool ragged, const T* x, const uint8_t* qg,
                            const float* sg, const float* bg, T* out,
                            float* ws, int* counters, int M, int K, int N, int gs,
                            int k_splits, int sb_groups, cudaStream_t stream) {
  if (M > R * BANDS) return cudaErrorInvalidValue;
  return ragged ? launch_ring<T, R, BANDS, true>(x, qg, sg, bg, out, ws, counters, M,
                                                 K, N, gs, k_splits, sb_groups, stream)
                : launch_ring<T, R, BANDS, false>(x, qg, sg, bg, out, ws, counters, M,
                                                  K, N, gs, k_splits, sb_groups, stream);
}

// -------------------------------------------------------------- simple path

constexpr int kCols = 32;                  // output columns per block
constexpr int kQuads = kCols / 4;          // threads across N, 4 columns each
constexpr int kLanes = 32;                 // threads across the groups of K
constexpr int kThreads = kQuads * kLanes;  // 256
constexpr int kChunkBytes = 4096;          // x bytes per row staged per pass
constexpr int kMaxRows = 8;                // MT of the multi-row variant
// x elements of a row staged per pass: 2048 bf16 or 1024 f32 (the largest
// group the simple path takes)
template <typename T>
__host__ __device__ constexpr int chunk_of() {
  return kChunkBytes / static_cast<int>(sizeof(T));
}
// one pad element per staged group (gs >= 8) keeps the 4 lanes of a warp
// off one bank, so a pass holds at most chunk * 9 / 8 elements per row;
// the lane-sum buffer reuses the same bytes after the last pass
constexpr int kStageBytes = kMaxRows * (kChunkBytes + kChunkBytes / 8);
constexpr int kReduceBytes = kLanes * kMaxRows * kCols * 4;
constexpr int kSmemBytes =
    kStageBytes > kReduceBytes ? kStageBytes : kReduceBytes;

constexpr int kBatch = 16;                 // row loads in flight per thread

// The 4 codes of row ``row`` at columns n0..n0+3 as one little-endian word
// (zeros past N).
template <bool VEC>
__device__ __forceinline__ unsigned load_codes(const uint8_t* __restrict__ row,
                                               int n0, int N) {
  if (VEC)  // N % 4 == 0 and 4-byte aligned rows: n0 < N covers all 4
    return n0 < N ? *reinterpret_cast<const unsigned*>(row + n0) : 0u;
  unsigned v = 0u;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (n0 + c < N) v |= unsigned(row[n0 + c]) << (8 * c);
  return v;
}

// The activation type T of the simple path: bf16, or f32 (the float32
// instance; its products, sums and output stay f32).
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// (a minimum of 1 block per SM: with ptxas' default cap of 128 registers
// the 8-row instance spilled)
template <typename T, int MT, bool VEC>
__global__ void __launch_bounds__(kThreads, 1) qmv_grouped_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ qg,
    const float* __restrict__ sg, const float* __restrict__ bg,
    T* __restrict__ out, int M, int K, int N, int gs) {
  __shared__ __align__(16) unsigned char smem[kSmemBytes];
  T* xs = reinterpret_cast<T*>(smem);

  const int tid = threadIdx.x;
  const int quad = tid % kQuads;
  const int lane = tid / kQuads;
  const int n0 = blockIdx.x * kCols + quad * 4;
  const int m0 = blockIdx.y * MT;
  const int G = K / gs;
  const int gpp = max(1, chunk_of<T>() / gs);  // groups staged per pass
  const int gstride = gs + (gs >= 8 ? 1 : 0);
  const int rs = gpp * gstride;         // staged row stride (elements)

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  for (int g0 = 0; g0 < G; g0 += gpp) {
    const int ng = min(gpp, G - g0);
    const int span = ng * gs;
    __syncthreads();  // the previous pass has finished reading xs
    for (int i = tid; i < MT * span; i += kThreads) {
      const int m = i / span;
      const int kk = i - m * span;
      T v = from_f32<T>(0.f);
      if (m0 + m < M) v = x[(size_t)(m0 + m) * K + (size_t)g0 * gs + kk];
      xs[m * rs + (kk / gs) * gstride + kk % gs] = v;
    }
    __syncthreads();

    for (int gl = lane; gl < ng; gl += kLanes) {
      const int g = g0 + gl;
      const uint8_t* qrow = qg + (size_t)g * gs * N;
      const T* xg = xs + gl * gstride;
      float part[MT][4];
      float xsum[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        xsum[m] = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) part[m][c] = 0.f;
      }
      for (int j0 = 0; j0 < gs; j0 += kBatch) {
        unsigned wv[kBatch];  // all loads of the batch issued before use
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          wv[u] = (j0 + u < gs)
                      ? load_codes<VEC>(qrow + (size_t)(j0 + u) * N, n0, N)
                      : 0u;
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (j0 + u >= gs) break;
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float xv = to_f32(xg[m * rs + j0 + u]);
            xsum[m] += xv;
#pragma unroll
            for (int c = 0; c < 4; ++c)
              part[m][c] = fmaf(xv, float((wv[u] >> (8 * c)) & 0xffu),
                                part[m][c]);
          }
        }
      }
      float s[4], b[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool in = n0 + c < N;
        s[c] = in ? sg[(size_t)g * N + n0 + c] : 0.f;
        b[c] = in ? bg[(size_t)g * N + n0 + c] : 0.f;
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[m][c] += part[m][c] * s[c] + xsum[m] * b[c];
    }
  }

  // sum the group lanes in a fixed order (deterministic)
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [kLanes][MT][kCols]
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      red[(lane * MT + m) * kCols + quad * 4 + c] = acc[m][c];
  __syncthreads();
  for (int i = tid; i < MT * kCols; i += kThreads) {
    const int m = i / kCols;
    const int col = i - m * kCols;
    float sum = 0.f;
#pragma unroll
    for (int l = 0; l < kLanes; ++l) sum += red[(l * MT + m) * kCols + col];
    const int n = blockIdx.x * kCols + col;
    if (m0 + m < M && n < N)
      out[(size_t)(m0 + m) * N + n] = from_f32<T>(sum);
  }
}

template <typename T, int MT>
cudaError_t launch_simple(const T* x, const uint8_t* qg, const float* sg,
                          const float* bg, T* out, int M, int K, int N,
                          int gs, cudaStream_t stream) {
  if (gs > chunk_of<T>()) return cudaErrorInvalidValue;  // a group per pass at most
  const dim3 grid((N + kCols - 1) / kCols, (M + MT - 1) / MT);
  if (N % 4 == 0 && reinterpret_cast<uintptr_t>(qg) % 4 == 0)
    qmv_grouped_kernel<T, MT, true><<<grid, kThreads, 0, stream>>>(
        x, qg, sg, bg, out, M, K, N, gs);
  else
    qmv_grouped_kernel<T, MT, false><<<grid, kThreads, 0, stream>>>(
        x, qg, sg, bg, out, M, K, N, gs);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_simple_any(const void* x, const void* qg, const void* sg,
                              const void* bg, void* out, int M, int K, int N, int gs,
                              void* stream) {
  auto* xp = static_cast<const T*>(x);
  auto* qp = static_cast<const uint8_t*>(qg);
  auto* sp = static_cast<const float*>(sg);
  auto* bp = static_cast<const float*>(bg);
  auto* op = static_cast<T*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return M == 1 ? launch_simple<T, 1>(xp, qp, sp, bp, op, M, K, N, gs, st)
                : launch_simple<T, kMaxRows>(xp, qp, sp, bp, op, M, K, N, gs, st);
}

// One launch of kernel A at activation type T as planned by
// ops/grouped_qmv.py::plan_kernel_a: bands = 0 takes the simple path;
// (band_rows, bands) in {(1, 1), (2, 1), (4, 1), (8, 1), (8, 2), (8, 3),
// (8, 4), (8, 8)} the ring path, with k_splits splits of K in whole 64-row
// slices, each holding at most sb_groups groups (ws: k_splits * ceil(N /
// 128) * band_rows * bands * 128 floats, and counters: one zeroed int per
// 128-column tile, when k_splits > 1). Returns the CUDA error of the
// launch (0 = launched).
template <typename T>
int qmv_grouped(const void* x, const void* qg, const void* sg, const void* bg,
                void* out, void* ws, void* counters, int M, int K, int N, int gs,
                int band_rows, int bands, int k_splits, int sb_groups, void* stream) {
  if (bands == 0)
    return static_cast<int>(launch_simple_any<T>(x, qg, sg, bg, out, M, K, N, gs, stream));
  auto* xp = static_cast<const T*>(x);
  auto* qp = static_cast<const uint8_t*>(qg);
  auto* sp = static_cast<const float*>(sg);
  auto* bp = static_cast<const float*>(bg);
  auto* op = static_cast<T*>(out);
  auto* wp = static_cast<float*>(ws);
  auto* cp = static_cast<int*>(counters);
  auto st = static_cast<cudaStream_t>(stream);
  // what the ring path takes (the plan sends nothing else)
  if (K % kTK || gs % 16 || kTK % gs || reinterpret_cast<uintptr_t>(x) % 16 ||
      k_splits < 1 || k_splits > K / kTK || sb_groups > kSbGroupsMax ||
      (K / kTK + k_splits - 1) / k_splits * (kTK / gs) > sb_groups)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool ragged =
      N % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(qg) | reinterpret_cast<uintptr_t>(sg) |
       reinterpret_cast<uintptr_t>(bg)) % 16 != 0;
#define RING_CASE(R, B)                                                             \
  if (band_rows == R && bands == B)                                                 \
    return static_cast<int>(launch_ring_any<T, R, B>(ragged, xp, qp, sp, bp, op, wp, \
                                                     cp, M, K, N, gs, k_splits,     \
                                                     sb_groups, st));
  RING_CASE(1, 1)
  RING_CASE(2, 1)
  RING_CASE(4, 1)
  RING_CASE(8, 1)
  RING_CASE(8, 2)
  RING_CASE(8, 3)
  RING_CASE(8, 4)
  RING_CASE(8, 8)
#undef RING_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Kernel A at bf16 x and out.
extern "C" int qmv_grouped_bf16(const void* x, const void* qg, const void* sg,
                                const void* bg, void* out, void* ws,
                                void* counters, int M, int K, int N, int gs,
                                int band_rows, int bands, int k_splits,
                                int sb_groups, void* stream) {
  return qmv_grouped<__nv_bfloat16>(x, qg, sg, bg, out, ws, counters, M, K, N, gs,
                                    band_rows, bands, k_splits, sb_groups, stream);
}

// Kernel A at float32 x and out (the f32 instance), with the bf16 entry's
// arguments and plan; its simple path stages 1024-element x rows (gs <= 1024).
extern "C" int qmv_grouped_f32(const void* x, const void* qg, const void* sg,
                               const void* bg, void* out, void* ws,
                               void* counters, int M, int K, int N, int gs,
                               int band_rows, int bands, int k_splits,
                               int sb_groups, void* stream) {
  return qmv_grouped<float>(x, qg, sg, bg, out, ws, counters, M, K, N, gs, band_rows,
                            bands, k_splits, sb_groups, stream);
}
