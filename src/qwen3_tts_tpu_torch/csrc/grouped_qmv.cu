// Grouped-layout int8 weight-only matmul for decode (kernel A).
//
// Replaces the TPU kernel qwen3_tts_tpu/ops/grouped_qmv.py::_qmv_grouped_kernel
// (launched by _qmv_2d, wrapper quantized_matmul_grouped). Same function:
//
//   out[m, n] = sum_g sg[g, n] * (x[m, g*gs:(g+1)*gs] . qg[g, :, n])
//             + sum_g bg[g, n] * xsum[m, g]
//
// x [M, K] bf16, qg [G, gs, N] uint8, sg/bg [G, N] f32, out [M, N] bf16.
// The u8 code widens to the activation type (exact), each product is exact in
// f32, the per-group partial sum, the affine step and the accumulator are f32,
// and the output is rounded to bf16. No dequantized weight is ever formed.
//
// Bound on this card: device-memory bytes. At decode (M <= 32) every weight
// byte is used for M multiply-adds, far below the ~295 operations per byte
// where Hopper's compute becomes the limit; the weights cost 1.125 bytes
// each at gs = 64 (u8 code plus the f32 scale and bias of its group).
//
// Design for that bound: one block owns 32 output columns. Within a block,
// 8 threads side by side take 4 neighbouring columns each (one 4-byte load
// per row, 32 contiguous bytes per row for the 8), and 32 threads split the
// groups of K, so a warp reads whole 32-byte sectors of 4 groups at once and
// every weight byte is read from device memory exactly once. Each thread
// issues its group's rows 16 loads at a time into registers before using
// them, since at one row per block the loads' latency, not their bytes,
// sets the time.
// The x rows of the current K range are staged in shared memory (bf16,
// exact) and read as broadcasts. A thread keeps its group's partial sums and its running
// accumulator in registers and applies scale and bias once per group, like
// the TPU kernel. The 32 group lanes are summed at the end through shared
// memory in a fixed order: no atomics, the result is the same on every run.
// Grid: (ceil(N / 32), ceil(M / MT)); MT = 1 for single-row decode, else 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;                  // output columns per block
constexpr int kQuads = kCols / 4;          // threads across N, 4 columns each
constexpr int kLanes = 32;                 // threads across the groups of K
constexpr int kThreads = kQuads * kLanes;  // 256
constexpr int kChunk = 2048;               // x elements per row staged per pass
constexpr int kMaxRows = 8;                // MT of the multi-row variant
// one pad element per staged group (gs >= 8) keeps the 4 lanes of a warp
// off one bank, so a pass holds at most kChunk * 9 / 8 elements per row;
// the lane-sum buffer reuses the same bytes after the last pass
constexpr int kStageBytes = kMaxRows * (kChunk + kChunk / 8) * 2;
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

template <int MT, bool VEC>
__global__ void __launch_bounds__(kThreads) qmv_grouped_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ qg,
    const float* __restrict__ sg, const float* __restrict__ bg,
    __nv_bfloat16* __restrict__ out, int M, int K, int N, int gs) {
  __shared__ __align__(16) unsigned char smem[kSmemBytes];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);

  const int tid = threadIdx.x;
  const int quad = tid % kQuads;
  const int lane = tid / kQuads;
  const int n0 = blockIdx.x * kCols + quad * 4;
  const int m0 = blockIdx.y * MT;
  const int G = K / gs;
  const int gpp = max(1, kChunk / gs);  // groups staged per pass
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
      __nv_bfloat16 v = __float2bfloat16(0.f);
      if (m0 + m < M) v = x[(size_t)(m0 + m) * K + (size_t)g0 * gs + kk];
      xs[m * rs + (kk / gs) * gstride + kk % gs] = v;
    }
    __syncthreads();

    for (int gl = lane; gl < ng; gl += kLanes) {
      const int g = g0 + gl;
      const uint8_t* qrow = qg + (size_t)g * gs * N;
      const __nv_bfloat16* xg = xs + gl * gstride;
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
            const float xv = __bfloat162float(xg[m * rs + j0 + u]);
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
      out[(size_t)(m0 + m) * N + n] = __float2bfloat16(sum);
  }
}

template <int MT>
void launch(const __nv_bfloat16* x, const uint8_t* qg, const float* sg,
            const float* bg, __nv_bfloat16* out, int M, int K, int N, int gs,
            cudaStream_t stream) {
  const dim3 grid((N + kCols - 1) / kCols, (M + MT - 1) / MT);
  if (N % 4 == 0 && reinterpret_cast<uintptr_t>(qg) % 4 == 0)
    qmv_grouped_kernel<MT, true><<<grid, kThreads, 0, stream>>>(
        x, qg, sg, bg, out, M, K, N, gs);
  else
    qmv_grouped_kernel<MT, false><<<grid, kThreads, 0, stream>>>(
        x, qg, sg, bg, out, M, K, N, gs);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int qmv_grouped_bf16(const void* x, const void* qg, const void* sg,
                                const void* bg, void* out, int M, int K, int N,
                                int gs, void* stream) {
  auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* qp = static_cast<const uint8_t*>(qg);
  auto* sp = static_cast<const float*>(sg);
  auto* bp = static_cast<const float*>(bg);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (M == 1)
    launch<1>(xp, qp, sp, bp, op, M, K, N, gs, st);
  else
    launch<kMaxRows>(xp, qp, sp, bp, op, M, K, N, gs, st);
  return static_cast<int>(cudaGetLastError());
}
