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
// version rounds them), rounded to bf16 BEFORE the product, multiplied on the
// tensor cores with f32 accumulation, and the output is rounded to bf16.
//
// Bound on this card: device-memory bytes at decode and at short prefills.
// Each weight costs 1.125 bytes at gs = 64 (u8 code plus the f32 scale and
// bias of its group); the product does 2*M operations per weight, so below
// M of about 300 rows the bytes are the limit.
//
// Design for that bound: the weight crosses device memory once, as u8, and
// its bf16 copy exists only in shared memory. One block of 4 warps owns a
// TM x 64 tile of the output; for each 64-wide slice of K it stages the x
// tile and the dequantized [64 x 64] weight tile in shared memory, and each
// warp multiplies its 16 output columns with nvcuda::wmma (16x16x16 bf16
// fragments, f32 accumulators in registers). TM = 16 when M <= 16 (decode),
// else 64. With few blocks in flight the loads' latency, not their bytes,
// sets the time, so when K and gs are multiples of 16 and the codes and
// activations are 16-byte aligned, each thread fetches its 16-code pieces
// (one group each) and 8-activation pieces with single 16-byte loads, and
// fetches the next K slice's codes into registers before the current
// slice's products. Edges in M, N and K are
// masked with zeros, so any N and any gs that divides K are taken.
// Grid: (ceil(N / 64), ceil(M / TM)).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int TN = 64;         // output columns per block (16 per warp)
constexpr int TK = 64;         // K slice staged per step
constexpr int LDS = TK + 8;    // bf16 row stride: 144 bytes keeps fragments 32-byte aligned
constexpr int LDO = TN + 4;    // f32 row stride of the output staging tile
constexpr int kThreads = 128;  // 4 warps

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
__global__ void __launch_bounds__(kThreads) dequant_matmul_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
    const float* __restrict__ scale, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ out, int M, int K, int N, int gs) {
  __shared__ __align__(32) __nv_bfloat16 xs[TM * LDS];
  __shared__ __align__(32) __nv_bfloat16 ws[TN * LDS];
  __shared__ __align__(32) float os[TM * LDO];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TN;
  const int G = K / gs;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  // VEC: thread -> weight rows tid/4 and tid/4 + 32, 16-code piece tid%4
  constexpr int kPieces = TN * TK / 16 / kThreads;  // 2
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

  for (int k0 = 0; k0 < K; k0 += TK) {
    if (VEC) {  // 8 activations per 16-byte load
      for (int i = tid; i < TM * TK / 8; i += kThreads) {
        const int r = i / (TK / 8);
        const int c = (i % (TK / 8)) * 8;
        const int m = m0 + r;
        const int k = k0 + c;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (m < M && k < K)
          v = *reinterpret_cast<const uint4*>(x + (size_t)m * K + k);
        *reinterpret_cast<uint4*>(xs + r * LDS + c) = v;
      }
    } else {
      for (int i = tid; i < TM * TK; i += kThreads) {
        const int r = i / TK;
        const int c = i % TK;
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
      for (int i = tid; i < TN * TK; i += kThreads) {
        const int r = i / TK;
        const int c = i % TK;
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
    if (VEC && k0 + TK < K) fetch(k0 + TK);  // in flight during the products
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
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
  for (int i = tid; i < TM * TN; i += kThreads) {
    const int r = i / TN;
    const int c = i % TN;
    const int m = m0 + r;
    const int n = n0 + c;
    if (m < M && n < N) out[(size_t)m * N + n] = __float2bfloat16(os[r * LDO + c]);
  }
}

template <int TM>
void launch(const __nv_bfloat16* x, const uint8_t* q, const float* s,
            const float* b, __nv_bfloat16* out, int M, int K, int N, int gs,
            cudaStream_t stream) {
  const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
  const bool vec = K % 16 == 0 && gs % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (vec)
    dequant_matmul_kernel<TM, true><<<grid, kThreads, 0, stream>>>(
        x, q, s, b, out, M, K, N, gs);
  else
    dequant_matmul_kernel<TM, false><<<grid, kThreads, 0, stream>>>(
        x, q, s, b, out, M, K, N, gs);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int dequant_matmul_bf16(const void* x, const void* q,
                                   const void* scale, const void* bias,
                                   void* out, int M, int K, int N, int gs,
                                   void* stream) {
  auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* qp = static_cast<const uint8_t*>(q);
  auto* sp = static_cast<const float*>(scale);
  auto* bp = static_cast<const float*>(bias);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (M <= 16)
    launch<16>(xp, qp, sp, bp, op, M, K, N, gs, st);
  else
    launch<64>(xp, qp, sp, bp, op, M, K, N, gs, st);
  return static_cast<int>(cudaGetLastError());
}
