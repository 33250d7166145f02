// Decode attention over a bf16 KV cache, one launch a call (kernel C).
//
// Replaces no TPU kernel: the JAX package keeps attention as plain code
// (qwen3_tts_tpu/models/layers.py::attention), and so did the port until the
// host's launches of that code set the pace of decode. This kernel does, in
// one launch, everything models/layers.py::attention does between the q/k/v
// projections and the o projection, for T <= 2 query positions a row:
//
//   1. the per-head RMSNorm of q and k over head_dim (when q_norm is given),
//      in f32, rounded to bf16 (layers.py::rmsnorm);
//   2. rotate-half RoPE from the f32 cos/sin rows, [T, HD/2] shared or
//      [B, T, HD/2] a row, with the plain code's roundings: cos and sin
//      rounded to bf16, each product and the sum rounded to bf16
//      (layers.py::apply_rope);
//   3. the in-place write of the rotated k and of v at rows pos .. pos+T-1,
//      the start clamped to [0, S - T] (layers.py::_write_rows);
//   4. the masked GQA read: query t of the row sits at q_idx = pos + t and
//      reads the keys with pad <= key <= q_idx, or key == q_idx, below the
//      row's window (layers.py::_scores_ctx). Scores are f32 dot products of
//      the bf16 q and k, times head_dim^-0.5; the softmax is f32; the
//      probabilities are rounded to bf16 before the value product, which
//      sums in f32; the output is rounded to bf16, [B, T, H * HD], ready for
//      the o projection.
//
// q, k, v [B, T, *] bf16 with a stride between tokens (a fused qkv product
// is read in place), cache [B, S, H_kv, HD] bf16 with a stride between rows
// (the engine's window views), pos / pad / win int64 [B] or one int each.
//
// What bounds it on an H100: device-memory bytes. A key costs 512 bytes (its
// k and v rows at HD = 128) and 4 * g FLOPs for each of the g query heads
// that share its kv head: about 2 FLOPs a byte at g = 2, far below the
// card's 295. So the design reads only the keys some query of the row may
// attend to (a masked key adds an exact zero, so skipping it is the same
// mathematics over fewer bytes) and reads each of them once:
// - One block a (row, kv head), with the g query heads of that kv head and
//   the T positions together: 64 rows x 8 kv heads = 512 blocks for the
//   talker, no split of the sequence needed. The block writes its own
//   cache rows, then __syncthreads() before it reads the window back: no
//   other block touches its (row, kv head) slice.
// - A ring of kStages tiles of kKT keys in dynamic shared memory, filled
//   by 16-byte cp.async copies: first the k tiles, then the v tiles, in one
//   stream of copies, so the first v tiles load while the softmax runs.
// - Scores: two threads a key, each a half of its 16-byte chunks
//   (interleaved; the padded row keeps a quarter-warp's loads on distinct
//   banks), summed by one shuffle; q is broadcast from shared memory. The
//   scores of the whole read range stay in shared memory, so the softmax
//   normalises exactly before the bf16 rounding, as the plain code does.
// - Values: one thread a dimension, summing the keys in order.
// Every sum has a fixed order, so repeated calls agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kHD = 128;                 // head_dim
constexpr int kThreads = 128;            // one a dimension in the value pass
constexpr int kWarps = kThreads / 32;
constexpr int kKT = kThreads / 2;        // keys a tile (two threads a key)
constexpr int kStages = 3;
constexpr int kRow = kHD + 16;           // bf16 a staged row (288 bytes)
constexpr int kChunks = kHD / 8;         // 16-byte chunks a row
constexpr int kMaxQ = 8;                 // T * g at most
constexpr int kEPL = kHD / 32;           // elements a lane in the prologue
constexpr int kMaxDevices = 64;

constexpr int kRingBytes = kStages * kKT * kRow * 2;
constexpr int kQBytes = kMaxQ * kHD * 4;
constexpr int kRedBytes = kWarps * kMaxQ * 4;

__host__ __device__ constexpr long long smem_bytes(int nq, int max_win) {
  return kRingBytes + kQBytes + kRedBytes + 4ll * nq * max_win;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// A block-wide reduction of one value a thread for each of nq queries, in a
// fixed order (lanes by butterfly, then warps 0..3), the result in every
// thread. red holds kWarps * kMaxQ floats.
template <bool kMax>
__device__ __forceinline__ void block_reduce(float (&v)[kMaxQ], int nq, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kMaxQ; ++i) {
    if (i >= nq) break;
    const float w = kMax ? warp_max(v[i]) : warp_sum(v[i]);
    if (lane == 0) red[warp * kMaxQ + i] = w;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kMaxQ; ++i) {
    if (i >= nq) break;
    float r = red[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      r = kMax ? fmaxf(r, red[w * kMaxQ + i]) : r + red[w * kMaxQ + i];
    v[i] = r;
  }
  __syncthreads();
}

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* q_norm;  // null: no qk norm
  const __nv_bfloat16* k_norm;
  const float* cos;
  const float* sin;
  __nv_bfloat16* cache_k;
  __nv_bfloat16* cache_v;
  const long long* pos;  // null: pos_int for every row
  const long long* pad;  // null: pad_int
  const long long* win;  // null: S for every row
  __nv_bfloat16* out;
  long long q_stride, k_stride, v_stride;  // elements between tokens
  long long cache_stride;                  // elements between cache rows (b)
  int rope_stride;                         // elements between rows' cos (0: shared)
  int T, n_heads, n_kv_heads, S, pos_int, pad_int;
  float eps, scale;
};

__global__ void __launch_bounds__(kThreads) decode_attention_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  auto* qs = reinterpret_cast<float*>(smem + kRingBytes);         // [kMaxQ][kHD]
  auto* red = reinterpret_cast<float*>(smem + kRingBytes + kQBytes);
  auto* sc = reinterpret_cast<float*>(smem + kRingBytes + kQBytes + kRedBytes);

  // programmatic dependent launch: wait for the kernel before (the
  // projections) before touching memory
  asm volatile("griddepcontrol.wait;" ::: "memory");

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = a.T, g = a.n_heads / a.n_kv_heads, nq = T * g;
  const int S = a.S;
  const long long pos = a.pos ? a.pos[b] : a.pos_int;
  const long long pad = a.pad ? a.pad[b] : a.pad_int;
  const long long win = a.win ? min(a.win[b], static_cast<long long>(S)) : S;
  const long long start = min(max(pos, 0ll), static_cast<long long>(S - T));
  __nv_bfloat16* ck = a.cache_k + b * a.cache_stride + h * kHD;  // + key * kv_row
  __nv_bfloat16* cv = a.cache_v + b * a.cache_stride + h * kHD;
  const long long kv_row = static_cast<long long>(a.n_kv_heads) * kHD;

  // ---- prologue: norm and RoPE of the nq query vectors and T keys (a warp
  // a vector, kEPL elements a lane), the cache write of k and v
  for (int vec = warp; vec < nq + 2 * T; vec += kWarps) {
    const bool is_q = vec < nq, is_k = !is_q && vec < nq + T;
    const int t = is_q ? vec / g : is_k ? vec - nq : vec - nq - T;
    const __nv_bfloat16* src =
        is_q ? a.q + (static_cast<long long>(b) * T + t) * a.q_stride + (h * g + vec % g) * kHD
        : is_k ? a.k + (static_cast<long long>(b) * T + t) * a.k_stride + h * kHD
               : a.v + (static_cast<long long>(b) * T + t) * a.v_stride + h * kHD;
    const uint2 raw = *reinterpret_cast<const uint2*>(src + lane * kEPL);
    __align__(8) __nv_bfloat16 e[kEPL];
    *reinterpret_cast<uint2*>(e) = raw;
    if (!is_q && !is_k) {  // v: written as it is
      *reinterpret_cast<uint2*>(cv + (start + t) * kv_row + lane * kEPL) = raw;
      continue;
    }
    float x[kEPL];
#pragma unroll
    for (int i = 0; i < kEPL; ++i) x[i] = __bfloat162float(e[i]);
    const __nv_bfloat16* nw = is_q ? a.q_norm : a.k_norm;
    if (nw) {
      float ss = 0.f;
#pragma unroll
      for (int i = 0; i < kEPL; ++i) ss += x[i] * x[i];
      const float var = warp_sum(ss) / static_cast<float>(kHD);
      const float inv = rsqrtf(var + a.eps);
#pragma unroll
      for (int i = 0; i < kEPL; ++i)
        x[i] = round_bf16(__fmul_rn(__fmul_rn(x[i], inv),
                                    __bfloat162float(nw[lane * kEPL + i])));
    }
    // rotate half: lane l < 16 holds x1[4l..], lane l + 16 the matching x2
    const float* cr = a.cos + static_cast<long long>(b) * a.rope_stride + t * (kHD / 2);
    const float* sr = a.sin + static_cast<long long>(b) * a.rope_stride + t * (kHD / 2);
    const bool first = lane < 16;
#pragma unroll
    for (int i = 0; i < kEPL; ++i) {
      const float other = __shfl_xor_sync(0xffffffffu, x[i], 16);
      const int j = (lane & 15) * kEPL + i;
      const float c = round_bf16(cr[j]), s = round_bf16(sr[j]);
      const float x1 = first ? x[i] : other, x2 = first ? other : x[i];
      x[i] = first ? round_bf16(round_bf16(__fmul_rn(x1, c)) - round_bf16(__fmul_rn(x2, s)))
                   : round_bf16(round_bf16(__fmul_rn(x2, c)) + round_bf16(__fmul_rn(x1, s)));
    }
    if (is_q) {
#pragma unroll
      for (int i = 0; i < kEPL; ++i) qs[vec * kHD + lane * kEPL + i] = x[i];
    } else {
#pragma unroll
      for (int i = 0; i < kEPL; ++i) e[i] = __float2bfloat16(x[i]);
      *reinterpret_cast<uint2*>(ck + (start + t) * kv_row + lane * kEPL) =
          *reinterpret_cast<const uint2*>(e);
    }
  }

  // ---- the keys some query may read: [lo, hi) over the queries' ranges
  long long lo_q[2], hi_q[2];
  long long lo = S, hi = 0;
  for (int t = 0; t < T; ++t) {
    const long long qi = pos + t;
    lo_q[t] = max(qi < pad ? qi : pad, 0ll);
    hi_q[t] = min(qi + 1, win);
    if (lo_q[t] < hi_q[t]) {
      lo = min(lo, lo_q[t]);
      hi = max(hi, hi_q[t]);
    }
  }
  const int n = hi > lo ? static_cast<int>(hi - lo) : 0;
  const int tiles = (n + kKT - 1) / kKT;
  __syncthreads();  // the cache rows written above are read back below

  // tile r < tiles: k rows; tiles <= r < 2 * tiles: v rows
  auto load = [&](int r) {
    if (r < 2 * tiles) {
      const __nv_bfloat16* base = r < tiles ? ck : cv;
      const int r0 = (r < tiles ? r : r - tiles) * kKT;
      __nv_bfloat16* dst = ring + (r % kStages) * kKT * kRow;
#pragma unroll
      for (int m = 0; m < kKT * kChunks / kThreads; ++m) {
        const int c = tid + m * kThreads, key = c / kChunks, part = c % kChunks;
        if (r0 + key < n)
          cp_async16(dst + key * kRow + part * 8, base + (lo + r0 + key) * kv_row + part * 8);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int r = 0; r < kStages - 1; ++r) load(r);

  float acc[kMaxQ];
#pragma unroll
  for (int i = 0; i < kMaxQ; ++i) acc[i] = 0.f;
  const int half = tid & 1, kk = tid >> 1;
  for (int r = 0; r < 2 * tiles; ++r) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const __nv_bfloat16* tile = ring + (r % kStages) * kKT * kRow;
    if (r == tiles) {
      // ---- softmax of each query's scores [0, n), exactly normalised, then
      // rounded to bf16 in place
      float m[kMaxQ], l[kMaxQ];
#pragma unroll
      for (int i = 0; i < kMaxQ; ++i) {
        m[i] = -INFINITY;
        if (i < nq)
          for (int j = tid; j < n; j += kThreads) m[i] = fmaxf(m[i], sc[i * n + j]);
      }
      block_reduce<true>(m, nq, red);
#pragma unroll
      for (int i = 0; i < kMaxQ; ++i) {
        l[i] = 0.f;
        if (i < nq)
          for (int j = tid; j < n; j += kThreads) l[i] += expf(sc[i * n + j] - m[i]);
      }
      block_reduce<false>(l, nq, red);
#pragma unroll
      for (int i = 0; i < kMaxQ; ++i) {
        if (i < nq)
          for (int j = tid; j < n; j += kThreads)
            sc[i * n + j] = round_bf16(expf(sc[i * n + j] - m[i]) / l[i]);
      }
      __syncthreads();
    }
    if (r < tiles) {
      // ---- scores of this tile's keys: two threads a key
      const int key = r * kKT + kk;
      float dot[kMaxQ];
#pragma unroll
      for (int i = 0; i < kMaxQ; ++i) dot[i] = 0.f;
      if (key < n) {
#pragma unroll
        for (int c = 0; c < kChunks / 2; ++c) {
          const int part = 2 * c + half;
          const uint4 raw = *reinterpret_cast<const uint4*>(tile + kk * kRow + part * 8);
          const __nv_bfloat16* kv = reinterpret_cast<const __nv_bfloat16*>(&raw);
          float kf[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) kf[e] = __bfloat162float(kv[e]);
#pragma unroll
          for (int i = 0; i < kMaxQ; ++i) {
            if (i < nq) {
              const float4 q0 = *reinterpret_cast<const float4*>(qs + i * kHD + part * 8);
              const float4 q1 = *reinterpret_cast<const float4*>(qs + i * kHD + part * 8 + 4);
              dot[i] += q0.x * kf[0] + q0.y * kf[1] + q0.z * kf[2] + q0.w * kf[3] +
                        q1.x * kf[4] + q1.y * kf[5] + q1.z * kf[6] + q1.w * kf[7];
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kMaxQ; ++i) {
        if (i < nq) {
          const float d = dot[i] + __shfl_xor_sync(0xffffffffu, dot[i], 1);
          const int t = i / g;
          const long long kidx = lo + key;
          if (half == 0 && key < n)
            sc[i * n + key] = kidx >= lo_q[t] && kidx < hi_q[t] ? d * a.scale : -INFINITY;
        }
      }
    } else {
      // ---- values: thread tid owns dimension tid
      const int r0 = (r - tiles) * kKT;
      const int keys = min(kKT, n - r0);
      for (int j = 0; j < keys; ++j) {
        const float vf = __bfloat162float(tile[j * kRow + tid]);
#pragma unroll
        for (int i = 0; i < kMaxQ; ++i)
          if (i < nq) acc[i] += sc[i * n + r0 + j] * vf;
      }
    }
    load(r + kStages - 1);
  }
  cp_async_wait<0>();

  // ---- the output row of each query head: bf16, [B, T, H * HD]
#pragma unroll
  for (int i = 0; i < kMaxQ; ++i) {
    if (i < nq) {
      const int t = i / g, head = h * g + i % g;
      // an empty range reads 0 / 0, as the plain softmax over no key does
      const float o = n > 0 ? acc[i] : NAN;
      a.out[((static_cast<long long>(b) * T + t) * a.n_heads + head) * kHD + tid] =
          __float2bfloat16(o);
    }
  }
}

}  // namespace

// Whether a call of nq = T * g query rows over max_win keys fits the kernel
// on device: nq within kMaxQ, and its shared memory within what a block may
// opt in to there. 1: it fits, 0: it does not, < 0: minus a CUDA error.
extern "C" int decode_attention_fits(int device, int nq, int max_win) {
  if (nq < 1 || nq > kMaxQ || max_win < 1) return 0;
  int limit = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return smem_bytes(nq, max_win) <= limit ? 1 : 0;
}

// One launch: grid (n_kv_heads, B) of kThreads threads, nq * max_win floats
// of scores beside the ring (max_win: the widest row window, at most S).
// Returns the CUDA error of the launch (0 = launched).
extern "C" int decode_attention_bf16(
    const void* q, const void* k, const void* v, const void* q_norm,
    const void* k_norm, const void* cos, const void* sin, void* cache_k,
    void* cache_v, const void* pos, const void* pad, const void* win, void* out,
    long long q_stride, long long k_stride, long long v_stride,
    long long cache_stride, int rope_stride, int B, int T, int n_heads,
    int n_kv_heads, int S, int pos_int, int pad_int, int max_win, float eps,
    float scale, void* stream) {
  if (B < 1 || T < 1 || T > 2 || n_kv_heads < 1 || n_heads % n_kv_heads ||
      T * (n_heads / n_kv_heads) > kMaxQ || S < T || max_win < 1 || max_win > S)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nq = T * (n_heads / n_kv_heads);
  static int smem_max[kMaxDevices] = {};  // the attribute set, per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  const long long wanted = smem_bytes(nq, max_win);
  if (wanted > (1 << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = static_cast<int>(wanted);
  if (bytes > smem_max[dev]) {
    err = cudaFuncSetAttribute(decode_attention_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_max[dev] = bytes;
  }
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.q_norm = static_cast<const __nv_bfloat16*>(q_norm);
  a.k_norm = static_cast<const __nv_bfloat16*>(k_norm);
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  a.cache_k = static_cast<__nv_bfloat16*>(cache_k);
  a.cache_v = static_cast<__nv_bfloat16*>(cache_v);
  a.pos = static_cast<const long long*>(pos);
  a.pad = static_cast<const long long*>(pad);
  a.win = static_cast<const long long*>(win);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.q_stride = q_stride;
  a.k_stride = k_stride;
  a.v_stride = v_stride;
  a.cache_stride = cache_stride;
  a.rope_stride = rope_stride;
  a.T = T;
  a.n_heads = n_heads;
  a.n_kv_heads = n_kv_heads;
  a.S = S;
  a.pos_int = pos_int;
  a.pad_int = pad_int;
  a.eps = eps;
  a.scale = scale;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_kv_heads, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_attention_kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
