// flash_decode: one-token GQA attention over a KV cache, for Hopper.
//
// Replaces the Pallas TPU kernel `_kernel` at
// src/repro/kernels/flash_decode/kernel.py:32 (reached through
// flash_decode_pallas -> _flash_decode_jit -> pallas_call, and from the
// GQA entry kernels/flash_decode/ops.py::decode_attention).
//
//   out[b, h, :] = softmax_s(q[b, h] . k[b, s, h / G] / sqrt(D)
//                            masked to s < lengths[b]) @ v[b, :, h / G, :]
//
// with G = H / KVH query heads per KV head.  q is [B, H, D]; k and v are
// read in the cache's own layout [B, S, KVH, D] (never expanded to H
// heads); float32 or bfloat16 in, fp32 softmax and accumulation, the
// output in the input's dtype.  A row with length 0 gives zeros.
//
// The TPU kernel walks a sequential (row block, S block) grid and
// carries (m, l, acc) in VMEM from one S block to the next.  Blocks on
// Hopper run in no order, so nothing carries across them.  Here:
//
//   pass 1 (flash_decode_split): grid (B * KVH * head chunks, splits).
//     One 128-thread CTA takes one KV head of one request and a span of
//     `split_len` cache positions, and serves every query head of its
//     group (up to KG = 8 per chunk) from one read of each K and V row.
//     It walks the span in tiles of 64 positions: D / 8 lanes read one
//     row with 16-byte loads (8 elements a lane), so a warp reads whole
//     rows; the KG dot products are reduced across those lanes with
//     shuffles into a [KG, 64] score tile in shared memory; one warp per
//     head then takes the tile's max, rescales (m, l) and turns the
//     scores into probabilities (base-2 exponent, the scale folded into
//     q); every thread then adds p * v into its fp32 accumulators.  The
//     span's unnormalised (acc, m, l) go to fp32 scratch.
//   pass 2 (flash_decode_merge): one CTA per (b, h) merges the splits by
//     log-sum-exp in fixed split order -- the merge the reference does
//     across chips (src/repro/models/attention.py:8-11) -- and writes
//     acc / max(l, 1e-30).  No atomics: the result is deterministic.
//
// Bound on this card: bytes.  The function must read K and V of each KV
// head within lengths once (2 * len * D elements per (b, kvh)), q, and
// write the output; it does 4 * len * D flops per query head.  At the
// LM decode shape (B = 16, H = 12, KVH = 2, D = 128, bf16, len ~32.8k)
// that is ~537 MB, ~0.160 ms at 3.35 TB/s (H100 SXM), against ~0.048 ms
// of fp32 work at 67 TFLOP/s; chip_smoke.flash_decode_work counts it on
// each run's lengths.  The design reads each cache row once per KV head
// (the GQA group shares it) and splits S so that B * KVH = 32 rows still
// fill 132 SMs.  A tile's K loads are issued together before any math
// and its V loads before the softmax; there is no multi-stage cp.async
// or TMA pipeline and no tensor-core (wgmma) product yet: later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kTile = 64;      // cache positions per tile
constexpr int kVec = 8;        // elements per lane per row
constexpr float kLog2e = 1.4426950408889634f;

// Eight consecutive elements of a row, as loaded (16 bytes of bfloat16
// or 32 bytes of float32).
template <typename T>
struct Vec8;

template <>
struct Vec8<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void zero() { u = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void to_float(float (&x)[kVec]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Vec8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ void zero() {
    a = make_float4(0.f, 0.f, 0.f, 0.f);
    b = a;
  }
  __device__ __forceinline__ void to_float(float (&x)[kVec]) const {
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Pass 1.  part_acc [B * H, n_splits, D] and part_ml [B * H, n_splits, 2]
// (m in base-2 units of the scaled scores, then l) receive each span's
// unnormalised state; a span past its row's length leaves (0, -inf, 0).
template <typename T, int D, int KG>
__global__ void __launch_bounds__(kThreads)
flash_decode_split(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v,
                   const int32_t* __restrict__ lengths,
                   float* __restrict__ part_acc, float* __restrict__ part_ml,
                   int S, int H, int KVH, int n_chunks, int split_len,
                   int n_splits, float scale_log2) {
  constexpr int X = D / kVec;          // lanes that share one row
  constexpr int R = kThreads / X;      // rows in flight per pass
  constexpr int RPT = kTile / R;       // rows per thread per tile
  static_assert(D % kVec == 0 && X >= 1 && X <= 32 && (X & (X - 1)) == 0,
                "D must be 8 x a power of two, at most 256");
  static_assert(kTile % R == 0 && kTile == 64, "tile layout");

  __shared__ float sc[KG][kTile];
  __shared__ float m_s[KG], l_s[KG], alpha_s[KG];
  __shared__ float red[R * KG * D];

  const int tid = threadIdx.x;
  const int lane_d = tid % X;
  const int slot = tid / X;
  const int chunk = blockIdx.x % n_chunks;
  const int bkv = blockIdx.x / n_chunks;
  const int b = bkv / KVH;
  const int kvh = bkv % KVH;
  const int G = H / KVH;
  const int split = blockIdx.y;

  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const int s_begin = split * split_len;
  const int s_end = min(len, s_begin + split_len);

  // this chunk's query heads, pre-scaled so that exp2 gives the softmax
  float qr[KG][kVec];
#pragma unroll
  for (int g = 0; g < KG; ++g) {
    const int gi = chunk * KG + g;
    if (gi < G) {
      Vec8<T> t;
      t.load(q + ((long long)b * H + (long long)kvh * G + gi) * D +
             lane_d * kVec);
      t.to_float(qr[g]);
#pragma unroll
      for (int e = 0; e < kVec; ++e) qr[g][e] *= scale_log2;
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) qr[g][e] = 0.f;
    }
  }
  if (tid < KG) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[KG][kVec];
#pragma unroll
  for (int g = 0; g < KG; ++g)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[g][e] = 0.f;
  __syncthreads();

  const long long row_stride = (long long)KVH * D;
  const long long base = ((long long)b * S * KVH + kvh) * D + lane_d * kVec;

  for (int t0 = s_begin; t0 < s_end; t0 += kTile) {
    // -- scores: KG dot products per row, reduced over the row's lanes
    Vec8<T> kv[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int s = t0 + slot + i * R;
      if (s < s_end) kv[i].load(k + base + s * row_stride);
      else kv[i].zero();
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float x[kVec];
      kv[i].to_float(x);
      const bool valid = t0 + slot + i * R < s_end;
#pragma unroll
      for (int g = 0; g < KG; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) dot = fmaf(qr[g][e], x[e], dot);
#pragma unroll
        for (int o = X / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (lane_d == 0) sc[g][slot + i * R] = valid ? dot : -INFINITY;
      }
    }
    // V rows of the tile, in flight during the softmax
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int s = t0 + slot + i * R;
      if (s < s_end) kv[i].load(v + base + s * row_stride);
      else kv[i].zero();
    }
    __syncthreads();

    // -- online softmax over the tile: one warp per query head
    const int warp = tid / 32, lane = tid % 32;
    for (int g = warp; g < KG; g += kThreads / 32) {
      const float s0 = sc[g][lane], s1 = sc[g][lane + 32];
      float mt = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mt);  // finite: t0 < s_end
      const float p0 = exp2f(s0 - m_new), p1 = exp2f(s1 - m_new);
      sc[g][lane] = p0;
      sc[g][lane + 32] = p1;
      float ps = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);  // 0 on the first tile
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + ps;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // -- acc = acc * alpha + p @ v
#pragma unroll
    for (int g = 0; g < KG; ++g) {
      const float a = alpha_s[g];
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[g][e] *= a;
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float x[kVec];
      kv[i].to_float(x);
#pragma unroll
      for (int g = 0; g < KG; ++g) {
        const float p = sc[g][slot + i * R];
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[g][e] = fmaf(p, x[e], acc[g][e]);
      }
    }
    __syncthreads();  // sc and alpha_s are rewritten by the next tile
  }

  // -- sum the R row slots' accumulators and write the span's state
#pragma unroll
  for (int g = 0; g < KG; ++g)
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      red[(slot * KG + g) * D + lane_d * kVec + e] = acc[g][e];
  __syncthreads();
  for (int idx = tid; idx < KG * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    const int gi = chunk * KG + g;
    if (gi >= G) continue;
    float sum = 0.f;
    for (int r = 0; r < R; ++r) sum += red[(r * KG + g) * D + d];
    const long long row = (long long)b * H + (long long)kvh * G + gi;
    part_acc[(row * n_splits + split) * D + d] = sum;
  }
  if (tid < KG && chunk * KG + tid < G) {
    const long long row = (long long)b * H + (long long)kvh * G +
                          chunk * KG + tid;
    part_ml[(row * n_splits + split) * 2] = m_s[tid];
    part_ml[(row * n_splits + split) * 2 + 1] = l_s[tid];
  }
}

// Pass 2: one CTA per (b, h); splits merged in order.
template <typename T>
__global__ void flash_decode_merge(const float* __restrict__ part_acc,
                                   const float* __restrict__ part_ml,
                                   T* __restrict__ out, int D, int n_splits) {
  const long long row = blockIdx.x;
  const float* ml = part_ml + row * n_splits * 2;
  float m = -INFINITY;
  for (int s = 0; s < n_splits; ++s) m = fmaxf(m, ml[2 * s]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float num = 0.f, den = 0.f;
    if (m != -INFINITY) {  // else every span was empty: length 0 -> zeros
      for (int s = 0; s < n_splits; ++s) {
        const float w = exp2f(ml[2 * s] - m);
        den = fmaf(ml[2 * s + 1], w, den);
        num = fmaf(part_acc[(row * n_splits + s) * D + d], w, num);
      }
    }
    store(out + row * D + d, num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int D, int KG>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, void* part_acc, void* part_ml, int B, int S, int H,
           int KVH, int split_len, int n_splits, cudaStream_t st) {
  const int G = H / KVH;
  const int n_chunks = (G + KG - 1) / KG;
  const long long rows = (long long)B * KVH * n_chunks;
  if (rows > 2147483647LL || n_splits > 65535)
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = kLog2e / sqrtf((float)D);
  flash_decode_split<T, D, KG><<<dim3((unsigned)rows, n_splits), kThreads, 0,
                                 st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int32_t*)lengths,
      (float*)part_acc, (float*)part_ml, S, H, KVH, n_chunks, split_len,
      n_splits, scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_decode_merge<T><<<(unsigned)((long long)B * H), D < 128 ? D : 128, 0,
                          st>>>((const float*)part_acc,
                                (const float*)part_ml, (T*)out, D, n_splits);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_kg(int kg, const void* q, const void* k, const void* v,
              const void* lengths, void* out, void* part_acc, void* part_ml,
              int B, int S, int H, int KVH, int split_len, int n_splits,
              cudaStream_t st) {
  switch (kg) {
    case 1: return launch<T, D, 1>(q, k, v, lengths, out, part_acc, part_ml,
                                   B, S, H, KVH, split_len, n_splits, st);
    case 2: return launch<T, D, 2>(q, k, v, lengths, out, part_acc, part_ml,
                                   B, S, H, KVH, split_len, n_splits, st);
    case 4: return launch<T, D, 4>(q, k, v, lengths, out, part_acc, part_ml,
                                   B, S, H, KVH, split_len, n_splits, st);
    case 8: return launch<T, D, 8>(q, k, v, lengths, out, part_acc, part_ml,
                                   B, S, H, KVH, split_len, n_splits, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_d(int D, int kg, const void* q, const void* k, const void* v,
             const void* lengths, void* out, void* part_acc, void* part_ml,
             int B, int S, int H, int KVH, int split_len, int n_splits,
             cudaStream_t st) {
  switch (D) {
    case 16: return launch_kg<T, 16>(kg, q, k, v, lengths, out, part_acc,
                                     part_ml, B, S, H, KVH, split_len,
                                     n_splits, st);
    case 32: return launch_kg<T, 32>(kg, q, k, v, lengths, out, part_acc,
                                     part_ml, B, S, H, KVH, split_len,
                                     n_splits, st);
    case 64: return launch_kg<T, 64>(kg, q, k, v, lengths, out, part_acc,
                                     part_ml, B, S, H, KVH, split_len,
                                     n_splits, st);
    case 128: return launch_kg<T, 128>(kg, q, k, v, lengths, out, part_acc,
                                       part_ml, B, S, H, KVH, split_len,
                                       n_splits, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype 0 = float32,
// 1 = bfloat16.  kg (1, 2, 4 or 8) is the number of query heads one CTA
// serves; D is 16, 32, 64 or 128; H is a multiple of KVH.  The caller
// allocates part_acc (float32 [B * H, n_splits, D]) and part_ml
// (float32 [B * H, n_splits, 2]), and picks split_len (a multiple of 64)
// and n_splits with n_splits * split_len >= S.  Launches both passes on
// `stream` and returns cudaGetLastError() (0 on success); never
// synchronises.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* lengths,
                                   void* out, void* part_acc, void* part_ml,
                                   int B, int S, int H, int KVH, int D,
                                   int kg, int split_len, int n_splits,
                                   int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 ||
      split_len <= 0 || split_len % kTile != 0 || n_splits <= 0 ||
      (long long)split_len * n_splits < S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_d<float>(D, kg, q, k, v, lengths, out, part_acc, part_ml,
                           B, S, H, KVH, split_len, n_splits, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, kg, q, k, v, lengths, out, part_acc,
                                   part_ml, B, S, H, KVH, split_len, n_splits,
                                   st);
  return (int)cudaErrorInvalidValue;
}
