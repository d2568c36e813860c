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
// heads); fp32 softmax and accumulation, the output in the input's
// dtype.  A row with length 0 gives zeros.  On request the merge also
// writes each row's log-sum-exp of its scaled scores (float32 [B, H],
// -inf at length 0): the sequence-sharded decode merges the outputs of
// several cache shards by it.  The Pallas kernel returns none (the
// reference leaves that merge across chips to XLA).
//
// The TPU kernel walks a sequential (row block, S block) grid and
// carries (m, l, acc) in VMEM from one S block to the next.  Blocks on
// Hopper run in no order, so nothing carries across them: pass 1 cuts S
// into spans, one CTA per (b, KV head, head chunk, span), each writing
// its span's unnormalised (acc, m, l) to fp32 scratch; pass 2
// (flash_decode_merge), one CTA per (b, h), merges the spans by
// log-sum-exp in fixed span order -- the merge the reference does across
// chips (src/repro/models/attention.py:8-11) -- and writes
// acc / max(l, 1e-30).  No atomics: the result is deterministic.  The
// wrapper (kernels/flash_decode/kernel.py) picks pass 1's route by dtype
// and D alone:
//
//   tensor cores (flash_decode_mma; bfloat16, D = 64 or 128, the LM's
//     route).  A CTA of 4 warps serves the whole GQA group of its KV
//     head, up to 16 query heads, as the M = 16 rows of
//     mma.sync.m16n8k16 products in bf16 with fp32 accumulators (rows
//     past the group are zero).  Each warp owns every 4th tile of 16
//     cache positions of the span and keeps its own (m, l, O[16 x D]) in
//     registers; its K and V tiles flow through its own 3-stage ring in
//     shared memory, filled by 16-byte cp.async.cg copies (zeros past the
//     row's end) and waited on with cp.async.wait_group and __syncwarp:
//     no __syncthreads until the 4 warps' states are merged once at the
//     end of the span.  A tile's rows are 256 bytes (D = 128), so its
//     16-byte chunks are stored XOR-swizzled by row (chunk ^ (row % 8))
//     and ldmatrix (K) and ldmatrix.trans (V) read 8 rows without bank
//     conflicts.  q is not scaled in bf16: the scale goes onto the fp32
//     scores.  P = exp2(s - m) is split into a bf16 pair hi + lo (lo =
//     P - hi) and P @ V is taken as two products, so P keeps about 16
//     bits where one bf16 product would keep 8.  The wrapper cuts S so
//     that the CTAs make one wave of 2 per SM (96 KB of rings each at
//     D = 128): 8 spans of 4112 positions at the LM's shape, 256 CTAs.
//     Smaller spans lost more to each CTA's fill and drain than they
//     gained in balance over the 132 SMs.  Both passes are launched with
//     programmatic dependent launch: pass 2 is scheduled while pass 1
//     drains (pass 1 signals it after its loop) and waits for pass 1's
//     writes itself, which takes a launch gap off every call.
//   CUDA cores (flash_decode_split; float32, and D = 16 or 32).  One
//     128-thread CTA serves up to KG = 8 query heads of its group from
//     one read of each K and V row, in tiles of 64 positions: D / 8
//     lanes read one row with 16-byte loads (8 elements a lane); the KG
//     dot products are reduced across those lanes with shuffles into a
//     [KG, 64] score tile in shared memory; one warp per head takes the
//     tile's max, rescales (m, l) and turns the scores into
//     probabilities (base-2 exponent, the scale folded into fp32 q);
//     every thread then adds p * v into its fp32 accumulators.  A tile's
//     K loads are issued together before any math and its V loads
//     before the softmax; there is no multi-stage pipeline.
//
// Bound on this card: bytes.  The function must read K and V of each KV
// head within lengths once (2 * len * D elements per (b, kvh)), q, and
// write the output; it does 4 * len * D flops per query head.  At the
// LM decode shape (B = 16, H = 12, KVH = 2, D = 128, bf16, len ~32.8k)
// that is ~537 MB, ~0.160 ms at 3.35 TB/s (H100 SXM), against ~0.048 ms
// of fp32 work at 67 TFLOP/s; chip_smoke.flash_decode_work counts it on
// each run's lengths.  Both routes read each cache row once per KV head
// (the GQA group shares it) and split S so that B * KVH = 32 rows still
// fill 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kTile = 64;      // cache positions per tile
constexpr int kVec = 8;        // elements per lane per row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// Wait for the kernels this one depends on to finish and their writes
// to show (a no-op unless launched with programmatic dependent launch).
__device__ __forceinline__ void wait_for_inputs() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Pass 2: one CTA per (b, h); splits merged in order.  With `lse` (may
// be null) thread 0 also writes the row's natural log-sum-exp of its
// scaled scores, ln(den) + m ln 2 (m and the spans' l are in base 2),
// -inf where every span was empty: what a merge of this row with the
// rows of other cache shards needs.
template <typename T>
__global__ void flash_decode_merge(const float* __restrict__ part_acc,
                                   const float* __restrict__ part_ml,
                                   T* __restrict__ out,
                                   float* __restrict__ lse, int D,
                                   int n_splits) {
  wait_for_inputs();
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
  if (lse != nullptr && threadIdx.x == 0) {
    float den = 0.f;
    if (m != -INFINITY)
      for (int s = 0; s < n_splits; ++s)
        den = fmaf(ml[2 * s + 1], exp2f(ml[2 * s] - m), den);
    lse[row] = m == -INFINITY ? -INFINITY : (m + log2f(den)) * kLn2;
  }
}

template <typename T, int D, int KG>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, void* part_acc, void* part_ml, void* lse, int B, int S,
           int H, int KVH, int split_len, int n_splits, cudaStream_t st) {
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
                                (const float*)part_ml, (T*)out, (float*)lse, D,
                                n_splits);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_kg(int kg, const void* q, const void* k, const void* v,
              const void* lengths, void* out, void* part_acc, void* part_ml,
              void* lse, int B, int S, int H, int KVH, int split_len,
              int n_splits, cudaStream_t st) {
  switch (kg) {
    case 1: return launch<T, D, 1>(q, k, v, lengths, out, part_acc, part_ml,
                                   lse, B, S, H, KVH, split_len, n_splits,
                                   st);
    case 2: return launch<T, D, 2>(q, k, v, lengths, out, part_acc, part_ml,
                                   lse, B, S, H, KVH, split_len, n_splits,
                                   st);
    case 4: return launch<T, D, 4>(q, k, v, lengths, out, part_acc, part_ml,
                                   lse, B, S, H, KVH, split_len, n_splits,
                                   st);
    case 8: return launch<T, D, 8>(q, k, v, lengths, out, part_acc, part_ml,
                                   lse, B, S, H, KVH, split_len, n_splits,
                                   st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_d(int D, int kg, const void* q, const void* k, const void* v,
             const void* lengths, void* out, void* part_acc, void* part_ml,
             void* lse, int B, int S, int H, int KVH, int split_len,
             int n_splits, cudaStream_t st) {
  switch (D) {
    case 16: return launch_kg<T, 16>(kg, q, k, v, lengths, out, part_acc,
                                     part_ml, lse, B, S, H, KVH, split_len,
                                     n_splits, st);
    case 32: return launch_kg<T, 32>(kg, q, k, v, lengths, out, part_acc,
                                     part_ml, lse, B, S, H, KVH, split_len,
                                     n_splits, st);
    case 64: return launch_kg<T, 64>(kg, q, k, v, lengths, out, part_acc,
                                     part_ml, lse, B, S, H, KVH, split_len,
                                     n_splits, st);
    case 128: return launch_kg<T, 128>(kg, q, k, v, lengths, out, part_acc,
                                       part_ml, lse, B, S, H, KVH, split_len,
                                       n_splits, st);
  }
  return (int)cudaErrorInvalidValue;
}

// ---- the tensor-core route -------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaRows = 16;   // query heads per CTA: the M of m16n8k16
constexpr int kWarpTile = 16;  // cache positions per warp tile
constexpr int kStages = 3;     // tiles in each warp's ring

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, asynchronously; zeros where
// `full` is false (src-size 0: nothing is read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// c += a @ b: a 16 x 16 bf16 (4 registers), b 16 x 8 bf16 (2), c fp32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) as a bf16 pair hi and the pair of what hi leaves out, lo.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = pack_bf16(h);
  lo = pack_bf16(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// Element offset of 16-byte chunk c of row r in a [kWarpTile, D] tile.
template <int D>
__device__ __forceinline__ int swizzled(int r, int c) {
  return r * D + ((c ^ (r & 7)) << 3);
}

// Pass 1 on the tensor cores.  Grid (B * KVH * head chunks of 16,
// n_splits), kMmaWarps warps.  Dynamic shared memory: each warp's ring
// of kStages (K, V) tile pairs; reused at the end for the warps' states.
// part_acc, part_ml as for flash_decode_split.
template <int D>
__global__ void __launch_bounds__(32 * kMmaWarps)
flash_decode_mma(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int32_t* __restrict__ lengths,
                 float* __restrict__ part_acc, float* __restrict__ part_ml,
                 int S, int H, int KVH, int n_chunks, int split_len,
                 int n_splits, float scale_log2) {
  constexpr int C = D / 8;       // 16-byte chunks per row
  constexpr int KS = D / 16;     // k-steps of q . k
  constexpr int NT = D / 8;      // n-tiles of p @ v
  constexpr int TILE = kWarpTile * D;
  static_assert(D == 64 || D == 128, "the tensor-core route takes D 64, 128");

  extern __shared__ float4 smem4[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem4) +
                        (threadIdx.x >> 5) * (kStages * 2 * TILE);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, gc = (lane & 3) * 2;  // fragment row, column
  const int chunk = blockIdx.x % n_chunks;
  const int bkv = blockIdx.x / n_chunks;
  const int b = bkv / KVH, kvh = bkv % KVH;
  const int G = H / KVH;
  const int split = blockIdx.y;

  wait_for_inputs();
  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const int s_begin = split * split_len;
  const int s_end = min(len, s_begin + split_len);
  const int n_tiles =
      s_end > s_begin ? (s_end - s_begin + kWarpTile - 1) / kWarpTile : 0;
  const int my_tiles =
      n_tiles > warp ? (n_tiles - warp + kMmaWarps - 1) / kMmaWarps : 0;

  // q as the A operand: rows = this chunk's query heads (zero past G)
  uint32_t qa[KS][4];
  {
    const int g0 = chunk * kMmaRows + gr, g1 = g0 + 8;
    const long long head0 = (long long)b * H + (long long)kvh * G;
    const uint32_t* q0 =
        reinterpret_cast<const uint32_t*>(q + (head0 + g0) * D + gc);
    const uint32_t* q1 =
        reinterpret_cast<const uint32_t*>(q + (head0 + g1) * D + gc);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      qa[kk][0] = g0 < G ? q0[kk * 8] : 0u;
      qa[kk][1] = g1 < G ? q1[kk * 8] : 0u;
      qa[kk][2] = g0 < G ? q0[kk * 8 + 4] : 0u;
      qa[kk][3] = g1 < G ? q1[kk * 8 + 4] : 0u;
    }
  }

  const long long row_stride = (long long)KVH * D;
  const __nv_bfloat16* kb = k + ((long long)b * S * KVH + kvh) * D;
  const __nv_bfloat16* vb = v + ((long long)b * S * KVH + kvh) * D;

  // this warp's i-th tile into stage i % kStages; always one group
  auto issue = [&](int i) {
    if (i < my_tiles) {
      const int t0 = s_begin + (warp + i * kMmaWarps) * kWarpTile;
      __nv_bfloat16* ks = ring + (i % kStages) * 2 * TILE;
#pragma unroll
      for (int u = 0; u < kWarpTile * C / 32; ++u) {
        const int r = (lane + 32 * u) / C, c = (lane + 32 * u) % C;
        const bool full = t0 + r < s_end;
        const long long off = (long long)(full ? t0 + r : t0) * row_stride +
                              c * 8;
        const uint32_t dst = smem_addr(ks + swizzled<D>(r, c));
        cp_async16(dst, kb + off, full);
        cp_async16(dst + TILE * 2, vb + off, full);
      }
    }
    cp_async_commit();
  };

  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // rows gr and gr + 8
  float l0 = 0.f, l1 = 0.f;              // this lane's share of the sums

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int i = 0; i < my_tiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncwarp();  // tile i is in; every lane is done with tile i - 1
    issue(i + kStages - 1);
    const __nv_bfloat16* ks = ring + (i % kStages) * 2 * TILE;
    const __nv_bfloat16* vs = ks + TILE;
    const int t0 = s_begin + (warp + i * kMmaWarps) * kWarpTile;

    // scores: positions t0 + 0..7 (sc[0]) and t0 + 8..15 (sc[1])
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    {
      const int j = lane >> 3;
      const int r = ((j >> 1) << 3) + (lane & 7);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t kf[4];
        ldmatrix_x4(kf, smem_addr(ks + swizzled<D>(r, kk * 2 + (j & 1))));
        mma_bf16(sc[0], qa[kk], kf[0], kf[1]);
        mma_bf16(sc[1], qa[kk], kf[2], kf[3]);
      }
    }
    // online softmax in base 2 on the fp32 scores
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = t0 + nt * 8 + gc + (e & 1) < s_end;
        sc[nt][e] = valid ? sc[nt][e] * scale_log2 : -INFINITY;
        if (e < 2) mx0 = fmaxf(mx0, sc[nt][e]);
        else mx1 = fmaxf(mx1, sc[nt][e]);
      }
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o2));
    }
    // finite: position t0 < s_end is in every row's quad
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - n0), a1 = exp2f(m1 - n1);  // 0 at first
    m0 = n0;
    m1 = n1;
    float p[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[nt][e] = exp2f(sc[nt][e] - (e < 2 ? n0 : n1));
    l0 = l0 * a0 + (p[0][0] + p[0][1] + p[1][0] + p[1][1]);
    l1 = l1 * a1 + (p[0][2] + p[0][3] + p[1][2] + p[1][3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      o[j][0] *= a0;
      o[j][1] *= a0;
      o[j][2] *= a1;
      o[j][3] *= a1;
    }
    // P as the A operand (k = the tile's 16 positions), hi and lo
    uint32_t ph[4], pl[4];
    split_bf16(p[0][0], p[0][1], ph[0], pl[0]);
    split_bf16(p[0][2], p[0][3], ph[1], pl[1]);
    split_bf16(p[1][0], p[1][1], ph[2], pl[2]);
    split_bf16(p[1][2], p[1][3], ph[3], pl[3]);
    {
      const int j = lane >> 3;
      const int r = ((j & 1) << 3) + (lane & 7);
#pragma unroll
      for (int jt = 0; jt < NT; jt += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, smem_addr(vs + swizzled<D>(r, jt + (j >> 1))));
        mma_bf16(o[jt], ph, vf[0], vf[1]);
        mma_bf16(o[jt], pl, vf[0], vf[1]);
        mma_bf16(o[jt + 1], ph, vf[2], vf[3]);
        mma_bf16(o[jt + 1], pl, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();
  // the merge pass may be scheduled now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
#pragma unroll
  for (int o2 = 1; o2 < 4; o2 <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o2);
  }

  const int rows = min(kMmaRows, G - chunk * kMmaRows);
  const long long row0 = (long long)b * H + (long long)kvh * G +
                         chunk * kMmaRows;
  // merge the warps' states in warp order, once per span
  __syncthreads();  // every warp is done with its ring
  float* red = reinterpret_cast<float*>(smem4);  // [warps][16][D]
  float* ml = red + kMmaWarps * kMmaRows * D;    // [warps][16][2]
  float* r0 = red + (warp * kMmaRows + gr) * D + gc;
  float* r1 = r0 + 8 * D;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    r0[j * 8] = o[j][0];
    r0[j * 8 + 1] = o[j][1];
    r1[j * 8] = o[j][2];
    r1[j * 8 + 1] = o[j][3];
  }
  if ((lane & 3) == 0) {
    ml[(warp * kMmaRows + gr) * 2] = m0;
    ml[(warp * kMmaRows + gr) * 2 + 1] = l0;
    ml[(warp * kMmaRows + gr + 8) * 2] = m1;
    ml[(warp * kMmaRows + gr + 8) * 2 + 1] = l1;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * D; idx += 32 * kMmaWarps) {
    const int r = idx / D, d = idx % D;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w)
      m = fmaxf(m, ml[(w * kMmaRows + r) * 2]);
    float acc = 0.f, l = 0.f;
    if (m != -INFINITY) {  // else no position of the span is valid
#pragma unroll
      for (int w = 0; w < kMmaWarps; ++w) {
        const float f = exp2f(ml[(w * kMmaRows + r) * 2] - m);
        acc = fmaf(red[(w * kMmaRows + r) * D + d], f, acc);
        l = fmaf(ml[(w * kMmaRows + r) * 2 + 1], f, l);
      }
    }
    const long long at = (row0 + r) * n_splits + split;
    part_acc[at * D + d] = acc;
    if (d == 0) {
      part_ml[at * 2] = m;
      part_ml[at * 2 + 1] = l;
    }
  }
}

template <int D>
constexpr size_t mma_smem() {
  return (size_t)kMmaWarps * kStages * 2 * kWarpTile * D * 2;
}

// Launch `kernel` on `st` with programmatic dependent launch: it may be
// scheduled while the kernel before it on the stream drains, and waits
// for that kernel's results itself (griddepcontrol.wait), so the gap
// between two launches shrinks.
template <typename... Params, typename... Args>
cudaError_t launch_after(void (*kernel)(Params...), dim3 grid,
                         dim3 block, size_t smem, cudaStream_t st,
                         Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v,
               const void* lengths, void* out, void* part_acc, void* part_ml,
               void* lse, int B, int S, int H, int KVH, int split_len,
               int n_splits, cudaStream_t st) {
  static_assert(mma_smem<D>() >= (size_t)kMmaWarps * kMmaRows * (D + 2) * 4,
                "the ring must hold the warps' states for the merge");
  const int G = H / KVH;
  const int n_chunks = (G + kMmaRows - 1) / kMmaRows;
  const long long rows = (long long)B * KVH * n_chunks;
  if (rows > 2147483647LL || n_splits > 65535 || split_len % kWarpTile)
    return (int)cudaErrorInvalidValue;
  static bool opted = false;
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_decode_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)mma_smem<D>());
    if (err != cudaSuccess) return (int)err;
    opted = true;
  }
  const float scale_log2 = kLog2e / sqrtf((float)D);
  cudaError_t err = launch_after(
      flash_decode_mma<D>, dim3((unsigned)rows, n_splits),
      dim3(32 * kMmaWarps), mma_smem<D>(), st, (const __nv_bfloat16*)q,
      (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const int32_t*)lengths, (float*)part_acc, (float*)part_ml, S, H, KVH,
      n_chunks, split_len, n_splits, scale_log2);
  if (err != cudaSuccess) return (int)err;
  err = launch_after(flash_decode_merge<__nv_bfloat16>,
                     dim3((unsigned)((long long)B * H)),
                     dim3(D < 128 ? D : 128), 0, st, (const float*)part_acc,
                     (const float*)part_ml, (__nv_bfloat16*)out, (float*)lse,
                     D, n_splits);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype 0 = float32,
// 1 = bfloat16.  kg (1, 2, 4 or 8) is the number of query heads one CTA
// serves; D is 16, 32, 64 or 128; H is a multiple of KVH.  The caller
// allocates part_acc (float32 [B * H, n_splits, D]) and part_ml
// (float32 [B * H, n_splits, 2]), and picks split_len (a multiple of 64)
// and n_splits with n_splits * split_len >= S.  `lse` is null, or float32
// [B * H] for each row's log-sum-exp (flash_decode_merge).  Launches both
// passes on `stream` and returns cudaGetLastError() (0 on success);
// never synchronises.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* lengths,
                                   void* out, void* part_acc, void* part_ml,
                                   void* lse, int B, int S, int H, int KVH,
                                   int D,
                                   int kg, int split_len, int n_splits,
                                   int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 ||
      split_len <= 0 || split_len % kTile != 0 || n_splits <= 0 ||
      (long long)split_len * n_splits < S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_d<float>(D, kg, q, k, v, lengths, out, part_acc, part_ml,
                           lse, B, S, H, KVH, split_len, n_splits, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, kg, q, k, v, lengths, out, part_acc,
                                   part_ml, lse, B, S, H, KVH, split_len,
                                   n_splits, st);
  return (int)cudaErrorInvalidValue;
}

// Plain C entry point of the tensor-core route, bound with ctypes: q, k,
// v bfloat16, D 64 or 128, H a multiple of KVH; part_acc, part_ml and
// lse as for flash_decode_launch, split_len a multiple of 16.  Launches both
// passes on `stream`, with programmatic dependent launch, and returns
// cudaGetLastError() (0 on success); never synchronises.
extern "C" int flash_decode_mma_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, void* part_acc,
                                       void* part_ml, void* lse, int B,
                                       int S, int H, int KVH, int D,
                                       int split_len, int n_splits,
                                       void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 ||
      split_len <= 0 || n_splits <= 0 || (long long)split_len * n_splits < S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    return launch_mma<64>(q, k, v, lengths, out, part_acc, part_ml, lse, B,
                          S, H, KVH, split_len, n_splits, st);
  if (D == 128)
    return launch_mma<128>(q, k, v, lengths, out, part_acc, part_ml, lse, B,
                           S, H, KVH, split_len, n_splits, st);
  return (int)cudaErrorInvalidValue;
}
