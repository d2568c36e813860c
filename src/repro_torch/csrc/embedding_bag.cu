// embedding_bag: in-bag sums of embedding-table rows for Hopper.
//
// Replaces the Pallas TPU kernel `_kernel` at
// src/repro/kernels/embedding_bag/kernel.py:29 (reached through
// embedding_bag_pallas -> _embedding_bag_jit -> pallas_call).
//
//   out[b, :] = sum over s < S of table[row(ids[b, s]), :]
//   row(i)    = i          if 0 <= i < V
//             = V + 1 + i  if -(V + 1) <= i < 0  (from the end, as the
//                                                reference's jnp.take
//                                                and Pallas kernel read it)
//             = V          otherwise  (table[V] is the zero row the ops
//                                      wrapper appends)
//
// fp32 accumulation; the output is written once in the table's dtype
// (float32 or bfloat16, the latter rounded to nearest even).
//
// The TPU kernel runs one sequential grid step per (bag, slot) and DMAs
// one [1, D] row per step into a VMEM accumulator.  Here the grid is
// parallel, in two designs; both add each (bag, column)'s rows in slot
// order from 0.f, with no atomics, so they are deterministic, equal to
// each other bit for bit, and differ from a plain fp32 sum only by that
// order.
//
// embedding_bag_packed (the route): a row is read as nv vectors of VB
// bytes, the widest of 16, 8, 4 (and 2 in bf16) that the row's bytes and
// the table's alignment allow (D = 18 f32: 72-byte rows, nv = 9 vectors
// of 8 bytes; D = 8 f32: nv = 2 of 16 bytes).  Lanes are spread over
// (bag, vector): a warp holds G = floor(32 / nv) bags when nv <= 16 (3 at
// D = 18 f32, 16 at D = 8 f32), else one bag whose vectors its lanes
// stride over.  The CTA (8 warps, 8 G bags) reads its bags' ids, 16 slots
// at a time, coalesced into shared memory, and each lane keeps 8 rows in
// flight before it adds them in slot order.
//
// embedding_bag_warp is the first design (with its slot loop
// unrolled), kept so that it can be timed beside the packed one: one warp per
// bag, lanes stride over D with scalar loads, ids broadcast by
// __shfl_sync, 4 rows in flight.
//
// Bound on this card: bytes.  The function must read the ids (4 B per
// slot), each distinct table row it touches once (D elements), and
// write the output (D elements per bag); it does about one add per
// slot and column, far below the fp32 rate.  At the recsys bulk shape
// (1,048,576 bags x 8 ids, D = 18, f32, 100,001 rows) that is about
// 33.5 MB + 75.5 MB + 7.2 MB, about 0.035 ms at 3.35 TB/s (H100 SXM);
// chip_smoke.embedding_bag_work counts it on each run's ids.  Rows are
// read once per occurrence, though: 8.4 M reads of 72 B there, from L2
// when the table fits (50 MB), so the L2 rate, not HBM's, bounds them
// (chip_smoke measures that rate on the card and reckons both).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void embedding_bag_warp(const int32_t* __restrict__ ids,
                                     const T* __restrict__ table,
                                     T* __restrict__ out, long long B,
                                     int S, int D, long long V1) {
  const int lane = threadIdx.x & 31;
  const long long bag =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (bag >= B) return;  // whole warps exit together
  const int32_t* bag_ids = ids + bag * (long long)S;
  const int zero_row = (int)(V1 - 1);  // V1 < 2^31: the wrapper checks
  for (int d0 = 0; d0 < D; d0 += 32) {
    const int d = d0 + lane;
    float acc = 0.f;
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int n_ids = S - s0 < 32 ? S - s0 : 32;
      const int32_t my_id = lane < n_ids ? bag_ids[s0 + lane] : 0;
      // unrolled so that several rows are in flight; the adds stay in
      // slot order
#pragma unroll 4
      for (int j = 0; j < n_ids; ++j) {
        const int32_t id = __shfl_sync(0xffffffffu, my_id, j);
        const int w = id < 0 ? id + zero_row + 1 : id;  // from the end
        const int row = (unsigned)w < (unsigned)zero_row ? w : zero_row;
        if (d < D) acc += to_float(table[(long long)row * D + d]);
      }
    }
    if (d < D) store(out + bag * (long long)D + d, acc);
  }
}


// -- embedding_bag_packed ----------------------------------------------------

constexpr int kSlotTile = 16;             // slots of ids staged at a time
constexpr int kTileStride = kSlotTile + 1;  // odd: bags on distinct banks
constexpr int kMaxBagsPerBlock = kWarpsPerBlock * 32;
constexpr int kInFlight = 8;              // rows in flight per lane

template <int VB> struct Vec;
template <> struct Vec<16> { using type = uint4; };
template <> struct Vec<8> { using type = uint2; };
template <> struct Vec<4> { using type = unsigned int; };
template <> struct Vec<2> { using type = unsigned short; };

__device__ __forceinline__ void to_words(const uint4& r, unsigned* w) {
  w[0] = r.x; w[1] = r.y; w[2] = r.z; w[3] = r.w;
}
__device__ __forceinline__ void to_words(const uint2& r, unsigned* w) {
  w[0] = r.x; w[1] = r.y;
}
__device__ __forceinline__ void to_words(unsigned int r, unsigned* w) {
  w[0] = r;
}
__device__ __forceinline__ void to_words(unsigned short r, unsigned* w) {
  w[0] = r;
}
__device__ __forceinline__ void from_words(const unsigned* w, uint4& r) {
  r = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void from_words(const unsigned* w, uint2& r) {
  r = make_uint2(w[0], w[1]);
}
__device__ __forceinline__ void from_words(const unsigned* w,
                                           unsigned int& r) {
  r = w[0];
}
__device__ __forceinline__ void from_words(const unsigned* w,
                                           unsigned short& r) {
  r = (unsigned short)w[0];
}

// acc[e] += element e of the vector in words w (bf16 widens exactly by a
// shift, as __bfloat162float does)
template <typename T, int E>
__device__ __forceinline__ void add_words(float (&acc)[E],
                                          const unsigned* w);
template <>
__device__ __forceinline__ void add_words<float, 4>(float (&acc)[4],
                                                    const unsigned* w) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += __uint_as_float(w[e]);
}
template <>
__device__ __forceinline__ void add_words<float, 2>(float (&acc)[2],
                                                    const unsigned* w) {
  acc[0] += __uint_as_float(w[0]);
  acc[1] += __uint_as_float(w[1]);
}
template <>
__device__ __forceinline__ void add_words<float, 1>(float (&acc)[1],
                                                    const unsigned* w) {
  acc[0] += __uint_as_float(w[0]);
}
template <int E>
__device__ __forceinline__ void add_bf16_words(float (&acc)[E],
                                               const unsigned* w) {
#pragma unroll
  for (int e = 0; e < E; ++e)
    acc[e] += __uint_as_float(e & 1 ? w[e >> 1] & 0xffff0000u
                                    : w[e >> 1] << 16);
}
template <>
__device__ __forceinline__ void add_words<__nv_bfloat16, 8>(
    float (&acc)[8], const unsigned* w) {
  add_bf16_words<8>(acc, w);
}
template <>
__device__ __forceinline__ void add_words<__nv_bfloat16, 4>(
    float (&acc)[4], const unsigned* w) {
  add_bf16_words<4>(acc, w);
}
template <>
__device__ __forceinline__ void add_words<__nv_bfloat16, 2>(
    float (&acc)[2], const unsigned* w) {
  add_bf16_words<2>(acc, w);
}
template <>
__device__ __forceinline__ void add_words<__nv_bfloat16, 1>(
    float (&acc)[1], const unsigned* w) {
  add_bf16_words<1>(acc, w);
}

__device__ __forceinline__ unsigned bf16_bits(float x) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// the words of the output vector: fp32 as is, bf16 rounded to nearest even
template <typename T, int E>
__device__ __forceinline__ void pack_words(const float (&acc)[E],
                                           unsigned* w) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int e = 0; e < E; ++e) w[e] = __float_as_uint(acc[e]);
  } else {
#pragma unroll
    for (int e = 0; e < E; e += 2)
      w[e >> 1] = bf16_bits(acc[e]) |
                  (e + 1 < E ? bf16_bits(acc[e + 1]) << 16 : 0u);
  }
}

template <typename T, int VB>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    embedding_bag_packed(const int32_t* __restrict__ ids,
                         const T* __restrict__ table, T* __restrict__ out,
                         long long B, int S, int nv, int G, long long V1) {
  using Raw = typename Vec<VB>::type;
  constexpr int E = VB / (int)sizeof(T);   // elements per vector
  constexpr int W = VB >= 4 ? VB / 4 : 1;  // 32-bit words per vector
  __shared__ int32_t tile[kMaxBagsPerBlock * kTileStride];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bags_per_block = kWarpsPerBlock * G;
  const long long bag0 = (long long)blockIdx.x * bags_per_block;
  const int lanes_per_bag = G == 1 ? 32 : nv;
  const int local = warp * G + lane / lanes_per_bag;  // bag in the block
  const long long bag = bag0 + local;
  const bool has_bag = lane / lanes_per_bag < G && bag < B;
  const int zero_row = (int)(V1 - 1);  // V1 < 2^31: the wrapper checks
  const Raw* rows = reinterpret_cast<const Raw*>(table);
  Raw* dst = reinterpret_cast<Raw*>(out);
  const long long n_bags =
      B - bag0 < bags_per_block ? B - bag0 : bags_per_block;

  // one pass when G > 1; a wide row's vectors in strides of 32 lanes
  for (int v0 = 0; v0 < nv; v0 += lanes_per_bag) {
    const int v = v0 + lane % lanes_per_bag;
    const bool live = has_bag && v < nv;
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
    for (int s0 = 0; s0 < S; s0 += kSlotTile) {
      const int sc = S - s0 < kSlotTile ? S - s0 : kSlotTile;
      __syncthreads();  // the previous tile is consumed
      for (int e = tid; e < n_bags * sc; e += 32 * kWarpsPerBlock) {
        const int r = e / sc, j = e - r * sc;
        tile[r * kTileStride + j] = ids[(bag0 + r) * S + s0 + j];
      }
      __syncthreads();
      if (!live) continue;
      const int32_t* my_ids = tile + local * kTileStride;
      for (int j0 = 0; j0 < sc; j0 += kInFlight) {
        Raw raw[kInFlight];
#pragma unroll
        for (int k = 0; k < kInFlight; ++k) {
          if (j0 + k < sc) {
            const int id = my_ids[j0 + k];
            const int w = id < 0 ? id + zero_row + 1 : id;  // from the end
            const int row = (unsigned)w < (unsigned)zero_row ? w : zero_row;
            raw[k] = __ldg(rows + (size_t)row * nv + v);
          }
        }
        // the adds stay in slot order
#pragma unroll
        for (int k = 0; k < kInFlight; ++k) {
          if (j0 + k < sc) {
            unsigned w[W];
            to_words(raw[k], w);
            add_words<T, E>(acc, w);
          }
        }
      }
    }
    if (live) {
      unsigned w[W];
      pack_words<T, E>(acc, w);
      Raw r;
      from_words(w, r);
      dst[bag * nv + v] = r;
    }
  }
}

template <typename T, int VB>
cudaError_t launch_packed(const void* ids, const void* table, void* out,
                          long long B, int S, int D, long long V1, int G,
                          cudaStream_t st) {
  const int nv = (int)((long long)D * (long long)sizeof(T) / VB);
  if (G < 1 || (G > 1 && G * nv > 32)) return cudaErrorInvalidValue;
  const long long per_block = (long long)kWarpsPerBlock * G;
  const long long blocks = (B + per_block - 1) / per_block;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  embedding_bag_packed<T, VB><<<(unsigned)blocks, 32 * kWarpsPerBlock, 0,
                                st>>>((const int32_t*)ids, (const T*)table,
                                      (T*)out, B, S, nv, G, V1);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes.  dtype 0 = float32,
// 1 = bfloat16.  Each launches on `stream` and returns
// cudaGetLastError() (0 on success); neither synchronises.

// The packed design; vb is the vector width in bytes (16, 8, 4, or 2 in
// bfloat16): it must divide D x the element size and the alignment of
// the table and the output; bags is the bags a warp holds (G: with
// D x size / vb vectors a row, G of them fit in 32 lanes, or G = 1).
extern "C" int embedding_bag_packed_launch(const void* ids, const void* table,
                                           void* out, long long B, int S,
                                           int D, long long V1, int dtype,
                                           int vb, int bags, void* stream) {
  if (B <= 0 || S < 0 || D <= 0 || V1 <= 0) return (int)cudaErrorInvalidValue;
  const int elem = dtype == 0 ? 4 : 2;
  if (dtype < 0 || dtype > 1 || vb < elem || vb > 16 || (vb & (vb - 1)) ||
      ((long long)D * elem) % vb)
    return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  cudaError_t (*fn)(const void*, const void*, void*, long long, int, int,
                    long long, int, cudaStream_t);
  if (dtype == 0)
    fn = vb == 16 ? launch_packed<float, 16>
         : vb == 8 ? launch_packed<float, 8> : launch_packed<float, 4>;
  else
    fn = vb == 16 ? launch_packed<bf16, 16>
         : vb == 8 ? launch_packed<bf16, 8>
         : vb == 4 ? launch_packed<bf16, 4> : launch_packed<bf16, 2>;
  return (int)fn(ids, table, out, B, S, D, V1, bags, (cudaStream_t)stream);
}

// The warp design.
extern "C" int embedding_bag_launch(const void* ids, const void* table,
                                    void* out, long long B, int S, int D,
                                    long long V1, int dtype, void* stream) {
  if (B <= 0 || S < 0 || D <= 0 || V1 <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 32 * kWarpsPerBlock;
  const long long blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    embedding_bag_warp<float><<<(unsigned)blocks, threads, 0, st>>>(
        (const int32_t*)ids, (const float*)table, (float*)out, B, S, D, V1);
  } else if (dtype == 1) {
    embedding_bag_warp<__nv_bfloat16><<<(unsigned)blocks, threads, 0, st>>>(
        (const int32_t*)ids, (const __nv_bfloat16*)table,
        (__nv_bfloat16*)out, B, S, D, V1);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
