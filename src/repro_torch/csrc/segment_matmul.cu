// segment_matmul: segment sums of edge values for Hopper.
//
// Replaces the Pallas TPU kernel `_kernel` at
// src/repro/kernels/segment_matmul/kernel.py:34 (reached through
// segment_matmul_pallas -> _segment_matmul_jit -> pallas_call).
//
//   out[i] = sum of vals[e] over the edges e with dst[e] == i
//
// for i in [0, N); ids outside [0, N), negatives included, are dropped.
// Sums run in fp32 and are cast once to the dtype of vals (f32 or bf16);
// a segment with no edge gets zeros.
//
// The TPU kernel forms a [E_blk, N_blk] one-hot tile for every (node
// block, edge block) and puts one_hot^T @ vals on the MXU: O(E N D) work
// for an O(E D) function, because the TPU has no fast scatter.  Hopper
// needs no one-hot.  The wrapper sorts dst stably (torch.sort, index
// bookkeeping only), and this file does the sums as a segmented
// reduction over the sorted order, reading each row of vals through
// the permutation, with no float atomics, so the result is the same bit
// for bit from run to run.
//
// Bound on this card: the function must read vals once (E D s bytes),
// dst once (4 E) and write out once (N D s); at the full-graph
// aggregation of the dspc CONFIG graph (E = 1048576, N = 65536, D = 128,
// f32) that is 574.6 MB, 0.17 ms at 3.35 TB/s (H100 SXM): bound by bytes
// (chip_smoke.segment_matmul_work counts it on each run's inputs).
//
// Design.  Degrees follow a power law: on that graph the longest
// segment has 14329 edges and the mean 16, so one warp per segment would
// leave the card idle behind one warp.  Instead the sorted edge list is
// cut into fixed chunks of `chunk` positions, whatever the segments:
//   pass 1 (chunk_sums): one warp per chunk, lanes over D with 16-byte
//     loads of f32 (8-byte of bf16), 8 rows in flight per lane.  A
//     segment that lies inside the chunk is written to out directly; a
//     segment that crosses the chunk's edge leaves an fp32 partial in
//     one of the chunk's two slots: slot 0 for the chunk's first
//     segment when it began in an earlier chunk, slot 1 for its last
//     segment when it began here and goes on past the chunk.
//   segment_starts: one thread per sorted position writes where each
//     segment begins (the segments between two neighbouring ids begin,
//     and end empty, at the second one).
//   pass 2 (combine): one warp per segment.  It writes zeros for an
//     empty segment and, for a segment that spans chunks c0..c1, adds
//     slot 1 of c0 and slot 0 of c0+1..c1 in chunk order, eight partial
//     rows in flight; other segments exit at once.
// Every segment is written exactly once, by one of the two passes.  A
// segment of k edges costs its pass-2 warp about k / chunk partial rows
// (112 for the longest segment above).  Giving a pass-2 warp 32
// neighbouring segments instead would bring the imbalance back: on that
// graph the busiest vertices have neighbouring ids, and the warp of
// segments 0-31 would add 845 partial rows one after another.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kRowsInFlight = 8;  // rows of vals a lane loads before adding
constexpr unsigned kFull = 0xffffffffu;

template <typename T, int VW>
struct Vec;

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    v[0] = __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *p = v[0];
  }
};

template <>
struct Vec<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* v) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
    v[0] = __low2float(a); v[1] = __high2float(a);
    v[2] = __low2float(b); v[3] = __high2float(b);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    uint2 x;
    *reinterpret_cast<__nv_bfloat162*>(&x.x) =
        __floats2bfloat162_rn(v[0], v[1]);
    *reinterpret_cast<__nv_bfloat162*>(&x.y) =
        __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = x;
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* v) {
    v[0] = __bfloat162float(p[0]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    *p = __float2bfloat16_rn(v[0]);
  }
};

// Pass 1: one warp per chunk of sorted positions [p0, p1).
template <typename T, int VW>
__global__ void chunk_sums(const T* __restrict__ vals,
                           const int32_t* __restrict__ skey,
                           const int64_t* __restrict__ perm,
                           float* __restrict__ partial,
                           T* __restrict__ out,
                           long long E, int N, int D, int chunk) {
  const int lane = threadIdx.x & 31;
  const long long c =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const long long p0 = c * chunk;
  if (p0 >= E) return;  // whole warps exit together
  const long long p1 = p0 + chunk < E ? p0 + chunk : E;
  // the ids just outside the chunk tell which segments cross its edges
  // (-1 outside the list: a dropped id, never a segment's)
  const int before = p0 > 0 ? skey[p0 - 1] : -1;
  const int after = p1 < E ? skey[p1] : -1;
  const int groups = (D + 32 * VW - 1) / (32 * VW);
  for (int g = 0; g < groups; ++g) {
    const int col = (g * 32 + lane) * VW;
    const bool active = col < D;
    int cur = -1;
    float acc[VW];
#pragma unroll
    for (int k = 0; k < VW; ++k) acc[k] = 0.f;
    auto flush = [&](int s) {
      if (s < 0 || s >= N || !active) return;
      const bool head = s == before, tail = s == after;
      if (!head && !tail) {
        float o[VW];
#pragma unroll
        for (int k = 0; k < VW; ++k) o[k] = acc[k];
        Vec<T, VW>::store(out + (long long)s * D + col, o);
      } else {
        Vec<float, VW>::store(partial + (c * 2 + (head ? 0 : 1)) * D + col,
                              acc);
      }
    };
    for (long long base = p0; base < p1; base += 32) {
      // lanes load 32 (id, row) pairs together, then pass them around
      const long long p = base + lane;
      const int key_l = p < p1 ? skey[p] : -1;
      const long long row_l = p < p1 ? perm[p] : 0;
      const int cnt = (int)(p1 - base < 32 ? p1 - base : 32);
      for (int j = 0; j < cnt; j += kRowsInFlight) {
        int key[kRowsInFlight];
        float v[kRowsInFlight][VW];
#pragma unroll
        for (int u = 0; u < kRowsInFlight; ++u) {
          key[u] = __shfl_sync(kFull, key_l, j + u);
          const long long row = __shfl_sync(kFull, row_l, j + u);
          const bool live = j + u < cnt && key[u] >= 0 && key[u] < N && active;
          if (live) {
            Vec<T, VW>::load(vals + row * D + col, v[u]);
          } else {
#pragma unroll
            for (int k = 0; k < VW; ++k) v[u][k] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kRowsInFlight; ++u) {
          if (j + u >= cnt) break;
          if (key[u] != cur) {
            flush(cur);
            cur = key[u];
#pragma unroll
            for (int k = 0; k < VW; ++k) acc[k] = 0.f;
          }
#pragma unroll
          for (int k = 0; k < VW; ++k) acc[k] += v[u][k];
        }
      }
    }
    flush(cur);
  }
}

// starts[s] = the first sorted position whose id is >= s, for s in
// [0, N]; ids below 0 count as -1 and ids from N on as N (dropped).
__global__ void segment_starts(const int32_t* __restrict__ skey,
                               int64_t* __restrict__ starts, long long E,
                               int N) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p > E) return;
  int prev = p == 0 ? -1 : skey[p - 1];
  int cur = p == E ? N : skey[p];
  prev = prev < -1 ? -1 : (prev > N ? N : prev);
  cur = cur < -1 ? -1 : (cur > N ? N : cur);
  for (int s = prev + 1; s <= cur; ++s) starts[s] = p;
}

// Pass 2: one warp per segment; empty segments and segments that span
// chunks.
template <typename T, int VW>
__global__ void combine(const int64_t* __restrict__ starts,
                        const float* __restrict__ partial,
                        T* __restrict__ out, int N, int D, int chunk) {
  const int lane = threadIdx.x & 31;
  const long long s =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (s >= N) return;  // whole warps exit together
  const long long st = starts[s], en = starts[s + 1];
  const long long c0 = st / chunk;
  const long long c1 = st < en ? (en - 1) / chunk : c0;
  if (st < en && c0 == c1) return;  // pass 1 wrote it
  const int groups = (D + 32 * VW - 1) / (32 * VW);
  for (int g = 0; g < groups; ++g) {
    const int col = (g * 32 + lane) * VW;
    if (col >= D) continue;
    float acc[VW];
#pragma unroll
    for (int k = 0; k < VW; ++k) acc[k] = 0.f;
    if (st < en) {
      Vec<float, VW>::load(partial + (c0 * 2 + 1) * D + col, acc);
      long long cc = c0 + 1;
      for (; cc + kRowsInFlight <= c1 + 1; cc += kRowsInFlight) {
        float v[kRowsInFlight][VW];
#pragma unroll
        for (int u = 0; u < kRowsInFlight; ++u)
          Vec<float, VW>::load(partial + (cc + u) * 2 * D + col, v[u]);
#pragma unroll
        for (int u = 0; u < kRowsInFlight; ++u)
#pragma unroll
          for (int k = 0; k < VW; ++k) acc[k] += v[u][k];
      }
      for (; cc <= c1; ++cc) {
        float v[VW];
        Vec<float, VW>::load(partial + cc * 2 * D + col, v);
#pragma unroll
        for (int k = 0; k < VW; ++k) acc[k] += v[k];
      }
    }
    Vec<T, VW>::store(out + s * D + col, acc);
  }
}

template <typename T, int VW>
int launch(const void* vals, const void* skey, const void* perm,
           void* starts, void* partial, void* out, long long E, int N,
           int D, int chunk, cudaStream_t stream) {
  const int threads = 32 * kWarpsPerBlock;
  segment_starts<<<(unsigned)((E + threads) / threads), threads, 0,
                   stream>>>((const int32_t*)skey, (int64_t*)starts, E, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long chunks = (E + chunk - 1) / chunk;
  if (chunks > 0) {
    const long long blocks = (chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
    chunk_sums<T, VW><<<(unsigned)blocks, threads, 0, stream>>>(
        (const T*)vals, (const int32_t*)skey, (const int64_t*)perm,
        (float*)partial, (T*)out, E, N, D, chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = ((long long)N + kWarpsPerBlock - 1) /
                           kWarpsPerBlock;
  combine<T, VW><<<(unsigned)blocks, threads, 0, stream>>>(
      (const int64_t*)starts, (const float*)partial, (T*)out, N, D, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes.  vals [E, D] (dtype 0: f32,
// 1: bf16), skey int32 [E] sorted ascending with perm int64 [E] the
// stable order that sorts dst, starts int64 [N + 1] and partial fp32
// [ceil(E / chunk), 2, D] scratch, out [N, D] in the dtype of vals.
// vec4 != 0 asks for 4-wide vector loads (D % 4 == 0 and vals, out
// aligned to 4 elements).  Launches the three kernels on `stream` and
// returns cudaGetLastError() (0 on success); never synchronises.
extern "C" int segment_matmul_launch(const void* vals, const void* skey,
                                     const void* perm, void* starts,
                                     void* partial, void* out, long long E,
                                     int N, int D, int chunk, int dtype,
                                     int vec4, void* stream) {
  if (E < 0 || N <= 0 || D <= 0 || chunk <= 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return vec4 ? launch<float, 4>(vals, skey, perm, starts, partial, out,
                                   E, N, D, chunk, s)
                : launch<float, 1>(vals, skey, perm, starts, partial, out,
                                   E, N, D, chunk, s);
  }
  return vec4 ? launch<__nv_bfloat16, 4>(vals, skey, perm, starts, partial,
                                         out, E, N, D, chunk, s)
              : launch<__nv_bfloat16, 1>(vals, skey, perm, starts, partial,
                                         out, E, N, D, chunk, s);
}
