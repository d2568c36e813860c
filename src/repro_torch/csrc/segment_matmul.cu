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
// a segment with no edge gets zeros.  Neither design below uses a float
// atomic: each adds in a fixed order, so the result is the same bit for
// bit from run to run.
//
// The TPU kernel forms a [E_blk, N_blk] one-hot tile for every (node
// block, edge block) and puts one_hot^T @ vals on the MXU: O(E N D) work
// for an O(E D) function, because the TPU has no fast scatter.  Hopper
// needs no one-hot.  The wrapper (kernels/segment_matmul/kernel.py)
// picks one of two designs from the shapes (E, N, D, dtype) alone.
//
// Bound on this card: the function must read vals once (E D s bytes),
// dst once (4 E) and write out once (N D s); at the full-graph
// aggregation of the dspc CONFIG graph (E = 1048576, N = 65536, D = 128,
// f32) that is 574.6 MB, 0.17 ms at 3.35 TB/s (H100 SXM): bound by bytes
// (chip_smoke.segment_matmul_work counts it on each run's inputs).
//
// The blocked design (block_sums), for few segments.  The TPU kernel's
// node-block decomposition without its one-hot product: one launch, no
// sort, no scratch in device memory.  One CTA of 8 warps owns `nblk`
// consecutive segments and keeps their fp32 rows in shared memory;
// segment n0 + r belongs to warp r % 8, which alone adds into its row.
// The CTA reads dst in steps of 4096 ids (16-byte loads, one step ahead;
// after the first CTA the ids come from L2): warp w lists, in id order,
// the hits of the block in the w-th eighth of the step (ballot counts
// and a prefix sum over the lanes); after a __syncthreads every warp
// walks the 8 lists in order, queues the hits of its own segments and
// adds their rows, lanes over D, 16 rows in flight.  So each segment is
// summed in id order from zero, one add after another -- the float32
// sum of a sequential loop -- and a run of hits (sorted ids put all of
// a block's edges in one run) is still shared by the 8 warps when its
// segments differ.  At the end the CTA writes every row of its block
// once (an empty segment keeps its zeros).  Every CTA reads all of dst,
// so its id traffic is E x 4 x ceil(N / nblk) bytes: the wrapper takes
// this design only where that is no more than the E D s bytes of vals,
// and where the CTAs are enough for vals.  At the kernel microbench's
// shape (E = 16384, N = 2048, D = 128, f32) nblk = 16 gives 128 CTAs
// and 8 MB of ids read from L2 beside 8 MB of vals.  The edges of one
// segment are added by one warp, and a block that owns most of the
// edges (ids skewed onto a few segments) is read by one SM: the shapes
// cannot show that, so the wrapper bounds the average bytes of vals per
// CTA instead.
//
// The sorted design, for many segments.  The wrapper sorts dst stably
// (torch.sort, index bookkeeping only), and the kernels below do the
// sums as a segmented reduction over the sorted order, reading each row
// of vals through the permutation.
//
// Its chunks.  Degrees follow a power law: on that graph the longest
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

// ---- the blocked design ---------------------------------------------

constexpr int kBlockWarps = 8;
constexpr int kScanIds = 4 * 32 * 4;            // ids one warp scans a step
constexpr int kStepIds = kScanIds * kBlockWarps;  // ids a CTA scans a step
constexpr int kHitsInFlight = 16;  // rows of vals a lane loads before adding
constexpr int kQueue = 2 * 32;     // a warp's hits waiting for their adds

// Four ids from position e: one 16-byte load where all four lie inside
// dst and `vec` says dst is 16-byte aligned (e is a multiple of 4), else
// scalar loads; -1 (a dropped id) past the end.
__device__ __forceinline__ int4 load_ids(const int32_t* __restrict__ dst,
                                         long long e, long long E,
                                         bool vec) {
  if (vec && e + 4 <= E) return __ldg(reinterpret_cast<const int4*>(dst + e));
  int4 r;
  r.x = e < E ? __ldg(dst + e) : -1;
  r.y = e + 1 < E ? __ldg(dst + e + 1) : -1;
  r.z = e + 2 < E ? __ldg(dst + e + 2) : -1;
  r.w = e + 3 < E ? __ldg(dst + e + 3) : -1;
  return r;
}

template <int VW>
__device__ __forceinline__ void smem_add(float* a, const float* v);
template <>
__device__ __forceinline__ void smem_add<4>(float* a, const float* v) {
  float4 x = *reinterpret_cast<float4*>(a);
  x.x += v[0]; x.y += v[1]; x.z += v[2]; x.w += v[3];
  *reinterpret_cast<float4*>(a) = x;
}
template <>
__device__ __forceinline__ void smem_add<1>(float* a, const float* v) {
  a[0] += v[0];
}

// Add the rows of a warp's `queued` hits (edge, offset in the block)
// into `acc`, in queue order, lanes over D, kHitsInFlight rows in flight.
template <typename T, int VW>
__device__ __forceinline__ void add_queued(const T* __restrict__ vals,
                                           const int2* queue, int queued,
                                           float* acc, int D, int lane) {
  const int col_groups = (D + 32 * VW - 1) / (32 * VW);
  for (int i = 0; i < queued; i += kHitsInFlight) {
    const int cnt = queued - i < kHitsInFlight ? queued - i
                                               : kHitsInFlight;
    for (int cg = 0; cg < col_groups; ++cg) {
      const int col = (cg * 32 + lane) * VW;
      if (col >= D) break;
      float v[kHitsInFlight][VW];
#pragma unroll
      for (int u = 0; u < kHitsInFlight; ++u)
        if (u < cnt) Vec<T, VW>::load(
            vals + (long long)queue[i + u].x * D + col, v[u]);
#pragma unroll
      for (int u = 0; u < kHitsInFlight; ++u)
        if (u < cnt) smem_add<VW>(acc + queue[i + u].y * D + col, v[u]);
    }
  }
}

// One CTA per block of nblk segments; segment n0 + r belongs to warp
// r % 8, which alone adds its rows.  Dynamic shared memory: the block's
// [nblk, D] fp32 accumulators, 8 lists of up to kScanIds hits (edge,
// offset in the block) with their counts, and 8 queues of kQueue hits.
// Each step of kStepIds ids has two phases: warp w scans the w-th
// eighth of the step (its ids loaded a step ahead) and lists its hits in
// id order; then every warp walks the 8 lists in order and adds the hits
// of its own segments.  So every segment is summed in id order from
// zero, one add after another: the float32 sum a sequential loop would
// give, the same bits on every launch.
template <typename T, int VW>
__global__ void __launch_bounds__(32 * kBlockWarps, 1)
block_sums(const T* __restrict__ vals, const int32_t* __restrict__ dst,
           T* __restrict__ out, long long E, int N, int D, int nblk,
           int ids_vec) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);
  int2* lists = reinterpret_cast<int2*>(acc + nblk * D);
  int2* queue = lists + kBlockWarps * kScanIds + (threadIdx.x >> 5) * kQueue;
  int* counts = reinterpret_cast<int*>(lists + kBlockWarps * kScanIds +
                                       kBlockWarps * kQueue);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * nblk;
  const int nb = N - n0 < nblk ? N - n0 : nblk;
  for (int i = threadIdx.x; i < nb * D; i += 32 * kBlockWarps) acc[i] = 0.f;
  int2* mine = lists + warp * kScanIds;
  const bool vec = ids_vec != 0;

  int4 ids[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    ids[j] = load_ids(dst, (long long)warp * kScanIds + (j * 32 + lane) * 4,
                      E, vec);
  int queued = 0;  // the same in every lane
  for (long long base = 0; base < E; base += kStepIds) {
    // phase 1: list the hits of this warp's eighth, in id order
    const long long e_lo = base + (long long)warp * kScanIds;
    int listed = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int x[4] = {ids[j].x, ids[j].y, ids[j].z, ids[j].w};
      unsigned m = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        m |= ((unsigned)x[k] - (unsigned)n0 < (unsigned)nb ? 1u : 0u) << k;
      if (__ballot_sync(kFull, m) == 0u) continue;  // the same in all lanes
      const int c = __popc(m);
      int pre = c;  // inclusive prefix sum of the lanes' hits
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, pre, o);
        if (lane >= o) pre += t;
      }
      const int e0 = (int)(e_lo + (j * 32 + lane) * 4);
      int pos = listed + pre - c;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (m >> k & 1u) mine[pos++] = make_int2(e0 + k, x[k] - n0);
      listed += __shfl_sync(kFull, pre, 31);
    }
    if (lane == 0) counts[warp] = listed;
    // the next step's ids, in flight during phase 2
    if (base + kStepIds < E) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ids[j] = load_ids(dst, e_lo + kStepIds + (j * 32 + lane) * 4, E,
                          vec);
    }
    __syncthreads();
    // phase 2: this warp's hits from the 8 lists, in list order
    for (int w = 0; w < kBlockWarps; ++w) {
      const int n = counts[w];
      for (int c0 = 0; c0 < n; c0 += 32) {
        const int2 hit = c0 + lane < n ? lists[w * kScanIds + c0 + lane]
                                       : make_int2(0, -1);
        const bool own = hit.y >= 0 && hit.y % kBlockWarps == warp;
        const unsigned sel = __ballot_sync(kFull, own);
        if (own) queue[queued + __popc(sel & ((1u << lane) - 1))] = hit;
        queued += __popc(sel);
        if (queued >= 32) {
          __syncwarp();
          add_queued<T, VW>(vals, queue, queued, acc, D, lane);
          __syncwarp();  // every lane has read the queue
          queued = 0;
        }
      }
    }
    __syncthreads();  // the lists are refilled next step
  }
  __syncwarp();
  add_queued<T, VW>(vals, queue, queued, acc, D, lane);

  // every row of the block once (an empty segment keeps its zeros)
  __syncthreads();
  T* o = out + (long long)n0 * D;
  for (int i = threadIdx.x * VW; i < nb * D; i += 32 * kBlockWarps * VW)
    Vec<T, VW>::store(o + i, acc + i);
}

// Bytes of dynamic shared memory block_sums needs for nblk x D: at most
// 45 KB for the wrapper's nblk x D <= 2048, inside the 48 KB a launch
// may ask for without opting in.
inline size_t block_smem(int nblk, int D) {
  return (size_t)nblk * D * sizeof(float) +
         (size_t)kBlockWarps * (kScanIds + kQueue) * sizeof(int2) +
         kBlockWarps * sizeof(int);
}

template <typename T, int VW>
int launch_blocked(const void* vals, const void* dst, void* out, long long E,
                   int N, int D, int nblk, int ids_vec, cudaStream_t stream) {
  const long long blocks = ((long long)N + nblk - 1) / nblk;
  block_sums<T, VW><<<(unsigned)blocks, 32 * kBlockWarps,
                      block_smem(nblk, D), stream>>>(
      (const T*)vals, (const int32_t*)dst, (T*)out, E, N, D, nblk, ids_vec);
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

// Plain C entry point of the blocked design, bound with ctypes.  vals
// [E, D] (dtype 0: f32, 1: bf16), dst int32 [E] in any order, out [N, D]
// in the dtype of vals; nblk segments per CTA.  vec4 != 0 asks for
// 4-wide vector loads of vals and stores of out (D % 4 == 0, both
// aligned to 4 elements); ids_vec != 0 for 16-byte loads of dst (dst
// 16-byte aligned).  One launch on `stream`, no scratch; returns
// cudaGetLastError() (0 on success); never synchronises.
extern "C" int segment_matmul_blocked_launch(const void* vals,
                                             const void* dst, void* out,
                                             long long E, int N, int D,
                                             int nblk, int dtype, int vec4,
                                             int ids_vec, void* stream) {
  if (E < 0 || E > 2147483647LL || N <= 0 || D <= 0 || nblk <= 0 ||
      dtype < 0 || dtype > 1 || block_smem(nblk, D) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return vec4 ? launch_blocked<float, 4>(vals, dst, out, E, N, D, nblk,
                                           ids_vec, s)
                : launch_blocked<float, 1>(vals, dst, out, E, N, D, nblk,
                                           ids_vec, s);
  }
  return vec4 ? launch_blocked<__nv_bfloat16, 4>(vals, dst, out, E, N, D,
                                                 nblk, ids_vec, s)
              : launch_blocked<__nv_bfloat16, 1>(vals, dst, out, E, N, D,
                                                 nblk, ids_vec, s);
}
