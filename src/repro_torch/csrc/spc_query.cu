// spc_query: batched SPC-Index pair queries (Algorithm 1) for Hopper.
//
// Replaces the Pallas TPU kernel `_kernel` at
// src/repro/kernels/spc_query/kernel.py:38 (reached through
// spc_query_pallas -> _spc_query_jit -> pallas_call).
//
// Per pair b, over the label rows (hub, dist, cnt) of s and t:
//   d[b] = min over common hubs h of dist_s(h) + dist_t(h)
//   c[b] = sum over the common hubs at that minimum of cnt_s * cnt_t
// and (INF, 0) when the rows share no hub (or the minimum is >= INF).
//
// Differences from the TPU kernel:
//   * counts are int64 in and out (the TPU VPU has no int64, so the
//     Pallas kernel counts in fp32, exact only to 2^24).  Products and
//     sums wrap modulo 2^64 exactly as the reference's int64 does; they
//     are formed on unsigned 64-bit values so the wrap is defined.
//   * no L x L comparison table: rows must be sorted by hub id (the
//     index keeps them so, with the pad sentinel last:
//     src/repro/core/labels.py:3-5).  A hub may repeat on either side
//     (the reference's microbench draws such rows); every equal pair
//     counts, as in the L x L table.  Labels with dist >= INF are
//     skipped on both sides: their sums are >= INF, and a minimum >= INF
//     answers (INF, 0) whatever the counts.
//
// Two kernels:
//
// spc_query_fused (the serve route) reads the label rows by vertex id
// straight from the index [n + 1, L] -- no gathered [B, L] operands.  An
// id follows the reference's gather rule: a negative id wraps once
// (id + n + 1), then the row is clamped to [0, n].  One CTA of 4 warps
// per pair, so a batch of 1024 pairs is one wave of 8 CTAs per SM:
//   1. where each row's labels end: 64 threads sample a row at every
//      ceil(L / 64)-th position; labels are sorted with the pads (hub >=
//      `limit`, the index's n) last, so the count of real samples bounds
//      the real length to within one stride (`ub`).  One round trip for
//      both rows, instead of walking L.
//   2. the longer row's hubs [0, ub) are copied into shared memory with
//      cp.async (16-byte copies where the row is 16-byte aligned), while
//      the threads read the shorter row's hubs from device memory,
//      coalesced, 4 per thread in flight.
//   3. each real hub of the shorter row is binary-searched (lower bound)
//      in shared memory and the run of equal hubs walked from there;
//      dist and cnt are read from device memory only at matches: a
//      thread first searches its 4 hubs, then has the loads of all its
//      matches (both sides) in flight together, with its next 4 hubs
//      behind them.  The common hubs crowd the rows' first labels (the
//      top-ranked hubs), so most threads meet one or more at once, and
//      a round trip per match would be paid one after the other.
//   4. (min d, count) is combined over the warp by shuffles and over the
//      4 warps in shared memory under the rule "keep the smaller d; on
//      equal d add the counts": integer sums, so the result does not
//      depend on the order of the combine and the kernel is
//      deterministic.
// Where 4 L bytes exceed the staging limit the same kernel searches the
// row in device memory instead (template kStaged = false).  The form
// that takes gathered [B, L] rows (the reference's microbench, the TPU
// sweep) is the same kernel with identity ids and no length cut (limit
// INT_MAX), since there the pad hub is not known.
//
// spc_query_warp is the first design, kept so that the route it served
// (gather + re-pad + this kernel) can be timed beside the fused one:
// one warp per gathered pair, lanes walk L(s) and binary-search L(t) in
// device memory.
//
// Bound on this card: bytes.  The function must read the real hubs of
// both rows (where a row ends is found from a few samples), dist and
// cnt only at the common hubs (24 bytes each), the two ids, and write
// 12 bytes per pair.  At B = 1024 pairs of the dspc index (L = 2048,
// about 400 real labels a row, 117 common hubs a pair) that is about
// 6 MB, about 2 us at 3.35 TB/s (H100 SXM); reading both hub rows in
// full, as the gathered route must, is 16.8 MB (chip_smoke counts both
// on each run's rows).  What the fused kernel pays beyond that is four
// dependent round trips to device memory per pair (ids, samples, rows,
// matches), which the 8 resident CTAs per SM overlap.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 28;
constexpr int kBig = kInf * 2;
constexpr int kWarpsPerBlock = 8;      // spc_query_warp
constexpr int kPairThreads = 128;      // spc_query_fused: one CTA a pair
constexpr int kPairWarps = kPairThreads / 32;
constexpr int kSamples = kPairThreads / 2;  // samples of each row
constexpr int kBatch = 4;              // hubs of the shorter row in flight

// (d, c) <- the smaller d; on equal d the sum of the counts
__device__ __forceinline__ void combine(int& d, unsigned long long& c, int od,
                                        unsigned long long oc) {
  if (od < d) {
    d = od;
    c = oc;
  } else if (od == d) {
    c += oc;
  }
}

__device__ __forceinline__ void warp_combine(int& d, unsigned long long& c) {
  for (int off = 16; off > 0; off >>= 1) {
    const int od = __shfl_down_sync(0xffffffffu, d, off);
    const unsigned long long oc = __shfl_down_sync(0xffffffffu, c, off);
    combine(d, c, od, oc);
  }
}

__global__ void spc_query_warp(const int32_t* __restrict__ hub_s,
                               const int32_t* __restrict__ dist_s,
                               const int64_t* __restrict__ cnt_s,
                               const int32_t* __restrict__ hub_t,
                               const int32_t* __restrict__ dist_t,
                               const int64_t* __restrict__ cnt_t,
                               int32_t* __restrict__ d_out,
                               int64_t* __restrict__ c_out, int B, int L) {
  const int lane = threadIdx.x & 31;
  const long long pair =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pair >= B) return;  // whole warps exit together
  const long long base = pair * (long long)L;
  const int32_t* hs = hub_s + base;
  const int32_t* ds = dist_s + base;
  const int64_t* cs = cnt_s + base;
  const int32_t* ht = hub_t + base;
  const int32_t* dt = dist_t + base;
  const int64_t* ct = cnt_t + base;

  int best_d = kBig;
  unsigned long long best_c = 0ull;
  for (int i = lane; i < L; i += 32) {
    const int di = ds[i];
    if (di >= kInf) continue;
    const int h = hs[i];
    // lower_bound of h in the sorted row L(t) (searchsorted, left side)
    int lo = 0, hi = L;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (ht[mid] < h) lo = mid + 1; else hi = mid;
    }
    // every entry of the run of h in L(t)
    for (int q = lo; q < L && ht[q] == h; ++q) {
      const int dq = dt[q];
      if (dq >= kInf) continue;
      combine(best_d, best_c, di + dq,
              (unsigned long long)cs[i] * (unsigned long long)ct[q]);
    }
  }
  warp_combine(best_d, best_c);
  if (lane == 0) {
    const bool connected = best_d < kInf;
    d_out[pair] = connected ? best_d : kInf;
    c_out[pair] = connected ? (int64_t)best_c : 0;
  }
}

// The row of a pair's id: identity without ids; else the reference's
// gather rule (wrap a negative id once, then clamp to [0, rows - 1]).
__device__ __forceinline__ long long row_of(const int64_t* ids,
                                            long long pair, long long rows) {
  if (ids == nullptr) return pair;
  long long v = ids[pair];
  if (v < 0) v += rows;
  return v < 0 ? 0 : (v >= rows ? rows - 1 : v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// hubs i0, i0 + 128, ... of a row in flight together; `limit` (read as a
// pad) past ub
__device__ __forceinline__ void load_hubs(int (&h)[kBatch],
                                          const int32_t* hub, int i0, int ub,
                                          int limit) {
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    const int i = i0 + k * kPairThreads;
    h[k] = i < ub ? hub[i] : limit;
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kPairThreads)
    spc_query_fused(const int32_t* __restrict__ hub_s,
                    const int32_t* __restrict__ dist_s,
                    const int64_t* __restrict__ cnt_s,
                    const int32_t* __restrict__ hub_t,
                    const int32_t* __restrict__ dist_t,
                    const int64_t* __restrict__ cnt_t,
                    const int64_t* __restrict__ ids_s,
                    const int64_t* __restrict__ ids_t,
                    int32_t* __restrict__ d_out, int64_t* __restrict__ c_out,
                    long long rows, int L, int limit) {
  extern __shared__ __align__(16) int32_t staged[];  // the longer row
  __shared__ int real_samples[kPairWarps];
  __shared__ int warp_d[kPairWarps];
  __shared__ unsigned long long warp_c[kPairWarps];

  const long long pair = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long base_s = row_of(ids_s, pair, rows) * (long long)L;
  const long long base_t = row_of(ids_t, pair, rows) * (long long)L;

  // 1. where the labels end: the first half of the warps sample row s,
  // the second half row t
  const int stride = (L + kSamples - 1) / kSamples;
  const bool side_t = tid >= kSamples;
  const int p = min(((side_t ? tid - kSamples : tid) + 1) * stride, L) - 1;
  const int h_sample = side_t ? hub_t[base_t + p] : hub_s[base_s + p];
  const unsigned real = __ballot_sync(0xffffffffu, h_sample < limit);
  if (lane == 0) real_samples[warp] = __popc(real);
  __syncthreads();
  int k_s = 0, k_t = 0;
#pragma unroll
  for (int w = 0; w < kPairWarps / 2; ++w) {
    k_s += real_samples[w];
    k_t += real_samples[w + kPairWarps / 2];
  }
  // every label at or past ub is a pad
  const int ub_s = k_s == kSamples ? L : min((k_s + 1) * stride, L);
  const int ub_t = k_t == kSamples ? L : min((k_t + 1) * stride, L);

  // 2. iterate the shorter row (a), search the longer (b)
  const bool a_is_s = ub_s <= ub_t;
  const long long base_a = a_is_s ? base_s : base_t;
  const long long base_b = a_is_s ? base_t : base_s;
  const int32_t* hub_a = (a_is_s ? hub_s : hub_t) + base_a;
  const int32_t* dist_a = (a_is_s ? dist_s : dist_t) + base_a;
  const int64_t* cnt_a = (a_is_s ? cnt_s : cnt_t) + base_a;
  const int32_t* hub_b = (a_is_s ? hub_t : hub_s) + base_b;
  const int32_t* dist_b = (a_is_s ? dist_t : dist_s) + base_b;
  const int64_t* cnt_b = (a_is_s ? cnt_t : cnt_s) + base_b;
  const int ub_a = a_is_s ? ub_s : ub_t;
  const int ub_b = a_is_s ? ub_t : ub_s;

  const int32_t* search = hub_b;
  if (kStaged) {
    if ((L & 3) == 0 && ((uintptr_t)hub_b & 15) == 0) {
      // whole 16-byte chunks; the last may run past ub, not past the row
      for (int i = tid; i < (ub_b + 3) >> 2; i += kPairThreads)
        cp_async16(staged + 4 * i, hub_b + 4 * i);
    } else {
      for (int i = tid; i < ub_b; i += kPairThreads)
        cp_async4(staged + i, hub_b + i);
    }
    search = staged;
  }

  // 3. the shorter row's hubs, kBatch a thread in flight; the first
  // batch is read while the copy flies
  int h[kBatch];
  load_hubs(h, hub_a, tid, ub_a, limit);
  if (kStaged) {
    cp_async_wait_all();
    __syncthreads();
  }
  int best_d = kBig;
  unsigned long long best_c = 0ull;
  for (int i0 = tid; i0 < ub_a; i0 += kBatch * kPairThreads) {
    // lower_bound of each hub in the longer row (searchsorted, left
    // side); pos -1 where it is absent
    int hk[kBatch], pos[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      hk[k] = h[k];
      pos[k] = -1;
      if (hk[k] >= limit) continue;  // a pad, or past the row's end
      int lo = 0, hi = ub_b;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (search[mid] < hk[k]) lo = mid + 1; else hi = mid;
      }
      if (lo < ub_b && search[lo] == hk[k]) pos[k] = lo;
    }
    // dist and cnt of both sides at every match of the batch, all in
    // flight together, and the next batch's hubs behind them
    int da[kBatch], db[kBatch];
    unsigned long long ca[kBatch], cb[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      da[k] = db[k] = kInf;
      ca[k] = cb[k] = 0ull;
      if (pos[k] < 0) continue;
      const int i = i0 + k * kPairThreads;
      da[k] = dist_a[i];
      ca[k] = (unsigned long long)cnt_a[i];
      db[k] = dist_b[pos[k]];
      cb[k] = (unsigned long long)cnt_b[pos[k]];
    }
    load_hubs(h, hub_a, i0 + kBatch * kPairThreads, ub_a, limit);
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (pos[k] < 0 || da[k] >= kInf) continue;  // e.g. a pad's match
      // every entry of the run of the hub in the longer row
      for (int q = pos[k];;) {
        if (db[k] < kInf)
          combine(best_d, best_c, da[k] + db[k], ca[k] * cb[k]);
        if (++q == ub_b || search[q] != hk[k]) break;
        db[k] = dist_b[q];
        cb[k] = (unsigned long long)cnt_b[q];
      }
    }
  }

  // 4. combine over the warp, then over the CTA's warps
  warp_combine(best_d, best_c);
  if (lane == 0) {
    warp_d[warp] = best_d;
    warp_c[warp] = best_c;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kPairWarps; ++w)
      combine(best_d, best_c, warp_d[w], warp_c[w]);
    const bool connected = best_d < kInf;
    d_out[pair] = connected ? best_d : kInf;
    c_out[pair] = connected ? (int64_t)best_c : 0;
  }
}

}  // namespace

// Plain C entry points, bound with ctypes.  Each launches on `stream` and
// returns cudaGetLastError() (0 on success); neither synchronises.

// The fused kernel.  Side s reads (hub_s, dist_s, cnt_s) [rows, L] at the
// rows of ids_s (int64 [B]; NULL: row b for pair b), side t likewise;
// the index form passes the index's matrices for both sides.  Labels
// with hub >= limit end a row (the index's n; INT_MAX: no cut).
// staged = 1 stages the longer row in 4 L bytes of shared memory.
extern "C" int spc_query_fused_launch(
    const void* hub_s, const void* dist_s, const void* cnt_s,
    const void* hub_t, const void* dist_t, const void* cnt_t,
    const void* ids_s, const void* ids_t, void* d_out, void* c_out,
    long long B, long long rows, int L, int limit, int staged,
    void* stream) {
  if (B <= 0 || B > INT_MAX || rows <= 0 || L <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)B);
  if (staged) {
    const size_t smem = ((size_t)L * 4 + 15) / 16 * 16;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          spc_query_fused<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    spc_query_fused<true><<<grid, kPairThreads, smem, st>>>(
        (const int32_t*)hub_s, (const int32_t*)dist_s, (const int64_t*)cnt_s,
        (const int32_t*)hub_t, (const int32_t*)dist_t, (const int64_t*)cnt_t,
        (const int64_t*)ids_s, (const int64_t*)ids_t, (int32_t*)d_out,
        (int64_t*)c_out, rows, L, limit);
  } else {
    spc_query_fused<false><<<grid, kPairThreads, 0, st>>>(
        (const int32_t*)hub_s, (const int32_t*)dist_s, (const int64_t*)cnt_s,
        (const int32_t*)hub_t, (const int32_t*)dist_t, (const int64_t*)cnt_t,
        (const int64_t*)ids_s, (const int64_t*)ids_t, (int32_t*)d_out,
        (int64_t*)c_out, rows, L, limit);
  }
  return (int)cudaGetLastError();
}

// The warp kernel over gathered [B, L] rows.
extern "C" int spc_query_launch(const void* hub_s, const void* dist_s,
                                const void* cnt_s, const void* hub_t,
                                const void* dist_t, const void* cnt_t,
                                void* d_out, void* c_out, int B, int L,
                                void* stream) {
  if (B <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 32 * kWarpsPerBlock;
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  spc_query_warp<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)hub_s, (const int32_t*)dist_s, (const int64_t*)cnt_s,
      (const int32_t*)hub_t, (const int32_t*)dist_t, (const int64_t*)cnt_t,
      (int32_t*)d_out, (int64_t*)c_out, B, L);
  return (int)cudaGetLastError();
}
