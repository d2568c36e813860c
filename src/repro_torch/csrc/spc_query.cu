// spc_query: batched SPC-Index pair queries (Algorithm 1) for Hopper.
//
// Replaces the Pallas TPU kernel `_kernel` at
// src/repro/kernels/spc_query/kernel.py:38 (reached through
// spc_query_pallas -> _spc_query_jit -> pallas_call).
//
// Per pair b, over the gathered label rows (hub, dist, cnt) of s and t:
//   d[b] = min over common hubs h of dist_s(h) + dist_t(h)
//   c[b] = sum over the common hubs at that minimum of cnt_s * cnt_t
// and (INF, 0) when the rows share no hub (or the minimum is >= INF).
//
// Differences from the TPU kernel:
//   * counts are int64 in and out (the TPU VPU has no int64, so the
//     Pallas kernel counts in fp32, exact only to 2^24).  Products and
//     sums wrap modulo 2^64 exactly as the reference's int64 does; they
//     are formed on unsigned 64-bit values so the wrap is defined.
//   * no L x L comparison table: rows are sorted by hub id with the pad
//     sentinel last (src/repro/core/labels.py:3-5), so each lane of a
//     warp walks a strided slice of L(s) and binary-searches its hub in
//     L(t) -- the semantics of _intersect_merge
//     (src/repro/core/query.py:60-76).
//
// Layout: one warp per pair, 8 warps per 256-thread block.  Lanes keep
// a running (min_d, cnt) and combine with __shfl_down_sync under the
// associative rule "keep the smaller d; on equal d add the counts";
// integer sums make the result independent of the combine order, so the
// kernel is deterministic.
//
// Bound on this card: the function must read both hub rows in full,
// 2 * L * 4 = 8 L bytes per pair, but dist and cnt of either side only
// at the common hubs (24 bytes each, a few per pair on real label rows),
// and write 12 bytes per pair; at B = 1024, L = 2048 that is about
// 16.8 MB, about 5 us at 3.35 TB/s (H100 SXM), bound by bytes
// (chip_smoke.spc_query_work counts it on each run's rows).  This kernel
// also reads dist and cnt only at matches, but its binary searches make
// log2 L dependent probes of L(t) per label of L(s), and one warp per
// pair leaves few warps per SM to hide their latency; staging L(t) in
// shared memory, fusing the row gather, and TMA loads are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 28;
constexpr int kBig = kInf * 2;
constexpr int kWarpsPerBlock = 8;

__global__ void spc_query_kernel(const int32_t* __restrict__ hub_s,
                                 const int32_t* __restrict__ dist_s,
                                 const int64_t* __restrict__ cnt_s,
                                 const int32_t* __restrict__ hub_t,
                                 const int32_t* __restrict__ dist_t,
                                 const int64_t* __restrict__ cnt_t,
                                 int32_t* __restrict__ d_out,
                                 int64_t* __restrict__ c_out,
                                 int B, int L) {
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
    const int h = hs[i];
    // lower_bound of h in the sorted row L(t) (searchsorted, left side)
    int lo = 0, hi = L;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (ht[mid] < h) lo = mid + 1; else hi = mid;
    }
    const int p = lo < L ? lo : L - 1;
    if (ht[p] != h) continue;
    const int dsum = ds[i] + dt[p];
    const unsigned long long prod =
        (unsigned long long)cs[i] * (unsigned long long)ct[p];
    if (dsum < best_d) {
      best_d = dsum;
      best_c = prod;
    } else if (dsum == best_d) {
      best_c += prod;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const int od = __shfl_down_sync(0xffffffffu, best_d, off);
    const unsigned long long oc = __shfl_down_sync(0xffffffffu, best_c, off);
    if (od < best_d) {
      best_d = od;
      best_c = oc;
    } else if (od == best_d) {
      best_c += oc;
    }
  }
  if (lane == 0) {
    const bool connected = best_d < kInf;
    d_out[pair] = connected ? best_d : kInf;
    c_out[pair] = connected ? (int64_t)best_c : 0;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  Launches on `stream` and
// returns cudaGetLastError() (0 on success); never synchronises.
extern "C" int spc_query_launch(const void* hub_s, const void* dist_s,
                                const void* cnt_s, const void* hub_t,
                                const void* dist_t, const void* cnt_t,
                                void* d_out, void* c_out, int B, int L,
                                void* stream) {
  if (B <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 32 * kWarpsPerBlock;
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  spc_query_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)hub_s, (const int32_t*)dist_s, (const int64_t*)cnt_s,
      (const int32_t*)hub_t, (const int32_t*)dist_t, (const int64_t*)cnt_t,
      (int32_t*)d_out, (int64_t*)c_out, B, L);
  return (int)cudaGetLastError();
}
