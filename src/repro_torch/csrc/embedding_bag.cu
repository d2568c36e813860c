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
// parallel: one warp per bag, 8 warps per 256-thread block.  The warp
// reads its bag's ids 32 at a time (one per lane) and broadcasts each
// with __shfl_sync; lanes stride over D, so one row read is D
// consecutive elements.  Each lane sums its columns over s = 0..S-1 in
// order: a fixed summation order and no atomics, so the kernel is
// deterministic and differs from a plain fp32 sum only by that order.
// The slot loop is unrolled by 4, so a lane has up to 4 rows in flight
// before their adds, which stay in slot order.  Loads are scalar, so
// any D (8 and 18 included) is read exactly to the end of each row and
// never past it.
//
// Bound on this card: bytes.  The function must read the ids (4 B per
// slot), each distinct table row it touches once (D elements), and
// write the output (D elements per bag); it does about one add per
// slot and column, far below the fp32 rate.  At the recsys bulk shape
// (1,048,576 bags x 8 ids, D = 18, f32, 100,001 rows) that is about
// 33.5 MB + 75.5 MB + 7.2 MB, about 0.035 ms at 3.35 TB/s (H100 SXM);
// chip_smoke.embedding_bag_work counts it on each run's ids.  Rows are
// re-read once per occurrence, from L2 when the table fits there (50
// MB); with D < 32 a warp leaves 32 - D lanes idle, and nothing here
// vectorises or keeps more than one bag in flight per warp: packing
// several bags into a warp and 16-byte loads are later work.

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
__global__ void embedding_bag_kernel(const int32_t* __restrict__ ids,
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

}  // namespace

// Plain C entry point, bound with ctypes.  dtype 0 = float32,
// 1 = bfloat16.  Launches on `stream` and returns cudaGetLastError()
// (0 on success); never synchronises.
extern "C" int embedding_bag_launch(const void* ids, const void* table,
                                    void* out, long long B, int S, int D,
                                    long long V1, int dtype, void* stream) {
  if (B <= 0 || S < 0 || D <= 0 || V1 <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 32 * kWarpsPerBlock;
  const long long blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    embedding_bag_kernel<float><<<(unsigned)blocks, threads, 0, st>>>(
        (const int32_t*)ids, (const float*)table, (float*)out, B, S, D, V1);
  } else if (dtype == 1) {
    embedding_bag_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, st>>>(
        (const int32_t*)ids, (const __nv_bfloat16*)table,
        (__nv_bfloat16*)out, B, S, D, V1);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
