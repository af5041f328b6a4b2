// Batch-order row scatter: table[idx[j]] += rows[j] for j = 0..B-1, with the
// rows of a repeated index added in batch order, ((row + v1) + v2) + ..., in
// float32.  A bfloat16 sum is rounded as PyTorch's CPU index_add_ rounds it:
// once, at the end, for a (n, k) table (it accumulates reduced-precision rows
// in float32), and after every add for a vector (round_each).  That is what
// index_add_ computes on the CPU, bit for bit; on CUDA index_add_ adds
// repeats with atomics in any order, so two runs of one training step could
// differ in their last bits.
//
// It replaces no TPU kernel: the reference scatters with XLA's .at[idx].add
// (src/repro/core/mf.py:276), which adds in batch order.  Every scatter of
// the port's training path goes through it (the fused and the masked step,
// RowOptimizer.apply_rows, the sharded step's tables and residuals).
//
// Input: the table, (n, k) with row stride ld (a 1-column table may be any
// strided vector); the indices stable-sorted by the wrapper (torch.sort with
// stable=True), with `order` the batch position of each sorted entry; rows
// (B, k) contiguous.  A negative index marks a row to leave out (the
// wrapper's keep= filter); an index >= n traps, as index_add_'s device assert
// does.
//
// Bound on the H100: bytes.  Each row of `rows` is read once, each touched
// table row is read once and written once, plus 16 bytes of index and order
// a row; about one add per element.  A warp owns one run of equal indices:
// it finds the run's end with ballots over 32 sorted entries at a time, keeps
// the table row's columns in registers (4 a lane, 128 columns a pass; wider
// rows take more passes), adds the run's rows in batch order, and writes the
// row once.  The batch positions of 32 entries are loaded by the 32 lanes and
// handed round by shuffles, and the run loop is unrolled so several rows'
// loads are in flight before their adds, which stay in order.  Warps walk
// the sorted entries with a grid stride; a warp at an entry that does not
// start a run moves on.  One launch, no host sync.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;        // warps a 256-thread block
constexpr int kThreads = 32 * kWarps;
constexpr int kPerLane = 4;      // columns a lane keeps in registers per pass
constexpr int kSpan = 32 * kPerLane;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
add_rows_kernel(T* __restrict__ table, long long ld, long long n, int k,
                const long long* __restrict__ sorted, const long long* __restrict__ order,
                const T* __restrict__ rows, long long b, int round_each) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long j = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5); j < b;
       j += warps) {
    const long long row = sorted[j];
    if (row < 0 || (j > 0 && sorted[j - 1] == row)) continue;  // left out, or not a run's head
    if (row >= n) __trap();
    // the run's end: the first sorted entry past j that differs
    long long end = j + 1;
    for (;;) {
      const long long at = end + lane;
      const unsigned same = __ballot_sync(kFull, at < b && sorted[at] == row);
      if (same != kFull) {
        end += __ffs(~same) - 1;
        break;
      }
      end += 32;
    }
    T* dst = table + row * ld;
    for (int c0 = 0; c0 < k; c0 += kSpan) {
      float acc[kPerLane];
#pragma unroll
      for (int v = 0; v < kPerLane; ++v) {
        const int c = c0 + lane + 32 * v;
        acc[v] = c < k ? load(dst + c) : 0.f;
      }
      for (long long base = j; base < end; base += 32) {
        const long long at = base + lane;
        const long long mine = at < end ? order[at] : 0;
        const int count = end - base < 32 ? static_cast<int>(end - base) : 32;
#pragma unroll 4
        for (int r = 0; r < count; ++r) {
          const T* src = rows + __shfl_sync(kFull, mine, r) * static_cast<long long>(k);
#pragma unroll
          for (int v = 0; v < kPerLane; ++v) {
            const int c = c0 + lane + 32 * v;
            if (c < k) {
              acc[v] = __fadd_rn(acc[v], load(src + c));
              if (round_each) acc[v] = round_to(acc[v], T());
            }
          }
        }
      }
#pragma unroll
      for (int v = 0; v < kPerLane; ++v) {
        const int c = c0 + lane + 32 * v;
        if (c < k) store(dst + c, acc[v]);
      }
    }
  }
}

template <typename T>
cudaError_t dispatch(void* table, long long ld, long long n, int k, const long long* sorted,
                     const long long* order, const void* rows, long long b,
                     int round_each, cudaStream_t s) {
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const long long want = (b + kWarps - 1) / kWarps, cap = static_cast<long long>(sms) * 16;
  const int grid = static_cast<int>(want < cap ? want : cap);
  add_rows_kernel<T><<<grid, kThreads, 0, s>>>(static_cast<T*>(table), ld, n, k, sorted, order,
                                               static_cast<const T*>(rows), b, round_each);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (table and rows alike); round_each: round a
// bfloat16 sum after every add (vectors) rather than once (tables).
extern "C" int add_rows_launch(void* table, long long ld, long long n, int k,
                               const void* sorted, const void* order, const void* rows,
                               long long b, int dtype, int round_each, void* stream) {
  if (b <= 0 || k <= 0 || n <= 0 || ld < 1 || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* si = static_cast<const long long*>(sorted);
  const long long* oi = static_cast<const long long*>(order);
  const cudaError_t e =
      dtype == 0 ? dispatch<float>(table, ld, n, k, si, oi, rows, b, round_each, s)
                 : dispatch<__nv_bfloat16>(table, ld, n, k, si, oi, rows, b, round_each, s);
  return static_cast<int>(e);
}
