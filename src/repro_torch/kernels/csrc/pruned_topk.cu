// Fused pruned score + top-k, the Hopper replacement of the TPU kernel
// pruned_topk_padded (src/repro/kernels/pruned_topk.py).  For every user u:
//     top-k over items i of  sum_{t < min(r_u, r_i)} p[u, t] q[i, t] + bias[i]
// in the serving order (score desc, item index asc), without the (m, n)
// score matrix ever reaching device memory.
//
// The TPU kernel walks item tiles in sequence inside one grid row per user
// tile; at a 256-user batch that would be two blocks on a 132-SM card.  Here
// the catalog is split instead:
//   1. pruned_topk_partial: grid (splits, user tiles).  A block scores its
//      128 users against its own item range, 128 items at a time (the score
//      tile of pruned_tile.cuh goes through shared memory), and folds each
//      tile into per-user running lists of length topk.  A candidate enters a
//      list only if it beats the list's current worst, which is cached in
//      shared memory, so after warm-up a score costs one compare.  The lists
//      live in the partial output (splits, m, topk) in device memory; a warp
//      copies a user's list into shared memory only for a tile that has a
//      candidate to insert.
//   2. pruned_topk_merge: one warp per user folds the `splits` partial lists
//      the same way, then writes the survivors sorted by the serving order.
// Every comparison uses (score desc, index asc), so ties resolve to the lower
// item index as in a stable dense argsort, whatever the split geometry.
#include <climits>
#include <cmath>

#include "pruned_tile.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 32, kTM = 8, kTN = 8;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);
constexpr int kWarps = kThreads / 32;
constexpr int kMergeWarps = 4;
constexpr int kTopkMax = 1024;  // the per-warp staging lists bound it
constexpr int kEmptyIndex = INT_MAX;  // an empty slot: (-inf, INT_MAX) loses to every item

using Tile = pruned::TileSmem<kBM, kBN, kBK>;

size_t partial_smem_bytes(int topk) {
  using pruned::align16;
  return align16(sizeof(Tile)) + align16(sizeof(float) * kBM * (kBN + 1)) +
         3 * align16(sizeof(int) * kBM) + 2 * align16(sizeof(float) * kWarps * topk);
}

__global__ void __launch_bounds__(kThreads, 2) pruned_topk_partial(
    const float* __restrict__ p, const float* __restrict__ q,
    const int* __restrict__ r_u, const int* __restrict__ r_i,
    const float* __restrict__ bias, float* __restrict__ part_s,
    int* __restrict__ part_i, int64_t m, int64_t n, int k, int topk,
    int64_t items_per_split) {
  using pruned::align16;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ptr = smem;
  Tile& sm = *reinterpret_cast<Tile*>(ptr);
  ptr += align16(sizeof(Tile));
  float* scores = reinterpret_cast<float*>(ptr);  // [kBM][kBN + 1]
  ptr += align16(sizeof(float) * kBM * (kBN + 1));
  float* worst_s = reinterpret_cast<float*>(ptr);
  ptr += align16(sizeof(int) * kBM);
  int* worst_i = reinterpret_cast<int*>(ptr);
  ptr += align16(sizeof(int) * kBM);
  int* worst_p = reinterpret_cast<int*>(ptr);
  ptr += align16(sizeof(int) * kBM);
  float* stage_s = reinterpret_cast<float*>(ptr);
  ptr += align16(sizeof(float) * kWarps * topk);
  int* stage_i = reinterpret_cast<int*>(ptr);

  const int split = blockIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int64_t split_lo = static_cast<int64_t>(split) * items_per_split;
  const int64_t split_hi = split_lo + items_per_split < n ? split_lo + items_per_split : n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tx = threadIdx.x % (kBN / kTN), ty = threadIdx.x / (kBN / kTN);
  float* ls = stage_s + warp * topk;
  int* li = stage_i + warp * topk;

  // Warp w owns the lists of local users w, w + kWarps, ...
  for (int ul = warp; ul < kBM && row0 + ul < m; ul += kWarps) {
    const int64_t base = (static_cast<int64_t>(split) * m + row0 + ul) * topk;
    for (int j = lane; j < topk; j += 32) {
      part_s[base + j] = -INFINITY;
      part_i[base + j] = kEmptyIndex;
    }
    if (lane == 0) { worst_s[ul] = -INFINITY; worst_i[ul] = kEmptyIndex; worst_p[ul] = 0; }
  }

  for (int64_t col0 = split_lo; col0 < split_hi; col0 += kBN) {
    float acc[kTM][kTN];
    pruned::score_tile<float, kBM, kBN, kBK, kTM, kTN>(
        p, q, r_u, r_i, m, split_hi, k, row0, col0, sm, acc);
#pragma unroll
    for (int nn = 0; nn < kTN; ++nn) {
      const int c = tx + nn * (kBN / kTN);
      const float b = col0 + c < split_hi ? bias[col0 + c] : 0.0f;
#pragma unroll
      for (int mm = 0; mm < kTM; ++mm)
        scores[(ty + mm * (kBM / kTM)) * (kBN + 1) + c] = acc[mm][nn] + b;
    }
    __syncthreads();

    for (int ul = warp; ul < kBM && row0 + ul < m; ul += kWarps) {
      float ws = worst_s[ul];
      int wi = worst_i[ul], wp = worst_p[ul];
      const float* row = scores + ul * (kBN + 1);
      float cs[kBN / 32];
      int ci[kBN / 32];
      unsigned masks[kBN / 32];
      bool any = false;
#pragma unroll
      for (int c = 0; c < kBN / 32; ++c) {
        const int64_t g = col0 + c * 32 + lane;
        cs[c] = row[c * 32 + lane];
        ci[c] = static_cast<int>(g);
        masks[c] = __ballot_sync(pruned::kFullMask,
                                 g < split_hi && pruned::better(cs[c], ci[c], ws, wi));
        any |= masks[c] != 0;
      }
      if (!any) continue;
      const int64_t base = (static_cast<int64_t>(split) * m + row0 + ul) * topk;
      for (int j = lane; j < topk; j += 32) { ls[j] = part_s[base + j]; li[j] = part_i[base + j]; }
      __syncwarp();
#pragma unroll
      for (int c = 0; c < kBN / 32; ++c)
        pruned::warp_insert(masks[c], cs[c], ci[c], ls, li, topk, ws, wi, wp);
      __syncwarp();
      for (int j = lane; j < topk; j += 32) { part_s[base + j] = ls[j]; part_i[base + j] = li[j]; }
      if (lane == 0) { worst_s[ul] = ws; worst_i[ul] = wi; worst_p[ul] = wp; }
      __syncwarp();
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kMergeWarps * 32) pruned_topk_merge(
    const float* __restrict__ part_s, const int* __restrict__ part_i,
    float* __restrict__ out_s, int* __restrict__ out_i, int64_t m, int topk,
    int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t u = static_cast<int64_t>(blockIdx.x) * kMergeWarps + warp;
  if (u >= m) return;  // whole warp; the kernel has no block-wide barrier
  float* ls = reinterpret_cast<float*>(smem) + warp * topk;
  int* li = reinterpret_cast<int*>(smem + sizeof(float) * kMergeWarps * topk) + warp * topk;

  for (int j = lane; j < topk; j += 32) { ls[j] = part_s[u * topk + j]; li[j] = part_i[u * topk + j]; }
  __syncwarp();
  float ws;
  int wi, wp;
  pruned::warp_worst(ls, li, topk, ws, wi, wp);
  for (int s = 1; s < splits; ++s) {
    const int64_t base = (static_cast<int64_t>(s) * m + u) * topk;
    for (int j0 = 0; j0 < topk; j0 += 32) {
      const int j = j0 + lane;
      const float cs = j < topk ? part_s[base + j] : -INFINITY;
      const int ci = j < topk ? part_i[base + j] : kEmptyIndex;
      const unsigned mask =
          __ballot_sync(pruned::kFullMask, j < topk && pruned::better(cs, ci, ws, wi));
      pruned::warp_insert(mask, cs, ci, ls, li, topk, ws, wi, wp);
    }
  }
  __syncwarp();
  // Sorted write: an entry's slot is the number of entries ahead of it.
  for (int j = lane; j < topk; j += 32) {
    const float s = ls[j];
    const int i = li[j];
    int slot = 0;
    for (int f = 0; f < topk; ++f) {
      const float sf = ls[f];
      const int i_f = li[f];
      slot += pruned::better(sf, i_f, s, i) || (sf == s && i_f == i && f < j);
    }
    out_s[u * topk + slot] = s;
    out_i[u * topk + slot] = i;
  }
}

}  // namespace

// part_s/part_i: (splits, m, topk) scratch; out_s/out_i: (m, topk).
// Item ranges: split s covers [s * items_per_split, (s + 1) * items_per_split).
// Returns cudaGetLastError() (or cudaErrorInvalidValue for bad arguments).
extern "C" int pruned_topk_launch(
    const float* p, const float* q, const int* r_u, const int* r_i,
    const float* bias, float* part_s, int* part_i, float* out_s, int* out_i,
    long long m, long long n, int k, int topk, long long items_per_split,
    int splits, void* stream) {
  if (m <= 0 || n <= 0 || n >= kEmptyIndex || k <= 0 || topk < 1 ||
      topk > kTopkMax || topk > n || splits < 1 || items_per_split <= 0 ||
      items_per_split % kBN != 0 || (splits - 1) * items_per_split >= n ||
      static_cast<long long>(splits) * items_per_split < n ||
      (m + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = partial_smem_bytes(topk);
  cudaError_t err = cudaFuncSetAttribute(
      pruned_topk_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(splits), static_cast<unsigned>((m + kBM - 1) / kBM));
  pruned_topk_partial<<<grid, kThreads, smem, s>>>(
      p, q, r_u, r_i, bias, part_s, part_i, m, n, k, topk, items_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t merge_smem = (sizeof(float) + sizeof(int)) * kMergeWarps * topk;
  pruned_topk_merge<<<static_cast<unsigned>((m + kMergeWarps - 1) / kMergeWarps),
                      kMergeWarps * 32, merge_smem, s>>>(
      part_s, part_i, out_s, out_i, m, topk, splits);
  return static_cast<int>(cudaGetLastError());
}
