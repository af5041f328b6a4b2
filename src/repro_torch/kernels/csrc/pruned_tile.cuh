// Shared device code of the pruned kernels: one rank-masked fp32 score tile
// with a per-tile K bound, plus the (score desc, index asc) order and the
// warp routines that keep a running top-k list under it.
//
// score_tile computes, for the BM x BN tile at (row0, col0),
//     acc[u][i] = sum_{t < min(r_u[u], r_i[i])} p[u, t] * q[i, t]
// with plain fp32 FMAs (no tensor cores, no TF32: the numbers must match an
// fp32 product).  The K loop ends at the tile bound
//     min(max r_u over the tile's rows, max r_i over the tile's columns),
// which is the paper's skipped work; inside it every loaded element is masked
// by its own row's rank, so the sum is exactly over t < min(r_u, r_i).  Rows
// and columns past the ragged edge get rank 0: they load nothing and add
// nothing.  Each thread sums its outputs in increasing t, one FMA per t, so a
// score does not depend on the other rows or columns of its tile (adding a
// masked +-0 product leaves a sum unchanged).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pruned {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* o, float v) { *o = v; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float v) { *o = __float2bfloat16(v); }

// Operand staging of one K chunk.  Both chunks are stored transposed
// ([kk][row]) with one float of padding, so the loads (a warp walks one row
// along K) and the FMA loop (a warp reads consecutive rows) are free of bank
// conflicts.
template <int BM, int BN, int BK>
struct TileSmem {
  float a[BK][BM + 1];
  float b[BK][BN + 1];
  int ru[BM];
  int ri[BN];
  int bound[2];
};

// Thread (ty, tx) owns rows ty + mm * (BM / TM) and columns tx + nn * (BN / TN).
template <typename T, int BM, int BN, int BK, int TM, int TN>
__device__ __forceinline__ void score_tile(
    const T* __restrict__ p, const T* __restrict__ q,
    const int* __restrict__ r_u, const int* __restrict__ r_i,
    int64_t m, int64_t col_end, int k, int64_t row0, int64_t col0,
    TileSmem<BM, BN, BK>& sm, float (&acc)[TM][TN]) {
  constexpr int kThreads = (BM / TM) * (BN / TN);
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);

  if (tid < 2) sm.bound[tid] = 0;
  __syncthreads();
  for (int i = tid; i < BM; i += kThreads) {
    const int64_t row = row0 + i;
    const int r = row < m ? min(max(r_u[row], 0), k) : 0;
    sm.ru[i] = r;
    atomicMax(&sm.bound[0], r);
  }
  for (int j = tid; j < BN; j += kThreads) {
    const int64_t col = col0 + j;
    const int r = col < col_end ? min(max(r_i[col], 0), k) : 0;
    sm.ri[j] = r;
    atomicMax(&sm.bound[1], r);
  }
  __syncthreads();
  const int bound = min(sm.bound[0], sm.bound[1]);

#pragma unroll
  for (int mm = 0; mm < TM; ++mm)
#pragma unroll
    for (int nn = 0; nn < TN; ++nn) acc[mm][nn] = 0.0f;

  for (int t0 = 0; t0 < bound; t0 += BK) {
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int i = e / BK, kk = e % BK, t = t0 + kk;
      sm.a[kk][i] = t < sm.ru[i] ? to_float(p[(row0 + i) * k + t]) : 0.0f;
    }
    for (int e = tid; e < BN * BK; e += kThreads) {
      const int j = e / BK, kk = e % BK, t = t0 + kk;
      sm.b[kk][j] = t < sm.ri[j] ? to_float(q[(col0 + j) * k + t]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int mm = 0; mm < TM; ++mm) av[mm] = sm.a[kk][ty + mm * (BM / TM)];
#pragma unroll
      for (int nn = 0; nn < TN; ++nn) bv[nn] = sm.b[kk][tx + nn * (BN / TN)];
#pragma unroll
      for (int mm = 0; mm < TM; ++mm)
#pragma unroll
        for (int nn = 0; nn < TN; ++nn) acc[mm][nn] = fmaf(av[mm], bv[nn], acc[mm][nn]);
    }
    __syncthreads();
  }
  __syncthreads();  // every thread has read the bound and ranks before reuse
}

// The serving order: higher score first, the lower item index on a tie.
__device__ __forceinline__ bool better(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// Worst entry of a warp's list ls/li[0, len) under the serving order (the
// lowest position among exact duplicates, which only empty slots can be).
// Every lane returns the same (ws, wi, wp).
__device__ __forceinline__ void warp_worst(
    const float* ls, const int* li, int len, float& ws, int& wi, int& wp) {
  const int lane = threadIdx.x & 31;
  float s = 0.0f;
  int i = 0, pos = -1;
  for (int j = lane; j < len; j += 32) {
    const float sj = ls[j];
    const int ij = li[j];
    if (pos < 0 || better(s, i, sj, ij)) { s = sj; i = ij; pos = j; }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float s2 = __shfl_xor_sync(kFullMask, s, off);
    const int i2 = __shfl_xor_sync(kFullMask, i, off);
    const int p2 = __shfl_xor_sync(kFullMask, pos, off);
    const bool take = p2 >= 0 && (pos < 0 || better(s, i, s2, i2) ||
                                  (s == s2 && i == i2 && p2 < pos));
    if (take) { s = s2; i = i2; pos = p2; }
  }
  ws = s; wi = i; wp = pos;
}

// Fold the candidates a warp flagged in `mask` (lane b holds (cs, ci)) into
// its list: each one that still beats the current worst replaces it, and the
// worst is found again.  After warm-up almost every candidate was already
// rejected by the one compare that built `mask`.
__device__ __forceinline__ void warp_insert(
    unsigned mask, float cs, int ci, float* ls, int* li, int len,
    float& ws, int& wi, int& wp) {
  const int lane = threadIdx.x & 31;
  while (mask) {
    const int b = __ffs(mask) - 1;
    mask &= mask - 1;
    const float s = __shfl_sync(kFullMask, cs, b);
    const int i = __shfl_sync(kFullMask, ci, b);
    if (better(s, i, ws, wi)) {
      if (lane == 0) { ls[wp] = s; li[wp] = i; }
      __syncwarp();
      warp_worst(ls, li, len, ws, wi, wp);
    }
  }
}

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

}  // namespace pruned
