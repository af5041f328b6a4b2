// Device code of the pruned product kernel: one rank-masked fp32 score tile
// with a per-tile K bound.
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

}  // namespace pruned
