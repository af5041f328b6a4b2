// All-pairs early-stopped product, the Hopper replacement of the TPU kernel
// pruned_matmul_padded (src/repro/kernels/pruned_matmul.py):
//     out[u, i] = sum_{t < min(r_u[u], r_i[i])} p[u, t] * q[i, t]
// p (m, k) and q (n, k) are row-major float32 or bfloat16 (upcast on load),
// out (m, n) is float32 or bfloat16, accumulation is float32.
//
// One 256-thread block per 64 x 128 output tile; each thread owns 4 x 8
// outputs.  The K loop of a tile ends at min(max r_u, max r_i) over the tile
// (see pruned_tile.cuh).  Ragged M, N and K edges are masked in the kernel,
// so no padded copy of either operand is needed.  Offsets are 64-bit: at a
// 10M-item catalog q alone passes 2^32 bytes.
#include "pruned_tile.cuh"

namespace {

constexpr int kBM = 64, kBN = 128, kBK = 32, kTM = 4, kTN = 8;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);

template <typename T, typename OutT>
__global__ void __launch_bounds__(kThreads) pruned_matmul_kernel(
    const T* __restrict__ p, const T* __restrict__ q,
    const int* __restrict__ r_u, const int* __restrict__ r_i,
    OutT* __restrict__ out, int64_t m, int64_t n, int k) {
  __shared__ pruned::TileSmem<kBM, kBN, kBK> sm;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kBN;
  float acc[kTM][kTN];
  pruned::score_tile<T, kBM, kBN, kBK, kTM, kTN>(
      p, q, r_u, r_i, m, n, k, row0, col0, sm, acc);

  const int tx = threadIdx.x % (kBN / kTN);
  const int ty = threadIdx.x / (kBN / kTN);
#pragma unroll
  for (int mm = 0; mm < kTM; ++mm) {
    const int64_t row = row0 + ty + mm * (kBM / kTM);
    if (row >= m) continue;
#pragma unroll
    for (int nn = 0; nn < kTN; ++nn) {
      const int64_t col = col0 + tx + nn * (kBN / kTN);
      if (col < n) pruned::store(out + row * n + col, acc[mm][nn]);
    }
  }
}

template <typename T, typename OutT>
cudaError_t launch(const void* p, const void* q, const int* r_u, const int* r_i,
                   void* out, int64_t m, int64_t n, int k, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n + kBN - 1) / kBN),
                  static_cast<unsigned>((m + kBM - 1) / kBM));
  pruned_matmul_kernel<T, OutT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(p), static_cast<const T*>(q), r_u, r_i,
      static_cast<OutT*>(out), m, n, k);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int pruned_matmul_launch(
    const void* p, const void* q, const int* r_u, const int* r_i, void* out,
    long long m, long long n, int k, int in_dtype, int out_dtype, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || (m + kBM - 1) / kBM > 65535 ||
      (n + kBN - 1) / kBN > 0x7fffffffLL || in_dtype < 0 || in_dtype > 1 ||
      out_dtype < 0 || out_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_dtype == 0 && out_dtype == 0)
    err = launch<float, float>(p, q, r_u, r_i, out, m, n, k, s);
  else if (in_dtype == 0)
    err = launch<float, __nv_bfloat16>(p, q, r_u, r_i, out, m, n, k, s);
  else if (out_dtype == 0)
    err = launch<__nv_bfloat16, float>(p, q, r_u, r_i, out, m, n, k, s);
  else
    err = launch<__nv_bfloat16, __nv_bfloat16>(p, q, r_u, r_i, out, m, n, k, s);
  return static_cast<int>(err);
}
