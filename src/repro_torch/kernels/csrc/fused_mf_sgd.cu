// Fused dynamically pruned MF-SGD step (the paper's Algs. 2 + 3 in one pass),
// the Hopper replacement of the TPU kernel fused_mf_sgd_padded
// (src/repro/kernels/fused_mf_sgd.py).  For each of B gathered row pairs:
//
//     r_u, r_i = first index t with |v_t| < T of the p row and of the q row
//     mask_t   = t < min(r_u, r_i)
//     pred     = ((sum_t p_t q_t mask_t + mu) + b_u) + b_i
//     err      = rating - pred
//     p'_t     = p_t + lr (err q_t - lam p_t) mask_t w      (q' likewise)
//     b_u'     = b_u + lr (err - lam b_u) w                  (b_i' likewise)
//
// The weight w gates the updates only; the prediction is never weighted.
// p_rows and q_rows are row-major (B, k) float32 or bfloat16 (upcast on load,
// math in fp32, rounded once to the input type on store); every column is
// float32.  weight, bias_u and bias_i may be null (ones, zeros and zeros;
// new_bu/new_bi are then not written).  t_p, t_q and mu are device scalars,
// so a training step never waits on the host; mu may be null (0).
//
// Bound on the H100: a row pair is 2k elements read and 2k written against
// about 8k flops, so the kernel is bound by bytes (2.15 GB at B = 2^20,
// k = 128, f32: 0.64 ms at 3.35 TB/s).  One warp owns one row pair and keeps
// it in registers (k / 32 values per lane), so each element is read once and
// written once; the loads of a warp are contiguous.  The ranks are warp-min
// reductions, the dot product a shuffle tree.  The ragged end of B is masked
// here, so the caller pads nothing.  The updates use the _rn intrinsics,
// which forbid FMA contraction: given the same err they round exactly as the
// plain PyTorch version does, element by element.  Offsets are 64-bit.
//
// Rows wider than 1024 (32 values a lane) do not fit in registers; they take
// a second kernel that walks the row in 1024-wide pieces twice.  Pass 1 finds
// the two ranks and the pruned dot product piece by piece: an index in a
// piece lies below the rank exactly when it lies below every hit found so
// far, so each piece's terms are summed as it is read, and the walk stops at
// the first piece that starts at or past the rank.  Pass 2 reads the pieces
// again and writes the updates.  Each lane sums its terms in increasing t in
// both kernels, so the dot product rounds the same way as a register row of
// the same width would.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // row pairs per 256-thread block
constexpr int kMaxLane = 32;  // values a lane keeps in registers (k <= 1024)
constexpr int kPiece = 32 * kMaxLane;  // the pieces of a wider row
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* o, float v) { *o = v; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float v) { *o = __float2bfloat16(v); }

// v + lr * (e * other - lam * v) * gate, in the plain version's order.
__device__ __forceinline__ float sgd(float v, float other, float e, float lr,
                                     float lam, float gate) {
  const float step = __fsub_rn(__fmul_rn(e, other), __fmul_rn(lam, v));
  return __fadd_rn(v, __fmul_rn(__fmul_rn(lr, step), gate));
}

template <typename T, int kPerLane>
__global__ void __launch_bounds__(kThreads) fused_mf_sgd_kernel(
    const T* __restrict__ p_rows, const T* __restrict__ q_rows,
    const float* __restrict__ rating, const float* __restrict__ bias_u,
    const float* __restrict__ bias_i, const float* __restrict__ weight,
    const float* __restrict__ t_p_ptr, const float* __restrict__ t_q_ptr,
    const float* __restrict__ mu_ptr, float lr, float lam,
    T* __restrict__ new_p, T* __restrict__ new_q, float* __restrict__ new_bu,
    float* __restrict__ new_bi, float* __restrict__ err_out, int64_t b, int k) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= b) return;  // warp-uniform: the whole warp leaves together
  const float t_p = *t_p_ptr;
  const float t_q = *t_q_ptr;
  const int64_t base = row * k;

  float p[kPerLane], q[kPerLane];
  int first_p = k, first_q = k;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int t = lane + 32 * j;
    p[j] = q[j] = 0.f;
    if (t < k) {
      p[j] = to_float(p_rows[base + t]);
      q[j] = to_float(q_rows[base + t]);
      // t grows with j, so the first hit of a lane is its smallest index
      if (first_p == k && fabsf(p[j]) < t_p) first_p = t;
      if (first_q == k && fabsf(q[j]) < t_q) first_q = t;
    }
  }
  const int rank = min(__reduce_min_sync(kFullMask, first_p),
                       __reduce_min_sync(kFullMask, first_q));

  float dot = 0.f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int t = lane + 32 * j;
    if (t < rank) dot = __fadd_rn(dot, __fmul_rn(p[j], q[j]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(kFullMask, dot, off);

  const float mu = mu_ptr != nullptr ? *mu_ptr : 0.f;
  const float bu = bias_u != nullptr ? bias_u[row] : 0.f;
  const float bi = bias_i != nullptr ? bias_i[row] : 0.f;
  const float w = weight != nullptr ? weight[row] : 1.f;
  const float pred = __fadd_rn(__fadd_rn(__fadd_rn(dot, mu), bu), bi);
  const float e = __fsub_rn(rating[row], pred);

#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int t = lane + 32 * j;
    if (t < k) {
      const float gate = __fmul_rn(t < rank ? 1.f : 0.f, w);
      store(new_p + base + t, sgd(p[j], q[j], e, lr, lam, gate));
      store(new_q + base + t, sgd(q[j], p[j], e, lr, lam, gate));
    }
  }
  if (lane == 0) {
    err_out[row] = e;
    if (new_bu != nullptr) new_bu[row] = sgd(bu, 1.f, e, lr, lam, w);
    if (new_bi != nullptr) new_bi[row] = sgd(bi, 1.f, e, lr, lam, w);
  }
}

// The same step for k > kPiece, a piece of kPiece values at a time.
template <typename T>
__global__ void __launch_bounds__(kThreads) fused_mf_sgd_wide_kernel(
    const T* __restrict__ p_rows, const T* __restrict__ q_rows,
    const float* __restrict__ rating, const float* __restrict__ bias_u,
    const float* __restrict__ bias_i, const float* __restrict__ weight,
    const float* __restrict__ t_p_ptr, const float* __restrict__ t_q_ptr,
    const float* __restrict__ mu_ptr, float lr, float lam,
    T* __restrict__ new_p, T* __restrict__ new_q, float* __restrict__ new_bu,
    float* __restrict__ new_bi, float* __restrict__ err_out, int64_t b, int k) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= b) return;  // warp-uniform: the whole warp leaves together
  const float t_p = *t_p_ptr;
  const float t_q = *t_q_ptr;
  const int64_t base = row * k;

  // Pass 1: rank (warp-uniform, the smallest hit so far) and the dot product.
  int rank = k;
  float dot = 0.f;
  for (int c0 = 0; c0 < rank; c0 += kPiece) {
    float p[kMaxLane], q[kMaxLane];
    int first = k;
#pragma unroll
    for (int j = 0; j < kMaxLane; ++j) {
      const int t = c0 + lane + 32 * j;
      p[j] = q[j] = 0.f;
      if (t < k) {
        p[j] = to_float(p_rows[base + t]);
        q[j] = to_float(q_rows[base + t]);
        if (first == k && (fabsf(p[j]) < t_p || fabsf(q[j]) < t_q)) first = t;
      }
    }
    rank = min(rank, __reduce_min_sync(kFullMask, first));
#pragma unroll
    for (int j = 0; j < kMaxLane; ++j) {
      const int t = c0 + lane + 32 * j;
      if (t < rank) dot = __fadd_rn(dot, __fmul_rn(p[j], q[j]));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(kFullMask, dot, off);

  const float mu = mu_ptr != nullptr ? *mu_ptr : 0.f;
  const float bu = bias_u != nullptr ? bias_u[row] : 0.f;
  const float bi = bias_i != nullptr ? bias_i[row] : 0.f;
  const float w = weight != nullptr ? weight[row] : 1.f;
  const float pred = __fadd_rn(__fadd_rn(__fadd_rn(dot, mu), bu), bi);
  const float e = __fsub_rn(rating[row], pred);

  // Pass 2: every value of both rows, updated below the rank.
  for (int t = lane; t < k; t += 32) {
    const float pv = to_float(p_rows[base + t]);
    const float qv = to_float(q_rows[base + t]);
    const float gate = __fmul_rn(t < rank ? 1.f : 0.f, w);
    store(new_p + base + t, sgd(pv, qv, e, lr, lam, gate));
    store(new_q + base + t, sgd(qv, pv, e, lr, lam, gate));
  }
  if (lane == 0) {
    err_out[row] = e;
    if (new_bu != nullptr) new_bu[row] = sgd(bu, 1.f, e, lr, lam, w);
    if (new_bi != nullptr) new_bi[row] = sgd(bi, 1.f, e, lr, lam, w);
  }
}

template <typename T, int kPerLane>
cudaError_t launch(const void* p_rows, const void* q_rows, const float* rating,
                   const float* bias_u, const float* bias_i, const float* weight,
                   const float* t_p, const float* t_q, const float* mu, float lr,
                   float lam, void* new_p, void* new_q, float* new_bu, float* new_bi,
                   float* err, int64_t b, int k, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((b + kWarps - 1) / kWarps);
  fused_mf_sgd_kernel<T, kPerLane><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(p_rows), static_cast<const T*>(q_rows), rating, bias_u,
      bias_i, weight, t_p, t_q, mu, lr, lam, static_cast<T*>(new_p),
      static_cast<T*>(new_q), new_bu, new_bi, err, b, k);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* p_rows, const void* q_rows, const float* rating,
                     const float* bias_u, const float* bias_i, const float* weight,
                     const float* t_p, const float* t_q, const float* mu, float lr,
                     float lam, void* new_p, void* new_q, float* new_bu, float* new_bi,
                     float* err, int64_t b, int k, cudaStream_t s) {
#define FUSED_MF_SGD_CASE(PER_LANE)                                                  \
  if (k <= 32 * PER_LANE)                                                            \
    return launch<T, PER_LANE>(p_rows, q_rows, rating, bias_u, bias_i, weight, t_p, \
                               t_q, mu, lr, lam, new_p, new_q, new_bu, new_bi, err, \
                               b, k, s);
  FUSED_MF_SGD_CASE(1)
  FUSED_MF_SGD_CASE(2)
  FUSED_MF_SGD_CASE(4)
  FUSED_MF_SGD_CASE(8)
  FUSED_MF_SGD_CASE(16)
  FUSED_MF_SGD_CASE(32)
#undef FUSED_MF_SGD_CASE
  const unsigned blocks = static_cast<unsigned>((b + kWarps - 1) / kWarps);
  fused_mf_sgd_wide_kernel<T><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(p_rows), static_cast<const T*>(q_rows), rating, bias_u, bias_i,
      weight, t_p, t_q, mu, lr, lam, static_cast<T*>(new_p), static_cast<T*>(new_q), new_bu,
      new_bi, err, b, k);
  return cudaGetLastError();
}

}  // namespace

// dtype code: 0 = float32, 1 = bfloat16 (p_rows, q_rows, new_p, new_q).
// k >= 1.  Returns cudaGetLastError() after the launch.
extern "C" int fused_mf_sgd_launch(
    const void* p_rows, const void* q_rows, const float* rating, const float* bias_u,
    const float* bias_i, const float* weight, const float* t_p, const float* t_q,
    const float* mu, float lr, float lam, void* new_p, void* new_q, float* new_bu,
    float* new_bi, float* err, long long b, int k, int dtype, void* stream) {
  if (b <= 0 || k <= 0 || (b + kWarps - 1) / kWarps > 0x7fffffffLL ||
      dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = dispatch<float>(p_rows, q_rows, rating, bias_u, bias_i, weight, t_p, t_q, mu, lr,
                        lam, new_p, new_q, new_bu, new_bi, err, b, k, s);
  else
    e = dispatch<__nv_bfloat16>(p_rows, q_rows, rating, bias_u, bias_i, weight, t_p, t_q,
                                mu, lr, lam, new_p, new_q, new_bu, new_bi, err, b, k, s);
  return static_cast<int>(e);
}
