// All-pairs early-stopped product, the Hopper replacement of the TPU kernel
// pruned_matmul_padded (src/repro/kernels/pruned_matmul.py):
//     out[u, i] = sum_{t < min(r_u[u], r_i[i])} p[u, t] * q[i, t]
// p (m, k) and q (n, k) are row-major float32 or bfloat16 with a row stride
// of ld >= k elements (a column slice of wider rows), out (m, n) is float32 or
// bfloat16, sums are float32.  Rows wider than kMaxK are the wrapper's: it
// runs slices of at most kMaxK columns and sums their outputs.
//
// What bounds it on the H100: the (m, n) output is written once, so at the
// serving shape (64 users x 10M items x k = 128, f32) 2.56 GB of stores set
// the floor (0.76 ms at 3.35 TB/s); the item rows' prefixes add a few hundred
// MB of scattered reads.  Dense, 5.12 GB of q come on top, and the products,
// 3 x 164 GFLOP as 3xTF32, take about 2.1 ms at the rate mma.sync reaches,
// so bytes and products both have to stream and overlap.
//
// Design:
//   - Persistent blocks, two per SM (110 KB of shared memory each at f32,
//     k = 128).  The work is the (64-user tile, 128-item tile) pairs, user
//     tile major; a block walks them with a grid stride, so any m runs.  The
//     user tile stays resident in shared memory, each row masked by its rank
//     at load (64 x (k + 4) floats, so k <= 512); it is reloaded only where
//     the walk enters another user tile.
//   - A tile's depth is min(max r_u, max r_i) over its rows, rounded up to
//     the K step of 8 (warp reductions).  Its item rows stream through a
//     three-stage ring of 32-deep chunks by cp.async; each 16-byte copy takes
//     4 x clamp(r - t, 0, 4) bytes (2 x clamp(r - t, 0, 8) for bf16), so past
//     its own rank a row reads nothing from device memory and lands as exact
//     zeros: the copy applies the rank mask.  A tile's ranks arrive three
//     tiles ahead, so its depth is known before its first chunk is requested.
//   - Products on the tensor cores: mma.sync m16n8k8 TF32 with f32
//     accumulation, each warp a 32 x 32 block of the 64 x 128 tile, fragments
//     by ldmatrix from rows padded by 16 bytes (no bank conflicts).  A float
//     x is split into big = x cut to TF32 and small = x - big, and
//     small*big + big*small + big*big are summed (3xTF32), whose error is of
//     the order of an fp32 product's; bfloat16 is exact in TF32 and takes one
//     pass.  A warp stops at the largest rank of its own 32 users and 32
//     items, which may lie below the tile's depth.
//   - A finished tile is staged in shared memory, rows 0-31 in the ring stage
//     its last chunk came through (where it fits) and rows 32-63 in a buffer
//     of their own, and written by the TMA, one bulk store of 512 contiguous bytes per
//     output row, while the next chunks' copies and products go on.
//   - Rows that are not 16-byte aligned (k * size % 16 != 0, or a base
//     pointer off 16 bytes) take 4-byte copies (f32) or plain loads (bf16);
//     output rows that are not take plain stores.  Ragged M and N edges get
//     rank 0 and are not stored.  Offsets are 64-bit: at a 10M-item catalog
//     q alone passes 2^32 bytes.
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kBM = 64;         // users of a tile
constexpr int kBN = 128;        // items of a tile
constexpr int kKC = 32;         // depth of a ring stage
constexpr int kStages = 3;      // ring stages
constexpr int kSlots = 8;       // tiles whose ranks are kept (> kStages)
constexpr int kThreads = 256;   // 8 warps, 2 x 4 blocks of 32 x 32 outputs
constexpr int kMaxK = 512;      // widest rows: the user tile stays resident

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Shared memory of a block, by byte offset: the user tile (float), the ring
// of item chunks, the output stage's second half (and its first, where a
// ring stage is too small for it), the ranks of kSlots tiles and their
// depths.
template <typename T, typename OutT>
struct Layout {
  static constexpr int kSQ = kKC + 16 / static_cast<int>(sizeof(T));  // elements a stage row
  static constexpr int kSO = kBN + 8;                                  // elements an output row
  static constexpr size_t kStage = size_t(kBN) * kSQ * sizeof(T);
  static constexpr size_t kHalf = size_t(kBM / 2) * kSO * sizeof(OutT);
  static constexpr bool kLoInStage = kStage >= kHalf;
  int sa;  // floats a user row: k rounded up to 8, plus 4
  size_t ring, staged, ri, ru, dep, bytes;
  __host__ __device__ explicit Layout(int k) : sa(((k + 7) & ~7) + 4) {
    ring = align16(size_t(kBM) * sa * sizeof(float));
    staged = ring + kStages * kStage;
    ri = staged + (kLoInStage ? 1 : 2) * kHalf;
    ru = ri + size_t(kSlots) * kBN * sizeof(int);
    dep = ru + size_t(kSlots) * kBM * sizeof(int);
    bytes = dep + size_t(kSlots) * sizeof(int);
  }
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store2(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* o, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}

// x = big + small exactly, big = x cut to TF32 (its low 13 bits 0).  The
// tensor core reads small to TF32 as well, which loses about 2^-21 |x|; a
// bfloat16 value is its own big.
template <bool kSplit>
__device__ __forceinline__ void split(uint32_t x, uint32_t& big, uint32_t& small) {
  if (kSplit) {
    big = x & 0xffffe000u;
    small = __float_as_uint(__uint_as_float(x) - __uint_as_float(big));
  } else {
    big = x;
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 4 tf32 matrices (8 x 8 b16 to ldmatrix) from shared memory: lane
// i names row i % 8 of matrix i / 8; register j of lane l is element l % 4 of
// row l / 4 of matrix j, which is an m16n8k8 fragment's layout.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(cpasync::smem_addr(row)));
}

// One output row segment from shared memory to device memory by the TMA
// (16-byte aligned, a multiple of 16 bytes).
__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(cpasync::smem_addr(src)), "r"(bytes)
               : "memory");
}

template <typename T, typename OutT>
__global__ void __launch_bounds__(kThreads, 2) pruned_matmul_kernel(
    const T* __restrict__ p, const T* __restrict__ q, const int* __restrict__ r_u,
    const int* __restrict__ r_i, OutT* __restrict__ out, int64_t m, int64_t n, int k,
    int64_t ld, int64_t item_tiles, int64_t work, int vec_in, int vec_out) {
  using L = Layout<T, OutT>;
  constexpr int kSQ = L::kSQ, kSO = L::kSO;
  constexpr bool kSplit = std::is_same<T, float>::value;
  const L lay(k);
  const int sa = lay.sa, kp = sa - 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* users_s = reinterpret_cast<float*>(smem);
  T* ring = reinterpret_cast<T*>(smem + lay.ring);
  OutT* staged = reinterpret_cast<OutT*>(smem + lay.staged);
  int* ri = reinterpret_cast<int*>(smem + lay.ri);
  int* ru = reinterpret_cast<int*>(smem + lay.ru);
  int* dep = reinterpret_cast<int*>(smem + lay.dep);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t first = blockIdx.x, stride = gridDim.x;
  const int64_t tiles = (work - first + stride - 1) / stride;  // the launcher keeps grid <= work

  // A walk over the block's tiles: tile j is work first + j * stride, user
  // tile major; a step divides only when it wraps into the next user tile.
  struct Walk {
    int64_t j, ut, it;
  };
  auto walk_start = [&]() {
    const int64_t ut = first / item_tiles;
    return Walk{0, ut, first - ut * item_tiles};
  };
  auto walk_next = [&](Walk& w) {
    ++w.j;
    w.it += stride;
    if (w.it >= item_tiles) {
      w.ut += w.it / item_tiles;
      w.it %= item_tiles;
    }
  };

  // The raw ranks of tile w into slot w.j % kSlots, 0 past the ragged edges.
  auto request_ranks = [&](const Walk& w) {
    if (w.j >= tiles || tid >= kBN + kBM) return;
    const int64_t row0 = w.ut * kBM, col0 = w.it * kBN;
    const int slot = static_cast<int>(w.j % kSlots);
    if (tid < kBN) {
      const int64_t c = col0 + tid;
      cpasync::copy4(ri + slot * kBN + tid, c < n ? r_i + c : r_i, c < n ? 4 : 0);
    } else {
      const int u = tid - kBN;
      const int64_t r = row0 + u;
      cpasync::copy4(ru + slot * kBM + u, r < m ? r_u + r : r_u, r < m ? 4 : 0);
    }
  };

  // Tile j's depth, the bound rounded up to 8; every warp computes it.
  auto depth_of = [&](int64_t j) {
    const int slot = static_cast<int>(j % kSlots);
    int mi = 0, mu = 0;
#pragma unroll
    for (int c = 0; c < kBN / 32; ++c) mi = max(mi, min(max(ri[slot * kBN + c * 32 + lane], 0), k));
#pragma unroll
    for (int c = 0; c < kBM / 32; ++c) mu = max(mu, min(max(ru[slot * kBM + c * 32 + lane], 0), k));
    mi = __reduce_max_sync(kFullMask, mi);
    mu = __reduce_max_sync(kFullMask, mu);
    return (min(mi, mu) + 7) & ~7;
  };

  // The user tile at row0, resident: each row masked by its own rank.
  auto load_users = [&](int64_t row0) {
    for (int e = tid; e < kBM * kp; e += kThreads) {
      const int u = e / kp, t = e - u * kp;
      const int64_t row = row0 + u;
      float x = 0.0f;
      if (row < m && t < min(max(r_u[row], 0), k)) x = to_float(p[row * ld + t]);
      users_s[u * sa + t] = x;
    }
  };

  // Chunk c (t in [kKC c, kKC c + kKC) cut at depth) of tile w's item rows
  // into stage s.
  auto request_chunk = [&](const Walk& w, int c, int depth, int s) {
    const int64_t col0 = w.it * kBN;
    const int* rank_of = ri + static_cast<int>(w.j % kSlots) * kBN;
    const int t0 = c * kKC, len = min(kKC, depth - t0);  // a multiple of 8
    T* dst = ring + s * kBN * kSQ;
    if (vec_in) {
      constexpr int kVec = 16 / static_cast<int>(sizeof(T)), kPerRow = kKC / kVec;
      const int per_row = len / kVec;
#pragma unroll
      for (int e = tid; e < kBN * kPerRow; e += kThreads) {
        const int r = e / kPerRow, cc = e % kPerRow, t = t0 + cc * kVec;
        if (cc >= per_row) continue;
        const int rank = min(max(rank_of[r], 0), k);
        const int bytes = static_cast<int>(sizeof(T)) * min(max(rank - t, 0), kVec);
        cpasync::copy16(dst + r * kSQ + cc * kVec, bytes ? q + (col0 + r) * ld + t : q, bytes);
      }
    } else {
      for (int e = tid; e < kBN * len; e += kThreads) {
        const int r = e / len, tt = e - r * len, t = t0 + tt;
        const bool in = t < min(max(rank_of[r], 0), k);
        if constexpr (sizeof(T) == 4) {
          cpasync::copy4(dst + r * kSQ + tt, in ? q + (col0 + r) * ld + t : q, in ? 4 : 0);
        } else {  // bfloat16 rows off 4-byte alignment: plain loads
          const uint16_t* src = reinterpret_cast<const uint16_t*>(q);
          reinterpret_cast<uint16_t*>(dst)[r * kSQ + tt] = in ? src[(col0 + r) * ld + t] : uint16_t(0);
        }
      }
    }
  };

  // Warp (wm, wn) owns rows 32 wm + [0, 32) and columns 32 wn + [0, 32) of
  // the tile: 2 x 4 m16n8 fragments, acc[mt][nt].  Its depth, the largest
  // rank over those rows and over those columns, may end below the tile's.
  const int g = lane >> 2, tg = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int mi = lane >> 3, rr = lane & 7;  // the ldmatrix row this lane names
  float acc[2][4][4];
  int warp_depth = 0;

  // steps K steps of 8 from stage s, whose chunk starts at t0.
  auto compute_chunk = [&](int s, int t0, int steps) {
    const T* qs = ring + s * kBN * kSQ;
#pragma unroll
    for (int ks = 0; ks < kKC / 8; ++ks) {
      if (ks < steps && t0 + ks * 8 < warp_depth) {
        uint32_t ab[2][4], as[2][4], bb[4][2], bs[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          uint32_t r[4];
          ldsm_x4(r, users_s + (wm * 32 + mt * 16 + (mi & 1) * 8 + rr) * sa + t0 + ks * 8 + (mi >> 1) * 4);
#pragma unroll
          for (int v = 0; v < 4; ++v) split<kSplit>(r[v], ab[mt][v], as[mt][v]);
        }
        if constexpr (kSplit) {
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t r[4];
            ldsm_x4(r, qs + (wn * 32 + (np * 2 + (mi >> 1)) * 8 + rr) * kSQ + ks * 8 + (mi & 1) * 4);
#pragma unroll
            for (int v = 0; v < 4; ++v) split<kSplit>(r[v], bb[2 * np + v / 2][v % 2], bs[2 * np + v / 2][v % 2]);
          }
        } else {  // bfloat16 items: 16-bit loads, widened exactly
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const T* b = qs + (wn * 32 + nt * 8 + g) * kSQ + ks * 8 + tg;
            bb[nt][0] = __float_as_uint(to_float(b[0]));
            bb[nt][1] = __float_as_uint(to_float(b[4]));
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            if (kSplit) {
              mma_tf32(acc[mt][nt], as[mt], bb[nt]);
              mma_tf32(acc[mt][nt], ab[mt], bs[nt]);
            }
            mma_tf32(acc[mt][nt], ab[mt], bb[nt]);
          }
      }
    }
  };

  // Write tile w, whose last chunk came through stage s: staged in shared
  // memory, then one TMA store a row (or plain stores where rows are not
  // 16-byte aligned).
  auto epilogue = [&](const Walk& w, int s) {
    const int64_t row0 = w.ut * kBM, col0 = w.it * kBN;
    OutT* const lo = L::kLoInStage ? reinterpret_cast<OutT*>(ring + s * kBN * kSQ) : staged;
    OutT* const hi = L::kLoInStage ? staged : staged + (kBM / 2) * kSO;
    auto row_at = [&](int r) { return (r < kBM / 2 ? lo : hi) + (r % (kBM / 2)) * kSO; };
    if (L::kLoInStage) __syncthreads();  // every warp is done reading stage s
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        OutT* o = (wm ? hi : lo) + (mt * 16 + g) * kSO + wn * 32 + nt * 8 + 2 * tg;
        store2(o, acc[mt][nt][0], acc[mt][nt][1]);
        store2(o + 8 * kSO, acc[mt][nt][2], acc[mt][nt][3]);
      }
    if (vec_out) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to the TMA
      __syncthreads();
      if (tid < kBM) {
        const int64_t row = row0 + tid;
        if (row < m) {
          const int64_t cols = n - col0 < kBN ? n - col0 : kBN;
          bulk_store(out + row * n + col0, row_at(tid), static_cast<int>(cols * sizeof(OutT)));
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    } else {
      __syncthreads();
      for (int e = tid; e < kBM * kBN; e += kThreads) {
        const int r = e / kBN, c = e - r * kBN;
        const int64_t row = row0 + r, col = col0 + c;
        if (row < m && col < n) out[row * n + col] = row_at(r)[c];
      }
    }
  };

  // The ranks of the first kStages tiles, then the first kStages - 1 steps.
  // A step is one chunk of a tile (a tile of depth 0 takes one empty step),
  // so the ranks of tile j + kStages, requested at tile j's first step, have
  // landed by the time tile j + kStages's first step is requested.
  Walk wr = walk_start();  // the next tile whose ranks to request
  for (int j = 0; j < kStages; ++j) {
    request_ranks(wr);
    walk_next(wr);
  }
  cpasync::commit();
  cpasync::wait<0>();
  __syncthreads();

  Walk wp = walk_start();  // producer: tile, chunk and depth of the next step to request
  int cp = 0, dp = 0;
  auto produce = [&](int s) {
    if (wp.j >= tiles) return;
    if (cp == 0) {
      dp = depth_of(wp.j);
      if (tid == 0) dep[wp.j % kSlots] = dp;
      request_ranks(wr);
      walk_next(wr);
    }
    if (cp * kKC < dp) request_chunk(wp, cp, dp, s);
    if (++cp >= max(1, (dp + kKC - 1) / kKC)) {
      cp = 0;
      walk_next(wp);
    }
  };
  for (int s = 0; s < kStages - 1; ++s) {
    produce(s);
    cpasync::commit();
  }

  Walk wc = walk_start();  // consumer: tile, chunk and depth of the step to compute
  int cc = 0, dc = 0;
  int64_t users = -1;  // the resident user tile
  for (int64_t i = 0; wc.j < tiles; ++i) {
    // Step i has landed; the stage step i - 1 used (and the last tile's
    // staged rows, once the TMA has read them) is free for step
    // i + kStages - 1.
    cpasync::wait<kStages - 2>();
    if (tid < kBM) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    __syncthreads();
    produce(static_cast<int>((i + kStages - 1) % kStages));
    cpasync::commit();
    if (cc == 0) {
      if (wc.ut != users) {  // every warp is past the last step's products
        load_users(wc.ut * kBM);
        users = wc.ut;
        __syncthreads();
      }
      dc = dep[wc.j % kSlots];
      const int slot = static_cast<int>(wc.j % kSlots);
      warp_depth = min(__reduce_max_sync(kFullMask, min(max(ru[slot * kBM + wm * 32 + lane], 0), k)),
                       __reduce_max_sync(kFullMask, min(max(ri[slot * kBN + wn * 32 + lane], 0), k)));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[mt][nt][v] = 0.0f;
    }
    compute_chunk(static_cast<int>(i % kStages), cc * kKC, max(0, min(kKC, dc - cc * kKC)) / 8);
    if (++cc >= max(1, (dc + kKC - 1) / kKC)) {
      epilogue(wc, static_cast<int>(i % kStages));
      cc = 0;
      walk_next(wc);
    }
  }
  cpasync::wait<0>();
  if (tid < kBM) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

template <typename T, typename OutT>
cudaError_t launch(const void* p, const void* q, const int* r_u, const int* r_i, void* out,
                   int64_t m, int64_t n, int k, int64_t ld, cudaStream_t stream) {
  const Layout<T, OutT> lay(k);
  auto kernel = pruned_matmul_kernel<T, OutT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(lay.bytes));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, lay.bytes)) !=
      cudaSuccess)
    return err;
  const int64_t item_tiles = (n + kBN - 1) / kBN;
  const int64_t work = (m + kBM - 1) / kBM * item_tiles;
  const int64_t slots = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(work < slots ? work : slots);
  const int vec_in = (ld * sizeof(T)) % 16 == 0 && aligned16(p) && aligned16(q);
  const int vec_out = (n * sizeof(OutT)) % 16 == 0 && aligned16(out);
  kernel<<<grid, kThreads, lay.bytes, stream>>>(
      static_cast<const T*>(p), static_cast<const T*>(q), r_u, r_i, static_cast<OutT*>(out), m, n,
      k, ld, item_tiles, work, vec_in, vec_out);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  ld: the row stride of p and q,
// in elements.  Returns a cudaError_t.
extern "C" int pruned_matmul_launch(
    const void* p, const void* q, const int* r_u, const int* r_i, void* out,
    long long m, long long n, int k, long long ld, int in_dtype, int out_dtype, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k > kMaxK || ld < k || in_dtype < 0 || in_dtype > 1 ||
      out_dtype < 0 || out_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_dtype == 0 && out_dtype == 0)
    err = launch<float, float>(p, q, r_u, r_i, out, m, n, k, ld, s);
  else if (in_dtype == 0)
    err = launch<float, __nv_bfloat16>(p, q, r_u, r_i, out, m, n, k, ld, s);
  else if (out_dtype == 0)
    err = launch<__nv_bfloat16, float>(p, q, r_u, r_i, out, m, n, k, ld, s);
  else
    err = launch<__nv_bfloat16, __nv_bfloat16>(p, q, r_u, r_i, out, m, n, k, ld, s);
  return static_cast<int>(err);
}
