// Fused pruned score + top-k, the Hopper replacement of the TPU kernel
// pruned_topk_padded (src/repro/kernels/pruned_topk.py).  For every user u:
//     top-k over items i of  sum_{t < min(r_u, r_i)} p[u, t] q[i, t] + bias[i]
// in the serving order (score desc, item index asc), without the (m, n)
// score matrix ever reaching device memory.
//
// What bounds it on the H100: dense, a 256-user batch against 10M items at
// k = 128 is 655 GFLOP of fp32 FMAs against 5 GB of q, so operations;
// pruning cuts the FMAs to the pairs' min(r_u, r_i).  Around the FMAs, what
// costs is feeding them (loads that stall the block), barriers, and keeping
// the lists, which must cost little per score and nothing per list length.
//
// The TPU kernel walks item tiles in sequence inside one grid row per user
// tile; at a 256-user batch that would be two blocks on a 132-SM card.  Here
// the catalog is split instead:
//   1. pruned_topk_partial: grid (splits, user tiles), one block per SM;
//      the user tiles run over y and then z, so any m takes one launch.
//      Scoring: the block's 128 user rows, up to the largest of their ranks,
//      are loaded into shared memory once.  Item factors stream through a
//      two-stage ring of 128 x 64 chunks with cp.async (16-byte copies that
//      zero-fill each row past its own rank), so the next chunk is in flight
//      while this one runs its FMAs; item ranks arrive two tiles ahead and
//      biases with their tile.  A tile of 128 items is computed to its bound
//      min(max r_u, max r_i) rounded up to 8 (warp reductions); each thread
//      sums its 8 x 8 scores in plain fp32 FMAs, one per t in increasing t,
//      so a score does not depend on its tile.
//      Selection: each thread compares its scores in registers with its
//      users' bars (a row whose best score is below the bar costs one
//      compare); a score that beats the bar is appended to the user's
//      candidate buffer of kBuf slots in shared memory.  A score that finds
//      the buffer full waits in registers until the next tile's first
//      barrier, where every buffer at least half full is merged into its
//      user's list, the merges dealt out over the warps.  The list of each
//      (split, user) lives sorted in the partial output (splits, m, topk) in
//      device memory.  A merge sorts the buffer (bitonic, two entries a
//      lane) and merges the two sorted runs: each entry moves to its own
//      index plus the count of entries of the other run ahead of it.  The
//      list's last 128 entries are read once into registers and searched
//      with shuffles; only the part of a longer list behind the best
//      candidate's slot is read and moved in device memory.  No shared array
//      has topk entries: topk is bounded only by the scratch the wrapper
//      gives.  A user's bar is the last entry of its list once the list is
//      full, raised to a bar pooled over a group of up to 16 splits: each
//      publishes its list's entry at ceil(topk / group) - 1 as a 64-bit key
//      in the serving order, and the smallest of the group's keys has at
//      least topk items at or above it, so an item below it is not in the
//      top k.  Since splits advance in step, the pool cuts the candidates
//      about group-fold against a split's own k-th entry.
//   2. pruned_topk_merge: one warp per user copies split 0's list into the
//      output and folds every other split's list into it with the same merge
//      step, 64 entries at a time, stopping at the first entry that does not
//      beat the output's last.  The output is sorted as it is built.
// Every comparison uses (score desc, index asc), so ties resolve to the lower
// item index as in a stable dense argsort, whatever the split geometry.
//
// Shared memory at k = 128: the user rows 64 KB, the ring 64 KB, the
// candidate buffers 64 KB, the bar pool 16 KB, about 214 KB in all, so one
// block of 8 warps per SM (about 250 registers a thread).  128 users a block (not 64 at two
// blocks per SM) halves the item-factor traffic per score and keeps each
// thread's 8 x 8 outputs against 16 shared loads a K step of 4.  Past
// k = 128 the user rows no longer fit beside the ring: they stream through
// it beside the item factors, 64 deep at a time.
#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kBM = 128, kBN = 128, kTM = 8, kTN = 8;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 64;           // depth of a ring stage
constexpr int kResidentK = 128;   // widest user rows kept resident
constexpr int kBuf = 64;          // candidate slots per user
constexpr int kBarSplits = 16;    // splits that pool their lists into a bar
constexpr int kMergeWarps = 4;
constexpr int kEmptyIndex = INT_MAX;  // an empty slot: (-inf, INT_MAX) loses to every item

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// The serving order: higher score first, the lower item index on a tie.
__device__ __forceinline__ bool better(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// (score, index) as one 64-bit key whose unsigned order is the serving
// order (-0 taken as +0); key 0 stands for no threshold.
__device__ __forceinline__ unsigned long long order_key(float s, int i) {
  unsigned u = __float_as_uint(s + 0.0f);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned>(kEmptyIndex - i);
}
__device__ __forceinline__ void from_key(unsigned long long key, float& s, int& i) {
  if (key == 0) { s = -INFINITY; i = kEmptyIndex; return; }
  const unsigned u = static_cast<unsigned>(key >> 32);
  s = __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
  i = kEmptyIndex - static_cast<int>(key & 0xffffffffu);
}

// Per-user selection state of a partial block.  thr is the list's entry at
// topk - 1 (empty until the list is full), len its count of real entries,
// cnt the candidates appended to buf since the last merge (it may run past
// kBuf; only the first kBuf were stored).  filt is the bar a score must
// beat to be kept: the better of thr and the bar pooled from the splits of
// the block's group (see pruned_topk_partial).
struct SelectSmem {
  int2 filt[kBM];  // (score bits, index), read and written whole
  float thr_s[kBM];
  int thr_i[kBM];
  int len[kBM];
  int cnt[kBM];
  float buf_s[kBM * kBuf];
  int buf_i[kBM * kBuf];
};

// Shared memory of a partial block; the user rows follow it.  A ring stage
// holds 16-byte chunk c of row r at chunk c ^ (r & 7), so the float4 reads
// of eight neighbouring rows hit eight different bank groups.  Item ranks
// arrive two tiles ahead (a tile's depth is needed before its factors are
// requested), item biases with the tile's first chunk.
struct PartialSmem {
  SelectSmem sel;
  int ru[kBM];
  int umax[kBM / 32];
  alignas(16) int ri[3][kBN];  // raw item ranks, tile j in ri[j % 3]
  alignas(16) unsigned long long pooled[kBarSplits][kBM];  // the group's published keys
  alignas(16) float bs[2][kBN];
  alignas(16) float qs[2][kBN * kKC];
};

size_t partial_smem_bytes(int k) {
  const int kp = (k + 7) & ~7;
  const size_t rows = kp <= kResidentK ? size_t(kBM) * kp : size_t(2) * kBM * kKC;
  return align16(sizeof(PartialSmem)) + rows * sizeof(float);
}

__device__ __forceinline__ int swz(int row, int chunk) { return (chunk ^ (row & 7)) << 2; }

// Copy t in [t0, t0 + depth) of 128 rows (row r at src + (first + r) * k)
// into a ring stage; element t of row r is zero-filled unless t < rank[r]
// (ranks clamped to [0, k]).  kVec = 4 uses 16-byte copies (k % 4 == 0,
// 16-byte aligned rows).
template <int kVec>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src,
                                           int64_t first, int k, const int* rank,
                                           int t0, int depth) {
  if (kVec == 4) {
    const int per_row = depth >> 2;
    for (int e = threadIdx.x; e < 128 * per_row; e += kThreads) {
      const int r = e / per_row, c = e - r * per_row, t = t0 + 4 * c;
      const int bytes = 4 * min(max(min(rank[r], k) - t, 0), 4);
      cpasync::copy16(dst + r * kKC + swz(r, c), bytes ? src + (first + r) * k + t : src, bytes);
    }
  } else {
    for (int e = threadIdx.x; e < 128 * depth; e += kThreads) {
      const int r = e / depth, tt = e - r * depth, t = t0 + tt;
      const int bytes = t < min(rank[r], k) ? 4 : 0;
      cpasync::copy4(dst + r * kKC + swz(r, tt >> 2) + (tt & 3),
                     bytes ? src + (first + r) * k + t : src, bytes);
    }
  }
}

// Copy the 128 four-byte values src[first, first + 128) into dst, zero
// from limit on.
template <int kVec>
__device__ __forceinline__ void stage_line(void* dst, const void* src, int64_t first,
                                           int64_t limit) {
  float* d = static_cast<float*>(dst);
  const float* s = static_cast<const float*>(src);
  if (kVec == 4) {
    if (threadIdx.x < 32) {
      const int64_t e = first + 4 * threadIdx.x;
      const int bytes = limit - e >= 4 ? 16 : limit > e ? 4 * static_cast<int>(limit - e) : 0;
      cpasync::copy16(d + 4 * threadIdx.x, bytes ? s + e : s, bytes);
    }
  } else if (threadIdx.x < 128) {
    const int64_t e = first + threadIdx.x;
    cpasync::copy4(d + threadIdx.x, e < limit ? s + e : s, e < limit ? 4 : 0);
  }
}

// The largest of a tile's 128 item ranks, clamped to [0, k]; every warp
// computes it on its own.
__device__ __forceinline__ int tile_max(const int* ri, int k) {
  const int lane = threadIdx.x & 31;
  const int v = max(max(ri[lane], ri[lane + 32]), max(ri[lane + 64], ri[lane + 96]));
  return min(max(__reduce_max_sync(kFullMask, v), 0), k);
}

// A run of up to 32 * R entries held R a lane: entry b in register b / 32 of
// lane b % 32.
template <int R>
struct Run {
  float s[R];
  int i[R];
};

// Entry b of a run, read by every lane (b is the same in all lanes).
template <int R>
__device__ __forceinline__ void run_entry(const Run<R>& run, int b, float& s, int& i) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float rs = __shfl_sync(kFullMask, run.s[r], b & 31);
    const int ri = __shfl_sync(kFullMask, run.i[r], b & 31);
    if (r == (b >> 5)) { s = rs; i = ri; }
  }
}

// Bitonic sort of a run into the serving order, entry 0 best.
template <int R>
__device__ __forceinline__ void warp_sort(Run<R>& run) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32 * R; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= 32) {  // partners in two registers of one lane
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int pr = r ^ (j >> 5);
          if (pr < r) continue;
          const bool desc = (((r << 5) | lane) & k) == 0;
          if (desc ? better(run.s[pr], run.i[pr], run.s[r], run.i[r])
                   : better(run.s[r], run.i[r], run.s[pr], run.i[pr])) {
            const float ts = run.s[r]; const int ti = run.i[r];
            run.s[r] = run.s[pr]; run.i[r] = run.i[pr];
            run.s[pr] = ts; run.i[pr] = ti;
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float os = __shfl_xor_sync(kFullMask, run.s[r], j);
          const int oi = __shfl_xor_sync(kFullMask, run.i[r], j);
          const int e = (r << 5) | lane;
          const bool keep_better = ((e & j) == 0) == ((e & k) == 0);
          if (keep_better ? better(os, oi, run.s[r], run.i[r]) : better(run.s[r], run.i[r], os, oi)) {
            run.s[r] = os; run.i[r] = oi;
          }
        }
      }
    }
  }
}

// Merge a sorted run of nb entries (the rest of the run empty slots) into
// the sorted list ls/li of capacity cap, whose first len entries are real
// and the rest empty; the best cap entries of the two remain.  Every run
// entry must beat the list's entry at cap - 1, (ts, ti), which is updated,
// as is len.  No run entry equals a list entry (an item occurs once), so
// every entry's new slot is its own index plus the number of entries of the
// other run ahead of it, and the slots form a permutation.  The list's last
// 32 * kWin entries are read once into registers and searched with
// shuffles; only a longer list is searched and moved in device memory.
// Called by a whole warp; every lane returns the same len and (ts, ti).
template <int R>
__device__ __forceinline__ void warp_merge(float* ls, int* li, int cap, int& len,
                                           const Run<R>& run, int nb, float& ts, int& ti) {
  constexpr int kWin = 4;    // list chunks of 32 held in registers
  constexpr int kGroup = 4;  // chunks in flight when moving the list's head
  const int lane = threadIdx.x & 31;
  bool wrote_last = false;
  float last_s = 0.0f;
  int last_i = 0;
  auto note_last = [&](int d, float s, int i) {
    if (d == cap - 1) { wrote_last = true; last_s = s; last_i = i; }
  };
  // The window: list entries [w0, len), entry w0 + 32 g + lane in register g.
  const int w0 = max(len - 32 * kWin, 0);
  Run<kWin> win;
#pragma unroll
  for (int g = 0; g < kWin; ++g) {
    const int j = w0 + 32 * g + lane;
    win.s[g] = -INFINITY;
    win.i[g] = kEmptyIndex;
    if (j < len) { win.s[g] = ls[j]; win.i[g] = li[j]; }
  }
  float es = INFINITY;  // the entry ahead of the window (none: beats all)
  int ei = -1;
  if (w0 > 0) { es = ls[w0 - 1]; ei = li[w0 - 1]; }
  // Each run entry's slot: its index plus the list entries ahead of it.
  int slot[R];
  int kept = 0;  // run entries that stay in the list
#pragma unroll
  for (int r = 0; r < R; ++r) {
    int lo = 0, hi = len - w0;
#pragma unroll
    for (int it = 0; it < 8; ++it) {  // len - w0 <= 128
      const int mid = (lo + hi) >> 1;
      float ms;
      int mi;
      run_entry(win, min(mid, 32 * kWin - 1), ms, mi);
      if (lo < hi) {
        if (better(ms, mi, run.s[r], run.i[r])) lo = mid + 1; else hi = mid;
      }
    }
    slot[r] = cap;
    if ((r << 5) + lane < nb) {
      int at = w0 + lo;
      if (!better(es, ei, run.s[r], run.i[r])) {  // it goes ahead of the window
        int a = 0, b = w0 - 1;
        while (a < b) {
          const int mid = (a + b) >> 1;
          if (better(ls[mid], li[mid], run.s[r], run.i[r])) a = mid + 1; else b = mid;
        }
        at = a;
      }
      slot[r] = (r << 5) + lane + at;
    }
    kept += __popc(__ballot_sync(kFullMask, slot[r] < cap));
  }
  // List entries ahead of the best run entry stay put, and those from
  // cap - kept on drop out.  The ones between move back by the number of
  // run entries ahead of each.
  const int first = __shfl_sync(kFullMask, slot[0], 0);
  const int end = min(len, cap - kept);
  auto run_ahead = [&](float s, int i) {  // run entries better than (s, i)
    int lo = 0, hi = nb;
#pragma unroll
    for (int it = 0; it < 6 + (R > 1); ++it) {  // nb <= 32 * R
      const int mid = (lo + hi) >> 1;
      float ms;
      int mi;
      run_entry(run, min(mid, 32 * R - 1), ms, mi);
      if (lo < hi) {
        if (better(ms, mi, s, i)) lo = mid + 1; else hi = mid;
      }
    }
    return lo;
  };
  // The window's entries were read above, so they may move at once.
#pragma unroll
  for (int g = 0; g < kWin; ++g) {
    const int j = w0 + 32 * g + lane;
    const int d = j + run_ahead(win.s[g], win.i[g]);
    if (j >= first && j < end) {
      ls[d] = win.s[g];
      li[d] = win.i[g];
      note_last(d, win.s[g], win.i[g]);
    }
  }
  // Ahead of the window, from the back, kGroup chunks at a time, so that no
  // entry is overwritten before it is read.
  for (int top = min(w0, end); top > first; top -= 32 * kGroup) {
    float s[kGroup];
    int i[kGroup], d[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int j = top - 32 * (g + 1) + lane;
      s[g] = -INFINITY;
      i[g] = kEmptyIndex;
      d[g] = -1;
      if (j >= first) { s[g] = ls[j]; i[g] = li[j]; d[g] = j; }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int ahead = run_ahead(s[g], i[g]);
      if (d[g] >= 0) d[g] += ahead;
    }
    __syncwarp();
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (d[g] >= 0) {
        ls[d[g]] = s[g];
        li[d[g]] = i[g];
        note_last(d[g], s[g], i[g]);
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (slot[r] < cap) {
      ls[slot[r]] = run.s[r];
      li[slot[r]] = run.i[r];
      note_last(slot[r], run.s[r], run.i[r]);
    }
  }
  len = min(len + nb, cap);
  const unsigned w = __ballot_sync(kFullMask, wrote_last);
  if (w) {
    const int src = __ffs(w) - 1;
    ts = __shfl_sync(kFullMask, last_s, src);
    ti = __shfl_sync(kFullMask, last_i, src);
  }
  __syncwarp();
}

// Merge user ul's candidate buffer into its list ls/li; a candidate that no
// longer beats the user's bar is dropped.  A list with at least `share`
// entries publishes its entry share - 1 to *key.  Whole warp.
__device__ __noinline__ void merge_buffer(SelectSmem& sel, int ul, float* ls, int* li,
                                          int topk, int share, unsigned long long* key) {
  constexpr int R = kBuf / 32;
  const int lane = threadIdx.x & 31;
  const int n = min(sel.cnt[ul], kBuf);
  const int2 bar = sel.filt[ul];
  float ts = sel.thr_s[ul], fs = __int_as_float(bar.x);
  int ti = sel.thr_i[ul], fi = bar.y;
  int len = sel.len[ul];
  Run<R> run;
  int nb = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int c = (r << 5) + lane;
    run.s[r] = -INFINITY;
    run.i[r] = kEmptyIndex;
    if (c < n) {
      const float s = sel.buf_s[ul * kBuf + c];
      const int i = sel.buf_i[ul * kBuf + c];
      if (better(s, i, fs, fi)) { run.s[r] = s; run.i[r] = i; }
    }
    nb += __popc(__ballot_sync(kFullMask, run.i[r] != kEmptyIndex));
  }
  if (nb > 0) {
    warp_sort(run);
    warp_merge(ls, li, topk, len, run, nb, ts, ti);
  }
  __syncwarp();
  if (lane == 0) {
    if (len >= share) *key = order_key(ls[share - 1], li[share - 1]);
    if (len == topk && better(ts, ti, fs, fi)) { fs = ts; fi = ti; }
    sel.thr_s[ul] = ts; sel.thr_i[ul] = ti; sel.filt[ul] = make_int2(__float_as_int(fs), fi);
    sel.len[ul] = len; sel.cnt[ul] = 0;
  }
  __syncwarp();
}

template <bool kResident, int kVec>
__global__ void __launch_bounds__(kThreads, 1) pruned_topk_partial(
    const float* __restrict__ p, const float* __restrict__ q,
    const int* __restrict__ r_u, const int* __restrict__ r_i,
    const float* __restrict__ bias, float* part_s, int* part_i,
    unsigned long long* keys, int64_t m, int64_t n, int k, int topk, int64_t items_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  PartialSmem& sm = *reinterpret_cast<PartialSmem*>(smem);
  SelectSmem& sel = sm.sel;
  float* rows = reinterpret_cast<float*>(smem + align16(sizeof(PartialSmem)));
  const int kp = (k + 7) & ~7;  // row stride of resident user rows

  const int split = blockIdx.x;
  const int64_t row0 = (static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y) * kBM;
  if (row0 >= m) return;  // the last z layer's tail: the whole block leaves
  const int64_t split_lo = static_cast<int64_t>(split) * items_per_split;
  const int64_t split_hi = split_lo + items_per_split < n ? split_lo + items_per_split : n;
  const int64_t tiles = (split_hi - split_lo + kBN - 1) / kBN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tx = threadIdx.x % (kBN / kTN), ty = threadIdx.x / (kBN / kTN);
  const int users = m - row0 < kBM ? static_cast<int>(m - row0) : kBM;
  // The bar pool: the splits of a group of at most kBarSplits (the splits
  // cut into equal runs) each publish, per user, the entry at share - 1 of
  // their lists, share = ceil(topk / group).  The group then holds at least
  // topk items at or above the smallest of those keys, so an item below it
  // is not in the user's top k, in whichever split it lies.  The pool is
  // read every other tile.
  const int splits = gridDim.x;
  const int groups = (splits + kBarSplits - 1) / kBarSplits;
  const int group_id = ((split + 1) * groups - 1) / splits;
  const int group0 = group_id * splits / groups;
  const int group = (group_id + 1) * splits / groups - group0;
  const int share = (topk + group - 1) / group;
  unsigned long long* my_keys = keys + static_cast<int64_t>(split) * m + row0;
  auto list_of = [&](int ul) { return (static_cast<int64_t>(split) * m + row0 + ul) * topk; };

  for (int ul = threadIdx.x; ul < kBM; ul += kThreads) {
    sel.thr_s[ul] = -INFINITY;
    sel.thr_i[ul] = kEmptyIndex;
    sel.filt[ul] = make_int2(__float_as_int(-INFINITY), kEmptyIndex);
    sel.len[ul] = 0;
    sel.cnt[ul] = 0;
  }
  if (threadIdx.x < kBM) {
    const int r = static_cast<int>(threadIdx.x) < users ? min(max(r_u[row0 + threadIdx.x], 0), k) : 0;
    sm.ru[threadIdx.x] = r;
    const int wm = __reduce_max_sync(kFullMask, r);
    if (lane == 0) sm.umax[warp] = wm;
  }
  stage_line<kVec>(sm.ri[0], r_i, split_lo, split_hi);
  stage_line<kVec>(sm.ri[1], r_i, split_lo + kBN, split_hi);
  stage_line<kVec>(sm.bs[0], bias, split_lo, split_hi);
  cpasync::commit();
  cpasync::wait<0>();
  __syncthreads();
  const int bu = max(max(sm.umax[0], sm.umax[1]), max(sm.umax[2], sm.umax[3]));
  if (kResident) {  // the user rows, once, up to their largest rank
    const int depth = (bu + 7) & ~7;
    for (int e = threadIdx.x; e < kBM * depth; e += kThreads) {
      const int u = e / depth, t = e - u * depth;
      rows[u * kp + t] = t < sm.ru[u] ? p[(row0 + u) * k + t] : 0.0f;
    }
  }
  // Tile depth: the tile bound rounded up to the K step of 8.
  auto depth_of = [&](const int* ri) { return (min(bu, tile_max(ri, k)) + 7) & ~7; };
  int kt = depth_of(sm.ri[0]);
  auto stage = [&](int slot, int64_t col0, const int* ri, int t0, int t1) {
    stage_rows<kVec>(sm.qs[slot], q, col0, k, ri, t0, t1 - t0);
    if (!kResident) stage_rows<kVec>(rows + slot * kBM * kKC, p, row0, k, sm.ru, t0, t1 - t0);
  };
  stage(0, split_lo, sm.ri[0], 0, min(kKC, kt));
  cpasync::commit();

  float acc[kTM][kTN];
  // Bit mm * kTN + nn of `pend`: the score acc[mm][nn] of the last tile
  // beats its user's bar but found the user's buffer full.
  unsigned long long pend = 0;
  int slot = 0, next_kt = 0;
  for (int64_t j = 0;; ++j) {
    // Settle the last tile: its waiting scores wait while the buffers are
    // merged, then try again.  Every buffer at least half full is merged
    // (buffers fill at much the same rate, so rounds, which stall the
    // block, grow rarer and spread over the warps), the k-th by warp
    // k % kWarps.  The first barrier is also this tile's first: its chunk
    // has landed and the other stage is free.
    cpasync::wait<0>();
    while (__syncthreads_or(pend != 0)) {
      unsigned full[kBM / 32];
#pragma unroll
      for (int c = 0; c < kBM / 32; ++c)
        full[c] = __ballot_sync(kFullMask, sel.cnt[c * 32 + lane] >= kBuf / 2);
      __syncthreads();  // every warp has its copy before counts are reset
      int nth = 0;
#pragma unroll
      for (int c = 0; c < kBM / 32; ++c) {
        for (unsigned bits = full[c]; bits; bits &= bits - 1) {
          const int ul = c * 32 + __ffs(bits) - 1;
          if (nth++ % kWarps == warp)
            merge_buffer(sel, ul, part_s + list_of(ul), part_i + list_of(ul), topk, share,
                         my_keys + ul);
        }
      }
      __syncthreads();
      const int g0 = static_cast<int>(split_lo + (j - 1) * kBN) + tx;
#pragma unroll
      for (int mm = 0; mm < kTM; ++mm) {
        const int ul = ty + mm * (kBM / kTM);
#pragma unroll
        for (int nn = 0; nn < kTN; ++nn) {
          const unsigned long long bit = 1ull << (mm * kTN + nn);
          if (!(pend & bit)) continue;
          const int2 bar = sel.filt[ul];
          const int g = g0 + nn * (kBN / kTN);
          if (!better(acc[mm][nn], g, __int_as_float(bar.x), bar.y)) { pend &= ~bit; continue; }
          const int at = atomicAdd(&sel.cnt[ul], 1);
          if (at < kBuf) {
            sel.buf_s[ul * kBuf + at] = acc[mm][nn];
            sel.buf_i[ul * kBuf + at] = g;
            pend &= ~bit;
          }
        }
      }
    }
    if (j == tiles) break;
    // Raise each bar to the pool staged during the last tile (a bar is read
    // and written whole, so a filter that reads it meanwhile sees the old
    // or the new one).
    if ((j & 1) && static_cast<int>(threadIdx.x) < users) {
      unsigned long long low = sm.pooled[0][threadIdx.x];
      for (int g = 1; g < group; ++g) low = min(low, sm.pooled[g][threadIdx.x]);
      float gs;
      int gi;
      from_key(low, gs, gi);
      const int2 bar = sel.filt[threadIdx.x];
      if (better(gs, gi, __int_as_float(bar.x), bar.y))
        sel.filt[threadIdx.x] = make_int2(__float_as_int(gs), gi);
    }
#pragma unroll
    for (int mm = 0; mm < kTM; ++mm)
#pragma unroll
      for (int nn = 0; nn < kTN; ++nn) acc[mm][nn] = 0.0f;

    const int64_t col0 = split_lo + j * kBN;
    const bool has_next = j + 1 < tiles;
    const int chunks = kt > kKC ? (kt + kKC - 1) / kKC : 1;
    for (int c = 0; c < chunks; ++c) {
      if (c > 0) {
        cpasync::wait<0>();
        __syncthreads();  // this chunk has landed; the other stage is free
      }
      if (c == 0 && has_next) next_kt = depth_of(sm.ri[(j + 1) % 3]);
      if (c + 1 < chunks) {
        stage(slot ^ 1, col0, sm.ri[j % 3], (c + 1) * kKC, min((c + 2) * kKC, kt));
      } else if (has_next) {
        stage(slot ^ 1, col0 + kBN, sm.ri[(j + 1) % 3], 0, min(kKC, next_kt));
        stage_line<kVec>(sm.bs[(j + 1) & 1], bias, col0 + kBN, split_hi);
        if (!(j & 1) && threadIdx.x < kBM) {
          const bool mine = static_cast<int>(threadIdx.x) < users;
          for (int g = 0; g < group; ++g)
            cpasync::copy8(&sm.pooled[g][threadIdx.x],
                           keys + static_cast<int64_t>(group0 + g) * m + row0 + (mine ? threadIdx.x : 0),
                           mine ? 8 : 0);
        }
      }
      if (c == 0 && j + 2 < tiles) stage_line<kVec>(sm.ri[(j + 2) % 3], r_i, col0 + 2 * kBN, split_hi);
      cpasync::commit();

      const int t0 = c * kKC, depth = min(kKC, kt - t0);
      const float* qb = sm.qs[slot];
      const float* ab = kResident ? rows + t0 : rows + slot * kBM * kKC;
#pragma unroll 2
      for (int ch = 0; ch < (depth >> 2); ++ch) {
        float4 av[kTM], bv[kTN];
#pragma unroll
        for (int mm = 0; mm < kTM; ++mm) {
          const int u = ty + mm * (kBM / kTM);
          av[mm] = *reinterpret_cast<const float4*>(
              kResident ? ab + u * kp + 4 * ch : ab + u * kKC + swz(u, ch));
        }
#pragma unroll
        for (int nn = 0; nn < kTN; ++nn) {
          const int i = tx + nn * (kBN / kTN);
          bv[nn] = *reinterpret_cast<const float4*>(qb + i * kKC + swz(i, ch));
        }
#pragma unroll
        for (int mm = 0; mm < kTM; ++mm)
#pragma unroll
          for (int nn = 0; nn < kTN; ++nn) {
            acc[mm][nn] = fmaf(av[mm].x, bv[nn].x, acc[mm][nn]);
            acc[mm][nn] = fmaf(av[mm].y, bv[nn].y, acc[mm][nn]);
            acc[mm][nn] = fmaf(av[mm].z, bv[nn].z, acc[mm][nn]);
            acc[mm][nn] = fmaf(av[mm].w, bv[nn].w, acc[mm][nn]);
          }
      }
      slot ^= 1;
    }

    // The filter, in registers: a score that beats its user's bar is
    // appended to the user's buffer, or waits (pend) if the buffer is full.
    // A row whose best score is below the bar is passed over in one compare.
#pragma unroll
    for (int nn = 0; nn < kTN; ++nn) {
      const float b = sm.bs[j & 1][tx + nn * (kBN / kTN)];  // 0 past split_hi
#pragma unroll
      for (int mm = 0; mm < kTM; ++mm) acc[mm][nn] += b;
    }
#pragma unroll
    for (int mm = 0; mm < kTM; ++mm) {
      const int ul = ty + mm * (kBM / kTM);
      float top = acc[mm][0];
#pragma unroll
      for (int nn = 1; nn < kTN; ++nn) top = fmaxf(top, acc[mm][nn]);
      const int2 bar = sel.filt[ul];
      const float fs = __int_as_float(bar.x);
      if (ul >= users || top < fs) continue;
#pragma unroll
      for (int nn = 0; nn < kTN; ++nn) {
        const int64_t g = col0 + tx + nn * (kBN / kTN);
        if (g >= split_hi || !better(acc[mm][nn], static_cast<int>(g), fs, bar.y)) continue;
        const int at = atomicAdd(&sel.cnt[ul], 1);
        if (at < kBuf) {
          sel.buf_s[ul * kBuf + at] = acc[mm][nn];
          sel.buf_i[ul * kBuf + at] = static_cast<int>(g);
        } else {
          pend |= 1ull << (mm * kTN + nn);
        }
      }
    }
    kt = next_kt;
  }
  for (int ul = warp; ul < users; ul += kWarps) {
    float* ls = part_s + list_of(ul);
    int* li = part_i + list_of(ul);
    if (sel.cnt[ul] > 0) merge_buffer(sel, ul, ls, li, topk, share, my_keys + ul);
    for (int j = sel.len[ul] + lane; j < topk; j += 32) { ls[j] = -INFINITY; li[j] = kEmptyIndex; }
  }
}

__global__ void __launch_bounds__(kMergeWarps * 32) pruned_topk_merge(
    const float* __restrict__ part_s, const int* __restrict__ part_i,
    float* out_s, int* out_i, int64_t m, int topk, int splits) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t u = static_cast<int64_t>(blockIdx.x) * kMergeWarps + warp;
  if (u >= m) return;  // whole warp; the kernel has no block-wide barrier
  float* ls = out_s + u * topk;
  int* li = out_i + u * topk;
  for (int j = lane; j < topk; j += 32) { ls[j] = part_s[u * topk + j]; li[j] = part_i[u * topk + j]; }
  __syncwarp();
  int lo = 0, hi = topk;  // real entries come first
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (li[mid] != kEmptyIndex) lo = mid + 1; else hi = mid;
  }
  int len = lo;
  float ts = ls[topk - 1];
  int ti = li[topk - 1];
  for (int s = 1; s < splits; ++s) {
    const int64_t base = (static_cast<int64_t>(s) * m + u) * topk;
    // The split's list is sorted, so the entries that beat the threshold
    // are a prefix; take it 64 at a time.
    for (int j0 = 0; j0 < topk; j0 += 64) {
      Run<2> run;
      int nb = 0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = j0 + (r << 5) + lane;
        run.s[r] = -INFINITY;
        run.i[r] = kEmptyIndex;
        if (j < topk) {
          const float cs = part_s[base + j];
          const int ci = part_i[base + j];
          if (ci != kEmptyIndex && better(cs, ci, ts, ti)) { run.s[r] = cs; run.i[r] = ci; }
        }
        nb += __popc(__ballot_sync(kFullMask, run.i[r] != kEmptyIndex));
      }
      if (nb == 0) break;
      warp_merge(ls, li, topk, len, run, nb, ts, ti);
      if (nb < 64) break;
    }
  }
}

using PartialKernel = void (*)(const float*, const float*, const int*, const int*,
                               const float*, float*, int*, unsigned long long*, int64_t,
                               int64_t, int, int, int64_t);

}  // namespace

// part_s/part_i: (splits, m, topk) scratch; keys: (splits, m) 64-bit
// scratch, the entries each split publishes for the bar pool; out_s/out_i:
// (m, topk).
// Item ranges: split s covers [s * items_per_split, (s + 1) * items_per_split).
// Returns cudaGetLastError() (or cudaErrorInvalidValue for bad arguments).
extern "C" int pruned_topk_launch(
    const float* p, const float* q, const int* r_u, const int* r_i,
    const float* bias, float* part_s, int* part_i, void* keys, float* out_s, int* out_i,
    long long m, long long n, int k, int topk, long long items_per_split,
    int splits, void* stream) {
  if (m <= 0 || n <= 0 || n >= kEmptyIndex || k <= 0 || topk < 1 || topk > n ||
      splits < 1 || items_per_split <= 0 || items_per_split % kBN != 0 ||
      (splits - 1) * items_per_split >= n ||
      static_cast<long long>(splits) * items_per_split < n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool resident = ((k + 7) & ~7) <= kResidentK;
  auto aligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  const bool vec = k % 4 == 0 && aligned(p) && aligned(q) && aligned(r_i) && aligned(bias);
  const PartialKernel kernel =
      resident ? (vec ? pruned_topk_partial<true, 4> : pruned_topk_partial<true, 1>)
               : (vec ? pruned_topk_partial<false, 4> : pruned_topk_partial<false, 1>);
  const size_t smem = partial_smem_bytes(k);
  cudaError_t err = cudaMemsetAsync(keys, 0, sizeof(unsigned long long) * splits * m, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // User tiles over y, then z: y stays within its limit of 65535.
  const long long user_tiles = (m + kBM - 1) / kBM;
  const long long layers = (user_tiles + 65534) / 65535;
  const dim3 grid(static_cast<unsigned>(splits),
                  static_cast<unsigned>((user_tiles + layers - 1) / layers),
                  static_cast<unsigned>(layers));
  kernel<<<grid, kThreads, smem, s>>>(
      p, q, r_u, r_i, bias, part_s, part_i, static_cast<unsigned long long*>(keys), m, n, k,
      topk, items_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pruned_topk_merge<<<static_cast<unsigned>((m + kMergeWarps - 1) / kMergeWarps),
                      kMergeWarps * 32, 0, s>>>(part_s, part_i, out_s, out_i, m, topk, splits);
  return static_cast<int>(cudaGetLastError());
}
