// Int8 retrieval score + top-k (kernel B2), for Hopper (sm_90a).
//
// Replaces the TPU kernel `_retrieval_kernel_body`, launched by
// `retrieval_topk_kernel` in deepfm_tpu/ops/pallas_retrieval.py.  For each
// query b of u [B, D] f32 against an int8 corpus (codes [R, D], per-row
// scales [R] f32, ids [R] i32):
//
//   score[b, r] = sum_d u[b, d] * (codes[r, d] * scales[r])    (ids[r] >= 0)
//               = -inf                                           (ids[r] <  0)
//
// and it returns exactly the top `kos` per query, by descending score with
// ties toward the smaller row: (scores [B, kos] f32, rows [B, kos] i32).
// The arithmetic is the Pallas kernel's: dequantize (one rounded product),
// then a float32 dot, summed over d in order with fmaf.  Slots past the
// corpus (R < kos) come back as (-inf, row 0).
//
// Order as a key.  Each candidate is one 64-bit key: the high 32 bits are
// the score mapped to an unsigned integer whose ascending order is the
// score's descending order, the low 32 bits the row.  Ascending keys are
// then (-score, row) order, the tie rule holds by construction, and every
// key is distinct.  -0.0 is canonicalized to +0.0 first, so equal scores
// give equal high halves.
//
// What is left out of the TPU design, and why: the Pallas kernel walks a
// sequential grid over row tiles and carries the running top-k in VMEM
// scratch from one grid step to the next.  Blocks here run in parallel, in
// no order, and a running top-k per block needs sorting, which on this card
// is barrier-bound (the first Hopper design merged sorted lists with
// block-wide bitonic networks: 168 us at 117,581 x 8, PERF.md).  So the top
// kos is found by a radix select on the 32-bit score key, and nothing is
// sorted:
//
//   1. scan (count): a grid of row blocks x chunks of up to 8 queries
//      scores every row (two rows a thread up to D = 32, so each query
//      value loaded from shared memory feeds two rows; 16-byte code loads
//      started a tile ahead of their use) and counts, per query, the keys'
//      top 11 bits in a shared-memory histogram, added into a global
//      [B, 2048] one at block end.
//   2. select: one warp per query finds the bin that holds the kos-th
//      key.  If every key in or before that bin fits the candidate buffer
//      (`cap` keys, cap >= kos + rows per block), the query is done.
//   3. Otherwise the next digit (key bits 20..10, then 9..0) is counted the
//      same way over the keys of that bin only, and selected again; after
//      three digits the kos-th key's score T is exact.  If more keys equal
//      T than fit, a fourth scan counts them per row block and the select
//      takes whole row blocks of them in row order up to the one that holds
//      the kos-th (ties go to the smaller row).  So the buffer is bounded
//      by kos + rows per block whatever the data: all-equal scores, fewer
//      live rows than kos, ten equal rows.  A scan for a chunk whose
//      queries are all done returns at once, so on spread scores step 3
//      costs six launches and no work.
//   4. filter: the rows are scored again (a score is not stored: at
//      2,000,000 x 64 the scores would be 512 MB and leave L2) and every
//      key at or below its query's bound (one 64-bit key per query) is
//      appended to the query's buffer, one global atomic per warp.  The
//      keys in the threshold bin also count their next digit, and a last
//      select finds that digit's bin of the kos-th key.
//   5. rank: each candidate's place is the number of smaller keys in its
//      query's buffer (the keys are distinct), counted by a grid of
//      candidate chunks x queries against the candidates within the
//      refined bin only (compacted into shared memory tile by tile; the
//      rest are larger than all of them); a candidate whose place is below
//      kos writes itself there.  No barrier per stage and no sort.
//
// Bound.  At the funnel's 2,000,000-row corpus of dimension 32, B = 8, the
// work must read 80 MB (codes, scales, ids once): 23.9 us at 3.35 TB/s,
// while its 1.09 GFLOP of f32 FMAs take 16 us on the CUDA cores at
// 67 TFLOP/s, so bytes bound it.  The FMAs grow with B (2·B·R·D) and pass
// the bytes near B = 13; at B = 64 the least time is about 122 us of FMAs.
// At the served 117,581-row corpus the bound is 1.4 us (B = 8) and 7.2 us
// (B = 64).  This design scores every row twice (count, filter) and adds
// one shared-memory atomic per row and query.  On an H100 80GB HBM3 at
// 700 W it takes 39 us at 117,581 x 8 (the torch.topk composition: 118),
// 91 us at 117,581 x 64 (222), 183 us at 2,000,000 x 8 and 1.09 ms at
// 2,000,000 x 64 (PERF.md).  At the served corpus its chain of launches (a
// memset and eleven kernels, six of them with no work) sets the time; at
// 2,000,000 rows the two scans do, at about one row-query pair per SM
// cycle, a third of the FMA rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kQueries = 8;           // queries per scan block
constexpr int kTile = 256;            // scan threads = rows per tile
constexpr int kBins = 2048;           // histogram bins (11 bits)
constexpr int kMaxChunks = 8;         // D = 16·chunks, at most 128
constexpr int kRankThreads = 128;     // candidates per rank block
constexpr int kRankTile = 1024;       // keys per shared-memory tile of rank
constexpr int kSelectWarps = 8;       // queries per select block
constexpr int kStateInts = 8;         // per-query state, below

// Per-query state in the workspace (ints), zeroed before the first scan:
//   [0] prefix: key >> shift(level) of the threshold bin (unsigned)
//   [1] level of the prefix: 0..2 digits, 3 = row blocks of equal keys
//   [2] done: the candidates of the prefix fit the buffer
//   [3] keys strictly before the prefix's bin
//   [4] level 3: the last row block whose equal keys are taken
//   [5] candidates appended by the filter
//   [6] the refined prefix: the next digit's bin that holds the kos-th key
//       among the candidates (levels 0 and 1)
enum { kPrefix, kLevel, kDone, kBefore, kLastBlock, kCount, kRefine };

// digit l of a key is key >> shift(l), masked to width(l) bits
__host__ __device__ __forceinline__ int digit_shift(int level) {
  return level == 0 ? 21 : (level == 1 ? 10 : 0);
}
__host__ __device__ __forceinline__ int digit_width(int level) {
  return level == 2 ? 10 : 11;
}

// shared bytes of a block's staged queries, rounded up so what follows
// them stays 16-byte aligned
__host__ __device__ __forceinline__ int query_bytes(int qpb, int dim) {
  return (qpb * dim * 4 + 15) & ~15;
}

// the score as an unsigned key, ascending in -score; -0.0 -> +0.0
__device__ __forceinline__ unsigned score_key(float s) {
  unsigned b = __float_as_uint(s);
  if ((b << 1) == 0u) b = 0u;
  const unsigned o = (b & 0x80000000u) ? ~b : (b | 0x80000000u);  // asc. in s
  return ~o;
}

__device__ __forceinline__ float key_score(unsigned k) {
  const unsigned o = ~k;
  const unsigned b = (o & 0x80000000u) ? (o & 0x7fffffffu) : ~o;
  return __uint_as_float(b);
}

// One row's inputs, loaded a tile ahead of their use: NC 16-byte chunks
// of codes (D = 16·NC), its scale and its id.  D also reaches the kernel
// as a run-time argument: with D a compile-time constant, the scoring loop
// ran 2-6% slower on an H100 80GB HBM3 (PERF.md).
template <int NC>
struct RowLoad {
  int id;
  float scale;
  int4 c[NC];
};

template <int NC>
__device__ __forceinline__ void load_row(RowLoad<NC>& out, const int8_t* codes,
                                         const float* scales, const int* ids,
                                         int dim, long long r, bool in_range) {
  out.id = in_range ? __ldg(ids + r) : -1;
  out.scale = in_range ? __ldg(scales + r) : 0.0f;
#pragma unroll
  for (int c = 0; c < NC; ++c)
    out.c[c] = in_range ? __ldg(reinterpret_cast<const int4*>(codes + r * dim) + c)
                        : make_int4(0, 0, 0, 0);
}

// Rows a scan thread scores at once.  Each query value a thread loads from
// shared memory feeds that many rows' FMAs: with one row a thread the
// scans were bound by the shared-memory pipe (a broadcast 16-byte load per
// 4 FMAs, about one row-query pair per SM cycle at every shape, on an H100
// 80GB HBM3, PERF.md).  Two rows a thread fit the registers up to D = 32.
template <int NC>
struct RowsPerThread {
  static constexpr int value = NC <= 2 ? 2 : 1;
};

// Scores this thread's RPT rows against the block's nq staged queries.
template <int NC, int RPT>
__device__ __forceinline__ void score_rows(const RowLoad<NC> (&rows)[RPT], const float* us,
                                           int dim, int nq, float (&acc)[RPT][kQueries]) {
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int q = 0; q < kQueries; ++q) acc[i][q] = 0.0f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    // each code to float exactly without the quarter-rate I2F: the code
    // plus 128 is the low byte of 2**23 + (code + 128) as a float
    float deq[RPT][16];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const unsigned w[4] = {static_cast<unsigned>(rows[i].c[c].x) ^ 0x80808080u,
                             static_cast<unsigned>(rows[i].c[c].y) ^ 0x80808080u,
                             static_cast<unsigned>(rows[i].c[c].z) ^ 0x80808080u,
                             static_cast<unsigned>(rows[i].c[c].w) ^ 0x80808080u};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float code =
            __uint_as_float(__byte_perm(w[j / 4], 0x4B000000u, 0x7540u | (j % 4))) -
            8388736.0f;
        deq[i][j] = code * rows[i].scale;
      }
    }
#pragma unroll
    for (int q = 0; q < kQueries; ++q) {
      if (q < nq) {
        const float4* uq = reinterpret_cast<const float4*>(us + q * dim + 16 * c);
#pragma unroll
        for (int j4 = 0; j4 < 4; ++j4) {
          const float4 w = uq[j4];
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            float a = acc[i][q];
            a = fmaf(w.x, deq[i][4 * j4], a);
            a = fmaf(w.y, deq[i][4 * j4 + 1], a);
            a = fmaf(w.z, deq[i][4 * j4 + 2], a);
            a = fmaf(w.w, deq[i][4 * j4 + 3], a);
            acc[i][q] = a;
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i)
    if (rows[i].id < 0)
#pragma unroll
      for (int q = 0; q < kQueries; ++q) acc[i][q] = __int_as_float(0xff800000);  // -inf
}

// The scan over all rows, for a grid of row blocks x query chunks.
// kFilter false: count the keys of digit `level` (0..2) into `hist`
// [B, kBins], or at level 3 the keys equal to the prefix into `equal`
// [B, row blocks], for the queries not yet done.  kFilter true: append
// every key that passes its query's criterion to `cand` [B, cap].
template <int NC, bool kFilter>
__global__ void __launch_bounds__(kTile, RowsPerThread<NC>::value == 2 ? 2 : 3) scan_kernel(
    const float* __restrict__ u, const int8_t* __restrict__ codes,
    const float* __restrict__ scales, const int* __restrict__ ids, int batch,
    int dim, long long rows, int rows_per_block, int level, int* state,
    int* __restrict__ hist, int* __restrict__ equal, u64* __restrict__ cand,
    int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned s_prefix[kQueries];
  __shared__ int s_level[kQueries];
  __shared__ u64 s_limit[kQueries];  // filter: the largest 64-bit key that passes
  __shared__ unsigned s_active;      // bit q: query q is counted or filtered
  float* us = reinterpret_cast<float*>(smem);             // [qpb][dim]
  const int qpb = min(kQueries, batch);
  int* hs = reinterpret_cast<int*>(smem + query_bytes(qpb, dim));  // [qpb][kBins]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.y * kQueries;
  const long long rb = blockIdx.x;  // row block
  const int nq = min(kQueries, batch - q0);
  if (tid == 0) s_active = 0u;
  __syncthreads();
  if (tid < nq) {
    const int* st = state + (q0 + tid) * kStateInts;
    const unsigned p = static_cast<unsigned>(st[kPrefix]);
    const int lq = st[kLevel];
    s_prefix[tid] = p;
    s_level[tid] = lq;
    // the filter's criterion as one 64-bit key bound: every key whose
    // prefix at its level is at most p; at level 3 the keys below p, and
    // those equal to p in row blocks up to the last one taken
    const int sh = lq < 3 ? digit_shift(lq) : 0;
    const unsigned top = lq < 3 ? (p << sh) | ((1u << sh) - 1u) : p;
    s_limit[tid] = lq < 3 || rb <= st[kLastBlock]
                       ? (static_cast<u64>(top) << 32) | 0xffffffffu
                       : (static_cast<u64>(p) << 32) - 1u;
    if (kFilter || level == 0 || st[kDone] == 0) atomicOr(&s_active, 1u << tid);
  }
  __syncthreads();
  const unsigned active = s_active;
  if (active == 0u) return;  // every query of the chunk is done: nothing to count

  const long long r0 = rb * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);
  for (int i = tid; i < nq * dim; i += blockDim.x)
    us[i] = u[static_cast<size_t>(q0) * dim + i];
  if (!kFilter && level < 3)
    for (int i = tid; i < nq * kBins; i += blockDim.x) hs[i] = 0;
  int eq[kQueries];
#pragma unroll
  for (int q = 0; q < kQueries; ++q) eq[q] = 0;
  constexpr int RPT = RowsPerThread<NC>::value;
  RowLoad<NC> next[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const long long r = r0 + tid + i * kTile;
    load_row<NC>(next[i], codes, scales, ids, dim, r, r < r1);
  }
  __syncthreads();

  const int shift = level < 3 ? digit_shift(level) : 0;
  const int above = level == 0 ? 32 : digit_shift(level - 1);  // prefix's shift
  const unsigned mask = (1u << digit_width(level < 3 ? level : 2)) - 1u;
  for (long long base = r0; base < r1; base += kTile * RPT) {
    RowLoad<NC> cur[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      cur[i] = next[i];
      // the next tile's loads are in flight while this one is scored
      const long long r = base + kTile * RPT + tid + i * kTile;
      load_row<NC>(next[i], codes, scales, ids, dim, r, r < r1);
    }
    float acc[RPT][kQueries];
    score_rows<NC, RPT>(cur, us, dim, nq, acc);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const long long r = base + tid + i * kTile;
      const bool in_range = r < r1;
#pragma unroll
      for (int q = 0; q < kQueries; ++q) {
        if (!((active >> q) & 1u)) continue;  // block-uniform (q < nq)
        const unsigned key = score_key(acc[i][q]);
        if (kFilter) {
          const u64 key64 = (static_cast<u64>(key) << 32) | static_cast<unsigned>(r);
          const bool pass = in_range && key64 <= s_limit[q];
          if (pass) {
            // the next digit of the keys in the threshold bin, for the
            // rank's refined prefix (rare: a few hundred keys per query)
            const int lq = s_level[q];
            if (lq < 2 && (key >> digit_shift(lq)) == s_prefix[q])
              atomicAdd(hist + (static_cast<size_t>(lq + 1) * batch + q0 + q) * kBins +
                            ((key >> digit_shift(lq + 1)) & ((1u << digit_width(lq + 1)) - 1u)),
                        1);
          }
          // append: one global atomic per warp (a ballot counts its lanes)
          const unsigned m = __ballot_sync(0xffffffffu, pass);
          if (m != 0u) {
            const int lane = tid & 31;
            const int leader = __ffs(m) - 1;
            int at = 0;
            if (lane == leader) at = atomicAdd(state + (q0 + q) * kStateInts + kCount, __popc(m));
            at = __shfl_sync(0xffffffffu, at, leader) + __popc(m & ((1u << lane) - 1u));
            if (pass && at < cap) cand[static_cast<size_t>(q0 + q) * cap + at] = key64;
          }
        } else if (in_range) {
          if (level == 3) {
            eq[q] += key == s_prefix[q];
          } else if (level == 0 || (key >> above) == s_prefix[q]) {
            atomicAdd(hs + q * kBins + ((key >> shift) & mask), 1);
          }
        }
      }
    }
  }
  if (kFilter) return;
  if (level == 3) {
    // per-block count of the keys equal to the prefix, row blocks in order
    const long long nblocks = gridDim.x;
    __syncthreads();
    if (tid < nq) hs[tid] = 0;
    __syncthreads();
    for (int q = 0; q < nq; ++q)
      if (eq[q]) atomicAdd(hs + q, eq[q]);
    __syncthreads();
    if (tid < nq && ((active >> tid) & 1u))
      equal[static_cast<size_t>(q0 + tid) * nblocks + rb] = hs[tid];
    return;
  }
  __syncthreads();
  for (int i = tid; i < nq * kBins; i += blockDim.x) {
    const int v = hs[i];
    if (v) atomicAdd(hist + static_cast<size_t>(q0) * kBins + i, v);
  }
}

// Finds, per query not yet done, the bin of `hist` (`bins` counters per
// query, `stride` apart) that holds the kos-th key, counting on from the
// keys before the prefix's bin; one warp per query.  With level 4 it
// refines instead: for a query done at level 0 or 1 it finds that bin in
// the next digit's histogram of the candidates (`hist` is then the base of
// the three digit histograms), for the rank.
__global__ void __launch_bounds__(32 * kSelectWarps) select_kernel(
    int level, const int* __restrict__ hist, int bins, long long stride,
    int batch, int kos, int cap, int* state) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kSelectWarps + threadIdx.x / 32;
  if (q >= batch) return;  // warp-uniform
  int* st = state + q * kStateInts;
  const bool refine = level > 3;
  const int* h = hist + q * stride;
  if (refine) {
    level = st[kLevel] + 1;
    if (level > 2) return;  // the candidates are exact already
    bins = 1 << digit_width(level);
    h = hist + (static_cast<long long>(level) * batch + q) * kBins;
  } else if (st[kDone]) {
    return;
  }
  const int base = level == 0 ? 0 : st[kBefore];
  // each lane sums a contiguous chunk of bins; a warp scan of the sums
  // finds the chunk that holds the kos-th key, then 32 bins at a time
  // inside it
  const int per = (bins + 31) / 32;
  const int lo = min(bins, lane * per), hi = min(bins, lo + per);
  int sum = 0;
  if (bins == 32 * per && per % 4 == 0 && per <= 64) {
    // digit histograms: 16-byte loads, all in flight at once
    const int4* h4 = reinterpret_cast<const int4*>(h + lo);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (4 * i < per) {
        const int4 v = h4[i];
        sum += v.x + v.y + v.z + v.w;
      }
    }
  } else {
#pragma unroll 8
    for (int i = lo; i < hi; ++i) sum += h[i];
  }
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  const unsigned m = __ballot_sync(0xffffffffu, base + incl >= kos);
  int t = bins - 1, before = 0, upto = base + __shfl_sync(0xffffffffu, incl, 31);
  if (m != 0u) {
    // (m == 0: fewer keys than kos, only at level 0 when R < kos: every bin)
    const int owner = __ffs(m) - 1;
    int run = __shfl_sync(0xffffffffu, base + incl - sum, owner);
    const int olo = __shfl_sync(0xffffffffu, lo, owner);
    const int ohi = __shfl_sync(0xffffffffu, hi, owner);
    for (int s0 = olo; s0 < ohi; s0 += 32) {
      const int v = s0 + lane < ohi ? h[s0 + lane] : 0;
      int c = v;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int w = __shfl_up_sync(0xffffffffu, c, off);
        if (lane >= off) c += w;
      }
      const unsigned hit = __ballot_sync(0xffffffffu, run + c >= kos);
      if (hit != 0u) {
        const int w = __ffs(hit) - 1;
        t = s0 + w;
        upto = run + __shfl_sync(0xffffffffu, c, w);
        before = upto - __shfl_sync(0xffffffffu, v, w);
        break;
      }
      run += __shfl_sync(0xffffffffu, c, 31);
    }
  }
  if (lane != 0) return;
  const unsigned prefix = static_cast<unsigned>(st[kPrefix]);
  if (refine) {
    st[kRefine] = static_cast<int>((prefix << digit_width(level)) | t);
    return;
  }
  if (level == 3) {
    st[kLastBlock] = t;
    st[kLevel] = 3;
    st[kDone] = 1;
    return;
  }
  st[kPrefix] = static_cast<int>(level == 0 ? static_cast<unsigned>(t)
                                            : (prefix << digit_width(level)) | t);
  st[kLevel] = level;
  st[kBefore] = before;
  if (upto <= cap) st[kDone] = 1;
}

// Each candidate's place among its query's candidates is the number of
// smaller keys (keys are distinct); places below kos are written out,
// decoded to (score, row).  Slots past the candidates get (-inf, 0).
// Where the query's candidates stopped at digit 0 or 1, only those within
// the refined prefix can place below kos, and every other candidate is
// larger than all of them: each block compacts those into shared memory,
// tile by tile, and counts against them alone.
__global__ void __launch_bounds__(kRankThreads) rank_kernel(
    const u64* __restrict__ cand, const int* __restrict__ state, int cap, int kos,
    float* __restrict__ out_scores, int* __restrict__ out_rows) {
  __shared__ u64 tile[kRankTile];
  __shared__ int s_kept;
  const int q = blockIdx.y;
  const int tid = threadIdx.x;
  const int* st = state + q * kStateInts;
  const int n = min(st[kCount], cap);
  const int level = st[kLevel];
  const bool refined = level < 2;
  const int shift = refined ? digit_shift(level + 1) : 0;
  const unsigned limit = refined ? static_cast<unsigned>(st[kRefine]) : ~0u;
  float* os = out_scores + static_cast<size_t>(q) * kos;
  int* orow = out_rows + static_cast<size_t>(q) * kos;
  if (blockIdx.x == 0)
    for (int s = n + tid; s < kos; s += kRankThreads) {
      os[s] = __int_as_float(0xff800000);
      orow[s] = 0;
    }
  if (static_cast<int>(blockIdx.x) * kRankThreads >= n) return;  // block-uniform
  const u64* c = cand + static_cast<size_t>(q) * cap;
  const int i = blockIdx.x * kRankThreads + tid;
  const u64 mine = i < n ? c[i] : ~0ULL;
  const bool live = i < n && (static_cast<unsigned>(mine >> 32) >> shift) <= limit;
  if (!__syncthreads_or(live)) return;
  int place = 0;
  for (int j0 = 0; j0 < n; j0 += kRankTile) {
    const int len = min(kRankTile, n - j0);
    if (tid == 0) s_kept = 0;
    __syncthreads();
    for (int j = tid; j < len; j += kRankThreads) {
      const u64 k = c[j0 + j];
      if ((static_cast<unsigned>(k >> 32) >> shift) <= limit) tile[atomicAdd(&s_kept, 1)] = k;
    }
    __syncthreads();
    const int kept = s_kept;
    if (live) {
#pragma unroll 8
      for (int j = 0; j < kept; ++j) place += tile[j] < mine;
    }
    __syncthreads();  // every thread has read the tile before it is refilled
  }
  if (live && place < kos) {
    os[place] = key_score(static_cast<unsigned>(mine >> 32));
    orow[place] = static_cast<int>(static_cast<unsigned>(mine));
  }
}

// workspace layout: state, the three digit histograms, the per-block
// equal counts (all zeroed per call), then the candidate buffers
struct Layout {
  size_t hist, equal, zeroed, cand, total;
};

// row blocks of the scans: at least one, so an empty corpus still runs
// the chain and answers (-inf, 0) everywhere
long long row_blocks(long long rows, int rows_per_block) {
  return rows > 0 ? (rows + rows_per_block - 1) / rows_per_block : 1;
}

Layout layout(int batch, long long rows, int rows_per_block, int cap) {
  const long long nblocks = row_blocks(rows, rows_per_block);
  Layout l;
  l.hist = static_cast<size_t>(batch) * kStateInts * 4;
  l.equal = l.hist + static_cast<size_t>(3) * batch * kBins * 4;
  l.zeroed = l.equal + static_cast<size_t>(batch) * nblocks * 4;
  l.cand = (l.zeroed + 15) & ~static_cast<size_t>(15);
  l.total = l.cand + static_cast<size_t>(batch) * cap * 8;
  return l;
}

}  // namespace

extern "C" {

// Bytes of device workspace that retrieval_topk needs for these sizes.
long long retrieval_topk_workspace(int batch, long long rows, int rows_per_block, int cap) {
  if (batch <= 0 || rows_per_block <= 0) return 0;
  return static_cast<long long>(layout(batch, rows, rows_per_block, cap).total);
}

// Launches the whole selection on `stream` and returns cudaGetLastError()
// as an int (0 = ok).  `workspace` holds retrieval_topk_workspace(...)
// bytes.  The caller has checked devices, types, shapes, contiguity,
// 1 <= kos, rows < 2**31; D must be a multiple of 16 up to 128, the codes
// 16-byte aligned, rows_per_block a positive multiple of 256 and
// cap >= kos + rows_per_block, or it returns cudaErrorInvalidValue.
int retrieval_topk(const float* u, const void* codes, const float* scales,
                   const int* ids, int batch, int dim, long long rows, int kos,
                   int rows_per_block, int cap, void* workspace, float* out_scores,
                   int* out_rows, void* stream) {
  if (batch <= 0) return 0;
  if (dim % 16 != 0 || dim < 16 || dim > 16 * kMaxChunks ||
      reinterpret_cast<uintptr_t>(codes) % 16 != 0 || rows_per_block <= 0 ||
      rows_per_block % kTile != 0 || kos < 1 ||
      static_cast<long long>(cap) < static_cast<long long>(kos) + rows_per_block)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  typedef void (*Scan)(const float*, const int8_t*, const float*, const int*, int, int,
                       long long, int, int, int*, int*, int*, u64*, int);
  const Scan counts[kMaxChunks] = {
      scan_kernel<1, false>, scan_kernel<2, false>, scan_kernel<3, false>,
      scan_kernel<4, false>, scan_kernel<5, false>, scan_kernel<6, false>,
      scan_kernel<7, false>, scan_kernel<8, false>};
  const Scan filters[kMaxChunks] = {
      scan_kernel<1, true>, scan_kernel<2, true>, scan_kernel<3, true>,
      scan_kernel<4, true>, scan_kernel<5, true>, scan_kernel<6, true>,
      scan_kernel<7, true>, scan_kernel<8, true>};
  const Scan count = counts[dim / 16 - 1];
  const Scan filter = filters[dim / 16 - 1];
  const int qpb = batch < kQueries ? batch : kQueries;
  const size_t smem_filter = query_bytes(qpb, dim);
  const size_t smem_count = smem_filter + static_cast<size_t>(qpb) * kBins * 4;
  // the attribute is per device, so it is set on every launch (the call
  // costs far less than the kernels)
  cudaError_t e = cudaFuncSetAttribute(count, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem_count));
  if (e != cudaSuccess) return static_cast<int>(e);

  const Layout l = layout(batch, rows, rows_per_block, cap);
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  int* state = reinterpret_cast<int*>(ws);
  int* hist = reinterpret_cast<int*>(ws + l.hist);
  int* equal = reinterpret_cast<int*>(ws + l.equal);
  u64* cand = reinterpret_cast<u64*>(ws + l.cand);
  e = cudaMemsetAsync(ws, 0, l.zeroed, s);
  if (e != cudaSuccess) return static_cast<int>(e);

  const long long nblocks = row_blocks(rows, rows_per_block);
  // row blocks vary fastest: a grid with the query chunks fastest, so that
  // a row block's codes come from L2 for all but its first chunk, ran the
  // scans 20-38% slower at 2,000,000 x 64 on an H100 80GB HBM3 (PERF.md)
  const dim3 grid(static_cast<unsigned>(nblocks), (batch + kQueries - 1) / kQueries);
  const int select_blocks = (batch + kSelectWarps - 1) / kSelectWarps;
  const int8_t* c8 = static_cast<const int8_t*>(codes);
  for (int level = 0; level <= 3; ++level) {
    int* h = hist + static_cast<size_t>(level < 3 ? level : 0) * batch * kBins;
    count<<<grid, kTile, smem_count, s>>>(u, c8, scales, ids, batch, dim, rows,
                                          rows_per_block, level, state, h, equal,
                                          cand, cap);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    if (level < 3)
      select_kernel<<<select_blocks, 32 * kSelectWarps, 0, s>>>(
          level, h, level == 2 ? 1 << digit_width(2) : kBins, kBins, batch, kos, cap, state);
    else
      select_kernel<<<select_blocks, 32 * kSelectWarps, 0, s>>>(
          level, equal, static_cast<int>(nblocks), nblocks, batch, kos, cap, state);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  filter<<<grid, kTile, smem_filter, s>>>(u, c8, scales, ids, batch, dim, rows,
                                          rows_per_block, 0, state, hist, equal, cand, cap);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  select_kernel<<<select_blocks, 32 * kSelectWarps, 0, s>>>(4, hist, 0, 0, batch, kos, cap,
                                                            state);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 rgrid((cap + kRankThreads - 1) / kRankThreads, batch);
  rank_kernel<<<rgrid, kRankThreads, 0, s>>>(cand, state, cap, kos, out_scores, out_rows);
  return static_cast<int>(cudaGetLastError());
}

const char* retrieval_topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
