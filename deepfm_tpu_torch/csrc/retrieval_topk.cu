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
// no order, so the selection is two passes:
//
//   pass 1 (score_select_kernel): a grid of row ranges x query chunks of up
//     to 8 queries.  A block stages its queries in shared memory and walks
//     its rows in tiles of 256, one row a thread (neighbouring threads on
//     neighbouring rows, 16-byte code loads started a tile ahead of their
//     use), scoring each row against every query of the chunk.  Each query
//     keeps, in shared memory, a sorted list of its best `kos` keys
//     followed by a buffer; a key enters the buffer (one shared atomic per
//     warp) only if it beats the list's kos-th key.  When a buffer could
//     overflow in the next tile, the block sorts list + buffer (one bitonic
//     network over all the chunk's lists) and the kos-th key tightens.  The
//     block writes its kos best keys per query, sorted, to a workspace.
//   pass 2 (merge_select_kernel): one block of 1,024 threads per query
//     first sorts the heads of the row blocks' sorted lists (enough of them
//     to bound the kos-th key), then streams the rest of the candidates
//     through the same filtered buffer and writes the final kos, decoded to
//     (score, row).
//
// Bound.  At the funnel's 2,000,000-row corpus of dimension 32, B = 8, the
// work must read 80 MB (codes, scales, ids once): 23.9 us at 3.35 TB/s,
// while its 1.09 GFLOP of f32 FMAs take 16 us on the CUDA cores at
// 67 TFLOP/s, so bytes bound it.  The FMAs grow with B (2·B·R·D) and pass
// the bytes near B = 13; at B = 64 the least time is about 122 us of FMAs.
// At the served 117,581-row corpus the bound is 1.4 us (B = 8) and 7.2 us
// (B = 64).  The design reads each code once per query chunk and never
// writes a score to device memory, but it is far from the bound: on an H100
// 80GB HBM3 at 700 W it takes 168 us at 117,581 x 8 and 461 us at
// 2,000,000 x 8 (PERF.md).  The block-wide bitonic sorts set that time: a
// stage costs some 600 cycles of instruction dispatch and a barrier, a sort
// 45-66 stages, and pass 2 alone takes about 85 us.  Selecting in
// registers (warp-wide sorts by shuffles, no block barriers) is the next
// step; the tensor cores would need other numerics (a bf16 or int8 query).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr u64 kSentinel = ~0ULL;      // larger than every real key
constexpr int kQueries = 8;           // queries per pass-1 block
constexpr int kTile1 = 256;           // pass-1 threads = rows per tile
constexpr int kTile2 = 1024;          // pass-2 threads = keys per tile
constexpr int kMaxChunks = 8;         // D = 16·chunks, at most 128

// shared bytes of a block's staged queries, rounded up so the lists after
// them stay 16-byte aligned
__host__ __device__ __forceinline__ int query_bytes(int qpb, int dim) {
  return (qpb * dim * 4 + 15) & ~15;
}

__device__ __forceinline__ u64 make_key(float s, unsigned row) {
  unsigned b = __float_as_uint(s);
  if ((b << 1) == 0u) b = 0u;                                // -0.0 -> +0.0
  const unsigned o = (b & 0x80000000u) ? ~b : (b | 0x80000000u);  // asc. in s
  return (static_cast<u64>(~o) << 32) | row;                 // asc. in -s
}

__device__ __forceinline__ float key_score(u64 key) {
  const unsigned o = ~static_cast<unsigned>(key >> 32);
  const unsigned b = (o & 0x80000000u) ? (o & 0x7fffffffu) : ~o;
  return __uint_as_float(b);
}

// Append `key` to a list's buffer where `pass`: one shared atomic per warp
// (a ballot counts the warp's passing lanes).  Every lane of the warp calls
// it, passing or not.
__device__ __forceinline__ void append(u64* list, int* count, int kos, u64 key,
                                       bool pass) {
  const unsigned m = __ballot_sync(0xffffffffu, pass);
  if (m == 0u) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(m) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(count, __popc(m));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (pass) list[kos + base + __popc(m & ((1u << lane) - 1u))] = key;
}

// Sort `nq` lists of `len` keys (len a power of two, lists contiguous)
// ascending with one bitonic network; list q holds its kept keys in
// [0, kos) and count[q] buffered keys after them.  Each thread takes up to
// kIlp compare-exchange pairs of a stage at once (loads first, then the
// exchanges), so the shared-memory latency of one pair hides another's.
// Then each list's kos-th key becomes its threshold and its buffer
// empties.  Every thread of the block calls this, after a barrier that
// follows the last append.
constexpr int kIlp = 4;

__device__ void merge_lists(u64* lists, int nq, int len, int kos, int* count,
                            u64* thresh) {
  for (int q = 0; q < nq; ++q)
    for (int i = kos + count[q] + threadIdx.x; i < len; i += blockDim.x)
      lists[q * len + i] = kSentinel;
  __syncthreads();
  const int half = len >> 1;
  const int shift = __ffs(half) - 1;              // half is a power of two
  const int pairs = nq * half;
  const int step = blockDim.x * kIlp;
  for (int k = 2; k <= len; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t0 = threadIdx.x; t0 < pairs; t0 += step) {
        int at[kIlp];
        u64 x[kIlp], y[kIlp];
#pragma unroll
        for (int m = 0; m < kIlp; ++m) {
          const int t = t0 + m * blockDim.x;
          const int tl = t & (half - 1);              // pair within its list
          const int i = 2 * tl - (tl & (j - 1));      // its lower index
          at[m] = t < pairs ? ((t >> shift) * len + i) : -1;
          if (at[m] >= 0) {
            x[m] = lists[at[m]];
            y[m] = lists[at[m] + j];
          }
        }
#pragma unroll
        for (int m = 0; m < kIlp; ++m) {
          if (at[m] >= 0) {
            const bool ascending = ((at[m] & (len - 1)) & k) == 0;
            if ((x[m] > y[m]) == ascending) {
              lists[at[m]] = y[m];
              lists[at[m] + j] = x[m];
            }
          }
        }
      }
      __syncthreads();
    }
  }
  if (threadIdx.x < nq) {
    count[threadIdx.x] = 0;
    thresh[threadIdx.x] = lists[threadIdx.x * len + kos - 1];
  }
  __syncthreads();
}

// One row's inputs, loaded a tile ahead of their use: NC 16-byte chunks
// of codes (D = 16·NC), its scale and its id.  D also reaches the kernel
// as a run-time argument: with D a compile-time constant, pass 1 ran 2-6%
// slower on an H100 80GB HBM3 (PERF.md).
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

template <int NC>
__global__ void __launch_bounds__(kTile1) score_select_kernel(
    const float* __restrict__ u, const int8_t* __restrict__ codes,
    const float* __restrict__ scales, const int* __restrict__ ids, int batch,
    int dim, long long rows, int kos, int qpb, int len,
    long long rows_per_block, u64* __restrict__ cand) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* us = reinterpret_cast<float*>(smem);             // [qpb][dim]
  u64* lists = reinterpret_cast<u64*>(smem + query_bytes(qpb, dim));  // [qpb][len]
  u64* thresh = lists + static_cast<size_t>(qpb) * len;   // [qpb]
  int* count = reinterpret_cast<int*>(thresh + qpb);      // [qpb]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.y * qpb;
  const int nq = min(qpb, batch - q0);
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);
  for (int i = tid; i < nq * len; i += blockDim.x) lists[i] = kSentinel;
  for (int i = tid; i < nq * dim; i += blockDim.x)
    us[i] = u[static_cast<size_t>(q0) * dim + i];
  if (tid < nq) {
    thresh[tid] = kSentinel;
    count[tid] = 0;
  }
  RowLoad<NC> next;
  load_row<NC>(next, codes, scales, ids, dim, r0 + tid, r0 + tid < r1);
  __syncthreads();

  const int room = len - kos - kTile1;  // a buffer past this may overflow
  for (long long base = r0; base < r1; base += kTile1) {
    const long long r = base + tid;
    const bool in_range = r < r1;
    const RowLoad<NC> cur = next;
    // the next tile's loads are in flight while this one is scored
    load_row<NC>(next, codes, scales, ids, dim, r + kTile1, r + kTile1 < r1);
    float acc[kQueries];
#pragma unroll
    for (int q = 0; q < kQueries; ++q) acc[q] = 0.0f;
    if (cur.id >= 0) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int8_t* b = reinterpret_cast<const int8_t*>(&cur.c[c]);
        float deq[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) deq[j] = static_cast<float>(b[j]) * cur.scale;
#pragma unroll
        for (int q = 0; q < kQueries; ++q) {
          if (q < nq) {
            const float4* uq = reinterpret_cast<const float4*>(us + q * dim + 16 * c);
            float a = acc[q];
#pragma unroll
            for (int j4 = 0; j4 < 4; ++j4) {
              const float4 w = uq[j4];
              a = fmaf(w.x, deq[4 * j4], a);
              a = fmaf(w.y, deq[4 * j4 + 1], a);
              a = fmaf(w.z, deq[4 * j4 + 2], a);
              a = fmaf(w.w, deq[4 * j4 + 3], a);
            }
            acc[q] = a;
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kQueries; ++q) {
      if (q < nq) {
        const float s = cur.id >= 0 ? acc[q] : __int_as_float(0xff800000);
        const u64 key = make_key(s, static_cast<unsigned>(r));
        append(lists + q * len, count + q, kos, key, in_range && key < thresh[q]);
      }
    }
    __syncthreads();
    bool full = false;
    for (int q = 0; q < nq; ++q) full |= count[q] > room;
    __syncthreads();  // every thread has decided before anyone appends again
    if (full) merge_lists(lists, nq, len, kos, count, thresh);
  }
  bool pending = false;
  for (int q = 0; q < nq; ++q) pending |= count[q] > 0;
  if (pending) merge_lists(lists, nq, len, kos, count, thresh);

  for (int q = 0; q < nq; ++q) {
    u64* out = cand + (static_cast<size_t>(q0 + q) * gridDim.x + blockIdx.x) * kos;
    for (int i = tid; i < kos; i += blockDim.x) out[i] = lists[q * len + i];
  }
}

__global__ void __launch_bounds__(kTile2) merge_select_kernel(
    const u64* __restrict__ cand, int lists_in, int kos, int len,
    float* __restrict__ out_scores, int* __restrict__ out_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* list = reinterpret_cast<u64*>(smem);               // [len]
  u64* thresh = list + len;                               // [1]
  int* count = reinterpret_cast<int*>(thresh + 1);        // [1]

  const int tid = threadIdx.x;
  const int q = blockIdx.x;
  const int n_cand = lists_in * kos;
  const u64* in = cand + static_cast<size_t>(q) * n_cand;
  for (int i = tid; i < len; i += blockDim.x) list[i] = kSentinel;
  if (tid == 0) {
    *thresh = kSentinel;
    *count = 0;
  }
  __syncthreads();

  // The pass-1 lists are sorted, so the first `head` keys of every list
  // (lists_in * head >= kos of them) hold at least kos keys no larger than
  // their kos-th smallest: that key bounds the answer's kos-th from above.
  // Sorting the heads first gives the stream a tight threshold at once.
  const int head = (kos + lists_in - 1) / lists_in;
  for (int i = tid; i < lists_in * head; i += blockDim.x)
    list[kos + i] = in[(i / head) * kos + i % head];
  if (tid == 0) *count = lists_in * head;
  __syncthreads();
  merge_lists(list, 1, len, kos, count, thresh);

  const int room = len - kos - kTile2;
  for (int base = 0; base < n_cand; base += kTile2) {
    const int i = base + tid;
    const u64 key = i < n_cand && i % kos >= head ? in[i] : kSentinel;
    append(list, count, kos, key, key < *thresh);
    __syncthreads();
    const bool full = *count > room;
    __syncthreads();
    if (full) merge_lists(list, 1, len, kos, count, thresh);
  }
  if (*count > 0) merge_lists(list, 1, len, kos, count, thresh);

  for (int i = tid; i < kos; i += blockDim.x) {
    const u64 key = list[i];
    const bool empty = key == kSentinel;
    out_scores[static_cast<size_t>(q) * kos + i] =
        empty ? __int_as_float(0xff800000) : key_score(key);
    out_rows[static_cast<size_t>(q) * kos + i] =
        empty ? 0 : static_cast<int>(static_cast<unsigned>(key));
  }
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// list length for a given kos and tile: the kept keys, one tile of
// appends and half a tile of slack, rounded up to a power of two
int list_len(int kos, int tile) { return pow2_at_least(kos + tile + tile / 2); }

}  // namespace

extern "C" {

// Shared memory the two passes need, in bytes, for the wrapper's limit
// check: pass 1 for a block of min(8, batch) queries, then pass 2.
long long retrieval_topk_smem(int batch, int dim, int kos, int pass) {
  if (pass == 1) {
    const long long qpb = batch < kQueries ? batch : kQueries;
    return query_bytes(static_cast<int>(qpb), dim) + qpb * list_len(kos, kTile1) * 8 +
           qpb * (8 + 4);
  }
  return static_cast<long long>(list_len(kos, kTile2)) * 8 + 8 + 4;
}

// Launches both passes on `stream` and returns cudaGetLastError() as an
// int (0 = ok).  `workspace` holds batch * row_blocks * kos 64-bit keys.
// The caller has checked devices, types, shapes, contiguity, 1 <= kos,
// rows < 2**31 and that the shared memory fits the card; D must be a
// multiple of 16 up to 128 and the codes 16-byte aligned, or it returns
// cudaErrorInvalidValue.
int retrieval_topk(const float* u, const void* codes, const float* scales,
                   const int* ids, int batch, int dim, long long rows, int kos,
                   int row_blocks, void* workspace, float* out_scores,
                   int* out_rows, void* stream) {
  if (batch <= 0) return 0;
  // pass 2 seeds its buffer with up to kos + row_blocks - 1 list heads
  if (row_blocks < 1 || row_blocks > kTile2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int qpb = batch < kQueries ? batch : kQueries;
  const int len1 = list_len(kos, kTile1);
  const int len2 = list_len(kos, kTile2);
  const size_t smem1 = static_cast<size_t>(retrieval_topk_smem(batch, dim, kos, 1));
  const size_t smem2 = static_cast<size_t>(retrieval_topk_smem(batch, dim, kos, 2));
  // pass 1 for D = 16, 32, ..., 128
  typedef void (*Pass1)(const float*, const int8_t*, const float*, const int*, int,
                        int, long long, int, int, int, long long, u64*);
  const Pass1 pass1[kMaxChunks] = {
      score_select_kernel<1>, score_select_kernel<2>, score_select_kernel<3>,
      score_select_kernel<4>, score_select_kernel<5>, score_select_kernel<6>,
      score_select_kernel<7>, score_select_kernel<8>};
  if (dim % 16 != 0 || dim < 16 || dim > 16 * kMaxChunks ||
      reinterpret_cast<uintptr_t>(codes) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Pass1 score_select = pass1[dim / 16 - 1];
  // the attribute is per device, so it is set on every launch (the call
  // costs far less than the kernel)
  cudaError_t e = cudaFuncSetAttribute(
      score_select, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem1));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(merge_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem2));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long rows_per_block = (rows + row_blocks - 1) / row_blocks;
  u64* cand = static_cast<u64*>(workspace);
  const dim3 grid1(row_blocks, (batch + qpb - 1) / qpb);
  score_select<<<grid1, kTile1, smem1, s>>>(u, static_cast<const int8_t*>(codes), scales,
                                            ids, batch, dim, rows, kos, qpb, len1,
                                            rows_per_block, cand);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  merge_select_kernel<<<batch, kTile2, smem2, s>>>(
      cand, row_blocks, kos, len2, out_scores, out_rows);
  return static_cast<int>(cudaGetLastError());
}

const char* retrieval_topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
