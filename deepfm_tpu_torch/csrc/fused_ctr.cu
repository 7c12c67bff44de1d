// Fused CTR embedding gather + FM interaction, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_gather_unique_kernel`, launched by
// `_gather_unique` behind `fused_ctr_interaction` in
// deepfm_tpu/ops/pallas_ctr.py.  It computes the whole forward of that
// function in one pass:
//
//   emb[b,f,:] = fm_v[clip(id, 0, Vv-1)] * val            [B, F, K]
//   y_w[b]     = sum_f fm_w[clip(id, 0, Vv-1, then Vw-1)] * val   [B]
//   y_v[b]     = 0.5 * sum_k ((sum_f e)^2 - sum_f e^2)    [B]
//
// with Vv the row count of fm_v (which may carry zero pad rows) and Vw that
// of fm_w (never padded).  Negative ids go to row 0.
//
// What is left out of the TPU design, and why: the 128-lane aligned-window
// view, the 64-deep DMA semaphore ring, the 65,536-id SMEM chunking and the
// sort-based dedup plan all exist because Mosaic cannot DMA a 32-float row
// at an arbitrary HBM offset.  Here a warp reads any row with one coalesced
// 128-byte load (K = 32: one float per lane), and at the flagship vocabulary
// the whole 15 MB fm_v fits in the H100's 50 MB L2, so a duplicate id is an
// L2 hit rather than a second trip to HBM.  No sort, no plan.
//
// Design: one warp per batch row, 4 warps per block.  Lanes first load 32
// (id, val) pairs of the row at once (coalesced), clip the ids, and gather
// their own fm_w terms; then the warp walks those fields, broadcasting each
// (row, val) by shuffle, and lanes stride over K reading the fm_v row,
// writing emb and accumulating sum_f e and sum_f e^2 in registers.  The
// row loads of 8 fields are issued before any is used, so a warp waits
// about F/8 memory latencies rather than F.  Warp shuffles reduce y_w and
// y_v at the end.  K up to 128 (4 floats a lane).
//
// Bound: bytes.  Per lookup the kernel moves 4 B id + 4 B val + 4 B fm_w +
// 128 B fm_v row read + 128 B emb write, about 268 B at K = 32: at B = 512,
// F = 39 that is 19,968 lookups, about 5.4 MB, about 1.6 us at the H100
// SXM's 3.35 TB/s (less where ids repeat: a repeated row is read once from
// HBM).  The design reads each input and writes each output once,
// coalesced, and keeps every intermediate (the FM sums) in registers; the
// operations (4 per element) are far below any compute limit.  At the
// serving buckets (8..512 rows) the grid is too small to hide memory
// latency, so the time is a chain of latencies, not bandwidth: measured
// 5.8-6.3 us at every bucket on an H100 80GB HBM3 at 700 W (PERF.md).
// More fields in flight per warp (float4 rows, several fields per load
// instruction) is the next step.
//
// ---------------------------------------------------------------------------
// Backward (fused_ctr_backward below).
//
// Replaces `_fused_bwd` in deepfm_tpu/ops/pallas_ctr.py, the custom-VJP
// backward of `fused_ctr_interaction`.  Given the cotangents g_emb [B,F,K],
// g_yw [B] and g_yv [B]:
//
//   r          = clip(id, 0, Vv-1)        rw = min(r, Vw-1)
//   e          = fm_v[r] * val
//   g_e        = g_emb + g_yv[b] * (sum_f' e[b,f'] - e[b,f])
//   d_fm_v[r] += g_e * val            (every lookup; duplicates summed)
//   d_fm_w[rw]+= g_yw[b] * val
//   d_vals     = sum_k g_e * fm_v[r] + g_yw[b] * fm_w[rw]   (optional)
//
// The clipping is the forward's, which is the plain JAX chain's
// (dense_lookup clips to each table's own rows).  It differs from the JAX
// `_fused_bwd` on int32 ids in [Vw, Vv): that one drops the fm_w gradient
// there and returns NaN d_vals (ROADMAP section C).
//
// What is left out of the TPU design, and why: the sort-based dedup plan,
// the segment_sum by the forward's inverse map and the one scatter per
// unique row exist because XLA:TPU serializes colliding scatter-adds.  On
// Hopper a float32 atomic add resolves in L2, colliding adds included, so
// row gradients go into d_fm_v by atomics: no sort, no inverse map, no
// unique-row pass.
//
// Design: a block takes 8 batch rows (kBwdRows).  sum_f e is not saved by
// the forward (the serving path has no use for it): pass 1 re-reads each
// row's fm_v rows (L2 hits: the flagship table fits the 50 MB L2) and sums
// e in registers, 1 or 2 warps a row, into shared memory.  Pass 2 takes
// the block's 8 * F lookups in field-major order, so that a window of 32
// lookups holds a few fields of all 8 rows, reads fm_v and g_emb again,
// forms g_e, and adds g_e * val into the row's gradient; d_vals reduces
// across lanes by shuffles.  8 lookups' loads are in flight at once.  The
// kernel allocates nothing: the wrapper zero-fills d_fm_v and d_fm_w.
//
// Repeated rows: every Criteo record carries the 13 numeric ids 1..13, and
// a popular category repeats too.  The first version added every lookup's
// gradient with its own atomics, and adds to one address serialize in L2:
// the train mix took 27.4 us at B = 1024 against 15.2 us on uniform ids
// (an H100 80GB HBM3 at 700 W, PERF.md), about (largest row multiplicity)
// x 10 ns.  So the sums are taken in levels before they reach d_fm_v:
//   1. a window: __match_any_sync groups its equal rows, the warp walks
//      each group's members one after another and sums their gradients
//      in registers (the numeric rows: one group of 8 per field);
//   2. the block: a group that spans fields adds its sum into a table of
//      rows in shared memory (claimed by compare-and-swap, added with
//      shared float atomics), and every group of two or more adds its fm_w
//      sum into a table of 4-row runs of fm_w, as does a lone lookup whose
//      run is there already; at block end each key is added once, a run as
//      one 16-byte atomic, since the 13 numeric rows share one line of
//      d_fm_w.
// Any other group, and any key a full table cannot take, adds to d_fm_v
// and d_fm_w itself.  No sort and no inverse map: the groups come from the
// match, the tables from a hash of the row.  The levels also shorten the
// chain of float additions into one address, which kept the one-row mix
// of chip_smoke.py within its 1e-5 tolerance at B = 4096.
// 2 warps a row halve each warp's chain of dependent loads, which sets the
// time at B = 1024 (1,024 rows fill 128 blocks); 1 warp a row lets B =
// 4096 fit the card at once (64 registers a thread, 32 warps a SM).  On an
// H100 80GB HBM3 at 700 W: 16.2-16.3 us on uniform ids and 16.1 us on the
// train mix at B = 1024 (the first version: 15.2-15.3 and 27.8-28.2),
// 46.5-46.8 and 46.5-46.7 us at B = 4096 (42.6-42.7 and 86.5-86.6;
// PERF.md).
// Atomics add in an order that changes from run to run, so the gradients
// are not bit-reproducible: compare them with a tolerance relative to
// their size.
//
// Bound: bytes.  g_emb (4 B F K bytes), ids, vals, g_yw, g_yv and each
// distinct fm_v/fm_w row are read once and each distinct gradient row and
// d_vals written once; about 8 float operations per element are far below
// any compute limit.  chip_smoke.py prints the bound for its batches beside
// the measured time (PERF.md).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxKPerLane = 4;  // K <= 128
constexpr int kBatch = 8;        // fields whose rows are in flight at once
constexpr unsigned kFullMask = 0xffffffffu;

template <typename IdT>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
fused_ctr_forward_kernel(const float* __restrict__ fm_w, int64_t w_rows,
                         const float* __restrict__ fm_v, int64_t v_rows,
                         int k_dim, const IdT* __restrict__ ids,
                         const float* __restrict__ vals, int batch,
                         int fields, float* __restrict__ emb,
                         float* __restrict__ y_w, float* __restrict__ y_v) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= batch) return;  // warp-uniform: the whole warp leaves together

  const IdT* row_ids = ids + static_cast<int64_t>(row) * fields;
  const float* row_vals = vals + static_cast<int64_t>(row) * fields;
  float* row_emb = emb + static_cast<int64_t>(row) * fields * k_dim;

  float sum_e[kMaxKPerLane];
  float sum_sq[kMaxKPerLane];
#pragma unroll
  for (int q = 0; q < kMaxKPerLane; ++q) {
    sum_e[q] = 0.f;
    sum_sq[q] = 0.f;
  }
  float acc_w = 0.f;  // this lane's fields' share of y_w

  for (int f0 = 0; f0 < fields; f0 += kWarp) {
    const int f_lane = f0 + lane;
    int64_t my_row = 0;
    float my_val = 0.f;
    if (f_lane < fields) {
      // clip in the incoming id type first: a wide id must not wrap
      const int64_t id = static_cast<int64_t>(row_ids[f_lane]);
      my_row = id < 0 ? 0 : (id >= v_rows ? v_rows - 1 : id);
      my_val = row_vals[f_lane];
      const int64_t w_row = my_row < w_rows ? my_row : w_rows - 1;
      acc_w += __ldg(fm_w + w_row) * my_val;
    }
    const int n = min(kWarp, fields - f0);
    for (int j0 = 0; j0 < n; j0 += kBatch) {
      // issue the row loads of kBatch fields before using any of them, so
      // the warp waits one memory latency per batch instead of per field
      float v[kBatch][kMaxKPerLane];
      float x[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const bool live = j0 + u < n;  // warp-uniform
        const int src = live ? j0 + u : 0;
        const int64_t r = __shfl_sync(kFullMask, my_row, src);
        x[u] = __shfl_sync(kFullMask, my_val, src);
#pragma unroll
        for (int q = 0; q < kMaxKPerLane; ++q) {
          const int k = lane + q * kWarp;
          v[u][q] = (live && k < k_dim) ? __ldg(fm_v + r * k_dim + k) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (j0 + u >= n) break;
        float* e_out = row_emb + static_cast<int64_t>(f0 + j0 + u) * k_dim;
#pragma unroll
        for (int q = 0; q < kMaxKPerLane; ++q) {
          const int k = lane + q * kWarp;
          if (k < k_dim) {
            const float e = v[u][q] * x[u];
            e_out[k] = e;
            sum_e[q] += e;
            sum_sq[q] += e * e;
          }
        }
      }
    }
  }

  float part = 0.f;
#pragma unroll
  for (int q = 0; q < kMaxKPerLane; ++q) part += sum_e[q] * sum_e[q] - sum_sq[q];
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) {
    part += __shfl_xor_sync(kFullMask, part, off);
    acc_w += __shfl_xor_sync(kFullMask, acc_w, off);
  }
  if (lane == 0) {
    y_w[row] = acc_w;
    y_v[row] = 0.5f * part;
  }
}

// The (row, val, fm_w row) of field f of a batch row, clipped as in the
// forward: in the incoming id type first, so a wide id cannot wrap.
template <typename IdT>
__device__ __forceinline__ void load_field(const IdT* row_ids,
                                           const float* row_vals, int f,
                                           int64_t v_rows, int64_t w_rows,
                                           int64_t* r, float* x, int64_t* rw) {
  const int64_t id = static_cast<int64_t>(row_ids[f]);
  *r = id < 0 ? 0 : (id >= v_rows ? v_rows - 1 : id);
  *rw = *r < w_rows ? *r : w_rows - 1;
  *x = row_vals[f];
}

// The backward's block: kBwdRows batch rows and kSplit warps to a row.
// Pass 1 forms sum_f e of each row, each of its warps over a share of its
// fields.  Pass 2 takes the block's kBwdRows * F lookups in field-major
// order (lookup i is field i / kBwdRows of batch row i % kBwdRows), an
// equal run of them to each warp, in windows of 32.  The launch takes 2
// warps a row when the grid then still fits the card at once
// (kResidentWarps a SM), else 1: on a 132-SM card, 2 at the train batch of
// 1,024 and 1 at 4,096.
constexpr int kBwdRows = 8;
constexpr int kResidentWarps = 32;  // a SM's warps at 64 registers a thread

// Rows (pass 1) or members (pass 2) whose loads are in flight at once: 8 at
// K <= 32, 4 for wider rows, so a thread stays within 64 registers.
template <int kQ>
__host__ __device__ constexpr int bwd_batch() {
  return kQ == 1 ? 8 : 4;
}

// The block's two tables in shared memory, open-addressed by a hash of
// the key.  `v`: the fm_v rows of the window groups that span fields
// (add_window), 64 / kQ rows of kQ * 32 floats.  `w`: the fm_w gradients
// of every group of two or more members (and of a lone lookup whose run is
// there already), summed per run of 4 fm_w rows (16 bytes).  At block end
// each key is added once into d_fm_v or d_fm_w.
constexpr int kProbes = 4;  // slots tried before a sum goes to d_fm_v/d_fm_w itself
constexpr int kRuns = 256;  // fm_w runs a block holds
constexpr unsigned long long kEmpty = ~0ULL;

template <int kQ>
struct BlockTable {
  static constexpr int kRows = 64 / kQ;
  unsigned long long row_keys[kRows];
  float v[kRows][kQ * kWarp];
  unsigned long long run_keys[kRuns];
  float w[kRuns][4];
};

// The slot of `key` in `keys` (`slots` a power of 2), or -1.  With
// `claim`, the first empty slot on the way is claimed for it; without, only
// a slot that holds it already counts (a claim racing with the look-up may
// be missed, and the caller then adds into device memory: the sum is the
// same).  -1 also when kProbes slots hold other keys.
__device__ __forceinline__ int table_slot(unsigned long long* keys, int slots, int64_t key,
                                          bool claim) {
  const unsigned long long k = static_cast<unsigned long long>(key);
  const unsigned h = static_cast<unsigned>((k * 0x9E3779B97F4A7C15ULL) >> 32);
#pragma unroll
  for (int p = 0; p < kProbes; ++p) {
    const int at = (h + p) & (slots - 1);
    const unsigned long long prev =
        claim ? atomicCAS(keys + at, kEmpty, k)
              : *(reinterpret_cast<volatile unsigned long long*>(keys) + at);
    if (prev == k) return at;
    if (prev == kEmpty) return claim ? at : -1;
  }
  return -1;
}

// One lookup of a window, as its owning lane holds it.
struct Lookup {
  int64_t row;   // clipped fm_v row
  int64_t wrow;  // clipped fm_w row
  float val, gw, gv;
};

// Lookup i of the block (field-major), if it is below `end` and its batch
// row is in the batch.
template <typename IdT>
__device__ __forceinline__ bool block_lookup(int64_t i, int64_t end, int b0, int batch,
                                             const IdT* ids, const float* vals,
                                             const float* g_yw, const float* g_yv,
                                             int fields, int64_t v_rows, int64_t w_rows,
                                             Lookup* me) {
  const int64_t b = b0 + i % kBwdRows;
  if (i >= end || b >= batch) return false;
  load_field(ids + b * fields, vals + b * fields, static_cast<int>(i / kBwdRows),
             v_rows, w_rows, &me->row, &me->val, &me->wrow);
  me->gw = g_yw[b];
  me->gv = g_yv[b];
  return true;
}

// Pass 2 over one window of 32 lookups (`live` the lanes that hold one).
// __match_any_sync groups the lanes whose rows are equal; each lane works
// out its place in an order that puts every group's members together (the
// groups by their lowest lane, members by lane), and the warp walks that
// order, bwd_batch<kQ>() members' loads in flight at once.  A member's row
// gradient g_e * val is summed in registers; after a group's last member
// its sums go to the block's row table when the group spans fields, else
// (or when the table has no slot for the row) to d_fm_v, one atomic per
// element.  Returns this lane's sum_k g_e * fm_v[r] (its d_vals before the
// fm_w term); on the lane of each group's last member it sets *w_sum, the
// group's fm_w gradient, and *w_many, whether the group has two members
// or more.  `order` is the warp's 32 ints of shared memory; `s_sum` holds
// kSplit partial sums of sum_f e per batch row.
template <bool kWantVals, int kQ, int kSplit>
__device__ __forceinline__ float add_window(
    unsigned live, const Lookup& me, int64_t i0, int lane, int k_dim, int fields,
    int b0, const float* s_sum, int* order, BlockTable<kQ>& table,
    const float* __restrict__ g_emb, const float* __restrict__ fm_v, float* d_fm_v,
    float* w_sum, bool* w_many) {
  constexpr int kNB = bwd_batch<kQ>();
  const bool on = (live >> lane) & 1u;
  const unsigned group = __match_any_sync(
      kFullMask, on ? static_cast<unsigned long long>(me.row) : ~0ULL);
  const unsigned below = (1u << lane) - 1u;
  // exclusive prefix, over the groups' lowest lanes, of the group sizes
  const int size = on && (group & below) == 0u ? __popc(group) : 0;
  int incl = size;
#pragma unroll
  for (int off = 1; off < kWarp; off *= 2) {
    const int t = __shfl_up_sync(kFullMask, incl, off);
    if (lane >= off) incl += t;
  }
  const int base = __shfl_sync(kFullMask, incl - size, __ffs(group) - 1);
  if (on) order[base + __popc(group & below)] = lane;
  const bool last = on && (group >> lane) == 1u;
  const unsigned last_of_group = __ballot_sync(kFullMask, last);
  // a group whose members lie in more than one field (lookup i0 + l is in
  // field (i0 + l) / kBwdRows) goes to the block's table: its row is
  // likely to come back in the block's other windows.  The lane of its
  // last member claims the slot.
  const bool spread =
      last && (i0 + lane) / kBwdRows != (i0 + __ffs(group) - 1) / kBwdRows;
  const int my_slot =
      spread ? table_slot(table.row_keys, BlockTable<kQ>::kRows, me.row, true) : -1;
  const unsigned in_table = __ballot_sync(kFullMask, my_slot >= 0);
  *w_many = last && __popc(group) > 1;
  __syncwarp();
  const int n = __popc(live);

  float acc[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) acc[q] = 0.f;
  float acc_w = 0.f;
  float my_dval = 0.f;
  for (int p0 = 0; p0 < n; p0 += kNB) {  // warp-uniform
    float v[kNB][kQ];
    float ge[kNB][kQ];
    int src[kNB];
#pragma unroll
    for (int u = 0; u < kNB; u += 4) {  // p0 and kNB are multiples of 4
      const int4 o = *reinterpret_cast<const int4*>(order + p0 + u);
      src[u] = o.x;
      src[u + 1] = o.y;
      src[u + 2] = o.z;
      src[u + 3] = o.w;
    }
#pragma unroll
    for (int u = 0; u < kNB; ++u) {
      const bool ok_u = p0 + u < n;  // warp-uniform
      if (!ok_u) src[u] = 0;
      const int64_t idx = i0 + src[u];
      const int64_t b = b0 + idx % kBwdRows;
      const int64_t r = __shfl_sync(kFullMask, me.row, src[u]);
      const float* g_f = g_emb + (b * fields + idx / kBwdRows) * k_dim;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int k = lane + q * kWarp;
        const bool ok = ok_u && k < k_dim;
        v[u][q] = ok ? __ldg(fm_v + r * k_dim + k) : 0.f;
        ge[u][q] = ok ? __ldg(g_f + k) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kNB; ++u) {
      if (p0 + u >= n) break;  // warp-uniform
      const float x = __shfl_sync(kFullMask, me.val, src[u]);
      const float gv = __shfl_sync(kFullMask, me.gv, src[u]);
      const float* sum_e = s_sum + ((i0 + src[u]) % kBwdRows) * kMaxKPerLane * kWarp;
      float part = 0.f;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int k = lane + q * kWarp;
        if (k < k_dim) {
          float se = 0.f;
#pragma unroll
          for (int h = 0; h < kSplit; ++h) se += sum_e[h * kBwdRows * kMaxKPerLane * kWarp + k];
          const float e = v[u][q] * x;
          const float g_e = ge[u][q] + gv * (se - e);
          acc[q] += g_e * x;
          if (kWantVals) part += g_e * v[u][q];
        }
      }
      acc_w += __shfl_sync(kFullMask, me.gw, src[u]) * x;
      if (kWantVals) {
#pragma unroll
        for (int off = kWarp / 2; off > 0; off /= 2) {
          part += __shfl_xor_sync(kFullMask, part, off);
        }
        if (lane == src[u]) my_dval = part;
      }
      if ((last_of_group >> src[u]) & 1u) {  // warp-uniform: the group is summed
        const int64_t r = __shfl_sync(kFullMask, me.row, src[u]);
        if ((in_table >> src[u]) & 1u) {  // warp-uniform
          const int slot = __shfl_sync(kFullMask, my_slot, src[u]);
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            const int k = lane + q * kWarp;
            if (k < k_dim) atomicAdd(&table.v[slot][k], acc[q]);
          }
        } else {
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            const int k = lane + q * kWarp;
            if (k < k_dim) atomicAdd(d_fm_v + r * k_dim + k, acc[q]);
          }
        }
        if (lane == src[u]) *w_sum = acc_w;
#pragma unroll
        for (int q = 0; q < kQ; ++q) acc[q] = 0.f;
        acc_w = 0.f;
      }
    }
  }
  __syncwarp();  // `order` is rewritten by the next window
  return my_dval;
}

// sum_f e over `fields` fields of one batch row in registers (kQ floats a
// lane), bwd_batch<kQ>() fields' loads in flight at once.
template <typename IdT, int kQ>
__device__ __forceinline__ void row_sum_e(const IdT* row_ids, const float* row_vals,
                                          int fields, int lane, int k_dim,
                                          const float* __restrict__ fm_v,
                                          int64_t v_rows, int64_t w_rows,
                                          float (&sum_e)[kQ]) {
  constexpr int kNB = bwd_batch<kQ>();
  for (int f0 = 0; f0 < fields; f0 += kWarp) {
    int64_t my_row = 0, my_wrow = 0;
    float my_val = 0.f;
    if (f0 + lane < fields) {
      load_field(row_ids, row_vals, f0 + lane, v_rows, w_rows, &my_row, &my_val,
                 &my_wrow);
    }
    const int n = min(kWarp, fields - f0);
    for (int j0 = 0; j0 < n; j0 += kNB) {
      float v[kNB][kQ];
      float x[kNB];
#pragma unroll
      for (int u = 0; u < kNB; ++u) {
        const bool live = j0 + u < n;  // warp-uniform
        const int src = live ? j0 + u : 0;
        const int64_t r = __shfl_sync(kFullMask, my_row, src);
        x[u] = live ? __shfl_sync(kFullMask, my_val, src) : 0.f;
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const int k = lane + q * kWarp;
          v[u][q] = (live && k < k_dim) ? __ldg(fm_v + r * k_dim + k) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kNB; ++u) {
#pragma unroll
        for (int q = 0; q < kQ; ++q) sum_e[q] += v[u][q] * x[u];
      }
    }
  }
}

// kQ = ceil(K / 32) floats a lane: the registers a launch needs for its
// K.  kSplit warps a batch row.  64 registers a thread.
template <typename IdT, bool kWantVals, int kQ, int kSplit>
__global__ void __launch_bounds__(kWarp * kBwdRows * kSplit, kResidentWarps / (kBwdRows * kSplit))
fused_ctr_backward_kernel(const float* __restrict__ g_emb,
                          const float* __restrict__ g_yw,
                          const float* __restrict__ g_yv,
                          const float* __restrict__ fm_w, int64_t w_rows,
                          const float* __restrict__ fm_v, int64_t v_rows,
                          int k_dim, const IdT* __restrict__ ids,
                          const float* __restrict__ vals, int batch,
                          int fields, float* __restrict__ d_fm_w,
                          float* __restrict__ d_fm_v,
                          float* __restrict__ d_vals) {
  // kSplit partial sums of sum_f e per batch row, each warp's walk, and
  // the table of repeated rows
  constexpr int kWarps = kBwdRows * kSplit;
  __shared__ float s_sum[kSplit][kBwdRows][kMaxKPerLane * kWarp];
  __shared__ __align__(16) int s_order[kWarps][kWarp];
  __shared__ BlockTable<kQ> table;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int b0 = blockIdx.x * kBwdRows;
  for (int i = threadIdx.x; i < BlockTable<kQ>::kRows; i += blockDim.x) {
    table.row_keys[i] = kEmpty;
  }
  for (int i = threadIdx.x; i < kRuns; i += blockDim.x) table.run_keys[i] = kEmpty;
  for (int i = threadIdx.x; i < 64 * kWarp; i += blockDim.x) {
    table.v[i / (kQ * kWarp)][i % (kQ * kWarp)] = 0.f;
  }
  for (int i = threadIdx.x; i < 4 * kRuns; i += blockDim.x) table.w[i / 4][i % 4] = 0.f;

  // this warp's run of the block's lookups; its first window's are loaded
  // while pass 1 runs
  const int64_t block_n = static_cast<int64_t>(kBwdRows) * fields;
  const int64_t per_warp = (block_n + kWarps - 1) / kWarps;
  const int64_t lo = warp * per_warp < block_n ? warp * per_warp : block_n;
  const int64_t hi = lo + per_warp < block_n ? lo + per_warp : block_n;
  Lookup me{0, 0, 0.f, 0.f, 0.f};
  bool on = block_lookup(lo + lane, hi, b0, batch, ids, vals, g_yw, g_yv, fields,
                         v_rows, w_rows, &me);

  // pass 1: the partial sum_f e of batch row b0 + warp % kBwdRows over
  // share warp / kBwdRows of its fields
  {
    const int j = warp % kBwdRows;
    const int share = (fields + kSplit - 1) / kSplit;
    const int f_lo = min(warp / kBwdRows * share, fields);
    const int f_hi = min(f_lo + share, fields);
    float sum_e[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) sum_e[q] = 0.f;
    const int64_t row = b0 + j;
    if (row < batch) {  // warp-uniform; every warp meets the barrier
      row_sum_e<IdT, kQ>(ids + row * fields + f_lo, vals + row * fields + f_lo,
                         f_hi - f_lo, lane, k_dim, fm_v, v_rows, w_rows, sum_e);
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int k = lane + q * kWarp;
      if (k < k_dim) s_sum[warp / kBwdRows][j][k] = sum_e[q];
    }
  }
  __syncthreads();

  // pass 2: the run, 32 lookups at a time
  for (int64_t i0 = lo; i0 < hi; i0 += kWarp) {
    if (i0 != lo) {
      on = block_lookup(i0 + lane, hi, b0, batch, ids, vals, g_yw, g_yv, fields,
                        v_rows, w_rows, &me);
    }
    float w_sum = 0.f;
    bool w_many = false;
    const float dval = add_window<kWantVals, kQ, kSplit>(
        __ballot_sync(kFullMask, on), me, i0, lane, k_dim, fields, b0, &s_sum[0][0][0],
        s_order[warp], table, g_emb, fm_v, d_fm_v, &w_sum, &w_many);
    if (w_sum != 0.f) {  // the last lane of a group
      // a group of two or more claims its run; a lone lookup joins a run
      // that the block holds already (the hot rows' run), else goes to d_fm_w
      const int slot = table_slot(table.run_keys, kRuns, me.wrow / 4, w_many);
      if (slot >= 0) {
        atomicAdd(&table.w[slot][me.wrow % 4], w_sum);
      } else {
        atomicAdd(d_fm_w + me.wrow, w_sum);
      }
    }
    if (kWantVals && on) {
      const int64_t i = i0 + lane;
      d_vals[(b0 + i % kBwdRows) * fields + i / kBwdRows] =
          dval + me.gw * __ldg(fm_w + me.wrow);
    }
  }

  // the tables, each key once: rows into d_fm_v, a warp a slot; runs into
  // d_fm_w, 16 bytes at once where the run is whole and aligned
  __syncthreads();
  for (int i = warp; i < BlockTable<kQ>::kRows; i += kWarps) {
    const unsigned long long key = table.row_keys[i];
    if (key == kEmpty) continue;  // warp-uniform
    const int64_t r = static_cast<int64_t>(key);
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int k = lane + q * kWarp;
      if (k < k_dim) atomicAdd(d_fm_v + r * k_dim + k, table.v[i][k]);
    }
  }
  const bool aligned = (reinterpret_cast<uintptr_t>(d_fm_w) & 15u) == 0u;
  for (int i = threadIdx.x; i < kRuns; i += blockDim.x) {
    const unsigned long long key = table.run_keys[i];
    if (key == kEmpty) continue;
    const int64_t w0 = static_cast<int64_t>(key) * 4;
    if (aligned && w0 + 4 <= w_rows) {
      atomicAdd(reinterpret_cast<float4*>(d_fm_w + w0),
                make_float4(table.w[i][0], table.w[i][1], table.w[i][2], table.w[i][3]));
    } else {
      for (int c = 0; c < 4 && w0 + c < w_rows; ++c) atomicAdd(d_fm_w + w0 + c, table.w[i][c]);
    }
  }
}

template <typename IdT, bool kWantVals, int kQ>
void launch_backward_q(const float* g_emb, const float* g_yw, const float* g_yv,
                       const float* fm_w, long long w_rows, const float* fm_v,
                       long long v_rows, int k_dim, const void* ids,
                       const float* vals, int batch, int fields, float* d_fm_w,
                       float* d_fm_v, float* d_vals, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const dim3 grid((batch + kBwdRows - 1) / kBwdRows);
  if (2LL * batch <= static_cast<long long>(kResidentWarps) * sms) {
    fused_ctr_backward_kernel<IdT, kWantVals, kQ, 2><<<grid, kWarp * kBwdRows * 2, 0, s>>>(
        g_emb, g_yw, g_yv, fm_w, w_rows, fm_v, v_rows, k_dim,
        static_cast<const IdT*>(ids), vals, batch, fields, d_fm_w, d_fm_v, d_vals);
  } else {
    fused_ctr_backward_kernel<IdT, kWantVals, kQ, 1><<<grid, kWarp * kBwdRows, 0, s>>>(
        g_emb, g_yw, g_yv, fm_w, w_rows, fm_v, v_rows, k_dim,
        static_cast<const IdT*>(ids), vals, batch, fields, d_fm_w, d_fm_v, d_vals);
  }
}

template <typename IdT, bool kWantVals>
void launch_backward_ids(const float* g_emb, const float* g_yw, const float* g_yv,
                         const float* fm_w, long long w_rows, const float* fm_v,
                         long long v_rows, int k_dim, const void* ids,
                         const float* vals, int batch, int fields, float* d_fm_w,
                         float* d_fm_v, float* d_vals, cudaStream_t s) {
  switch ((k_dim + kWarp - 1) / kWarp) {
    case 1:
      launch_backward_q<IdT, kWantVals, 1>(g_emb, g_yw, g_yv, fm_w, w_rows, fm_v,
                                           v_rows, k_dim, ids, vals, batch, fields,
                                           d_fm_w, d_fm_v, d_vals, s);
      break;
    case 2:
      launch_backward_q<IdT, kWantVals, 2>(g_emb, g_yw, g_yv, fm_w, w_rows, fm_v,
                                           v_rows, k_dim, ids, vals, batch, fields,
                                           d_fm_w, d_fm_v, d_vals, s);
      break;
    default:
      launch_backward_q<IdT, kWantVals, kMaxKPerLane>(
          g_emb, g_yw, g_yv, fm_w, w_rows, fm_v, v_rows, k_dim, ids, vals, batch,
          fields, d_fm_w, d_fm_v, d_vals, s);
  }
}

template <bool kWantVals>
void launch_backward(const float* g_emb, const float* g_yw, const float* g_yv,
                     const float* fm_w, long long w_rows, const float* fm_v,
                     long long v_rows, int k_dim, const void* ids,
                     int ids_int64, const float* vals, int batch, int fields,
                     float* d_fm_w, float* d_fm_v, float* d_vals,
                     cudaStream_t s) {
  if (ids_int64) {
    launch_backward_ids<int64_t, kWantVals>(g_emb, g_yw, g_yv, fm_w, w_rows, fm_v,
                                            v_rows, k_dim, ids, vals, batch, fields,
                                            d_fm_w, d_fm_v, d_vals, s);
  } else {
    launch_backward_ids<int32_t, kWantVals>(g_emb, g_yw, g_yv, fm_w, w_rows, fm_v,
                                            v_rows, k_dim, ids, vals, batch, fields,
                                            d_fm_w, d_fm_v, d_vals, s);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
// ids are int32 when ids_int64 == 0, else int64.  The caller has checked
// shapes, types, contiguity and k_dim <= 128.
int fused_ctr_forward(const float* fm_w, long long w_rows, const float* fm_v,
                      long long v_rows, int k_dim, const void* ids,
                      int ids_int64, const float* vals, int batch, int fields,
                      float* emb, float* y_w, float* y_v, void* stream) {
  if (batch <= 0) return 0;
  const dim3 block(kWarp * kWarpsPerBlock);
  const dim3 grid((batch + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ids_int64) {
    fused_ctr_forward_kernel<int64_t><<<grid, block, 0, s>>>(
        fm_w, w_rows, fm_v, v_rows, k_dim, static_cast<const int64_t*>(ids),
        vals, batch, fields, emb, y_w, y_v);
  } else {
    fused_ctr_forward_kernel<int32_t><<<grid, block, 0, s>>>(
        fm_w, w_rows, fm_v, v_rows, k_dim, static_cast<const int32_t*>(ids),
        vals, batch, fields, emb, y_w, y_v);
  }
  return static_cast<int>(cudaGetLastError());
}

// Adds the gradients of one batch into d_fm_w [w_rows] and d_fm_v
// [v_rows, k_dim], which the caller has zero-filled, and writes d_vals
// [batch, fields] unless it is null.  Launches on `stream` and returns
// cudaGetLastError() as an int (0 = ok).  ids as in fused_ctr_forward; the
// caller has checked shapes, types, contiguity and k_dim <= 128.
int fused_ctr_backward(const float* g_emb, const float* g_yw,
                       const float* g_yv, const float* fm_w, long long w_rows,
                       const float* fm_v, long long v_rows, int k_dim,
                       const void* ids, int ids_int64, const float* vals,
                       int batch, int fields, float* d_fm_w, float* d_fm_v,
                       float* d_vals, void* stream) {
  if (batch <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d_vals != nullptr) {
    launch_backward<true>(g_emb, g_yw, g_yv, fm_w, w_rows, fm_v, v_rows, k_dim,
                          ids, ids_int64, vals, batch, fields, d_fm_w, d_fm_v,
                          d_vals, s);
  } else {
    launch_backward<false>(g_emb, g_yw, g_yv, fm_w, w_rows, fm_v, v_rows,
                           k_dim, ids, ids_int64, vals, batch, fields, d_fm_w,
                           d_fm_v, d_vals, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fused_ctr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
