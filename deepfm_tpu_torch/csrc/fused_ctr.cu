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

const char* fused_ctr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
