// Batched ExpectedCost(TTL) scan (paper §3.2.2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ttl_scan_kernel` in
// src/repro/kernels/ttl_scan.py (launched by `ttl_cost_surface` there).  For
// each of E edge rows over C candidate cells it computes
//
//   t_hat    = time_w / hist, or the cell midpoint where hist == 0
//   hit_csum, hist_csum, last_csum, age_csum
//            = inclusive prefix sums along the cells of
//              hist * t_hat, hist, last and last * mid
//   cost[j]  = first * n + s * hit_csum + miss * (n + e * s)
//              + tail * e * s + s * age_csum
//
// with miss / tail the row totals minus the prefix sums.  The TTL = 0 column
// and the argmin stay in the Python wrapper (repro_torch/kernels/ops.py).
//
// Bound.  The kernel moves 16 bytes per cell (three float32 loads, one
// float32 store) and does ~30 floating-point operations per cell, so it is
// bound by memory: 72,000 edges x 800 cells is 0.92 GB, about 0.28 ms at the
// H100's 3.35 TB/s.  A replay refresh solves n_regions - 1 = 8 edges at a
// time; there the launch itself is the cost.
//
// Design.  One warp per edge row, eight rows per block.  The warp walks the
// row in tiles of 32 cells: lane l loads cell 32 t + l (coalesced 128-byte
// loads and stores), a shuffle scan forms the tile's inclusive prefix sums,
// and a carry taken from lane 31 adds the earlier tiles -- so every prefix
// sum is carry + tile scan, an order written out here rather than left to a
// library scan.  A first pass over the row forms the totals of hist and last
// the same way (the second pass finds the row in L1/L2, not device memory),
// so past the last tile that holds data a prefix sum equals the total bit
// for bit and miss / tail are exactly 0: cost-tie plateaus stay flat there.
//
// Accumulation.  Everything is float32, as in the TPU kernel: loads, t_hat,
// the products, the prefix sums, the cost expression and the store.
// Decisions are taken from this surface by an argmin index with a relative
// tie band of 2**-20 (kernels/ops.py), a band tuned against the TPU kernel's
// float32 Hillis-Steele order; the carry + tile-scan order here is another
// float32 order and could in principle move a near-tie across the band.
// chip_smoke.py gates exactly that on the card (the replay-harvested corpus,
// a large-tier replay and the SkyStore golden fixtures: TTLs, decisions and
// dollars equal to the float64 engines).  Should a gate ever fail, take the
// prefix sums in float64, keeping float32 loads and stores (the H100's FP64
// rate is far above what this memory-bound scan needs) -- never widen the
// tie band.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_inclusive_scan(float x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_up_sync(kFullMask, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// carry + inclusive scan of the tile; returns the prefix sum of this lane's
// cell and advances `carry` to the prefix sum of the tile's last cell.
__device__ __forceinline__ float scan_tile(float x, int lane, float& carry) {
  const float v = carry + warp_inclusive_scan(x, lane);
  carry = __shfl_sync(kFullMask, v, 31);
  return v;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ttl_scan_kernel(const float* __restrict__ hist,
                const float* __restrict__ time_w,
                const float* __restrict__ last,
                const float* __restrict__ edges,
                const float* __restrict__ s_price,
                const float* __restrict__ n_price,
                const float* __restrict__ first_remote,
                float* __restrict__ cost,
                int n_rows, int n_cells) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // uniform across the warp
  const size_t base = static_cast<size_t>(row) * n_cells;
  const float* h_row = hist + base;
  const float* w_row = time_w + base;
  const float* l_row = last + base;
  float* c_row = cost + base;

  // Pass 1: row totals, by the same tile order as the prefix sums below.
  float tot_h = 0.0f, tot_l = 0.0f;
  for (int j0 = 0; j0 < n_cells; j0 += 32) {
    const int j = j0 + lane;
    const bool in = j < n_cells;
    scan_tile(in ? h_row[j] : 0.0f, lane, tot_h);
    scan_tile(in ? l_row[j] : 0.0f, lane, tot_l);
  }

  // Pass 2: the four prefix sums and the cost surface.
  const float s = s_price[row];
  const float n = n_price[row];
  const float first_n = first_remote[row] * n;
  float c_hit = 0.0f, c_h = 0.0f, c_l = 0.0f, c_age = 0.0f;
  for (int j0 = 0; j0 < n_cells; j0 += 32) {
    const int j = j0 + lane;
    const bool in = j < n_cells;
    const float h = in ? h_row[j] : 0.0f;
    const float tw = in ? w_row[j] : 0.0f;
    const float l = in ? l_row[j] : 0.0f;
    const float e = in ? edges[j] : 0.0f;
    const float lower = (in && j > 0) ? edges[j - 1] : 0.0f;
    const float mid = 0.5f * (lower + e);
    const float t_hat = h > 0.0f ? tw / fmaxf(h, 1e-30f) : mid;

    const float hit_csum = scan_tile(h * t_hat, lane, c_hit);
    const float hist_csum = scan_tile(h, lane, c_h);
    const float last_csum = scan_tile(l, lane, c_l);
    const float age_csum = scan_tile(l * mid, lane, c_age);
    if (in) {
      const float miss = tot_h - hist_csum;
      const float tail = tot_l - last_csum;
      c_row[j] = first_n + s * hit_csum + miss * (n + e * s) + tail * e * s
                 + s * age_csum;
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  Every pointer is a float32 device
// pointer (row-major [n_rows, n_cells] for hist/time_w/last/cost, [n_cells]
// for edges, [n_rows] for the prices and first_remote); `stream` is a
// cudaStream_t.  Launches on `stream` without synchronising and returns the
// cudaError_t of the launch (0 = launched).
extern "C" int ttl_scan(const float* hist, const float* time_w,
                        const float* last, const float* edges,
                        const float* s_price, const float* n_price,
                        const float* first_remote, float* cost, int n_rows,
                        int n_cells, void* stream) {
  if (n_rows <= 0 || n_cells <= 0) return static_cast<int>(cudaSuccess);
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  ttl_scan_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      hist, time_w, last, edges, s_price, n_price, first_remote, cost,
      n_rows, n_cells);
  return static_cast<int>(cudaGetLastError());
}
