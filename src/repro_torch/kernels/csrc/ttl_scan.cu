// Batched ExpectedCost(TTL) scan and TTL decision (paper §3.2.2) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_ttl_scan_kernel` in
// src/repro/kernels/ttl_scan.py (launched by `ttl_cost_surface` there), and
// the TTL = 0 column and argmin epilogue that the JAX package's
// kernels/ops.py forms around it.  For each of E edge rows over C candidate
// cells it computes
//
//   t_hat    = time_w / hist, or the cell midpoint where hist == 0
//   hit_csum, hist_csum, last_csum, age_csum
//            = inclusive prefix sums along the cells of
//              hist * t_hat, hist, last and last * mid
//   cost[j]  = first * n + s * hit_csum + miss * (n + e * s)
//              + tail * e * s + s * age_csum
//
// with miss / tail the row totals minus the prefix sums, and then, in the
// same block, the decision: the TTL = 0 cost (first + total_hist) * n, the
// row minimum m over [zero, cost], and the first index whose cost is at most
// m * (1 + 2**-20) in float64 -- `canonical_argmin` of kernels/ref.py on the
// kernel's own float32 values, so the index is the one the CPU would take
// from the same surface, bit for bit (a float32 value is at most that
// float64 threshold exactly when it is at most the threshold rounded down
// to float32, which is the test the kernel makes).  The surface is stored
// only when asked.
//
// Bound.  With the surface the kernel moves 16 bytes per cell (three float32
// loads, one float32 store); the decision alone 12.  It does ~26
// floating-point operations per cell, so by that count it is bound by
// memory: 72,000 edges x 800 cells is 0.92 GB with the surface (0.275 ms at
// the H100's 3.35 TB/s) and 0.69 GB without (0.206 ms).  A controller
// refresh solves n_regions - 1 = 8 edges that share one histogram (row
// stride 0): 13 KB, a bound of ~4 ns, so there the latency of one launch is
// the cost.  The written-out scan order below costs far more instructions
// than those 26 operations (a carry add per cell per scan level), so at
// 72,000 rows the decision-only call is held by instruction issue, not by
// bytes (PERF.md).
//
// Design.  ceil(C / 4) threads a block, rounded up to whole warps (224 for
// C = 800); thread t owns cells 4t .. 4t + 3.  A block per row, up to the
// blocks the card holds at once; past that, each block walks rows
// gridDim.x apart.
// - Latency: each thread copies its cells of hist, time_w and last into
//   its own slots of a ring of kStages rows in shared memory (cp.async, 16
//   bytes a copy where rows are 16-byte aligned and C % 4 == 0, 4 bytes
//   otherwise), two rows ahead of the one it solves, and reads only what it
//   copied: no barrier guards the ring.  At E = 8 the chain is one load
//   latency, then ~5 + 3 shuffle rounds and three barriers -- not one warp
//   walking 25 tiles twice; at E = 72,000 two rows of loads stay in flight
//   while a row is solved.
// - Traffic: one pass.  Each input is read once (the row totals come out of
//   the same scan) and the surface is written at most once.  The TTL = 0
//   column, the minimum and the index never leave the block.
// - Order, written out (no library scan: its order is not ours to state).
//   Each prefix sum is a Sklansky scan over the cells: a thread's four cells
//   in sequence; then across the 32 lanes of a warp, at each level d the
//   lanes of the upper half of every 2d-lane group add the running total of
//   the lower half (shuffled from its last lane) to each of their cells;
//   then the same across the warps of the block, each warp running the scan
//   over the warp totals (one barrier) and adding its carries level by
//   level.  Every addition is `carry + value`, rounded (__fadd_rn).  The row
//   totals are the value of the block's last element in that same order.
//   In such a scan a zero input changes nothing (x + 0 == x), so past the
//   last occupied cell each prefix sum equals the row total bit for bit:
//   miss and tail are exactly 0 there and cost-tie plateaus are flat -- past
//   the last occupied cell, not only past the last occupied 32-cell tile as
//   in the one-warp-per-row design this replaces.
// - Shared histograms: the row stride of hist, time_w and last is an
//   argument.  It is 0 when every row reads one histogram (a controller
//   refresh: E edges priced against one merged histogram); the prices stay
//   per row.
//
// Accumulation.  Everything is float32, as in the TPU kernel: loads, t_hat,
// the products, the prefix sums, the cost expression and the store; only
// the tie threshold is float64.  Decisions are taken from this surface by
// the index rule above, with a relative tie band of 2**-20
// (kernels/ref.py), a band tuned against the TPU kernel's float32
// Hillis-Steele order; the Sklansky order here is another float32 order and
// could in principle move a near-tie across the band.  chip_smoke.py gates
// exactly that on the card (the replay-harvested corpus, a large-tier replay
// and the SkyStore golden fixtures: TTLs, decisions and dollars equal to the
// float64 engines).  Should a gate ever fail, take the prefix sums in
// float64, keeping float32 loads and stores (a controller refresh is bound
// by launch latency, not arithmetic) -- never widen the tie band.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCells = 4;          // cells per thread
constexpr int kMaxThreads = 1024;  // so C <= 4096
constexpr int kQuantities = 4;     // hit, hist, last, age
constexpr int kStages = 3;         // rows a block has in flight
constexpr unsigned kFullMask = 0xffffffffu;
constexpr double kTieScale = 1.0 + 0x1p-20;  // 1 + TIE_BAND, exact in float64

template <bool kVec>
__device__ __forceinline__ void load_cells(const float* __restrict__ p,
                                           int j0, int n_cells,
                                           float (&x)[kCells]) {
  if (kVec) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (j0 < n_cells) v = __ldg(reinterpret_cast<const float4*>(p + j0));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < kCells; ++k)
      x[k] = j0 + k < n_cells ? __ldg(p + j0 + k) : 0.0f;
  }
}

// Asynchronous copies into shared memory (cp.async): `bytes` of `src`, the
// rest of the `size` bytes zero-filled; `src` stays a valid address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending));
}

// This thread's four cells of one input row into its own slot of a stage.
template <bool kVec>
__device__ __forceinline__ void copy_cells(float4* slot, const float* p,
                                           int j0, int n_cells) {
  if (kVec) {
    const bool in = j0 < n_cells;
    cp_async16(slot, p + (in ? j0 : 0), in ? 16 : 0);
  } else {
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      const bool in = j0 + k < n_cells;
      cp_async4(reinterpret_cast<float*>(slot) + k, p + (in ? j0 + k : 0),
                in ? 4 : 0);
    }
  }
}

// An int key of a float (not NaN) in the same order: the smallest key is the
// smallest value.  -0 sorts below +0, which no threshold test tells apart.
__device__ __forceinline__ int order_key(float x) {
  const int b = __float_as_int(x);
  return b < 0 ? b ^ 0x7fffffff : b;
}
__device__ __forceinline__ float from_key(int key) {
  return __int_as_float(key < 0 ? key ^ 0x7fffffff : key);
}

template <bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
ttl_scan_kernel(const float* __restrict__ hist,
                const float* __restrict__ time_w,
                const float* __restrict__ last,
                long long row_stride,
                const float* __restrict__ edges,
                const float* __restrict__ s_price,
                const float* __restrict__ n_price,
                const float* __restrict__ first_remote,
                float* __restrict__ cost,
                int* __restrict__ best_idx,
                float* __restrict__ best_cost,
                float* __restrict__ zero_cost,
                int n_rows, int n_cells) {
  // ring[stage][input][thread]: each thread's cells of the rows in flight.
  // A thread reads only the slots it filled, so its own cp.async wait is
  // all the ordering they need.
  extern __shared__ float4 ring[];
  // warp_tot alternates between rows, so one barrier a row keeps a fast
  // warp's next totals off a slow warp's current ones.
  __shared__ float warp_tot[2][kQuantities][32];
  __shared__ int warp_key[32];
  __shared__ int warp_idx[32];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int j0 = tid * kCells;
  const int step = gridDim.x;

  // Rows blockIdx.x, + step, + 2 step, ... : each row's loads are issued
  // kStages - 1 rows ahead of its arithmetic.
  auto issue = [&](int row, int stage) {
    if (row < n_rows) {
      const size_t base = static_cast<size_t>(row) * row_stride;
      float4* slot = ring + stage * 3 * blockDim.x + tid;
      copy_cells<kVec>(slot, hist + base, j0, n_cells);
      copy_cells<kVec>(slot + blockDim.x, time_w + base, j0, n_cells);
      copy_cells<kVec>(slot + 2 * blockDim.x, last + base, j0, n_cells);
    }
    cp_async_commit();  // empty groups too: one group per row slot
  };
  int row = blockIdx.x;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(row + i * step, i);

  // The cells' edges and midpoints are every row's.
  float e[kCells], mid[kCells];
  load_cells<kVec>(edges, j0, n_cells, e);
  const float lower0 = (j0 > 0 && j0 <= n_cells) ? __ldg(edges + j0 - 1) : 0.0f;
#pragma unroll
  for (int k = 0; k < kCells; ++k)
    mid[k] = __fmul_rn(0.5f, __fadd_rn(k == 0 ? lower0 : e[k - 1], e[k]));

  for (int it = 0; row < n_rows; row += step, ++it) {
    const int stage = it % kStages;
    issue(row + (kStages - 1) * step, (it + kStages - 1) % kStages);
    const float s = __ldg(s_price + row);
    const float n = __ldg(n_price + row);
    const float first = __ldg(first_remote + row);
    cp_async_wait<kStages - 1>();  // this row's group is in
    const float4* slot = ring + stage * 3 * blockDim.x + tid;
    const float4 hv = slot[0], twv = slot[blockDim.x], lv = slot[2 * blockDim.x];
    const float h4[kCells] = {hv.x, hv.y, hv.z, hv.w};
    const float tw4[kCells] = {twv.x, twv.y, twv.z, twv.w};
    const float l4[kCells] = {lv.x, lv.y, lv.z, lv.w};

    // The thread's four cells in sequence.
    float c[kQuantities][kCells];
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      const float h = h4[k];
      const float t_hat = h > 0.0f ? __fdiv_rn(tw4[k], fmaxf(h, 1e-30f)) : mid[k];
      const float x[kQuantities] = {__fmul_rn(h, t_hat), h, l4[k],
                                    __fmul_rn(l4[k], mid[k])};
#pragma unroll
      for (int q = 0; q < kQuantities; ++q)
        c[q][k] = k == 0 ? x[q] : __fadd_rn(c[q][k - 1], x[q]);
    }

    // Across the lanes of the warp: the upper half of each 2d-lane group
    // adds the lower half's total, level by level.
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int src = (lane & ~(2 * d - 1)) + d - 1;
      const bool upper = (lane & d) != 0;
#pragma unroll
      for (int q = 0; q < kQuantities; ++q) {
        const float carry = __shfl_sync(kFullMask, c[q][kCells - 1], src);
        if (upper) {
#pragma unroll
          for (int k = 0; k < kCells; ++k) c[q][k] = __fadd_rn(carry, c[q][k]);
        }
      }
    }

    // Across the warps: each warp scans the warp totals the same way and
    // adds its own carries to its cells; the row totals are the last warp's
    // total after the same carries -- the last element of the order.
    float (&tots)[kQuantities][32] = warp_tot[it & 1];
    if (lane == 31) {
#pragma unroll
      for (int q = 0; q < kQuantities; ++q) tots[q][warp] = c[q][kCells - 1];
    }
    __syncthreads();
    float v[kQuantities], tot[kQuantities];
#pragma unroll
    for (int q = 0; q < kQuantities; ++q)
      v[q] = lane < n_warps ? tots[q][lane] : 0.0f;
    for (int d = 1; d < n_warps; d <<= 1) {  // uniform across the block
      const int mine = (warp & ~(2 * d - 1)) + d - 1;
      const int theirs = (lane & ~(2 * d - 1)) + d - 1;
#pragma unroll
      for (int q = 0; q < kQuantities; ++q) {
        const float carry = __shfl_sync(kFullMask, v[q], mine);
        const float lower = __shfl_sync(kFullMask, v[q], theirs);
        if (warp & d) {
#pragma unroll
          for (int k = 0; k < kCells; ++k) c[q][k] = __fadd_rn(carry, c[q][k]);
        }
        if (lane & d) v[q] = __fadd_rn(lower, v[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kQuantities; ++q)
      tot[q] = __shfl_sync(kFullMask, v[q], n_warps - 1);

    // The cost surface (the TPU kernel's expression, float32).
    const float first_n = first * n;
    float cst[kCells];
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      const float miss = tot[1] - c[1][k];
      const float tail = tot[2] - c[2][k];
      cst[k] = first_n + s * c[0][k] + miss * (n + e[k] * s)
               + tail * e[k] * s + s * c[3][k];
    }
    if (cost != nullptr && j0 < n_cells) {
      float* c_row = cost + static_cast<size_t>(row) * n_cells;
      if (kVec) {
        *reinterpret_cast<float4*>(c_row + j0) =
            make_float4(cst[0], cst[1], cst[2], cst[3]);
      } else {
#pragma unroll
        for (int k = 0; k < kCells; ++k)
          if (j0 + k < n_cells) c_row[j0 + k] = cst[k];
      }
    }
    if (best_idx == nullptr) continue;  // uniform: the surface alone was asked

    // The decision: candidate 0 is TTL = 0, candidate j + 1 is cell j.
    // The row minimum by order keys (INT_MIN: a NaN is in the row, and then
    // torch's minimum is NaN, no candidate passes and the index is 0).
    const float zero = __fmul_rn(__fadd_rn(first, tot[1]), n);
    bool nan = zero != zero;
    int key = nan ? INT_MAX : order_key(zero);
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      if (j0 + k < n_cells) {
        nan |= cst[k] != cst[k];
        key = cst[k] != cst[k] ? key : min(key, order_key(cst[k]));
      }
    }
    key = __any_sync(kFullMask, nan) ? INT_MIN : __reduce_min_sync(kFullMask, key);
    if (lane == 0) warp_key[warp] = key;
    __syncthreads();
    key = __reduce_min_sync(kFullMask, lane < n_warps ? warp_key[lane] : INT_MAX);

    // First index at or under m * (1 + 2**-20) in float64; for a float32
    // value that is the same test as against that threshold rounded down to
    // float32.
    int idx = 0;
    if (key != INT_MIN) {  // uniform across the block
      const float thr = __double2float_rd(
          __dmul_rn(static_cast<double>(from_key(key)), kTieScale));
      int found = INT_MAX;
#pragma unroll
      for (int k = kCells - 1; k >= 0; --k)
        if (j0 + k < n_cells && cst[k] <= thr) found = j0 + k + 1;
      if (tid == 0 && zero <= thr) found = 0;
      found = __reduce_min_sync(kFullMask, found);
      if (lane == 0) warp_idx[warp] = found;
      __syncthreads();
      idx = __reduce_min_sync(kFullMask,
                              lane < n_warps ? warp_idx[lane] : INT_MAX);
    }

    if (tid == 0) {
      best_idx[row] = idx;
      zero_cost[row] = zero;
      if (idx == 0) best_cost[row] = zero;
    }
    if (idx > 0 && (idx - 1) / kCells == tid) {
      const int k = (idx - 1) % kCells;
      best_cost[row] = k == 0 ? cst[0] : k == 1 ? cst[1] : k == 2 ? cst[2] : cst[3];
    }
  }
  cp_async_wait<0>();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// Plain C entry point, bound with ctypes.  Every pointer is a device pointer.
// hist/time_w/last: float32 rows of n_cells, row r at r * row_stride
// elements (row_stride 0: every row reads one histogram); edges: float32
// [n_cells]; s_price/n_price/first_remote: float32 [n_rows].  Outputs, each
// may be null: cost, float32 row-major [n_rows, n_cells]; best_idx (int32),
// best_cost and zero_cost (float32), [n_rows] each, all three null or none.
// `stream` is a cudaStream_t.  Launches on `stream` without synchronising and
// returns the cudaError_t of the launch (0 = launched).
extern "C" int ttl_scan(const float* hist, const float* time_w,
                        const float* last, long long row_stride,
                        const float* edges, const float* s_price,
                        const float* n_price, const float* first_remote,
                        float* cost, int* best_idx, float* best_cost,
                        float* zero_cost, int n_rows, int n_cells,
                        void* stream) {
  if (n_rows <= 0 || n_cells <= 0) return static_cast<int>(cudaSuccess);
  if (n_cells > kMaxThreads * kCells ||
      (best_idx == nullptr) != (best_cost == nullptr) ||
      (best_idx == nullptr) != (zero_cost == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int warps = (n_cells + 32 * kCells - 1) / (32 * kCells);
  const int threads = 32 * warps;
  const bool vec = n_cells % kCells == 0 && row_stride % kCells == 0 &&
                   aligned16(hist) && aligned16(time_w) && aligned16(last) &&
                   aligned16(edges) && (cost == nullptr || aligned16(cost));
  const auto kernel = vec ? ttl_scan_kernel<true> : ttl_scan_kernel<false>;
  const size_t smem = sizeof(float4) * kStages * 3 * threads;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  // A block per row up to what the card holds at once; past that, each
  // block walks rows gridDim.x apart.
  int grid = n_rows;
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && n_rows > sms)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm > 0 && n_rows > per_sm * sms) grid = per_sm * sms;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      hist, time_w, last, row_stride, edges, s_price, n_price, first_remote,
      cost, best_idx, best_cost, zero_cost, n_rows, n_cells);
  return static_cast<int>(cudaGetLastError());
}
