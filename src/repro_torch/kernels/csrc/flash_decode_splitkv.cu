// Flash attention decode for Hopper (sm_90a): split-KV over the whole card,
// then a merge in split order.
//
// Replaces the Pallas TPU kernel `_flash_kernel` in
// src/repro/kernels/flash_attention.py for bf16 calls with at most 64 query
// rows per KV head (Sq * group <= 64: a decode step, or a short chunk), at
// head dims 64, 80, 96, 128, 192 and 256.  It computes what
// flash_prefill_sm90.cu computes (q pre-scaled by d**-0.5 and rounded to
// bf16, fp32 logits and softmax, output in bf16, the keys below kv_len, a
// causal mask and a sliding window), with p kept in fp32 for the second
// product.
//
// Bound on the H100 (3.35 TB/s HBM3): a decode step of the serving path
// (B 4, Hkv 8, 1,041 live keys of a 1,056-slot cache, D 64) reads 8.5 MB of
// K/V for 35 MFLOP, 2.6 us at the memory rate against 0.04 us at the
// tensor-core rate: bytes bound it, so the reads must be spread over every SM
// and kept in flight, and only the live keys read.
//
// Design.  Kernel 1, grid (splits, B * Hkv), 128 threads: the live keys
// [lo, n_live) (not the cache's slots: n_live is q_offset + Sq when causal,
// or kv_len; lo is 0, or the least key the first row's window holds) are
// cut into `splits` contiguous ranges of whole 64-key tiles from lo's tile
// on, none empty; the host picks the
// count so the grid has at least two blocks per SM and a block at most four
// tiles.  A block holds its KV head's query rows (the query group, 4 rows
// for llama3.2-1b, not a 64-row tile) and streams its range with 16-byte
// cp.async loads, double-buffered,
// into rows padded by 16 bytes (conflict-free 16-byte reads).  Scores: each
// thread holds one key row in registers against rows of q broadcast from
// shared memory; the softmax runs a warp per row; P.V: each thread owns two
// output columns of a few rows (D 192 / 256: every thread a column pair,
// and the key row read from shared memory for each query row rather than
// held in 128 registers).  All on the CUDA cores in fp32: at 35 MFLOP
// a step the bytes are the limit.  The block writes its partial (m, l,
// unnormalised acc) in fp32 to scratch.  Kernel 2, one block per (b, KV
// head), merges the partials in split order with no atomics, so a decode is
// deterministic: two identical calls give identical bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::Strides;

constexpr int kKeys = 64;       // keys per tile
constexpr int kThreads = 128;
constexpr int kMaxRows = 64;    // Sq * group

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  float* part_acc;              // [splits, B * Hkv, rows, D]
  float* part_ml;               // [splits, B * Hkv, rows, 2]
  Strides qs, ks, vs;
  int rows, hkv, group, causal, q_offset, n_live, tiles_per_split;
  int first_tile;               // the live range's first 64-key tile
  int win;                      // sliding window, 2**30 for none
  float scale;
};

struct MergeParams {
  const float* part_acc;
  const float* part_ml;
  __nv_bfloat16* o;
  Strides os;
  int rows, hkv, group, d, splits, bh;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  // src-size 0 fills the 16 bytes with zeros (keys past the live range).
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(flash::smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <int D>
struct Tile {
  static constexpr int kStride = D + 8;             // padded row, in bf16
  static constexpr int kChunks = D / 8;             // 16-byte chunks per row
  static constexpr int kLanes = D / 2 <= 32 ? 32 : D / 2 <= 64 ? 64 : 128;  // column pairs
  static constexpr int kGroups = kThreads / kLanes;      // row groups for P.V
  static constexpr int kBytes = 2 * 2 * kKeys * kStride * 2;  // 2 stages x (K, V)
};

// Shared memory: q [rows][D] f32 | s [rows][64] f32 | m, l, alpha [64] f32
// | K/V stages [2][2][64][D + 8] bf16.
template <int D>
size_t smem_bytes(int rows) {
  return sizeof(float) * (rows * D + rows * kKeys + 3 * kMaxRows) + Tile<D>::kBytes;
}

template <int D>
__device__ __forceinline__ void load_tile(const Params& p, __nv_bfloat16* kv, int stage,
                                          int tile, int b, int hk) {
  using T = Tile<D>;
  __nv_bfloat16* ks = kv + (2 * stage) * kKeys * T::kStride;
  __nv_bfloat16* vs = ks + kKeys * T::kStride;
  for (int idx = threadIdx.x; idx < kKeys * T::kChunks; idx += kThreads) {
    const int j = idx / T::kChunks, c = idx % T::kChunks;
    const int kp = tile * kKeys + j;
    const bool valid = kp < p.n_live;
    const int row = valid ? kp : 0;
    cp_async16(ks + j * T::kStride + c * 8,
               p.k + b * p.ks.b + row * p.ks.s + hk * p.ks.h + c * 8, valid);
    cp_async16(vs + j * T::kStride + c * 8,
               p.v + b * p.vs.b + row * p.vs.s + hk * p.vs.h + c * 8, valid);
  }
}

// RPT: rows of P.V per thread, the least of {1, 2, 8, 32, 64} that covers
// `rows` with Tile<D>::kGroups row groups.
template <int D, int RPT, bool kWindowed>
__global__ void __launch_bounds__(kThreads) flash_decode_split_kernel(const Params p) {
  using T = Tile<D>;
  extern __shared__ __align__(16) uint8_t smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ss = qs + p.rows * D;
  float* ms = ss + p.rows * kKeys;
  float* ls = ms + kMaxRows;
  float* al = ls + kMaxRows;
  __nv_bfloat16* kv = reinterpret_cast<__nv_bfloat16*>(al + kMaxRows);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x, bh = blockIdx.y;
  const int b = bh / p.hkv, hk = bh % p.hkv;
  const int t0 = p.first_tile + split * p.tiles_per_split;
  const int t1 = min(t0 + p.tiles_per_split, (p.n_live + kKeys - 1) / kKeys);

  if (t0 < t1) load_tile<D>(p, kv, 0, t0, b, hk);
  cp_async_commit();

  for (int idx = tid; idx < p.rows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int s = r / p.group, h = hk * p.group + r % p.group;
    const float x = __bfloat162float(p.q[b * p.qs.b + s * p.qs.s + h * p.qs.h + d]);
    qs[idx] = __bfloat162float(__float2bfloat16(x * p.scale));
  }
  if (tid < p.rows) {
    ms[tid] = -INFINITY;
    ls[tid] = 0.f;
  }

  const int dp = tid % T::kLanes, rg = tid / T::kLanes;   // P.V: column pair, row group
  const bool has_cols = dp < D / 2;
  float2 acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = make_float2(0.f, 0.f);

  for (int t = t0; t < t1; ++t) {
    const int stage = (t - t0) & 1;
    if (t + 1 < t1) {
      load_tile<D>(p, kv, stage ^ 1, t + 1, b, hk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = kv + (2 * stage) * kKeys * T::kStride;
    const __nv_bfloat16* vs = ks + kKeys * T::kStride;

    // Scores: thread -> key j; rows of one parity.  Up to D 128 the key row
    // is held in registers across the rows; above, each row reads it from
    // shared memory.
    {
      const int j = tid % kKeys, kp = t * kKeys + j;
      const __nv_bfloat16* krow = ks + j * T::kStride;
      constexpr bool kHold = D <= 128;
      uint4 kr[kHold ? T::kChunks : 1];
      if constexpr (kHold) {
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c) {
          kr[c] = *reinterpret_cast<const uint4*>(krow + c * 8);
        }
      }
      for (int r = tid / kKeys; r < p.rows; r += kThreads / kKeys) {
        const float* qr = qs + r * D;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c) {
          uint4 kc;
          if constexpr (kHold) {
            kc = kr[c];
          } else {
            kc = *reinterpret_cast<const uint4*>(krow + c * 8);
          }
          const float4 qa = *reinterpret_cast<const float4*>(qr + 8 * c);
          const float4 qb = *reinterpret_cast<const float4*>(qr + 8 * c + 4);
          const float2 k0 = flash::unpack_bf16(kc.x), k1 = flash::unpack_bf16(kc.y);
          const float2 k2 = flash::unpack_bf16(kc.z), k3 = flash::unpack_bf16(kc.w);
          dot = fmaf(qa.x, k0.x, dot);
          dot = fmaf(qa.y, k0.y, dot);
          dot = fmaf(qa.z, k1.x, dot);
          dot = fmaf(qa.w, k1.y, dot);
          dot = fmaf(qb.x, k2.x, dot);
          dot = fmaf(qb.y, k2.y, dot);
          dot = fmaf(qb.z, k3.x, dot);
          dot = fmaf(qb.w, k3.y, dot);
        }
        const int qpos = p.q_offset + r / p.group;
        const bool valid = kp < p.n_live && (!p.causal || kp <= qpos) &&
                           (!kWindowed || kp > qpos - p.win);
        ss[r * kKeys + j] = valid ? dot : -INFINITY;
      }
    }
    __syncthreads();

    // Online softmax: a warp per row, two scores per lane.
    for (int r = warp; r < p.rows; r += kThreads / 32) {
      float s0 = ss[r * kKeys + lane], s1 = ss[r * kKeys + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, mx);
      const float msc = m_new == -INFINITY ? 0.f : m_new * flash::kLog2e;
      s0 = flash::ex2(s0 * flash::kLog2e - msc);
      s1 = flash::ex2(s1 * flash::kLog2e - msc);
      ss[r * kKeys + lane] = s0;
      ss[r * kKeys + lane + 32] = s1;
      float sum = s0 + s1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float a = flash::ex2(m_old * flash::kLog2e - msc);
        al[r] = a;
        ls[r] = ls[r] * a + sum;
        ms[r] = m_new;
      }
    }
    __syncthreads();

    // O += P . V: thread -> column pair dp of rows rg, rg + kGroups, ...
    if (has_cols) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = rg + T::kGroups * i;
        if (r < p.rows) {
          const float a = al[r];
          acc[i].x *= a;
          acc[i].y *= a;
        }
      }
#pragma unroll 4
      for (int j = 0; j < kKeys; ++j) {
        const float2 vv =
            flash::unpack_bf16(*reinterpret_cast<const uint32_t*>(vs + j * T::kStride + 2 * dp));
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = rg + T::kGroups * i;
          if (r < p.rows) {
            const float pj = ss[r * kKeys + j];
            acc[i].x = fmaf(pj, vv.x, acc[i].x);
            acc[i].y = fmaf(pj, vv.y, acc[i].y);
          }
        }
      }
    }
    __syncthreads();  // the stage is refilled by the next iteration's load
  }

  const long long base = (static_cast<long long>(split) * gridDim.y + bh) * p.rows;
  if (has_cols) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg + T::kGroups * i;
      if (r < p.rows) {
        *reinterpret_cast<float2*>(p.part_acc + (base + r) * D + 2 * dp) = acc[i];
      }
    }
  }
  if (tid < p.rows) {
    p.part_ml[(base + tid) * 2] = ms[tid];
    p.part_ml[(base + tid) * 2 + 1] = ls[tid];
  }
}

// One block per (b, KV head): out = sum_s acc_s w_s / sum_s l_s w_s with
// w_s = exp(m_s - max_s m_s), summed in split order.
__global__ void __launch_bounds__(kThreads) flash_decode_merge_kernel(const MergeParams p) {
  const int bh = blockIdx.x, b = bh / p.hkv, hk = bh % p.hkv;
  const int pairs = p.d / 2;
  for (int idx = threadIdx.x; idx < p.rows * pairs; idx += kThreads) {
    const int r = idx / pairs, dp = idx % pairs;
    float m = -INFINITY;
    for (int s = 0; s < p.splits; ++s) {
      m = fmaxf(m, p.part_ml[((static_cast<long long>(s) * p.bh + bh) * p.rows + r) * 2]);
    }
    const float msc = m == -INFINITY ? 0.f : m * flash::kLog2e;
    float l = 0.f, ox = 0.f, oy = 0.f;
    for (int s = 0; s < p.splits; ++s) {
      const long long row = (static_cast<long long>(s) * p.bh + bh) * p.rows + r;
      const float w = flash::ex2(p.part_ml[row * 2] * flash::kLog2e - msc);
      const float2 a = *reinterpret_cast<const float2*>(p.part_acc + row * p.d + 2 * dp);
      l = fmaf(p.part_ml[row * 2 + 1], w, l);
      ox = fmaf(a.x, w, ox);
      oy = fmaf(a.y, w, oy);
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int s = r / p.group, h = hk * p.group + r % p.group;
    *reinterpret_cast<uint32_t*>(p.o + b * p.os.b + s * p.os.s + h * p.os.h + 2 * dp) =
        flash::pack_bf16(ox * inv, oy * inv);
  }
}

template <int D, int RPT, bool kWindowed>
cudaError_t launch_split(const Params& p, int splits, int bh, cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>(p.rows);
  static size_t configured = 0;  // the largest size the attribute allows so far
  if (bytes > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_decode_split_kernel<D, RPT, kWindowed>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<D>(kMaxRows)));
    if (err != cudaSuccess) return err;
    configured = smem_bytes<D>(kMaxRows);
  }
  flash_decode_split_kernel<D, RPT, kWindowed><<<dim3(splits, bh), kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// A kernel without the window's test serves the calls without a window, so
// they run the same code as before windows were taken.
template <int D, bool kWindowed>
cudaError_t dispatch_rows(const Params& p, int splits, int bh, cudaStream_t stream) {
  const int need = (p.rows + Tile<D>::kGroups - 1) / Tile<D>::kGroups;
  if (need <= 1) return launch_split<D, 1, kWindowed>(p, splits, bh, stream);
  if (need <= 2) return launch_split<D, 2, kWindowed>(p, splits, bh, stream);
  if (need <= 8) return launch_split<D, 8, kWindowed>(p, splits, bh, stream);
  if constexpr (Tile<D>::kGroups == 1) {   // D 192 / 256: one row group
    if (need > 32) return launch_split<D, 64, kWindowed>(p, splits, bh, stream);
  }
  return launch_split<D, 32, kWindowed>(p, splits, bh, stream);
}

template <int D>
cudaError_t dispatch(const Params& p, bool windowed, int splits, int bh, cudaStream_t stream) {
  return windowed ? dispatch_rows<D, true>(p, splits, bh, stream)
                  : dispatch_rows<D, false>(p, splits, bh, stream);
}

}  // namespace

// Plain C entry, bound with ctypes: both kernels on `stream`.  part_acc and
// part_ml are scratch of [splits, B * Hkv, rows, D] and [..., 2] fp32.
// Split i covers tiles first_tile + i * tiles_per_split, ... of the keys
// below n_live; `window` > 0 masks keys at or below a row's position less
// the window.  Returns the cudaError_t of the launches (0 = launched).
extern "C" int flash_decode(const void* q, const void* k, const void* v, void* o,
                            void* part_acc, void* part_ml, int batch, int sq, int hq, int hkv,
                            int d, long long q_sb, long long q_ss, long long q_sh,
                            long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                            long long v_ss, long long v_sh, long long o_sb, long long o_ss,
                            long long o_sh, int causal, int q_offset, int n_live, int splits,
                            int tiles_per_split, int first_tile, int window, float scale,
                            void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || sq * (hq / hkv) > kMaxRows || splits <= 0 ||
      batch * hkv > 65535 || first_tile < 0 || window < 0) {
    return cudaErrorInvalidValue;
  }
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float*>(part_ml);
  p.qs = {q_sb, q_ss, q_sh};
  p.ks = {k_sb, k_ss, k_sh};
  p.vs = {v_sb, v_ss, v_sh};
  p.group = hq / hkv;
  p.rows = sq * p.group;
  p.hkv = hkv;
  p.causal = causal;
  p.q_offset = q_offset;
  p.n_live = n_live;
  p.tiles_per_split = tiles_per_split;
  p.first_tile = first_tile;
  p.win = window > 0 ? window : (1 << 30);
  p.scale = scale;
  const int bh = batch * hkv;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 64: err = dispatch<64>(p, window > 0, splits, bh, s); break;
    case 80: err = dispatch<80>(p, window > 0, splits, bh, s); break;
    case 96: err = dispatch<96>(p, window > 0, splits, bh, s); break;
    case 128: err = dispatch<128>(p, window > 0, splits, bh, s); break;
    case 192: err = dispatch<192>(p, window > 0, splits, bh, s); break;
    case 256: err = dispatch<256>(p, window > 0, splits, bh, s); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  MergeParams mp;
  mp.part_acc = p.part_acc;
  mp.part_ml = p.part_ml;
  mp.o = static_cast<__nv_bfloat16*>(o);
  mp.os = {o_sb, o_ss, o_sh};
  mp.rows = p.rows;
  mp.hkv = hkv;
  mp.group = p.group;
  mp.d = d;
  mp.splits = splits;
  mp.bh = bh;
  flash_decode_merge_kernel<<<bh, kThreads, 0, s>>>(mp);
  return static_cast<int>(cudaGetLastError());
}
