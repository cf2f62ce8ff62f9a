// Streaming (flash) softmax attention in float32 for Hopper (sm_90a): the
// CUDA-core (`simt`) route of kernels/flash_attention.py.  It takes the
// float32 calls, whose products must stay float32 for the reference's 2e-5
// tolerance (TF32 keeps about three digits); every bf16 call goes to
// flash_prefill_sm90.cu or flash_decode_splitkv.cu.
//
// Replaces the Pallas TPU kernel `_flash_kernel` in
// src/repro/kernels/flash_attention.py (launched there by
// `flash_attention_bhsd`, wrapped by `ops.flash_attention`).  For every query
// row of every (batch, query head) it computes
//
//   o = softmax(q . k^T) . v      over the keys kpos < kv_len
//                                 (and kpos <= q_offset + qrow when causal,
//                                 and kpos > q_offset + qrow - window when
//                                 a sliding window is given)
//
// with q pre-scaled by d**-0.5 as the TPU kernel does, logits, softmax and
// accumulation in fp32.  The O(Sq x Skv) score matrix never reaches device
// memory: KV tiles stream through shared memory under an online softmax.
//
// Bound on the H100 (67 TFLOP/s fp32 on the CUDA cores, 3.35 TB/s HBM3): at
// the f32 gate's call (B 1, Hq 32, Hkv 8, S 256, D 64, causal) the two
// products are 4 * Hq * S(S+1)/2 * D = 0.27 GFLOP, 4.02 us, against 5.2 MB of
// Q/K/V/O, 1.6 us: operations bound it, so the kernel must keep the FMA
// pipes fed and the card full at a short sequence.
//
// Design.  What bounds a CUDA-core attention on this card is the path from
// shared memory to registers (128 B a clock an SM, broadcast or not) more
// than the FMA pipes (128 FMAs a clock an SM): every float a lane loads
// must feed at least 4 FMAs.  So a lane holds several query rows and uses
// each K or V float it loads for all of them.  A block of 4 warps owns a
// tile of query rows of one (batch, KV head): rows are (position, head)
// pairs of the KV head's query group, row = s * group + g, so the group
// shares every K/V tile and K/V are never repeated.  Four lanes share a set
// of rows, each a quarter of the columns (float4 chunks interleaved, so the
// four quarters of a K or V row are 64 contiguous bytes), and a lane holds
// 4 rows at D 64 (4 FMAs a loaded float; 32 rows a tile), 2 at D 80-128
// (16 rows a tile) and 1 at D 192 / 256 (8 rows a tile: Q and O alone
// are then 2 x D / 4 registers a lane).  Q is pre-scaled and held in registers, and so is the
// accumulator.  The 4 warps split the tile's keys: warp w takes KV tiles of
// 8 keys w, w + 4, ..., each its own, double-buffered in shared memory by
// cp.async (16 B a lane, zero-filled past kv_len), so the next tile's loads
// overlap this tile's products and no block barrier stands in the loop.
// Per tile a lane forms its rows' partial scores over its quarter from
// 16-byte shared loads, adds the other quarters' by two shuffles, and keeps
// the online softmax (running max m, sum l) and the probabilities in
// registers; P . V reads V the same way.  At the end each warp leaves
// (m, l, o) of its key share in shared memory and the block merges the 4
// shares in warp order, so results are deterministic.  Tiles wholly above
// the causal diagonal, or wholly below the first row's sliding window, are
// never loaded; a tile that crosses the diagonal, the window's edge or
// kv_len is masked.  At D 256 the K/V buffers take 4 warps x 4 x 8 x 256 x
// 4 B = 128 KB of shared memory (the kernel opts in past 48 KB).  Blocks are issued heaviest first (highest rows of every head
// first).  At the f32 gate's call that is 256 blocks of 128 threads for
// 132 SMs, two an SM at a time (registers bound it at D 64), and the
// heaviest blocks' 8 tiles a warp set the time: a split of those keys over
// more blocks with a merge kernel did not shorten it (PERF.md §6).
//
// Layout.  q, o are [B, Sq, Hq, D] and k, v [B, Skv, Hkv, D] given by element
// strides for batch, position and head, with D contiguous and every row
// 16-byte aligned (the wrapper checks): the model's [B, S, H, D] activations
// and a [B, H, S, D] view both go in without a copy.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::Strides;
using flash::smem_u32;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFullMask = 0xffffffffu;

constexpr int kLanes = 4;       // lanes that share a row, a quarter of D each
constexpr int kKeys = 8;        // keys a KV tile

// Per-D shape: rows a lane holds, rows a block holds, float4 chunks a lane
// holds of a row (its quarter), and the shared memory: two K and two V
// tiles a warp, later reused for the warps' (m, l, o) shares.
template <int D>
struct Shape {
  static_assert(kKeys * D % 128 == 0, "a tile must be whole float4s for 32 lanes");
  static constexpr int kRpt = D <= 64 ? 4 : D <= 128 ? 2 : 1;
  static constexpr int kRows = 32 / kLanes * kRpt;
  static constexpr int kChunks = D / 16;
  static constexpr int kTile = kKeys * D;                        // floats
  static constexpr int kWarpFloats = 4 * kTile;                  // K, V x 2 buffers
  static constexpr int kShareFloats = kRows * (D + 2);           // o, m, l
  static constexpr int kFloats =
      kWarps * (kWarpFloats > kShareFloats ? kWarpFloats : kShareFloats);
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  Strides qs, ks, vs, os;
  int sq, hkv, group, causal, q_offset, kv_len, row_tiles;
  int win;              // sliding window, 2**30 for none
  float scale;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)),
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

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float4& acc, float a, float4 x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

// Copy KV tile t (keys t * kKeys ...) of K and V into a warp's buffer; keys
// at or past kv_len read nothing and fill zeros (0 * garbage would be NaN).
template <int D>
__device__ __forceinline__ void load_tile(float* kbuf, float* vbuf, const Params& p,
                                          const float* kbase, const float* vbase, int t,
                                          int lane) {
#pragma unroll
  for (int it = 0; it < kKeys * D / 128; ++it) {   // kKeys * D / 4 chunks, 32 lanes
    const int idx = lane + 32 * it;
    const int j = idx / (D / 4), c = idx % (D / 4);
    const int kp = t * kKeys + j;
    const bool valid = kp < p.kv_len;
    const long long row = valid ? kp : 0;
    cp_async16(kbuf + 4 * idx, kbase + row * p.ks.s + 4 * c, valid);
    cp_async16(vbuf + 4 * idx, vbase + row * p.vs.s + 4 * c, valid);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_kernel(const Params p) {
  using S = Shape<D>;
  constexpr int R = S::kRpt, C = S::kChunks, G = 32 / kLanes;
  extern __shared__ __align__(16) float smem[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quarter = lane % kLanes, g = lane / kLanes;  // rows g + G i of the tile
  const int b = blockIdx.x / p.hkv, hk = blockIdx.x % p.hkv;
  const int row0 = (p.row_tiles - 1 - blockIdx.y) * S::kRows;   // heaviest first
  const int n_rows = p.sq * p.group;
  const float* kbase = p.k + b * p.ks.b + hk * p.ks.h;
  const float* vbase = p.v + b * p.vs.b + hk * p.vs.h;

  int n_tiles = (p.kv_len + kKeys - 1) / kKeys;
  const int last_qpos = p.q_offset + (min(row0 + S::kRows, n_rows) - 1) / p.group;
  if (p.causal) {  // skip KV tiles wholly above the tile's last query row
    n_tiles = min(n_tiles, last_qpos < 0 ? 0 : last_qpos / kKeys + 1);
  }
  const int first_qpos = p.q_offset + row0 / p.group;
  // and those wholly below its first row's window
  const int lo = first_qpos - p.win + 1;
  const int t_lo = lo > 0 ? min(lo / kKeys, n_tiles) : 0;

  float* kbuf = smem + warp * S::kWarpFloats;   // [2][kTile], then V [2][kTile]
  float* vbuf = kbuf + 2 * S::kTile;
  if (t_lo + warp < n_tiles) load_tile<D>(kbuf, vbuf, p, kbase, vbase, t_lo + warp, lane);
  cp_async_commit();        // the first tile loads while Q does

  // This lane's rows: Q pre-scaled, its quarter's columns (chunk c is
  // columns 16c + 4 quarter .. + 3), zero past the last row.
  float4 q[R][C];
  int qpos[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = row0 + g + G * i;
    qpos[i] = p.q_offset + row / p.group;
    const bool live = row < n_rows;
    const float* src = p.q + b * p.qs.b +
                       (live ? (row / p.group) * p.qs.s + (hk * p.group + row % p.group) * p.qs.h
                             : 0);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float4 x = live ? *reinterpret_cast<const float4*>(src + 16 * c + 4 * quarter)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      x.x *= p.scale;
      x.y *= p.scale;
      x.z *= p.scale;
      x.w *= p.scale;
      q[i][c] = x;
    }
  }

  float4 o[R][C];
  float m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) o[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int t = t_lo + warp, n = 0; t < n_tiles; t += kWarps, ++n) {
    const int buf = n & 1;
    if (t + kWarps < n_tiles) {   // the next tile into the other buffer
      load_tile<D>(kbuf + (buf ^ 1) * S::kTile, vbuf + (buf ^ 1) * S::kTile, p, kbase, vbase,
                   t + kWarps, lane);
    }
    cp_async_commit();
    cp_async_wait<1>();           // this tile's group is done
    __syncwarp();
    const float* ks = kbuf + buf * S::kTile + 4 * quarter;
    const float* vs = vbuf + buf * S::kTile + 4 * quarter;

    // Scores of the tile's keys for this lane's rows: its quarter's partial
    // dot products (each K float loaded once for R rows), then the other
    // quarters' added by two shuffles.
    float s[R][kKeys];
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
#pragma unroll
      for (int i = 0; i < R; ++i) s[i][j] = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4 kv = lds4(ks + j * D + 16 * c);
#pragma unroll
        for (int i = 0; i < R; ++i) s[i][j] = dot4(q[i][c], kv, s[i][j]);
      }
    }
    const int kv0 = t * kKeys;
    const bool masked = kv0 + kKeys > p.kv_len || (p.causal && kv0 + kKeys - 1 > first_qpos) ||
                        kv0 <= last_qpos - p.win;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        s[i][j] += __shfl_xor_sync(kFullMask, s[i][j], 1);
        s[i][j] += __shfl_xor_sync(kFullMask, s[i][j], 2);
        if (masked) {
          const int kp = kv0 + j;
          if (kp >= p.kv_len || (p.causal && kp > qpos[i]) || kp <= qpos[i] - p.win) {
            s[i][j] = -INFINITY;
          }
        }
        mx = fmaxf(mx, s[i][j]);
      }
      // Online softmax; a row that has seen no key keeps m = -inf and a
      // zero scaled max, so nothing becomes NaN.
      const float mn = fmaxf(m[i], mx);
      const float ms = mn == -INFINITY ? 0.f : mn * flash::kLog2e;
      const float alpha = flash::ex2(fmaf(m[i], flash::kLog2e, -ms));
      m[i] = mn;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        s[i][j] = flash::ex2(fmaf(s[i][j], flash::kLog2e, -ms));
        sum += s[i][j];
      }
      l[i] = fmaf(l[i], alpha, sum);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        o[i][c].x *= alpha;
        o[i][c].y *= alpha;
        o[i][c].z *= alpha;
        o[i][c].w *= alpha;
      }
    }

    // O += P . V over the tile's keys, each V float loaded once for R rows.
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4 vv = lds4(vs + j * D + 16 * c);
#pragma unroll
        for (int i = 0; i < R; ++i) axpy4(o[i][c], s[i][j], vv);
      }
    }
    __syncwarp();                 // the buffer is free for the tile after next
  }
  cp_async_wait<0>();

  // Merge the warps' shares of the keys in warp order: each warp leaves its
  // (o, m, l) in shared memory, then the block writes each row once.
  __syncthreads();                // every warp is done with its K/V buffers
  float* share = smem + warp * S::kShareFloats;  // [kRows][D], then m, l
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = g + G * i;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      *reinterpret_cast<float4*>(share + r * D + 16 * c + 4 * quarter) = o[i][c];
    }
    if (quarter == 0) {
      share[S::kRows * D + r] = m[i];
      share[S::kRows * (D + 1) + r] = l[i];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < S::kRows * (D / 4); idx += kThreads) {
    const int r = idx / (D / 4), c = idx % (D / 4);
    const int row = row0 + r;
    if (row >= n_rows) continue;
    float mw[kWarps];
    float m_all = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mw[w] = smem[w * S::kShareFloats + S::kRows * D + r];
      m_all = fmaxf(m_all, mw[w]);
    }
    const float ms = m_all == -INFINITY ? 0.f : m_all;
    float den = 0.f;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* sw = smem + w * S::kShareFloats;
      const float wt = expf(mw[w] - ms);
      den = fmaf(sw[S::kRows * (D + 1) + r], wt, den);
      axpy4(num, wt, lds4(sw + r * D + 4 * c));
    }
    const float inv = 1.f / fmaxf(den, 1e-30f);
    const int sp = row / p.group, h = hk * p.group + row % p.group;
    *reinterpret_cast<float4*>(p.o + b * p.os.b + sp * p.os.s + h * p.os.h + 4 * c) =
        make_float4(num.x * inv, num.y * inv, num.z * inv, num.w * inv);
  }
}

template <int D>
cudaError_t launch(Params p, int batch, cudaStream_t stream) {
  using S = Shape<D>;
  static bool configured = false;  // the attribute is set once per kernel
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(S::kBytes));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  p.row_tiles = (p.sq * p.group + S::kRows - 1) / S::kRows;
  if (p.row_tiles > 65535) return cudaErrorInvalidValue;     // the grid's y
  if (p.row_tiles == 0 || batch == 0) return cudaSuccess;
  const dim3 grid(batch * p.hkv, p.row_tiles);
  flash_kernel<D><<<grid, kThreads, S::kBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry, bound with ctypes.  Keys [0, kv_len) are live; `window` > 0
// masks keys at or below a row's position less the window.  Returns the
// cudaError_t of the launch (0 = launched); the wrapper raises on anything
// else.
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* o,
    int batch, int sq, int hq, int hkv, int d,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int q_offset, int kv_len, int window, float scale, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || window < 0) return cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.qs = {q_sb, q_ss, q_sh};
  p.ks = {k_sb, k_ss, k_sh};
  p.vs = {v_sb, v_ss, v_sh};
  p.os = {o_sb, o_ss, o_sh};
  p.sq = sq; p.hkv = hkv; p.group = hq / hkv;
  p.causal = causal; p.q_offset = q_offset; p.kv_len = kv_len;
  p.win = window > 0 ? window : (1 << 30);
  p.row_tiles = 0;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return static_cast<int>(launch<64>(p, batch, s));
    case 80: return static_cast<int>(launch<80>(p, batch, s));
    case 96: return static_cast<int>(launch<96>(p, batch, s));
    case 128: return static_cast<int>(launch<128>(p, batch, s));
    case 192: return static_cast<int>(launch<192>(p, batch, s));
    case 256: return static_cast<int>(launch<256>(p, batch, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
