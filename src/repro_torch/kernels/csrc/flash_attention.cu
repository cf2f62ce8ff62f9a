// Streaming (flash) softmax attention for Hopper (sm_90a): the CUDA-core
// (`simt`) route of kernels/flash_attention.py.  It takes the float32 calls,
// whose products must stay float32 for the reference's 2e-5 tolerance, and
// bf16 prefill at head dims 80 and 96; bf16 prefill at 64 and 128 goes to
// flash_prefill_sm90.cu, bf16 decode to flash_decode_splitkv.cu.
//
// Replaces the Pallas TPU kernel `_flash_kernel` in
// src/repro/kernels/flash_attention.py (launched there by
// `flash_attention_bhsd`, wrapped by `ops.flash_attention`).  For every query
// row of every (batch, query head) it computes
//
//   o = softmax(q . k^T) . v      over the keys kpos < kv_len
//                                 (and kpos <= q_offset + qrow when causal)
//
// with q pre-scaled by d**-0.5 and rounded to the input type, as the TPU
// kernel does, logits and accumulation in fp32, and the output in the input
// type.  The O(Sq x Skv) score matrix never reaches device memory: KV tiles
// stream through shared memory under an online softmax (running max m,
// normaliser l, fp32 accumulator).
//
// Bound on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s HBM3).  Prefill at
// the serving path's shape (B 4, Hq 32, Hkv 8, S 1024, D 64, causal) needs
// 4 * B * Hq * S(S+1)/2 * D = 17.2 GFLOP, 17.4 us at the tensor-core rate,
// against 42 MB of Q/K/V/O, 12.5 us: operations bound it.  A decode step
// (Sq 1 against a cache of ~1056 keys) reads 8.7 MB of K/V for 35 MFLOP:
// bytes bound it, at about 2.6 us.
//
// Design.  One block of 256 threads per (batch, KV head,
// tile of 64 query rows).  The rows of a tile are (position, head) pairs of
// the KV head's query-head group, row = s * group + g, so a GQA group shares
// each K/V tile it loads and the KV head is read as h / group in place of
// materialising repeated K/V; a decode step's 4 heads fill one tile.  Per KV
// tile of 64 keys: the block stages K and V in shared memory as fp32 (zero
// past kv_len), each thread forms a 4 x 4 block of scores with fp32 FMAs,
// the 16 threads of a half warp that share 4 rows take the row max and sum
// by shuffles, the probabilities go through shared memory, and each thread
// accumulates a 4 x (D / 16) block of the output.  KV tiles wholly above the
// diagonal are never loaded; the last tile is masked for any Sq and Skv.
// The products run on the CUDA cores in fp32, so the kernel's own ceiling is
// the fp32 rate (67 TFLOP/s), not the tensor cores': PERF.md records its
// time beside the bound.
//
// Layout.  q, o are [B, Sq, Hq, D] and k, v [B, Skv, Hkv, D] given by element
// strides for batch, position and head, with D contiguous: the model's
// [B, S, H, D] activations and a [B, H, S, D] view both go in without a copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;        // query rows per block
constexpr int kKeys = 64;        // keys per KV tile
constexpr int kThreads = 256;    // 16 row groups x 16 lanes
constexpr int kLanes = 16;       // threads sharing a row group (half a warp)
constexpr int kRowsPer = 4;      // rows per thread
constexpr int kColsPer = kKeys / kLanes;   // score columns per thread
constexpr int kPStride = kKeys + 4;        // rows r, r+4 on disjoint banks
constexpr unsigned kFullMask = 0xffffffffu;

struct Strides {
  long long b, s, h;  // element strides; the head dim is contiguous
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides qs, ks, vs, os;
  int sq, hkv, group, causal, q_offset, kv_len;
  float scale;
};

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kRows * (D + 4) + kKeys * (D + 1) + kKeys * D + kRows * kPStride);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_kernel(const Params p) {
  static_assert(D % kLanes == 0, "D must be a multiple of 16");
  constexpr int QS = D + 4;  // rows r and r + 4 on disjoint banks
  constexpr int KS = D + 1;  // 16 consecutive keys on distinct banks
  constexpr int VS = D;
  constexpr int kOutPer = D / kLanes;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kRows * QS;
  float* Vs = Ks + kKeys * KS;
  float* Ps = Vs + kKeys * VS;

  const T* __restrict__ q = static_cast<const T*>(p.q);
  const T* __restrict__ k = static_cast<const T*>(p.k);
  const T* __restrict__ v = static_cast<const T*>(p.v);
  T* __restrict__ o = static_cast<T*>(p.o);

  const int tid = threadIdx.x;
  const int ty = tid / kLanes;
  const int tx = tid % kLanes;
  const int b = blockIdx.y / p.hkv;
  const int hk = blockIdx.y % p.hkv;
  const int n_rows = p.sq * p.group;
  const int row0 = blockIdx.x * kRows;
  const long long kbase = b * p.ks.b + hk * p.ks.h;
  const long long vbase = b * p.vs.b + hk * p.vs.h;

  // Q tile: pre-scaled and rounded to T, zero past the last row.
  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int i = row0 + r;
    float x = 0.f;
    if (i < n_rows) {
      const int s = i / p.group, h = hk * p.group + i % p.group;
      x = to_f<T>(from_f<T>(to_f<T>(q[b * p.qs.b + s * p.qs.s + h * p.qs.h + d]) *
                            p.scale));
    }
    Qs[r * QS + d] = x;
  }

  int qpos[kRowsPer];
  float m[kRowsPer], l[kRowsPer], acc[kRowsPer][kOutPer];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    qpos[i] = p.q_offset + (row0 + ty * kRowsPer + i) / p.group;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOutPer; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (p.kv_len + kKeys - 1) / kKeys;
  if (p.causal) {  // skip KV tiles wholly above the tile's last query row
    const int last_qpos = p.q_offset + (min(row0 + kRows, n_rows) - 1) / p.group;
    n_tiles = min(n_tiles, last_qpos < 0 ? 0 : last_qpos / kKeys + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kKeys;
    __syncthreads();  // the last tile's readers are done with Ks, Vs, Ps
    for (int idx = tid; idx < kKeys * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      const int kp = kv0 + j;
      float kx = 0.f, vx = 0.f;  // zero V past kv_len: 0 * garbage is NaN
      if (kp < p.kv_len) {
        kx = to_f<T>(k[kbase + kp * p.ks.s + d]);
        vx = to_f<T>(v[vbase + kp * p.vs.s + d]);
      }
      Ks[j * KS + d] = kx;
      Vs[j * VS + d] = vx;
    }
    __syncthreads();

    // Scores: rows ty*4 + i, keys tx + 16 c.
    float s[kRowsPer][kColsPer];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
      for (int c = 0; c < kColsPer; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRowsPer], kv[kColsPer];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) qv[i] = Qs[(ty * kRowsPer + i) * QS + d];
#pragma unroll
      for (int c = 0; c < kColsPer; ++c) kv[c] = Ks[(tx + kLanes * c) * KS + d];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
        for (int c = 0; c < kColsPer; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

    // Online softmax over the tile; the 16 lanes of a row group hold a row.
    float alpha[kRowsPer];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kColsPer; ++c) {
        const int kp = kv0 + tx + kLanes * c;
        if (kp >= p.kv_len || (p.causal && kp > qpos[i])) s[i][c] = -INFINITY;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, off));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kColsPer; ++c) {
        const float pr = s[i][c] == -INFINITY ? 0.f : expf(s[i][c] - m_new);
        Ps[(ty * kRowsPer + i) * kPStride + tx + kLanes * c] = pr;
        sum += pr;
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFullMask, sum, off);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();

    // Output: rows ty*4 + i, columns tx + 16 c.
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
      for (int c = 0; c < kOutPer; ++c) acc[i][c] *= alpha[i];
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      float pv[kRowsPer], vv[kOutPer];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) pv[i] = Ps[(ty * kRowsPer + i) * kPStride + j];
#pragma unroll
      for (int c = 0; c < kOutPer; ++c) vv[c] = Vs[j * VS + tx + kLanes * c];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
        for (int c = 0; c < kOutPer; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int r = row0 + ty * kRowsPer + i;
    if (r >= n_rows) continue;
    const int s = r / p.group, h = hk * p.group + r % p.group;
    T* out = o + b * p.os.b + s * p.os.s + h * p.os.h;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kOutPer; ++c) out[tx + kLanes * c] = from_f<T>(acc[i][c] / den);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  static bool configured = false;  // the attribute is set once per kernel
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<D>()));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((p.sq * p.group + kRows - 1) / kRows, batch * p.hkv);
  flash_kernel<T, D><<<grid, kThreads, smem_bytes<D>(), stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int batch, int d, cudaStream_t stream) {
  switch (d) {
    case 64: return launch<T, 64>(p, batch, stream);
    case 80: return launch<T, 80>(p, batch, stream);
    case 96: return launch<T, 96>(p, batch, stream);
    case 128: return launch<T, 128>(p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry, bound with ctypes.  Returns the cudaError_t of the launch
// (0 = launched); the wrapper raises on anything else.
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* o, int is_bf16,
    int batch, int sq, int hq, int hkv, int d,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int q_offset, int kv_len, float scale, void* stream) {
  if (hkv <= 0 || hq % hkv != 0) return cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.qs = {q_sb, q_ss, q_sh};
  p.ks = {k_sb, k_ss, k_sh};
  p.vs = {v_sb, v_ss, v_sh};
  p.os = {o_sb, o_ss, o_sh};
  p.sq = sq; p.hkv = hkv; p.group = hq / hkv;
  p.causal = causal; p.q_offset = q_offset; p.kv_len = kv_len;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? static_cast<int>(dispatch<__nv_bfloat16>(p, batch, d, s))
                 : static_cast<int>(dispatch<float>(p, batch, d, s));
}
