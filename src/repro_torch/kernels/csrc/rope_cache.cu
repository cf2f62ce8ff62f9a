// GQA decode's rotary embedding and K / V cache write for Hopper (sm_90a), in
// one launch a layer.
//
// Replaces no Pallas kernel.  The JAX package's apply_attn
// (src/repro/models/layers.py) rotates q and k with plain jnp and writes the
// step's K / V rows into the caches with dynamic-update-slices; the port did
// the same with ~40 small device ops a layer (the positions, the frequency
// table, the angles, cos and sin, the f32 upcast, four products, two sums, a
// cat and a downcast, once for q and once for k, then two slice copies),
// each issued by the host.  At one query token a sequence the data is a few
// tens of KB, so the cost was the host's issue; here it is one launch.
//
// Function.  One decode step (S 1) at position `pos`: for each sequence b,
// with half = D / 2 and f_i = inv_freq[i] (i < half; fp32, the caller's
// table, plain rope's or YaRN's):
//   a_i = float(pos) * f_i,  c_i = cos(a_i) * scale,  s_i = sin(a_i) * scale
//   rot(x)_i        = x_i c_i - x_{i+half} s_i
//   rot(x)_{i+half} = x_{i+half} c_i + x_i s_i
//   q_out[b, 0, h]        = rot(q[b, 0, h])          h < Hq
//   k_cache[b, slot, h]   = rot(k[b, 0, h])          h < Hkv
//   v_cache[b, slot, h]   = v[b, 0, h]
// in fp32 from the inputs' type, rounded once to it.  This is exactly the
// PyTorch path it replaces (layers.apply_rope + write_seq): every product,
// sum and difference rounded on its own (the __f*_rn intrinsics, which nvcc
// never contracts into an FMA), the accurate cosf / sinf that torch.cos /
// torch.sin call (never __cosf / __sinf: the angles reach thousands of
// radians, where the fast intrinsics are off), and round-to-nearest-even to
// bf16.  `scale` is YaRN's cos / sin factor (1 for plain rope: a product by
// 1 is exact).
//
// Bound on the H100: bytes, and at decode sizes not even those: qwen2-moe's
// B 4 moves 2 x 48 KiB (q, k, v read; q_out and two cache rows written),
// ~0.03 us at 3.35 TB/s.  The launch itself (a few us) is the floor.  Design:
// grid (Hq + 2 Hkv, B), one block a (head row, sequence): rows below Hq
// rotate a q head, the next Hkv rotate a k head into the cache, the last Hkv
// copy a v head.  A thread takes pair i (and i + half), recomputing c_i and
// s_i per head: a few thousand cosf a call, nothing against the launch.
// Every tensor is addressed by its element strides, so the projections'
// outputs and any cache layout are read and written in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxHeadDim = 256;
constexpr int kErrArg = 1001;    // arguments the kernel does not take

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* k_cache;
  void* v_cache;
  void* q_out;              // [B, 1, Hq, D], contiguous
  const float* inv_freq;    // [D / 2]
  long long q_s[3];         // strides of b, h, d (elements)
  long long k_s[3];
  long long v_s[3];
  long long kc_s[4];        // strides of b, slot, h, d
  long long vc_s[4];
  int hq, hkv, d, pos, slot;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void rope_cache_kernel(const Params p) {
  const int row = blockIdx.x;
  const long long b = blockIdx.y;
  const int half = p.d / 2;
  if (row >= p.hq + p.hkv) {               // v: copied unchanged
    const int h = row - p.hq - p.hkv;
    const T* src = static_cast<const T*>(p.v) + b * p.v_s[0] + h * p.v_s[1];
    T* dst = static_cast<T*>(p.v_cache) + b * p.vc_s[0] + p.slot * p.vc_s[1] + h * p.vc_s[2];
    for (int j = threadIdx.x; j < p.d; j += blockDim.x) dst[j * p.vc_s[3]] = src[j * p.v_s[2]];
    return;
  }
  const T* src;
  T* dst;
  long long ss, ds;
  if (row < p.hq) {                        // q: into q_out
    src = static_cast<const T*>(p.q) + b * p.q_s[0] + row * p.q_s[1];
    dst = static_cast<T*>(p.q_out) + (b * p.hq + row) * p.d;
    ss = p.q_s[2];
    ds = 1;
  } else {                                 // k: into the cache's slot
    const int h = row - p.hq;
    src = static_cast<const T*>(p.k) + b * p.k_s[0] + h * p.k_s[1];
    dst = static_cast<T*>(p.k_cache) + b * p.kc_s[0] + p.slot * p.kc_s[1] + h * p.kc_s[2];
    ss = p.k_s[2];
    ds = p.kc_s[3];
  }
  const float fpos = static_cast<float>(p.pos);
  for (int i = threadIdx.x; i < half; i += blockDim.x) {
    const float ang = __fmul_rn(fpos, p.inv_freq[i]);
    const float c = __fmul_rn(cosf(ang), p.scale);
    const float s = __fmul_rn(sinf(ang), p.scale);
    const float x1 = to_f32(src[i * ss]);
    const float x2 = to_f32(src[(i + half) * ss]);
    dst[i * ds] = from_f32<T>(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
    dst[(i + half) * ds] = from_f32<T>(__fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s)));
  }
}

}  // namespace

// One launch on `stream` (see the note above): q_out [B, 1, Hq, D]
// (contiguous) from q, and k_cache / v_cache's rows at `slot` from k / v, in
// bf16 (bf16 = 1) or fp32.  Strides are in elements: q / k / v by (b, h, d),
// the caches by (b, slot, h, d).  Returns 0, kErrArg, or the launch's CUDA
// error.
extern "C" int rope_cache(const void* q, long long q_sb, long long q_sh, long long q_sd,
                          const void* k, long long k_sb, long long k_sh, long long k_sd,
                          const void* v, long long v_sb, long long v_sh, long long v_sd,
                          void* k_cache, long long kc_sb, long long kc_sl, long long kc_sh,
                          long long kc_sd, void* v_cache, long long vc_sb, long long vc_sl,
                          long long vc_sh, long long vc_sd, void* q_out, const void* inv_freq,
                          int b, int hq, int hkv, int d, int pos, int slot, float scale,
                          int bf16, void* stream) {
  if (b < 1 || b > 65535 || hq < 1 || hkv < 1 || d < 2 || d % 2 || d > kMaxHeadDim ||
      pos < 0 || slot < 0)
    return kErrArg;
  const Params p{q, k, v, k_cache, v_cache, q_out, static_cast<const float*>(inv_freq),
                 {q_sb, q_sh, q_sd}, {k_sb, k_sh, k_sd}, {v_sb, v_sh, v_sd},
                 {kc_sb, kc_sl, kc_sh, kc_sd}, {vc_sb, vc_sl, vc_sh, vc_sd},
                 hq, hkv, d, pos, slot, scale};
  const dim3 grid(hq + 2 * hkv, b);
  const int threads = ((d / 2 + 31) / 32) * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    rope_cache_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(p);
  else
    rope_cache_kernel<float><<<grid, threads, 0, s>>>(p);
  return (int)cudaGetLastError();
}
