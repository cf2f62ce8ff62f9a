// MLA decode for Hopper (sm_90a): one query token a sequence, all heads
// scored in latent space against the latent cache, split over the keys,
// then the splits merged -- two kernels.
//
// Replaces the absorbed decode of the JAX package's apply_mla
// (src/repro/models/layers.py), which is plain jnp: per step and layer it
// converts the whole max_len latent cache to fp32, scores every slot, masks
// those past pos and softmaxes them.  No flash route takes this form: the
// keys are one latent row a token, shared by every head.
//
// Function.  A sequence b has H <= 16 heads, each with a query row
// q_h = [q_lat_h ; q_rope_h] (R = 512 latent columns, then Dr = 64 rope
// columns), and kv_len cache rows k_t = [ckv_t ; krope_t].  For each head
//   s_ht = scale * (q_h . k_t),   p_ht = softmax_t(s_ht),
//   o_h  = sum_{t < kv_len} p_ht ckv_t                      [R]
// the products in fp32 from bf16 inputs, the softmax in fp32 (online, in
// the log2 domain), p rounded to bf16 before p . ckv (as the tensor cores
// take it), o rounded once to bf16.  The caller then takes o_h . w_uv and
// wo.
//
// Bound on the H100 (3.35 TB/s HBM3): bytes.  Each cache row (576 bf16,
// 1,152 bytes) serves all 16 heads: 16 x (576 + 512) x 2 = 34.8 kFLOP a
// row, 30 FLOP a byte against the tensor cores' 295.  The least time is
// the rows up to kv_len, q and o over the HBM rate: at B 4 and kv_len
// 16,447, 75.8 MB and 22.6 us a layer.  Scalar fp32 at 30 FLOP a byte
// would be bound by the 67 TFLOP/s of the CUDA cores near the memory
// bound, so the products run on the tensor cores (mma.sync m16n8k16).
//
// Design.  Kernel 1, grid (n_split, B), 256 threads (8 warps), one block an
// SM (207 KB of shared memory), one wave: a block streams one split -- a
// run of whole 32-key tiles -- of one sequence's rows into shared memory
// once, for all heads, by cp.async (16 bytes a thread; five stages, four
// tiles in flight while one is used; rows padded to 584 bf16 so that
// fragment loads meet no bank conflict; rows past kv_len zero-filled).  The
// 16 heads are the M = 16 rows of the mma; rows past H are zero.  Each warp
// holds its part of the queries as mma fragments in registers for the whole
// split (72 registers).  Per tile, warp w scores keys 8 (w % 4) .. + 7 over
// half the 576 columns (w / 4), 18 mma on two accumulators, the keys' B
// fragments by ldmatrix; the halves meet in shared memory, where 16 threads
// a head take the online softmax (the running maximum and sum a head in
// shared memory) and write p as bf16; each warp then rescales its fp32
// accumulators and adds p . ckv for latent columns 64w..64w+63 (8 mma, the
// V fragments by ldmatrix.trans from the same tile).  A split writes o / l
// in fp32 and its log2-sum-exp.  Kernel 2, grid (H, B, 4), 128 threads:
// one column a thread, its values of every split loaded at once, merged by
// the splits' log2-sum-exp (the weights staged in shared memory), o
// written in bf16.  Every sum runs in a fixed order: a call is
// deterministic.
//
// Measured on the H100 at B 4, kv_len 16,447 (device time, the split
// kernel alone): 45 us with the queries re-read from shared memory every
// tile and four warps scoring, 42 with all eight, 37.5 with the queries in
// registers and ldmatrix for the keys; 31-32 with the arithmetic left out,
// against torch's own sum over the same 75.8 MB in 29.9 us.  Shared
// memory's bandwidth, not the mma, bounded the arithmetic.  Per-row bulk
// copies (the TMA engine, 64 a tile) in place of cp.async ran 60 us; a
// fifth stage over four changed nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 512;                // latent columns
constexpr int kDr = 64;                // rope columns
constexpr int kC = kR + kDr;           // a cache row
constexpr int kLd = kC + 8;            // its row in shared memory (bf16)
constexpr int kHeads = 16;             // mma rows
constexpr int kTile = 32;              // keys a tile
constexpr int kStages = 5;             // tiles in shared memory (4 in flight)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKeyWarps = kTile / 8;   // warps along the keys, 8 keys each
constexpr int kColParts = kWarps / kKeyWarps;  // column parts of a score
constexpr int kPld = kTile + 8;        // a row of p in shared memory (bf16)
constexpr int kSld = kTile + 4;        // a row of partial scores (fp32)
constexpr int kChunks = kC / 8;        // 16-byte chunks a row
constexpr int kErrArg = 1001;          // arguments the kernels do not take
constexpr int kCombineThreads = 128;
constexpr size_t kSmem = (size_t)(kHeads * kLd + kStages * kTile * kLd + kHeads * kPld) * 2 +
                         (size_t)(kColParts * kHeads * kSld + 3 * kHeads) * 4;
constexpr int kMaxSplit = 1024;        // splits the merge kernel takes
constexpr int kRegSplit = 48;          // splits it loads at once

struct Params {
  const __nv_bfloat16* q_lat;   // [B, H, R] at strides (qlat_sb, qlat_sh)
  const __nv_bfloat16* q_rope;  // [B, H, Dr] at strides (qr_sb, qr_sh)
  const __nv_bfloat16* ckv;     // [B, T, R] at strides (ckv_sb, ckv_st)
  const __nv_bfloat16* krope;   // [B, T, Dr] at strides (kr_sb, kr_st)
  float* o_part;                // [B, n_split, H, R]
  float* lse;                   // [B, n_split, H] (log2)
  __nv_bfloat16* out;           // [B, H, R]
  long long qlat_sb, qlat_sh, qr_sb, qr_sh, ckv_sb, ckv_st, kr_sb, kr_st;
  int heads, kv_len, n_split, tiles_per_split;
  float scale_log2;             // softmax scale times log2(e)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  // src-size 0 fills the 16 bytes with zeros (rows past kv_len).
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One tile of kTile rows (keys key0 ..) of sequence b into the stage ks,
// 16 bytes a thread at a time; rows past kv_len zero-filled.
__device__ __forceinline__ void load_tile(const Params& p, __nv_bfloat16* ks, int b,
                                          int key0, int tid) {
  const __nv_bfloat16* ckv = p.ckv + (long long)b * p.ckv_sb;
  const __nv_bfloat16* kr = p.krope + (long long)b * p.kr_sb;
  for (int i = tid; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i - r * kChunks;
    const int key = key0 + r;
    const bool valid = key < p.kv_len;
    const int k = valid ? key : 0;
    const __nv_bfloat16* src = c < kR / 8 ? ckv + (long long)k * p.ckv_st + c * 8
                                          : kr + (long long)k * p.kr_st + (c - kR / 8) * 8;
    cp_async16(ks + r * kLd + c * 8, src, valid);
  }
}

__global__ void __launch_bounds__(kThreads, 1) mla_decode_split_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + kHeads * kLd;              // kStages tiles
  __nv_bfloat16* ps = ks + kStages * kTile * kLd;
  float* sp = reinterpret_cast<float*>(ps + kHeads * kPld);  // [kColParts][16][kSld]
  float* m_s = sp + kColParts * kHeads * kSld;        // running max a head
  float* l_s = m_s + kHeads;                          // running sum a head
  float* a_s = l_s + kHeads;                          // this tile's rescale

  const int split = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int tile0 = split * p.tiles_per_split;
  const int n_tiles_all = (p.kv_len + kTile - 1) / kTile;
  const int n_tiles = min(p.tiles_per_split, n_tiles_all - tile0);

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_tile(p, ks + st * kTile * kLd, b, (tile0 + st) * kTile, tid);
    cp_commit();
  }
  // The heads' query rows, rows past H zero.
  for (int i = tid; i < kHeads * kChunks; i += kThreads) {
    const int h = i / kChunks, c = i - h * kChunks;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (h < p.heads) {
      const __nv_bfloat16* src =
          c < kR / 8 ? p.q_lat + b * p.qlat_sb + h * p.qlat_sh + c * 8
                     : p.q_rope + b * p.qr_sb + h * p.qr_sh + (c - kR / 8) * 8;
      v = *reinterpret_cast<const uint4*>(src);
    }
    *reinterpret_cast<uint4*>(qs + h * kLd + c * 8) = v;
  }
  if (tid < kHeads) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  // This warp's part of the queries as mma fragments, held in registers for
  // every tile: read from shared memory once, not once a tile.
  const int kw = warp % kKeyWarps, part = warp / kKeyWarps;
  const int col0 = part * (kC / kColParts);
  constexpr int kSteps = kC / kColParts / 16;
  uint32_t qa[kSteps][4];
  {
    const __nv_bfloat16* q0 = qs + g * kLd + col0 + 2 * t4;
    const __nv_bfloat16* q8 = q0 + 8 * kLd;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      qa[kk][0] = ld32(q0 + kk * 16);
      qa[kk][1] = ld32(q8 + kk * 16);
      qa[kk][2] = ld32(q0 + kk * 16 + 8);
      qa[kk][3] = ld32(q8 + kk * 16 + 8);
    }
  }

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // The softmax's layout: 16 threads a head, two keys each.
  const int srow = tid / 16, skey = (tid % 16) * 2;

  for (int it = 0; it < n_tiles; ++it) {
    cp_wait<kStages - 2>();
    __syncthreads();
    // Every thread has passed iteration it - 1: its stage can be refilled.
    const int ahead = it + kStages - 1;
    if (ahead < n_tiles)
      load_tile(p, ks + (ahead % kStages) * kTile * kLd, b, (tile0 + ahead) * kTile, tid);
    cp_commit();
    const __nv_bfloat16* kt = ks + (it % kStages) * kTile * kLd;
    const int key0 = (tile0 + it) * kTile;

    // Partial scores: warp w, keys 8 (w % 4) .. + 7, columns of part w / 4
    // (kC / kColParts of them), on two accumulators.
    {
      float s[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
      // Lane l addresses key 8 (w % 4) + l % 8 at column 8 (l / 8) of a
      // 32-column run: the B fragments of two k-steps.
      const __nv_bfloat16* krow = kt + (kw * 8 + (lane & 7)) * kLd + col0 + (lane >> 3) * 8;
#pragma unroll
      for (int kk = 0; kk < kSteps; kk += 2) {
        uint32_t bf[4];
        ldmatrix_x4(bf, krow + kk * 16);
        mma16816(s, qa[kk], bf[0], bf[1]);
        mma16816(s2, qa[kk + 1], bf[2], bf[3]);
      }
      float* dst = sp + part * kHeads * kSld + kw * 8 + 2 * t4;
      *reinterpret_cast<float2*>(dst + g * kSld) = make_float2(s[0] + s2[0], s[1] + s2[1]);
      *reinterpret_cast<float2*>(dst + (g + 8) * kSld) =
          make_float2(s[2] + s2[2], s[3] + s2[3]);
    }
    __syncthreads();
    // The online softmax of head srow over this tile: its 16 threads.
    {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = 0.f;
#pragma unroll
        for (int q = 0; q < kColParts; ++q) x += sp[(q * kHeads + srow) * kSld + skey + e];
        v[e] = key0 + skey + e < p.kv_len ? x * p.scale_log2 : -INFINITY;
      }
      float mx = fmaxf(v[0], v[1]);
#pragma unroll
      for (int o = 8; o > 0; o /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[srow];
      const float m_new = fmaxf(m_old, mx);   // finite: a tile has a live key
      const __nv_bfloat162 pv =
          __floats2bfloat162_rn(exp2f(v[0] - m_new), exp2f(v[1] - m_new));
      *reinterpret_cast<__nv_bfloat162*>(ps + srow * kPld + skey) = pv;
      const float2 pf = __bfloat1622float2(pv);
      float sum = pf.x + pf.y;
#pragma unroll
      for (int o = 8; o > 0; o /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (skey == 0) {
        const float alpha = exp2f(m_old - m_new);
        a_s[srow] = alpha;
        l_s[srow] = l_s[srow] * alpha + sum;
        m_s[srow] = m_new;
      }
    }
    __syncthreads();
    // o += p . ckv over latent columns 64 warp .. 64 warp + 63, the
    // accumulators first rescaled to the new maximum.
    {
      const float al = a_s[g], ah = a_s[g + 8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][0] *= al;
        acc[j][1] *= al;
        acc[j][2] *= ah;
        acc[j][3] *= ah;
      }
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        const int c0 = kk * 16 + 2 * t4;
        uint32_t a[4];
        a[0] = ld32(ps + g * kPld + c0);
        a[1] = ld32(ps + (g + 8) * kPld + c0);
        a[2] = ld32(ps + g * kPld + c0 + 8);
        a[3] = ld32(ps + (g + 8) * kPld + c0 + 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, kt + (kk * 16 + (lane & 15)) * kLd + warp * 64 + j * 16 +
                                    (lane >> 4) * 8);
          mma16816(acc[2 * j], a, bf[0], bf[1]);
          mma16816(acc[2 * j + 1], a, bf[2], bf[3]);
        }
      }
    }
  }
  float l_run[2] = {l_s[g], l_s[g + 8]}, m_run[2] = {m_s[g], m_s[g + 8]};

  // o / l and the log2-sum-exp of this split, heads below H.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int h = g + 8 * r;
    if (h >= p.heads) continue;
    const float inv = l_run[r] > 0.f ? 1.f / l_run[r] : 0.f;
    float* dst = p.o_part + (((long long)b * p.n_split + split) * p.heads + h) * kR +
                 warp * 64 + 2 * t4;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(dst + j * 8) =
          make_float2(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
    if (warp == 0 && t4 == 0)
      p.lse[((long long)b * p.n_split + split) * p.heads + h] =
          l_run[r] > 0.f ? m_run[r] + log2f(l_run[r]) : -INFINITY;
  }
}

// One (head, sequence, 128-column part): each thread loads its column of
// the first kRegSplit splits at once (one round trip to L2, beside the
// log2-sum-exps), then weighs them by the splits' log2-sum-exp.
__global__ void __launch_bounds__(kCombineThreads) mla_decode_combine_kernel(Params p) {
  __shared__ float w[kMaxSplit];
  __shared__ float red[kCombineThreads / 32];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int col = blockIdx.z * kCombineThreads + tid;
  const int n = p.n_split;
  const float* part = p.o_part + ((long long)b * n * p.heads + h) * kR + col;
  const long long step = (long long)p.heads * kR;
  float v[kRegSplit];
#pragma unroll
  for (int s = 0; s < kRegSplit; ++s) v[s] = s < n ? part[s * step] : 0.f;
  const float* lse = p.lse + (long long)b * n * p.heads + h;
  float top = -INFINITY;
  for (int s = tid; s < n; s += kCombineThreads) {
    const float x = lse[(long long)s * p.heads];
    w[s] = x;
    top = fmaxf(top, x);
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, o));
  if (tid % 32 == 0) red[tid / 32] = top;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kCombineThreads / 32; ++i) top = fmaxf(top, red[i]);
  for (int s = tid; s < n; s += kCombineThreads)
    w[s] = w[s] == -INFINITY ? 0.f : exp2f(w[s] - top);
  __syncthreads();
  float o = 0.f, wsum = 0.f;
#pragma unroll
  for (int s = 0; s < kRegSplit; ++s) {
    const float ws = s < n ? w[s] : 0.f;
    o += ws * v[s];
    wsum += ws;
  }
  for (int s = kRegSplit; s < n; ++s) {
    o += w[s] * part[s * step];
    wsum += w[s];
  }
  p.out[((long long)b * p.heads + h) * kR + col] = __float2bfloat16_rn(o / wsum);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

extern "C" {

// Both kernels on the stream; 0, a cudaError_t, or kErrArg for arguments
// the kernels do not take (strides in elements; every row 16-byte aligned).
int mla_decode(const void* q_lat, long long qlat_sb, long long qlat_sh, const void* q_rope,
               long long qr_sb, long long qr_sh, const void* ckv, long long ckv_sb,
               long long ckv_st, const void* krope, long long kr_sb, long long kr_st,
               void* o_part, void* lse, void* out, int batch, int heads, int kv_len,
               int n_split, int tiles_per_split, float scale, cudaStream_t stream) {
  const int n_tiles = (kv_len + kTile - 1) / kTile;
  if (batch < 1 || batch > 65535 || heads < 1 || heads > kHeads || kv_len < 1 ||
      n_split < 1 || n_split > kMaxSplit || tiles_per_split < 1 ||
      (long long)n_split * tiles_per_split < n_tiles ||
      (long long)(n_split - 1) * tiles_per_split >= n_tiles || !aligned16(q_lat) ||
      !aligned16(q_rope) || !aligned16(ckv) || !aligned16(krope) || !aligned16(o_part) ||
      !aligned16(out) || qlat_sb % 8 || qlat_sh % 8 || qr_sb % 8 || qr_sh % 8 || ckv_sb % 8 ||
      ckv_st % 8 || kr_sb % 8 || kr_st % 8)
    return kErrArg;
  Params p{static_cast<const __nv_bfloat16*>(q_lat),
           static_cast<const __nv_bfloat16*>(q_rope),
           static_cast<const __nv_bfloat16*>(ckv),
           static_cast<const __nv_bfloat16*>(krope),
           static_cast<float*>(o_part),
           static_cast<float*>(lse),
           static_cast<__nv_bfloat16*>(out),
           qlat_sb, qlat_sh, qr_sb, qr_sh, ckv_sb, ckv_st, kr_sb, kr_st,
           heads, kv_len, n_split, tiles_per_split,
           scale * 1.4426950408889634f};
  const cudaError_t e = cudaFuncSetAttribute(
      mla_decode_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  mla_decode_split_kernel<<<dim3(n_split, batch), kThreads, kSmem, stream>>>(p);
  cudaError_t l = cudaGetLastError();
  if (l != cudaSuccess) return (int)l;
  mla_decode_combine_kernel<<<dim3(heads, batch, kR / kCombineThreads), kCombineThreads, 0,
                              stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
