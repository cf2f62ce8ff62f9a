// Routed MoE for Hopper (sm_90a): the experts a call routes, and the shared
// expert, in two kernels -- gate / up, then down and combine.
//
// Replaces no Pallas kernel.  The JAX package's apply_moe
// (src/repro/models/layers.py) is plain jnp: it scatters every (token, k)
// pair into a capacity buffer [B, E, cap, d], runs all E experts densely
// over it, gathers the pairs back and adds the shared expert.  When no pair
// can be dropped (S * top_k <= cap: every decode step) that buffer is almost
// all zeros: at qwen2-moe-a2.7b's decode (B 4, 60 experts, top-4, cap 4) 16
// of its 960 rows hold a token, yet all 60 experts' weights are read.  This
// path reads only the experts some token chose, each once.
//
// Function.  Tokens t < T, each with top_k pairs (t, j): expert e_tj and
// gate g_tj (the router's renormalised top-k probabilities), and n_shared
// shared experts of width f (column blocks s*f of ws_gate / ws_up, row
// blocks of ws_down), all products in fp32 from the inputs' type:
//   h_tj = silu(x_t We_gate[e_tj]) * (x_t We_up[e_tj])            kernel 1
//   h_ts = silu(x_t Ws_gate_s) * (x_t Ws_up_s)
//   y_t  = sum_j g_tj h_tj We_down[e_tj] + sum_s h_ts Ws_down_s   kernel 2
// rounded once to x's type.  h is an fp32 workspace [T, top_k + n_shared, f].
// A token may name one expert in several of its pairs: each pair is summed
// with its own gate, as the plain version does.  The ids live on the card,
// so the host cannot check them without waiting for it: an id outside
// [0, E) is never used as an offset; its pair's block does nothing and the
// token's row of y is NaN.
//
// Bound on the H100 (3.35 TB/s HBM3): bytes.  At B 4 a layer of
// qwen2-moe-a2.7b multiplies each weight by at most 4 tokens, about 4 FLOP a
// byte against the tensor cores' 295.  The least the card can take is the
// bytes of the distinct routed experts (3 d f each), the shared experts'
// 3 d n_shared f, x, h written and read, and y: 0.346 GB at 16 distinct
// experts, 103 us a layer.  So the design streams each needed weight byte
// once, in 16-byte loads along the contiguous axis with several rows in
// flight a thread, over enough blocks to cover the 132 SMs.
//
// Design.  Kernel 1, grid (f / FT, T * top_k + n_shared), 256 threads: one
// block a (slot, FT-column tile).  A routed slot is a pair; its block works
// only if no earlier pair chose the same expert, and then for every pair
// that chose it, so an expert's tile is read once however many tokens chose
// it (a pass holds 4 tokens; more re-read the tile from L2).  A shared slot
// takes every token.  Warp 0 finds the tokens in the router's expert ids
// directly (ballots, in pair order): nothing is prepared on the host.  The
// tokens' x rows sit in shared memory in fp32; each thread streams 8 columns
// of both matrices (one 16-byte load of bf16 each) down a strided set of the
// d rows and keeps 2 x tokens x 8 fp32 sums; the row sets are summed by warp
// shuffles, then across warps in shared memory.
// Kernel 2, grid (T, d / 32), 256 threads: one block a (token, 32-column
// tile) walks the token's top_k + n_shared matrices as one run of rows (h
// [t] lies the same way), each thread 8 columns of a strided set of rows,
// 8 rows in flight, the gate folded into h; the row sets are reduced as in
// kernel 1 and y written once.  Tokens that share an expert (always the
// shared one) read its tile again, from L2 when their blocks run together,
// which blocks of one tile do: they are adjacent in the grid.  Measured on
// the H100, against the alternatives tried: 16 rows in flight ran no faster
// at qwen2-moe's and deepseek's B 4 and 29 % slower at jamba's (fewer
// blocks fit an SM); grouping the tokens by expert (each tile read once, a
// token's sums gathered across a cluster through distributed shared
// memory) took 94-238 us against 80 at qwen2-moe's, its blocks streaming
// rows more slowly; 64- and 256-column tiles left too few blocks.
// Every sum runs in a fixed order and nothing is atomic: a call is
// deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPassTok = 4;      // tokens one pass of kernel 1 holds
constexpr int kMaxTok = 1024;    // tokens a call may have
constexpr int kMaxK2 = 64;       // top_k + n_shared
constexpr int kErrArg = 1001;    // arguments the kernels do not take

// Eight consecutive elements as loaded: one 16-byte load of bf16, two of fp32.
template <typename T>
struct Raw8;
template <>
struct Raw8<__nv_bfloat16> {
  uint4 v;
};
template <>
struct Raw8<float> {
  float4 a, b;
};

__device__ __forceinline__ void load(Raw8<__nv_bfloat16>& r, const __nv_bfloat16* p) {
  r.v = __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ void load(Raw8<float>& r, const float* p) {
  r.a = __ldg(reinterpret_cast<const float4*>(p));
  r.b = __ldg(reinterpret_cast<const float4*>(p) + 1);
}
__device__ __forceinline__ void zero(Raw8<__nv_bfloat16>& r) { r.v = make_uint4(0, 0, 0, 0); }
__device__ __forceinline__ void zero(Raw8<float>& r) {
  r.a = make_float4(0.f, 0.f, 0.f, 0.f);
  r.b = r.a;
}
__device__ __forceinline__ void unpack(const Raw8<__nv_bfloat16>& r, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(const Raw8<float>& r, float (&v)[8]) {
  v[0] = r.a.x; v[1] = r.a.y; v[2] = r.a.z; v[3] = r.a.w;
  v[4] = r.b.x; v[5] = r.b.y; v[6] = r.b.z; v[7] = r.b.w;
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// Rows a thread keeps in flight: 4 x 16 bytes of bf16, 2 x 32 bytes of fp32.
template <typename T>
constexpr int kUnroll = sizeof(T) == 2 ? 4 : 2;

template <typename T>
struct UpParams {
  const T* x;             // [T, d]
  const int64_t* expert;  // [T * top_k], token-major
  const T* we_gate;       // [E, d, f]
  const T* we_up;         // [E, d, f]
  const T* ws_gate;       // [d, n_shared * f]
  const T* ws_up;         // [d, n_shared * f]
  float* h;               // [T, top_k + n_shared, f]
  int n_tok, top_k, n_shared, d, f, n_exp;
};

template <typename T>
struct DownParams {
  const float* h;         // [T, top_k + n_shared, f]
  const int64_t* expert;  // [T * top_k]
  const float* gates;     // [T * top_k]
  const T* we_down;       // [E, f, d]
  const T* ws_down;       // [n_shared * f, d]
  T* y;                   // [T, d]
  int n_tok, top_k, n_shared, d, f, n_exp;
};

// One pass of kernel 1 over m <= MT of the block's tokens: their x rows into
// shared memory, the tile's products, h for each.
template <typename T, int FT, int MT>
__device__ __forceinline__ void up_pass(const UpParams<T>& p, const T* wg, const T* wu,
                                        size_t ld, int col0, float* xs, const int* tok,
                                        const int* row, int m, float* red) {
  constexpr int CG = FT / 8;             // threads across the tile's columns
  constexpr int NRG = kThreads / CG;     // row sets
  constexpr int U = kUnroll<T>;
  const int tid = threadIdx.x, cg = tid % CG, rg = tid / CG;
  const int warp = tid / 32, lane = tid % 32;
  __syncthreads();                       // the last pass is done with xs and red
  for (int j = 0; j < MT; ++j) {
    const T* xr = p.x + (size_t)tok[j < m ? j : 0] * p.d;
    for (int r = tid; r < p.d; r += kThreads) xs[r * MT + j] = j < m ? to_f32(xr[r]) : 0.f;
  }
  __syncthreads();

  float ag[MT][8], au[MT][8];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int c = 0; c < 8; ++c) ag[j][c] = au[j][c] = 0.f;
  const size_t col = (size_t)col0 + cg * 8;
  for (int r0 = rg; r0 < p.d; r0 += NRG * U) {
    Raw8<T> rgw[U], ruw[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int r = r0 + i * NRG;
      if (r < p.d) {
        load(rgw[i], wg + (size_t)r * ld + col);
        load(ruw[i], wu + (size_t)r * ld + col);
      } else {
        zero(rgw[i]);
        zero(ruw[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int r = r0 + i * NRG;
      float g8[8], u8[8], xv[MT];
      unpack(rgw[i], g8);
      unpack(ruw[i], u8);
#pragma unroll
      for (int j = 0; j < MT; ++j) xv[j] = r < p.d ? xs[r * MT + j] : 0.f;
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          ag[j][c] = fmaf(xv[j], g8[c], ag[j][c]);
          au[j][c] = fmaf(xv[j], u8[c], au[j][c]);
        }
    }
  }

  // Row sets: the lanes of a warp that share columns, then the warps.
#pragma unroll
  for (int off = CG; off < 32; off <<= 1)
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        ag[j][c] += __shfl_xor_sync(0xffffffffu, ag[j][c], off);
        au[j][c] += __shfl_xor_sync(0xffffffffu, au[j][c], off);
      }
  if (lane < CG) {
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        red[((warp * MT + j) * 2 + 0) * FT + cg * 8 + c] = ag[j][c];
        red[((warp * MT + j) * 2 + 1) * FT + cg * 8 + c] = au[j][c];
      }
  }
  __syncthreads();
  for (int i = tid; i < m * FT; i += kThreads) {
    const int j = i / FT, cc = i % FT;
    float g = 0.f, u = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      g += red[((w * MT + j) * 2 + 0) * FT + cc];
      u += red[((w * MT + j) * 2 + 1) * FT + cc];
    }
    p.h[(size_t)row[j] * p.f + col0 + cc] = g / (1.f + expf(-g)) * u;
  }
}

template <typename T, int FT>
__global__ void __launch_bounds__(kThreads, 2) moe_up_kernel(UpParams<T> p) {
  // [d][pass tokens] fp32, then the tok / row lists, a pair each: an expert
  // named twice by one token holds two entries.
  extern __shared__ float xs[];
  const int n_pairs = p.n_tok * p.top_k, k2 = p.top_k + p.n_shared;
  int* s_tok = reinterpret_cast<int*>(xs + (size_t)p.d * kPassTok);
  int* s_row = s_tok + n_pairs;
  __shared__ float red[kWarps * kPassTok * 2 * FT];
  __shared__ int s_n;

  const int slot = blockIdx.y, col0 = blockIdx.x * FT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* wg;
  const T* wu;
  size_t ld;
  if (slot < n_pairs) {
    const int64_t e = p.expert[slot];
    if (e < 0 || e >= p.n_exp) return;  // the same for the whole block; y is NaN
    if (warp == 0) {
      bool earlier = false;
      for (int q = lane; q < slot; q += 32) earlier |= p.expert[q] == e;
      int n = 0;
      if (!__any_sync(0xffffffffu, earlier)) {   // this pair leads its expert
        for (int q0 = slot; q0 < n_pairs; q0 += 32) {
          const int q = q0 + lane;
          const bool hit = q < n_pairs && p.expert[q] == e;
          const unsigned mask = __ballot_sync(0xffffffffu, hit);
          if (hit) {
            const int at = n + __popc(mask & ((1u << lane) - 1u));
            s_tok[at] = q / p.top_k;
            s_row[at] = (q / p.top_k) * k2 + q % p.top_k;
          }
          n += __popc(mask);
        }
      }
      if (lane == 0) s_n = n;
    }
    wg = p.we_gate + (size_t)e * p.d * p.f;
    wu = p.we_up + (size_t)e * p.d * p.f;
    ld = p.f;
  } else {
    const int s = slot - n_pairs;
    for (int t = threadIdx.x; t < p.n_tok; t += kThreads) {
      s_tok[t] = t;
      s_row[t] = t * k2 + p.top_k + s;
    }
    if (threadIdx.x == 0) s_n = p.n_tok;
    wg = p.ws_gate + (size_t)s * p.f;
    wu = p.ws_up + (size_t)s * p.f;
    ld = (size_t)p.n_shared * p.f;
  }
  __syncthreads();
  const int n = s_n;
  for (int c = 0; c < n; c += kPassTok) {
    const int m = min(kPassTok, n - c);
    if (m == 1)
      up_pass<T, FT, 1>(p, wg, wu, ld, col0, xs, s_tok + c, s_row + c, m, red);
    else if (m == 2)
      up_pass<T, FT, 2>(p, wg, wu, ld, col0, xs, s_tok + c, s_row + c, m, red);
    else
      up_pass<T, FT, 4>(p, wg, wu, ld, col0, xs, s_tok + c, s_row + c, m, red);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) moe_down_kernel(DownParams<T> p) {
  constexpr int DT = 32, CG = DT / 8, NRG = kThreads / CG, U = 2 * kUnroll<T>;
  __shared__ float red[kWarps * DT];
  __shared__ const T* s_w[kMaxK2];       // each matrix's column tile
  __shared__ float s_gate[kMaxK2];
  const int t = blockIdx.x, col0 = blockIdx.y * DT;
  const int tid = threadIdx.x, cg = tid % CG, rg = tid / CG;
  const int warp = tid / 32, lane = tid % 32;
  const int k2 = p.top_k + p.n_shared;
  int bad = 0;
  for (int j = tid; j < k2; j += kThreads) {
    if (j < p.top_k) {
      const int q = t * p.top_k + j;
      const int64_t e = p.expert[q];
      bad |= e < 0 || e >= p.n_exp;
      s_w[j] = p.we_down + (size_t)(bad ? 0 : e) * p.f * p.d + col0;
      s_gate[j] = p.gates[q];
    } else {
      s_w[j] = p.ws_down + (size_t)(j - p.top_k) * p.f * p.d + col0;
      s_gate[j] = 1.f;
    }
  }
  if (__syncthreads_or(bad)) {           // an id outside [0, E): nothing read
    if (tid < DT) store(p.y + (size_t)t * p.d + col0 + tid, __int_as_float(0x7fc00000));
    return;
  }

  // The token's k2 matrices as one run of k2 * f rows, row i of matrix j at
  // j * f + i: h [t] is laid out the same way, so U rows of any matrices are
  // in flight at once.
  const float* hr = p.h + (size_t)t * k2 * p.f;
  const int rows = k2 * p.f;
  float acc[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) acc[c] = 0.f;
  for (int i0 = rg; i0 < rows; i0 += NRG * U) {
    Raw8<T> raw[U];
    float hv[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int idx = i0 + i * NRG;
      if (idx < rows) {
        const int j = idx / p.f;
        load(raw[i], s_w[j] + (size_t)(idx - j * p.f) * p.d + cg * 8);
        hv[i] = s_gate[j] * __ldg(hr + idx);
      } else {
        zero(raw[i]);
        hv[i] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      float v[8];
      unpack(raw[i], v);
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[c] = fmaf(hv[i], v[c], acc[c]);
    }
  }
#pragma unroll
  for (int off = CG; off < 32; off <<= 1)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
  if (lane < CG) {
#pragma unroll
    for (int c = 0; c < 8; ++c) red[warp * DT + cg * 8 + c] = acc[c];
  }
  __syncthreads();
  if (tid < DT) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * DT + tid];
    store(p.y + (size_t)t * p.d + col0 + tid, s);
  }
}

template <typename T, int FT>
int launch_up(const UpParams<T>& p, cudaStream_t stream) {
  // Dynamic shared memory beside the static reduction buffer: past 48 KB
  // together only by the attribute, so it is set on every launch.
  const size_t smem =
      (size_t)p.d * kPassTok * sizeof(float) + 2 * (size_t)p.n_tok * p.top_k * sizeof(int);
  const cudaError_t e = cudaFuncSetAttribute(
      moe_up_kernel<T, FT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(p.f / FT, p.n_tok * p.top_k + p.n_shared);
  moe_up_kernel<T, FT><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_down(const DownParams<T>& p, cudaStream_t stream) {
  const dim3 grid(p.n_tok, p.d / 32);
  moe_down_kernel<T><<<grid, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// The shapes both kernels take: 1..1024 tokens, widths in whole tiles, x's
// rows and the pair lists within shared memory, the grids within their
// limits.
bool shapes_ok(int n_tok, int top_k, int n_shared, int d, int f, int n_exp) {
  return n_tok >= 1 && n_tok <= kMaxTok && top_k >= 1 && n_shared >= 0 && d >= 8 &&
         f >= 8 && d % 8 == 0 && f % 8 == 0 && n_exp >= 1 &&
         (size_t)d * kPassTok * 4 + 8 * (size_t)n_tok * top_k <= 160 * 1024 &&
         top_k + n_shared <= kMaxK2 && (long long)n_tok * top_k + n_shared <= 65535 &&
         (long long)(top_k + n_shared) * f < (1LL << 31);
}

template <typename T>
int run(const void* x, const void* expert, const void* gates, const void* we_gate,
        const void* we_up, const void* we_down, const void* ws_gate, const void* ws_up,
        const void* ws_down, void* h, void* y, int n_tok, int top_k, int n_shared, int d,
        int f, int n_exp, int tile, cudaStream_t s) {
  const UpParams<T> up{static_cast<const T*>(x), static_cast<const int64_t*>(expert),
                       static_cast<const T*>(we_gate), static_cast<const T*>(we_up),
                       static_cast<const T*>(ws_gate), static_cast<const T*>(ws_up),
                       static_cast<float*>(h), n_tok, top_k, n_shared, d, f, n_exp};
  const int e = tile == 64 ? launch_up<T, 64>(up, s) : launch_up<T, 32>(up, s);
  if (e != 0) return e;
  const DownParams<T> down{static_cast<const float*>(h), static_cast<const int64_t*>(expert),
                           static_cast<const float*>(gates), static_cast<const T*>(we_down),
                           static_cast<const T*>(ws_down), static_cast<T*>(y),
                           n_tok, top_k, n_shared, d, f, n_exp};
  return launch_down<T>(down, s);
}

}  // namespace

// Both kernels on `stream`: h [T, top_k + n_shared, f] (fp32 workspace) from
// x [T, d], the pairs' experts [T * top_k] (int64) and the gate / up weights
// at column tile `tile` (32 or 64, dividing f); then y [T, d] in x's type from
// h, the experts, the gates [T * top_k] (fp32) and the down weights (d a
// multiple of 32), for E = n_exp routed experts.  The shared weights are
// null without a shared expert.
// Returns 0, kErrArg, or the CUDA error of the launch that failed.
extern "C" int moe_decode(const void* x, const void* expert, const void* gates,
                          const void* we_gate, const void* we_up, const void* we_down,
                          const void* ws_gate, const void* ws_up, const void* ws_down, void* h,
                          void* y, int n_tok, int top_k, int n_shared, int d, int f,
                          int n_exp, int bf16, int tile, void* stream) {
  if (!shapes_ok(n_tok, top_k, n_shared, d, f, n_exp) || (tile != 32 && tile != 64) || f % tile ||
      d % 32 || (n_shared && (!ws_gate || !ws_up || !ws_down)))
    return kErrArg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? run<__nv_bfloat16>(x, expert, gates, we_gate, we_up, we_down, ws_gate, ws_up,
                                   ws_down, h, y, n_tok, top_k, n_shared, d, f, n_exp, tile, s)
              : run<float>(x, expert, gates, we_gate, we_up, we_down, ws_gate, ws_up, ws_down,
                           h, y, n_tok, top_k, n_shared, d, f, n_exp, tile, s);
}
