// Helpers shared by the Hopper flash-attention kernels (flash_prefill_sm90.cu
// and flash_decode_splitkv.cu): the attention contract's numerics (q
// pre-scaled by d**-0.5 and rounded to bf16, exp2-based online softmax) and
// the small PTX wrappers both use.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kLog2e = 1.4426950408889634f;

// The attention's layout: [B, S, H, D] given by element strides for batch,
// position and head; D is contiguous.
struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2**x by the SFU (ex2.approx): exact 0 for -inf, relative error ~2**-22.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x = lo, low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

// Eight bf16 of q -> round_to_bf16(q * scale), the TPU kernel's pre-scale.
__device__ __forceinline__ uint4 scale_round8(uint4 raw, float scale) {
  uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = unpack_bf16(w[i]);
    w[i] = pack_bf16(f.x * scale, f.y * scale);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

}  // namespace flash
