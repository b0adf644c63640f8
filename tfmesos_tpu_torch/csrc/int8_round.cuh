// The int8 rounding rule of the port, shared by quant_int8.cu (every
// int8 weight leaf and KV-cache write) and flash_decode_paged.cu (the
// deferred self chunk over an int8 pool, rounded as a committed slot
// holds it): one rule, not two copies.
//
// A row (a weight row, or one (row, token, kv head) slot of head_dim
// elements) whose largest magnitude is `absmax` has the scale absmax /
// 127, a true IEEE division (the build never passes -use_fast_math), and
// an all-zero row the scale 1.  An element x becomes
// clip(rint(x / scale [+ dither]), -127, 127): a true division, rounded
// half to even.  The JAX package's quantize_int8_reference computes the
// same bits.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace tfm_int8 {

__device__ __forceinline__ float absmax_scale(float absmax) {
  return absmax == 0.f ? 1.f : absmax / 127.f;
}

// The int8 value of a step count s = x / scale [+ dither], as a float.
__device__ __forceinline__ float round_step(float s) {
  return fminf(fmaxf(rintf(s), -127.f), 127.f);
}

}  // namespace tfm_int8
