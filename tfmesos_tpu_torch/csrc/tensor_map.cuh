// TMA tensor maps of bf16 [B, T, heads, D] operands, shared by
// flash_fwd.cu and flash_bwd.cu: libcuda's encoder, reached through the
// CUDA runtime without linking libcuda, and a cache of the last encoded
// maps.
//
// A map reads one (head, batch) at a time, in boxes of 64 columns (one
// 128-byte row of bf16) x `rows` rows, 128-byte swizzled, so a box lands
// in shared memory as the canonical SW128 tile that wgmma.cuh's
// descriptors read.  head_dim 128 loads as two such 64-column panels.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace tfm_tmap {

constexpr int PANEL = 64;            // bf16 columns of one 128-byte row

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up once through the CUDA
// runtime (the libraries are not linked against libcuda).
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// What a tensor map encodes: a bf16 [B, T, heads, D] operand at `base`
// (element strides sb, st, sh; unit stride on D), read in boxes of 64
// columns x `rows` rows of one (head, batch).
struct MapArgs {
  const void* base;
  long long sb, st, sh;
  int B, T, heads, D, rows;
  bool operator==(const MapArgs& o) const {
    return base == o.base && sb == o.sb && st == o.st && sh == o.sh &&
           B == o.B && T == o.T && heads == o.heads && D == o.D &&
           rows == o.rows;
  }
};

// The 4-D tensor map of `a`: 128-byte swizzle, zero fill out of bounds.
inline bool encode(CUtensorMap* map, const MapArgs& a) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)a.D, (cuuint64_t)a.heads,
                              (cuuint64_t)a.T, (cuuint64_t)a.B};
  const cuuint64_t strides[3] = {(cuuint64_t)a.sh * 2, (cuuint64_t)a.st * 2,
                                 (cuuint64_t)a.sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)PANEL, 1, (cuuint32_t)a.rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(a.base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A map is a pure function of its MapArgs, so the last MAPS encoded are
// kept and a call on the same buffers (PyTorch's caching allocator hands
// every layer of a step the same blocks) skips libcuda's encoder.
template <int MAPS>
bool encode_cached(CUtensorMap* map, const MapArgs& a) {
  static MapArgs keys[MAPS];
  static CUtensorMap maps[MAPS];
  static int filled = 0, next = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < filled; ++i) {
    if (keys[i] == a) {
      *map = maps[i];
      return true;
    }
  }
  if (!encode(map, a)) return false;
  keys[next] = a;
  maps[next] = *map;
  next = (next + 1) % MAPS;
  if (filled < MAPS) ++filled;
  return true;
}

}  // namespace tfm_tmap
