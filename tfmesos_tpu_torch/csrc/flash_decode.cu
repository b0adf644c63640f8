// Decode attention over a linear KV cache for Hopper (sm_90a): bf16 or
// float32 caches, or int8 caches with per-position float32 scales;
// float32 accumulation.
//
// Replaces: tfmesos_tpu/ops/attention.py, _flash_decode_kernel (called
// through flash_decode) — the TPU kernel behind every generate() step
// after the prompt prefill.
//
// What it computes: for each row b and each of its t chunk tokens,
// attention of q [B, t, H, D] over that row's cache in the stacked
// buffer [L, B, KV, M, D] (layer `layer`, read in place), which already
// holds the chunk (the linear cache is written before it is attended):
// token tt sees positions <= pos[b] + tt, with ragged per-row pos.  GQA:
// the G = H / KV query heads of a kv head share its cache.  int8 caches
// carry lane-major scales [L, B, KV, 1, M]; the k-scale folds into the
// score after the dot and the v-scale into the probability before P.V
// (decode_common.cuh, shared with the paged kernel), so the cache is
// read at int8 width and never dequantized in device memory.
//
// What bounds it on this card: bytes.  A t = 1 step does ~4 FLOPs per
// cache element it reads, far below the ~295 FLOP/byte balance point:
// the least time is the live positions' K and V (and scales) over
// 3.35 TB/s.
//
// What this design does about it: reads only the live blocks (the
// per-row bound pos + t - 1 is computed here), never the dead tail of
// the buffer, and never slices a layer out of the stack.  One CTA per
// (kv head, row, tile of up to 16 query rows), so a chunk of any length
// runs (long chunks tile their t * G rows over CTAs); each CTA stages
// 64-position blocks of K and V in shared memory with coalesced loads
// and runs a guarded float32 online softmax.  This first version is
// simple and right: the block loop is sequential in one CTA, so a long
// context is latency-bound.  Splitting it across CTAs (flash-decoding)
// and async copies are later work; PERF.md records the distance to the
// bound.

#include "decode_common.cuh"

namespace {

using namespace tfm_decode;

constexpr int BLOCK_KEYS = 64;

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kc,
              const TKV* __restrict__ vc, const float* __restrict__ ksc,
              const float* __restrict__ vsc, const int* __restrict__ pos,
              TQ* __restrict__ out, int B, int t, int H, int KV, int M,
              int D, int layer, float scale) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  const int r0 = blockIdx.z * ROW_TILE;
  const int R = min(ROW_TILE, t * G - r0);
  const int rt = min(ROW_TILE, t * G);
  const Smem sm(smem, rt, BLOCK_KEYS, D);
  load_rows(q, sm, b, t, H, G, kvh, r0, R, D);
  const int p0 = pos[b];
  for (int r = threadIdx.x; r < R; r += THREADS)
    sm.lim[r] = p0 + (r0 + r) / G;     // token tt sees positions <= pos+tt
  // Live blocks of this tile: up to its last token's bound, within M.
  const int last = p0 + (r0 + R - 1) / G;
  const int nb = last < 0 ? 0
                          : min(last / BLOCK_KEYS + 1,
                                (M + BLOCK_KEYS - 1) / BLOCK_KEYS);
  const long long head = ((long long)layer * B + b) * KV + kvh;
  const TKV* kb = kc + head * M * D;
  const TKV* vb = vc + head * M * D;
  const float* ksb = ksc == nullptr ? nullptr : ksc + head * M;
  const float* vsb = vsc == nullptr ? nullptr : vsc + head * M;
  __syncthreads();

  for (int j = 0; j < nb; ++j) {
    const int k0 = j * BLOCK_KEYS;
    const int n = min(BLOCK_KEYS, M - k0);
    stage(kb + (long long)k0 * D, vb + (long long)k0 * D, D,
          ksb == nullptr ? nullptr : ksb + k0,
          vsb == nullptr ? nullptr : vsb + k0, sm, n, D);
    score_tile(sm, ksb != nullptr, k0, R, n, D, scale);
    accumulate<TKV>(sm, R, n, D);
  }
  store_rows(out, sm, b, t, H, G, kvh, r0, R, D);
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* kc, const void* vc, const void* ksc,
           const void* vsc, const void* pos, void* out, int B, int t, int H,
           int KV, int M, int D, int layer, float scale, cudaStream_t s) {
  const int rows = t * (H / KV);
  const long long smem =
      smem_bytes(rows < ROW_TILE ? rows : ROW_TILE, BLOCK_KEYS, D);
  if (smem > 232448) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<TQ, TKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(KV, B, (rows + ROW_TILE - 1) / ROW_TILE);
  decode_kernel<TQ, TKV><<<grid, THREADS, smem, s>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kc),
      static_cast<const TKV*>(vc), static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<const int*>(pos),
      static_cast<TQ*>(out), B, t, H, KV, M, D, layer, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* tfm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory (bytes) one CTA needs for these sizes.
extern "C" long long tfm_flash_decode_smem(int t, int H, int KV, int D) {
  const int rows = t * (H / KV);
  return smem_bytes(rows < ROW_TILE ? rows : ROW_TILE, BLOCK_KEYS, D);
}

// q: contiguous [B, t, H, D]; kc/vc: contiguous [L, B, KV, M, D] (int8
// when kv_int8, else q's type); ksc/vsc: contiguous float32
// [L, B, KV, 1, M] when kv_int8, else null; pos: int32 [B]; out:
// contiguous [B, t, H, D] of q's type (bf16 when is_bf16, else float32).
// Returns cudaGetLastError() after the launch.
extern "C" int tfm_flash_decode(const void* q, const void* kc,
                                const void* vc, const void* ksc,
                                const void* vsc, const void* pos, void* out,
                                int B, int t, int H, int KV, int M, int D,
                                int layer, float scale, int is_bf16,
                                int kv_int8, void* stream) {
  if (KV <= 0 || H % KV != 0 || B <= 0 || t <= 0 || M <= 0 || D <= 0)
    return cudaErrorInvalidValue;
  if (kv_int8 && (ksc == nullptr || vsc == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using TQ = __nv_bfloat16;
    return kv_int8 ? launch<TQ, int8_t>(q, kc, vc, ksc, vsc, pos, out, B, t,
                                        H, KV, M, D, layer, scale, s)
                   : launch<TQ, TQ>(q, kc, vc, nullptr, nullptr, pos, out, B,
                                    t, H, KV, M, D, layer, scale, s);
  }
  using TQ = float;
  return kv_int8 ? launch<TQ, int8_t>(q, kc, vc, ksc, vsc, pos, out, B, t, H,
                                      KV, M, D, layer, scale, s)
                 : launch<TQ, TQ>(q, kc, vc, nullptr, nullptr, pos, out, B, t,
                                  H, KV, M, D, layer, scale, s);
}
