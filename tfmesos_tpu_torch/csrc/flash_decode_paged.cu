// Paged decode attention for Hopper (sm_90a): bf16 or float32 pools, or
// int8 pools with per-position float32 scales; float32 accumulation.
//
// Replaces: tfmesos_tpu/ops/attention.py, _flash_decode_paged_kernel
// (called through flash_decode_paged) — the TPU kernel behind every
// decode tick of the continuous batcher.
//
// What it computes: for each row b and each of its t chunk tokens,
// attention of q [B, t, H, D] over that row's cache, which lives in
// pages of a shared stacked pool [L, P, KV, page, D] (layer `layer`,
// read in place) named by the row's page-table row table[b, :NP], with
// ragged per-row positions pos[b].  Without a self chunk the pool holds
// the chunk already: token tt sees positions <= pos + tt (inclusive
// bound, blocks 0 .. (pos + t - 1) / page).  With the deferred-write
// self chunk (kself/vself [B, t, KV, D] in q's type, not yet committed
// to the pool) the pool bound is exclusive — positions <= pos - 1,
// ceil(pos / page) blocks — and the chunk attends from the self operand
// under the intra-chunk causal mask (token tt sees self slots <= tt).
// GQA: the G = H / KV query heads of a kv head share its pages.  int8
// pools carry lane-major scales [L, P, KV, 1, page]; the k-scale folds
// into the score after the dot and the v-scale into the probability
// before P.V — the math of decode_common.cuh, shared with the linear
// kernel — so pages are read at int8 width.
//
// What bounds it on this card: bytes.  A t=1 step does ~4 FLOPs per K/V
// element it reads, far below the ~295 FLOP/byte balance point, so the
// least time is the live pages' K and V (and scales) over 3.35 TB/s.
//
// What this design does about it: reads only live pages (the per-row
// block bound is computed here from pos), never the dead tail of the
// table, and never slices a layer out of the pool.  One CTA per
// (kv head, row, tile of up to 16 query rows) reads the row's page ids
// from the table itself (the TPU kernel's scalar prefetch), stages each
// page's K and V slab in shared memory with coalesced loads, and runs a
// guarded float32 online softmax; the self chunk is staged a page's
// worth of slots at a time, so a chunk of any length runs.  This first
// version is simple and right: the page loop is sequential in one CTA,
// so a long row is latency-bound.  Splitting the page loop across CTAs
// (flash-decoding) and async copies are later work; PERF.md records the
// distance to the bound.

#include "decode_common.cuh"

namespace {

using namespace tfm_decode;

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kpool,
                    const TKV* __restrict__ vpool,
                    const float* __restrict__ kscale,
                    const float* __restrict__ vscale,
                    const int* __restrict__ table,
                    const int* __restrict__ pos,
                    const TQ* __restrict__ kself,
                    const TQ* __restrict__ vself, TQ* __restrict__ out,
                    int t, int H, int KV, int D, int P, int ps, int NP,
                    int layer, int has_self, float scale) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  const int r0 = blockIdx.z * ROW_TILE;
  const int R = min(ROW_TILE, t * G - r0);
  const int rt = min(ROW_TILE, t * G);
  const Smem sm(smem, rt, ps, D);
  load_rows(q, sm, b, t, H, G, kvh, r0, R, D);
  const int p0 = pos[b];
  const int tt_last = (r0 + R - 1) / G;      // this tile's last token
  for (int r = threadIdx.x; r < R; r += THREADS)
    sm.lim[r] = has_self ? p0 - 1 : p0 + (r0 + r) / G;
  // Pool blocks: committed positions < pos with a self chunk, else up to
  // this tile's last token's bound.
  int nb = has_self ? (p0 + ps - 1) / ps : (p0 + tt_last) / ps + 1;
  nb = max(0, min(nb, NP));
  const long long slab = (long long)ps * D;
  const long long layer_pages = (long long)layer * P;
  __syncthreads();

  for (int j = 0; j < nb; ++j) {
    int page = table[(long long)b * NP + j];
    page = max(0, min(page, P - 1));
    const long long head = (layer_pages + page) * KV + kvh;
    stage(kpool + head * slab, vpool + head * slab, D,
          kscale == nullptr ? nullptr : kscale + head * ps,
          vscale == nullptr ? nullptr : vscale + head * ps, sm, ps, D);
    score_tile(sm, kscale != nullptr, j * ps, R, ps, D, scale);
    accumulate<TKV>(sm, R, ps, D);
  }

  if (has_self) {
    // Intra-chunk causality: token tt attends self slots <= tt.
    for (int r = threadIdx.x; r < R; r += THREADS)
      sm.lim[r] = (r0 + r) / G;
    const long long self_stride = (long long)KV * D;
    for (int s0 = 0; s0 <= tt_last; s0 += ps) {
      const int n = min(ps, tt_last + 1 - s0);
      const long long off = (((long long)b * t + s0) * KV + kvh) * D;
      stage(kself + off, vself + off, self_stride, nullptr, nullptr, sm, n,
            D);
      score_tile(sm, false, s0, R, n, D, scale);
      accumulate<TQ>(sm, R, n, D);
    }
  }
  store_rows(out, sm, b, t, H, G, kvh, r0, R, D);
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* kpool, const void* vpool,
           const void* kscale, const void* vscale, const void* table,
           const void* pos, const void* kself, const void* vself, void* out,
           int B, int t, int H, int KV, int D, int P, int ps, int NP,
           int layer, int has_self, float scale, cudaStream_t s) {
  const int rows = t * (H / KV);
  const long long smem =
      smem_bytes(rows < ROW_TILE ? rows : ROW_TILE, ps, D);
  if (smem > 232448) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<TQ, TKV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(KV, B, (rows + ROW_TILE - 1) / ROW_TILE);
  paged_decode_kernel<TQ, TKV><<<grid, THREADS, smem, s>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kpool),
      static_cast<const TKV*>(vpool), static_cast<const float*>(kscale),
      static_cast<const float*>(vscale), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<const TQ*>(kself),
      static_cast<const TQ*>(vself), static_cast<TQ*>(out), t, H, KV, D, P,
      ps, NP, layer, has_self, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* tfm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory (bytes) one CTA needs for these sizes.
extern "C" long long tfm_flash_decode_paged_smem(int t, int H, int KV, int D,
                                                 int ps) {
  const int rows = t * (H / KV);
  return smem_bytes(rows < ROW_TILE ? rows : ROW_TILE, ps, D);
}

// q: contiguous [B, t, H, D]; kpool/vpool: contiguous [L, P, KV, ps, D]
// (int8 when kv_int8, else q's type); kscale/vscale: contiguous float32
// [L, P, KV, 1, ps] when kv_int8, else null; table: contiguous int32
// [B, NP]; pos: int32 [B]; kself/vself: contiguous [B, t, KV, D] of q's
// type, or null when has_self == 0; out: contiguous [B, t, H, D] of q's
// type (bf16 when is_bf16, else float32).  Returns cudaGetLastError()
// after the launch.
extern "C" int tfm_flash_decode_paged(
    const void* q, const void* kpool, const void* vpool, const void* kscale,
    const void* vscale, const void* table, const void* pos,
    const void* kself, const void* vself, void* out, int B, int t, int H,
    int KV, int D, int P, int ps, int NP, int layer, int has_self,
    float scale, int is_bf16, int kv_int8, void* stream) {
  if (KV <= 0 || H % KV != 0 || B <= 0 || t <= 0 || ps <= 0)
    return cudaErrorInvalidValue;
  if (kv_int8 && (kscale == nullptr || vscale == nullptr))
    return cudaErrorInvalidValue;
  if (has_self && (kself == nullptr || vself == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using TQ = __nv_bfloat16;
    return kv_int8
               ? launch<TQ, int8_t>(q, kpool, vpool, kscale, vscale, table,
                                    pos, kself, vself, out, B, t, H, KV, D, P,
                                    ps, NP, layer, has_self, scale, s)
               : launch<TQ, TQ>(q, kpool, vpool, nullptr, nullptr, table,
                                pos, kself, vself, out, B, t, H, KV, D, P, ps,
                                NP, layer, has_self, scale, s);
  }
  using TQ = float;
  return kv_int8
             ? launch<TQ, int8_t>(q, kpool, vpool, kscale, vscale, table, pos,
                                  kself, vself, out, B, t, H, KV, D, P, ps,
                                  NP, layer, has_self, scale, s)
             : launch<TQ, TQ>(q, kpool, vpool, nullptr, nullptr, table, pos,
                              kself, vself, out, B, t, H, KV, D, P, ps, NP,
                              layer, has_self, scale, s);
}
