// Paged decode attention for Hopper (sm_90a), bf16 or fp32 pools,
// fp32 accumulation.
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
// self chunk (kself/vself [B, t, KV, D], not yet committed to the pool)
// the pool bound is exclusive — positions <= pos - 1, ceil(pos / page)
// blocks — and the chunk attends from the self operand under the
// intra-chunk causal mask (token tt sees self slots <= tt).  GQA: the G
// = H / KV query heads of a kv head share its pages.
//
// What bounds it on this card: bytes.  A t=1 step does ~4 FLOPs per K/V
// element it reads, far below the ~295 FLOP/byte balance point, so the
// least time is the live pages' K and V over 3.35 TB/s.
//
// What this design does about it: reads only live pages (the per-row
// block bound is computed here from pos), never the dead tail of the
// table, and never slices a layer out of the pool.  One CTA per
// (kv head, row) holds the t*G query rows of that kv head in shared
// memory, reads the row's page ids from the table itself (the TPU
// kernel's scalar prefetch), stages each page's K and V slab in shared
// memory with coalesced loads, and runs a guarded fp32 online softmax.
// This first version is simple and right: the page loop is sequential
// in one CTA, so a long row is latency-bound.  Splitting the page loop
// across CTAs (flash-decoding) and async copies are later work; PERF.md
// records the distance to the bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One online-softmax step over n staged keys: ss [R][n] holds the masked,
// scaled scores on entry and the probabilities after; vs [n][D] the
// staged values; os [R][D] / ms / ls the running accumulator.
__device__ void accumulate(float* ss, const float* vs, float* os, float* ms,
                           float* ls, float* cs, int R, int n, int D) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < R; r += WARPS) {
    float* row = ss + r * n;
    float mx = -INFINITY;
    for (int p = lane; p < n; p += 32) mx = fmaxf(mx, row[p]);
    mx = warp_max(mx);
    const float m_old = ms[r];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
    for (int p = lane; p < n; p += 32) {
      const float s = row[p];
      const float e = (s == -INFINITY) ? 0.f : expf(s - m_new);
      row[p] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float corr = (m_old == -INFINITY) ? 0.f : expf(m_old - m_new);
      ms[r] = m_new;
      ls[r] = ls[r] * corr + sum;
      cs[r] = corr;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < R * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const float* row = ss + r * n;
    float acc = os[idx] * cs[r];
    for (int p = 0; p < n; ++p) acc += row[p] * vs[p * D + d];
    os[idx] = acc;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                    const T* __restrict__ vpool,
                    const int* __restrict__ table,
                    const int* __restrict__ pos,
                    const T* __restrict__ kself,
                    const T* __restrict__ vself, T* __restrict__ out, int t,
                    int H, int KV, int D, int P, int ps, int NP, int layer,
                    int has_self, float scale) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  const int R = t * G;                       // query rows, t-major
  const int nk = ps > t ? ps : t;            // staged key rows
  float* qs = smem;                          // [R][D]
  float* os = qs + R * D;                    // [R][D]
  float* ks = os + R * D;                    // [nk][D + 1] (padded)
  float* vs = ks + nk * (D + 1);             // [nk][D]
  float* ss = vs + nk * D;                   // [R][nk]
  float* ms = ss + R * nk;                   // [R]
  float* ls = ms + R;                        // [R]
  float* cs = ls + R;                        // [R]
  const int tid = threadIdx.x;

  for (int idx = tid; idx < R * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const int tt = r / G, gi = r % G;
    qs[idx] = to_f(q[(((long long)b * t + tt) * H + kvh * G + gi) * D + d]);
    os[idx] = 0.f;
  }
  for (int r = tid; r < R; r += THREADS) {
    ms[r] = -INFINITY;
    ls[r] = 0.f;
  }
  const int p0 = pos[b];
  int nb, bound;
  if (has_self) {          // pool holds positions < pos only
    nb = (p0 + ps - 1) / ps;
    bound = p0 - 1;
  } else {                 // token tt sees positions <= pos + tt
    nb = (p0 + t - 1) / ps + 1;
    bound = p0;
  }
  nb = max(0, min(nb, NP));
  const long long slab = (long long)ps * D;
  const long long layer_off = (long long)layer * P * KV * slab;
  __syncthreads();

  for (int j = 0; j < nb; ++j) {
    int page = table[(long long)b * NP + j];
    page = max(0, min(page, P - 1));
    const long long base = layer_off + ((long long)page * KV + kvh) * slab;
    const T* kp = kpool + base;
    const T* vp = vpool + base;
    for (int idx = tid; idx < ps * D; idx += THREADS) {
      const int p = idx / D, d = idx % D;
      ks[p * (D + 1) + d] = to_f(kp[idx]);
      vs[idx] = to_f(vp[idx]);
    }
    __syncthreads();
    for (int idx = tid; idx < R * ps; idx += THREADS) {
      const int r = idx / ps, p = idx % ps;
      const float* qr = qs + r * D;
      const float* kr = ks + p * (D + 1);
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
      const int kpos = j * ps + p;
      const bool bad = has_self ? kpos > bound : kpos > bound + r / G;
      ss[r * ps + p] = bad ? -INFINITY : dot * scale;
    }
    __syncthreads();
    accumulate(ss, vs, os, ms, ls, cs, R, ps, D);
  }

  if (has_self) {
    for (int idx = tid; idx < t * D; idx += THREADS) {
      const int tt = idx / D, d = idx % D;
      const long long off = (((long long)b * t + tt) * KV + kvh) * D + d;
      ks[tt * (D + 1) + d] = to_f(kself[off]);
      vs[idx] = to_f(vself[off]);
    }
    __syncthreads();
    for (int idx = tid; idx < R * t; idx += THREADS) {
      const int r = idx / t, sl = idx % t;
      const float* qr = qs + r * D;
      const float* kr = ks + sl * (D + 1);
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
      // Intra-chunk causality: token tt attends self slots <= tt.
      ss[r * t + sl] = sl > r / G ? -INFINITY : dot * scale;
    }
    __syncthreads();
    accumulate(ss, vs, os, ms, ls, cs, R, t, D);
  }

  for (int idx = tid; idx < R * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const int tt = r / G, gi = r % G;
    const float l = ls[r];
    out[(((long long)b * t + tt) * H + kvh * G + gi) * D + d] =
        from_f<T>(l > 0.f ? os[idx] / l : 0.f);
  }
}

}  // namespace

extern "C" const char* tfm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory (bytes) one CTA needs for these sizes.
extern "C" long long tfm_flash_decode_paged_smem(int t, int H, int KV, int D,
                                                 int ps) {
  const long long R = (long long)t * (H / KV);
  const long long nk = ps > t ? ps : t;
  return (2 * R * D + nk * (D + 1) + nk * D + R * nk + 3 * R) *
         (long long)sizeof(float);
}

// q: contiguous [B, t, H, D]; kpool/vpool: contiguous [L, P, KV, ps, D];
// table: contiguous int32 [B, NP]; pos: int32 [B]; kself/vself:
// contiguous [B, t, KV, D] or null when has_self == 0; out: contiguous
// [B, t, H, D].  All of one element type (bf16 when is_bf16, else fp32).
// Returns cudaGetLastError() after the launch.
extern "C" int tfm_flash_decode_paged(const void* q, const void* kpool,
                                      const void* vpool, const void* table,
                                      const void* pos, const void* kself,
                                      const void* vself, void* out, int B,
                                      int t, int H, int KV, int D, int P,
                                      int ps, int NP, int layer,
                                      int has_self, float scale, int is_bf16,
                                      void* stream) {
  if (KV <= 0 || H % KV != 0 || B <= 0) return cudaErrorInvalidValue;
  const long long smem = tfm_flash_decode_paged_smem(t, H, KV, D, ps);
  if (smem > 232448) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(KV, B);
  cudaError_t err;
  if (is_bf16) {
    using T = __nv_bfloat16;
    err = cudaFuncSetAttribute(paged_decode_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    paged_decode_kernel<T><<<grid, THREADS, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(kpool),
        static_cast<const T*>(vpool), static_cast<const int*>(table),
        static_cast<const int*>(pos), static_cast<const T*>(kself),
        static_cast<const T*>(vself), static_cast<T*>(out), t, H, KV, D, P,
        ps, NP, layer, has_self, scale);
  } else {
    using T = float;
    err = cudaFuncSetAttribute(paged_decode_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    paged_decode_kernel<T><<<grid, THREADS, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(kpool),
        static_cast<const T*>(vpool), static_cast<const int*>(table),
        static_cast<const int*>(pos), static_cast<const T*>(kself),
        static_cast<const T*>(vself), static_cast<T*>(out), t, H, KV, D, P,
        ps, NP, layer, has_self, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
