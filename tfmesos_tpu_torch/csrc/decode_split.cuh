// Flash-decoding's bookkeeping, for any decode kernel that splits a
// row's live key blocks over S CTAs (flash_decode.cu today; the paged
// kernel can adopt it): which blocks a split owns, how a split leaves
// its partial softmax state, and the merge of the S partials.
//
// A split's partial for one query row is (m, l, o): its running max, its
// sum of exp(s - m) and its unnormalized sum of p v, all float32.  A
// split that owns no block leaves the empty partial (-inf, 0, 0).  The
// merge is m* = max_s m_s, l = sum_s l_s e^(m_s - m*),
// o = sum_s o_s e^(m_s - m*) / l, with e^(-inf - m*) read as 0 and a row
// whose l is 0 written as zeros.  Every sum runs in a fixed order, so
// results are the same bits from run to run.
//
// Partials live in scratch the caller allocates: pm, pl [S][rows] and
// po [S][rows][D], rows = B * t * H in the output's row order.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "decode_common.cuh"

namespace tfm_split {

// Keys per block: the unit a split owns.
constexpr int BLOCK_KEYS = 64;

// Split s of S owns the contiguous blocks [j0, j1) of a row's nb live
// blocks: shares of ceil(nb / S), the last ones short or empty.
__device__ __forceinline__ void split_share(int nb, int S, int s,
                                            int* j0, int* j1) {
  const int per = (nb + S - 1) / S;
  *j0 = min(nb, s * per);
  *j1 = min(nb, *j0 + per);
}

// Weight of a partial with max m against the merged max mx.
__device__ __forceinline__ float merge_weight(float m, float mx) {
  return m == -INFINITY ? 0.f : expf(m - mx);
}

// The most splits a row may have: the merge holds two per lane.
constexpr int MAX_SPLITS = 64;

// One warp per output row: merge the row's S <= MAX_SPLITS partials into
// out (contiguous [rows][D] of TQ).  Lane i holds splits i and i + 32,
// so the partials' loads all issue at once; the weights reach the lanes
// that sum o by shuffles.  Every sum runs in a fixed order.
template <typename TQ>
__global__ void __launch_bounds__(128)
merge_partials(const float* __restrict__ pm, const float* __restrict__ pl,
               const float* __restrict__ po, TQ* __restrict__ out, int rows,
               int S, int D) {
  const int row = blockIdx.x * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const long long i0 = (long long)lane * rows + row;
  const long long i1 = i0 + 32LL * rows;
  const float m0 = lane < S ? pm[i0] : -INFINITY;
  const float m1 = lane + 32 < S ? pm[i1] : -INFINITY;
  const float mx = tfm_decode::warp_max(fmaxf(m0, m1));
  const float w0 = merge_weight(m0, mx), w1 = merge_weight(m1, mx);
  const float l = tfm_decode::warp_sum((lane < S ? pl[i0] * w0 : 0.f) +
                                       (lane + 32 < S ? pl[i1] * w1 : 0.f));
  for (int d0 = 0; d0 < D; d0 += 32) {
    const int d = d0 + lane;
    float o = 0.f;
#pragma unroll 8
    for (int s = 0; s < S; ++s) {
      const float w = __shfl_sync(0xffffffffu, s < 32 ? w0 : w1, s % 32);
      if (d < D) o += po[((long long)s * rows + row) * D + d] * w;
    }
    if (d < D)
      out[(long long)row * D + d] =
          tfm_decode::from_f<TQ>(l > 0.f ? o / l : 0.f);
  }
}

// CTAs of the merge over `rows` output rows (four warps, a row each).
inline int merge_blocks(int rows) { return (rows + 3) / 4; }

template <typename TQ>
cudaError_t launch_merge(const float* pm, const float* pl, const float* po,
                         TQ* out, int rows, int S, int D,
                         cudaStream_t stream) {
  merge_partials<TQ><<<merge_blocks(rows), 128, 0, stream>>>(pm, pl, po,
                                                             out, rows, S, D);
  return cudaGetLastError();
}

}  // namespace tfm_split
