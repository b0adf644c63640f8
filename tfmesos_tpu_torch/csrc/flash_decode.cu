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
// score after the dot and the v-scale into the probability before P.V,
// with the rounding rules of decode_common.cuh (PV<>), so the cache is
// read at int8 width and never dequantized in device memory.
//
// What bounds it on this card: bytes.  A t = 1 step does ~4 FLOPs per
// cache element it reads, far below the ~295 FLOP/byte balance point:
// the least time is the live positions' K and V (and scales) over
// 3.35 TB/s.  Reaching that needs the whole card reading at once — the
// flagship's long-context step has only B x KV = 32 (row, kv head)
// pairs for 132 SMs — and copies in flight while the products run.
//
// What this design does about it:
// * Flash-decoding.  The grid is (KV, B x row tiles, S): the S CTAs of a
//   (row, kv head, tile of <= 4 query rows) split its live 64-key blocks
//   into contiguous shares (decode_split.cuh).  S comes from static
//   shapes and the SM count (the wrapper's _decode_splits), never from
//   pos, so no step reads pos on the host.  Each CTA reads pos[b]
//   itself; a share past the row's live bound leaves the empty partial.
//   With S > 1 the partials go to scratch and merge_partials combines
//   them, one warp a row, in a fixed order (deterministic); with S = 1
//   the CTA writes the output directly and no merge runs.
// * Bulk async copies.  One 64-position block of one head is a single
//   contiguous span of K and of V (8 KB each in bf16) plus, for int8, two
//   256-byte scale slices.  A producer warp streams them with 1-D bulk
//   copies (cp.async.bulk, the tensor-map-free form of TMA) into a ring
//   of 3-4 stages guarded by mbarriers, so block j + 1 is in flight while
//   block j is computed.  Operands stay in their stored type in shared
//   memory.  A span that is not 16-byte aligned or sized (an odd M, a
//   short int8 tail) is loaded by the producer warp itself with ordinary
//   loads into the same ring.
// * No block barrier.  Each of the 4 consumer warps owns 16 keys of every
//   block: D / 8 lanes per key, each lane 8 elements of head_dim read with
//   one 16-byte (bf16) shared load, the dot finished by shuffles.  A warp
//   keeps its own running (m, l, o) in registers and releases the stage
//   to the producer through the `empty` barrier; warps merge once, after
//   their last block.  p is rounded against its warp's running max, not
//   the whole row's: other bits than the JAX kernel, the same function.

#include "decode_split.cuh"
#include "hopper_async.cuh"

namespace {

using tfm_async::mbar_arrive;
using tfm_async::mbar_arrive_expect_tx;
using tfm_async::mbar_wait;
using tfm_decode::from_f;
using tfm_decode::PV;
using tfm_decode::to_f;
using tfm_split::BLOCK_KEYS;

constexpr int CWARPS = 4;                    // consumer warps
constexpr int THREADS = (CWARPS + 1) * 32;   // + one producer warp
constexpr int RT = 4;                        // query rows per CTA
constexpr int VEC = 8;                       // head_dim elements per lane
constexpr int KW = BLOCK_KEYS / CWARPS;      // keys per warp per block

template <typename TKV, int D>
struct Plan {
  static constexpr int LPK = D / VEC;              // lanes per key
  static constexpr int KPS = 32 / LPK;             // keys per warp step
  static constexpr int STEPS = KW > KPS ? KW / KPS : 1;
  static constexpr int KV_BYTES = BLOCK_KEYS * D * (int)sizeof(TKV);
  static constexpr int STAGE = 2 * KV_BYTES + 2 * BLOCK_KEYS * 4;
  static constexpr int NST = 4 * STAGE <= 160 * 1024 ? 4 : 3;
  // stages, then 2 * NST barriers, q rows, the warps' partials, limits
  static constexpr int BAR_OFF = NST * STAGE;
  static constexpr int Q_OFF = BAR_OFF + 2 * NST * 8;
  static constexpr int WM_OFF = Q_OFF + RT * D * 4;
  static constexpr int WL_OFF = WM_OFF + CWARPS * RT * 4;
  static constexpr int WO_OFF = WL_OFF + CWARPS * RT * 4;
  static constexpr int LIM_OFF = WO_OFF + CWARPS * RT * D * 4;
  static constexpr int BYTES = LIM_OFF + RT * 4;
};

// 8 consecutive elements of T at p (aligned to their size) as floats.
template <typename T>
__device__ __forceinline__ void load8(const T* p, float* x);
template <>
__device__ __forceinline__ void load8<__nv_bfloat16>(const __nv_bfloat16* p,
                                                     float* x) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = to_f(e[i]);
}
template <>
__device__ __forceinline__ void load8<float>(const float* p, float* x) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
template <>
__device__ __forceinline__ void load8<int8_t>(const int8_t* p, float* x) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = to_f(e[i]);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

struct Args {
  const void *q, *kc, *vc;
  const float *ksc, *vsc;
  const int* pos;
  void* out;
  float *pm, *pl, *po;        // partials (S > 1), else null
  int B, t, H, KV, M, layer, S, tiles;
  float scale;
};

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(THREADS)
split_decode_kernel(const Args a) {
  using P = Plan<TKV, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::BAR_OFF);
  uint64_t* empty = full + P::NST;
  float* qs = reinterpret_cast<float*>(smem + P::Q_OFF);
  float* wm = reinterpret_cast<float*>(smem + P::WM_OFF);
  float* wl = reinterpret_cast<float*>(smem + P::WL_OFF);
  float* wo = reinterpret_cast<float*>(smem + P::WO_OFF);
  int* lim = reinterpret_cast<int*>(smem + P::LIM_OFF);

  const int kvh = blockIdx.x, b = blockIdx.y / a.tiles;
  const int r0 = (blockIdx.y % a.tiles) * RT, split = blockIdx.z;
  const int G = a.H / a.KV, rows = a.t * G;
  const int R = min(RT, rows - r0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // This tile's live blocks (up to its last token's bound, within M) and
  // the share of them this split owns.
  const int p0 = a.pos[b];
  const int last = p0 + (r0 + R - 1) / G;
  const int nb = last < 0 ? 0
                          : min(last / BLOCK_KEYS + 1,
                                (a.M + BLOCK_KEYS - 1) / BLOCK_KEYS);
  int j0, j1;
  tfm_split::split_share(nb, a.S, split, &j0, &j1);

  if (tid == 0) {
    for (int i = 0; i < P::NST; ++i) {
      tfm_async::mbar_init(&full[i], 1);
      tfm_async::mbar_init(&empty[i], CWARPS);
    }
    tfm_async::fence_barrier_init();
  }
  const TQ* q = static_cast<const TQ*>(a.q);
  for (int idx = tid; idx < RT * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const int tt = (r0 + r) / G, gi = (r0 + r) % G;
    qs[idx] = r < R ? to_f(q[(((long long)b * a.t + tt) * a.H + kvh * G +
                              gi) * D + d])
                    : 0.f;
  }
  for (int r = tid; r < RT; r += THREADS)
    lim[r] = r < R ? p0 + (r0 + r) / G : -1;    // -1: sees nothing
  __syncthreads();

  const long long head = ((long long)a.layer * a.B + b) * a.KV + kvh;
  const TKV* kb = static_cast<const TKV*>(a.kc) + head * a.M * D;
  const TKV* vb = static_cast<const TKV*>(a.vc) + head * a.M * D;
  const float* ksb = a.ksc == nullptr ? nullptr : a.ksc + head * a.M;
  const float* vsb = a.vsc == nullptr ? nullptr : a.vsc + head * a.M;

  if (warp == CWARPS) {
    // ---- producer: fill the ring, one stage per block of the share ----
    for (int j = j0; j < j1; ++j) {
      const int i = j - j0, st = i % P::NST;
      if (i >= P::NST) mbar_wait(&empty[st], ((i / P::NST) - 1) & 1);
      unsigned char* stage = smem + st * P::STAGE;
      TKV* ks = reinterpret_cast<TKV*>(stage);
      TKV* vs = reinterpret_cast<TKV*>(stage + P::KV_BYTES);
      float* kss = reinterpret_cast<float*>(stage + 2 * P::KV_BYTES);
      float* vss = kss + BLOCK_KEYS;
      const int k0 = j * BLOCK_KEYS, n = min(BLOCK_KEYS, a.M - k0);
      const TKV* ksrc = kb + (long long)k0 * D;
      const TKV* vsrc = vb + (long long)k0 * D;
      const uint32_t bytes = n * D * sizeof(TKV);
      bool bulk = aligned16(ksrc) && aligned16(vsrc) && bytes % 16 == 0;
      if (ksb != nullptr)
        bulk = bulk && aligned16(ksb + k0) && aligned16(vsb + k0) &&
               (n * 4) % 16 == 0;
      if (bulk) {
        if (lane == 0) {
          const uint32_t sbytes = ksb != nullptr ? n * 4 : 0;
          mbar_arrive_expect_tx(&full[st], 2 * bytes + 2 * sbytes);
          tfm_async::bulk_load(ks, ksrc, bytes, &full[st]);
          tfm_async::bulk_load(vs, vsrc, bytes, &full[st]);
          if (sbytes) {
            tfm_async::bulk_load(kss, ksb + k0, sbytes, &full[st]);
            tfm_async::bulk_load(vss, vsb + k0, sbytes, &full[st]);
          }
        }
      } else {
        for (int idx = lane; idx < n * D; idx += 32) {
          ks[idx] = ksrc[idx];
          vs[idx] = vsrc[idx];
        }
        if (ksb != nullptr) {
          for (int p = lane; p < n; p += 32) {
            kss[p] = ksb[k0 + p];
            vss[p] = vsb[k0 + p];
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[st]);
      }
    }
  } else {
    // ---- consumers: warp `warp` owns keys [warp * KW, + KW) of a block --
    const int li = lane % P::LPK, g = lane / P::LPK;
    float qr[RT][VEC], o[RT][VEC], m[RT], l[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        qr[r][e] = qs[r * D + li * VEC + e];
        o[r][e] = 0.f;
      }
      m[r] = -INFINITY;
      l[r] = 0.f;
    }
    int lims[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) lims[r] = lim[r];

    for (int j = j0; j < j1; ++j) {
      const int i = j - j0, st = i % P::NST;
      mbar_wait(&full[st], (i / P::NST) & 1);
      const unsigned char* stage = smem + st * P::STAGE;
      const TKV* ks = reinterpret_cast<const TKV*>(stage);
      const TKV* vs = reinterpret_cast<const TKV*>(stage + P::KV_BYTES);
      const float* kss =
          reinterpret_cast<const float*>(stage + 2 * P::KV_BYTES);
      const float* vss = kss + BLOCK_KEYS;
      const int k0 = j * BLOCK_KEYS, n = min(BLOCK_KEYS, a.M - k0);

      // Scores of this warp's keys: sc[r][step] for key
      // warp * KW + step * KPS + g (invalid lanes keep -inf).
      float sc[RT][P::STEPS];
#pragma unroll
      for (int step = 0; step < P::STEPS; ++step) {
        const int kin = step * P::KPS + g;
        const int key = warp * KW + kin;
        const bool valid = kin < KW && key < n;
        float kx[VEC];
        load8<TKV>(ks + (valid ? key : 0) * D + li * VEC, kx);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) dot += qr[r][e] * kx[e];
#pragma unroll
          for (int off = 1; off < P::LPK; off <<= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          float s = dot * a.scale;
          if (ksb != nullptr) s = s * kss[valid ? key : 0];
          sc[r][step] = valid && k0 + key <= lims[r] ? s : -INFINITY;
        }
      }
      // The warp's running (m, l) per row; o rescaled once per block.
      float corr[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        float mt = -INFINITY;
#pragma unroll
        for (int step = 0; step < P::STEPS; ++step)
          mt = fmaxf(mt, sc[r][step]);
#pragma unroll
        for (int off = P::LPK; off < 32; off <<= 1)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
        const float m_new = fmaxf(m[r], mt);
        corr[r] = m[r] == -INFINITY ? 0.f : expf(m[r] - m_new);
        m[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int step = 0; step < P::STEPS; ++step) {
          const float p =
              sc[r][step] == -INFINITY ? 0.f : expf(sc[r][step] - m_new);
          sc[r][step] = p;
          sum += p;
        }
        l[r] = l[r] * corr[r] + sum;     // this lane group's keys only
#pragma unroll
        for (int e = 0; e < VEC; ++e) o[r][e] *= corr[r];
      }
#pragma unroll
      for (int step = 0; step < P::STEPS; ++step) {
        const int kin = step * P::KPS + g;
        const int key = warp * KW + kin;
        if (kin < KW && key < n) {
          float vx[VEC];
          load8<TKV>(vs + key * D + li * VEC, vx);
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            const float pv = PV<TKV>::operand(sc[r][step], vss, key);
#pragma unroll
            for (int e = 0; e < VEC; ++e) o[r][e] += pv * vx[e];
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    // Sum the lane groups (each holds its keys' l and o; m is uniform).
#pragma unroll
    for (int r = 0; r < RT; ++r) {
#pragma unroll
      for (int off = P::LPK; off < 32; off <<= 1) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          o[r][e] += __shfl_xor_sync(0xffffffffu, o[r][e], off);
      }
      if (g == 0) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          wo[(warp * RT + r) * D + li * VEC + e] = o[r][e];
      }
      if (lane == 0) {
        wm[warp * RT + r] = m[r];
        wl[warp * RT + r] = l[r];
      }
    }
  }
  __syncthreads();

  // Merge the warps; write the output (S = 1) or this split's partial.
  const int out_rows = a.B * a.t * a.H;
  for (int idx = tid; idx < R * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < CWARPS; ++w) mx = fmaxf(mx, wm[w * RT + r]);
    float lsum = 0.f, osum = 0.f;
#pragma unroll
    for (int w = 0; w < CWARPS; ++w) {
      const float wt = tfm_split::merge_weight(wm[w * RT + r], mx);
      lsum += wl[w * RT + r] * wt;
      osum += wo[(w * RT + r) * D + d] * wt;
    }
    const int tt = (r0 + r) / G, gi = (r0 + r) % G;
    const long long row = ((long long)b * a.t + tt) * a.H + kvh * G + gi;
    if (a.pm == nullptr) {
      static_cast<TQ*>(a.out)[row * D + d] =
          from_f<TQ>(lsum > 0.f ? osum / lsum : 0.f);
    } else {
      const long long prow = (long long)split * out_rows + row;
      a.po[prow * D + d] = osum;
      if (d == 0) {
        a.pm[prow] = mx;
        a.pl[prow] = lsum;
      }
    }
  }
}

// The grids of this thread's last tfm_flash_decode call: the split
// kernel's (x, y, z = S) and the merge's x (0: no merge ran).
thread_local int last_launch[4] = {0, 0, 0, 0};

template <typename TQ, typename TKV, int D>
int launch(const Args& a, cudaStream_t s) {
  using P = Plan<TKV, D>;
  auto kernel = split_decode_kernel<TQ, TKV, D>;
  static std::atomic<unsigned> smem_set{0};
  cudaError_t err = tfm_async::smem_limit_once(
      smem_set, reinterpret_cast<const void*>(kernel), P::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.KV, a.B * a.tiles, a.S);
  kernel<<<grid, THREADS, P::BYTES, s>>>(a);
  err = cudaGetLastError();
  const int rows = a.B * a.t * a.H;
  last_launch[0] = grid.x;
  last_launch[1] = grid.y;
  last_launch[2] = grid.z;
  last_launch[3] = a.S > 1 ? tfm_split::merge_blocks(rows) : 0;
  if (err != cudaSuccess || a.S == 1) return err;
  return tfm_split::launch_merge<TQ>(a.pm, a.pl, a.po,
                                     static_cast<TQ*>(a.out), rows, a.S, D,
                                     s);
}

template <typename TQ, typename TKV>
int launch_d(const Args& a, int D, cudaStream_t s) {
  switch (D) {
    case 8: return launch<TQ, TKV, 8>(a, s);
    case 16: return launch<TQ, TKV, 16>(a, s);
    case 32: return launch<TQ, TKV, 32>(a, s);
    case 64: return launch<TQ, TKV, 64>(a, s);
    case 128: return launch<TQ, TKV, 128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* tfm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Query rows one CTA holds (the wrapper's row tiles and the plain
// version's partition must use the same number).
extern "C" int tfm_flash_decode_row_tile() { return RT; }

// What this thread's last tfm_flash_decode launched: out[0..2] the split
// kernel's grid (KV, B x row tiles, S), out[3] the merge's CTAs (0 when
// S = 1 and no merge ran).
extern "C" void tfm_flash_decode_last_launch(int* out) {
  for (int i = 0; i < 4; ++i) out[i] = last_launch[i];
}

// q: contiguous [B, t, H, D]; kc/vc: contiguous [L, B, KV, M, D] (int8
// when kv_int8, else q's type); ksc/vsc: contiguous float32
// [L, B, KV, 1, M] when kv_int8, else null; pos: int32 [B]; out:
// contiguous [B, t, H, D] of q's type (bf16 when is_bf16, else float32).
// splits: 1 <= S <= 64 CTAs per (row, kv head, row tile); with S > 1, pm/pl
// (float32 [S, B*t*H]) and po (float32 [S, B*t*H, D]) are the partials'
// scratch and a merge kernel follows, else they are null.  head_dim D in
// {8, 16, 32, 64, 128}.  Returns cudaGetLastError() after the launches.
extern "C" int tfm_flash_decode(const void* q, const void* kc,
                                const void* vc, const void* ksc,
                                const void* vsc, const void* pos, void* out,
                                void* pm, void* pl, void* po, int B, int t,
                                int H, int KV, int M, int D, int layer,
                                int splits, float scale, int is_bf16,
                                int kv_int8, void* stream) {
  if (KV <= 0 || H % KV != 0 || B <= 0 || t <= 0 || M <= 0 || splits < 1 ||
      splits > tfm_split::MAX_SPLITS)
    return cudaErrorInvalidValue;
  if (kv_int8 && (ksc == nullptr || vsc == nullptr))
    return cudaErrorInvalidValue;
  if (splits > 1 && (pm == nullptr || pl == nullptr || po == nullptr))
    return cudaErrorInvalidValue;
  const int rows = t * (H / KV);
  Args a{q, kc, vc,
         kv_int8 ? static_cast<const float*>(ksc) : nullptr,
         kv_int8 ? static_cast<const float*>(vsc) : nullptr,
         static_cast<const int*>(pos), out,
         splits > 1 ? static_cast<float*>(pm) : nullptr,
         static_cast<float*>(pl), static_cast<float*>(po),
         B, t, H, KV, M, layer, splits, (rows + RT - 1) / RT, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using TQ = __nv_bfloat16;
    return kv_int8 ? launch_d<TQ, int8_t>(a, D, s) : launch_d<TQ, TQ>(a, D, s);
  }
  return kv_int8 ? launch_d<float, int8_t>(a, D, s)
                 : launch_d<float, float>(a, D, s);
}
