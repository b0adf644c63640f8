// Tensor-core fragment helpers shared by the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu): bf16 operands through mma.sync m16n8k16
// with fp32 accumulation.
//
// Fragment layout of m16n8k16 (gr = lane / 4, tg = lane % 4):
//   A 16x16, row-major, 4 registers of two bf16 each:
//     a0 (row gr,   k tg*2..+1)    a1 (row gr+8, k tg*2..+1)
//     a2 (row gr,   k tg*2+8..+9)  a3 (row gr+8, k tg*2+8..+9)
//   B 16x8, column-major, 2 registers:
//     b0 (k tg*2..+1, col gr)      b1 (k tg*2+8..+9, col gr)
//   C/D 16x8 fp32, 4 registers:
//     c0, c1 (row gr, col tg*2..+1)  c2, c3 (row gr+8, col tg*2..+1)
// So the accumulators of two neighbouring 8-column tiles, packed to bf16
// pairwise, are exactly the A fragment of the next product over those 16
// columns (pack_a): the scores never leave the registers.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tfm {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The bf16 A fragment over columns [16t, 16t + 16) of a row block whose
// fp32 accumulators sit in 8-column tiles c[2t] and c[2t + 1].
__device__ __forceinline__ void pack_a(uint32_t* a, const float* c0,
                                       const float* c1) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// B fragment from a shared tile stored [col][k] (k contiguous, so each
// register is one aligned 32-bit load): element (k, col) at row[col][k].
__device__ __forceinline__ void mma_bf16_smem(float* d, const uint32_t* a,
                                              const bf16* p) {
  mma_bf16(d, a, *reinterpret_cast<const uint32_t*>(p),
           *reinterpret_cast<const uint32_t*>(p + 8));
}

}  // namespace tfm
