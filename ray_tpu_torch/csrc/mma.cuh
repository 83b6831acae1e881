// Warp-level tensor-core helpers shared by the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu).  mma.sync and ldmatrix exist from sm_80 on;
// the kernels are built for sm_90a.
//
// Fragment layout of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major)  a[0]: row g,   cols 2t, 2t+1
//                           a[1]: row g+8, cols 2t, 2t+1
//                           a[2]: row g,   cols 2t+8, 2t+9
//                           a[3]: row g+8, cols 2t+8, 2t+9
//   B (16 x 8, "col")       b0: col g, rows 2t, 2t+1;  b1: rows 2t+8, 2t+9
//   C (16 x 8, f32)         c[0], c[1]: row g, cols 2t, 2t+1
//                           c[2], c[3]: row g+8, cols 2t, 2t+1
// so the C fragments of two neighbouring 8-column tiles, packed to bf16
// pairs, are the A fragment of one 16-column chunk.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices, transposed; lanes 8i..8i+7 give the row
// addresses of matrix i, and register i receives matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Two floats as one bf16x2 word; `lo` is the lower column.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A bf16 pair of device memory, or 0 for a row past the sequence.
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* base,
                                              int row, int64_t row_stride,
                                              int col, int S) {
  if (row >= S) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + row * row_stride + col);
}
