// Checks of the Hopper primitives in sm90.cuh, one kernel each, run by
// chip_smoke.py (phase 1b) against torch before the flash kernels rely on
// them.  No model path calls these entry points.
//
//   sm90_check_tma:   one TMA load (4-d map, swizzled box) of a 64-row tile
//                     of a strided (B, S, H, D) view, rows past S zero;
//                     the tile is read back through Tile::offset.
//   sm90_check_ss:    s = a b^T by wgmma m64n64k16 with both operands
//                     K-major in shared memory (the forward's q k^T).
//   sm90_check_rs:    o = p v by wgmma m64nDk16 with p in registers and v
//                     MN-major in shared memory (the forward's p v).
//
// Each loads its shared operands with tma_load_4d through the same tensor
// maps and descriptors (Tile<D, 64>) as the forward kernel, for D = 32
// (64-byte swizzle), 64 and 128 (128-byte swizzle, two boxes at 128).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ray_tpu_torch/native/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using sm90::Tile;

// Thread 0 loads `n` tiles of Tile<D, 64> (tile i from map i at rows row0,
// head h, batch b) into smem one after the other; every thread waits.
template <int D>
__device__ void load_tiles(uint8_t* smem, uint64_t* bar,
                           const CUtensorMap* const* maps, int n, int row0,
                           int h, int b) {
  using T = Tile<D, 64>;
  if (threadIdx.x == 0) {
    sm90::mbar_init(bar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sm90::mbar_arrive_expect_tx(bar, n * T::kBytes);
    for (int i = 0; i < n; ++i)
      for (int box = 0; box < T::kBoxes; ++box)
        sm90::tma_load_4d(smem + i * T::kBytes + box * T::kBoxBytes, maps[i],
                          bar, box * T::kBoxCols, row0, h, b);
  }
  sm90::mbar_wait(bar, 0);
}

template <int D>
__global__ void check_tma_kernel(const __grid_constant__ CUtensorMap map,
                                 __nv_bfloat16* out, int row0, int h, int b) {
  using T = Tile<D, 64>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align_1024(smem_raw);
  __shared__ uint64_t bar;
  const CUtensorMap* maps[1] = {&map};
  load_tiles<D>(smem, &bar, maps, 1, row0, h, b);
  for (int i = threadIdx.x; i < 64 * D / 8; i += blockDim.x) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(out + r * D + c) =
        *reinterpret_cast<const uint4*>(smem + T::offset(r, c));
  }
}

// One warpgroup: s (64 x 64, f32) = a (64 x D) b^T (b: 64 x D).
template <int D>
__global__ void check_ss_kernel(const __grid_constant__ CUtensorMap ma,
                                const __grid_constant__ CUtensorMap mb,
                                float* out) {
  using T = Tile<D, 64>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align_1024(smem_raw);
  __shared__ uint64_t bar;
  const CUtensorMap* maps[2] = {&ma, &mb};
  load_tiles<D>(smem, &bar, maps, 2, 0, 0, 0);
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  sm90::fence_regs(s);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    sm90::wgmma_ss_m64n64k16(s, T::desc_k_major(smem, kk),
                             T::desc_k_major(smem + T::kBytes, kk), kk > 0);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(s);
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4,
            t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      out[(16 * warp + g + 8 * (i / 2)) * 64 + 8 * j + 2 * t + i % 2] =
          s[4 * j + i];
}

// One warpgroup: o (64 x D, f32) = p (64 x 64, read from device memory
// into A fragments) v (64 x D, MN-major in smem).
template <int D>
__global__ void check_rs_kernel(const __nv_bfloat16* __restrict__ p,
                                const __grid_constant__ CUtensorMap mv,
                                float* out) {
  using T = Tile<D, 64>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align_1024(smem_raw);
  __shared__ uint64_t bar;
  const CUtensorMap* maps[1] = {&mv};
  load_tiles<D>(smem, &bar, maps, 1, 0, 0, 0);
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4,
            t = threadIdx.x % 4;
  auto pair = [&](int row, int col) {
    return *reinterpret_cast<const uint32_t*>(p + (16 * warp + row) * 64 +
                                              col);
  };
  uint32_t a[4][4];
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    a[kc][0] = pair(g, 16 * kc + 2 * t);
    a[kc][1] = pair(g + 8, 16 * kc + 2 * t);
    a[kc][2] = pair(g, 16 * kc + 2 * t + 8);
    a[kc][3] = pair(g + 8, 16 * kc + 2 * t + 8);
  }
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  sm90::fence_regs(o);
  sm90::wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
    sm90::wgmma_rs_k16_tb(o, a[kc], T::desc_mn_major(smem, kc), 1);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(o);
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      out[(16 * warp + g + 8 * (i / 2)) * D + 8 * j + 2 * t + i % 2] =
          o[4 * j + i];
}

// A contiguous (64, D) bf16 matrix as the map of a (1, 1, 64, D) tensor.
int matrix_map(CUtensorMap* map, const void* base, int D) {
  return sm90::encode_tile_map(map, base, 1, 1, 64, D, 64 * D, D, 64 * D, 64);
}

template <int D>
int check_tma(const void* src, void* out, int B, int S, int H,
              const int64_t* st, int row0, int h, int b, cudaStream_t stream) {
  CUtensorMap map;
  int rc = sm90::encode_tile_map(&map, src, B, H, S, D, st[0], st[1], st[2],
                                 64);
  if (rc) return rc;
  const int smem = Tile<D, 64>::kBytes + 1024;
  cudaFuncSetAttribute(check_tma_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  check_tma_kernel<D><<<1, 128, smem, stream>>>(
      map, static_cast<__nv_bfloat16*>(out), row0, h, b);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int check_ss(const void* a, const void* b, void* out, cudaStream_t stream) {
  CUtensorMap ma, mb;
  int rc = matrix_map(&ma, a, D);
  if (!rc) rc = matrix_map(&mb, b, D);
  if (rc) return rc;
  const int smem = 2 * Tile<D, 64>::kBytes + 1024;
  cudaFuncSetAttribute(check_ss_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  check_ss_kernel<D><<<1, 128, smem, stream>>>(ma, mb,
                                              static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int check_rs(const void* p, const void* v, void* out, cudaStream_t stream) {
  CUtensorMap mv;
  int rc = matrix_map(&mv, v, D);
  if (rc) return rc;
  const int smem = Tile<D, 64>::kBytes + 1024;
  cudaFuncSetAttribute(check_rs_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  check_rs_kernel<D><<<1, 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(p), mv, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The entry points return 0, a CUDA error code, or sm90::kEncodeError + a
// CUresult.  Head dims: 32, 64, 128 (else cudaErrorInvalidValue).

// out (64, D) bf16 = rows row0 .. row0 + 63 of head h, batch b of src, a
// (B, S, H, D) view with element strides st = (batch, seq, head).
extern "C" int sm90_check_tma(const void* src, void* out, int B, int S, int H,
                              int D, const int64_t* st, int row0, int h,
                              int b, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return check_tma<32>(src, out, B, S, H, st, row0, h, b, s);
    case 64: return check_tma<64>(src, out, B, S, H, st, row0, h, b, s);
    case 128: return check_tma<128>(src, out, B, S, H, st, row0, h, b, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// out (64, 64) f32 = a b^T; a, b contiguous (64, D) bf16.
extern "C" int sm90_check_ss(const void* a, const void* b, void* out, int D,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return check_ss<32>(a, b, out, s);
    case 64: return check_ss<64>(a, b, out, s);
    case 128: return check_ss<128>(a, b, out, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// out (64, D) f32 = p v; p contiguous (64, 64) bf16, v contiguous (64, D).
extern "C" int sm90_check_rs(const void* p, const void* v, void* out, int D,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return check_rs<32>(p, v, out, s);
    case 64: return check_rs<64>(p, v, out, s);
    case 128: return check_rs<128>(p, v, out, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
