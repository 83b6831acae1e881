// Hopper (sm_90a) primitives as inline PTX, for the kernels of this
// directory: mbarriers, TMA tile loads with their tensor maps, the
// shared-memory matrix descriptor, and warpgroup MMA (wgmma).  No CUTLASS:
// each helper is one or a few PTX instructions, and sm90_check.cu holds
// each against torch on the card before a kernel relies on it.
//
// Tiles.  Every operand tile is what one or more TMA boxes write: `rows`
// rows of a (B, S, H, D) bf16 tensor, cut along D into boxes of kSwizzle
// bytes (128 for D = 64 and 128, 64 for D = 32, so a box row never
// exceeds the 128-byte swizzle span), each box rows x kSwizzle bytes, one
// after the other.  TMA swizzles each box: the 16-byte chunk c of box row r
// lands at chunk c ^ (r mod 8) for 128 bytes, c ^ ((r / 2) mod 4) for 64
// bytes, i.e. address bits [4, 7) or [4, 6) XOR-ed with bits [7, 10) or
// [7, 9) of the byte offset, which is what `swizzle` computes and what the
// descriptors' layout type tells wgmma.  Tiles start at multiples of 1024
// bytes, so the descriptors' base offset is 0.
//
// The host part encodes tensor maps with cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint, so no library links against libcuda.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

// ---------------------------------------------------------------------------
// shared memory and the swizzle
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-aligned byte of dynamic shared memory (allocate 1024
// more): swizzled tiles start on the swizzle pattern's repeat.
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// Byte offset of linear byte `off` of a box with kSwizzle-byte rows.
template <int kSwizzle>
__host__ __device__ constexpr uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & (kSwizzle / 16 - 1)) << 4);
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

// A wait that lasts this long means the ring is broken: trap (the launch
// then fails with an error) rather than hang the card.
constexpr uint64_t kWaitLimitNs = 4000000000ull;

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// After the inits, before any thread or the TMA unit uses the barriers.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait for the completion of the phase of parity `parity` (a fresh barrier
// is in phase 0; waiting on parity 1 then returns at once).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = globaltimer_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (globaltimer_ns() - t0 > kWaitLimitNs) __trap();
  }
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// One box of a 4-d tensor map at coordinates (c0, c1, c2, c3), innermost
// first, into shared memory; completes `bytes` of `bar`'s transactions.
// Coordinates past the tensor read as zeros (and still count as bytes).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor (PTX ISA, "Matrix Descriptor Format"):
// start address, leading and stride byte offsets (each >> 4), base offset
// 0, layout type in bits 62-63 (1: 128-byte swizzle, 2: 64-byte).
template <int kSwizzle>
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  static_assert(kSwizzle == 128 || kSwizzle == 64, "swizzle: 64 or 128");
  constexpr uint64_t kLayout = kSwizzle == 128 ? 1 : 2;
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (kLayout << 62);
}

// A tile of kRows rows of D bf16 columns as TMA boxes write it (see the
// top of this file), and the descriptors of its k16 slices.
template <int D, int kRows>
struct Tile {
  static_assert(D == 32 || D == 64 || D == 128, "head dim: 32, 64 or 128");
  static_assert(kRows % 8 == 0, "rows: a multiple of 8");
  static constexpr int kSwizzle = D == 32 ? 64 : 128;  // bytes of a box row
  static constexpr int kBoxCols = kSwizzle / 2;
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kBoxBytes = kRows * kSwizzle;
  static constexpr int kBytes = kBoxes * kBoxBytes;

  // byte offset of element (row, col); col a multiple of 8
  __device__ static uint32_t offset(int row, int col) {
    return (col / kBoxCols) * kBoxBytes +
           swizzle<kSwizzle>(row * kSwizzle + (col % kBoxCols) * 2);
  }

  // The tile as a K-major operand (rows are M or N, columns are K): the k16
  // slice of columns 16 kk .. 16 kk + 15.  8-row groups lie kSwizzle * 8
  // bytes apart; a slice inside a box starts 32 bytes further per step.
  __device__ static uint64_t desc_k_major(const uint8_t* tile, int kk) {
    const int col = 16 * kk;
    return smem_desc<kSwizzle>(
        tile + (col / kBoxCols) * kBoxBytes + (col % kBoxCols) * 2, 16,
        8 * kSwizzle);
  }

  // The tile as an MN-major operand (rows are K, columns are N = D): the
  // k16 slice of rows 16 kk .. 16 kk + 15.  N runs kBoxCols columns inside
  // a box row, the next kBoxCols a box further (LBO); 8-row groups of K lie
  // kSwizzle * 8 bytes apart (SBO).
  __device__ static uint64_t desc_mn_major(const uint8_t* tile, int kk) {
    return smem_desc<kSwizzle>(tile + 16 * kk * kSwizzle, kBoxBytes,
                               8 * kSwizzle);
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Pin registers at this point of the instruction stream: an accumulator
// that wgmma writes asynchronously is read only after wgmma_wait, and
// written only before wgmma_fence.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Registers of the calling warpgroup (all 128 threads execute it); the
// block's warpgroups together keep to the registers it was launched with.
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// wgmma.mma_async m64nNk16, bf16 in, f32 accumulate.  The accumulator of a
// warpgroup: warp w holds rows 16w .. 16w + 15; with g = lane / 4 and
// t = lane % 4, d[4j], d[4j + 1] are row g, columns 8j + 2t, 8j + 2t + 1,
// and d[4j + 2], d[4j + 3] row g + 8, the same columns -- mma.sync's C
// fragment repeated N / 8 times.  The register A operand has mma.sync's
// m16n8k16 A layout per warp: packed to bf16 pairs, accumulator columns
// 16c .. 16c + 15 are the A fragment of k16 step c.

// Two floats as one bf16x2 word of an A operand; `lo` is the lower column.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[32] += a (64x16, smem) * b (16x64, smem, K-major); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t a,
                                                    uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[16] += a (64x16, registers) * b (16x32, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_k16_tb(float (&d)[16],
                                                const uint32_t (&a)[4],
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d[32] += a (64x16, registers) * b (16x64, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_k16_tb(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d[64] += a (64x16, registers) * b (16x128, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_k16_tb(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// tensor maps (host)
// ---------------------------------------------------------------------------

// A failed encode returns kEncodeError + its CUresult (+ 0xffff where the
// encoder is not found), apart from the CUDA runtime's error codes.
constexpr int kEncodeError = 1 << 16;

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a bf16 tensor of logical shape (B, H, S, D), unit
// stride along D and element strides sb, ss, sh of batch, seq and head: 4-d
// (D, S, H, B) innermost first, boxes of Tile<D, rows> (`rows` rows of one
// head by kSwizzle bytes of D), swizzled.  Rows past S read as zeros.
// Returns 0 or kEncodeError + the CUresult.
inline int encode_tile_map(CUtensorMap* map, const void* base, int B, int H,
                           int S, int D, int64_t sb, int64_t ss, int64_t sh,
                           int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kEncodeError + 0xffff;
  const int swz = D == 32 ? 64 : 128;
  // a dimension of extent 1 is never stepped, so any legal stride does
  auto bytes = [](int64_t stride, int extent) -> cuuint64_t {
    return extent == 1 ? 16 : static_cast<cuuint64_t>(stride) * 2;
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {bytes(ss, S), bytes(sh, H), bytes(sb, B)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(swz / 2),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swz == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

}  // namespace sm90
