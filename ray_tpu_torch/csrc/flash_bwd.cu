// Flash-attention backward for Hopper (sm_90a): dq, dk and dv of causal or
// full attention, from the saved row logsumexp (lse) and delta =
// rowsum(do * o), both f32 and both used as given (ring attention passes a
// global lse and delta that differ from a chunk's own, so nothing here
// recomputes them).
//
// Replaces the four Pallas backward kernels of ray_tpu/ops/flash_attention.py:
//   * _bwd_dkv_kernel (:268, launched by _pallas_backward :418): by
//     flash_bwd_dkv_kernel;
//   * _bwd_dq_kernel (:213, :404): by flash_bwd_dq_kernel;
//   * _bwd_fused_kernel (:203, :385), (B, H, S, D), and
//     _bwd_fused_kernel_lanes (:463, :549), (B, S, H, D) in 128-lane
//     blocks: the same gradients in one grid step when one block holds the
//     whole sequence; by the two kernels together.
// The fused forms keep the whole (S, S) score and dp tiles in the TPU's
// VMEM; a Hopper block has at most 227 KB of shared memory and blocks run
// in parallel, so all four become the two kernels below, which take the
// batch, sequence and head strides of every operand: both layouts, no
// transposes.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): the backward as one
// function does five products of 2 S^2 D operations per (batch, head),
// half when causal, and moves q, k, v, do, dq, dk, dv (bf16) and lse,
// delta (f32) once.  The two kernels recompute s and dp each, seven
// products: dk/dv four (s^T, dp^T, p^T do, ds^T q), dq three (s, dp,
// ds k).  At GPT-2 training shapes (D = 64) operations bound both: at
// B = 16, H = 12, S = 1024, causal, dk/dv 0.0521 ms and dq 0.0391 ms
// (chip_smoke.py, PERF.md).
//
// Both kernels: TMA, mbarriers and wgmma (csrc/sm90.cuh).  A block is a
// producer warpgroup and c = 1 or 2 consumer warpgroups of 64 rows; the
// plans of ops/flash_attention.py (_dq_plan, _bwd_plan) pick c, the ring
// depth and the swizzle.  The producer loads the block's own tiles once by
// TMA, then walks the other operand's tiles of 64 rows through a ring of
// slots by TMA (the forward's 4-d strided maps, so bshd, bhsd and zero
// leading strides are read as they are).  A slot's `full` mbarrier waits
// for its TMA bytes (and, in dk/dv, its row loads); its `empty` one for one
// arrival per consumer warp.  Products take both operands from shared
// memory (SS, both K-major) or p / ds from registers (RS): the wgmma
// accumulator layout of a 64 x 64 tile, packed to bf16 in place, is the
// register A layout, and the B tile is read MN-major from the same
// swizzled tile that an SS product reads K-major.  A consumer drains each
// tile's products before it releases the slot (leaving the last product in
// flight while the next tile's are issued was slower in dk/dv:
// flash_bwd_ab.py pipeline, PERF.md).  Each block writes only its own
// rows: no atomics, so the gradients are the same bit for bit from run to
// run.  Rows >= S are never written.
//
// flash_bwd_dq_kernel.  One block per (64 c q rows, head, batch).  The
// producer loads the block's q and do tiles once, then k and v tiles into
// a ring of kDqStages slots; one thread issues every TMA.  A consumer
// warpgroup holds its rows' lse * log2(e) and delta in registers (+inf and
// 0 past S), and per k tile:
//   s  = q k^T        SS wgmma m64n64k16, q and k K-major;
//   p  = 2^(s sm_scale log2 e - lse log2 e), masked on the diagonal tile
//        (k > q) and past S (k rows past S arrive as zeros, so s = 0
//        there and 2^(-lse log2 e) could overflow: inf * 0 in ds k) by
//        s = -inf on those two tiles only (a select per element of every
//        tile doubled this phase), rounded to bf16 and packed;
//   dp = do v^T       SS (issued with s, to run under the exponentials,
//                     it was slower: flash_bwd_ab.py dp_with_s);
//   ds = p (dp - delta), rounded to bf16 and packed;
//   dq += ds k        RS wgmma m64nDk16, k MN-major.
// Two consumers (128 q rows) only at D = 128: below it a one-consumer
// build fits two blocks an SM (<= 128 registers), faster than one
// two-consumer block (PERF.md).  A causal block walks k tiles up to its
// last consumer's diagonal; the first consumer of a 128-row block waits
// for and releases the tile past its own, so `empty` stays in step.  The
// grid is (H, q blocks reversed, B): within a batch the longest causal
// blocks go out first, and a head's blocks run side by side, reading its k
// and v tiles from L2.  Each dq row is summed by one warpgroup over the k
// tiles in order; dq is scaled by sm_scale at the end.
//
// flash_bwd_dkv_kernel.  One block per (64 c k rows, head, batch).  The
// producer loads the block's k and v tiles once, then q and do tiles by
// TMA and the tiles' lse * log2(e) and delta rows by plain loads of one
// producer warp, +inf and 0 past S (a (b, h) row of lse starts on a 4-byte
// boundary when S % 4 != 0, too fine for a bulk copy); `full` also waits
// for two arrivals of that warp (before the TMA and after the rows).  A
// consumer warpgroup, per q tile, for its 64 k rows:
//   s^T  = k q^T       SS, k and q K-major;
//   p^T  = 2^(s^T sm_scale log2 e - lse log2 e), masked (q < k) on the
//          diagonal tile only (q rows past S have lse = +inf, so p = 0),
//          rounded to bf16 and packed;
//   dv  += p^T do      RS wgmma m64nDk16, do MN-major, issued with
//   dp^T = v do^T      SS;
//   ds^T = p^T (dp^T - delta), rounded to bf16 and packed;
//   dk  += ds^T q      RS, q MN-major.
// A causal block starts at the q tile of its diagonal.  The grid is
// (H, k blocks, B).  dk is scaled by sm_scale at the end.
//
// Registers: ptxas keeps every warpgroup of a 384-thread block within 168
// registers a thread, setmaxnreg or not.  dk/dv: two consumers' dk and dv
// accumulators at D = 128 are 128 of them, and that build spilled ~330
// bytes, so D = 128 takes one consumer; two-consumer builds split 40 / 232
// / 232 (a 24-register producer spilled its lse loop).  dq: one 64 x D
// accumulator; its D = 128 two-consumer build splits 24 / 240 / 240 (the
// producer only issues TMA) and fits in 168.  chip_smoke.py's phase 1
// fails on a spill of either kernel (PERF.md has the counts).
//
// What bounds them: a dk/dv tile's four products are 16 wgmma m64n64k16 at
// D = 64, ~500 cycles of the SM's tensor cores, and its 4096 exponentials
// ~256 cycles of the MUFU; a dq tile's three are 12, ~375 cycles, with the
// same exponentials.  Inside a warpgroup these run in series (the
// exponentials wait for s, ds for dp), so the design leans on another
// warpgroup's products running meanwhile: the other consumer, which shares
// each ring tile (halving its traffic), or the SM's other block.  PERF.md
// has the cycles of each phase (flash_bwd_ab.py --phases).
//
// Both kernels round p and ds to bf16 before their products, as the JAX
// kernels do.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ray_tpu_torch/native/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// shared by both kernels
// ---------------------------------------------------------------------------

using sm90::pack_bf16;

constexpr int kTile = 64;  // rows a consumer owns = rows of a ring slot
constexpr float kLog2e = 1.4426950408889634f;

// Operand strides in elements, (batch, seq, head) each.
struct Strides3 {
  int64_t b, s, h;
};

Strides3 strides_at(const int64_t* st, int i) {
  return Strides3{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

// q, k, v, do tensor maps: boxes of one 64-row tile (Tile<D, 64>); 0 or
// sm90::kEncodeError + the CUresult of the map refused.
int encode_maps(CUtensorMap (&maps)[4], const void* q, const void* k,
                const void* v, const void* dO, int B, int H, int S, int D,
                const int64_t* st) {
  const void* ptrs[4] = {q, k, v, dO};
  for (int i = 0; i < 4; ++i) {
    const int rc = sm90::encode_tile_map(&maps[i], ptrs[i], B, H, S, D,
                                         st[3 * i], st[3 * i + 1],
                                         st[3 * i + 2], kTile);
    if (rc) return rc;
  }
  return 0;
}

// Let `kernel` have `bytes` of dynamic shared memory (above 48 KB it must
// be asked for), once a device: `sized` is the kernel's own flag per
// device.  0 or the CUDA error.
template <typename Kernel>
int allow_smem(Kernel* kernel, int bytes, bool (&sized)[64]) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!sized[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized[dev] = true;
  }
  return 0;
}

// The two bf16 halves of a packed word, as floats (exact).
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Element i of the accumulator's 8-column group nt, read back (as a float)
// from the A fragments `pack` made of it.
template <int NT>
__device__ __forceinline__ float a_elem(const uint32_t (&a)[NT / 2][4],
                                        int nt, int i) {
  const uint32_t w = a[nt >> 1][(nt & 1) * 2 + (i >> 1)];
  return (i & 1) ? bf16_hi(w) : bf16_lo(w);
}

// 2^x as one MUFU op (ex2.approx, ~2^-22 relative; below 2^-126 flushes to
// zero), as in flash_fwd.cu: far finer than the bf16 p it feeds.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A 64 x 64 tile in the wgmma accumulator layout (c[4j + i] is row
// 16 warp + g + 8 (i / 2), column 8j + 2t + i % 2), packed to bf16 as the
// register A operand: 16 columns a k16 step.
__device__ __forceinline__ void pack(uint32_t (&a)[kTile / 16][4],
                                     const float (&c)[kTile / 2]) {
#pragma unroll
  for (int kc = 0; kc < kTile / 16; ++kc)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kc][i] = pack_bf16(c[8 * kc + 2 * i], c[8 * kc + 2 * i + 1]);
}

// Registers that wgmma reads or writes are touched by other instructions
// only before wgmma_fence and after wgmma_wait.
__device__ __forceinline__ void fence_a(uint32_t (&a)[kTile / 16][4]) {
#pragma unroll
  for (int kc = 0; kc < kTile / 16; ++kc) sm90::fence_regs(a[kc]);
}

// c = a x b^T, 64 x 64 over D (a, b: 64-row tiles): SS wgmma, both tiles
// K-major, committed as one group; the first k16 step overwrites c.
template <int D>
__device__ __forceinline__ void ss(float (&c)[kTile / 2], const uint8_t* a,
                                   const uint8_t* b) {
  using T = sm90::Tile<D, kTile>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    sm90::wgmma_ss_m64n64k16(c, T::desc_k_major(a, kk),
                             T::desc_k_major(b, kk), kk > 0);
  sm90::wgmma_commit();
}

// acc (64 x D, D = 2N) += a (registers, 64 x 64) x tile (64 rows x D, read
// MN-major): RS wgmma, committed as one group.
template <int N>
__device__ __forceinline__ void rs(float (&acc)[N],
                                   const uint32_t (&a)[kTile / 16][4],
                                   const uint8_t* tile) {
  using T = sm90::Tile<2 * N, kTile>;
#pragma unroll
  for (int kc = 0; kc < kTile / 16; ++kc)
    sm90::wgmma_rs_k16_tb(acc, a[kc], T::desc_mn_major(tile, kc), 1);
  sm90::wgmma_commit();
}

// ---------------------------------------------------------------------------
// dq: a TMA/mbarrier k/v ring feeding wgmma
// ---------------------------------------------------------------------------

constexpr int kDqStages = 4;  // ring slots (_dq_plan)

// Dynamic shared memory, from a 1024-aligned base: the block's q and do
// tiles, the ring's k and v tiles, then the barriers (qdo_full,
// full[kStages], empty[kStages]).
template <int D, int kConsumers, int kStages>
struct DqSmem {
  using T = sm90::Tile<D, kTile>;
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + kConsumers * T::kBytes;
  static constexpr int kK = kDo + kConsumers * T::kBytes;
  static constexpr int kV = kK + kStages * T::kBytes;
  static constexpr int kBar = kV + kStages * T::kBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// One consumer below D = 128 keeps to 128 registers a thread: two blocks an
// SM.
template <int D, int kConsumers, int kStages>
__global__ void __launch_bounds__(128 * (1 + kConsumers),
                                  kConsumers == 1 && D < 128 ? 2 : 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int H, int S,
                    Strides3 dq_st, float scale_log2, float sm_scale,
                    int causal) {
  using L = DqSmem<D, kConsumers, kStages>;
  using T = typename L::T;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align_1024(smem_raw);
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = qdo_full + 1;
  uint64_t* empty = full + kStages;

  // grid (H, q blocks, B), q blocks reversed when causal: within a batch
  // the longest blocks go first, and a head's q blocks run side by side,
  // reading its k and v tiles from L2
  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int m_block = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int m0 = m_block * kTile * kConsumers;  // first q row
  const int n_tiles = (S + kTile - 1) / kTile;
  // causal: up to the last consumer's diagonal tile
  const int n_end = causal ? min(n_tiles, m0 / kTile + kConsumers) : n_tiles;

  if (threadIdx.x == 0) {
    sm90::mbar_init(qdo_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4 * kConsumers);  // consumer warps
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup; one thread issues the TMA
    if constexpr (kConsumers == 2) sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      sm90::mbar_arrive_expect_tx(qdo_full, 2 * kConsumers * T::kBytes);
      for (int c = 0; c < kConsumers; ++c)
        for (int box = 0; box < T::kBoxes; ++box) {
          const int off = c * T::kBytes + box * T::kBoxBytes;
          sm90::tma_load_4d(smem + L::kQ + off, &tq, qdo_full,
                            box * T::kBoxCols, m0 + kTile * c, h, b);
          sm90::tma_load_4d(smem + L::kDo + off, &tdo, qdo_full,
                            box * T::kBoxCols, m0 + kTile * c, h, b);
        }
      for (int it = 0; it < n_end; ++it) {
        const int s = it % kStages;
        // every consumer warp must have released the slot's previous round
        if (it >= kStages) sm90::mbar_wait(&empty[s], (it / kStages - 1) & 1);
        sm90::mbar_arrive_expect_tx(&full[s], 2 * T::kBytes);
        for (int box = 0; box < T::kBoxes; ++box) {
          const int off = s * T::kBytes + box * T::kBoxBytes;
          sm90::tma_load_4d(smem + L::kK + off, &tk, &full[s],
                            box * T::kBoxCols, it * kTile, h, b);
          sm90::tma_load_4d(smem + L::kV + off, &tv, &full[s],
                            box * T::kBoxCols, it * kTile, h, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: q rows q_first .. q_first + 63
  if constexpr (kConsumers == 2) sm90::setmaxnreg_inc<240>();
  const int wg = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // accumulator row group
  const int t = lane & 3;   // thread in the group
  const int q_first = m0 + kTile * wg;
  const int row0 = q_first + warp * 16 + g;  // rows row0, row0 + 8
  const int diag = q_first / kTile;          // this warpgroup's diagonal
  const int wg_end = causal ? min(n_end, diag + 1) : n_end;
  const uint8_t* sQ = smem + L::kQ + wg * T::kBytes;
  const uint8_t* sDo = smem + L::kDo + wg * T::kBytes;

  // the two rows' lse * log2(e) and delta; past S, +inf and 0 (p = 0)
  const int64_t row_bh = (static_cast<int64_t>(b) * H + h) * S;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < S ? lse[row_bh + row] * kLog2e : INFINITY;
    dlt[r] = row < S ? delta[row_bh + row] : 0.f;
  }

  // a 64 x D accumulator and 64 x 64 tiles in the wgmma accumulator layout
  float dq_acc[D / 2];
  float sc[kTile / 2];   // s, then p in f32
  float dps[kTile / 2];  // dp, then ds in f32
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kTile / 2; ++i) sc[i] = dps[i] = 0.f;
  uint32_t pa[kTile / 16][4];  // p, bf16 A layout (16 k rows a k16 step)
  uint32_t da[kTile / 16][4];  // ds, the same


  sm90::mbar_wait(qdo_full, 0);
  for (int it = 0; it < n_end; ++it) {
    const int s = it % kStages;
    sm90::mbar_wait(&full[s], (it / kStages) & 1);
    // a tile past this warpgroup's causal diagonal is only released
    if (it < wg_end) {
      const uint8_t* sK = smem + L::kK + s * T::kBytes;
      const uint8_t* sV = smem + L::kV + s * T::kBytes;
      sm90::fence_regs(sc);
      sm90::fence_regs(dps);
      sm90::wgmma_fence();
      ss<D>(sc, sQ, sK);  // s = q k^T
      sm90::wgmma_wait<0>();  // s is in
      sm90::fence_regs(sc);

      // p; k column 8j + 2t + i % 2 of the tile is masked (s = -inf, so
      // p = 0) past S, and past the row on the diagonal tile
      const int n0 = it * kTile;
      const bool masked = (causal && it == diag) || n0 + kTile > S;
      if (masked) {
#pragma unroll
        for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = n0 + 8 * j + 2 * t + (i & 1);
            const int row = row0 + 8 * (i >> 1);
            if (col >= S || (causal && col > row)) sc[4 * j + i] = -INFINITY;
          }
      }
#pragma unroll
      for (int i = 0; i < kTile / 2; ++i)
        sc[i] = ex2(sc[i] * scale_log2 - lse2[(i >> 1) & 1]);
      pack(pa, sc);
      sm90::wgmma_fence();
      ss<D>(dps, sDo, sV);  // dp = do v^T
      sm90::wgmma_wait<0>();  // dp is in
      sm90::fence_regs(dps);

      // ds = p (dp - delta), p as rounded to bf16
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dps[4 * j + i] = a_elem<kTile / 8>(pa, j, i) *
                           (dps[4 * j + i] - dlt[i >> 1]);
      pack(da, dps);
      fence_a(da);
      sm90::wgmma_fence();
      rs(dq_acc, da, sK);  // dq += ds k
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dq_acc);
      fence_a(da);
    }
    __syncwarp();  // the warp's wgmma reads of the slot are done
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }

  __nv_bfloat16* dqb = dq + b * dq_st.b + h * dq_st.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int i = 4 * dt + 2 * r;
      *reinterpret_cast<uint32_t*>(dqb + row * dq_st.s + dt * 8 + 2 * t) =
          pack_bf16(dq_acc[i] * sm_scale, dq_acc[i + 1] * sm_scale);
    }
  }
}

template <int D, int kConsumers, int kStages>
int launch_dq(const void* q, const void* k, const void* v, const void* dO,
              const float* lse, const float* delta, void* dq, int B, int H,
              int S, const int64_t* st, float scale_log2, float sm_scale,
              int causal, cudaStream_t stream) {
  CUtensorMap maps[4];
  const int rc = encode_maps(maps, q, k, v, dO, B, H, S, D, st);
  if (rc) return rc;
  auto kernel = flash_bwd_dq_kernel<D, kConsumers, kStages>;
  constexpr int kSmem = DqSmem<D, kConsumers, kStages>::kBytes;
  static bool sized[64] = {};  // per device: the attribute is set once
  const int e = allow_smem(kernel, kSmem, sized);
  if (e) return e;
  const int q_blocks = (S + kTile * kConsumers - 1) / (kTile * kConsumers);
  const dim3 grid(H, q_blocks, B);
  kernel<<<grid, 128 * (1 + kConsumers), kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta,
      static_cast<__nv_bfloat16*>(dq), H, S, strides_at(st, 4), scale_log2,
      sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq_rows(int block_m, const void* q, const void* k, const void* v,
                   const void* dO, const float* lse, const float* delta,
                   void* dq, int B, int H, int S, const int64_t* st,
                   float scale_log2, float sm_scale, int causal,
                   cudaStream_t stream) {
  if (block_m == 64)
    return launch_dq<D, 1, kDqStages>(q, k, v, dO, lse, delta, dq, B, H, S,
                                      st, scale_log2, sm_scale, causal,
                                      stream);
  // below D = 128 two 64-row blocks share an SM and beat one 128-row block
  // (flash_bwd_ab.py rows64, PERF.md): not built
  if constexpr (D == 128) {
    if (block_m == 128)
      return launch_dq<D, 2, kDqStages>(q, k, v, dO, lse, delta, dq, B, H,
                                        S, st, scale_log2, sm_scale, causal,
                                        stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// dk/dv: a TMA/mbarrier q/do ring feeding wgmma
// ---------------------------------------------------------------------------

constexpr int kDkvStages = 4;   // ring slots (_bwd_plan)

// Dynamic shared memory, from a 1024-aligned base: the block's k and v
// tiles, the ring's q and do tiles, its lse (x log2 e) and delta rows, then
// the barriers (kv_full, full[kStages], empty[kStages]).
template <int D, int kConsumers, int kStages>
struct DkvSmem {
  using T = sm90::Tile<D, kTile>;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kConsumers * T::kBytes;
  static constexpr int kQ = kV + kConsumers * T::kBytes;
  static constexpr int kDo = kQ + kStages * T::kBytes;
  static constexpr int kLse = kDo + kStages * T::kBytes;
  static constexpr int kDelta = kLse + kStages * kTile * 4;
  static constexpr int kBar = kDelta + kStages * kTile * 4;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

template <int D, int kConsumers, int kStages>
__global__ void __launch_bounds__(128 * (1 + kConsumers), 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int H, int S,
                     Strides3 dk_st, Strides3 dv_st, float scale_log2,
                     float sm_scale, int causal) {
  using L = DkvSmem<D, kConsumers, kStages>;
  using T = typename L::T;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align_1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  float* sLse = reinterpret_cast<float*>(smem + L::kLse);
  float* sDelta = reinterpret_cast<float*>(smem + L::kDelta);

  // grid (H, k blocks, B): within a batch the longest causal blocks go
  // first, and a head's k blocks run side by side, reading its q and do
  // tiles from L2
  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int n0 = blockIdx.y * kTile * kConsumers;  // first k row
  const int m_tiles = (S + kTile - 1) / kTile;
  const int m_start = causal ? n0 / kTile : 0;
  const int n_iter = m_tiles - m_start;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 2);                // producer warp, twice
      sm90::mbar_init(&empty[s], 4 * kConsumers);  // consumer warps
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup; its warp 0 does the work
    if constexpr (kConsumers == 2) sm90::setmaxnreg_dec<40>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(kv_full, 2 * kConsumers * T::kBytes);
      for (int c = 0; c < kConsumers; ++c)
        for (int box = 0; box < T::kBoxes; ++box) {
          const int off = c * T::kBytes + box * T::kBoxBytes;
          sm90::tma_load_4d(smem + L::kK + off, &tk, kv_full,
                            box * T::kBoxCols, n0 + kTile * c, h, b);
          sm90::tma_load_4d(smem + L::kV + off, &tv, kv_full,
                            box * T::kBoxCols, n0 + kTile * c, h, b);
        }
    }
    const int64_t row_bh = (static_cast<int64_t>(b) * H + h) * S;
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % kStages;
      const int m0 = (m_start + it) * kTile;
      // the slot's previous round must be released by every consumer warp
      if (it >= kStages) sm90::mbar_wait(&empty[s], (it / kStages - 1) & 1);
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(&full[s], 2 * T::kBytes);
        for (int box = 0; box < T::kBoxes; ++box) {
          const int off = s * T::kBytes + box * T::kBoxBytes;
          sm90::tma_load_4d(smem + L::kQ + off, &tq, &full[s],
                            box * T::kBoxCols, m0, h, b);
          sm90::tma_load_4d(smem + L::kDo + off, &tdo, &full[s],
                            box * T::kBoxCols, m0, h, b);
        }
      }
      for (int i = lane; i < kTile; i += 32) {
        const bool in = m0 + i < S;
        sLse[s * kTile + i] = in ? lse[row_bh + m0 + i] * kLog2e : INFINITY;
        sDelta[s * kTile + i] = in ? delta[row_bh + m0 + i] : 0.f;
      }
      __syncwarp();  // the warp's rows are written before lane 0 arrives
      if (lane == 0) sm90::mbar_arrive(&full[s]);
    }
    return;
  }

  // consumer warpgroup wg: k rows k_first .. k_first + 63
  if constexpr (kConsumers == 2) sm90::setmaxnreg_inc<232>();
  const int wg = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // accumulator row group
  const int t = lane & 3;   // thread in the group
  const int k_first = n0 + kTile * wg;
  const int krow = warp * 16 + g;  // rows krow, krow + 8 of the warpgroup's
  const int wg_start = causal ? k_first / kTile : 0;  // its diagonal tile
  const uint8_t* sK = smem + L::kK + wg * T::kBytes;
  const uint8_t* sV = smem + L::kV + wg * T::kBytes;

  // 64 x D accumulators and 64 x 64 tiles in the wgmma accumulator layout:
  // [4j + i] is row krow (i < 2) or krow + 8, column 8j + 2t + i % 2
  float dk_acc[D / 2], dv_acc[D / 2];
  float st[kTile / 2];   // s^T, then p^T in f32
  float dpt[kTile / 2];  // dp^T, then ds^T in f32
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kTile / 2; ++i) st[i] = dpt[i] = 0.f;
  uint32_t pa[kTile / 16][4];  // p^T, bf16 A operand (16 q rows a k16 step)
  uint32_t da[kTile / 16][4];  // ds^T, the same


  sm90::mbar_wait(kv_full, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int mt = m_start + it;
    const int s = it % kStages;
    sm90::mbar_wait(&full[s], (it / kStages) & 1);
    // a causal warpgroup whose diagonal is past this tile only releases it
    if (mt >= wg_start) {
      const uint8_t* sQ = smem + L::kQ + s * T::kBytes;
      const uint8_t* sDo = smem + L::kDo + s * T::kBytes;
      const float* lse2 = sLse + s * kTile;
      const float* dlt = sDelta + s * kTile;
      sm90::fence_regs(st);
      sm90::fence_regs(dpt);
      sm90::wgmma_fence();
      ss<D>(st, sK, sQ);
      sm90::wgmma_wait<0>();  // s^T is in
      sm90::fence_regs(st);

      // p^T; on the diagonal tile q row 8j + 2t + i % 2 < k row is masked
      const bool diag = causal && mt == wg_start;
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = 8 * j + 2 * t + (i & 1);
          const float x = st[4 * j + i] * scale_log2 - ((i & 1) ? l.y : l.x);
          const bool keep = !diag || col >= krow + 8 * (i >> 1);
          st[4 * j + i] = keep ? ex2(x) : 0.f;
        }
      }
      pack(pa, st);
      fence_a(pa);
      sm90::wgmma_fence();
      rs(dv_acc, pa, sDo);  // dv += p^T do
      ss<D>(dpt, sV, sDo);     // dp^T = v do^T
      sm90::wgmma_wait<0>();  // dp^T is in
      sm90::fence_regs(dpt);

      // ds^T = p^T (dp^T - delta), p^T as rounded to bf16
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        const float2 d = *reinterpret_cast<const float2*>(dlt + 8 * j + 2 * t);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dpt[4 * j + i] = a_elem<kTile / 8>(pa, j, i) *
                           (dpt[4 * j + i] - ((i & 1) ? d.y : d.x));
        }
      }
      pack(da, dpt);
      fence_a(da);
      sm90::wgmma_fence();
      rs(dk_acc, da, sQ);  // dk += ds^T q
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dk_acc);
      sm90::fence_regs(dv_acc);
      fence_a(pa);
      fence_a(da);
    }
    __syncwarp();  // the warp's wgmma and shared reads of the slot are done
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }

  __nv_bfloat16* dkb = dk + b * dk_st.b + h * dk_st.h;
  __nv_bfloat16* dvb = dv + b * dv_st.b + h * dv_st.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k_first + krow + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int i = 4 * dt + 2 * r;
      *reinterpret_cast<uint32_t*>(dkb + row * dk_st.s + dt * 8 + 2 * t) =
          pack_bf16(dk_acc[i] * sm_scale, dk_acc[i + 1] * sm_scale);
      *reinterpret_cast<uint32_t*>(dvb + row * dv_st.s + dt * 8 + 2 * t) =
          pack_bf16(dv_acc[i], dv_acc[i + 1]);
    }
  }
}

template <int D, int kConsumers, int kStages>
int launch_dkv(const void* q, const void* k, const void* v, const void* dO,
               const float* lse, const float* delta, void* dk, void* dv,
               int B, int H, int S, const int64_t* st, float scale_log2,
               float sm_scale, int causal, cudaStream_t stream) {
  CUtensorMap maps[4];
  const int rc = encode_maps(maps, q, k, v, dO, B, H, S, D, st);
  if (rc) return rc;
  auto kernel = flash_bwd_dkv_kernel<D, kConsumers, kStages>;
  constexpr int kSmem = DkvSmem<D, kConsumers, kStages>::kBytes;
  static bool sized[64] = {};  // per device: the attribute is set once
  const int e = allow_smem(kernel, kSmem, sized);
  if (e) return e;
  const int rows = kTile * kConsumers;
  const dim3 grid(H, (S + rows - 1) / rows, B);
  kernel<<<grid, 128 * (1 + kConsumers), kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, S,
      strides_at(st, 4), strides_at(st, 5), scale_log2, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_rows(int block_n, const void* q, const void* k, const void* v,
                    const void* dO, const float* lse, const float* delta,
                    void* dk, void* dv, int B, int H, int S,
                    const int64_t* st, float scale_log2, float sm_scale,
                    int causal, cudaStream_t stream) {
  if (block_n == 64)
    return launch_dkv<D, 1, kDkvStages>(q, k, v, dO, lse, delta, dk, dv, B,
                                        H, S, st, scale_log2, sm_scale,
                                        causal, stream);
  // two consumers' dk and dv accumulators at D = 128, 128 registers a
  // thread, do not fit in the 168 of a 384-thread block: not built
  if constexpr (D < 128) {
    if (block_n == 128)
      return launch_dkv<D, 2, kDkvStages>(q, k, v, dO, lse, delta, dk, dv,
                                          B, H, S, st, scale_log2, sm_scale,
                                          causal, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, do, and the outputs: bf16 with unit stride along D and 16-byte
// aligned base and rows; strides in elements, (batch, seq, head) per
// operand in argument order (q, k, v, do, dq: 15 values; q, k, v, do, dk,
// dv: 18).  lse, delta: f32 (B, H, S), contiguous; lse in natural-log
// units.  scale_log2 = sm_scale * log2(e).  Each returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for a head
// dim other than 32, 64, 128 or a plan the kernel is not built for, and
// sm90::kEncodeError + the CUresult of a refused tensor map.

// The dq plan (ops/flash_attention.py _dq_plan): q rows a block holds (64
// or 128: one or two consumer warpgroups), ring depth (4) and swizzle bytes
// (64 at D = 32, else 128).
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dO, const void* lse,
                                 const void* delta, void* dq, int B, int H,
                                 int S, int D, const int64_t* strides,
                                 float scale_log2, float sm_scale, int causal,
                                 int block_m, int stages, int swizzle,
                                 void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stages != kDqStages || swizzle != (D == 32 ? 64 : 128))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 32:
      return launch_dq_rows<32>(block_m, q, k, v, dO, l, dl, dq, B, H, S,
                                strides, scale_log2, sm_scale, causal, st);
    case 64:
      return launch_dq_rows<64>(block_m, q, k, v, dO, l, dl, dq, B, H, S,
                                strides, scale_log2, sm_scale, causal, st);
    case 128:
      return launch_dq_rows<128>(block_m, q, k, v, dO, l, dl, dq, B, H, S,
                                 strides, scale_log2, sm_scale, causal, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dk/dv plan (ops/flash_attention.py _bwd_plan): k rows a block holds
// (64 or 128: one or two consumer warpgroups; 64 at D = 128), ring depth
// (4) and swizzle bytes (64 at D = 32, else 128).
extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* dO, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int B, int H, int S, int D,
                                  const int64_t* strides, float scale_log2,
                                  float sm_scale, int causal, int block_n,
                                  int stages, int swizzle, void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stages != kDkvStages || swizzle != (D == 32 ? 64 : 128))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 32:
      return launch_dkv_rows<32>(block_n, q, k, v, dO, l, dl, dk, dv, B, H,
                                 S, strides, scale_log2, sm_scale, causal,
                                 st);
    case 64:
      return launch_dkv_rows<64>(block_n, q, k, v, dO, l, dl, dk, dv, B, H,
                                 S, strides, scale_log2, sm_scale, causal,
                                 st);
    case 128:
      return launch_dkv_rows<128>(block_n, q, k, v, dO, l, dl, dk, dv, B, H,
                                  S, strides, scale_log2, sm_scale, causal,
                                  st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
