// Flash-attention forward for Hopper (sm_90a): causal or full attention with
// an online softmax; writes o (bf16) and the row logsumexp (f32, natural log).
//
// Replaces the two Pallas forward kernels of ray_tpu/ops/flash_attention.py:
//   * _fwd_kernel (:192, launched by _pallas_forward :349), layout
//     (B, H, S, D);
//   * _fwd_kernel_lanes (:443, launched by _pallas_forward_bshd :510),
//     layout (B, S, H, D), which exists on the TPU only to avoid a
//     transpose under the 128-lane tiling rule.
// Both run _fwd_core (:100-147): online softmax in base 2, an f32
// accumulator, a causal loop that stops at the diagonal.  Here one kernel
// serves both layouts: its tensor maps take the batch, sequence and head
// strides of q, k and v, so neither layout is ever transposed.
//
// Bound on an H100 SXM: the larger of 4 B H S^2 D operations (half when
// causal) at 989 TFLOP/s bf16 and the bytes of q, k, v, o (bf16) and lse
// (f32) at 3.35 TB/s.  Causal, D = 64: at the served shape (B = 1, H = 12,
// S = 1024) 0.00189 ms, bytes; at the training shape (B = 16) 0.0303 ms,
// bytes.  Neither is near: at these sizes a block walks up to S / 64 k/v
// tiles in series, and within a tile the softmax (exp2 on the MUFU, max
// and sum across a row) takes longer than either product (PERF.md).
//
// Design.  One block per (q tile of 64 or 128 rows, head, batch), all
// heads' longest causal tiles first.  Warpgroup 0 is the producer: one
// thread starts TMA loads of the q tile once and of k and v tiles into a
// ring of kStages slots, each with a `full` mbarrier (transaction bytes)
// and an `empty` one (each consumer warp arrives once when done), so the
// next tiles' loads are in flight while the tensor cores work.  The other
// one or two warpgroups are consumers of 64 q rows each.  Tiles land
// swizzled (128-byte rows; 64-byte at D = 32; sm90.cuh); rows past S land
// as zeros, and are never written.  A causal block stops at its diagonal
// tile; only the diagonal and ragged tiles are masked.  With two
// consumers, setmaxnreg moves registers from the producer (24) to them
// (240): the s tile and the o accumulator are 32 + D / 2 f32 registers a
// thread.  _fwd_plan (ops/flash_attention.py) picks the rows, the ring
// depth and the swizzle.
//
// Consumers, per k/v tile: s = q k^T by wgmma m64n64k16 with both
// operands K-major in shared memory (SS); the online softmax (running max,
// running sum, rescaled accumulator) in f32 registers, in base 2 (scores
// scaled by sm_scale * log2(e) in f32, ex2.approx); p packed to bf16 in
// place: the accumulator layout of s is the register A layout of the next
// product; o += p v by wgmma m64nDk16 with p in registers and v MN-major
// in shared memory (RS, transposed B).  A tile's q k^T is started with the
// previous tile's p v, and its softmax, the longest phase of a tile, runs
// while that p v is in flight; a consumer so holds two slots, and the
// ring has three.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ray_tpu_torch/native/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <chrono>

#include "sm90.cuh"

namespace {

constexpr int kBlockN = 64;  // k/v rows per tile = q rows per consumer
constexpr float kLn2 = 0.6931471805599453f;
using sm90::pack_bf16;

// 2^x as one MUFU op (ex2.approx, ~2^-22 relative); results below 2^-126
// flush to zero, far below what the bf16 p keeps.  exp2f's accurate
// routine around the same op made the softmax, the bottleneck of a tile,
// slower (PERF.md).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Dynamic shared memory, from a 1024-aligned base: the q tiles, the k and v
// rings, then the barriers (q_full, full[kStages], empty[kStages]).
template <int D, int kBlockM, int kStages>
struct Smem {
  using T = sm90::Tile<D, kBlockN>;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + (kBlockM / kBlockN) * T::kBytes;
  static constexpr int kV = kK + kStages * T::kBytes;
  static constexpr int kBar = kV + kStages * T::kBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

template <int D, int kBlockM, int kStages>
__global__ void __launch_bounds__(128 * (1 + kBlockM / 64),
                                  kBlockM == 64 && D < 128 ? 2 : 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int H, int S, int64_t o_sb, int64_t o_ss, int64_t o_sh,
                 float scale_log2, int causal) {
  using L = Smem<D, kBlockM, kStages>;
  using T = typename L::T;
  constexpr int kConsumers = kBlockM / 64;  // warpgroups of 64 q rows
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int m_block = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int m0 = m_block * kBlockM;
  const int n_tiles = (S + kBlockN - 1) / kBlockN;
  const int n_end = causal ? min(n_tiles, (m0 + kBlockM) / kBlockN) : n_tiles;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4 * kConsumers);  // consumer warps
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    if constexpr (kConsumers == 2) sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      sm90::mbar_arrive_expect_tx(q_full, kConsumers * T::kBytes);
      for (int c = 0; c < kConsumers; ++c)
        for (int box = 0; box < T::kBoxes; ++box)
          sm90::tma_load_4d(smem + L::kQ + c * T::kBytes + box * T::kBoxBytes,
                            &tq, q_full, box * T::kBoxCols, m0 + 64 * c, h,
                            b);
      for (int it = 0; it < n_end; ++it) {
        const int s = it % kStages;
        // the slot's previous round must be released by every consumer
        if (it >= kStages) sm90::mbar_wait(&empty[s], (it / kStages - 1) & 1);
        sm90::mbar_arrive_expect_tx(&full[s], 2 * T::kBytes);
        for (int box = 0; box < T::kBoxes; ++box) {
          const int off = s * T::kBytes + box * T::kBoxBytes;
          sm90::tma_load_4d(smem + L::kK + off, &tk, &full[s],
                            box * T::kBoxCols, it * kBlockN, h, b);
          sm90::tma_load_4d(smem + L::kV + off, &tv, &full[s],
                            box * T::kBoxCols, it * kBlockN, h, b);
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
  const int q_first = m0 + 64 * wg;
  const int row0 = q_first + warp * 16 + g;  // rows row0, row0 + 8
  const int diag = q_first / kBlockN;        // this warpgroup's diagonal
  const int wg_end = causal ? min(n_tiles, diag + 1) : n_tiles;
  const uint8_t* sQ = smem + L::kQ + wg * T::kBytes;

  float acc[D / 2];       // o, 64 x D in the wgmma accumulator layout
  float sc[kBlockN / 2];  // s of the newest tile, then its p in f32
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBlockN / 2; ++i) sc[i] = 0.f;
  uint32_t pa[kBlockN / 16][4];  // p of the previous tile, bf16 A operand
  float m_run[2] = {-INFINITY, -INFINITY};  // running max, base-2 units
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  float alpha[2], rowsum[2];    // a tile's rescale of what came before, sums

  // s = q k^T of tile `it`, 64 rows x 64 keys: SS wgmma, q and k K-major
  auto qk = [&](int it) {
    const uint8_t* sK = smem + L::kK + (it % kStages) * T::kBytes;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss_m64n64k16(sc, T::desc_k_major(sQ, kk),
                               T::desc_k_major(sK, kk), kk > 0);
    sm90::wgmma_commit();
  };
  // o += p v of tile `it`: p packed to bf16 in place of its accumulator is
  // the A operand (16 keys per k16 step); v MN-major, by RS wgmma
  auto pv = [&](int it) {
    const uint8_t* sV = smem + L::kV + (it % kStages) * T::kBytes;
#pragma unroll
    for (int kc = 0; kc < kBlockN / 16; ++kc)
      sm90::wgmma_rs_k16_tb(acc, pa[kc], T::desc_mn_major(sV, kc), 1);
    sm90::wgmma_commit();
  };
  // s -> p of tile `it`: scale, mask, running max; alpha rescales what
  // came before, rowsum is this tile's share.  sc[4j + i] is row row0
  // (i < 2) or row0 + 8, key 64 it + 8j + 2t + i % 2; max and sum as trees
  auto softmax = [&](int it) {
    const int n0 = it * kBlockN;
    const bool masked = (causal && it == diag) || (n0 + kBlockN > S);
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) {
      sc[i] *= scale_log2;
      if (masked) {
        const int col = n0 + (i / 4) * 8 + 2 * t + (i & 1);
        const int row = row0 + ((i & 2) ? 8 : 0);
        if (col >= S || (causal && col > row)) sc[i] = -INFINITY;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v[kBlockN / 8];
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j)
        v[j] = fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]);
#pragma unroll
      for (int w = kBlockN / 16; w > 0; w /= 2)
#pragma unroll
        for (int j = 0; j < w; ++j) v[j] = fmaxf(v[j], v[j + w]);
      float mx = fmaxf(m_run[r], v[0]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // a row with every score masked so far keeps m = -inf; subtract 0
      // then, so that 2^x gives 0 and not NaN
      const float m_use = mx == -INFINITY ? 0.f : mx;
      alpha[r] = ex2(m_run[r] - m_use);
      m_run[r] = mx;
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
        float* p = &sc[4 * j + 2 * r];
        p[0] = ex2(p[0] - m_use);
        p[1] = ex2(p[1] - m_use);
        v[j] = p[0] + p[1];
      }
#pragma unroll
      for (int w = kBlockN / 16; w > 0; w /= 2)
#pragma unroll
        for (int j = 0; j < w; ++j) v[j] += v[j + w];
      rowsum[r] = v[0];
    }
  };
  auto pack = [&]() {
#pragma unroll
    for (int kc = 0; kc < kBlockN / 16; ++kc)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[kc][i] = pack_bf16(sc[8 * kc + 2 * i], sc[8 * kc + 2 * i + 1]);
  };
  // registers that wgmma reads or writes are touched by other instructions
  // only before wgmma_fence and after wgmma_wait
  auto fence_all = [&]() {
    sm90::fence_regs(sc);
    sm90::fence_regs(acc);
#pragma unroll
    for (int kc = 0; kc < kBlockN / 16; ++kc) sm90::fence_regs(pa[kc]);
  };
  auto release = [&](int it) {
    __syncwarp();  // the warp's wgmma reads of the slot are done
    if (lane == 0) sm90::mbar_arrive(&empty[it % kStages]);
  };

  // Tile `it`'s q k^T is started with tile it - 1's p v, and its softmax
  // runs while that p v is in flight; a warpgroup holds two slots.
  sm90::mbar_wait(q_full, 0);
  sm90::mbar_wait(&full[0], 0);  // every warpgroup has a tile 0
  fence_all();
  sm90::wgmma_fence();
  qk(0);
  sm90::wgmma_wait<0>();
  fence_all();
  softmax(0);
  l_run[0] = rowsum[0];
  l_run[1] = rowsum[1];
  pack();
  for (int it = 1; it < wg_end; ++it) {
    sm90::mbar_wait(&full[it % kStages], (it / kStages) & 1);
    fence_all();
    sm90::wgmma_fence();
    qk(it);
    pv(it - 1);
    sm90::wgmma_wait<1>();  // s of tile it is in; p v may still run
    sm90::fence_regs(sc);
    softmax(it);
    sm90::wgmma_wait<0>();
    fence_all();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] = l_run[r] * alpha[r] + rowsum[r];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j + 2 * r] *= alpha[r];
        acc[4 * j + 2 * r + 1] *= alpha[r];
      }
    }
    release(it - 1);
    pack();
  }
  fence_all();
  sm90::wgmma_fence();
  pv(wg_end - 1);
  sm90::wgmma_wait<0>();
  fence_all();
  release(wg_end - 1);
  for (int it = wg_end; it < n_end; ++it) {  // the other warpgroup's tile
    sm90::mbar_wait(&full[it % kStages], (it / kStages) & 1);
    release(it);
  }

  // finish: sum the row shares across the 4 threads of a row, normalise
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float l_safe = l == 0.f ? 1.f : l;
    const float inv = 1.f / l_safe;
    const int row = row0 + 8 * r;
    if (row < S) {
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        *reinterpret_cast<uint32_t*>(ob + row * o_ss + dt * 8 + 2 * t) =
            pack_bf16(acc[4 * dt + 2 * r] * inv, acc[4 * dt + 2 * r + 1] * inv);
      }
      if (t == 0) {
        lse[(static_cast<int64_t>(b) * H + h) * S + row] =
            m_run[r] * kLn2 + logf(l_safe);
      }
    }
  }
}

// q, k, v tensor maps: boxes of one 64-row tile (Tile<D, 64>).
int encode_maps(CUtensorMap (&maps)[3], const void* q, const void* k,
                const void* v, int B, int H, int S, int D,
                const int64_t* st) {
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int rc = sm90::encode_tile_map(&maps[i], ptrs[i], B, H, S, D,
                                         st[3 * i], st[3 * i + 1],
                                         st[3 * i + 2], kBlockN);
    if (rc) return rc;
  }
  return 0;
}

template <int D, int kBlockM, int kStages>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int S, const int64_t* st, float scale_log2,
           int causal, cudaStream_t stream) {
  CUtensorMap maps[3];
  int rc = encode_maps(maps, q, k, v, B, H, S, D, st);
  if (rc) return rc;
  auto kernel = flash_fwd_kernel<D, kBlockM, kStages>;
  constexpr int kSmem = Smem<D, kBlockM, kStages>::kBytes;
  static bool sized[64] = {};  // per device: the attribute is set once
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!sized[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized[dev] = true;
  }
  const dim3 grid(H, B, (S + kBlockM - 1) / kBlockM);
  kernel<<<grid, 128 * (1 + kBlockM / 64), kSmem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), lse, H, S,
      st[9], st[10], st[11], scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int kStages>
int launch_rows(int block_m, const void* q, const void* k, const void* v,
                void* o, float* lse, int B, int H, int S, const int64_t* st,
                float scale_log2, int causal, cudaStream_t stream) {
  if (block_m == 64)
    return launch<D, 64, kStages>(q, k, v, o, lse, B, H, S, st, scale_log2,
                                  causal, stream);
  if (block_m == 128)
    return launch<D, 128, kStages>(q, k, v, o, lse, B, H, S, st, scale_log2,
                                   causal, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, o: bf16 with unit stride along D, 16-byte aligned base and
// rows; strides in elements, (batch, seq, head) for q, k, v, o in that
// order (12 values).  lse: f32 (B, H, S), contiguous.  scale_log2 =
// sm_scale * log2(e).  The plan (ops/flash_attention.py _fwd_plan): q rows
// a block holds (64 or 128), ring depth (3) and swizzle bytes (64 at
// D = 32, else 128).  Returns cudaGetLastError()
// after the launch, cudaErrorInvalidValue for a head dim or plan the
// kernel is not built for, or sm90::kEncodeError + the CUresult of a
// refused tensor map.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int H, int S, int D,
                              const int64_t* strides, float scale_log2,
                              int causal, int block_m, int stages,
                              int swizzle, void* stream) {
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int want_stages = 3;
  const int want_swizzle = D == 32 ? 64 : 128;
  if (stages != want_stages || swizzle != want_swizzle)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 32:
      return launch_rows<32, 3>(block_m, q, k, v, o, l, B, H, S, strides,
                                scale_log2, causal, st);
    case 64:
      return launch_rows<64, 3>(block_m, q, k, v, o, l, B, H, S, strides,
                                scale_log2, causal, st);
    case 128:
      return launch_rows<128, 3>(block_m, q, k, v, o, l, B, H, S, strides,
                                 scale_log2, causal, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Mean host microseconds of encoding one launch's three tensor maps, over
// `iters` encodes of the maps of these arguments; negative on a refused map.
extern "C" double flash_fwd_encode_us(const void* q, const void* k,
                                      const void* v, int B, int H, int S,
                                      int D, const int64_t* strides,
                                      int iters) {
  CUtensorMap maps[3];
  if (encode_maps(maps, q, k, v, B, H, S, D, strides)) return -1.0;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i)
    encode_maps(maps, q, k, v, B, H, S, D, strides);
  const std::chrono::duration<double, std::micro> dt =
      std::chrono::steady_clock::now() - t0;
  return dt.count() / iters;
}
