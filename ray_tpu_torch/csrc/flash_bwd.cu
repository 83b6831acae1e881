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
// flash_bwd_dkv_kernel: TMA, mbarriers and wgmma (csrc/sm90.cuh).  One
// block per (64 c k rows, head, batch): c = 1 or 2 consumer warpgroups of
// 64 k rows, and a producer warpgroup; _bwd_plan (ops/flash_attention.py)
// picks c, the ring depth and the swizzle.  The producer loads the
// block's k and v tiles once by TMA, then walks the q tiles of 64 rows
// through a ring of slots: one q and one do tile by TMA (the forward's 4-d
// strided maps, so bshd, bhsd and zero leading strides are read as they
// are), and the tile's lse * log2(e) and delta by plain loads of one
// producer warp, +inf and 0 past S (a (b, h) row of lse starts on a
// 4-byte boundary when S % 4 != 0, too fine for a bulk copy).  A slot's
// `full` mbarrier waits for the TMA bytes and two arrivals of that warp
// (before the TMA and after the rows); its `empty` one for one arrival
// per consumer warp.  A consumer warpgroup, per q tile, for its 64 k rows:
//   s^T  = k q^T       SS wgmma m64n64k16, k and q K-major;
//   p^T  = 2^(s^T sm_scale log2 e - lse log2 e), masked (q < k) on the
//          diagonal tile only (q rows past S have lse = +inf, so p = 0),
//          rounded to bf16 and packed in place: the accumulator layout
//          is the register A layout;
//   dv  += p^T do      RS wgmma m64nDk16, do MN-major (the same swizzled
//                      tile, read the other way), issued with
//   dp^T = v do^T      SS;
//   ds^T = p^T (dp^T - delta), rounded to bf16 and packed;
//   dk  += ds^T q      RS, q MN-major;
// then it waits for its products and releases the slot (leaving dk in
// flight while the next tile's s^T is issued was slower: flash_bwd_ab.py
// pipeline, PERF.md).  A causal block starts at the q tile of its
// diagonal.  The grid is (H, k blocks, B): within a batch the longest
// blocks go out first, and a head's blocks run side by side, reading its
// q and do tiles from L2.  Each block writes only its own dk and dv rows:
// no atomics, so the gradients are the same bit for bit from run to run.
// dk is scaled by sm_scale at the end; rows >= S are never written.
//
// Registers: ptxas keeps every warpgroup of a 384-thread block within 168
// registers a thread, setmaxnreg or not; two consumers' dk and dv
// accumulators at D = 128 are 128 of them, and that build spilled ~330
// bytes, so D = 128 takes one consumer.  Two-consumer builds split the
// block's registers 40 / 232 / 232 with setmaxnreg (a 24-register
// producer spilled its lse loop).
//
// What bounds it: the four products of a tile are 16 wgmma m64n64k16 at
// D = 64, ~500 cycles of the SM's tensor cores, and its 4096
// exponentials ~256 cycles of the MUFU.  Inside a warpgroup these run in
// series (the exponentials wait for s^T, ds^T for dp^T), so the design
// leans on the other consumer's products running meanwhile; the two
// share each q/do tile, halving its traffic.  PERF.md has the cycles of
// each phase (flash_bwd_ab.py --phases).
//
// flash_bwd_dq_kernel: mma.sync, written to be right, not fast (no wgmma,
// no TMA or cp.async pipelining).  One block per (64 q rows, head, batch),
// four warps of 16 rows; q, do, lse and delta stay in registers; the block
// walks the k tiles up to its causal diagonal (synchronous loads into
// padded shared tiles between two __syncthreads), recomputes p and ds and
// accumulates dq += ds k on mma.sync.m16n8k16, k read column-wise through
// ldmatrix.trans; dq *= sm_scale at the end.  Each dq row is summed by one
// warp in a fixed order.
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

#include "mma.cuh"
#include "sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// dq: mma.sync
// ---------------------------------------------------------------------------

constexpr int kBlockM = 64;  // q rows of a dq block (16 per warp)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDqStep = 64;  // k rows per step of the dq loop

// Operand strides in elements, (batch, seq, head) each.
struct Strides3 {
  int64_t b, s, h;
};

__device__ __forceinline__ const __nv_bfloat16* head_ptr(
    const __nv_bfloat16* p, const Strides3& st, int b, int h) {
  return p + b * st.b + h * st.h;
}

// The two bf16 halves of a packed word, as floats (exact).
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// This warp's 16 rows (row0 = first row + g, and row0 + 8) of a (S, D)
// bf16 operand as A fragments, read from device memory; rows >= S are 0.
template <int D>
__device__ __forceinline__ void global_a_frags(uint32_t (&f)[D / 16][4],
                                               const __nv_bfloat16* base,
                                               int row0, int64_t row_stride,
                                               int S, int t) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int col = kc * 16 + 2 * t;
    f[kc][0] = load_pair(base, row0, row_stride, col, S);
    f[kc][1] = load_pair(base, row0 + 8, row_stride, col, S);
    f[kc][2] = load_pair(base, row0, row_stride, col + 8, S);
    f[kc][3] = load_pair(base, row0 + 8, row_stride, col + 8, S);
  }
}

// Rows [row0, row0 + ROWS) of a (S, D) bf16 operand into shared memory
// (row pitch D + 8 elements), 16 bytes a thread at a time; rows >= S are
// zero-filled.  Every thread of the block takes part.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int64_t row_stride, int S,
                                          int tid) {
  constexpr int kVecPerRow = D / 8;
#pragma unroll
  for (int i = tid; i < ROWS * kVecPerRow; i += THREADS) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < S)
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<int64_t>(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = val;
  }
}

template <int N>
__device__ __forceinline__ void zero_frags(float (&c)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[n][i] = 0.f;
}

// The products below read shared tiles of row pitch D + 8 (load_tile's).
// c[nt] += A x (shared tile rows as columns): the B operand of column
// n = nt * 8 + g is row n of `tile`, read along D (q k^T and do v^T take
// this form).
template <int D, int NT>
__device__ __forceinline__ void mma_rows(float (&c)[NT][4],
                                         const uint32_t (&a)[4],
                                         const __nv_bfloat16* tile, int kc,
                                         int g, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const __nv_bfloat16* bp = tile + (nt * 8 + g) * (D + 8) + kc * 16 + 2 * t;
    mma_bf16(c[nt], a, *reinterpret_cast<const uint32_t*>(bp),
             *reinterpret_cast<const uint32_t*>(bp + 8));
  }
}

// acc (16 x D) += A (16 x 16*KC, bf16 A fragments) x tile (16*KC x D): the
// tile's columns come through ldmatrix.trans (ds k).
template <int D, int KC>
__device__ __forceinline__ void mma_cols(float (&acc)[D / 8][4],
                                         const uint32_t (&a)[KC][4],
                                         const __nv_bfloat16* tile,
                                         int lane) {
  const int mi = lane >> 3;  // which of the four 8x8 matrices
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int row = kc * 16 + (lane & 7) + (mi & 1) * 8;
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t f[4];
      ldmatrix_x4_trans(f, tile + row * (D + 8) + dp * 16 + (mi >> 1) * 8);
      mma_bf16(acc[2 * dp], a[kc], f[0], f[1]);
      mma_bf16(acc[2 * dp + 1], a[kc], f[2], f[3]);
    }
  }
}

// C fragments of 8-column tiles 2kc, 2kc+1 -> bf16 A fragment of chunk kc.
template <int NT>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[NT / 2][4],
                                       const float (&c)[NT][4]) {
#pragma unroll
  for (int kc = 0; kc < NT / 2; ++kc) {
    a[kc][0] = pack_bf16(c[2 * kc][0], c[2 * kc][1]);
    a[kc][1] = pack_bf16(c[2 * kc][2], c[2 * kc][3]);
    a[kc][2] = pack_bf16(c[2 * kc + 1][0], c[2 * kc + 1][1]);
    a[kc][3] = pack_bf16(c[2 * kc + 1][2], c[2 * kc + 1][3]);
  }
}

// Element i of the C fragment of 8-column tile nt, read back (as a float)
// from the packed A fragments c_to_a made of it.
template <int NT>
__device__ __forceinline__ float a_elem(const uint32_t (&a)[NT / 2][4],
                                        int nt, int i) {
  const uint32_t w = a[nt >> 1][(nt & 1) * 2 + (i >> 1)];
  return (i & 1) ? bf16_hi(w) : bf16_lo(w);
}

// Rows row0, row0 + 8 of a (16 x D) f32 accumulator, times `scale`, to
// bf16 device memory; rows >= S are not written.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base,
                                           int64_t row_stride,
                                           const float (&acc)[D / 8][4],
                                           int row0, int t, int S,
                                           float scale) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(base + row * row_stride + dt * 8 + 2 * t) =
          pack_bf16(acc[dt][2 * r] * scale, acc[dt][2 * r + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int H, int S,
                    Strides3 q_st, Strides3 k_st, Strides3 v_st,
                    Strides3 do_st, Strides3 dq_st, float scale_log2,
                    float sm_scale, int causal) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int BN = kDqStep;
  constexpr int P = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + BN * P;

  // causal: q tiles in reverse order, so the longest start first
  const int m_block = causal ? (gridDim.x - 1 - blockIdx.x) : blockIdx.x;
  const int m0 = m_block * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = m0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  const __nv_bfloat16* qb = head_ptr(q, q_st, b, h);
  const __nv_bfloat16* kb = head_ptr(k, k_st, b, h);
  const __nv_bfloat16* vb = head_ptr(v, v_st, b, h);
  const __nv_bfloat16* dob = head_ptr(dO, do_st, b, h);
  const float* lse_bh = lse + (static_cast<int64_t>(b) * H + h) * S;
  const float* delta_bh = delta + (static_cast<int64_t>(b) * H + h) * S;

  // this warp's q and do rows as A fragments, read once
  uint32_t qf[D / 16][4];
  uint32_t df[D / 16][4];
  global_a_frags<D>(qf, qb, row0, q_st.s, S, t);
  global_a_frags<D>(df, dob, row0, do_st.s, S, t);
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < S ? lse_bh[row] * kLog2e : INFINITY;
    dlt[r] = row < S ? delta_bh[row] : 0.f;
  }

  float dq_acc[D / 8][4];
  zero_frags(dq_acc);

  const int n_tiles = (S + BN - 1) / BN;
  const int n_end =
      causal ? min(n_tiles, (m0 + kBlockM + BN - 1) / BN) : n_tiles;
  for (int nb = 0; nb < n_end; ++nb) {
    const int n0 = nb * BN;
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile<D, BN, kThreads>(sK, kb, n0, k_st.s, S, tid);
    load_tile<D, BN, kThreads>(sV, vb, n0, v_st.s, S, tid);
    __syncthreads();

    // s = q k^T: 16 q rows x BN keys per warp
    float s[BN / 8][4];
    zero_frags(s);
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) mma_rows<D>(s, qf[kc], sK, kc, g, t);

    const bool masked = (causal && n0 + BN > m0) || n0 + BN > S;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[nt][i] * scale_log2;
        if (masked) {
          const int col = n0 + nt * 8 + 2 * t + (i & 1);
          const int row = row0 + (i >= 2 ? 8 : 0);
          if (col >= S || (causal && col > row)) x = -INFINITY;
        }
        s[nt][i] = exp2f(x - lse2[i >> 1]);
      }
    }
    uint32_t pp[BN / 16][4];
    c_to_a<BN / 8>(pp, s);

    // dp = do v^T
    float dp[BN / 8][4];
    zero_frags(dp);
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) mma_rows<D>(dp, df[kc], sV, kc, g, t);

    // ds = p (dp - delta), rounded to bf16; then dq += ds k
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dp[nt][i] = a_elem<BN / 8>(pp, nt, i) * (dp[nt][i] - dlt[i >> 1]);
    uint32_t ds[BN / 16][4];
    c_to_a<BN / 8>(ds, dp);
    mma_cols<D, BN / 16>(dq_acc, ds, sK, lane);
  }

  __nv_bfloat16* dqb = dq + b * dq_st.b + h * dq_st.h;
  store_rows<D>(dqb, dq_st.s, dq_acc, row0, t, S, sm_scale);
}

template <int D>
constexpr size_t dq_smem() {
  return 2 * kDqStep * (D + 8) * sizeof(__nv_bfloat16);
}

// Above 48 KB a kernel's dynamic shared memory must be asked for.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

Strides3 strides_at(const int64_t* st, int i) {
  return Strides3{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dO, const float* lse, const float* delta,
                      void* dq, int B, int H, int S, const int64_t* st,
                      float scale_log2, float sm_scale, int causal,
                      cudaStream_t stream) {
  const cudaError_t err = allow_smem(flash_bwd_dq_kernel<D>, dq_smem<D>());
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBlockM - 1) / kBlockM, H, B);
  flash_bwd_dq_kernel<D><<<grid, kThreads, dq_smem<D>(), stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dO), lse, delta,
      static_cast<__nv_bfloat16*>(dq), H, S, strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
      strides_at(st, 4), scale_log2, sm_scale, causal);
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// dk/dv: a TMA/mbarrier q/do ring feeding wgmma
// ---------------------------------------------------------------------------

constexpr int kTile = 64;       // k rows a consumer owns = q rows of a slot
constexpr int kDkvStages = 4;   // ring slots (_bwd_plan)

// 2^x as one MUFU op (ex2.approx, ~2^-22 relative; below 2^-126 flushes to
// zero), as in flash_fwd.cu: far finer than the bf16 p it feeds.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

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

  // registers that wgmma reads or writes are touched by other instructions
  // only before wgmma_fence and after wgmma_wait
  auto fence_a = [&](uint32_t (&a)[kTile / 16][4]) {
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) sm90::fence_regs(a[kc]);
  };
  auto pack = [&](uint32_t (&a)[kTile / 16][4], const float (&c)[kTile / 2]) {
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[kc][i] = pack_bf16(c[8 * kc + 2 * i], c[8 * kc + 2 * i + 1]);
  };
  // c = a x b^T, 64 x 64 over D: SS, both tiles K-major
  auto ss = [&](float (&c)[kTile / 2], const uint8_t* a, const uint8_t* b) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss_m64n64k16(c, T::desc_k_major(a, kk),
                               T::desc_k_major(b, kk), kk > 0);
    sm90::wgmma_commit();
  };
  // acc += a (registers) x tile, 64 x D over 64 q rows: RS, tile MN-major
  auto rs = [&](float (&acc)[D / 2], const uint32_t (&a)[kTile / 16][4],
                const uint8_t* tile) {
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc)
      sm90::wgmma_rs_k16_tb(acc, a[kc], T::desc_mn_major(tile, kc), 1);
    sm90::wgmma_commit();
  };

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
      ss(st, sK, sQ);
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
      ss(dpt, sV, sDo);     // dp^T = v do^T
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
  // q, k, v, do tensor maps: boxes of one 64-row tile (Tile<D, 64>)
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, dO};
  for (int i = 0; i < 4; ++i) {
    const int rc = sm90::encode_tile_map(&maps[i], ptrs[i], B, H, S, D,
                                         st[3 * i], st[3 * i + 1],
                                         st[3 * i + 2], kTile);
    if (rc) return rc;
  }
  auto kernel = flash_bwd_dkv_kernel<D, kConsumers, kStages>;
  constexpr int kSmem = DkvSmem<D, kConsumers, kStages>::kBytes;
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
// the dk/dv entry sm90::kEncodeError + the CUresult of a refused tensor
// map.

extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dO, const void* lse,
                                 const void* delta, void* dq, int B, int H,
                                 int S, int D, const int64_t* strides,
                                 float scale_log2, float sm_scale, int causal,
                                 void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32:
      err = launch_dq<32>(q, k, v, dO, l, dl, dq, B, H, S, strides,
                          scale_log2, sm_scale, causal, st);
      break;
    case 64:
      err = launch_dq<64>(q, k, v, dO, l, dl, dq, B, H, S, strides,
                          scale_log2, sm_scale, causal, st);
      break;
    case 128:
      err = launch_dq<128>(q, k, v, dO, l, dl, dq, B, H, S, strides,
                           scale_log2, sm_scale, causal, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
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
