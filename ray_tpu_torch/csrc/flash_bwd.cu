// Flash-attention backward for Hopper (sm_90a): dq, dk and dv of causal or
// full attention, from the saved row logsumexp (lse) and delta =
// rowsum(do * o), both f32 and both used as given (ring attention passes a
// global lse and delta that differ from a chunk's own, so nothing here
// recomputes them).
//
// Replaces the four Pallas backward kernels of ray_tpu/ops/flash_attention.py:
//   * _bwd_dq_kernel (:213, launched by _pallas_backward :404) and
//     _bwd_dkv_kernel (:268, :418): the FlashAttention-2 split, (B, H, S, D);
//   * _bwd_fused_kernel (:203, :385): the same gradients in one grid step
//     when one block holds the whole sequence, (B, H, S, D);
//   * _bwd_fused_kernel_lanes (:463, :549): the fused form in the
//     (B, S, H, D) layout, in 128-lane blocks.
// The fused forms keep the whole (S, S) score and dp tiles in the TPU's
// VMEM; a Hopper block has at most 227 KB of shared memory and blocks run
// in parallel, so all four become the two kernels below, which take the
// batch, sequence and head strides of every operand: both layouts, no
// transposes.
//
//   flash_bwd_dkv_kernel: one block per (64 k rows, head, batch), four
//     warps of 16 k rows.  k and v stay in shared memory; the block walks
//     the q tiles and, per tile, recomputes s^T = k q^T and
//     p^T = exp2(s^T * scale * log2e - lse * log2e), then
//     dv += p^T do,  dp^T = v do^T,  ds^T = p^T (dp^T - delta),
//     dk += ds^T q;  dk is scaled by sm_scale at the end.
//   flash_bwd_dq_kernel: one block per (64 q rows, head, batch); q, do,
//     lse and delta stay in registers; the block walks the k tiles,
//     recomputes p and ds, and accumulates dq += ds k;  dq *= sm_scale.
//
// No atomics: each gradient row is summed by one warp in a fixed order,
// so the gradients are deterministic from run to run.
//
// All five products run on the tensor cores (mma.sync.m16n8k16, bf16 in,
// f32 accumulate).  p and ds are rounded to bf16 before their products,
// as the JAX kernels do.  The transposed operands come from shared memory:
// s^T and dp^T are computed directly as k q^T and v do^T (k, v as the A
// operand, q, do as the B operand read row-wise), and the B operands of
// p^T do, ds^T q and ds k (do, q, k read column-wise) come through
// ldmatrix.trans.  Scores, p, dp and ds stay in registers; the C fragments
// of p^T and ds^T become A fragments without a trip through memory.
//
// Causal: the dk/dv loop starts at the q tile of the diagonal and the dq
// loop stops at it; only tiles that cross the diagonal, or the ragged end
// of a sequence that is not a multiple of the tile, are masked.  Rows >= S
// are loaded as zeros with lse = +inf and delta = 0, so p = 0 there, and
// are never written.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): the backward does
// five products of 2*S^2*D per (batch, head), 10*B*H*S^2*D operations
// (half when causal); it moves q, k, v, do, dq, dk and dv (bf16) and lse
// and delta (f32) at least once.  At GPT-2 training shapes (D = 64) the
// operations bound.  This pair recomputes s in both kernels (seven products
// where five would do) and is written to be right, not fast: no wgmma, no
// TMA or cp.async pipelining of the tiles, no extra blocks at small batch.
// Those are for a later change.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ray_tpu_torch/native/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kBlockM = 64;  // rows of a block's own tile (16 per warp)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

// q rows per step of the dk/dv loop.  At D = 128 the dk and dv accumulators
// take 128 registers a thread; a 32-row step halves s^T and dp^T (16
// registers each) to stay inside the 255 a thread may have.
template <int D>
__host__ __device__ constexpr int dkv_step() { return D == 128 ? 32 : 64; }
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
// n = nt * 8 + g is row n of `tile`, read along D (q k^T, k q^T, do v^T,
// v do^T all take this form).
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
// tile's columns come through ldmatrix.trans (p^T do, ds^T q, ds k).
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

// A fragment of rows [row, row + 16) x cols [col, col + 16) of a shared
// tile with row pitch D + 8 (the caller passes row = warp * 16 + g and
// col = kc * 16 + 2t).
template <int D>
__device__ __forceinline__ void smem_a_frag(uint32_t (&a)[4],
                                            const __nv_bfloat16* tile,
                                            int row, int col) {
  constexpr int P = D + 8;
  a[0] = *reinterpret_cast<const uint32_t*>(tile + row * P + col);
  a[1] = *reinterpret_cast<const uint32_t*>(tile + (row + 8) * P + col);
  a[2] = *reinterpret_cast<const uint32_t*>(tile + row * P + col + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(tile + (row + 8) * P + col + 8);
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
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dO,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int H, int S,
                     Strides3 q_st, Strides3 k_st, Strides3 v_st,
                     Strides3 do_st, Strides3 dk_st, Strides3 dv_st,
                     float scale_log2, float sm_scale, int causal) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int BN = dkv_step<D>();
  constexpr int P = D + 8;  // padded shared-memory row, in elements
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + kBlockM * P;
  __nv_bfloat16* sQ = sV + kBlockM * P;
  __nv_bfloat16* sDo = sQ + BN * P;
  float* sLse = reinterpret_cast<float*>(sDo + BN * P);  // base 2
  float* sDelta = sLse + BN;

  const int n0 = blockIdx.x * kBlockM;  // first k row of this block
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int krow = warp * 16 + g;  // this thread's k rows: krow, krow + 8

  const __nv_bfloat16* qb = head_ptr(q, q_st, b, h);
  const __nv_bfloat16* kb = head_ptr(k, k_st, b, h);
  const __nv_bfloat16* vb = head_ptr(v, v_st, b, h);
  const __nv_bfloat16* dob = head_ptr(dO, do_st, b, h);
  const float* lse_bh = lse + (static_cast<int64_t>(b) * H + h) * S;
  const float* delta_bh = delta + (static_cast<int64_t>(b) * H + h) * S;

  load_tile<D, kBlockM, kThreads>(sK, kb, n0, k_st.s, S, tid);
  load_tile<D, kBlockM, kThreads>(sV, vb, n0, v_st.s, S, tid);

  float dk_acc[D / 8][4];
  float dv_acc[D / 8][4];
  zero_frags(dk_acc);
  zero_frags(dv_acc);

  const int m_tiles = (S + BN - 1) / BN;
  for (int mb = causal ? n0 / BN : 0; mb < m_tiles; ++mb) {
    const int m0 = mb * BN;
    __syncthreads();  // every warp is done with the previous q tile
    load_tile<D, BN, kThreads>(sQ, qb, m0, q_st.s, S, tid);
    load_tile<D, BN, kThreads>(sDo, dob, m0, do_st.s, S, tid);
    for (int i = tid; i < BN; i += kThreads) {
      const bool in = m0 + i < S;
      sLse[i] = in ? lse_bh[m0 + i] * kLog2e : INFINITY;
      sDelta[i] = in ? delta_bh[m0 + i] : 0.f;
    }
    __syncthreads();

    // s^T = k q^T: 16 k rows x BN q columns per warp
    float st[BN / 8][4];
    zero_frags(st);
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t a[4];
      smem_a_frag<D>(a, sK, krow, kc * 16 + 2 * t);
      mma_rows<D>(st, a, sQ, kc, g, t);
    }

    // p^T, masked where q < k (causal) or past S, rounded to bf16
    const bool masked = (causal && m0 < n0 + kBlockM) || m0 + BN > S ||
                        n0 + kBlockM > S;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = nt * 8 + 2 * t + (i & 1);
        float x = st[nt][i] * scale_log2;
        if (masked) {
          const int qi = m0 + col;
          const int ki = n0 + krow + (i >= 2 ? 8 : 0);
          if (qi >= S || ki >= S || (causal && qi < ki)) x = -INFINITY;
        }
        st[nt][i] = exp2f(x - sLse[col]);
      }
    }
    uint32_t pt[BN / 16][4];
    c_to_a<BN / 8>(pt, st);

    // dv += p^T do
    mma_cols<D, BN / 16>(dv_acc, pt, sDo, lane);

    // dp^T = v do^T
    float dpt[BN / 8][4];
    zero_frags(dpt);
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t a[4];
      smem_a_frag<D>(a, sV, krow, kc * 16 + 2 * t);
      mma_rows<D>(dpt, a, sDo, kc, g, t);
    }

    // ds^T = p^T (dp^T - delta), rounded to bf16; then dk += ds^T q
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dpt[nt][i] = a_elem<BN / 8>(pt, nt, i) *
                     (dpt[nt][i] - sDelta[nt * 8 + 2 * t + (i & 1)]);
    uint32_t dst[BN / 16][4];
    c_to_a<BN / 8>(dst, dpt);
    mma_cols<D, BN / 16>(dk_acc, dst, sQ, lane);
  }

  __nv_bfloat16* dkb = dk + b * dk_st.b + h * dk_st.h;
  __nv_bfloat16* dvb = dv + b * dv_st.b + h * dv_st.h;
  store_rows<D>(dkb, dk_st.s, dk_acc, n0 + krow, t, S, sm_scale);
  store_rows<D>(dvb, dv_st.s, dv_acc, n0 + krow, t, S, 1.f);
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
constexpr size_t dkv_smem() {
  return (2 * kBlockM + 2 * dkv_step<D>()) * (D + 8) * sizeof(__nv_bfloat16) +
         2 * dkv_step<D>() * sizeof(float);
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

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dO, const float* lse, const float* delta,
                       void* dk, void* dv, int B, int H, int S,
                       const int64_t* st, float scale_log2, float sm_scale,
                       int causal, cudaStream_t stream) {
  const cudaError_t err = allow_smem(flash_bwd_dkv_kernel<D>, dkv_smem<D>());
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBlockM - 1) / kBlockM, H, B);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, dkv_smem<D>(), stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dO), lse, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, S,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), strides_at(st, 4), strides_at(st, 5), scale_log2,
      sm_scale, causal);
  return cudaSuccess;
}

}  // namespace

// q, k, v, do, and the outputs: bf16 with unit stride along D and 16-byte
// aligned rows; strides in elements, (batch, seq, head) per operand in
// argument order (q, k, v, do, dq: 15 values; q, k, v, do, dk, dv: 18).
// lse, delta: f32 (B, H, S), contiguous; lse in natural-log units.
// scale_log2 = sm_scale * log2(e).  Each returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for a head dim other than 32, 64, 128).
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

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* dO, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int B, int H, int S, int D,
                                  const int64_t* strides, float scale_log2,
                                  float sm_scale, int causal, void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32:
      err = launch_dkv<32>(q, k, v, dO, l, dl, dk, dv, B, H, S, strides,
                           scale_log2, sm_scale, causal, st);
      break;
    case 64:
      err = launch_dkv<64>(q, k, v, dO, l, dl, dk, dv, B, H, S, strides,
                           scale_log2, sm_scale, causal, st);
      break;
    case 128:
      err = launch_dkv<128>(q, k, v, dO, l, dl, dk, dv, B, H, S, strides,
                            scale_log2, sm_scale, causal, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
