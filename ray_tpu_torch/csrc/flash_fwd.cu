// Flash-attention forward for Hopper (sm_90a): causal or full attention with
// an online softmax; writes o (bf16) and the row logsumexp (f32, natural log).
//
// Replaces the two Pallas forward kernels of ray_tpu/ops/flash_attention.py:
//   * _fwd_kernel (:192, launched by _pallas_forward :349), layout
//     (B, H, S, D);
//   * _fwd_kernel_lanes (:443, launched by _pallas_forward_bshd :510),
//     layout (B, S, H, D), which exists on the TPU only to avoid a
//     transpose under the 128-lane tiling rule.
// Here one kernel serves both: it takes the batch, sequence and head
// strides of q, k, v and o, so neither layout is ever transposed.
//
// Work split.  One thread block per (64-row q tile, head, batch), four
// warps, each warp owning 16 q rows.  The block walks the k/v sequence in
// tiles of 64 rows staged in shared memory with 16-byte vector loads
// (rows padded by 8 elements so the fragment reads are free of bank
// conflicts).  Q K^T and P V run on the tensor cores with
// mma.sync.m16n8k16 (bf16 in, f32 accumulate); V's fragments come from
// ldmatrix.trans.  The online softmax (running max, running sum, rescaled
// accumulator) stays in registers in f32, in base-2 units: the scores are
// scaled by sm_scale*log2(e) in f32 and exponentiated with exp2f.  (The
// TPU kernel folds that scale into the bf16 q tile; scaling the f32
// scores costs one multiply per score and keeps q exact.)
//
// Causal: the k loop stops at the diagonal tile; only the diagonal tile and
// the ragged last tile (S not a multiple of 64) are masked.  q tiles run in
// reverse order so the longest ones start first.  Rows >= S are computed
// on zero-filled inputs and never written.
//
// Bound on an H100 SXM.  Operations 4*B*H*S^2*D (half that when causal)
// against 989 TFLOP/s bf16; bytes: q, k, v and o (2 bytes each) plus lse
// (4 bytes a row) against 3.35 TB/s.  At GPT-2 shapes (D = 64, S <= 1024)
// both bounds are a few microseconds, below launch overhead; this kernel
// is written to be right, not fast: no cp.async pipelining of the k/v
// tiles, no wgmma, no TMA, no warp specialisation.  Those are for a later
// change.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ray_tpu_torch/native/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kBlockM = 64;  // q rows per block (16 per warp)
constexpr int kBlockN = 64;  // k/v rows per tile; equal to kBlockM, which
                             // the causal tile arithmetic below relies on
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int H, int S, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                 int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                 int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss,
                 int64_t o_sh, float scale_log2, int causal) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kStride = D + 8;  // padded shared-memory row, in elements
  __shared__ __align__(16) __nv_bfloat16 sK[kBlockN * kStride];
  __shared__ __align__(16) __nv_bfloat16 sV[kBlockN * kStride];

  const int m_block = causal ? (gridDim.x - 1 - blockIdx.x) : blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in the group
  const int row0 = m_block * kBlockM + warp * 16 + g;  // rows row0, row0 + 8

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;

  // This warp's q rows as A fragments, read once from device memory.
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int col = kc * 16 + 2 * t;
    qf[kc][0] = load_pair(qb, row0, q_ss, col, S);
    qf[kc][1] = load_pair(qb, row0 + 8, q_ss, col, S);
    qf[kc][2] = load_pair(qb, row0, q_ss, col + 8, S);
    qf[kc][3] = load_pair(qb, row0 + 8, q_ss, col + 8, S);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // running max, base-2 units
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

  const int n_tiles = (S + kBlockN - 1) / kBlockN;
  const int n_end = causal ? min(n_tiles, m_block + 1) : n_tiles;

  for (int nb = 0; nb < n_end; ++nb) {
    const int n0 = nb * kBlockN;
    __syncthreads();  // every warp is done with the previous tile
    constexpr int kVecPerRow = D / 8;
#pragma unroll
    for (int i = tid; i < kBlockN * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0);
      uint4 vv = make_uint4(0, 0, 0, 0);
      if (n0 + r < S) {
        kv = *reinterpret_cast<const uint4*>(kb + (n0 + r) * k_ss + c);
        vv = *reinterpret_cast<const uint4*>(vb + (n0 + r) * v_ss + c);
      }
      *reinterpret_cast<uint4*>(&sK[r * kStride + c]) = kv;
      *reinterpret_cast<uint4*>(&sV[r * kStride + c]) = vv;
    }
    __syncthreads();

    // s = q k^T: 16 rows x 64 keys per warp, as 8 C fragments.
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const __nv_bfloat16* kp = &sK[(nt * 8 + g) * kStride + kc * 16 + 2 * t];
        mma_bf16(s[nt], qf[kc], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }

    const bool masked = (causal && nb == m_block) || (n0 + kBlockN > S);
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nt][i] *= scale_log2;
        if (masked) {
          const int col = n0 + nt * 8 + 2 * t + (i & 1);
          const int row = row0 + (i >= 2 ? 8 : 0);
          if (col >= S || (causal && col > row)) s[nt][i] = -INFINITY;
        }
      }
    }

    // online softmax: C fragment entries 0,1 are row row0, 2,3 row row0+8
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m_run[r];
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // a row with every score masked so far keeps m = -inf; subtract 0
      // then, so that exp2 gives 0 and not NaN
      const float m_use = mx == -INFINITY ? 0.f : mx;
      const float alpha = exp2f(m_run[r] - m_use);
      m_run[r] = mx;
      float rowsum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        s[nt][2 * r] = exp2f(s[nt][2 * r] - m_use);
        s[nt][2 * r + 1] = exp2f(s[nt][2 * r + 1] - m_use);
        rowsum += s[nt][2 * r] + s[nt][2 * r + 1];
      }
      l_run[r] = l_run[r] * alpha + rowsum;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        acc[dt][2 * r] *= alpha;
        acc[dt][2 * r + 1] *= alpha;
      }
    }

    // acc += p v: p's C fragments become A fragments, 16 keys at a time.
#pragma unroll
    for (int kc = 0; kc < kBlockN / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const int mi = lane >> 3;  // which of the four 8x8 matrices
      const int key = kc * 16 + (lane & 7) + (mi & 1) * 8;
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, &sV[key * kStride + dp * 16 + (mi >> 1) * 8]);
        mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }

  // finish: sum the row shares across the 4 threads of a row, normalise
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
            pack_bf16(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
      }
      if (t == 0) {
        lse[(static_cast<int64_t>(b) * H + h) * S + row] =
            m_run[r] * kLn2 + logf(l_safe);
      }
    }
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, void* o, float* lse,
            int B, int H, int S, const int64_t* st, float scale_log2,
            int causal, cudaStream_t stream) {
  const dim3 grid((S + kBlockM - 1) / kBlockM, H, B);
  flash_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, H, S, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], scale_log2, causal);
}

}  // namespace

// q, k, v, o: bf16 with unit stride along D, 16-byte aligned rows; strides
// in elements, (batch, seq, head) for q, k, v, o in that order (12 values).
// lse: f32 (B, H, S), contiguous.  scale_log2 = sm_scale * log2(e).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// head dim other than 32, 64 or 128).
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int H, int S, int D,
                              const int64_t* strides, float scale_log2,
                              int causal, void* stream) {
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      launch<32>(q, k, v, o, l, B, H, S, strides, scale_log2, causal, st);
      break;
    case 64:
      launch<64>(q, k, v, o, l, B, H, S, strides, scale_log2, causal, st);
      break;
    case 128:
      launch<128>(q, k, v, o, l, B, H, S, strides, scale_log2, causal, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
