// Causal FlashAttention-2 forward with a key-padding mask, for Hopper.
//
// Replaces the TPU kernel mla_tpu/ops/flash_attention.py::_fwd_kernel (:39),
// launched by _flash_fwd_impl (:183).
//
// What bounds it on an H100: at the serving prefill (32 heads, S = 534,
// head_dim 128, bf16) one layer moves ~17.5 MB of q, k, v and o (5.3 us at
// 3.35 TB/s) for ~2.3 GFLOP of causal work (2.4 us at 989 TFLOP/s), so it is
// bound by bytes; the score matrix never leaves the chip.  Design: one block per (batch*head, 64-query
// tile), four warps of 16 query rows each.  Key tiles of 64 rows stream
// through shared memory (K as stored, V transposed so the PV product reads
// it as the column operand); QK^T and PV run on mma.sync m16n8k16 bf16 with
// fp32 accumulators; the running max m, normalizer l and output acc stay in
// registers (online softmax).  P is rounded to bf16 before the PV product, as
// the TPU kernel does.  Key tiles strictly above the diagonal are skipped and
// the diagonal tile count is taken by ceil-div; the diagonal and ragged
// tiles are masked element by element.  Rows and keys past S are masked in
// the kernel, so the caller need not pad.  The log-sum-exp is written for the
// backward pass.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int HD>
__global__ void __launch_bounds__(128)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ Q, const __nv_bfloat16* __restrict__ K,
                 const __nv_bfloat16* __restrict__ V, const int* __restrict__ mask,
                 __nv_bfloat16* __restrict__ O, float* __restrict__ LSE, int S, float sm_scale) {
  constexpr int KP = HD + 8;   // padded row of the K tile (bank spread)
  constexpr int VP = BK + 8;   // padded row of the transposed V tile
  __shared__ __align__(16) __nv_bfloat16 Ks[BK][KP];
  __shared__ __align__(16) __nv_bfloat16 Vt[HD][VP];
  __shared__ int Ms[BK];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, qb = blockIdx.x;
  const size_t base = (size_t)bh * S * HD;
  const int row0 = qb * BQ + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const int rows[2] = {row0, row0 + 8};

  // Q fragments for the whole head dim, kept in registers
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int c = 0; c < HD / 16; ++c) {
    const int col = c * 16 + t * 2;
    qa[c][0] = rows[0] < S ? ld32(Q + base + (size_t)rows[0] * HD + col) : 0u;
    qa[c][1] = rows[1] < S ? ld32(Q + base + (size_t)rows[1] * HD + col) : 0u;
    qa[c][2] = rows[0] < S ? ld32(Q + base + (size_t)rows[0] * HD + col + 8) : 0u;
    qa[c][3] = rows[1] < S ? ld32(Q + base + (size_t)rows[1] * HD + col + 8) : 0u;
  }

  float o[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[d][r] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  const int nk_all = (S + BK - 1) / BK;
  const int nk = min(nk_all, ((qb + 1) * BQ + BK - 1) / BK);

  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();
    for (int i = tid; i < BK * (HD / 8); i += 128) {
      const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < S) {
        kv = *reinterpret_cast<const uint4*>(K + base + (size_t)(k0 + r) * HD + c);
        vv = *reinterpret_cast<const uint4*>(V + base + (size_t)(k0 + r) * HD + c);
      }
      *reinterpret_cast<uint4*>(&Ks[r][c]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[c + j][r] = ve[j];
    }
    if (tid < BK) Ms[tid] = (k0 + tid < S) ? mask[(size_t)bh * S + k0 + tid] : 0;
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) s[nt][r] = 0.f;
#pragma unroll
      for (int c = 0; c < HD / 16; ++c)
        mma_bf16(s[nt], qa[c], ld32(&Ks[nt * 8 + g][c * 16 + t * 2]),
                 ld32(&Ks[nt * 8 + g][c * 16 + 8 + t * 2]));
    }

    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kl = nt * 8 + t * 2 + (r & 1);
        const int row = rows[r >> 1];
        float v = s[nt][r] * sm_scale;
        if (Ms[kl] <= 0) v = NEG_INF;
        if (k0 + kl > row) v = NEG_INF;
        s[nt][r] = v;
        mx[r >> 1] = fmaxf(mx[r >> 1], v);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = expf(s[nt][r] - m[r >> 1]);
        s[nt][r] = p;
        sum[r >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = l[h] * alpha[h] + sum[h];
    }
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      o[d][0] *= alpha[0];
      o[d][1] *= alpha[0];
      o[d][2] *= alpha[1];
      o[d][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]), pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int d = 0; d < HD / 8; ++d)
        mma_bf16(o[d], pa, ld32(&Vt[d * 8 + g][j * 16 + t * 2]), ld32(&Vt[d * 8 + g][j * 16 + 8 + t * 2]));
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rows[h];
    if (row >= S) continue;
    const float l_safe = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      const int col = d * 8 + t * 2;
      *reinterpret_cast<__nv_bfloat162*>(O + base + (size_t)row * HD + col) =
          __floats2bfloat162_rn(o[d][2 * h] / l_safe, o[d][2 * h + 1] / l_safe);
    }
    if (t == 0) LSE[(size_t)bh * S + row] = m[h] + logf(l_safe);
  }
}

}  // namespace

// q, k, v, o bf16 [BH, S, hd] contiguous; mask int32 [BH, S] (> 0 = may be
// attended); lse fp32 [BH, S].  hd is 64 or 128.  Returns cudaGetLastError().
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const int* mask, void* o,
                         float* lse, int BH, int S, int hd, float sm_scale, void* stream) {
  dim3 grid((S + BQ - 1) / BQ, BH);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (hd == 128)
    flash_fwd_kernel<128><<<grid, 128, 0, s>>>(static_cast<const bf*>(q), static_cast<const bf*>(k),
                                                static_cast<const bf*>(v), mask, static_cast<bf*>(o),
                                                lse, S, sm_scale);
  else if (hd == 64)
    flash_fwd_kernel<64><<<grid, 128, 0, s>>>(static_cast<const bf*>(q), static_cast<const bf*>(k),
                                               static_cast<const bf*>(v), mask, static_cast<bf*>(o),
                                               lse, S, sm_scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
