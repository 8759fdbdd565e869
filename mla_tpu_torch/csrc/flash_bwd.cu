// Causal FlashAttention-2 backward with a key-padding mask, for Hopper:
// dQ (flash_bwd_dq) and dK/dV (flash_bwd_dkv).
//
// Replaces the TPU kernels mla_tpu/ops/flash_attention.py::_bwd_dq_kernel
// (:92) and ::_bwd_dkv_kernel (:127), launched by _flash_bwd (:216, :234).
//
// What bounds it on an H100: at the mla-2b training shape (BH = 256,
// S = 563, head_dim 128, bf16) the pair must read q, k, v, dO and write dQ,
// dK, dV (7 x 37 MB) and read o's summary lse and delta (1 MB): ~0.26 GB,
// 0.08 ms at 3.35 TB/s, against ~52 GFLOP of causal products (S, dP, dQ,
// dK, dV), 0.05 ms at 989 TFLOP/s.  So the least time is set by bytes; the
// score and probability tiles never leave the chip.
//
// Design.  P is recomputed from the forward's log-sum-exp, p = exp(s - lse),
// with the forward's masking (key padding, the causal triangle, keys and
// rows past S masked here, so the caller need not pad).  dS = P * (dP -
// delta) * scale, delta = rowsum(dO * O) from the caller.  As in the TPU
// kernels, P and dS are rounded to bf16 before they enter a product, every
// product accumulates in fp32, and the gradients are written in bf16.  The
// work is split as the TPU kernels split it, so no two blocks write the
// same output and no atomics are needed: two runs give bit-identical
// gradients.
//   dQ:    one block per (batch*head, 64-query tile), four warps of 16 rows,
//          mma.sync m16n8k16.  Q and dO fragments stay in registers; 32-key
//          tiles of K (as stored and transposed) and V stream through shared
//          memory, up to the diagonal tile (ceil-div), as _bwd_dq_kernel
//          loops.
//   dK/dV: one block per (batch*head, 128-key tile); a head's key tiles
//          are launched together (Q and dO stay in L2), the first, with the
//          longest query loop, first.  Two consumer warpgroups of 64 keys
//          and a producer warpgroup, which hands its registers to them
//          (setmaxnreg) and of which one warp loads.  K and V are loaded
//          once by TMA and stay in shared memory; 64-query tiles of Q and dO
//          stream through a three-stage TMA ring (3-D tensor maps: the
//          ragged tail reads zeros), with lse and delta stored beside them
//          by the producer warp, from the first query tile that can see the
//          key tile to the end, as _bwd_dkv_kernel loops.  All four products run
//          on wgmma (layouts in hopper.cuh) and read every operand as
//          stored: S^T = K Q^T and dP^T = V dO^T with both operands K-major;
//          dV += P^T dO and dK += dS^T Q with P^T and dS^T converted in
//          registers from the accumulators just computed, dO and Q read
//          MN-major through the transpose bit.  Each warpgroup keeps its dK
//          and dV (64 x hd fp32 each) in registers.  The causal triangle and
//          queries past S are masked on the diagonal and ragged tiles only;
//          a padded key zeroes its own row.  dK and dV leave through the K
//          and V slots by TMA store (whole 128-byte rows; rows past S are
//          clipped by the tensor map).

#include "hopper.cuh"

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;    // dQ: query rows per block
constexpr int BKQ = 32;   // dQ: key rows per step
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

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragments (16 rows x HD) of a [S, HD] matrix for rows r[0], r[1] (= r[0] + 8);
// rows past S read as zero.
template <int HD>
__device__ __forceinline__ void load_frags(uint32_t (&a)[HD / 16][4], const bf16* __restrict__ src,
                                           const int (&r)[2], int S, int t) {
#pragma unroll
  for (int c = 0; c < HD / 16; ++c) {
    const int col = c * 16 + t * 2;
    a[c][0] = r[0] < S ? ld32(src + (size_t)r[0] * HD + col) : 0u;
    a[c][1] = r[1] < S ? ld32(src + (size_t)r[1] * HD + col) : 0u;
    a[c][2] = r[0] < S ? ld32(src + (size_t)r[0] * HD + col + 8) : 0u;
    a[c][3] = r[1] < S ? ld32(src + (size_t)r[1] * HD + col + 8) : 0u;
  }
}

// Rows [r0, r0 + ROWS) of a [S, HD] matrix into shared memory: as stored into
// `rm` (if ROW) and transposed into `tr` (if TRANS).  Rows past S are zero.
template <int ROWS, int HD, bool ROW, bool TRANS, int RP, int TP>
__device__ __forceinline__ void load_tile(const bf16* __restrict__ src, int r0, int S, bf16 (*rm)[RP],
                                          bf16 (*tr)[TP]) {
  for (int i = threadIdx.x; i < ROWS * (HD / 8); i += blockDim.x) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < S) v = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * HD + c);
    if (ROW) *reinterpret_cast<uint4*>(&rm[r][c]) = v;
    if (TRANS) {
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) tr[c + j][r] = e[j];
    }
  }
}

// A fragment of a 16 x 16 chunk j from two adjacent n-tiles of accumulators,
// rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4], const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

template <int HD>
__global__ void __launch_bounds__(128)
flash_bwd_dq_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ K, const bf16* __restrict__ V,
                    const int* __restrict__ mask, const bf16* __restrict__ dO, const float* __restrict__ LSE,
                    const float* __restrict__ Delta, bf16* __restrict__ dQ, int S, float sm_scale) {
  constexpr int KP = HD + 8;   // padded row of the K and V tiles (bank spread)
  constexpr int TP = BKQ + 8;  // padded row of the transposed K tile
  __shared__ __align__(16) bf16 Ks[BKQ][KP];
  __shared__ __align__(16) bf16 Vs[BKQ][KP];
  __shared__ __align__(16) bf16 Kt[HD][TP];
  __shared__ int Ms[BKQ];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, qb = blockIdx.x;
  const size_t base = (size_t)bh * S * HD;
  const int row0 = qb * BQ + warp * 16 + g;
  const int rows[2] = {row0, row0 + 8};

  uint32_t qa[HD / 16][4], da[HD / 16][4];
  load_frags<HD>(qa, Q + base, rows, S, t);
  load_frags<HD>(da, dO + base, rows, S, t);
  float lse[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse[h] = rows[h] < S ? LSE[(size_t)bh * S + rows[h]] : 0.f;
    dl[h] = rows[h] < S ? Delta[(size_t)bh * S + rows[h]] : 0.f;
  }

  float dq[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int r = 0; r < 4; ++r) dq[d][r] = 0.f;

  const int nk = min((S + BKQ - 1) / BKQ, ((qb + 1) * BQ + BKQ - 1) / BKQ);
  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * BKQ;
    __syncthreads();
    load_tile<BKQ, HD, true, true, KP, TP>(K + base, k0, S, Ks, Kt);
    load_tile<BKQ, HD, true, false, KP, TP>(V + base, k0, S, Vs, Kt);
    if (tid < BKQ) Ms[tid] = (k0 + tid < S) ? mask[(size_t)bh * S + k0 + tid] : 0;
    __syncthreads();

    float s[BKQ / 8][4], dp[BKQ / 8][4];
#pragma unroll
    for (int nt = 0; nt < BKQ / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[nt][r] = dp[nt][r] = 0.f;
#pragma unroll
    for (int c = 0; c < HD / 16; ++c)
#pragma unroll
      for (int nt = 0; nt < BKQ / 8; ++nt) {
        const int kr = nt * 8 + g, col = c * 16 + t * 2;
        mma_bf16(s[nt], qa[c], ld32(&Ks[kr][col]), ld32(&Ks[kr][col + 8]));
        mma_bf16(dp[nt], da[c], ld32(&Vs[kr][col]), ld32(&Vs[kr][col + 8]));
      }

#pragma unroll
    for (int nt = 0; nt < BKQ / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kl = nt * 8 + t * 2 + (r & 1), h = r >> 1;
        float v = s[nt][r] * sm_scale;
        if (Ms[kl] <= 0) v = NEG_INF;
        if (k0 + kl > rows[h]) v = NEG_INF;
        const float p = expf(v - lse[h]);
        s[nt][r] = p * (dp[nt][r] - dl[h]) * sm_scale;  // dS, rounded to bf16 below
      }

#pragma unroll
    for (int j = 0; j < BKQ / 16; ++j) {
      uint32_t sa[4];
      acc_to_a(sa, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int d = 0; d < HD / 8; ++d)
        mma_bf16(dq[d], sa, ld32(&Kt[d * 8 + g][j * 16 + t * 2]), ld32(&Kt[d * 8 + g][j * 16 + 8 + t * 2]));
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= S) continue;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<__nv_bfloat162*>(dQ + base + (size_t)rows[h] * HD + d * 8 + t * 2) =
          __floats2bfloat162_rn(dq[d][2 * h], dq[d][2 * h + 1]);
  }
}

constexpr int KV_BK = 128;    // dK/dV: key rows per block, two warpgroups of 64
constexpr int KV_QS = 64;     // dK/dV: query rows per step of the ring
constexpr int KV_STAGES = 3;  // dK/dV: ring depth

template <int HD>
constexpr size_t dkv_smem_bytes() {
  return 1024 + (size_t)(HD / 64) * 128 * (2 * KV_BK + 2 * KV_STAGES * KV_QS) +
         (size_t)KV_STAGES * 2 * KV_QS * sizeof(float) + (2 * KV_STAGES + 1) * 8;
}

template <int HD>
__global__ void __launch_bounds__(3 * 128, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tdk, const __grid_constant__ CUtensorMap tdv,
                     const int* __restrict__ mask, const float* __restrict__ LSE, const float* __restrict__ Delta,
                     int S, float sm_scale) {
  using namespace hopper;
  constexpr int NCB = HD / 64;
  constexpr uint32_t KV_BYTES = NCB * KV_BK * 128, QT_BYTES = NCB * KV_QS * 128;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sK = smem_u32(smem), sV = sK + KV_BYTES;
  const uint32_t sRing = sV + KV_BYTES;  // stage s: Q at sRing + 2 s QT_BYTES, dO QT_BYTES later
  float* rowv = reinterpret_cast<float*>(smem + 2 * KV_BYTES + 2 * KV_STAGES * QT_BYTES);  // stage s: lse log2 e, delta
  uint64_t* bars = reinterpret_cast<uint64_t*>(rowv + KV_STAGES * 2 * KV_QS);
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + KV_STAGES * 8, kvbar = full0 + 2 * KV_STAGES * 8;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, k_off = blockIdx.x * KV_BK;
  const int qb0 = k_off / KV_QS;  // the first query tile that can see a key of the block
  const int nq = (S + KV_QS - 1) / KV_QS;

  if (tid == 0) {
    for (int s = 0; s < KV_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1 + 32);  // the TMA bytes, and the producer warp's lse/delta stores
      mbar_init(empty0 + 8 * s, 2 * 4);
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup: warp 8 loads, the group gives its registers to the consumers
    setmaxnreg_dec<24>();
    if (warp > 8) return;
    if (lane == 0) {
      mbar_expect_tx(kvbar, 2 * KV_BYTES);
      for (int c = 0; c < NCB; ++c) {
        tma_load_3d(sK + c * KV_BK * 128, &tk, kvbar, c * 64, k_off, bh);
        tma_load_3d(sV + c * KV_BK * 128, &tv, kvbar, c * 64, k_off, bh);
      }
    }
    for (int i = 0; qb0 + i < nq; ++i) {
      const int s = i % KV_STAGES, q0 = (qb0 + i) * KV_QS;
      mbar_wait(empty0 + 8 * s, ((i / KV_STAGES) & 1) ^ 1);
      const uint32_t full = full0 + 8 * s, sQ = sRing + 2 * s * QT_BYTES;
      if (lane == 0) {
        mbar_expect_tx(full, 2 * QT_BYTES);
        for (int c = 0; c < NCB; ++c) {
          tma_load_3d(sQ + c * KV_QS * 128, &tq, full, c * 64, q0, bh);
          tma_load_3d(sQ + QT_BYTES + c * KV_QS * 128, &tdo, full, c * 64, q0, bh);
        }
      }
      float* rv = rowv + s * 2 * KV_QS;
      for (int j = lane; j < KV_QS; j += 32) {
        const int q = q0 + j;
        rv[j] = q < S ? LSE[(size_t)bh * S + q] * LOG2E : 0.f;
        rv[KV_QS + j] = q < S ? Delta[(size_t)bh * S + q] : 0.f;
      }
      mbar_arrive(full);
    }
    return;
  }

  setmaxnreg_inc<240>();
  // consumer warpgroup wg: keys kw0 .. kw0 + 63; this thread's keys krows[0]
  // and krows[1] (warp w of the group holds 16)
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  const int kw0 = k_off + wg * 64;
  const int krows[2] = {kw0 + w * 16 + g, kw0 + w * 16 + g + 8};
  bool kvalid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) kvalid[h] = krows[h] < S && mask[(size_t)bh * S + krows[h]] > 0;
  const float scale_log2 = sm_scale * LOG2E;

  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(kvbar, 0);

  for (int i = 0; qb0 + i < nq; ++i) {
    const int s = i % KV_STAGES, q0 = (qb0 + i) * KV_QS;
    mbar_wait(full0 + 8 * s, (i / KV_STAGES) & 1);
    if (kw0 < S && q0 + KV_QS - 1 >= kw0) {  // some query of the tile sees a key of the group
      const uint32_t sQ = sRing + 2 * s * QT_BYTES, sD = sQ + QT_BYTES;
      // S^T = K Q^T and dP^T = V dO^T: 64 keys x KV_QS queries, all K-major as stored
      float st[KV_QS / 2], dpt[KV_QS / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t a = (kk >> 2) * KV_BK * 128 + wg * 64 * 128 + (kk & 3) * 32;
        const uint32_t b = (kk >> 2) * KV_QS * 128 + (kk & 3) * 32;
        wgmma_ss(st, desc_sw128(sK + a, 16, 1024), desc_sw128(sQ + b, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t a = (kk >> 2) * KV_BK * 128 + wg * 64 * 128 + (kk & 3) * 32;
        const uint32_t b = (kk >> 2) * KV_QS * 128 + (kk & 3) * 32;
        wgmma_ss(dpt, desc_sw128(sV + a, 16, 1024), desc_sw128(sD + b, 16, 1024), kk > 0);
      }
      wg_commit();
      wg_wait_all();
      reg_fence(st);
      reg_fence(dpt);

      // P^T = exp(s - lse) and dS^T = P^T (dP^T - delta) scale; the causal
      // triangle and queries past S only on the diagonal and ragged tiles
      const float* rv = rowv + s * 2 * KV_QS;
      const bool edge = q0 < kw0 + 63 || q0 + KV_QS > S;
#pragma unroll
      for (int j = 0; j < KV_QS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ql = j * 8 + t * 2 + e, q = q0 + ql;
          const float L = rv[ql], D = rv[KV_QS + ql];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i2 = j * 4 + h * 2 + e;
            float p = kvalid[h] ? exp2f(st[i2] * scale_log2 - L) : 0.f;
            if (edge && (krows[h] > q || q >= S)) p = 0.f;
            dpt[i2] = p * (dpt[i2] - D) * sm_scale;
            st[i2] = p;
          }
        }

      // dV += P^T dO and dK += dS^T Q: P^T and dS^T rounded to bf16 from the
      // accumulators, dO and Q read MN-major through the transpose bit
      uint32_t pa[KV_QS / 16][4], sa[KV_QS / 16][4];
#pragma unroll
      for (int c = 0; c < KV_QS / 16; ++c) {
        hopper::acc_to_a(pa[c], &st[8 * c], &st[8 * c + 4]);
        hopper::acc_to_a(sa[c], &dpt[8 * c], &dpt[8 * c + 4]);
      }
      wg_fence();
#pragma unroll
      for (int c = 0; c < KV_QS / 16; ++c) wgmma_rs(dv, pa[c], desc_sw128(sD + c * 16 * 128, KV_QS * 128, 1024));
#pragma unroll
      for (int c = 0; c < KV_QS / 16; ++c) wgmma_rs(dk, sa[c], desc_sw128(sQ + c * 16 * 128, KV_QS * 128, 1024));
      wg_commit();
      wg_wait_all();
      reg_fence(dk);
      reg_fence(dv);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

  // dK and dV through shared memory (the K and V slots, whose rows only
  // this warpgroup read) and out by TMA; rows past S are not written
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wg * 64 + w * 16 + g + h * 8;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const uint32_t off = (j >> 3) * KV_BK * 128 + r * 128 + (((j & 7) ^ (r & 7)) << 4) + t * 4;
      *reinterpret_cast<__nv_bfloat162*>(smem + off) = __floats2bfloat162_rn(dk[j * 4 + h * 2], dk[j * 4 + h * 2 + 1]);
      *reinterpret_cast<__nv_bfloat162*>(smem + KV_BYTES + off) =
          __floats2bfloat162_rn(dv[j * 4 + h * 2], dv[j * 4 + h * 2 + 1]);
    }
  }
  fence_proxy_async();
  asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the eight consumer warps
  if (tid == 0) {
    for (int c = 0; c < NCB; ++c) {
      tma_store_3d(&tdk, sK + c * KV_BK * 128, c * 64, k_off, bh);
      tma_store_3d(&tdv, sV + c * KV_BK * 128, c * 64, k_off, bh);
    }
    tma_store_wait();
  }
}

template <int HD>
int launch_dkv(const void* q, const void* k, const void* v, const int* mask, const void* dout, const float* lse,
               const float* delta, bf16* dk, bf16* dv, int BH, int S, float sm_scale, cudaStream_t s) {
  CUtensorMap tq, tk, tv, tdo, tdk, tdv;
  if (!make_map(&tq, q, HD, S, BH, KV_QS) || !make_map(&tdo, dout, HD, S, BH, KV_QS) ||
      !make_map(&tk, k, HD, S, BH, KV_BK) || !make_map(&tv, v, HD, S, BH, KV_BK) ||
      !make_map(&tdk, dk, HD, S, BH, KV_BK) || !make_map(&tdv, dv, HD, S, BH, KV_BK))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = dkv_smem_bytes<HD>();
  static bool smem_allowed = false;  // raised once, not at every launch
  if (!smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = true;
  }
  // a head's key tiles together (Q and dO stay in L2), the first, with the
  // longest query loop, first
  const dim3 grid((S + KV_BK - 1) / KV_BK, BH);
  flash_bwd_dkv_kernel<HD><<<grid, 3 * 128, smem, s>>>(tq, tk, tv, tdo, tdk, tdv, mask, lse, delta, S, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, dout, dq bf16 [BH, S, hd] contiguous; mask int32 [BH, S] (> 0 =
// may be attended); lse and delta fp32 [BH, S].  hd is 64 or 128.
// Returns cudaGetLastError().
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const int* mask, const void* dout,
                            const float* lse, const float* delta, void* dq, int BH, int S, int hd, float sm_scale,
                            void* stream) {
  dim3 grid((S + BQ - 1) / BQ, BH);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *Q = static_cast<const bf16*>(q), *K = static_cast<const bf16*>(k), *V = static_cast<const bf16*>(v),
             *D = static_cast<const bf16*>(dout);
  if (hd == 128)
    flash_bwd_dq_kernel<128><<<grid, 128, 0, s>>>(Q, K, V, mask, D, lse, delta, static_cast<bf16*>(dq), S, sm_scale);
  else if (hd == 64)
    flash_bwd_dq_kernel<64><<<grid, 128, 0, s>>>(Q, K, V, mask, D, lse, delta, static_cast<bf16*>(dq), S, sm_scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The same inputs; dk, dv bf16 [BH, S, hd].  Returns cudaGetLastError().
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const int* mask, const void* dout,
                             const float* lse, const float* delta, void* dk, void* dv, int BH, int S, int hd,
                             float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16 *dK = static_cast<bf16*>(dk), *dV = static_cast<bf16*>(dv);
  if (hd == 128) return launch_dkv<128>(q, k, v, mask, dout, lse, delta, dK, dV, BH, S, sm_scale, s);
  if (hd == 64) return launch_dkv<64>(q, k, v, mask, dout, lse, delta, dK, dV, BH, S, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
