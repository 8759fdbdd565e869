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
//   dQ:    one block per (batch*head, 64-query tile): one consumer
//          warpgroup and a producer warp, two blocks per SM; a head's query
//          tiles are launched together (K and V stay in L2), the longest
//          causal loop first.  Q and dO are loaded once by TMA and stay in
//          shared memory, lse and delta in registers; 64-key tiles of K and
//          V stream through two-stage TMA rings (3-D tensor maps: the ragged
//          tail reads zeros) up to the diagonal tile (ceil-div), as
//          _bwd_dq_kernel loops.  S = Q K^T and dP = dO V^T run on wgmma
//          with both operands K-major as stored; dS, converted in registers
//          from the accumulators, is the A operand of dQ += dS K, with K
//          read MN-major through the transpose bit: no transposed copy.  The
//          key mask is scanned into one flag per key tile while the first
//          tiles load, and masks apply only on the diagonal tile and tiles
//          with a padded key or a key past S.  dQ leaves through the Q slot
//          by TMA store (rows past S clipped).
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

constexpr int DQ_BM = 64;      // dQ: query rows per block, one consumer warpgroup
constexpr int DQ_BN = 64;      // dQ: keys per tile
constexpr int DQ_STAGES = 2;   // dQ: depth of the K and V rings
constexpr int DQ_THREADS = 128 + 32;

template <int HD>
constexpr size_t dq_smem_bytes(int nk_all) {
  return 1024 + (size_t)(HD / 64) * 128 * (2 * DQ_BM + 2 * DQ_STAGES * DQ_BN) + (4 * DQ_STAGES + 1) * 8 + nk_all;
}

template <int HD>
__global__ void __launch_bounds__(DQ_THREADS, 2)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tdq, const int* __restrict__ mask,
                    const float* __restrict__ LSE, const float* __restrict__ Delta, int S, float sm_scale) {
  using namespace hopper;
  constexpr int NCB = HD / 64;
  constexpr uint32_t Q_BYTES = NCB * DQ_BM * 128, KV_BYTES = NCB * DQ_BN * 128;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sQ = smem_u32(smem), sD = sQ + Q_BYTES;
  const uint32_t sK0 = sD + Q_BYTES, sV0 = sK0 + DQ_STAGES * KV_BYTES;  // the K and V rings
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 2 * Q_BYTES + 2 * DQ_STAGES * KV_BYTES);
  const uint32_t fullK = smem_u32(bars), emptyK = fullK + DQ_STAGES * 8, fullV = emptyK + DQ_STAGES * 8,
                 emptyV = fullV + DQ_STAGES * 8, qbar = emptyV + DQ_STAGES * 8;
  signed char* tile_ok = reinterpret_cast<signed char*>(bars + 4 * DQ_STAGES + 1);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y;
  const int q0 = ((S + DQ_BM - 1) / DQ_BM - 1 - (int)blockIdx.x) * DQ_BM;  // the longest causal loop first
  const int nk_all = (S + DQ_BN - 1) / DQ_BN;
  const int nk = min(nk_all, (q0 + DQ_BM + DQ_BN - 1) / DQ_BN);
  const int* mask_row = mask + (size_t)bh * S;

  if (tid == 0) {
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(fullK + 8 * s, 1);
      mbar_init(emptyK + 8 * s, 4);  // one arrival per consumer warp
      mbar_init(fullV + 8 * s, 1);
      mbar_init(emptyV + 8 * s, 4);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {  // producer warp
    if (lane == 0) {
      mbar_expect_tx(qbar, 2 * Q_BYTES);
      for (int c = 0; c < NCB; ++c) {
        tma_load_3d(sQ + c * DQ_BM * 128, &tq, qbar, c * 64, q0, bh);
        tma_load_3d(sD + c * DQ_BM * 128, &tdo, qbar, c * 64, q0, bh);
      }
      for (int kb = 0; kb < nk; ++kb) {  // a slot is reused once the consumers release it
        const int s = kb % DQ_STAGES;
        const uint32_t ph = ((kb / DQ_STAGES) & 1) ^ 1;
        mbar_wait(emptyK + 8 * s, ph);
        mbar_expect_tx(fullK + 8 * s, KV_BYTES);
        for (int c = 0; c < NCB; ++c)
          tma_load_3d(sK0 + s * KV_BYTES + c * DQ_BN * 128, &tk, fullK + 8 * s, c * 64, kb * DQ_BN, bh);
        mbar_wait(emptyV + 8 * s, ph);
        mbar_expect_tx(fullV + 8 * s, KV_BYTES);
        for (int c = 0; c < NCB; ++c)
          tma_load_3d(sV0 + s * KV_BYTES + c * DQ_BN * 128, &tv, fullV + 8 * s, c * 64, kb * DQ_BN, bh);
      }
    }
    return;
  }

  // consumer warpgroup: query rows q0 .. q0 + 63; this thread's rows rows[0]
  // and rows[1] (warp w holds 16)
  const int w = warp, g = lane >> 2, t = lane & 3;
  const int rows[2] = {q0 + w * 16 + g, q0 + w * 16 + g + 8};

  // one flag per key tile, scanned while the first tiles load: every key of
  // it lies below S and may be attended
  for (int kb0 = w; kb0 < nk; kb0 += 16) {
    int ok[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      ok[u] = 1;
#pragma unroll
      for (int j = 0; j < DQ_BN; j += 32) {
        const int key = (kb0 + 4 * u) * DQ_BN + j + lane;
        ok[u] &= key < S && mask_row[key] > 0;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int all = __all_sync(0xffffffffu, ok[u]);
      if (lane == 0 && kb0 + 4 * u < nk) tile_ok[kb0 + 4 * u] = all;
    }
  }
  named_sync(1, 128);  // the four consumer warps

  // lse in log2 units and delta of this thread's rows (0 past S, where Q
  // and dO read zeros, so dS is 0 there)
  const float scale_log2 = sm_scale * LOG2E;
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse2[h] = rows[h] < S ? LSE[(size_t)bh * S + rows[h]] * LOG2E : 0.f;
    dl[h] = rows[h] < S ? Delta[(size_t)bh * S + rows[h]] : 0.f;
  }
  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
  mbar_wait(qbar, 0);

  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % DQ_STAGES, k0 = kb * DQ_BN;
    const uint32_t ph = (kb / DQ_STAGES) & 1;
    const uint32_t sK = sK0 + s * KV_BYTES, sV = sV0 + s * KV_BYTES;
    // S = Q K^T and dP = dO V^T: 64 queries x 64 keys, all K-major as stored
    float sc[DQ_BN / 2], dp[DQ_BN / 2];
    mbar_wait(fullK + 8 * s, ph);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      wgmma_ss(sc, desc_sw128(sQ + (kk >> 2) * DQ_BM * 128 + off, 16, 1024),
               desc_sw128(sK + (kk >> 2) * DQ_BN * 128 + off, 16, 1024), kk > 0);
    }
    mbar_wait(fullV + 8 * s, ph);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      wgmma_ss(dp, desc_sw128(sD + (kk >> 2) * DQ_BM * 128 + off, 16, 1024),
               desc_sw128(sV + (kk >> 2) * DQ_BN * 128 + off, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    reg_fence(sc);
    reg_fence(dp);
    __syncwarp();
    if (lane == 0) mbar_arrive(emptyV + 8 * s);  // the next V tile may load while dQ is formed

    // P = exp(s - lse) and dS = P (dP - delta) scale; the key mask, keys
    // past S and the causal triangle only on the diagonal and flagged tiles
    const bool edge = !tile_ok[kb] || k0 + DQ_BN - 1 > q0;
#pragma unroll
    for (int j = 0; j < DQ_BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + j * 8 + t * 2 + e;
        const bool kv = !edge || (key < S && mask_row[key] > 0);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = j * 4 + h * 2 + e;
          float p = exp2f(sc[i] * scale_log2 - lse2[h]);
          if (edge && !(kv && key <= rows[h])) p = 0.f;
          dp[i] = p * (dp[i] - dl[h]) * sm_scale;
        }
      }

    // dQ += dS K: dS rounded to bf16 from the accumulator, K read MN-major
    // through the transpose bit
    uint32_t da[DQ_BN / 16][4];
#pragma unroll
    for (int c = 0; c < DQ_BN / 16; ++c) acc_to_a(da[c], &dp[8 * c], &dp[8 * c + 4]);
    wg_fence();
#pragma unroll
    for (int c = 0; c < DQ_BN / 16; ++c) wgmma_rs(dq, da[c], desc_sw128(sK + c * 16 * 128, DQ_BN * 128, 1024));
    wg_commit();
    wg_wait_all();
    reg_fence(dq);
    __syncwarp();
    if (lane == 0) mbar_arrive(emptyK + 8 * s);
  }

  // dQ through shared memory (the Q slot, which no product reads any more)
  // and out by TMA, in the 128-byte-swizzled layout of the tensor map's
  // box; rows past S are not written
  named_sync(1, 128);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = w * 16 + g + h * 8;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(smem + (j >> 3) * DQ_BM * 128 + r * 128 + (((j & 7) ^ (r & 7)) << 4) + t * 4) =
          __floats2bfloat162_rn(dq[j * 4 + h * 2], dq[j * 4 + h * 2 + 1]);
  }
  fence_proxy_async();
  named_sync(1, 128);
  if (tid == 0) {
    for (int c = 0; c < NCB; ++c) tma_store_3d(&tdq, sQ + c * DQ_BM * 128, c * 64, q0, bh);
    tma_store_wait();
  }
}

template <int HD>
int launch_dq(const void* q, const void* k, const void* v, const int* mask, const void* dout, const float* lse,
              const float* delta, void* dq, int BH, int S, float sm_scale, cudaStream_t s) {
  CUtensorMap tq, tk, tv, tdo, tdq;
  if (!make_map(&tq, q, HD, S, BH, DQ_BM) || !make_map(&tdo, dout, HD, S, BH, DQ_BM) ||
      !make_map(&tk, k, HD, S, BH, DQ_BN) || !make_map(&tv, v, HD, S, BH, DQ_BN) ||
      !make_map(&tdq, dq, HD, S, BH, DQ_BM))
    return (int)cudaErrorInvalidValue;
  const size_t smem = dq_smem_bytes<HD>((S + DQ_BN - 1) / DQ_BN);
  static size_t smem_allowed = 0;  // raised once per size, not at every launch
  if (smem > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  const dim3 grid((S + DQ_BM - 1) / DQ_BM, BH);
  flash_bwd_dq_kernel<HD><<<grid, DQ_THREADS, smem, s>>>(tq, tk, tv, tdo, tdq, mask, lse, delta, S, sm_scale);
  return (int)cudaGetLastError();
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128) return launch_dq<128>(q, k, v, mask, dout, lse, delta, dq, BH, S, sm_scale, s);
  if (hd == 64) return launch_dq<64>(q, k, v, mask, dout, lse, delta, dq, BH, S, sm_scale, s);
  return (int)cudaErrorInvalidValue;
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
