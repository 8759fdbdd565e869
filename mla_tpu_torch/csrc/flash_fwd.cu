// Causal FlashAttention forward with a key-padding mask, for Hopper.
//
// Replaces the TPU kernel mla_tpu/ops/flash_attention.py::_fwd_kernel (:39),
// launched by _flash_fwd_impl (:183).
//
// What bounds it on an H100: bytes.  At the mla-2b training shape (BH 256,
// S 563, head_dim 128, bf16) it moves q, k, v and o (4 x 37 MB) and the mask
// and lse: 0.044 ms at 3.35 TB/s, against ~10 GFLOP of causal products,
// about half that time at 989 TFLOP/s; at the serving prefill (BH 32,
// S 534) 0.005 ms.  The score matrix never leaves the chip.  At these short
// sequences a block runs only a few key tiles, so what a block spends
// before its first product (barrier set-up, the Q and first K loads, the
// mask scan) weighs as much as the products: the design keeps three blocks
// on each SM, so one block's start overlaps the others' work.
//
// Design (the layouts are in hopper.cuh):
//   - One block per (batch*head, 64-query tile): one consumer warpgroup and
//     one producer warp, three blocks per SM.  blockIdx.x walks a head's
//     query tiles from the last, so the longest causal loops start first
//     and the blocks running together share a head's K and V in L2.  (Tiles
//     of 128 rows on two consumer warpgroups, one block per SM, measured
//     slower at both the serving and the training shape.)
//   - The producer warp loads the query tile once and streams 64-key tiles
//     of K and V with TMA (3-D tensor maps, so the ragged tail of a head
//     reads zeros, never the next head's rows) through a ring each, with
//     full and empty mbarriers: two slots for K, released as soon as S is
//     formed, so the next K tile loads during the softmax and P V; one for
//     V, which keeps a block at 64 KB of shared memory.  While the first
//     tiles load, the consumer warps scan the key mask into one flag per
//     key tile.
//   - S = Q K^T on wgmma m64n64k16 with Q and K K-major in shared memory as
//     stored; O += P V on wgmma m64n{hd}k16 with P from registers, converted
//     in place from S's accumulator and rounded to bf16 as the TPU kernel
//     does, and V read MN-major through the transpose bit: no copy of V is
//     transposed.
//   - The online softmax keeps fp32 scores, running max and normalizer in
//     registers, in log2 units (log2 e folded into the scale, exp2f); lse is
//     written in natural-log units for the dQ kernel.  l is clamped at 1e-30.
//   - Masks only where needed: the key mask, keys past S and the causal
//     triangle are applied only on the diagonal tile and on tiles whose flag
//     says they hold a padded key or a key past S.
//   - O leaves through shared memory (the query tile's slots, free by then)
//     in the swizzled layout of a TMA box, one bulk store per 64 columns:
//     whole 128-byte rows instead of 4-byte stores, and rows past S are
//     clipped by the tensor map.

#include "hopper.cuh"

#include <math.h>

namespace {

using namespace hopper;

constexpr int BM = 64;      // query rows per block: one consumer warpgroup
constexpr int BN = 64;      // keys per tile
constexpr int KST = 2;      // depth of the K ring
constexpr int VST = 1;      // depth of the V ring
constexpr int THREADS = 128 + 32;
constexpr int BLOCKS_PER_SM = 3;  // 64 KB of shared memory and <= 128 registers a thread
constexpr float NEG_INF = -1e30f;

template <int HD>
constexpr size_t fwd_smem_bytes(int nk_all) {
  return 1024 + (size_t)(HD / 64) * 128 * (BM + (KST + VST) * BN) + (2 * KST + 2 * VST + 1) * 8 + nk_all;
}

// The online softmax of key tile kb's raw scores sc: updates the running
// max m and normalizer l (log2 units), gives O's rescale factor alpha and P
// as bf16 A fragments.  The mask is applied only on the diagonal tile and on
// tiles with a padded key or a key past S (ok false).
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2], uint32_t (&pa)[BN / 16][4], float (&alpha)[2],
                                             float (&m)[2], float (&l)[2], int kb, bool ok, int q0,
                                             const int (&rows)[2], int t, const int* mask_row, int S,
                                             float scale_log2) {
  const int k0 = kb * BN;
  float mx[2] = {NEG_INF, NEG_INF};
  if (ok && k0 + BN - 1 <= q0) {  // wholly below the diagonal: nothing to mask
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      sc[i] *= scale_log2;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + j * 8 + t * 2 + e;
        const bool kv = ok || (key < S && mask_row[key] > 0);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& v = sc[j * 4 + h * 2 + e];
          v = (kv && key <= rows[h]) ? v * scale_log2 : NEG_INF;
          mx[h] = fmaxf(mx[h], v);
        }
      }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    alpha[h] = exp2f(m[h] - m_new);
    m[h] = m_new;
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int h = (i >> 1) & 1;
    sc[i] = exp2f(sc[i] - m[h]);
    sum[h] += sc[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    l[h] = l[h] * alpha[h] + sum[h];
  }
#pragma unroll
  for (int c = 0; c < BN / 16; ++c) acc_to_a(pa[c], &sc[8 * c], &sc[8 * c + 4]);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                 const int* __restrict__ mask, float* __restrict__ LSE, int S, float scale_log2) {
  constexpr int NCB = HD / 64;
  constexpr uint32_t Q_BYTES = NCB * BM * 128, KV_BYTES = NCB * BN * 128;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sK0 = sQ + Q_BYTES, sV0 = sK0 + KST * KV_BYTES;  // the K and V rings
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Q_BYTES + (KST + VST) * KV_BYTES);
  const uint32_t fullK = smem_u32(bars), emptyK = fullK + KST * 8, fullV = emptyK + KST * 8,
                 emptyV = fullV + VST * 8, qbar = emptyV + VST * 8;
  signed char* tile_ok = reinterpret_cast<signed char*>(bars + 2 * KST + 2 * VST + 1);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y;
  const int q0 = ((S + BM - 1) / BM - 1 - (int)blockIdx.x) * BM;  // the longest causal loop first
  const int nk_all = (S + BN - 1) / BN;
  const int nk = min(nk_all, (q0 + BM + BN - 1) / BN);
  const int* mask_row = mask + (size_t)bh * S;

  if (tid == 0) {
    for (int s = 0; s < KST; ++s) {
      mbar_init(fullK + 8 * s, 1);
      mbar_init(emptyK + 8 * s, 4);  // one arrival per consumer warp
    }
    for (int s = 0; s < VST; ++s) {
      mbar_init(fullV + 8 * s, 1);
      mbar_init(emptyV + 8 * s, 4);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {  // producer warp
    if (lane == 0) {
      mbar_expect_tx(qbar, Q_BYTES);
      for (int c = 0; c < NCB; ++c) tma_load_3d(sQ + c * BM * 128, &tq, qbar, c * 64, q0, bh);
      for (int kb = 0; kb < nk; ++kb) {  // a slot is reused once the consumers release it
        const int sk = kb % KST, sv = kb % VST;
        mbar_wait(emptyK + 8 * sk, ((kb / KST) & 1) ^ 1);
        mbar_expect_tx(fullK + 8 * sk, KV_BYTES);
        for (int c = 0; c < NCB; ++c)
          tma_load_3d(sK0 + sk * KV_BYTES + c * BN * 128, &tk, fullK + 8 * sk, c * 64, kb * BN, bh);
        mbar_wait(emptyV + 8 * sv, ((kb / VST) & 1) ^ 1);
        mbar_expect_tx(fullV + 8 * sv, KV_BYTES);
        for (int c = 0; c < NCB; ++c)
          tma_load_3d(sV0 + sv * KV_BYTES + c * BN * 128, &tv, fullV + 8 * sv, c * 64, kb * BN, bh);
      }
    }
    return;
  }

  // consumer warpgroup: query rows q0 .. q0 + 63; this thread's rows rows[0]
  // and rows[1] (warp w holds 16)
  const int w = warp, g = lane >> 2, t = lane & 3;
  const int rows[2] = {q0 + w * 16 + g, q0 + w * 16 + g + 8};

  // one flag per key tile, scanned while the first tiles load: every key of
  // it lies below S and may be attended.  A warp takes every fourth tile,
  // four tiles' loads in flight at once.
  for (int kb0 = w; kb0 < nk; kb0 += 16) {
    int ok[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      ok[u] = 1;
#pragma unroll
      for (int j = 0; j < BN; j += 32) {
        const int key = (kb0 + 4 * u) * BN + j + lane;
        ok[u] &= key < S && mask_row[key] > 0;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int all = __all_sync(0xffffffffu, ok[u]);
      if (lane == 0 && kb0 + 4 * u < nk) tile_ok[kb0 + 4 * u] = all;
    }
  }
  asm volatile("bar.sync 1, 128;\n" ::: "memory");  // the four consumer warps

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  uint32_t pa[BN / 16][4];  // P, bf16 A fragments
  mbar_wait(qbar, 0);

  for (int kb = 0; kb < nk; ++kb) {
    const int sk = kb % KST, sv = kb % VST;
    const uint32_t sK = sK0 + sk * KV_BYTES, sV = sV0 + sv * KV_BYTES;
    float sc[BN / 2], alpha[2];
    mbar_wait(fullK + 8 * sk, (kb / KST) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      wgmma_ss(sc, desc_sw128(sQ + (kk >> 2) * BM * 128 + off, 16, 1024),
               desc_sw128(sK + (kk >> 2) * BN * 128 + off, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    reg_fence(sc);
    __syncwarp();
    if (lane == 0) mbar_arrive(emptyK + 8 * sk);  // the next K tile may load while P V runs
    softmax_tile(sc, pa, alpha, m, l, kb, tile_ok[kb], q0, rows, t, mask_row, S, scale_log2);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    mbar_wait(fullV + 8 * sv, (kb / VST) & 1);
    wg_fence();
#pragma unroll
    for (int c = 0; c < BN / 16; ++c) wgmma_rs(o, pa[c], desc_sw128(sV + c * 16 * 128, BN * 128, 1024));
    wg_commit();
    wg_wait_all();
    reg_fence(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(emptyV + 8 * sv);
  }

  // O through shared memory (the Q tile's slots, free now) and out by TMA,
  // in the 128-byte-swizzled layout of the tensor map's box; rows past S
  // are not written
  unsigned char* so = smem;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = w * 16 + g + h * 8;
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(so + (j >> 3) * BM * 128 + r * 128 + (((j & 7) ^ (r & 7)) << 4) + t * 4) =
          __floats2bfloat162_rn(o[j * 4 + h * 2] * inv, o[j * 4 + h * 2 + 1] * inv);
    if (t == 0 && rows[h] < S) LSE[(size_t)bh * S + rows[h]] = (m[h] + log2f(fmaxf(l[h], 1e-30f))) * LN2;
  }
  fence_proxy_async();
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
  if (tid == 0) {
    for (int c = 0; c < NCB; ++c) tma_store_3d(&to, sQ + c * BM * 128, c * 64, q0, bh);
    tma_store_wait();
  }
}

template <int HD>
int launch_fwd(const void* q, const void* k, const void* v, const int* mask, void* o, float* lse, int BH, int S,
               float sm_scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  if (!make_map(&tq, q, HD, S, BH, BM) || !make_map(&tk, k, HD, S, BH, BN) || !make_map(&tv, v, HD, S, BH, BN) ||
      !make_map(&to, o, HD, S, BH, BM))
    return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem_bytes<HD>((S + BN - 1) / BN);
  static size_t smem_allowed = 0;  // raised once per size, not at every launch
  if (smem > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  const dim3 grid((S + BM - 1) / BM, BH);
  flash_fwd_kernel<HD><<<grid, THREADS, smem, stream>>>(tq, tk, tv, to, mask, lse, S, sm_scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o bf16 [BH, S, hd] contiguous; mask int32 [BH, S] (> 0 = may be
// attended); lse fp32 [BH, S].  hd is 64 or 128.  Returns cudaGetLastError().
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const int* mask, void* o, float* lse, int BH,
                         int S, int hd, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128) return launch_fwd<128>(q, k, v, mask, o, lse, BH, S, sm_scale, s);
  if (hd == 64) return launch_fwd<64>(q, k, v, mask, o, lse, BH, S, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
