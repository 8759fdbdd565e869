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
// product accumulates in fp32 (mma.sync m16n8k16 bf16), and the gradients
// are written in bf16.  The work is split as the TPU kernels split it, so
// no two blocks write the same output and no atomics are needed: two runs
// give bit-identical gradients.
//   dQ:    one block per (batch*head, 64-query tile), four warps of 16 rows.
//          Q and dO fragments stay in registers; 32-key tiles of K (as
//          stored and transposed) and V stream through shared memory, up to
//          the diagonal tile (ceil-div), as _bwd_dq_kernel loops.
//   dK/dV: one block per (batch*head, 64-key tile), four warps of 16 keys.
//          K and V stay in shared memory; 32-query tiles of Q and dO (as
//          stored and transposed), lse and delta stream from the first
//          query tile that can see the key tile to the end, as
//          _bwd_dkv_kernel loops.  S^T = K Q^T and dP^T = V dO^T are formed
//          per warp, so P^T and dS^T feed dV += P^T dO and dK += dS^T Q
//          straight from the accumulators.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;    // dQ: query rows per block
constexpr int BKQ = 32;   // dQ: key rows per step
constexpr int BKV = 64;   // dK/dV: key rows per block
constexpr int BQKV = 32;  // dK/dV: query rows per step
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

template <int HD>
constexpr size_t dkv_smem_bytes() {
  return (size_t)(2 * BKV + 2 * BQKV) * (HD + 8) * sizeof(bf16) + (size_t)2 * HD * (BQKV + 8) * sizeof(bf16) +
         (size_t)2 * BQKV * sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(128)
flash_bwd_dkv_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ K, const bf16* __restrict__ V,
                     const int* __restrict__ mask, const bf16* __restrict__ dO, const float* __restrict__ LSE,
                     const float* __restrict__ Delta, bf16* __restrict__ dK, bf16* __restrict__ dV, int S,
                     float sm_scale) {
  constexpr int KP = HD + 8;
  constexpr int TP = BQKV + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16(*Ks)[KP] = reinterpret_cast<bf16(*)[KP]>(smem);  // [BKV][KP] this block's keys
  bf16(*Vs)[KP] = Ks + BKV;                             // [BKV][KP] their values
  bf16(*Qs)[KP] = Vs + BKV;                             // [BQKV][KP] query tile
  bf16(*Ds)[KP] = Qs + BQKV;                            // [BQKV][KP] dO tile
  bf16(*Qt)[TP] = reinterpret_cast<bf16(*)[TP]>(Ds + BQKV);  // [HD][TP] query tile transposed
  bf16(*Dt)[TP] = Qt + HD;                                   // [HD][TP] dO tile transposed
  float* Ls = reinterpret_cast<float*>(Dt + HD);             // [BQKV] lse of the tile's rows
  float* Dl = Ls + BQKV;                                     // [BQKV] delta of the tile's rows

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, k_off = blockIdx.x * BKV;
  const size_t base = (size_t)bh * S * HD;
  const int wr = warp * 16;  // this warp's first key row in the tile
  const int krows[2] = {k_off + wr + g, k_off + wr + g + 8};
  bool kvalid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) kvalid[h] = krows[h] < S && mask[(size_t)bh * S + krows[h]] > 0;

  load_tile<BKV, HD, true, false, KP, TP>(K + base, k_off, S, Ks, Qt);
  load_tile<BKV, HD, true, false, KP, TP>(V + base, k_off, S, Vs, Qt);

  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int r = 0; r < 4; ++r) dk[d][r] = dv[d][r] = 0.f;

  const int nq = (S + BQKV - 1) / BQKV;
  for (int qb = k_off / BQKV; qb < nq; ++qb) {
    const int q0 = qb * BQKV;
    __syncthreads();
    load_tile<BQKV, HD, true, true, KP, TP>(Q + base, q0, S, Qs, Qt);
    load_tile<BQKV, HD, true, true, KP, TP>(dO + base, q0, S, Ds, Dt);
    if (tid < BQKV) {
      Ls[tid] = q0 + tid < S ? LSE[(size_t)bh * S + q0 + tid] : 0.f;
      Dl[tid] = q0 + tid < S ? Delta[(size_t)bh * S + q0 + tid] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x BQKV queries
    float st[BQKV / 8][4], dpt[BQKV / 8][4];
#pragma unroll
    for (int nt = 0; nt < BQKV / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) st[nt][r] = dpt[nt][r] = 0.f;
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) {
      const int col = c * 16 + t * 2;
      const uint32_t ka[4] = {ld32(&Ks[wr + g][col]), ld32(&Ks[wr + g + 8][col]), ld32(&Ks[wr + g][col + 8]),
                              ld32(&Ks[wr + g + 8][col + 8])};
      const uint32_t va[4] = {ld32(&Vs[wr + g][col]), ld32(&Vs[wr + g + 8][col]), ld32(&Vs[wr + g][col + 8]),
                              ld32(&Vs[wr + g + 8][col + 8])};
#pragma unroll
      for (int nt = 0; nt < BQKV / 8; ++nt) {
        mma_bf16(st[nt], ka, ld32(&Qs[nt * 8 + g][col]), ld32(&Qs[nt * 8 + g][col + 8]));
        mma_bf16(dpt[nt], va, ld32(&Ds[nt * 8 + g][col]), ld32(&Ds[nt * 8 + g][col + 8]));
      }
    }

#pragma unroll
    for (int nt = 0; nt < BQKV / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ql = nt * 8 + t * 2 + (r & 1), h = r >> 1;
        float v = st[nt][r] * sm_scale;
        if (!kvalid[h]) v = NEG_INF;
        if (krows[h] > q0 + ql) v = NEG_INF;
        const float p = q0 + ql < S ? expf(v - Ls[ql]) : 0.f;
        dpt[nt][r] = p * (dpt[nt][r] - Dl[ql]) * sm_scale;  // dS^T
        st[nt][r] = p;                                      // P^T
      }

#pragma unroll
    for (int j = 0; j < BQKV / 16; ++j) {
      uint32_t pa[4], sa[4];
      acc_to_a(pa, st[2 * j], st[2 * j + 1]);
      acc_to_a(sa, dpt[2 * j], dpt[2 * j + 1]);
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        const int n = d * 8 + g, kk = j * 16 + t * 2;
        mma_bf16(dv[d], pa, ld32(&Dt[n][kk]), ld32(&Dt[n][kk + 8]));
        mma_bf16(dk[d], sa, ld32(&Qt[n][kk]), ld32(&Qt[n][kk + 8]));
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (krows[h] >= S) continue;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      const size_t off = base + (size_t)krows[h] * HD + d * 8 + t * 2;
      *reinterpret_cast<__nv_bfloat162*>(dK + off) = __floats2bfloat162_rn(dk[d][2 * h], dk[d][2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dV + off) = __floats2bfloat162_rn(dv[d][2 * h], dv[d][2 * h + 1]);
    }
  }
}

template <int HD>
int launch_dkv(const bf16* q, const bf16* k, const bf16* v, const int* mask, const bf16* dout, const float* lse,
               const float* delta, bf16* dk, bf16* dv, int BH, int S, float sm_scale, cudaStream_t s) {
  constexpr size_t smem = dkv_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BKV - 1) / BKV, BH);
  flash_bwd_dkv_kernel<HD><<<grid, 128, smem, s>>>(q, k, v, mask, dout, lse, delta, dk, dv, S, sm_scale);
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
  const bf16 *Q = static_cast<const bf16*>(q), *K = static_cast<const bf16*>(k), *V = static_cast<const bf16*>(v),
             *D = static_cast<const bf16*>(dout);
  if (hd == 128)
    return launch_dkv<128>(Q, K, V, mask, D, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), BH, S,
                           sm_scale, s);
  if (hd == 64)
    return launch_dkv<64>(Q, K, V, mask, D, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), BH, S,
                          sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
