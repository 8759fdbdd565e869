// Weight-only int8 linear for Hopper: y = (x @ float(w_q)) * w_scale, in x's
// dtype.  x [M, K] is bf16 or fp32, w_q int8 [K, N] (JAX's layout, the bytes
// contiguous along N), w_scale fp32 [N].
//
// Replaces the TPU kernel mla_tpu/ops/quantization.py::_int8_mm_kernel (:264),
// launched by int8_matmul (:298).  The int8 lm_head runs through it too, in
// fp32 (models/llama.lm_head_logits, JAX's formula).
//
// What bounds it on an H100.  At a decode step (M = 1, or B * K rows for
// beams) every weight byte serves a handful of rows: the product is bound by
// reading the int8 weights, 202.4 MB per mla-7b layer (0.060 ms at 3.35
// TB/s) and 131 MB for the lm_head (0.039 ms).  At the AR prefill (M = 535)
// it is bound by bf16 tensor-core operations, 216.6 GFLOP per layer (0.219
// ms at 989 TFLOP/s).  Two paths, chosen by the caller's plan
// (ops/quantization.int8_mm_plan):
//
//   narrow (fp32 x at any M; bf16 x up to 4 rows): a weight stream on the
//     CUDA cores.  A block owns a strip of output columns (256 for up to 4
//     rows, 128 for 8), a group of MR rows (1, 2, 4 or 8; more rows take
//     more row groups) and a range of K.  One producer thread keeps a 96 KB
//     TMA ring of 64-row weight tiles and the matching x tiles in flight.
//     Each of the 256 consumer threads takes 4 K rows x 16 (or 8) columns
//     of a stage into registers with one 16-byte load a row, releases the
//     slot, and widens the bytes without a float conversion per byte: byte
//     b, biased to b + 128 by one xor a word, is put by a byte permute into
//     the low mantissa byte of 2^23, and 2^23 + 128 is subtracted (exact).
//     Products and sums are fp32 FMAs.  The 16 K groups of a block are
//     added in a fixed order (warp shuffle, then shared memory).  K is split
//     over blocks where the strips alone fill the SMs poorly (the N = 4096
//     products).
//   wide (bf16 x above 4 rows): bf16 wgmma on the transposed product,
//     D[n][m] = sum_k W[k][n] x[m][k].  The widened weights are the
//     register-A operand, so they never return to shared memory: each warp
//     reads its 16 columns of the int8 tile (TMA, 128-byte swizzle) with
//     ldmatrix.trans as 8 x 8 matrices of byte pairs, which hand every lane
//     the K pairs of two columns, and widens them in registers while the
//     tensor cores multiply the stage before (A rows map to columns in the
//     order ldmatrix delivers them).  The x tile of up to 192 rows is the
//     K-major B operand (TMA, 128-byte swizzle), N = its rows: a tile is
//     128 columns (two consumer warpgroups of 64) by 64 MB rows, MB (1 to
//     3) the fewest 64-row blocks that cover M in the fewest tiles (3 for
//     the AR prefill), so one widened weight tile feeds up to 192 rows.  A
//     producer warp keeps a five-stage ring.  A weight tile's row tiles are
//     launched together (read from memory once, then from L2); where the
//     tiles fill the SMs in a poor number of waves, K is split.
//   split K (both paths): each block stores its fp32 partial sums and takes
//     a ticket; the block that takes its tile's last ticket adds the splits'
//     partials in split order (so two launches give the same bits), runs the
//     epilogue and puts the ticket back to zero (a CUDA graph can replay it).
//
// Numerics: exact products (int8 and bf16 values fit fp32; fp32 x rounds
// each FMA once), fp32 sums, then one __fmul_rn by w_scale and one rounding
// to x's dtype, as the TPU kernel does.  The output equals the plain
// version's up to the order of the sums, and every launch sums in the same
// order.  Ragged K and N read zeros from TMA; rows and columns past M and N
// are not stored.

#include "hopper.cuh"

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using namespace hopper;

constexpr int BK = 64;  // K rows of weights per ring stage, both paths
constexpr int W_TILE = BK * 128;  // the wide path's int8 weight tile: 64 K rows x 128 columns, 8 KB

constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 32;  // both paths: eight consumer warps and a producer warp

// 64-row blocks of x in a wide tile, at most: 96 accumulators a thread (a
// fourth block's 128 would spill; ptxas budgets a wgmma kernel's registers
// per whole warpgroup)
constexpr int WIDE_MAX_MB = 3;
constexpr int WIDE_BN = 128, WIDE_STAGES = 5;
constexpr uint32_t WIDE_X_BYTES = WIDE_MAX_MB * 64 * BK * 2;  // a ring slot: bf16, up to 192 rows of 128 bytes

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// The K tiles [x, y) of split `split` of `splits`.
__device__ __forceinline__ int2 split_range(int K, int split, int splits) {
  const int kt = (K + BK - 1) / BK;
  return make_int2(split * kt / splits, (split + 1) * kt / splits);
}

// Four int8 (one word, byte 0 first) -> four exact floats.
__device__ __forceinline__ void widen4(uint32_t word, float* f) {
  const uint32_t u = word ^ 0x80808080u;  // b + 128, as an unsigned byte
  f[0] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)), 8388736.0f);
  f[1] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)), 8388736.0f);
  f[2] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)), 8388736.0f);
  f[3] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)), 8388736.0f);
}

// Two floats that hold small integers -> a bf16 pair (the upper halves: exact).
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// x values k..k+3 of one row of a stage's x tile, as floats.
__device__ __forceinline__ void load_x4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load_x4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16), v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16), v[3] = __uint_as_float(q.y & 0xffff0000u);
}

__device__ __forceinline__ void store_out(float* y, size_t i, float v) { y[i] = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* y, size_t i, float v) { y[i] = __float2bfloat16_rn(v); }

// Split K, in three steps.  Every block stores its partial sums
// (store_partials: float4 vectors v0.. of each consumer thread, consecutive
// threads on consecutive addresses, in the block's slot of `part`), then
// takes a ticket of its tile (last_split: true in the block that takes the
// last one, which puts the ticket back to zero for the next launch), and
// that block adds the partials of all splits in split order (add_partials),
// so two launches give the same bits.  A slot holds V float4 per thread.
template <int R>
__device__ __forceinline__ void store_partials(const float (&acc)[R], float* part, size_t slot, int v0, int ctid) {
  float4* p = reinterpret_cast<float4*>(part) + slot + ctid;
#pragma unroll
  for (int i = 0; i < R / 4; ++i)
    __stcg(p + (size_t)(v0 + i) * CONSUMERS, make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]));
}

__device__ __forceinline__ bool last_split(int* __restrict__ tickets, int tile, int splits, int ctid, int* last) {
  __threadfence();
  named_sync(1, CONSUMERS);
  if (ctid == 0) *last = atomicAdd(tickets + tile, 1) == splits - 1;
  named_sync(1, CONSUMERS);
  if (!*last) return false;
  __threadfence();
  if (ctid == 0) tickets[tile] = 0;  // every split has taken its ticket
  return true;
}

template <int R>
__device__ __forceinline__ void add_partials(float (&acc)[R], const float* part, size_t slot0, size_t stride,
                                             int splits, int v0, int ctid) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float4* p = reinterpret_cast<const float4*>(part) + slot0 + s * stride + ctid;
#pragma unroll
    for (int i = 0; i < R / 4; ++i) {
      const float4 v = __ldcg(p + (size_t)(v0 + i) * CONSUMERS);
      acc[4 * i] += v.x;
      acc[4 * i + 1] += v.y;
      acc[4 * i + 2] += v.z;
      acc[4 * i + 3] += v.w;
    }
  }
}

// ---- narrow path: the weight stream on the CUDA cores ----

constexpr int NARROW_RING = 96 * 1024;  // weight bytes a block keeps in flight

// A narrow block of MR rows: each consumer thread takes CPT columns (one
// 16-byte load a K row up to 4 rows; 8 columns for 8 rows, for registers),
// so a block owns 16 x CPT output columns.
template <int MR>
struct Narrow {
  static constexpr int CPT = MR <= 4 ? 16 : 8;
  static constexpr int COLS = 16 * CPT;
  static constexpr int W_BYTES = BK * COLS;
  static constexpr int STAGES = NARROW_RING / W_BYTES;
  static constexpr int MIN_BLOCKS = MR * CPT <= 32 ? 2 : 1;  // blocks an SM, as the registers allow
};

template <int MR, typename T>
constexpr size_t narrow_smem_bytes() {
  return 1024 + (size_t)Narrow<MR>::STAGES * (Narrow<MR>::W_BYTES + MR * BK * sizeof(T)) +
         2 * Narrow<MR>::STAGES * 8;
}

// Block (strip, split, row group) computes rows m0 .. m0 + MR - 1 of the
// COLS output columns n0.. over its share of K.  Consumer thread (kg, cg)
// takes K rows 4 kg .. 4 kg + 3 of each stage and columns CPT cg ..
template <int MR, typename T>
__global__ void __launch_bounds__(THREADS, Narrow<MR>::MIN_BLOCKS)
int8_mm_narrow(const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tx,
               const float* __restrict__ ws, T* __restrict__ y, float* __restrict__ part, int* __restrict__ tickets,
               int M, int N, int K, int splits) {
  constexpr int CPT = Narrow<MR>::CPT, COLS = Narrow<MR>::COLS, STAGES = Narrow<MR>::STAGES;
  constexpr uint32_t W_BYTES = Narrow<MR>::W_BYTES, X_BYTES = MR * BK * sizeof(T);
  constexpr int OUT = MR * COLS;  // outputs of a block
  constexpr int PER = (OUT + CONSUMERS - 1) / CONSUMERS;
  static_assert(PER <= 4, "a thread holds at most four outputs");
  extern __shared__ unsigned char smem_raw[];
  __shared__ int last;
  unsigned char* base = align1024(smem_raw);
  const uint32_t sW0 = smem_u32(base), sX0 = sW0 + STAGES * W_BYTES;
  const uint32_t full0 = sX0 + STAGES * X_BYTES, empty0 = full0 + STAGES * 8;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile = blockIdx.z * gridDim.x + blockIdx.x, split = blockIdx.y;
  const int n0 = blockIdx.x * COLS, m0 = blockIdx.z * MR;
  const int2 kr = split_range(K, split, splits);
  const int nk = kr.y - kr.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS / 32);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {  // producer warp
    if (lane == 0) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty0 + 8 * s, ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, W_BYTES + X_BYTES);
        tma_load_2d(sW0 + s * W_BYTES, &tw, full0 + 8 * s, n0, (kr.x + i) * BK);
        tma_load_2d(sX0 + s * X_BYTES, &tx, full0 + 8 * s, (kr.x + i) * BK, m0);
      }
    }
    return;
  }

  const int kg = tid >> 4, cg = tid & 15;
  float acc[MR][CPT];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[m][j] = 0.f;

  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    mbar_wait(full0 + 8 * s, (i / STAGES) & 1);
    const unsigned char* wt = base + s * W_BYTES + (4 * kg) * COLS + CPT * cg;
    uint32_t wv[4][CPT / 4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if constexpr (CPT == 16) {
        const uint4 u = *reinterpret_cast<const uint4*>(wt + r * COLS);
        wv[r][0] = u.x, wv[r][1] = u.y, wv[r][2] = u.z, wv[r][3] = u.w;
      } else {
        const uint2 u = *reinterpret_cast<const uint2*>(wt + r * COLS);
        wv[r][0] = u.x, wv[r][1] = u.y;
      }
    }
    const T* xt = reinterpret_cast<const T*>(base + STAGES * W_BYTES + s * X_BYTES) + 4 * kg;
    float xv[MR][4];
#pragma unroll
    for (int m = 0; m < MR; ++m) load_x4(xt + m * BK, xv[m]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);  // the stage is in registers: the producer may refill it
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < CPT / 4; ++q) {
        float f[4];
        widen4(wv[r][q], f);
#pragma unroll
        for (int m = 0; m < MR; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][4 * q + e] = fmaf(xv[m][r], f[e], acc[m][4 * q + e]);
      }
  }

  // the two K groups of a warp (lanes l and l + 16); a + b == b + a, so
  // both lanes hold the same sum
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], 16);
  named_sync(1, CONSUMERS);  // every consumer is past the ring, which is now free
  float* red = reinterpret_cast<float*>(base);  // [warp][MR][COLS]
  if (lane < 16) {
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int q = 0; q < CPT / 4; ++q)
        reinterpret_cast<float4*>(red + (warp * MR + m) * COLS + CPT * cg)[q] =
            make_float4(acc[m][4 * q], acc[m][4 * q + 1], acc[m][4 * q + 2], acc[m][4 * q + 3]);
  }
  named_sync(1, CONSUMERS);
  // output o = m * COLS + c: thread tid holds o = tid + 256 q, the warps'
  // sums added in warp order
  float v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int o = tid + CONSUMERS * q;
    float a = 0.f;
    if (q < PER && o < OUT) {
      a = red[o];
#pragma unroll
      for (int w = 1; w < CONSUMERS / 32; ++w) a += red[w * OUT + o];
    }
    v[q] = a;
  }
  if (splits > 1) {  // the partials, PER per thread padded to one float4 (V = 1)
    store_partials(v, part, (size_t)(tile * splits + split) * CONSUMERS, 0, tid);
    if (!last_split(tickets, tile, splits, tid, &last)) return;
    add_partials(v, part, (size_t)tile * splits * CONSUMERS, CONSUMERS, splits, 0, tid);
  }
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int o = tid + CONSUMERS * q;
    const int m = m0 + o / COLS, n = n0 + o % COLS;
    if (o < OUT && m < M && n < N) store_out(y, (size_t)m * N + n, __fmul_rn(v[q], ws[n]));
  }
}

// ---- wide path: bf16 wgmma, the weights widened in registers ----

constexpr size_t wide_smem_bytes() {
  return 1024 + (size_t)WIDE_STAGES * (WIDE_X_BYTES + W_TILE) + 2 * WIDE_STAGES * 8;
}

// The A fragments of one stage (four k16 steps) of this warp's 16 weight
// columns, widened to bf16 pairs.  The int8 tile (64 K rows of 128 bytes,
// 128-byte swizzled) is read through ldmatrix.trans as 8 x 8 matrices of
// byte pairs: lane 4g + t receives columns (2g, 2g + 1) of K rows 2t and
// 2t + 1 of each.  A row g of the warp's block is column 2g, A row g + 8
// column 2g + 1, so each matrix register gives one A register of each row.
__device__ __forceinline__ void widen_a(uint32_t (&a)[4][4], uint32_t sw, int col16, int lane) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {  // k16 steps 2p and 2p + 1
    // matrix q = lane / 8: k16 step 2p + q / 2, K rows (q % 2) * 8 .. + 7
    const int q = lane >> 3, k = (2 * p + (q >> 1)) * 16 + (q & 1) * 8 + (lane & 7);
    uint32_t r[4];
    ldsm_x4_trans(r, sw + k * 128 + ((col16 ^ (k & 7)) << 4));
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      float f[4];  // (k 2t, col 2g), (k 2t, col 2g + 1), (k 2t + 1, col 2g), (k 2t + 1, col 2g + 1)
      widen4(r[h], f);
      uint32_t* dst = a[2 * p + (h >> 1)] + 2 * (h & 1);
      dst[0] = bf16_pair(f[0], f[2]);  // A row g: K rows 2t, 2t + 1 (+ 8 for the second matrix)
      dst[1] = bf16_pair(f[1], f[3]);  // A row g + 8
    }
  }
}

// Block (tile, split) computes the output tile of 128 columns from n0 and
// 64 MB rows from m0 over its share of K, as the transposed product
// D[n][m] = sum_k W[k][n] x[m][k]: the weights are wgmma's register-A
// operand (warpgroup wg's 64 columns n0 + 64 wg .., warp w's 16 of them),
// the x tile its K-major B operand (N = 64 MB).  A warp's A rows map to
// columns in the order ldmatrix.trans delivers them: row 16 w + g + 8 h is
// column n0 + 64 wg + 16 w + 2 g + h.
template <int MB>
__global__ void __launch_bounds__(THREADS, 1)
int8_mm_wide(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
             const float* __restrict__ ws, __nv_bfloat16* __restrict__ y, float* __restrict__ part,
             int* __restrict__ tickets, int M, int N, int K, int splits) {
  constexpr int ROWS = 64 * MB, R = ROWS / 2;  // x rows (wgmma's N) and accumulators per thread
  constexpr uint32_t X_BYTES = ROWS * BK * 2;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int last;
  unsigned char* base = align1024(smem_raw);
  const uint32_t sX0 = smem_u32(base), sW0 = sX0 + WIDE_STAGES * WIDE_X_BYTES;
  const uint32_t full0 = sW0 + WIDE_STAGES * W_TILE, empty0 = full0 + WIDE_STAGES * 8;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mtiles = (M + ROWS - 1) / ROWS;
  const int tile = blockIdx.x, split = blockIdx.y;
  const int m0 = (tile % mtiles) * ROWS, n0 = (tile / mtiles) * WIDE_BN;  // a weight tile's row tiles together
  const int2 kr = split_range(K, split, splits);
  const int nk = kr.y - kr.x;

  if (tid == 0) {
    for (int s = 0; s < WIDE_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS / 32);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {  // producer warp
    if (lane == 0) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % WIDE_STAGES;
        if (i >= WIDE_STAGES) mbar_wait(empty0 + 8 * s, ((i / WIDE_STAGES) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, X_BYTES + W_TILE);
        tma_load_2d(sX0 + s * WIDE_X_BYTES, &tx, full0 + 8 * s, (kr.x + i) * BK, m0);
        tma_load_2d(sW0 + s * W_TILE, &tw, full0 + 8 * s, n0, (kr.x + i) * BK);
      }
    }
    return;
  }

  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  const int col16 = 4 * wg + w;  // this warp's 16-byte column chunk of the weight tile
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  uint32_t a[4][4], next[4][4];
  if (nk > 0) {
    mbar_wait(full0, 0);
    widen_a(a, sW0, col16, lane);
  }
  for (int i = 0; i < nk; ++i) {
    const int s = i % WIDE_STAGES;
    const uint32_t sX = sX0 + s * WIDE_X_BYTES;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs_kb(acc, a[kk], desc_sw128(sX + kk * 32, 16, 1024));
    wg_commit();
    if (i + 1 < nk) {  // widen the next stage's weights while the tensor cores run
      const int s1 = (i + 1) % WIDE_STAGES;
      mbar_wait(full0 + 8 * s1, ((i + 1) / WIDE_STAGES) & 1);
      widen_a(next, sW0 + s1 * W_TILE, col16, lane);
    }
    wg_wait_all();
    // the products read a until here: keep it live, so that the compiler
    // cannot give its registers to next while they are in flight
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[kk][e])::"memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[kk][e] = next[kk][e];
  }
  reg_fence(acc);
  if (splits > 1) {  // R / 4 float4 vectors per thread
    const size_t stride = (size_t)(R / 4) * CONSUMERS;
    store_partials(acc, part, (tile * splits + split) * stride, 0, tid);
    if (!last_split(tickets, tile, splits, tid, &last)) return;
    add_partials(acc, part, tile * splits * stride, stride, splits, 0, tid);
  }
  // this thread holds D[n][m0 + 8 j + 2 t + e] in acc[4 j + 2 h + e] for
  // n = n0 + 64 wg + 16 w + 2 g + h: columns n and n + 1 of one output row
  const int n = n0 + 64 * wg + 16 * w + 2 * g;
  if (n >= N) return;
  const float s0 = ws[n], s1 = ws[n + 1];
#pragma unroll
  for (int j = 0; j < R / 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * j + 2 * t + e;
      if (m < M)
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)m * N + n) =
            __floats2bfloat162_rn(__fmul_rn(acc[4 * j + e], s0), __fmul_rn(acc[4 * j + 2 + e], s1));
    }
}

// ---- launches ----

template <typename T>
constexpr CUtensorMapDataType map_type() {
  return sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

template <int MR, typename T>
int launch_narrow(const void* x, const int8_t* wq, const float* ws, void* y, float* part, int* tickets, int M, int K,
                  int N, int splits, cudaStream_t stream) {
  constexpr int COLS = Narrow<MR>::COLS;
  CUtensorMap tw, tx;
  if (!make_map_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wq, N, K, COLS, BK, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map_2d(&tx, map_type<T>(), sizeof(T), x, K, M, BK, MR, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = narrow_smem_bytes<MR, T>();
  static bool smem_allowed = false;  // raised once, not at every launch
  if (!smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(int8_mm_narrow<MR, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = true;
  }
  const dim3 grid((N + COLS - 1) / COLS, splits, (M + MR - 1) / MR);
  int8_mm_narrow<MR, T><<<grid, THREADS, smem, stream>>>(tw, tx, ws, static_cast<T*>(y), part, tickets, M, N, K,
                                                          splits);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_narrow_rows(const void* x, const int8_t* wq, const float* ws, void* y, float* part, int* tickets, int M,
                       int K, int N, int splits, cudaStream_t stream) {
  if (M <= 1) return launch_narrow<1, T>(x, wq, ws, y, part, tickets, M, K, N, splits, stream);
  if (M <= 2) return launch_narrow<2, T>(x, wq, ws, y, part, tickets, M, K, N, splits, stream);
  if (M <= 4) return launch_narrow<4, T>(x, wq, ws, y, part, tickets, M, K, N, splits, stream);
  return launch_narrow<8, T>(x, wq, ws, y, part, tickets, M, K, N, splits, stream);
}

template <int MB>
int launch_wide(const void* x, const int8_t* wq, const float* ws, void* y, float* part, int* tickets, int M, int K,
                int N, int splits, cudaStream_t stream) {
  CUtensorMap tx, tw;
  if (!make_map_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, K, M, BK, 64 * MB, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wq, N, K, WIDE_BN, BK, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = wide_smem_bytes();
  static bool smem_allowed = false;
  if (!smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(int8_mm_wide<MB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = true;
  }
  const dim3 grid(((M + 64 * MB - 1) / (64 * MB)) * ((N + WIDE_BN - 1) / WIDE_BN), splits);
  int8_mm_wide<MB><<<grid, THREADS, smem, stream>>>(tx, tw, ws, static_cast<__nv_bfloat16*>(y), part, tickets, M, N,
                                                    K, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, K] (x_dtype 0 = float32, 1 = bfloat16), wq int8 [K, N], ws fp32 [N],
// y [M, N] in x's dtype.  wide = 1 takes the wgmma path (bf16 x only), 0 the
// weight stream.  splits > 1 splits K over that many blocks per output
// tile (at most one per 64 K rows): part is fp32 scratch of tiles x splits
// x 1024 floats (narrow: ceil(N / 128) x ceil(M / MR) tiles, MR the row
// group of 1, 2, 4 or 8 that M picks) or tiles x splits x 256 x 64 (wide:
// ceil(M / 128) x ceil(N / 128) tiles), and tickets int32 [tiles] must be
// zero and is left zero.  Requires M >= 1, K and N multiples of 16, x and
// wq 16-byte aligned.  Returns the launch's error code.
extern "C" int int8_mm(const void* x, int x_dtype, const int8_t* wq, const float* ws, void* y, float* part,
                       int* tickets, int M, int K, int N, int wide, int splits, void* stream) {
  if (M < 1 || K < 16 || K % 16 != 0 || N < 16 || N % 16 != 0 || splits < 1 || splits > (K + BK - 1) / BK ||
      (splits > 1 && (part == nullptr || tickets == nullptr)) || wide < 0 || wide > WIDE_MAX_MB ||
      (wide && x_dtype != 1) || (reinterpret_cast<uintptr_t>(x) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(wq) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide == 1) return launch_wide<1>(x, wq, ws, y, part, tickets, M, K, N, splits, s);
  if (wide == 2) return launch_wide<2>(x, wq, ws, y, part, tickets, M, K, N, splits, s);
  if (wide == 3) return launch_wide<3>(x, wq, ws, y, part, tickets, M, K, N, splits, s);
  if (x_dtype == 0) return launch_narrow_rows<float>(x, wq, ws, y, part, tickets, M, K, N, splits, s);
  return launch_narrow_rows<__nv_bfloat16>(x, wq, ws, y, part, tickets, M, K, N, splits, s);
}
