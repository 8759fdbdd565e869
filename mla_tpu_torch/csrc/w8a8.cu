// Fused W8A8 linear for Hopper: per-row dynamic int8 activation quantization,
// an int8 x int8 -> int32 tensor-core product, and the fp32 rescale.
//
// Replaces the TPU kernel mla_tpu/ops/quantization.py::_w8a8_kernel (:347),
// launched by w8a8_matmul (:383).
//
// What bounds it on an H100.  At the suffix shapes of the int8 mla-7b
// (M = 18 rows) every weight byte serves 18 rows only: the product is bound
// by reading the int8 weights (0.060 ms a layer at 3.35 TB/s).  At the
// prefill (M = 534) it is bound by int8 tensor-core operations (0.109 ms a
// layer at 1979 TOP/s).  int8 wgmma reads both operands K-major from shared
// memory (the transpose bits exist only for 16-bit types), so the kernel
// takes the weight K-major, wt [N, K], a copy built once with the serving
// tree; JAX's [K, N] layout is not read here.
//
// Design (the layouts are in hopper.cuh):
//   pass 1 (quant_rows): one block per row computes amax, the scale
//          s_x = max(amax, 1e-8) / 127 and xq = clip(rint(x / s_x), +-127),
//          reading the row once in 16-byte loads kept in registers.
//   pass 2, chosen by M, is launched as a programmatic dependent of pass 1:
//          its blocks start while pass 1 runs and load their first weight
//          tiles, and wait for pass 1 (griddepcontrol) only before the
//          first activation tile.
//   pass 2:
//   - narrow (M <= 64, the weight stream): a block owns 64 weight rows
//     (output columns) and streams their 128-byte K tiles, with the matching
//     tile of all M activation rows, through a four-stage TMA ring (one
//     producer warp, full and empty mbarriers).  The operands are swapped:
//     64 weight rows are wgmma's A, the activation rows a narrow B (n = 32
//     or 64; TMA reads zero rows past M), m64nNk32 s8 with int32 sums.
//     Three or four blocks share an SM, ~100 KB of weights in flight on it.
//     The N = 4096 products have only 64 such tiles, so K is split over up
//     to six blocks (split K).
//   - wide (M > 64, operation-bound): 128 x 128 output tiles, two consumer
//     warpgroups of 64 rows and a producer warp, a five-stage TMA ring of
//     128-byte K tiles of xq and wt (TMA reads zero rows past M), m64n128k32
//     s8, one group of products kept in flight while the next stage waits.
//     A head's five row tiles of one weight tile are launched together, so
//     the weight tile is read from memory once and from L2 after.  Where the
//     tiles fill the SMs in a poor number of waves (the N = 4096 products
//     give 160 tiles on 132 SMs), K is split in two to four.
//   - split K: each block stores its int32 partial sums and takes a ticket;
//     the block that takes its tile's last ticket adds the partials and runs
//     the epilogue, and leaves the ticket at zero for the next launch.
//     int32 sums are exact in any order, so the accumulators equal one
//     block's bit for bit.
//   - epilogue: (acc * s_x) * w_scale with __fmul_rn, in x's dtype.
//
// Numerics match the plain version bit for bit in the int32 accumulators:
// round half to even (rintf), a true IEEE division (__fdiv_rn), no fast math.

#include "hopper.cuh"

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using namespace hopper;

constexpr int QUANT_THREADS = 256;
constexpr int BK = 128;              // K bytes per ring stage: one swizzled 128-byte row
constexpr int NARROW_MAX_M = 64;     // the narrow path takes M <= this
constexpr int NARROW_ROWS = 64;      // narrow: weight rows (output columns) per block
constexpr int NARROW_STAGES = 4;
constexpr int NARROW_THREADS = 128 + 32;
constexpr int WIDE_BM = 128;         // wide: output rows per block, two warpgroups of 64
constexpr int WIDE_BN = 128;         // wide: output columns per block
constexpr int WIDE_STAGES = 5;
constexpr int WIDE_THREADS = 256 + 32;

__device__ __forceinline__ void store_f(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, size_t i, float v) { p[i] = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_f2(float* p, size_t i, float a, float b) {
  *reinterpret_cast<float2*>(p + i) = make_float2(a, b);
}
__device__ __forceinline__ void store_f2(__nv_bfloat16* p, size_t i, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p + i) = __floats2bfloat162_rn(a, b);
}

// Element i of a 16-byte vector of T.
__device__ __forceinline__ float elem(const uint4& u, int i, const float*) { return reinterpret_cast<const float*>(&u)[i]; }
__device__ __forceinline__ float elem(const uint4& u, int i, const __nv_bfloat16*) {
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&u)[i]);
}

constexpr int QUANT_CACHE = 8;  // 16-byte vectors a thread keeps between the two steps

// The int8 values of one 16-byte vector of x (16 / sizeof(T) of them) to xq.
template <typename T>
__device__ __forceinline__ void quantize_vec(const uint4& u, float s, int8_t* dst) {
  constexpr int V = 16 / sizeof(T);
  __align__(8) int8_t q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float r = rintf(__fdiv_rn(elem(u, i, static_cast<const T*>(nullptr)), s));
    q[i] = static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
  }
  if constexpr (V == 8)
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(q);
  else
    *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(q);
}

// One block per row; x 16-byte aligned, K a multiple of 64.
template <typename T>
__global__ void __launch_bounds__(QUANT_THREADS)
quant_rows(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx, int K) {
  grid_dep_launch();  // the product may start now: its first weight loads need nothing of this pass
  constexpr int V = 16 / sizeof(T);
  __shared__ float red[QUANT_THREADS / 32];
  const size_t row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * K);
  int8_t* qr = xq + row * K;
  const int nv = K / V;
  uint4 cache[QUANT_CACHE];
  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < QUANT_CACHE; ++c) {
    const int v = threadIdx.x + c * QUANT_THREADS;
    if (v < nv) {
      cache[c] = __ldg(xr + v);
#pragma unroll
      for (int i = 0; i < V; ++i) amax = fmaxf(amax, fabsf(elem(cache[c], i, x)));
    }
  }
  for (int v = threadIdx.x + QUANT_CACHE * QUANT_THREADS; v < nv; v += QUANT_THREADS) {
    const uint4 u = __ldg(xr + v);
#pragma unroll
    for (int i = 0; i < V; ++i) amax = fmaxf(amax, fabsf(elem(u, i, x)));
  }
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < QUANT_THREADS / 32 ? red[threadIdx.x] : 0.f;
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (threadIdx.x == 0) red[0] = v;
  }
  __syncthreads();
  const float s = __fdiv_rn(fmaxf(red[0], 1e-8f), 127.0f);
  if (threadIdx.x == 0) sx[row] = s;
#pragma unroll
  for (int c = 0; c < QUANT_CACHE; ++c) {
    const int v = threadIdx.x + c * QUANT_THREADS;
    if (v < nv) quantize_vec<T>(cache[c], s, qr + (size_t)v * V);
  }
  for (int v = threadIdx.x + QUANT_CACHE * QUANT_THREADS; v < nv; v += QUANT_THREADS)
    quantize_vec<T>(__ldg(xr + v), s, qr + (size_t)v * V);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// The K tiles [x, y) of split `split` of `splits`.
__device__ __forceinline__ int2 split_range(int K, int split, int splits) {
  const int kt = (K + BK - 1) / BK;
  return make_int2(split * kt / splits, (split + 1) * kt / splits);
}

// Split K.  With more than one split, every block stores its R int32 sums
// per consumer thread to part (16-byte vectors, consecutive threads on
// consecutive addresses), and one thread takes a ticket of the tile; the
// block that takes the last one adds the partials of all splits and goes on
// to the epilogue, and puts the ticket back to zero.  Returns true in the
// block that then holds the tile's whole sums.
template <int R>
__device__ __forceinline__ bool reduce_splits(int (&acc)[R], int* __restrict__ part, int* __restrict__ tickets,
                                              int tile, int split, int splits, int ctid, int nthreads, int* last) {
  if (splits == 1) return true;
  int4* mine = reinterpret_cast<int4*>(part) + (size_t)(tile * splits + split) * (R / 4) * nthreads + ctid;
#pragma unroll
  for (int i = 0; i < R / 4; ++i)
    __stcg(mine + (size_t)i * nthreads, make_int4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]));
  __threadfence();
  named_sync(1, nthreads);
  if (ctid == 0) *last = atomicAdd(tickets + tile, 1) == splits - 1;
  named_sync(1, nthreads);
  if (!*last) return false;
  __threadfence();
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0;
  for (int s = 0; s < splits; ++s) {
    const int4* p = reinterpret_cast<const int4*>(part) + (size_t)(tile * splits + s) * (R / 4) * nthreads + ctid;
#pragma unroll
    for (int i = 0; i < R / 4; ++i) {
      const int4 v = __ldcg(p + (size_t)i * nthreads);
      acc[4 * i] += v.x;
      acc[4 * i + 1] += v.y;
      acc[4 * i + 2] += v.z;
      acc[4 * i + 3] += v.w;
    }
  }
  if (ctid == 0) tickets[tile] = 0;
  return true;
}

// Narrow path: block (tile, split) computes D[n][m] = sum_k wt[n][k] xq[m][k]
// for the 64 weight rows n0.. and all M rows, over its share of K.
template <int NX>
constexpr size_t narrow_smem_bytes() {
  return 1024 + (size_t)NARROW_STAGES * (NARROW_ROWS + NX) * BK + 2 * NARROW_STAGES * 8;
}

template <int NX, typename T>
__global__ void __launch_bounds__(NARROW_THREADS)
w8a8_narrow(const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tx,
            const float* __restrict__ sx, const float* __restrict__ ws, T* __restrict__ y,
            int32_t* __restrict__ acc_out, int* __restrict__ part, int* __restrict__ tickets, int M, int N, int K,
            int splits) {
  constexpr uint32_t W_BYTES = NARROW_ROWS * BK, X_BYTES = NX * BK;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int last;
  const uint32_t sW0 = smem_u32(align1024(smem_raw)), sX0 = sW0 + NARROW_STAGES * W_BYTES;
  const uint32_t full0 = sX0 + NARROW_STAGES * X_BYTES, empty0 = full0 + NARROW_STAGES * 8;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile = blockIdx.x, split = blockIdx.y, n0 = tile * NARROW_ROWS;
  const int2 kr = split_range(K, split, splits);
  const int kb = kr.x, ke = kr.y;

  if (tid == 0) {
    for (int s = 0; s < NARROW_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {  // producer warp
    if (lane == 0) {
      // the first stages' weight tiles load while quant_rows still runs
      const int n = ke - kb, pre = min(n, NARROW_STAGES);
      for (int i = 0; i < pre; ++i) {
        mbar_expect_tx(full0 + 8 * i, W_BYTES + X_BYTES);
        tma_load_2d(sW0 + i * W_BYTES, &tw, full0 + 8 * i, (kb + i) * BK, n0);
      }
      grid_dep_wait();  // xq and sx are written
      for (int i = 0; i < n; ++i) {
        const int s = i % NARROW_STAGES;
        if (i >= pre) {
          mbar_wait(empty0 + 8 * s, ((i / NARROW_STAGES) & 1) ^ 1);
          mbar_expect_tx(full0 + 8 * s, W_BYTES + X_BYTES);
          tma_load_2d(sW0 + s * W_BYTES, &tw, full0 + 8 * s, (kb + i) * BK, n0);
        }
        tma_load_2d(sX0 + s * X_BYTES, &tx, full0 + 8 * s, (kb + i) * BK, 0);
      }
    }
    return;
  }

  const int w = warp, g = lane >> 2, t = lane & 3;
  int acc[NX / 2];
#pragma unroll
  for (int i = 0; i < NX / 2; ++i) acc[i] = 0;
  for (int i = 0; kb + i < ke; ++i) {
    const int s = i % NARROW_STAGES;
    const uint32_t sW = sW0 + s * W_BYTES, sX = sX0 + s * X_BYTES;
    mbar_wait(full0 + 8 * s, (i / NARROW_STAGES) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      wgmma_s8(acc, desc_sw128(sW + kk * 32, 16, 1024), desc_sw128(sX + kk * 32, 16, 1024), 1);
    wg_commit();
    wg_wait_all();
    reg_fence(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }
  grid_dep_wait();  // sx, and the tickets the launch before this pass left
  if (!reduce_splits(acc, part, tickets, tile, split, splits, tid, 128, &last)) return;

  // this thread holds D[n0 + 16w + g + 8h][8j + 2t + e] in acc[4j + 2h + e]
#pragma unroll
  for (int j = 0; j < NX / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = 8 * j + 2 * t + e;
      if (m < M) {
        const float s = sx[m];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = n0 + 16 * w + g + 8 * h, v = acc[4 * j + 2 * h + e];
          const size_t o = (size_t)m * N + n;
          store_f(y, o, __fmul_rn(__fmul_rn((float)v, s), ws[n]));
          if (acc_out) acc_out[o] = v;
        }
      }
    }
}

// Wide path: block (tile, split) computes the 128 x 128 output tile
// (m0, n0) over its share of K.
constexpr size_t wide_smem_bytes() {
  return 1024 + (size_t)WIDE_STAGES * (WIDE_BM + WIDE_BN) * BK + 2 * WIDE_STAGES * 8;
}

template <typename T>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
w8a8_wide(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
          const float* __restrict__ sx, const float* __restrict__ ws, T* __restrict__ y,
          int32_t* __restrict__ acc_out, int* __restrict__ part, int* __restrict__ tickets, int M, int N, int K,
          int splits) {
  constexpr uint32_t A_BYTES = WIDE_BM * BK, B_BYTES = WIDE_BN * BK;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int last;
  const uint32_t sA0 = smem_u32(align1024(smem_raw)), sB0 = sA0 + WIDE_STAGES * A_BYTES;
  const uint32_t full0 = sB0 + WIDE_STAGES * B_BYTES, empty0 = full0 + WIDE_STAGES * 8;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mtiles = (M + WIDE_BM - 1) / WIDE_BM;
  const int tile = blockIdx.x, split = blockIdx.y;
  const int m0 = (tile % mtiles) * WIDE_BM, n0 = (tile / mtiles) * WIDE_BN;  // a weight tile's row tiles together
  const int2 kr = split_range(K, split, splits);
  const int kb = kr.x, ke = kr.y;

  if (tid == 0) {
    for (int s = 0; s < WIDE_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // producer warp
    if (lane == 0) {
      // the first stages' weight tiles load while quant_rows still runs
      const int n = ke - kb, pre = min(n, WIDE_STAGES);
      for (int i = 0; i < pre; ++i) {
        mbar_expect_tx(full0 + 8 * i, A_BYTES + B_BYTES);
        tma_load_2d(sB0 + i * B_BYTES, &tw, full0 + 8 * i, (kb + i) * BK, n0);
      }
      grid_dep_wait();  // xq and sx are written
      for (int i = 0; i < n; ++i) {
        const int s = i % WIDE_STAGES;
        if (i >= pre) {
          mbar_wait(empty0 + 8 * s, ((i / WIDE_STAGES) & 1) ^ 1);
          mbar_expect_tx(full0 + 8 * s, A_BYTES + B_BYTES);
          tma_load_2d(sB0 + s * B_BYTES, &tw, full0 + 8 * s, (kb + i) * BK, n0);
        }
        tma_load_2d(sA0 + s * A_BYTES, &tx, full0 + 8 * s, (kb + i) * BK, m0);
      }
    }
    return;
  }

  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  int acc[WIDE_BN / 2];
#pragma unroll
  for (int i = 0; i < WIDE_BN / 2; ++i) acc[i] = 0;
  for (int i = 0; kb + i < ke; ++i) {
    const int s = i % WIDE_STAGES;
    const uint32_t sA = sA0 + s * A_BYTES + wg * 64 * BK, sB = sB0 + s * B_BYTES;
    mbar_wait(full0 + 8 * s, (i / WIDE_STAGES) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      wgmma_s8(acc, desc_sw128(sA + kk * 32, 16, 1024), desc_sw128(sB + kk * 32, 16, 1024), 1);
    wg_commit();
    wg_wait_one();  // the previous stage's products are done: release its slot
    if (i > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * ((i - 1) % WIDE_STAGES));
    }
  }
  wg_wait_all();
  reg_fence(acc);
  grid_dep_wait();  // sx, and the tickets the launch before this pass left
  if (!reduce_splits(acc, part, tickets, tile, split, splits, tid, 256, &last)) return;

  // this thread holds D[m0 + 64 wg + 16w + g + 8h][n0 + 8j + 2t + e] in acc[4j + 2h + e]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + 64 * wg + 16 * w + g + 8 * h;
    if (m >= M) continue;
    const float s = sx[m];
#pragma unroll
    for (int j = 0; j < WIDE_BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      if (n >= N) continue;
      const int v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      const size_t o = (size_t)m * N + n;
      store_f2(y, o, __fmul_rn(__fmul_rn((float)v0, s), ws[n]), __fmul_rn(__fmul_rn((float)v1, s), ws[n + 1]));
      if (acc_out) *reinterpret_cast<int2*>(acc_out + o) = make_int2(v0, v1);
    }
  }
}

// The launch of pass 2 as a programmatic dependent of pass 1 (attr holds
// the attribute the configuration points to).
cudaLaunchConfig_t dependent_launch(dim3 grid, int threads, size_t smem, cudaStream_t stream,
                                    cudaLaunchAttribute (&attr)[1]) {
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int NX, typename T>
int launch_narrow(const int8_t* wt, const int8_t* xq, const float* sx, const float* ws, T* y, int32_t* acc_out,
                  int* part, int* tickets, int M, int K, int N, int splits, cudaStream_t stream) {
  CUtensorMap tw, tx;
  if (!make_map_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wt, K, N, BK, NARROW_ROWS, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, xq, K, M, BK, NX, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = narrow_smem_bytes<NX>();
  static bool smem_allowed = false;  // raised once, not at every launch
  if (!smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(w8a8_narrow<NX, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = true;
  }
  cudaLaunchAttribute pdl[1];
  const cudaLaunchConfig_t cfg = dependent_launch(dim3(N / NARROW_ROWS, splits), NARROW_THREADS, smem, stream, pdl);
  return (int)cudaLaunchKernelEx(&cfg, w8a8_narrow<NX, T>, tw, tx, sx, ws, y, acc_out, part, tickets, M, N, K, splits);
}

template <typename T>
int launch_wide(const int8_t* wt, const int8_t* xq, const float* sx, const float* ws, T* y, int32_t* acc_out,
                int* part, int* tickets, int M, int K, int N, int splits, cudaStream_t stream) {
  CUtensorMap tx, tw;
  if (!make_map_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, xq, K, M, BK, WIDE_BM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wt, K, N, BK, WIDE_BN, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = wide_smem_bytes();
  static bool smem_allowed = false;
  if (!smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(w8a8_wide<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = true;
  }
  cudaLaunchAttribute pdl[1];
  const cudaLaunchConfig_t cfg = dependent_launch(
      dim3(((M + WIDE_BM - 1) / WIDE_BM) * ((N + WIDE_BN - 1) / WIDE_BN), splits), WIDE_THREADS, smem, stream, pdl);
  return (int)cudaLaunchKernelEx(&cfg, w8a8_wide<T>, tx, tw, sx, ws, y, acc_out, part, tickets, M, N, K, splits);
}

template <typename T>
int launch(const void* x, const int8_t* wt, const float* ws, void* y, int8_t* xq, float* sx, int32_t* acc_out,
           int* part, int* tickets, int M, int K, int N, int splits, cudaStream_t stream) {
  quant_rows<T><<<M, QUANT_THREADS, 0, stream>>>(static_cast<const T*>(x), xq, sx, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  T* out = static_cast<T*>(y);
  if (M > NARROW_MAX_M) return launch_wide<T>(wt, xq, sx, ws, out, acc_out, part, tickets, M, K, N, splits, stream);
  if (M > 32) return launch_narrow<64, T>(wt, xq, sx, ws, out, acc_out, part, tickets, M, K, N, splits, stream);
  return launch_narrow<32, T>(wt, xq, sx, ws, out, acc_out, part, tickets, M, K, N, splits, stream);
}

}  // namespace

// x [M, K] (dtype 0 = float32, 1 = bfloat16); wt int8 [N, K], the weight
// K-major (row n holds output column n's K weights); ws fp32 [N]; y [M, N]
// in x's dtype; xq int8 [M, K] and sx fp32 [M] are scratch the caller
// allocates; acc_out int32 [M, N] is written when not null.  M <= 64 takes
// the narrow path, M > 64 the wide one.  splits > 1 splits K over that many
// blocks per output tile: part is int32 scratch of tiles x splits x 128 x
// (M <= 32 ? 16 : 32) ints (narrow, 64-column tiles) or tiles x splits x
// 256 x 64 (wide, 128 x 128 tiles), and tickets int32 [tiles] must be zero
// and is left zero.  Requires K % 64 == 0, N % 64 == 0, M >= 1, 16-byte
// aligned x, xq and wt.  Returns the launch's error code.
extern "C" int w8a8_matmul(const void* x, int x_dtype, const int8_t* wt, const float* ws, void* y, int8_t* xq,
                           float* sx, int32_t* acc_out, int* part, int* tickets, int M, int K, int N, int splits,
                           void* stream) {
  if (M < 1 || K % 64 != 0 || N % 64 != 0 || splits < 1 || (splits > 1 && (part == nullptr || tickets == nullptr)) ||
      (reinterpret_cast<uintptr_t>(x) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return launch<float>(x, wt, ws, y, xq, sx, acc_out, part, tickets, M, K, N, splits, s);
  return launch<__nv_bfloat16>(x, wt, ws, y, xq, sx, acc_out, part, tickets, M, K, N, splits, s);
}
