// Weight-only int8 linear for Hopper: y = (x @ float(w_q)) * w_scale, in x's
// dtype.  x [M, K] is bf16 or fp32, w_q int8 [K, N], w_scale fp32 [N].
//
// Replaces the TPU kernel mla_tpu/ops/quantization.py::_int8_mm_kernel (:264),
// launched by int8_matmul (:298).
//
// What bounds it on an H100: at a decode step (M = 1, or B*K rows for beams)
// every int8 weight byte serves a handful of rows, so the kernel is bound by
// reading the weights: 202.4 MB per mla-7b layer, 0.060 ms at 3.35 TB/s.  At
// the AR prefill (M = 535) it is bound by tensor-core operations: 216.6 GFLOP
// per layer, 0.219 ms at 989 TFLOP/s.  This first version is the simple one:
//   * an int8 weight tile [BK][BN] arrives with 16-byte loads along N (the
//     [K, N] layout is N-contiguous) and is converted to bf16 (exact: int8
//     values fit bf16) on its way into shared memory; the x tile is bf16 as
//     given.  mma.sync m16n8k16 bf16 multiplies them with fp32 accumulators,
//     the weight tile read as the column operand through ldmatrix.trans.  The
//     per-column scale is applied in the epilogue, in fp32, as the TPU kernel
//     does.
//   * the next tile is loaded into registers while the current one is
//     multiplied, and the weight tile PF tiles ahead is prefetched into L2,
//     so more weight bytes are in flight than the registers hold.
//   * two tile shapes.  Up to 32 rows: 16 or 32 x 32 tiles of 2 warps, BK
//     128, so N = 4096 (the o and down projections) gives 128 blocks for the
//     132 SMs, one block per SM: those two stay further from the bandwidth
//     bound than the wide qkv and gate|up products (split K is later work).
//     Above 32 rows: 128 x 128 tiles of 8 warps (64 x 32 each), BK 32.
//   * rows past M are zero-filled and not stored (M is padded to the tile);
//     columns past N (a ragged last tile; N is a multiple of 16) likewise.
// fp32 x runs a plain fp32 FMA tile (no TF32), as the TPU kernel takes fp32
// too.  Every sum runs in a fixed order, so two launches give the same bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int PF = 4;  // tiles of weights prefetched into L2 ahead of use

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices, transposed on the way: lanes 8i..8i+7 give the row
// addresses of matrix i, and r[i] receives its column-operand fragment.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// bytes 2h and 2h+1 of w (two int8) -> a bf16 pair, low byte first
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(uint32_t w, int h) {
  const float lo = static_cast<float>(static_cast<int8_t>((w >> (16 * h)) & 0xffu));
  const float hi = static_cast<float>(static_cast<int8_t>((w >> (16 * h + 8)) & 0xffu));
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int BM, int BN, int BK, int WM, int WN>
struct Tile {
  static constexpr int WARPS_N = BN / WN;
  static constexpr int THREADS = (BM / WM) * WARPS_N * 32;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int AP = BK + 8, BP = BN + 8;   // padded shared rows (bank spread)
  static constexpr int A_CH = BM * BK / 8 / THREADS;   // 16-byte chunks of x per thread
  static constexpr int B_CH = BK * BN / 16 / THREADS;  // 16-byte chunks of w per thread
  static_assert(A_CH * THREADS * 8 == BM * BK && B_CH * THREADS * 16 == BK * BN, "tile and threads disagree");
  static_assert(NT % 2 == 0, "ldmatrix.x4.trans feeds two n8 tiles");
};

template <class T, int BM, int BN, int BK>
__device__ __forceinline__ void load_tile(uint4 (&ra)[T::A_CH], uint4 (&rb)[T::B_CH], const bf16* __restrict__ x,
                                          const int8_t* __restrict__ wq, int m0, int n0, int k0, int M, int N,
                                          int K, int tid) {
#pragma unroll
  for (int i = 0; i < T::A_CH; ++i) {
    const int c = tid + i * T::THREADS, m = m0 + c / (BK / 8), col = (c % (BK / 8)) * 8;
    ra[i] = m < M ? *reinterpret_cast<const uint4*>(x + (size_t)m * K + k0 + col) : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int i = 0; i < T::B_CH; ++i) {
    const int c = tid + i * T::THREADS, k = k0 + c / (BN / 16), n = n0 + (c % (BN / 16)) * 16;
    rb[i] = n < N ? *reinterpret_cast<const uint4*>(wq + (size_t)k * N + n) : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int BM, int BN, int BK, int WM, int WN>
__global__ void __launch_bounds__(Tile<BM, BN, BK, WM, WN>::THREADS)
int8_mm_bf16(const bf16* __restrict__ x, const int8_t* __restrict__ wq, const float* __restrict__ ws,
             bf16* __restrict__ y, int M, int N, int K) {
  typedef Tile<BM, BN, BK, WM, WN> T;
  __shared__ __align__(16) bf16 As[BM][T::AP];
  __shared__ __align__(16) bf16 Bs[BK][T::BP];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  uint4 ra[T::A_CH], rb[T::B_CH];
  const int nkt = K / BK;
  load_tile<T, BM, BN, BK>(ra, rb, x, wq, m0, n0, 0, M, N, K, tid);
  for (int kt = 0; kt < nkt; ++kt) {
#pragma unroll
    for (int i = 0; i < T::A_CH; ++i) {
      const int c = tid + i * T::THREADS;
      *reinterpret_cast<uint4*>(&As[c / (BK / 8)][(c % (BK / 8)) * 8]) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < T::B_CH; ++i) {
      const int c = tid + i * T::THREADS, r = c / (BN / 16), col = (c % (BN / 16)) * 16;
      const uint4 w = rb[i];
      *reinterpret_cast<uint4*>(&Bs[r][col]) =
          make_uint4(int8x2_to_bf16x2(w.x, 0), int8x2_to_bf16x2(w.x, 1), int8x2_to_bf16x2(w.y, 0),
                     int8x2_to_bf16x2(w.y, 1));
      *reinterpret_cast<uint4*>(&Bs[r][col + 8]) =
          make_uint4(int8x2_to_bf16x2(w.z, 0), int8x2_to_bf16x2(w.z, 1), int8x2_to_bf16x2(w.w, 0),
                     int8x2_to_bf16x2(w.w, 1));
    }
    __syncthreads();
    if (kt + 1 < nkt) load_tile<T, BM, BN, BK>(ra, rb, x, wq, m0, n0, (kt + 1) * BK, M, N, K, tid);
    if (kt + PF < nkt) {
#pragma unroll
      for (int i = 0; i < T::B_CH; ++i) {
        const int c = tid + i * T::THREADS, n = n0 + (c % (BN / 16)) * 16;
        if (n < N) prefetch_l2(wq + (size_t)((kt + PF) * BK + c / (BN / 16)) * N + n);
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[T::MT][4];
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt) {
        const int r = wm * WM + mt * 16 + g;
        a[mt][0] = ld32(&As[r][kk + 2 * t]);
        a[mt][1] = ld32(&As[r + 8][kk + 2 * t]);
        a[mt][2] = ld32(&As[r][kk + 2 * t + 8]);
        a[mt][3] = ld32(&As[r + 8][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int np = 0; np < T::NT / 2; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, &Bs[kk + (lane & 7) + ((lane >> 3) & 1) * 8][wn * WN + np * 16 + (lane >> 4) * 8]);
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * WM + mt * 16 + g + h * 8;
        const int n = n0 + wn * WN + nt * 8 + 2 * t;
        if (m < M && n < N) {
          const float lo = __fmul_rn(acc[mt][nt][2 * h], ws[n]);
          const float hi = __fmul_rn(acc[mt][nt][2 * h + 1], ws[n + 1]);
          *reinterpret_cast<__nv_bfloat162*>(y + (size_t)m * N + n) = __floats2bfloat162_rn(lo, hi);
        }
      }
}

template <int BM, int BN, int BK, int WM, int WN>
int launch_bf16(const void* x, const int8_t* wq, const float* ws, void* y, int M, int K, int N, cudaStream_t s) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_mm_bf16<BM, BN, BK, WM, WN><<<grid, Tile<BM, BN, BK, WM, WN>::THREADS, 0, s>>>(
      static_cast<const bf16*>(x), wq, ws, static_cast<bf16*>(y), M, N, K);
  return (int)cudaGetLastError();
}

// fp32 x: 64 x 64 tiles, 16 x 16 threads of 4 x 4 outputs each, BK 16
constexpr int FBM = 64, FBN = 64, FBK = 16;

__global__ void __launch_bounds__(256)
int8_mm_f32(const float* __restrict__ x, const int8_t* __restrict__ wq, const float* __restrict__ ws,
            float* __restrict__ y, int M, int N, int K) {
  __shared__ float As[FBK][FBM + 4];  // [k][m]
  __shared__ float Bs[FBK][FBN + 4];  // [k][n]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int nkt = K / FBK;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * FBK;
    for (int i = tid; i < FBM * FBK; i += 256) {
      const int r = i / FBK, c = i % FBK, m = m0 + r;
      As[c][r] = m < M ? x[(size_t)m * K + k0 + c] : 0.f;
    }
    for (int i = tid; i < FBK * FBN; i += 256) {
      const int r = i / FBN, c = i % FBN, n = n0 + c;
      Bs[r][c] = n < N ? static_cast<float>(wq[(size_t)(k0 + r) * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < M && n < N) y[(size_t)m * N + n] = __fmul_rn(acc[i][j], ws[n]);
    }
}

}  // namespace

// x [M, K] (x_dtype 0 = float32, 1 = bfloat16), wq int8 [K, N], ws fp32 [N],
// y [M, N] in x's dtype.  Requires K % 128 == 0, N % 16 == 0, x and wq
// 16-byte aligned.  Returns cudaGetLastError().
extern "C" int int8_mm(const void* x, int x_dtype, const int8_t* wq, const float* ws, void* y, int M, int K, int N,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) {
    dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM);
    int8_mm_f32<<<grid, 256, 0, s>>>(static_cast<const float*>(x), wq, ws, static_cast<float*>(y), M, N, K);
    return (int)cudaGetLastError();
  }
  if (M <= 16) return launch_bf16<16, 32, 128, 16, 16>(x, wq, ws, y, M, K, N, s);
  if (M <= 32) return launch_bf16<32, 32, 128, 32, 16>(x, wq, ws, y, M, K, N, s);
  return launch_bf16<128, 128, 32, 64, 32>(x, wq, ws, y, M, K, N, s);
}
