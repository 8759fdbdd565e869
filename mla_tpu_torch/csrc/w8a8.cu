// Fused W8A8 linear for Hopper: per-row dynamic int8 activation quantization,
// an int8 x int8 -> int32 tensor-core product, and the fp32 rescale.
//
// Replaces the TPU kernel mla_tpu/ops/quantization.py::_w8a8_kernel (:347),
// launched by w8a8_matmul (:383).
//
// What bounds it on an H100: at the suffix shapes (M = 18 rows) every int8
// weight byte is used by 18 rows only, so the kernel is bound by reading the
// weights (bytes); at the prefill shapes (M = 534) it is bound by int8
// tensor-core operations.  This first version is the simple, exact one:
//   pass 1 (quant_rows): one block per row computes amax, the scale
//          s_x = max(amax, 1e-8) / 127 and xq = clip(rint(x / s_x), +-127);
//   pass 2 (gemm): 32x64 output tiles, 4 warps, K in steps of 64 through
//          shared memory, mma.sync m16n8k32 s8 with int32 accumulators, the
//          rescale (acc * s_x) * w_scale in the epilogue.
// The weight tile arrives [k][n] (n contiguous); the mma B operand wants four
// consecutive k of one column in a register, so each thread transposes a 4x4
// byte block with __byte_perm on its way into shared memory.
//
// Numerics match the plain version bit for bit in the int32 accumulators:
// round half to even (rintf), a true IEEE division (__fdiv_rn), no fast math.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int KW = BK / 4;   // 32-bit words of k per tile row
constexpr int PAD = 4;       // words of padding per shared row (bank spread)
constexpr int QUANT_THREADS = 256;

__device__ __forceinline__ float load_f(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ void store_f(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, size_t i, float v) { p[i] = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(QUANT_THREADS)
quant_rows(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx, int K) {
  __shared__ float red[QUANT_THREADS / 32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * K;
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += QUANT_THREADS) amax = fmaxf(amax, fabsf(load_f(xr, k)));
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
  for (int k = threadIdx.x; k < K; k += QUANT_THREADS) {
    float q = rintf(__fdiv_rn(load_f(xr, k), s));
    q = fminf(fmaxf(q, -127.f), 127.f);
    xq[row * K + k] = static_cast<int8_t>(q);
  }
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__global__ void __launch_bounds__(128)
gemm_s8(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq, const float* __restrict__ sx,
        const float* __restrict__ ws, T* __restrict__ y, int32_t* __restrict__ acc_out,
        int M, int N, int K) {
  __shared__ uint32_t As[BM][KW + PAD];  // [m][k/4]
  __shared__ uint32_t Bs[BN][KW + PAD];  // [n][k/4], transposed on load
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * KW; i += 128) {
      const int r = i / KW, c = i % KW, m = m0 + r;
      As[r][c] = m < M ? *reinterpret_cast<const uint32_t*>(xq + (size_t)m * K + k0 + c * 4) : 0u;
    }
    for (int i = tid; i < KW * (BN / 4); i += 128) {
      const int kb = i / (BN / 4), nb = i % (BN / 4);
      const int8_t* src = wq + (size_t)(k0 + kb * 4) * N + n0 + nb * 4;
      const uint32_t r0 = *reinterpret_cast<const uint32_t*>(src);
      const uint32_t r1 = *reinterpret_cast<const uint32_t*>(src + N);
      const uint32_t r2 = *reinterpret_cast<const uint32_t*>(src + 2 * (size_t)N);
      const uint32_t r3 = *reinterpret_cast<const uint32_t*>(src + 3 * (size_t)N);
      // 4x4 byte transpose: out_j = [r0.b_j, r1.b_j, r2.b_j, r3.b_j]
      const uint32_t t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r0, r1, 0x7362);
      const uint32_t t2 = __byte_perm(r2, r3, 0x5140), t3 = __byte_perm(r2, r3, 0x7362);
      Bs[nb * 4 + 0][kb] = __byte_perm(t0, t2, 0x5410);
      Bs[nb * 4 + 1][kb] = __byte_perm(t0, t2, 0x7632);
      Bs[nb * 4 + 2][kb] = __byte_perm(t1, t3, 0x5410);
      Bs[nb * 4 + 3][kb] = __byte_perm(t1, t3, 0x7632);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      const int kw = kk * 8;
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = mt * 16 + g;
        a[mt][0] = As[r][kw + t];
        a[mt][1] = As[r + 8][kw + t];
        a[mt][2] = As[r][kw + 4 + t];
        a[mt][3] = As[r + 8][kw + 4 + t];
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int n = warp * 16 + nt * 8 + g;
        const uint32_t b0 = Bs[n][kw + t], b1 = Bs[n][kw + 4 + t];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_s8(acc[mt][nt], a[mt], b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + mt * 16 + g + (r >> 1) * 8;
        const int n = n0 + warp * 16 + nt * 8 + t * 2 + (r & 1);
        if (m < M) {
          const size_t o = (size_t)m * N + n;
          store_f(y, o, __fmul_rn(__fmul_rn((float)acc[mt][nt][r], sx[m]), ws[n]));
          if (acc_out) acc_out[o] = acc[mt][nt][r];
        }
      }
}

template <typename T>
int launch(const void* x, const int8_t* wq, const float* ws, void* y, int8_t* xq, float* sx,
           int32_t* acc_out, int M, int K, int N, cudaStream_t stream) {
  quant_rows<T><<<M, QUANT_THREADS, 0, stream>>>(static_cast<const T*>(x), xq, sx, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N / BN, (M + BM - 1) / BM);
  gemm_s8<T><<<grid, 128, 0, stream>>>(xq, wq, sx, ws, static_cast<T*>(y), acc_out, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, K] (dtype 0 = float32, 1 = bfloat16), wq int8 [K, N], ws fp32 [N],
// y [M, N] in x's dtype; xq int8 [M, K] and sx fp32 [M] are scratch the
// caller allocates; acc_out int32 [M, N] is written when not null.
// Requires K % 64 == 0 and N % 64 == 0.  Returns cudaGetLastError().
extern "C" int w8a8_matmul(const void* x, int x_dtype, const int8_t* wq, const float* ws, void* y,
                           int8_t* xq, float* sx, int32_t* acc_out, int M, int K, int N,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return launch<float>(x, wq, ws, y, xq, sx, acc_out, M, K, N, s);
  return launch<__nv_bfloat16>(x, wq, ws, y, xq, sx, acc_out, M, K, N, s);
}
