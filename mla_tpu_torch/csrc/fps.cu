// Farthest-point sampling for Hopper: one block per cloud.
//
// Replaces the TPU kernel mla_tpu/ops/pointops_pallas.py::_fps_kernel (:28),
// launched by fps_pallas (:83).
//
// What bounds it on an H100: neither bytes nor operations.  The cloud is
// 12 KB and the work 1024 x 512 distance updates, but the npoint steps form
// one dependency chain (768 steps for the point tokenizer's 1024 -> 512 ->
// 256), each ending in a block-wide argmax that the next step's centroid
// waits for.  So the time is npoint x the latency of one step, and the
// design shortens that chain:
//   * each thread keeps its points (p = tid + j * threads, PPT of them) and
//     their running distances in registers; a copy of the cloud stays in
//     shared memory for the centroid gather.  Large clouds (N > 4096) keep
//     only the distances in registers and read the points from shared
//     memory.
//   * the argmax packs nothing: distances are >= 0, so their bits order as
//     unsigned integers, and a warp finds (max, lowest index of the max)
//     with two redux.sync instructions instead of a shuffle tree.
//   * one barrier per step: each warp writes its (max, index) into a
//     double-buffered slot, and after the barrier every warp reduces all
//     slots itself, so no second barrier hands the result back.
//   * few threads (N / 4 for N <= 1024: 256 for the 1024-point stage), so
//     the barrier and the slot reduction span few warps.
//
// Numerics: the squared distance is ((dx*dx + dy*dy) + dz*dz) with every
// operation rounded on its own (__fmul_rn / __fadd_rn, and the file is also
// built with -fmad=false), the order both JAX versions use; ties go to the
// lower index, as jnp.argmax does.  The indices equal the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NO_INDEX = 0x7fffffffu;

// PPT points per thread; REGS: the points' coordinates in registers (else
// read from the shared copy each step); MAXT: the most threads a launch
// takes.
template <int PPT, bool REGS, int MAXT>
__global__ void __launch_bounds__(MAXT)
fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start, int* __restrict__ out, int N, int npoint) {
  extern __shared__ float sm[];
  float* xs = sm;
  float* ys = sm + N;
  float* zs = sm + 2 * N;
  __shared__ uint2 slot[2][32];

  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = blockDim.x, W = T >> 5;
  const float* cloud = xyz + (size_t)b * N * 3;
  for (int p = tid; p < N; p += T) {
    xs[p] = cloud[p * 3 + 0];
    ys[p] = cloud[p * 3 + 1];
    zs[p] = cloud[p * 3 + 2];
  }
  // points past N carry coordinates 0 and distance 0: never above a real
  // point's distance, and their index loses every tie
  float px[REGS ? PPT : 1], py[REGS ? PPT : 1], pz[REGS ? PPT : 1], dist[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = tid + j * T;
    const bool real = p < N;
    if constexpr (REGS) {
      px[j] = real ? cloud[p * 3 + 0] : 0.f;
      py[j] = real ? cloud[p * 3 + 1] : 0.f;
      pz[j] = real ? cloud[p * 3 + 2] : 0.f;
    }
    dist[j] = real ? 1e10f : 0.f;
  }
  int far = start[b];
  __syncthreads();

  for (int i = 0; i < npoint; ++i) {
    if (tid == 0) out[(size_t)b * npoint + i] = far;
    const float cx = xs[far], cy = ys[far], cz = zs[far];
    unsigned best = 0u, best_i = NO_INDEX;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int p = tid + j * T;
      float x, y, z;
      if constexpr (REGS) {
        x = px[j], y = py[j], z = pz[j];
      } else {
        const int q = p < N ? p : 0;
        x = xs[q], y = ys[q], z = zs[q];
      }
      const float dx = __fsub_rn(x, cx), dy = __fsub_rn(y, cy), dz = __fsub_rn(z, cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      dist[j] = fminf(dist[j], d);
      const unsigned u = __float_as_uint(dist[j]);
      // p rises with j, so a strict > keeps the lowest index of a tie; a
      // point past N (distance 0) is never taken after a real one
      if (j == 0) {
        best = u;
        best_i = p < N ? p : NO_INDEX;
      } else if (u > best) {
        best = u;
        best_i = p;
      }
    }
    const unsigned wmax = __reduce_max_sync(FULL, best);
    const unsigned widx = __reduce_min_sync(FULL, best == wmax ? best_i : NO_INDEX);
    if (lane == 0) slot[i & 1][warp] = make_uint2(wmax, widx);
    __syncthreads();
    const uint2 v = lane < W ? slot[i & 1][lane] : make_uint2(0u, NO_INDEX);
    const unsigned bmax = __reduce_max_sync(FULL, v.x);
    far = (int)__reduce_min_sync(FULL, v.x == bmax ? v.y : NO_INDEX);
  }
}

template <int PPT, bool REGS, int MAXT>
int launch(const float* xyz, const int* start, int* out, int B, int N, int npoint, cudaStream_t stream) {
  const size_t smem = (size_t)3 * N * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(fps_kernel<PPT, REGS, MAXT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = ((N + PPT - 1) / PPT + 31) / 32 * 32;
  fps_kernel<PPT, REGS, MAXT><<<B, threads, smem, stream>>>(xyz, start, out, N, npoint);
  return (int)cudaGetLastError();
}

}  // namespace

// xyz fp32 [B, N, 3] contiguous, start int32 [B], out int32 [B, npoint];
// 1 <= npoint <= N <= 16384.  Returns cudaGetLastError().
extern "C" int fps(const float* xyz, const int* start, int* out, int B, int N, int npoint, void* stream) {
  if (N < 1 || N > 16384 || npoint < 1 || npoint > N) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 1024) return launch<4, true, 256>(xyz, start, out, B, N, npoint, s);
  if (N <= 4096) return launch<8, true, 512>(xyz, start, out, B, N, npoint, s);
  return launch<16, false, 1024>(xyz, start, out, B, N, npoint, s);
}
