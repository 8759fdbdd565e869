// Farthest-point sampling for Hopper: one block per cloud.
//
// Replaces the TPU kernel mla_tpu/ops/pointops_pallas.py::_fps_kernel (:28),
// launched by fps_pallas (:83).
//
// What bounds it on an H100: neither bytes nor operations.  The cloud is
// 12 KB and the work 1024 x 512 distance updates, but the npoint steps form
// one dependency chain, each ending in a block-wide argmax.  So the time is
// npoint x (one pass over the block's points + two barriers).  The design
// keeps everything on chip: the cloud and the running min-distance field live
// in shared memory, each step gathers the centroid from shared memory,
// updates the field, and reduces (max, lowest index) first within each warp
// by shuffles and then across warps through shared memory.
//
// Numerics: the squared distance is ((dx*dx + dy*dy) + dz*dz) with every
// operation rounded on its own (__fmul_rn / __fadd_rn, and the file is also
// built with -fmad=false), the order both JAX versions use; ties go to the
// lower index, as jnp.argmax does.  The indices equal the plain version's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;

__device__ __forceinline__ void better(float& bv, int& bi, float ov, int oi) {
  if (ov > bv || (ov == bv && oi < bi)) {
    bv = ov;
    bi = oi;
  }
}

__global__ void __launch_bounds__(THREADS)
fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start, int* __restrict__ out,
           int N, int npoint) {
  extern __shared__ float sm[];
  float* xs = sm;
  float* ys = sm + N;
  float* zs = sm + 2 * N;
  float* dist = sm + 3 * N;
  __shared__ float wv[THREADS / 32];
  __shared__ int wi[THREADS / 32];
  __shared__ int far_s;

  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* cloud = xyz + (size_t)b * N * 3;
  for (int p = tid; p < N; p += THREADS) {
    xs[p] = cloud[p * 3 + 0];
    ys[p] = cloud[p * 3 + 1];
    zs[p] = cloud[p * 3 + 2];
    dist[p] = 1e10f;
  }
  int far = start[b];
  __syncthreads();

  for (int i = 0; i < npoint; ++i) {
    if (tid == 0) out[(size_t)b * npoint + i] = far;
    const float cx = xs[far], cy = ys[far], cz = zs[far];
    float bv = -INFINITY;
    int bi = N;
    for (int p = tid; p < N; p += THREADS) {
      const float dx = __fsub_rn(xs[p], cx), dy = __fsub_rn(ys[p], cy), dz = __fsub_rn(zs[p], cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      const float dm = fminf(dist[p], d);
      dist[p] = dm;
      if (dm > bv) {  // p rises, so a strict > keeps the lowest index of a tie
        bv = dm;
        bi = p;
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      better(bv, bi, __shfl_xor_sync(0xffffffffu, bv, off), __shfl_xor_sync(0xffffffffu, bi, off));
    if (lane == 0) {
      wv[warp] = bv;
      wi[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < THREADS / 32 ? wv[lane] : -INFINITY;
      bi = lane < THREADS / 32 ? wi[lane] : N;
      for (int off = 16; off > 0; off >>= 1)
        better(bv, bi, __shfl_xor_sync(0xffffffffu, bv, off), __shfl_xor_sync(0xffffffffu, bi, off));
      if (lane == 0) far_s = bi;
    }
    __syncthreads();
    far = far_s;
  }
}

}  // namespace

// xyz fp32 [B, N, 3] contiguous, start int32 [B], out int32 [B, npoint].
// Returns cudaGetLastError().
extern "C" int fps(const float* xyz, const int* start, int* out, int B, int N, int npoint,
                   void* stream) {
  const size_t smem = (size_t)4 * N * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fps_kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(xyz, start, out, N, npoint);
  return (int)cudaGetLastError();
}
