// Farthest point sampling for Hopper (sm_90a).
//
// Replaces: point2cyl_tpu/ops/pallas_fps.py:_fps_kernel, reached through
// farthest_point_sample_pallas (the pallas_call at pallas_fps.py:94).
//
// What it computes: npoint iterations of "record the current index, update
// each point's running minimum squared distance to the current centre, take
// the argmax (ties to the lowest index) as the next centre", starting from
// a given index with every distance at 1e10. The indices equal the JAX
// versions bit for bit: the distance is ((dx*dx + dy*dy) + dz*dz) with
// explicit round-to-nearest intrinsics, so nvcc cannot contract it into
// FMAs, and every argmax keeps the lowest index among equal maxima.
//
// What bounds it on this card: not bytes (a cloud is read once, 96 KB at
// N=8192) but the npoint dependent iterations, each a full pass over N
// plus a block-wide argmax that needs two barriers. One block serves one
// cloud, so a batch of B clouds keeps only B of the 132 SMs busy.
//
// What the design does about it: each thread keeps its points and their
// running distances in registers (N/1024 per thread), so an iteration
// touches no memory but a broadcast read of the new centre from a shared
// copy of the cloud. The argmax is a register pass per thread, a shuffle
// tree per warp and one more warp over the per-warp winners. Spreading a
// cloud over several SMs (a cluster with distributed shared memory) is
// left for a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr unsigned kFullMask = 0xffffffffu;

// (d2, i2) beats (d1, i1): larger distance, then lower index.
__device__ __forceinline__ bool beats(float d2, int i2, float d1, int i1) {
  return d2 > d1 || (d2 == d1 && i2 < i1);
}

__device__ __forceinline__ void warp_argmax(float& d, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(kFullMask, d, off);
    const int oi = __shfl_xor_sync(kFullMask, i, off);
    if (beats(od, oi, d, i)) {
      d = od;
      i = oi;
    }
  }
}

// PPT: points per thread; point j lives in thread j % blockDim.x, slot
// j / blockDim.x, so a thread's slots run in increasing index order.
template <int PPT>
__global__ void __launch_bounds__(kMaxThreads)
fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
           int n, int npoint, int* __restrict__ out) {
  extern __shared__ float cloud[];  // x[n] | y[n] | z[n]
  __shared__ float warp_d[32];
  __shared__ int warp_i[32];
  __shared__ int next;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  float* sx = cloud;
  float* sy = cloud + n;
  float* sz = cloud + 2 * n;

  float px[PPT], py[PPT], pz[PPT], dist[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int j = k * nthreads + tid;
    px[k] = py[k] = pz[k] = 0.0f;
    dist[k] = 1e10f;
    if (j < n) {
      px[k] = p[3 * j];
      py[k] = p[3 * j + 1];
      pz[k] = p[3 * j + 2];
      sx[j] = px[k];
      sy[j] = py[k];
      sz[j] = pz[k];
    }
  }
  int far = start[b];
  int* row_out = out + static_cast<size_t>(b) * npoint;
  __syncthreads();

  for (int it = 0; it < npoint; ++it) {
    if (tid == 0) row_out[it] = far;
    const float cx = sx[far];
    const float cy = sy[far];
    const float cz = sz[far];
    float best_d = -1.0f;  // distances are >= 0, so any point beats this
    int best_i = n;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int j = k * nthreads + tid;
      if (j < n) {
        const float dx = __fsub_rn(px[k], cx);
        const float dy = __fsub_rn(py[k], cy);
        const float dz = __fsub_rn(pz[k], cz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        const float m = fminf(dist[k], d);
        dist[k] = m;
        if (m > best_d) {  // strict: the earlier (lower) index keeps a tie
          best_d = m;
          best_i = j;
        }
      }
    }
    warp_argmax(best_d, best_i);
    if (lane == 0) {
      warp_d[warp] = best_d;
      warp_i[warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
      best_d = lane < nwarps ? warp_d[lane] : -1.0f;
      best_i = lane < nwarps ? warp_i[lane] : n;
      warp_argmax(best_d, best_i);
      if (lane == 0) next = best_i;
    }
    __syncthreads();
    far = next;
  }
}

template <int PPT>
cudaError_t launch(const float* xyz, const int* start, int* out, int b, int n,
                   int npoint, int threads, cudaStream_t stream) {
  const size_t smem = 3 * static_cast<size_t>(n) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fps_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  fps_kernel<PPT><<<b, threads, smem, stream>>>(xyz, start, n, npoint, out);
  return cudaSuccess;
}

}  // namespace

// xyz (b, n, 3) f32, start (b,) i32 -> out (b, npoint) i32. Needs
// 1 <= n <= 16384; returns cudaGetLastError() after the launch.
extern "C" int p2c_fps(const float* xyz, const int* start, int* out, int b,
                       int n, int npoint, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int threads, ppt;
  if (n <= kMaxThreads) {
    threads = (n + 31) / 32 * 32;
    ppt = 1;
  } else {
    threads = kMaxThreads;
    ppt = (n + kMaxThreads - 1) / kMaxThreads;
  }
  cudaError_t err;
  if (ppt <= 1) {
    err = launch<1>(xyz, start, out, b, n, npoint, threads, s);
  } else if (ppt <= 2) {
    err = launch<2>(xyz, start, out, b, n, npoint, threads, s);
  } else if (ppt <= 4) {
    err = launch<4>(xyz, start, out, b, n, npoint, threads, s);
  } else if (ppt <= 8) {
    err = launch<8>(xyz, start, out, b, n, npoint, threads, s);
  } else if (ppt <= 16) {
    err = launch<16>(xyz, start, out, b, n, npoint, threads, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
