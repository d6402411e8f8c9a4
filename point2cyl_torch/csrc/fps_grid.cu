// Farthest point sampling over clouds beyond one cluster's registers
// (N > kClusterCapacity, 131,072; fps_cluster.cu takes 16,385 to it), for
// Hopper (sm_90a).
//
// Replaces: point2cyl_tpu/ops/pallas_fps.py:_fps_kernel (the pallas_call
// at pallas_fps.py:94) above the sizes fps.cu takes. The TPU kernel tiles
// the batch and holds a whole cloud in VMEM, so N scales to HBM; fps.cu
// keeps a copy of the whole cloud in each CTA's shared memory, which caps
// it at 16,384 points.
//
// What it computes: fps.cu's loop, bit for bit. npoint iterations of
// "record the current index, update each point's running minimum squared
// distance to the current centre, take the argmax (ties to the lowest
// index) as the next centre", from start[b] with every distance at 1e10.
// The distance is ((dx*dx + dy*dy) + dz*dz) with explicit round-to-nearest
// intrinsics, so nvcc cannot contract it into FMAs, and the running minimum
// is min.NaN: a NaN distance stays NaN and wins (its bits, canonical
// 0x7fffffff, lie above inf's), the lowest index first, as torch.minimum
// and torch.argmax do. The indices equal farthest_point_sample_plain and
// the JAX versions.
//
// What bounds it on this card: the chain of npoint dependent steps, each
// an argmax over the whole cloud. The operations (about 10 N a step) and
// the bytes (the cloud read once) are far below one step's latency chain
// at the sizes it takes.
//
// What the design does about it: one persistent launch a call, all steps
// inside it. A cloud is spread over `ctas` CTAs (grid B x ctas); each
// thread keeps a run of kGridPPT points and their running distances in
// registers for the whole call. Where the plan's registers do not hold the
// cloud (ops/cuda_fps.py:fps_grid_plan: large B at large N), the points
// beyond stream from global memory every step, their running distances in
// a scratch array the wrapper allocates. The next centre's coordinates are
// read from global `xyz` by index (through L2), not from a shared copy of
// the cloud. A step is:
//   - every thread updates its points and keeps its best (largest
//     distance; its points run in increasing index order, so a strict
//     comparison keeps the lowest index of a tie);
//   - each warp reduces with two redux.sync (the largest distance bits,
//     then the largest ~index among the lanes that hold them), and warp 0
//     reduces the warps the same way;
//   - the CTAs of a cloud meet once in global memory: thread 0 folds the
//     CTA's 64-bit key (distance bits << 32 | ~index, fps_ring.cu's key)
//     into the cloud's slot with atomicMax, then counts itself in; the
//     last to arrive releases the others by bumping the cloud's step
//     counter, on which the others spin; every CTA then reads the winner
//     and its coordinates, and the next step starts.
// The meeting places are a (B, kGridMeetWords) int64 buffer the caller
// passes in, zero at the launch (the wrapper allocates it a call: one
// memset node in a graph), so two launches in flight at once never share
// one. The key slots are double-buffered by step parity: the last CTA to
// arrive at step s resets the slot of step s - 1 (which every CTA has read
// before arriving) and the arrival count before it releases step s.
//
// Every CTA of the launch must be resident at once, or the barrier
// deadlocks: the plan keeps B x ctas within the CTAs the card holds
// (fps_grid_layout.cuh), the launch checks that against the occupancy API,
// and a cooperative launch (cudaLaunchAttributeCooperative, which stream
// capture records) makes the runtime refuse a grid it cannot co-schedule
// instead of hanging.
//
// Tried on the H100 and not kept (PERF.md): clusters of 16 CTAs meeting
// first in distributed shared memory, then in step-tagged slots in global
// memory that carried the winner's coordinates (no atomics, one L2 round
// trip after the last write). Only 7 such clusters are resident, so at
// 2^20 points the last 131,072 lived in shared memory, and a step took
// 3.2-3.5 us against this design's 3.2 in the same runs.

#undef NDEBUG  // the start-index check below must stay in every build
#include <atomic>
#include <cassert>
#include <cstdint>

#include <cuda_runtime.h>

#include "fps_grid_layout.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxDevices = 16;

// A cloud's meeting place: the best key of each parity's step and the
// arrivals, on one line; the steps completed, polled, on another.
struct alignas(128) Meet {
  unsigned long long best[2];
  unsigned int count;
  unsigned int pad0[27];
  unsigned int steps;
  unsigned int pad1[31];
};
static_assert(sizeof(Meet) == kGridMeetWords * sizeof(long long),
              "the wrapper's meeting buffer is kGridMeetWords int64 a cloud");

__device__ __forceinline__ unsigned load_volatile(const unsigned* p) {
  return *static_cast<const volatile unsigned*>(p);
}

// Fold this CTA's key into the cloud's slot for step `it`, wait for every
// CTA of the cloud, and return the step's largest key. One thread a CTA.
__device__ __forceinline__ unsigned long long meet_step(Meet* m, unsigned long long key,
                                                        int ctas, int it) {
  const int par = it & 1;
  atomicMax(&m->best[par], key);
  __threadfence();
  if (atomicAdd(&m->count, 1u) == static_cast<unsigned>(ctas - 1)) {
    // every CTA has read step it - 1's slot before arriving here
    atomicExch(&m->best[par ^ 1], 0ull);
    atomicExch(&m->count, 0u);
    __threadfence();
    atomicAdd(&m->steps, 1u);
  } else {
    while (static_cast<int>(load_volatile(&m->steps)) <= it) {
    }
  }
  __threadfence();
  return atomicOr(&m->best[par], 0ull);
}

// min with NaN propagation, as torch.minimum: a canonical NaN if either is.
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float sq_dist(float px, float py, float pz, float cx, float cy,
                                         float cz) {
  const float dx = __fsub_rn(px, cx);
  const float dy = __fsub_rn(py, cy);
  const float dz = __fsub_rn(pz, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// Grid B x ctas; CTA `rank` of cloud b holds indices [rank * T * kGridPPT,
// (rank + 1) * T * kGridPPT) in registers, thread t the indices
// rank * T * kGridPPT + k * T + t, k < kGridPPT (increasing in k). A slot
// past the end of the cloud holds a copy of point 0 under its own index
// (>= n): it ties with point 0 at every step and loses the tie, so it never
// wins. Points from held = ctas * T * kGridPPT on are streamed: global
// thread g = rank * T + t owns held + g + m * ctas * T, its running
// distances at scratch[b * (n - held) + (j - held)].
__global__ void __launch_bounds__(kGridMaxThreads, 1)
fps_grid_kernel(const float* __restrict__ xyz, const int* __restrict__ start, int n,
                int npoint, int ctas, int* __restrict__ out, float* __restrict__ scratch,
                Meet* __restrict__ meets) {
  __shared__ uint2 rec[kGridMaxThreads / 32];
  __shared__ float centre[3];
  __shared__ int far_sh;
  const int b = blockIdx.x / ctas;
  const int rank = blockIdx.x - b * ctas;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  Meet* meet = meets + b;
  const int held = ctas * nthreads * kGridPPT;
  const int first = rank * nthreads * kGridPPT + tid;
  const int stride = ctas * nthreads;  // between a thread's streamed points
  const int own = held + rank * nthreads + tid;
  float* sdist = scratch + static_cast<size_t>(b) * (n > held ? n - held : 0) - held;

  float px[kGridPPT], py[kGridPPT], pz[kGridPPT], dist[kGridPPT];
#pragma unroll
  for (int k = 0; k < kGridPPT; ++k) {
    const int j = first + k * nthreads;
    const int at = j < n ? 3 * j : 0;
    px[k] = p[at];
    py[k] = p[at + 1];
    pz[k] = p[at + 2];
    dist[k] = 1e10f;
  }
  for (int j = own; j < n; j += stride) sdist[j] = 1e10f;
  if (tid == 0) {
    const int s0 = start[b];
    assert(s0 >= 0 && s0 < n && "FPS start index out of range");
    far_sh = s0;
    centre[0] = p[3 * s0];
    centre[1] = p[3 * s0 + 1];
    centre[2] = p[3 * s0 + 2];
  }
  __syncthreads();

  for (int it = 0;; ++it) {
    if (rank == 0 && tid == 0) out[static_cast<size_t>(b) * npoint + it] = far_sh;
    if (it + 1 == npoint) break;  // the last centre needs no update
    const float cx = centre[0];
    const float cy = centre[1];
    const float cz = centre[2];
    dist[0] = min_nan(dist[0], sq_dist(px[0], py[0], pz[0], cx, cy, cz));
    unsigned bits = __float_as_uint(dist[0]);  // non-negative or NaN: ordered as its bits
    unsigned low = ~static_cast<unsigned>(first);
#pragma unroll
    for (int k = 1; k < kGridPPT; ++k) {
      dist[k] = min_nan(dist[k], sq_dist(px[k], py[k], pz[k], cx, cy, cz));
      const unsigned kb = __float_as_uint(dist[k]);
      if (kb > bits) {
        bits = kb;
        low = ~static_cast<unsigned>(first + k * nthreads);
      }
    }
    for (int j = own; j < n; j += stride) {
      const float d =
          min_nan(sdist[j], sq_dist(p[3 * j], p[3 * j + 1], p[3 * j + 2], cx, cy, cz));
      sdist[j] = d;
      if (__float_as_uint(d) > bits) {
        bits = __float_as_uint(d);
        low = ~static_cast<unsigned>(j);
      }
    }
    const unsigned wbits = __reduce_max_sync(kFullMask, bits);
    const unsigned wlow = __reduce_max_sync(kFullMask, bits == wbits ? low : 0u);
    if (lane == 0) rec[warp] = make_uint2(wbits, wlow);
    __syncthreads();
    if (warp == 0) {
      const uint2 r = lane < nwarps ? rec[lane] : make_uint2(0u, 0u);
      const unsigned cbits = __reduce_max_sync(kFullMask, r.x);
      const unsigned clow = __reduce_max_sync(kFullMask, r.x == cbits ? r.y : 0u);
      if (lane == 0) {
        const unsigned long long best =
            meet_step(meet, static_cast<unsigned long long>(cbits) << 32 | clow, ctas, it);
        const int far = static_cast<int>(~static_cast<unsigned>(best));
        far_sh = far;
        centre[0] = __ldg(p + 3 * far);
        centre[1] = __ldg(p + 3 * far + 1);
        centre[2] = __ldg(p + 3 * far + 2);
      }
    }
    __syncthreads();
  }
}

// CTAs each card holds at once for each warp count (0: not asked yet);
// writers that race store the same answer.
std::atomic<int> g_resident[kMaxDevices][kGridMaxThreads / 32 + 1];

}  // namespace

// xyz (b, n, 3) f32, start (b,) i32 -> out (b, npoint) i32, with `ctas`
// CTAs of `threads` threads (a multiple of 32, at most kGridMaxThreads)
// a cloud holding kGridPPT points a thread in registers; scratch
// (b, grid_streamed(n, ctas, threads)) f32 for the points beyond (null
// where there are none); meet (b, kGridMeetWords) int64, zero, 128-byte
// aligned, used by this launch alone. Needs 1 <= npoint <= n and 3 n <
// 2^31. Returns the CUDA status of the launch: a grid whose CTAs cannot
// all be resident is refused, never shrunk. A start index outside [0, n)
// fails the kernel's device-side assert.
extern "C" int p2c_fps_grid(const float* xyz, const int* start, int* out, float* scratch,
                            long long* meet, int b, int n, int npoint, int ctas, int threads,
                            void* stream) {
  const long long streamed = grid_streamed(n, ctas, threads);
  if (b < 1 || n < 1 || n > 0x7fffffff / 3 || npoint < 1 || npoint > n || ctas < 1 ||
      threads < 32 || threads > kGridMaxThreads || threads % 32 != 0 ||
      static_cast<long long>(b) * ctas > 0x7fffffff ||
      static_cast<long long>(ctas) * threads * kGridPPT > 0x7fffffff ||
      (streamed > 0) != (scratch != nullptr) || meet == nullptr ||
      reinterpret_cast<uintptr_t>(meet) % alignof(Meet) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int resident = g_resident[dev][threads / 32].load(std::memory_order_relaxed);
  if (resident == 0) {
    int sms = 0;
    int per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fps_grid_kernel, threads, 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = per_sm * sms;
    g_resident[dev][threads / 32].store(resident, std::memory_order_relaxed);
  }
  if (static_cast<long long>(b) * ctas > resident) {
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(b * ctas));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fps_grid_kernel, xyz, start, n, npoint, ctas, out, scratch,
                           reinterpret_cast<Meet*>(meet));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
