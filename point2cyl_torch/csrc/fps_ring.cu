// One step of farthest point sampling over a point-sharded cloud, for
// Hopper (sm_90a).
//
// Replaces: the loop body of point2cyl_tpu/parallel/point_sharding.py
// _fps_local (the lax.fori_loop at :252), which XLA fuses inside the
// shard_map of parallel/sharded_backbone.py; that ring is XLA code, not a
// pallas_call. Its plain version is fps_ring_step_plain (ops/sampling.py).
//
// What one launch computes, per cloud b, on this rank's shard of nl points
// whose global indices start at `off`:
//   1. the winner of the previous step: the largest of the p offers
//      every[:, b] (int64 keys; the first rank on a tie, as argmax);
//   2. centroids[b, step] = its global index, ~key's low 32 bits;
//   3. distance[b, j] = min(distance[b, j], |x_j - c|^2), c the winner's
//      coordinates (the float32 bits in the offer's lanes 1-3), summed as
//      ((dx*dx + dy*dy) + dz*dz) with explicit round-to-nearest
//      intrinsics, so nvcc cannot contract it into FMAs;
//   4. this rank's offer for the next step, offer[b] = {key, x, y, z}:
//      key = float bits of the largest distance << 32 | (2^32 - 1 - its
//      global index), so the largest key is the largest distance at the
//      lowest index (argmax's first occurrence), and the point's
//      coordinate bits, each sign-extended to int64.
// Every output equals the plain version's bit for bit on finite inputs.
//
// What bounds it: bytes. A step reads each point's coordinates and
// running distance and writes the distance back (20 bytes a point); the
// arithmetic is ten operations a point. The launch itself (a few
// microseconds) is as long as the pass over an SA1 shard, so the step loop
// is captured into a CUDA graph by its caller.
//
// What the design does about it: grid (ctas, b). Each CTA takes a
// contiguous chunk of the cloud's shard, its threads striding through it
// (coalesced loads), and reduces its largest key by warp shuffles and
// shared memory. The CTAs of a cloud meet in global memory: each folds
// its key into work[b].best with a 64-bit atomicMax and counts itself in
// work[b].count; the last CTA to arrive (after a fence) takes the best key
// with atomicExch, which also resets it, zeroes the count, and writes the
// offer, reading the winner's coordinates from its own shard. The work
// buffer must be zero before the first step and is zero again after every
// step. The launch goes on the caller's stream, so a graph records it.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr unsigned long long kLow32 = 0xffffffffull;
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long u = __shfl_xor_sync(kFullMask, v, o);
    v = u > v ? u : v;
  }
  return v;
}

__global__ void fps_ring_step_kernel(const float* __restrict__ xyz,
                                     const long long* __restrict__ every, int p,
                                     float* __restrict__ distance,
                                     long long* __restrict__ centroids,
                                     long long* __restrict__ offer,
                                     unsigned long long* __restrict__ work, int b,
                                     int nl, int npoint, int step, long long off,
                                     int chunk) {
  const int cloud = blockIdx.y;
  __shared__ float centre[3];
  __shared__ unsigned long long warp_best[kMaxThreads / 32];
  __shared__ int last;

  // 1-2. the previous step's winner: the largest key over the ranks
  if (threadIdx.x == 0) {
    const long long* row = every + static_cast<long long>(cloud) * 4;
    const long long stride = static_cast<long long>(b) * 4;
    int who = 0;
    long long best = row[0];
    for (int r = 1; r < p; ++r) {
      const long long key = row[r * stride];
      if (key > best) {
        best = key;
        who = r;
      }
    }
    const long long* win = row + who * stride;
    centre[0] = __int_as_float(static_cast<int>(win[1]));
    centre[1] = __int_as_float(static_cast<int>(win[2]));
    centre[2] = __int_as_float(static_cast<int>(win[3]));
    if (blockIdx.x == 0) {
      centroids[static_cast<long long>(cloud) * npoint + step] =
          static_cast<long long>(kLow32 - (static_cast<unsigned long long>(best) & kLow32));
    }
  }
  __syncthreads();
  const float cx = centre[0];
  const float cy = centre[1];
  const float cz = centre[2];

  // 3. the running distances of this CTA's chunk, and its largest key
  const float* pts = xyz + static_cast<long long>(cloud) * nl * 3;
  float* dist = distance + static_cast<long long>(cloud) * nl;
  const int begin = blockIdx.x * chunk;
  const int end = min(nl, begin + chunk);
  unsigned long long mine = 0;
  for (int j = begin + threadIdx.x; j < end; j += blockDim.x) {
    const float dx = __fsub_rn(pts[3 * j], cx);
    const float dy = __fsub_rn(pts[3 * j + 1], cy);
    const float dz = __fsub_rn(pts[3 * j + 2], cz);
    const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                              __fmul_rn(dz, dz));
    const float m = fminf(dist[j], d);
    dist[j] = m;
    const unsigned long long key =
        (static_cast<unsigned long long>(__float_as_uint(m)) << 32) |
        (kLow32 - static_cast<unsigned long long>(off + j));
    mine = key > mine ? key : mine;
  }
  mine = warp_max(mine);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_best[warp] = mine;
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x >> 5;
    mine = lane < warps ? warp_best[lane] : 0ull;
    mine = warp_max(mine);
  }

  // 4. the CTAs of the cloud meet; the last one writes the offer
  unsigned long long* best = work + 2 * cloud;
  unsigned long long* count = best + 1;
  if (threadIdx.x == 0) {
    atomicMax(best, mine);
    __threadfence();
    last = atomicAdd(count, 1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (threadIdx.x == 0 && last) {
    __threadfence();
    const unsigned long long key = atomicExch(best, 0ull);
    atomicExch(count, 0ull);
    const long long local =
        static_cast<long long>(kLow32 - (key & kLow32)) - off;
    const float* q = pts + 3 * local;
    long long* out = offer + static_cast<long long>(cloud) * 4;
    out[0] = static_cast<long long>(key);
    out[1] = static_cast<long long>(__float_as_int(q[0]));
    out[2] = static_cast<long long>(__float_as_int(q[1]));
    out[3] = static_cast<long long>(__float_as_int(q[2]));
  }
}

}  // namespace

// xyz (b, nl, 3) f32, every (p, b, 4) i64, distance (b, nl) f32 (in and
// out), centroids (b, npoint) i64 (column `step` written), offer (b, 4) i64
// (out), work (b, 2) u64 (zero before and after), with `ctas` CTAs of
// `threads` threads (a multiple of 32, at most 1024) per cloud. Needs
// 0 <= off and off + nl <= 2^32 - 1, 3 nl < 2^31, 0 <= step < npoint and
// b <= 65535.
// Returns the CUDA status of the launch.
extern "C" int p2c_fps_ring_step(const float* xyz, const long long* every, int p,
                                 float* distance, long long* centroids,
                                 long long* offer, unsigned long long* work, int b,
                                 int nl, int npoint, int step, long long off,
                                 int ctas, int threads, void* stream) {
  if (b < 1 || b > 65535 || nl < 1 || nl > 0x7fffffff / 3 || p < 1 ||
      npoint < 1 || step < 0 ||
      step >= npoint || off < 0 || off + nl > static_cast<long long>(kLow32) ||
      ctas < 1 || threads < 32 || threads > kMaxThreads || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunk = (nl + ctas - 1) / ctas;
  const dim3 grid(static_cast<unsigned>(ctas), static_cast<unsigned>(b));
  fps_ring_step_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      xyz, every, p, distance, centroids, offer, work, b, nl, npoint, step, off,
      chunk);
  return static_cast<int>(cudaGetLastError());
}
