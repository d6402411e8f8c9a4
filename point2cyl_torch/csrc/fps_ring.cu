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
//      every[:, b] (int64 keys; equal keys name the same point);
//   2. centroids[b, step] = its global index, ~key's low 32 bits;
//   3. distance[b, j] = min(distance[b, j], |x_j - c|^2), c the winner's
//      coordinates (the float32 bits in the offer's lanes 1-3), summed as
//      ((dx*dx + dy*dy) + dz*dz) with explicit round-to-nearest
//      intrinsics, so nvcc cannot contract it into FMAs, the minimum
//      min.NaN (a NaN stays NaN, canonical 0x7fffffff, as torch.minimum);
//   4. this rank's offer for the next step, offer[b] = {key, x, y, z}:
//      key = float bits of the largest distance << 32 | (2^32 - 1 - its
//      global index), so the largest key is the largest distance at the
//      lowest index (argmax's first occurrence; a NaN above inf), and the
//      point's coordinate bits, each sign-extended to int64.
// Every output equals the plain version's bit for bit (a NaN distance is
// a NaN, its payload aside).
//
// What bounds it: bytes. A step reads each point's coordinates and
// running distance and writes the distance back (20 bytes a point); the
// arithmetic is ten operations a point. The launch itself (a few
// microseconds) is as long as the pass over an SA1 shard, so the step loop
// is captured into a CUDA graph by its caller.
//
// What the design does about it: one thread-block cluster a cloud (grid B
// x cluster, the cluster dimension of the launch), so the CTAs of a cloud
// meet in distributed shared memory and no global memory is shared between
// them. Every warp reads the p offers itself (one load a word, all in
// flight together) and takes the winner by redux.sync, so no barrier comes
// before the pass. Each CTA takes a contiguous chunk of the cloud's shard,
// its threads striding through it (coalesced loads), keeps its best point
// with its coordinates, and reduces it by warp (redux.sync, the winner's
// coordinates by shuffles), then by CTA (the warps' records in shared
// memory, one __syncthreads). Lane 0 of warp 0 writes the CTA's record
// {distance bits, ~index, x, y, z} into slot `rank` of the cluster's rank-0
// CTA through distributed shared memory, and one cluster barrier
// (arrive.release / wait.acquire) publishes it; rank 0 reduces the records
// and writes the offer from them, without reading the shard again. A split
// cluster barrier at the start (arrive before the pass, wait after it)
// makes sure every CTA runs before a peer writes into its shared memory.
// Nothing is kept between launches and no buffer needs zeroing. The launch
// goes on the caller's stream, so a graph records it.
//
// Where it falls short on the H100 (PERF.md): one cluster's 16 SMs read a
// large shard at about 55 GB/s each, so at 131,072 points a shard a step
// takes longer than a launch spread over the whole card would.

#include <atomic>
#include <climits>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr unsigned long long kLow32 = 0xffffffffull;
constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 16;
constexpr int kMaxDevices = 16;

// A candidate: the key's halves and the point's coordinates.
struct Cand {
  unsigned bits;  // the running distance's bits (non-negative or canonical NaN)
  unsigned low;   // 2^32 - 1 - the global index; 0 for no point
  float x, y, z;
};

struct alignas(16) Record {
  uint4 head;  // bits, low, x bits, y bits
  float z;
};

__device__ __forceinline__ bool beats(const Cand& b, const Cand& a) {
  return b.bits > a.bits || (b.bits == a.bits && b.low > a.low);
}

// The warp's best candidate, on every lane.
__device__ __forceinline__ Cand warp_best(const Cand& c) {
  Cand w;
  w.bits = __reduce_max_sync(kFullMask, c.bits);
  w.low = __reduce_max_sync(kFullMask, c.bits == w.bits ? c.low : 0u);
  const int src = __ffs(__ballot_sync(kFullMask, c.bits == w.bits && c.low == w.low)) - 1;
  w.x = __shfl_sync(kFullMask, c.x, src);
  w.y = __shfl_sync(kFullMask, c.y, src);
  w.z = __shfl_sync(kFullMask, c.z, src);
  return w;
}

__device__ __forceinline__ Cand load_record(const Record& r) {
  return {r.head.x, r.head.y, __uint_as_float(r.head.z), __uint_as_float(r.head.w), r.z};
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// Four consecutive points of a thread and their running distances.
struct Quad {
  float x[4], y[4], z[4], d[4];
};

// Points [j, j + 4) (those below `end`): with `vec` (16-byte aligned rows,
// j a multiple of 4) three float4 of coordinates and one of distances,
// else one float at a time.
__device__ __forceinline__ Quad load_quad(const float* __restrict__ pts,
                                          const float* __restrict__ dist, int j, int end,
                                          bool vec) {
  Quad q;
  if (vec && j + 4 <= end) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(pts + 3 * j));
    const float4 b = __ldg(reinterpret_cast<const float4*>(pts + 3 * j + 4));
    const float4 c = __ldg(reinterpret_cast<const float4*>(pts + 3 * j + 8));
    const float4 d = *reinterpret_cast<const float4*>(dist + j);
    q.x[0] = a.x; q.y[0] = a.y; q.z[0] = a.z;
    q.x[1] = a.w; q.y[1] = b.x; q.z[1] = b.y;
    q.x[2] = b.z; q.y[2] = b.w; q.z[2] = c.x;
    q.x[3] = c.y; q.y[3] = c.z; q.z[3] = c.w;
    q.d[0] = d.x; q.d[1] = d.y; q.d[2] = d.z; q.d[3] = d.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool in = j + k < end;
      q.x[k] = in ? __ldg(pts + 3 * (j + k)) : 0.0f;
      q.y[k] = in ? __ldg(pts + 3 * (j + k) + 1) : 0.0f;
      q.z[k] = in ? __ldg(pts + 3 * (j + k) + 2) : 0.0f;
      q.d[k] = in ? dist[j + k] : 0.0f;
    }
  }
  return q;
}

__device__ __forceinline__ void store_quad(float* __restrict__ dist, int j, int end, bool vec,
                                           const Quad& q) {
  if (vec && j + 4 <= end) {
    *reinterpret_cast<float4*>(dist + j) = make_float4(q.d[0], q.d[1], q.d[2], q.d[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (j + k < end) dist[j + k] = q.d[k];
    }
  }
}

// Grid B x cluster in clusters of `cluster` CTAs, one a cloud; CTA `rank`
// of cloud b takes the chunk [rank * chunk, min(nl, (rank + 1) * chunk)),
// chunk a multiple of 4; thread t takes points [4 t, 4 t + 4) of it, then
// every 4 x threads.
__global__ void __launch_bounds__(kMaxThreads)
fps_ring_step_kernel(const float* __restrict__ xyz, const long long* __restrict__ every, int p,
                     float* __restrict__ distance, long long* __restrict__ centroids,
                     long long* __restrict__ offer, int b, int nl, int npoint, int step,
                     long long off, int chunk, bool vec) {
  __shared__ Record warp_rec[kMaxThreads / 32];
  __shared__ Record cta_rec[kMaxCluster];  // rank 0: each CTA's record
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int cloud = blockIdx.x / csize;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // every CTA of the cluster has started before a peer writes into it
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  // the first points' loads go out before the offers are read: they do
  // not depend on the centre
  const float* pts = xyz + static_cast<long long>(cloud) * nl * 3;
  float* dist = distance + static_cast<long long>(cloud) * nl;
  const int begin = rank * chunk;
  const int end = min(nl, begin + chunk);
  const int step4 = 4 * blockDim.x;
  int j = begin + 4 * threadIdx.x;
  Quad cur = load_quad(pts, dist, j, end, vec);

  // 1-2. the previous step's winner: the largest key over the ranks, by
  // every warp (lane r takes ranks r, r + 32, ...); equal keys name the
  // same point, so which of them wins does not matter
  long long key = LLONG_MIN;
  float cx = 0.0f, cy = 0.0f, cz = 0.0f;
  for (int r = lane; r < p; r += 32) {
    const long long* o = every + (static_cast<long long>(r) * b + cloud) * 4;
    const long long k = __ldg(o);
    const long long x = __ldg(o + 1);
    const long long y = __ldg(o + 2);
    const long long z = __ldg(o + 3);
    if (k > key) {
      key = k;
      cx = __int_as_float(static_cast<int>(x));
      cy = __int_as_float(static_cast<int>(y));
      cz = __int_as_float(static_cast<int>(z));
    }
  }
  {
    // the signed 64-bit maximum: its high half as signed, then its low
    // half as unsigned, then the lowest lane holding it
    const int hi = static_cast<int>(key >> 32);
    const unsigned lo = static_cast<unsigned>(key);
    const int whi = __reduce_max_sync(kFullMask, hi);
    const unsigned wlo = __reduce_max_sync(kFullMask, hi == whi ? lo : 0u);
    const int src = __ffs(__ballot_sync(kFullMask, hi == whi && lo == wlo)) - 1;
    key = static_cast<long long>(static_cast<unsigned long long>(static_cast<unsigned>(whi))
                                 << 32 | wlo);
    cx = __shfl_sync(kFullMask, cx, src);
    cy = __shfl_sync(kFullMask, cy, src);
    cz = __shfl_sync(kFullMask, cz, src);
  }
  if (rank == 0 && threadIdx.x == 0) {
    centroids[static_cast<long long>(cloud) * npoint + step] =
        static_cast<long long>(kLow32 - (static_cast<unsigned long long>(key) & kLow32));
  }

  // 3. the running distances of this CTA's chunk, four points a thread at
  // a time (the next four's loads in flight), and its best point
  Cand mine = {0u, 0u, 0.0f, 0.0f, 0.0f};
  while (j < end) {
    const Quad next = load_quad(pts, dist, j + step4, end, vec);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (j + k < end) {
        const float dx = __fsub_rn(cur.x[k], cx);
        const float dy = __fsub_rn(cur.y[k], cy);
        const float dz = __fsub_rn(cur.z[k], cz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        cur.d[k] = min_nan(cur.d[k], d);
        const Cand c = {__float_as_uint(cur.d[k]),
                        static_cast<unsigned>(kLow32 -
                                              static_cast<unsigned long long>(off + j + k)),
                        cur.x[k], cur.y[k], cur.z[k]};
        if (beats(c, mine)) mine = c;
      }
    }
    store_quad(dist, j, end, vec, cur);
    cur = next;
    j += step4;
  }
  mine = warp_best(mine);
  if (lane == 0) {
    warp_rec[warp].head = make_uint4(mine.bits, mine.low, __float_as_uint(mine.x),
                                     __float_as_uint(mine.y));
    warp_rec[warp].z = mine.z;
  }
  __syncthreads();

  // 4. the CTAs of the cloud meet in rank 0's shared memory
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (warp == 0) {
    const int warps = blockDim.x >> 5;
    const Cand none = {0u, 0u, 0.0f, 0.0f, 0.0f};
    mine = warp_best(lane < warps ? load_record(warp_rec[lane]) : none);
    if (lane == 0) {
      const uint32_t at = map_rank(shared_addr(&cta_rec[rank]), 0);
      asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(at),
                   "r"(mine.bits), "r"(mine.low), "r"(__float_as_uint(mine.x)),
                   "r"(__float_as_uint(mine.y)) : "memory");
      asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(at + 16u), "f"(mine.z) : "memory");
    }
  }
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
  if (rank != 0 || warp != 0) return;
  const Cand none = {0u, 0u, 0.0f, 0.0f, 0.0f};
  const Cand best = warp_best(lane < csize ? load_record(cta_rec[lane]) : none);
  if (lane == 0) {
    long long* out = offer + static_cast<long long>(cloud) * 4;
    out[0] = static_cast<long long>(static_cast<unsigned long long>(best.bits) << 32 |
                                    best.low);
    out[1] = static_cast<long long>(__float_as_int(best.x));
    out[2] = static_cast<long long>(__float_as_int(best.y));
    out[3] = static_cast<long long>(__float_as_int(best.z));
  }
}

// Clusters of each size and warp count each card holds at once (0: not
// asked yet, -1: none); writers that race store the same answer.
std::atomic<int> g_held[kMaxDevices][kMaxCluster + 1][kMaxThreads / 32 + 1];

}  // namespace

// xyz (b, nl, 3) f32, every (p, b, 4) i64, distance (b, nl) f32 (in and
// out), centroids (b, npoint) i64 (column `step` written), offer (b, 4) i64
// (out), with one cluster of `cluster` CTAs (1-16) of `threads` threads (a
// multiple of 32, at most 1024) a cloud. Needs 0 <= off and off + nl <=
// 2^32 - 1, 3 nl < 2^31, 0 <= step < npoint and b x cluster < 2^31. Returns
// the CUDA status of the launch: a cluster the card cannot hold is
// refused, never shrunk.
extern "C" int p2c_fps_ring_step(const float* xyz, const long long* every, int p,
                                 float* distance, long long* centroids, long long* offer,
                                 int b, int nl, int npoint, int step, long long off,
                                 int cluster, int threads, void* stream) {
  if (b < 1 || nl < 1 || nl > 0x7fffffff / 3 || p < 1 || npoint < 1 || step < 0 ||
      step >= npoint || off < 0 || off + nl > static_cast<long long>(kLow32) || cluster < 1 ||
      cluster > kMaxCluster || static_cast<long long>(b) * cluster > 0x7fffffff ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(fps_ring_step_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(cluster);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(b) * static_cast<unsigned>(cluster));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  std::atomic<int>& known = g_held[dev][cluster][threads / 32];
  int held = known.load(std::memory_order_relaxed);
  if (held == 0) {
    int active = 0;
    err = cudaOccupancyMaxActiveClusters(&active, fps_ring_step_kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    held = active >= 1 ? active : -1;
    known.store(held, std::memory_order_relaxed);
  }
  if (held < 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int chunk = ((nl + cluster - 1) / cluster + 3) / 4 * 4;
  // float4 loads where every cloud's rows start 16-byte aligned
  const bool vec = nl % 4 == 0 && reinterpret_cast<uintptr_t>(xyz) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(distance) % 16 == 0;
  err = cudaLaunchKernelEx(&cfg, fps_ring_step_kernel, xyz, every, p, distance, centroids,
                           offer, b, nl, npoint, step, off, chunk, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
