// Farthest point sampling over clouds beyond fps.cu's 16,384 points, up to
// kClusterCapacity (131,072), for Hopper (sm_90a): one thread-block
// cluster a cloud.
//
// Replaces: point2cyl_tpu/ops/pallas_fps.py:_fps_kernel (the pallas_call
// at pallas_fps.py:94) above the sizes fps.cu takes. The TPU kernel tiles
// the batch and holds a whole cloud in VMEM; fps.cu keeps a copy of the
// whole cloud in each CTA's shared memory, which caps it at 16,384 points.
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
// the bytes (the cloud read once) are far below one step's latency chain:
// a step is a pass over registers, a reduction across the CTAs of the
// cloud and a broadcast of the winner.
//
// What the design does about it: one launch a call, all steps inside it,
// and a cloud's CTAs meet in distributed shared memory, never in global
// memory. A cloud runs on one cluster of `ctas` CTAs (grid B x ctas, the
// cluster dimension of the launch); each thread keeps kGridPPT points and
// their running distances in registers for the whole call, so no CTA keeps
// a copy of the cloud: every record that crosses a CTA carries the
// candidate's coordinates beside {distance bits, ~index}, and every CTA
// knows the next centre without reading memory. A step is:
//   - every thread updates its points and keeps its best (its points run in
//     increasing index order, so a strict comparison keeps the lowest index
//     of a tie) and that point's coordinates;
//   - each warp reduces with two redux.sync (the largest distance bits,
//     then the largest ~index among the lanes that hold them) and takes the
//     winner's coordinates from its lane by shuffles;
//   - warp 0 reduces the warps' records (one __syncthreads), and its lanes
//     0..cluster-1 send the CTA's record to every CTA of the cluster, as
//     fps.cu sends its warps': two st.async (16 + 4 bytes) into the
//     receiver's step-parity buffer, counted on its mbarrier;
//   - every warp waits on its own CTA's mbarrier and reduces the cluster's
//     records itself: the next centre.
// No global memory, no cluster barrier and no buffer of the caller inside
// a step; clusters need not be resident together, so any B runs, in
// waves. On the H100 the meeting costs about 0.4 us a step (PERF.md).
//
// The record buffers and mbarriers are double-buffered by step parity, as
// in fps.cu: a CTA cannot send step s+2's record before it has every
// record of step s+1, and each CTA sends that only after all its warps
// have read step s's buffer. A cluster barrier at the start (after the
// mbarriers are initialised) and one at the end keep every CTA's shared
// memory alive while a peer can write into it.
//
// The launch plan (CTAs, threads) comes from the caller
// (ops/cuda_fps.py:fps_grid_plan); a cluster the card cannot schedule is
// an error, never shrunk.

#undef NDEBUG  // the start-index check below must stay in every build
#include <atomic>
#include <cassert>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fps_grid_layout.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxDevices = 16;

// A candidate for the next centre.
struct Cand {
  unsigned bits;  // the running distance's bits (non-negative or canonical NaN)
  unsigned low;   // ~index: the larger, the lower index
  float x, y, z;
};

// A record in shared memory.
struct alignas(16) Record {
  uint4 head;  // bits, low, x bits, y bits
  float z;
  unsigned pad[3];
};
static_assert(sizeof(Record) == kRecordStride, "records are kRecordStride bytes apart");

__device__ __forceinline__ Cand no_cand() { return {0u, 0u, 0.0f, 0.0f, 0.0f}; }

__device__ __forceinline__ Cand load_record(const Record& r) {
  return {r.head.x, r.head.y, __uint_as_float(r.head.z), __uint_as_float(r.head.w), r.z};
}

__device__ __forceinline__ uint4 head_of(const Cand& c) {
  return make_uint4(c.bits, c.low, __float_as_uint(c.x), __float_as_uint(c.y));
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

__device__ __forceinline__ void cluster_barrier() {
  asm volatile(
      "barrier.cluster.arrive.release;\n\t"
      "barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address of the same shared-memory location in CTA `rank` of the
// cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// The barrier's one arrival of a phase, which also expects `bytes` of
// st.async data before the phase can complete.
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t"
      ".reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t"
      "}" ::"r"(bar), "r"(parity) : "memory");
}

// A record into a peer's shared memory (cluster address `addr`), both
// stores counted on the peer's barrier `bar`: kRecordBytes in all.
__device__ __forceinline__ void send_record(uint32_t addr, const Cand& c, uint32_t bar) {
  const uint4 h = head_of(c);
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(addr), "r"(h.x), "r"(h.y), "r"(h.z), "r"(h.w), "r"(bar) : "memory");
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
      ::"r"(addr + 16u), "r"(__float_as_uint(c.z)), "r"(bar) : "memory");
}

// Grid B x ctas in clusters of ctas. CTA `rank` of cloud b holds indices
// rank * T * kGridPPT + k * T + t, k < kGridPPT (increasing in k), for
// thread t. A slot past the end of the cloud holds a copy of point 0 under
// its own index (>= n): it ties with point 0 at every step and loses the
// tie, so it never wins.
__global__ void __launch_bounds__(kGridMaxThreads, 1)
fps_cluster_kernel(const float* __restrict__ xyz, const int* __restrict__ start, int n,
                   int npoint, int* __restrict__ out) {
  __shared__ Record rec[2][kClusterMaxCtas];        // received, one a CTA, by step parity
  __shared__ Record wrec[2][kGridMaxThreads / 32];  // this CTA's warps', by step parity
  __shared__ uint64_t full[2];                      // a barrier per received buffer
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int b = blockIdx.x / csize;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  const int first = rank * nthreads * kGridPPT + tid;

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
  int far = start[b];
  assert(far >= 0 && far < n && "FPS start index out of range");
  float cx = p[3 * far];
  float cy = p[3 * far + 1];
  float cz = p[3 * far + 2];
  if (tid == 0) {
    mbar_init(shared_addr(&full[0]), 1);
    mbar_init(shared_addr(&full[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // lane r < cluster size of warp 0 sends the CTA's record to CTA r
  const uint32_t to = lane < csize ? lane : 0;
  const uint32_t peer_rec = map_rank(shared_addr(&rec[0][rank]), to);
  const uint32_t peer_full = map_rank(shared_addr(full), to);
  const uint32_t step_bytes = static_cast<uint32_t>(csize) * kRecordBytes;
  // every CTA of the cluster runs and its barriers are initialised before
  // any record crosses to a peer
  cluster_barrier();

  for (int it = 0;; ++it) {
    if (rank == 0 && tid == 0) out[static_cast<size_t>(b) * npoint + it] = far;
    if (it + 1 == npoint) break;  // the last centre needs no update

    // this thread's best, in increasing index order
    Cand c;
    dist[0] = min_nan(dist[0], sq_dist(px[0], py[0], pz[0], cx, cy, cz));
    c.bits = __float_as_uint(dist[0]);
    c.low = ~static_cast<unsigned>(first);
    c.x = px[0];
    c.y = py[0];
    c.z = pz[0];
#pragma unroll
    for (int k = 1; k < kGridPPT; ++k) {
      dist[k] = min_nan(dist[k], sq_dist(px[k], py[k], pz[k], cx, cy, cz));
      const unsigned kb = __float_as_uint(dist[k]);
      if (kb > c.bits) {
        c.bits = kb;
        c.low = ~static_cast<unsigned>(first + k * nthreads);
        c.x = px[k];
        c.y = py[k];
        c.z = pz[k];
      }
    }
    const Cand w = warp_best(c);
    const int par = it & 1;
    if (lane == 0) {
      wrec[par][warp].head = head_of(w);
      wrec[par][warp].z = w.z;
    }
    __syncthreads();
    // warp 0: the CTA's record, to every CTA of the cluster
    if (warp == 0) {
      const Cand mine = warp_best(lane < nwarps ? load_record(wrec[par][lane]) : no_cand());
      if (lane < csize) {
        send_record(peer_rec + static_cast<uint32_t>(par * kClusterMaxCtas) * kRecordStride,
                    mine, peer_full + par * 8u);
      }
    }
    // every warp: the cluster's records, the (it / 2)-th use of the buffer
    if (tid == 0) mbar_arrive_expect(shared_addr(&full[par]), step_bytes);
    mbar_wait(shared_addr(&full[par]), (it >> 1) & 1);
    const Cand r = warp_best(lane < csize ? load_record(rec[par][lane]) : no_cand());
    cx = r.x;
    cy = r.y;
    cz = r.z;
    far = static_cast<int>(~r.low);
  }
  // no CTA leaves while a peer may still write into its shared memory
  cluster_barrier();
}

// Clusters of each size and warp count each card holds at once (0: not
// asked yet, -1: none); writers that race store the same answer.
std::atomic<int> g_held[kMaxDevices][kClusterMaxCtas + 1][kGridMaxThreads / 32 + 1];

}  // namespace

// xyz (b, n, 3) f32, start (b,) i32 -> out (b, npoint) i32, each cloud on
// one cluster of `ctas` CTAs (1-16) of `threads` threads (a multiple of 32,
// at most kGridMaxThreads) whose registers hold it at kGridPPT points a
// thread. Needs 1 <= npoint <= n and 3 n < 2^31. Returns the CUDA status of
// the launch: a cluster the card cannot hold is refused, never shrunk. A
// start index outside [0, n) fails the kernel's device-side assert.
extern "C" int p2c_fps_cluster(const float* xyz, const int* start, int* out, int b, int n,
                               int npoint, int ctas, int threads, void* stream) {
  if (b < 1 || n < 1 || n > 0x7fffffff / 3 || npoint < 1 || npoint > n || ctas < 1 ||
      ctas > kClusterMaxCtas || threads < 32 || threads > kGridMaxThreads ||
      threads % 32 != 0 || static_cast<long long>(ctas) * threads * kGridPPT < n ||
      static_cast<long long>(b) * ctas > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  if (ctas > 8) {
    err = cudaFuncSetAttribute(fps_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(ctas);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(b) * static_cast<unsigned>(ctas));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  std::atomic<int>& known = g_held[dev][ctas][threads / 32];
  int held = known.load(std::memory_order_relaxed);
  if (held == 0) {
    int active = 0;
    err = cudaOccupancyMaxActiveClusters(&active, fps_cluster_kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    held = active >= 1 ? active : -1;
    known.store(held, std::memory_order_relaxed);
  }
  if (held < 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaLaunchKernelEx(&cfg, fps_cluster_kernel, xyz, start, n, npoint, out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
