// Farthest point sampling for Hopper (sm_90a).
//
// Replaces: point2cyl_tpu/ops/pallas_fps.py:_fps_kernel, reached through
// farthest_point_sample_pallas (the pallas_call at pallas_fps.py:94).
//
// What it computes: npoint iterations of "record the current index, update
// each point's running minimum squared distance to the current centre, take
// the argmax (ties to the lowest index) as the next centre", starting from
// start[b] with every distance at 1e10. The indices equal the JAX versions
// and farthest_point_sample_plain bit for bit: the distance is
// ((dx*dx + dy*dy) + dz*dz) with explicit round-to-nearest intrinsics, so
// nvcc cannot contract it into FMAs, and every argmax keeps the lowest
// index among equal maxima, within a thread, a warp and the cluster. The
// running minimum is min.NaN and the maxima are taken on the distances'
// bits, so a NaN distance stays NaN and wins, as torch.minimum and
// torch.argmax (and JAX's) take it.
//
// What bounds it on this card: not bytes (a cloud is read once, 96 KB at
// N=8192) and not operations (about 10 N a step) but the chain of npoint
// dependent steps: each step needs the previous step's argmax over the
// whole cloud. The time is npoint times the latency of one step, and one
// step is a pass over the points, a reduction across every thread that
// holds a point, and a broadcast of the winner.
//
// What the design does about it: a thread-block cluster per cloud (grid
// B x cluster, cudaLaunchKernelEx with a cluster dimension), so a cloud's
// arithmetic is spread over `cluster` SMs, and a step that is a short
// chain of latencies with no CTA-wide or cluster-wide barrier in it. Each
// CTA owns a contiguous slice of the cloud, a run of PPT points a thread,
// kept with their running distances in registers, and a copy of the whole
// cloud in shared memory (to read the next centre). A step is:
//   - every thread updates its points and takes its best by a tree over
//     its slots (largest distance, lowest index);
//   - each warp reduces with two redux.sync: the max of the distance's
//     bits (non-negative floats order as unsigned ints), then the max of
//     ~index over the lanes that hold it, which is the lowest index;
//   - lanes 0..cluster-1 of each warp send the warp's 8-byte record
//     {bits, ~index} into slot (rank, warp) of every CTA of the cluster
//     through distributed shared memory with st.async, each store
//     counting its bytes on the receiving CTA's mbarrier (complete_tx);
//   - each CTA waits on its own mbarrier until all records of the step
//     have landed;
//   - each warp reduces all records from its own shared memory the same
//     way and reads the next centre's coordinates from its copy.
// The record slots and their mbarriers are double-buffered by step
// parity. A CTA cannot send step s+2's records before it has every CTA's
// record of step s+1, and each CTA sends those only after it has read
// step s's buffer, so a buffer is never overwritten while it is read and
// a barrier's phases never mix. A cluster barrier at the start (after the
// mbarriers are initialised) and one at the end keep every CTA's shared
// memory alive while a peer can write into it. An earlier form of this
// design, with 20-byte records and a cluster barrier (arrive.release /
// wait.acquire) in every step, was slower than one block a cloud on the
// H100: about 1.2 us a step. This one reaches about 0.46 us a step at
// SA1 (B=16, cluster 8 x 128 threads); PERF.md has the measurements.
//
// The launch plan (cluster size, threads per CTA) comes from the caller
// (ops/cuda_fps.py:fps_launch_plan); a cluster the card cannot schedule
// is an error, never shrunk.

#undef NDEBUG  // the start-index check below must stay in every build
#include <cassert>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxPPT = 8;
constexpr int kMaxCluster = 16;
constexpr int kMaxSmem = 232448;  // 227 KB a block may opt into on sm_90
constexpr unsigned kFullMask = 0xffffffffu;

// min with NaN propagation, as torch.minimum: a canonical NaN (0x7fffffff,
// above inf's bits) if either is.
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
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

// A store into a peer's shared memory that counts its bytes on the
// peer's barrier `bar` (both cluster addresses from map_rank).
__device__ __forceinline__ void st_async(uint32_t addr, uint2 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];"
      ::"r"(addr), "r"(v.x), "r"(v.y), "r"(bar) : "memory");
}

// Shared memory of one CTA: records [2][nrec] as uint2 {distance bits,
// ~index}, then the whole cloud's coordinates x|y|z [n] each.
__host__ __device__ constexpr size_t smem_bytes(int nrec, int n) {
  return static_cast<size_t>(nrec) * 2 * sizeof(uint2) +
         static_cast<size_t>(n) * 3 * sizeof(float);
}

// The larger of two records: the larger distance, then the lower index
// (the larger ~index).
__device__ __forceinline__ uint2 larger(uint2 a, uint2 b) {
  return (b.x > a.x || (b.x == a.x && b.y > a.y)) ? b : a;
}

// PPT: points a thread. CTA `rank` of cloud b owns indices
// [rank * slice, (rank + 1) * slice) with slice = PPT * blockDim.x, and its
// thread t the run rank * slice + t * PPT + k, k < PPT, so a thread's slots
// run in increasing index order and its tree keeps the lowest index of a
// tie. A slot past the end of the cloud holds a copy of point 0 under its
// own index (>= n): it ties with point 0 at every step and loses the tie,
// so it never wins.
template <int PPT>
__global__ void __launch_bounds__(kMaxThreads)
fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start, int n,
           int npoint, int* __restrict__ out) {
  extern __shared__ uint2 smem[];
  __shared__ uint64_t full[2];  // a barrier per record buffer
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int b = blockIdx.x / csize;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const int nrec = csize * nwarps;
  const int lo = rank * PPT * nthreads + tid * PPT;  // this thread's first index

  uint2* rec = smem;  // [2][nrec]
  float* sx = reinterpret_cast<float*>(smem + 2 * nrec);
  float* sy = sx + n;
  float* sz = sy + n;
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  for (int t = tid; t < 3 * n; t += nthreads) {
    const int j = t / 3;
    sx[(t - 3 * j) * n + j] = p[t];
  }
  int far = start[b];
  assert(far >= 0 && far < n && "FPS start index out of range");
  int* row_out = out + static_cast<size_t>(b) * npoint;
  if (tid == 0) {
    mbar_init(shared_addr(&full[0]), 1);
    mbar_init(shared_addr(&full[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // lane r < cluster size sends this warp's records to CTA r
  const uint32_t to = lane < csize ? lane : 0;
  const uint32_t peer_rec = map_rank(shared_addr(rec), to);
  const uint32_t peer_full = map_rank(shared_addr(full), to);
  const uint32_t step_bytes = static_cast<uint32_t>(nrec) * sizeof(uint2);
  // records [first, last) of the buffer are this lane's to reduce
  const int per_lane = (nrec + 31) >> 5;
  const int first = min(lane * per_lane, nrec);
  const int last = min(first + per_lane, nrec);
  // every CTA of the cluster runs, its barriers are initialised and its
  // copy of the cloud is staged before any record crosses to a peer
  cluster_barrier();

  float px[PPT], py[PPT], pz[PPT], dist[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int j = lo + k < n ? lo + k : 0;
    px[k] = sx[j];
    py[k] = sy[j];
    pz[k] = sz[j];
    dist[k] = 1e10f;
  }

  for (int it = 0;; ++it) {
    if (rank == 0 && tid == 0) row_out[it] = far;
    if (it + 1 == npoint) break;  // the last centre needs no update
    const float cx = sx[far];
    const float cy = sy[far];
    const float cz = sz[far];

    // update the running distances, then a tree argmax over the slots'
    // bits; the later slot wins only when strictly larger
    float m[PPT];
    int mk[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const float dx = __fsub_rn(px[k], cx);
      const float dy = __fsub_rn(py[k], cy);
      const float dz = __fsub_rn(pz[k], cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      dist[k] = min_nan(dist[k], d);
      m[k] = dist[k];
      mk[k] = k;
    }
#pragma unroll
    for (int step = 1; step < PPT; step <<= 1) {
#pragma unroll
      for (int k = 0; k + step < PPT; k += 2 * step) {
        if (__float_as_uint(m[k + step]) > __float_as_uint(m[k])) {
          m[k] = m[k + step];
          mk[k] = mk[k + step];
        }
      }
    }

    // the warp's record: its largest distance (non-negative floats order
    // as their bits), then its lowest index (the largest ~index)
    const unsigned bits = __float_as_uint(m[0]);
    const unsigned wbits = __reduce_max_sync(kFullMask, bits);
    const unsigned wlow = __reduce_max_sync(
        kFullMask, bits == wbits ? ~static_cast<unsigned>(lo + mk[0]) : 0u);
    const int parity = it & 1;
    const int buf = parity * nrec;
    if (lane < csize) {
      // into slot (rank, warp) of CTA `lane`, counted on its barrier
      st_async(peer_rec + (buf + rank * nwarps + warp) * 8u, make_uint2(wbits, wlow),
               peer_full + parity * 8u);
    }
    // this CTA expects nrec records in the buffer: the (it / 2)-th use
    if (tid == 0) mbar_arrive_expect(shared_addr(&full[parity]), step_bytes);
    mbar_wait(shared_addr(&full[parity]), (it >> 1) & 1);

    // every warp reduces every record from its own shared memory
    uint2 r = first < last ? rec[buf + first] : make_uint2(0u, 0u);  // 0: below all
    for (int k = first + 1; k < last; ++k) r = larger(r, rec[buf + k]);
    const unsigned gbits = __reduce_max_sync(kFullMask, r.x);
    far = static_cast<int>(~__reduce_max_sync(kFullMask, r.x == gbits ? r.y : 0u));
  }
  // no CTA leaves while a peer may still write into its shared memory
  cluster_barrier();
}

// Schedulability of each (PPT, cluster, warps) plan, from
// cudaOccupancyMaxActiveClusters: 0 unknown, 1 schedulable, -1 not.
int g_schedulable[kMaxPPT + 1][kMaxCluster + 1][kMaxThreads / 32 + 1];

template <int PPT>
cudaError_t launch(const float* xyz, const int* start, int* out, int b, int n,
                   int npoint, int cluster, int threads, cudaStream_t stream) {
  const size_t smem = smem_bytes(cluster * (threads / 32), n);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fps_kernel<PPT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if (cluster > 8) {
    err = cudaFuncSetAttribute(fps_kernel<PPT>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(cluster);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(b) * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int& known = g_schedulable[PPT][cluster][threads / 32];
  if (known == 0) {
    int active = 0;
    err = cudaOccupancyMaxActiveClusters(&active, fps_kernel<PPT>, &cfg);
    if (err != cudaSuccess) return err;
    known = active >= 1 ? 1 : -1;
  }
  // a cluster the card cannot hold is refused, not shrunk
  if (known < 0) return cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, fps_kernel<PPT>, xyz, start, n, npoint, out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// xyz (b, n, 3) f32, start (b,) i32 -> out (b, npoint) i32, with the launch
// plan `cluster` CTAs (1-16) of `threads` threads (a multiple of 32, at most
// 512) per cloud. Needs 1 <= npoint <= n <= 16384 and at most 8 points a
// thread (ceil(ceil(n / cluster) / threads) <= 8). Returns the CUDA status
// of the launch. A start index outside [0, n) fails the kernel's
// device-side assert.
extern "C" int p2c_fps(const float* xyz, const int* start, int* out, int b,
                       int n, int npoint, int cluster, int threads,
                       void* stream) {
  if (b < 1 || n < 1 || n > 16384 || npoint < 1 || npoint > n ||
      cluster < 1 || cluster > kMaxCluster || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 ||
      static_cast<long long>(b) * cluster > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per_cta = (n + cluster - 1) / cluster;
  const int ppt = (per_cta + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (ppt) {
    case 1: err = launch<1>(xyz, start, out, b, n, npoint, cluster, threads, s); break;
    case 2: err = launch<2>(xyz, start, out, b, n, npoint, cluster, threads, s); break;
    case 3: err = launch<3>(xyz, start, out, b, n, npoint, cluster, threads, s); break;
    case 4: err = launch<4>(xyz, start, out, b, n, npoint, cluster, threads, s); break;
    case 5: err = launch<5>(xyz, start, out, b, n, npoint, cluster, threads, s); break;
    case 6: err = launch<6>(xyz, start, out, b, n, npoint, cluster, threads, s); break;
    case 7: err = launch<7>(xyz, start, out, b, n, npoint, cluster, threads, s); break;
    case 8: err = launch<8>(xyz, start, out, b, n, npoint, cluster, threads, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
