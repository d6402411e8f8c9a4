// Ball query, with and without fused neighbour gather, for Hopper
// (sm_90a).
//
// Replaces three TPU kernels of point2cyl_tpu/ops/pallas_ballquery.py:
//   - _ballquery_kernel (pallas_call at :580, reached through
//     ball_query_pallas): indices only. SA1 whenever N <= 1024 (the N=512
//     A/B protocol) and any stage the fused kernels below do not cover.
//     Entry point p2c_ball_query.
//   - _ballquery_grouped_kernel (pallas_call at :637, reached through
//     ball_query_grouped_pallas / ball_query_grouped): ball query, then
//     grouped = xyz[idx] - centre. SA1 of the backbone (N=8192, no
//     features). Entry point p2c_ball_query_grouped; above 11,944 points
//     p2c_ball_query_stream.
//   - _sa_grouped_exact_kernel (pallas_call at :474, reached through
//     sa_grouped_exact_pallas / sa_grouped_exact): exact ball query, then
//     grouped = [xyz[idx] - centre | feats[idx]]. SA2 (N=512, C=128).
//     Entry point p2c_sa_grouped_features.
// The gathers' backwards (_bqg_scatter_kernel at SA1,
// _sa_exact_scatter_kernel at SA2) are p2c_sa_grouped_backward in
// target_sum.cu: ordered per-target sums.
//
// What the forward computes: for each query centre, the first nsample
// point indices (ascending) whose squared distance is <= r2, short rows
// padded with the first one (a row with none gives n-1), and, for the
// fused entry points, the gathered rows in the layout (b, s, nsample,
// 3 [+ c]). Selection is exact at every N: the TPU kernel's blocked
// selection above N=1024 is not reproduced. The distance is
// ((dx*dx + dy*dy) + dz*dz) of exact differences with explicit
// round-to-nearest intrinsics (no FMA), so membership equals the JAX
// Pallas kernels (pallas_ballquery.py:_exact_d) bit for bit. The gather
// copies values, so it is exact where the TPU's one-hot matmul gather is
// about 1e-5 off.
//
// What bounds each forward on this card, and what its design does:
//   - SA1 (p2c_ball_query_grouped, N=8192 -> 512, r=0.2, nsample 64):
//     the selection. An index-order scan tests ~78% of N per query (a
//     query has ~82 points in its ball on the unit sphere and stops at
//     the 64th): 52 M tests at B=16, 93% of the earlier kernel's time;
//     the write is 6.3 MB. So each CTA builds a cell grid of its batch
//     row in shared memory (ball_query_grid_kernel). It reads the row
//     from global memory once (16-byte loads into x|y|z planes in index
//     order, the bounding box of the finite points taken on the way),
//     picks a cell edge >= r2^(1/2) * (1 + 2^-6), enlarged until the grid
//     has at most kMaxCells cells, gives each point its cell and its rank
//     there (a shared atomic on the cell's count), scans the counts into
//     cell starts and lists the indices in cell order (uint16). A warp
//     then serves a query from the 3 x 3 runs of three x-adjacent cells
//     around the query's cell, each run one contiguous range of the list,
//     laid end to end and tested 64 candidates a step (an index from the
//     list, then its coordinates from the planes): ~280 tests instead of
//     ~6,400. The in-radius indices go into the warp's bitmap
//     of N bits (shared atomicOr); lane l reads out a run of 2^sh words,
//     the runs in index order, and one prefix over the lanes' popcounts
//     gives each index its rank: the first nsample ascending, whatever the
//     order within a cell. A pad word after each lane's run puts the 32
//     lanes' reads on 32 banks. A query whose runs hold more than `cap`
//     candidates (a dense cluster, or a grid that the cell cap made
//     coarse) scans the row in index order instead, inside the same
//     kernel; so does every query of a row whose box is not finite or
//     whose radius gives no usable edge. The plan (CTAs a row, warps a
//     CTA, cap) comes from the caller (ops/cuda_ballquery.py:
//     ball_query_plan), which takes the streamed query below for rows
//     whose grid does not fit shared memory (N above 11,944 at nsample
//     64), where the index-order scan of the staged row lost to it
//     (PERF.md). Permuting the planes into cell order, so that a
//     candidate's coordinates sit beside its neighbours', cost more in
//     the build than it saved in the tests (PERF.md).
//   - SA1 where the grid does not fit (N above 11,944 at nsample 64;
//     p2c_ball_query_stream, also idx only from 1,536 points): the grid
//     and the scan both stage the whole row in shared memory, which caps
//     them; the TPU kernel walks the cloud in blocks and takes any N. A
//     query needs the row up to its nsample-th in-radius point: on the
//     unit sphere at r = 0.2 a ball holds 1% of the cloud, so about 6,400
//     points (at most ~9,300 over 512 centres) at every N. The earlier
//     design (a warp a query, tiles of 2,048 points by cp.async) spent ~6
//     us a tile on its chain of 64 dependent ballots and a tile's waits:
//     34-37 us a call, 12.5 over one tile (PERF.md). Now `group` warps
//     serve a query and test each staged block at once, so a query's
//     chain is a few blocks long; by clock stamps (the kernel's kProbe
//     instantiation) a block's tests are then issue-bound (about
//     11 instructions a test: 3 sub, 3 mul, 2 add, a compare and a select
//     of the exact distance, and a quarter of three 16-byte loads for 4
//     points), placing the hits costs about as much again, and the copies
//     are bound by L2 handing every SM the same prefix of the row.
//     ball_query_stream_kernel (below) copies the row in blocks of 1,024
//     x group points with one bulk copy each (cp.async.bulk, completion
//     on an mbarrier, 3 in flight), ranks a warp's hits with one packed
//     prefix over its lanes, and meets once a block (__syncthreads). The
//     plan (ops/cuda_ballquery.py: ball_query_plan) gives 4 queries of 4
//     warps a CTA at B=1 and S=512 and 16 of 2 at B=4. Measured and not
//     kept (PERF.md): clusters of 2-8 CTAs fed by one multicast bulk copy
//     (meeting across the cluster cost 0.85-1.1 us a block against 0.19
//     for a CTA alone, and clusters of 4 at B=1 started in two waves); a
//     meeting of each query's warps alone on its own barrier, without the
//     CTA's, and placing a block's hits during the next block's tests (no
//     faster).
//   - Coverage of the grid. Let t = fl(fl(p - lo) * inv) be a coordinate's
//     cell position, inv = fl(1 / e). A pair passes the float test only if
//     fl(d_a^2) <= r2 on every axis a (the partial sums are monotone and
//     the terms non-negative), so |p_a - c_a| <= r2^(1/2) * (1 + 2u),
//     u = 2^-24, and |p_a - c_a| / e <= (1 + 2u) / (1.015625 (1 - 2u))
//     < 0.9847. Each t carries a relative error below 3.01u and |t| <=
//     4097 for any point of the box and any query within a cell of it, so
//     the computed positions differ by less than 0.9847 + 2^-9 < 1 and
//     their floors by at most 1. The cell index is that floor clamped (in
//     float, before the conversion, so NaN and inf cannot overflow it) to
//     [0, dim - 1], which keeps a difference of at most 1: every in-radius
//     point lies in the 27 cells around the query's. Points with a
//     non-finite coordinate are never in radius (their distance is NaN or
//     inf), so they stay out of the grid, as they fail the scan's test.
//   - SA2 (p2c_sa_grouped_features, N=512 -> 128, r=0.4, nsample 64,
//     C=128): the write. The grouped tensor is 69 MB at B=16 and the
//     earlier kernel wrote it with dependent 4-byte gather-store chains at
//     0.92 TB/s. Selection stays the index-order scan (16 ballot steps,
//     4 a pass). A CTA takes its queries in rounds of one a warp: each
//     warp selects its query into shared slots, then all warps write the
//     round's (nsample, 3 + c) rows, a warp a row. A lane reads 16 bytes
//     of the neighbour's feature row (L1: a query's ~20 distinct rows are
//     10 KB) and stores them as the row's offset from a 16-byte boundary
//     allows (one 16-byte store, two of 8, or 4 + 8 + 4 bytes) into a
//     shared buffer that holds the query's whole block, which thread 0
//     sends with one bulk copy (cp.async.bulk.global.shared::cta, two
//     buffers, so composing the next block overlaps the copy). A TMA
//     tensor map cannot describe the output: a row is 524 bytes, not a
//     multiple of 16. The bulk copy needs c % 4 == 0, nsample * (3 + c) %
//     4 == 0 and 16-byte aligned feats and grouped; else, or where its two
//     buffers do not fit shared memory, a lane reads and stores 4 bytes
//     straight into `grouped`. 16-byte stores from registers, without the
//     shared block, measured slower than both (PERF.md) and are not kept.
//   - The idx-only query (p2c_ball_query; SA1 of the N=512 protocol: N=512,
//     S=512, nsample 64, B=8): by the roofline its bytes (the 1 MB of
//     indices written, 0.34 us), in practice the launch and the latency of
//     a few dependent steps. A ball on the unit sphere at r=0.2 holds
//     about 5 of 512 points, so an index-order scan with an early stop
//     runs all 16 of its ballot steps anyway, each waiting on the last's
//     count. Up to kBallotMaxN points (ball_query_ballot_kernel) a warp
//     serves one query with no shared staging and no __syncthreads: it
//     reads the row through L1 (__ldg; the CTA's other warps read the
//     same 6 KB), lane l the 4 adjacent points 4 l .. 4 l + 3 of each
//     block of 128 with three 16-byte loads (a lane a point and a step
//     of 32, the first build, took three 4-byte loads of 12-byte-strided
//     addresses a point: three times the L1 wavefronts, PERF.md), all
//     blocks' tests independent; one warp prefix over the lanes' counts,
//     a byte for each block packed into 64 bits, ranks every hit, each
//     lane places its hits below nsample into the warp's slots, and the
//     lanes write the padded row, 16 bytes a lane where it is aligned. 32
//     warps a CTA: S / 32 CTAs a row, 128 at B=8, one wave. Above that,
//     below 1,536 points, the index-order scan of the staged row
//     (ball_query_scan_kernel), a warp a query, with its stop; from 1,536
//     points SA1's streamed query without its gather, which beat the scan
//     there at B=1, 4 and 16 and lost to it at 1,025 points (PERF.md).

#include <cstdint>

#include <cuda_runtime.h>

#include "ballquery_layout.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxSmem = 232448;  // 227 KB a block may opt into on sm_90
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float sq_dist(float ax, float ay, float az, float bx,
                                         float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// NaN fails the comparison, +-inf exceeds the largest float
__device__ __forceinline__ bool finite_f(float x) { return fabsf(x) <= 3.40282347e38f; }

__device__ __forceinline__ bool finite3(float x, float y, float z) {
  return finite_f(x) && finite_f(y) && finite_f(z);
}

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ void box_add(float x, float y, float z, float* lo, float* hi) {
  if (finite3(x, y, z)) {
    lo[0] = fminf(lo[0], x);
    lo[1] = fminf(lo[1], y);
    lo[2] = fminf(lo[2], z);
    hi[0] = fmaxf(hi[0], x);
    hi[1] = fmaxf(hi[1], y);
    hi[2] = fmaxf(hi[2], z);
  }
}

// Stage a batch row p (n points, (n, 3)) as planes x | y | z of stride n4
// = round_up(n, 4) from sx on, then __syncthreads. vec: p is 16-byte
// aligned and n % 4 == 0, so a thread moves 4 points with three 16-byte
// loads and stores. kBox: also this thread's share of the bounding box
// [lo, hi] of the row's finite points, from the registers of the 16-byte
// path, else from the planes once staged.
template <bool kBox>
__device__ __forceinline__ void stage_planes(const float* __restrict__ p, int n, int n4,
                                             float* sx, bool vec, float* lo = nullptr,
                                             float* hi = nullptr) {
  float* sy = sx + n4;
  float* sz = sy + n4;
  if (vec) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll 2
    for (int k = threadIdx.x; k < n / 4; k += blockDim.x) {
      const float4 a = p4[3 * k];      // x0 y0 z0 x1
      const float4 b = p4[3 * k + 1];  // y1 z1 x2 y2
      const float4 c = p4[3 * k + 2];  // z2 x3 y3 z3
      reinterpret_cast<float4*>(sx)[k] = make_float4(a.x, a.w, b.z, c.y);
      reinterpret_cast<float4*>(sy)[k] = make_float4(a.y, b.x, b.w, c.z);
      reinterpret_cast<float4*>(sz)[k] = make_float4(a.z, b.y, c.x, c.w);
      if constexpr (kBox) {
        box_add(a.x, a.y, a.z, lo, hi);
        box_add(a.w, b.x, b.y, lo, hi);
        box_add(b.z, b.w, c.x, lo, hi);
        box_add(c.y, c.z, c.w, lo, hi);
      }
    }
  } else {
#pragma unroll 4
    for (int t = threadIdx.x; t < 3 * n; t += blockDim.x) {
      const int j = t / 3;
      sx[(t - 3 * j) * n4 + j] = p[t];
    }
  }
  __syncthreads();
  if constexpr (kBox) {
    if (!vec) {
#pragma unroll 4
      for (int j = threadIdx.x; j < n; j += blockDim.x) box_add(sx[j], sy[j], sz[j], lo, hi);
    }
  }
}

// The first ns in-radius indices of the row in index order into sel, 32
// points a step: a ballot of the in-radius test, a popc prefix for each
// lane's slot, and a stop at ns. kUnroll steps a pass, their loads and
// tests independent, the stop checked once a pass. The row is the planes
// x | y | z of stride n4 from sx on. Returns the in-radius count up to the
// stop (>= ns: the row is full).
template <int kUnroll>
__device__ __forceinline__ int scan_select(const float* sx, int n4, int n, float cx,
                                           float cy, float cz, float r2, int ns, int* sel,
                                           int lane) {
  int count = 0;  // warp-uniform
  for (int base = 0; base < n && count < ns; base += 32 * kUnroll) {
    unsigned hits[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + 32 * u + lane;
      hits[u] = __ballot_sync(
          kFullMask, j < n && sq_dist(cx, cy, cz, sx[j], sx[n4 + j], sx[2 * n4 + j]) <= r2);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if ((hits[u] >> lane) & 1u) {
        const int pos = count + __popc(hits[u] & ((1u << lane) - 1u));
        if (pos < ns) sel[pos] = base + 32 * u + lane;
      }
      count += __popc(hits[u]);
    }
  }
  return count;
}

// Pad a row of `count` in-radius indices to ns slots with its first, or
// with n - 1 where it has none, and write its indices (unless idx_row is
// null).
__device__ __forceinline__ void finish_slots(int* sel, int count, int ns, int n,
                                             int* __restrict__ idx_row, int lane) {
  __syncwarp();
  const int found = count < ns ? count : ns;
  const int first = found > 0 ? sel[0] : n - 1;
  for (int t = found + lane; t < ns; t += 32) sel[t] = first;
  __syncwarp();
  if (idx_row != nullptr) {
    for (int t = lane; t < ns; t += 32) idx_row[t] = sel[t];
  }
}

// A warp writes a query's contiguous (ns, 3) block of centred coordinates
// to dst, V floats a lane (V = 4 needs ns * 3 % 4 == 0 and a 16-byte
// aligned dst); coord(j, ch) reads coordinate ch of point j (from the
// planes in shared memory, or from the row in global memory).
template <int V, typename Coord>
__device__ __forceinline__ void write_coords(float* dst, Coord coord, const int* sel, int ns,
                                             float cx, float cy, float cz, int lane) {
  const int total = ns * 3 / V;
  for (int v = lane; v < total; v += 32) {
    int slot = V * v / 3;
    int ch = V * v - 3 * slot;
    float val[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float centre = ch == 0 ? cx : (ch == 1 ? cy : cz);
      val[i] = __fsub_rn(coord(sel[slot], ch), centre);
      if (++ch == 3) {
        ch = 0;
        ++slot;
      }
    }
    if constexpr (V == 4) {
      reinterpret_cast<float4*>(dst)[v] = make_float4(val[0], val[1], val[2], val[3]);
    } else {
      dst[v] = val[0];
    }
  }
}

// Store v at e, m floats past a 16-byte boundary: one 16-byte store, two
// of 8 bytes, or 4 + 8 + 4 bytes.
__device__ __forceinline__ void store4(float* e, int m, float4 v) {
  if (m == 0) {
    *reinterpret_cast<float4*>(e) = v;
  } else if (m == 2) {
    reinterpret_cast<float2*>(e)[0] = make_float2(v.x, v.y);
    reinterpret_cast<float2*>(e)[1] = make_float2(v.z, v.w);
  } else {
    e[0] = v.x;
    *reinterpret_cast<float2*>(e + 1) = make_float2(v.y, v.z);
    e[3] = v.w;
  }
}

// A warp writes one grouped row: the centred coordinates of neighbour j
// (lanes 0-2, from the planes) at out, then its c features from f (the
// (n, c) rows in global memory, through L1). kVec (the bulk path's
// composing into shared memory): 16 bytes a lane read, and stored
// (store4) as the row's offset from a 16-byte boundary allows (out is
// `at` floats past one; f 16-byte aligned, c % 4 == 0). Else 4 bytes a
// lane.
template <bool kVec>
__device__ __forceinline__ void write_row(float* out, size_t at, const float* planes,
                                          int n4, const float* __restrict__ f, int c,
                                          int j, float4 centre, int lane) {
  if (lane < 3) {
    out[lane] = __fsub_rn(planes[lane * n4 + j],
                          lane == 0 ? centre.x : (lane == 1 ? centre.y : centre.z));
  }
  float* d = out + 3;
  const float* row = f + static_cast<size_t>(j) * c;
  if constexpr (kVec) {
    const int m = static_cast<int>((at + 3) & 3);  // d's offset from 16-byte alignment
    for (int k = lane; k < c / 4; k += 32) {
      store4(d + 4 * k, m, __ldg(reinterpret_cast<const float4*>(row) + k));
    }
  } else {
#pragma unroll 4
    for (int ch = lane; ch < c; ch += 32) d[ch] = __ldg(row + ch);
  }
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread sends `bytes` (a multiple of 16) of shared memory at src to
// global memory at dst (both 16-byte aligned) as one bulk async group.
__device__ __forceinline__ void bulk_store(float* dst, const float* src, uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n\t"
      "cp.async.bulk.commit_group;" ::"l"(dst), "r"(shared_addr(src)), "r"(bytes)
      : "memory");
}

// Wait until at most one of this thread's bulk groups still reads its
// shared memory.
__device__ __forceinline__ void bulk_wait_read_one() {
  asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Make this thread's generic-proxy writes to shared memory visible to the
// bulk copy (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Grid (ctas, b); a warp takes query q = blockIdx.x * warps + warp, then
// every (ctas * warps)-th, and selects in index order (idx only).
__global__ void __launch_bounds__(kMaxThreads)
ball_query_scan_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
                       int n, int s, int ns, float r2, bool stage_vec,
                       int* __restrict__ idx_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n4 = round_up(n, 4);
  float* sx = reinterpret_cast<float*>(smem);
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  int* sel = reinterpret_cast<int*>(sx + 3 * n4) + warp * ns;

  stage_planes<false>(xyz + static_cast<size_t>(b) * n * 3, n, n4, sx, stage_vec);

  for (int q = blockIdx.x * warps + warp; q < s; q += gridDim.x * warps) {
    const size_t row = static_cast<size_t>(b) * s + q;
    const float cx = new_xyz[row * 3];
    const float cy = new_xyz[row * 3 + 1];
    const float cz = new_xyz[row * 3 + 2];
    const int count = scan_select<1>(sx, n4, n, cx, cy, cz, r2, ns, sel, lane);
    finish_slots(sel, count, ns, n, idx_out + row * ns, lane);
    __syncwarp();  // sel is rewritten by the next query
  }
}

// Grid (ctas, b); the CTA takes its queries q = blockIdx.x + k * ctas in
// rounds of one a warp. Warp w selects query k = round * warps + w in
// index order (4 steps a pass) into its slots; then the warps write the
// round's rows: for kScalar, row t of the round's nq * ns by warp t %
// warps, straight into `grouped`; for kBulk, query by query, each block
// composed in one of two shared buffers and sent by thread 0 with one
// bulk copy.
template <int kStore>
__global__ void __launch_bounds__(kMaxThreads)
sa_group_kernel(const float* __restrict__ xyz, const float* __restrict__ feats,
                const float* __restrict__ new_xyz, int n, int s, int ns, int c,
                float r2, bool stage_vec, int* __restrict__ idx_out,
                float* __restrict__ grouped) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n4 = round_up(n, 4);
  const int tid = threadIdx.x;
  const int warps = blockDim.x >> 5;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.y;
  const int ctas = gridDim.x;
  float* planes = reinterpret_cast<float*>(smem);
  int* slots = reinterpret_cast<int*>(planes + 3 * n4);  // [warps][ns]
  float4* centres = reinterpret_cast<float4*>(
      smem + 12 * static_cast<size_t>(n4) + round16(4 * static_cast<size_t>(warps) * ns));
  float* bufs = reinterpret_cast<float*>(centres + warps);
  const int width = 3 + c;
  const size_t blk = static_cast<size_t>(ns) * width;  // floats of a query's block
  const float* f = feats + static_cast<size_t>(b) * n * c;

  // the first round's centre is loaded while the planes are staged
  int q = blockIdx.x + warp * ctas;
  float4 centre = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (q < s) {
    const float* cq = new_xyz + (static_cast<size_t>(b) * s + q) * 3;
    centre = make_float4(cq[0], cq[1], cq[2], 0.0f);
  }
  stage_planes<false>(xyz + static_cast<size_t>(b) * n * 3, n, n4, planes, stage_vec);

  int sent = 0;  // kBulk: blocks sent so far
  for (int base = blockIdx.x; base < s; base += warps * ctas) {
    q = base + warp * ctas;
    if (q < s) {
      const size_t row = static_cast<size_t>(b) * s + q;
      if (base != blockIdx.x) {
        centre = make_float4(new_xyz[row * 3], new_xyz[row * 3 + 1], new_xyz[row * 3 + 2],
                             0.0f);
      }
      int* sel = slots + warp * ns;
      const int count = scan_select<4>(planes, n4, n, centre.x, centre.y, centre.z, r2, ns,
                                       sel, lane);
      finish_slots(sel, count, ns, n, idx_out + row * ns, lane);
      if (lane == 0) centres[warp] = centre;
    }
    __syncthreads();
    const int nq = min(warps, (s - base + ctas - 1) / ctas);  // queries this round
    const size_t first_row = static_cast<size_t>(b) * s + base;
    if constexpr (kStore == kBulk) {
      for (int i = 0; i < nq; ++i, ++sent) {
        float* buf = bufs + (sent & 1) * blk;
        // the buffer's copy of two blocks ago may still be reading it
        if (tid == 0 && sent >= 2) bulk_wait_read_one();
        __syncthreads();
        for (int slot = warp; slot < ns; slot += warps) {
          const size_t at = static_cast<size_t>(slot) * width;
          write_row<true>(buf + at, at, planes, n4, f, c, slots[i * ns + slot], centres[i],
                          lane);
        }
        fence_proxy_async();
        __syncthreads();
        if (tid == 0) {
          bulk_store(grouped + (first_row + static_cast<size_t>(i) * ctas) * blk, buf,
                     static_cast<uint32_t>(4 * blk));
        }
      }
    } else {
#pragma unroll 2
      for (int t = warp; t < nq * ns; t += warps) {
        const int i = t / ns;
        const int slot = t - i * ns;
        const size_t at = (first_row + static_cast<size_t>(i) * ctas) * blk +
                          static_cast<size_t>(slot) * width;
        write_row<false>(grouped + at, at, planes, n4, f, c, slots[i * ns + slot],
                         centres[i], lane);
      }
    }
    __syncthreads();  // the slots and centres are rewritten next round
  }
  if constexpr (kStore == kBulk) {
    if (tid == 0) bulk_wait_all();  // shared memory lives until its copies end
  }
}

// Grid (ctas, b), `warps` warps a CTA, n <= kBallotMaxN; a warp takes
// query q = blockIdx.x * warps + warp, then every (ctas * warps)-th. Lane
// l tests the points 128 m + 4 l .. 128 m + 4 l + 3 of each block m of 128
// (three 16-byte loads where `load_vec`: n % 4 == 0 and xyz 16-byte
// aligned; else 12 of 4 bytes), all blocks' loads and tests independent,
// and keeps a bit for each (bit 4 m + k). One prefix over the lanes of
// their counts, a byte for each block packed into 64 bits, ranks every
// lane's hits in index order; each lane places its hits below ns into the
// warp's slots, and the row is padded with its first index (n - 1 where it
// has none) and written, 16 bytes a lane where `store_vec` (ns % 4 == 0
// and idx_out 16-byte aligned). kStop > 0 ends after the tests (1) or the
// placing (2), writing nothing meaningful: p2c_ball_query_probe times the
// phases so.
template <int kStop>
__global__ void __launch_bounds__(kMaxThreads)
ball_query_ballot_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
                         int n, int s, int ns, float r2, bool load_vec, bool store_vec,
                         int* __restrict__ idx_out) {
  constexpr int kBlocks = kBallotMaxN / 128;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int blocks = (n + 127) >> 7;
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  int* sel = reinterpret_cast<int*>(smem) + warp * ns;

  for (int q = blockIdx.x * warps + warp; q < s; q += gridDim.x * warps) {
    const size_t row = static_cast<size_t>(b) * s + q;
    const float cx = __ldg(new_xyz + row * 3);
    const float cy = __ldg(new_xyz + row * 3 + 1);
    const float cz = __ldg(new_xyz + row * 3 + 2);
    unsigned hits = 0u;  // bit 4 m + k: point 128 m + 4 lane + k is in radius
#pragma unroll
    for (int m = 0; m < kBlocks; ++m) {
      if (m < blocks) {  // warp-uniform
        const int j = 128 * m + 4 * lane;  // the lane's first point of the block
        float c[12];
        if (load_vec) {
          const float4* p4 = reinterpret_cast<const float4*>(p + 3 * j);
          const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          const float4 u = j < n ? __ldg(p4) : zero;
          const float4 v = j < n ? __ldg(p4 + 1) : zero;
          const float4 w = j < n ? __ldg(p4 + 2) : zero;
          c[0] = u.x, c[1] = u.y, c[2] = u.z, c[3] = u.w, c[4] = v.x, c[5] = v.y;
          c[6] = v.z, c[7] = v.w, c[8] = w.x, c[9] = w.y, c[10] = w.z, c[11] = w.w;
        } else {
#pragma unroll
          for (int t = 0; t < 12; ++t) c[t] = j + t / 3 < n ? __ldg(p + 3 * j + t) : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (j + k < n && sq_dist(cx, cy, cz, c[3 * k], c[3 * k + 1], c[3 * k + 2]) <= r2) {
            hits |= 1u << (4 * m + k);
          }
        }
      }
    }
    if (kStop == 1) {
      if (hits == 0xffffffffu && lane == 0) idx_out[row * ns] = 0;  // keeps the tests
      continue;
    }
    // the lane's count in each block, a byte each (at most 128 a block),
    // and their inclusive prefix over the lanes
    unsigned long long mine = 0ull;
#pragma unroll
    for (int m = 0; m < kBlocks; ++m) {
      mine |= static_cast<unsigned long long>(__popc(hits >> (4 * m) & 0xfu)) << (8 * m);
    }
    unsigned long long incl = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned long long t = __shfl_up_sync(kFullMask, incl, off);
      if (lane >= off) incl += t;
    }
    const unsigned long long totals = __shfl_sync(kFullMask, incl, 31);
    const unsigned long long before = incl - mine;
    int base = 0;  // the hits of the blocks before m
#pragma unroll
    for (int m = 0; m < kBlocks; ++m) {
      int at = base + static_cast<int>(before >> (8 * m) & 0xffull);
      for (unsigned h = hits >> (4 * m) & 0xfu; h != 0u && at < ns; h &= h - 1u) {
        sel[at++] = 128 * m + 4 * lane + __ffs(static_cast<int>(h)) - 1;
      }
      base += static_cast<int>(totals >> (8 * m) & 0xffull);
    }
    const int found = min(base, ns);
    // the first in-radius index: the least of the lanes' first
    const unsigned lowest = hits != 0u ? __ffs(static_cast<int>(hits)) - 1 : 0u;
    const unsigned least = __reduce_min_sync(
        kFullMask, hits != 0u ? 128u * (lowest >> 2) + 4u * lane + (lowest & 3u) : 0xffffffffu);
    const int first = base > 0 ? static_cast<int>(least) : n - 1;
    __syncwarp();
    if (kStop == 2) {
      if (sel[lane % ns] == -2 && lane == 0) idx_out[row * ns] = first;  // keeps the placing
      __syncwarp();
      continue;
    }
    int* out = idx_out + row * ns;
    if (store_vec) {
      for (int t = lane; t < ns / 4; t += 32) {
        const int k = 4 * t;
        reinterpret_cast<int4*>(out)[t] =
            make_int4(k < found ? sel[k] : first, k + 1 < found ? sel[k + 1] : first,
                      k + 2 < found ? sel[k + 2] : first, k + 3 < found ? sel[k + 3] : first);
      }
    } else {
      for (int t = lane; t < ns; t += 32) out[t] = t < found ? sel[t] : first;
    }
    __syncwarp();  // sel is rewritten by the next query
  }
}

struct GridShape {
  float lo[3];
  float inv;  // 1 / cell edge
  int dim[3];
  int use;    // 0: every query of the row scans in index order
};

// A coordinate's cell on one axis: the floor of its position, clamped in
// float before the conversion so that NaN and inf cannot overflow it.
__device__ __forceinline__ int axis_cell(float p, float lo, float inv, int dim) {
  const float t = floorf(__fmul_rn(__fsub_rn(p, lo), inv));
  return static_cast<int>(fminf(fmaxf(t, 0.0f), static_cast<float>(dim - 1)));
}

__device__ __forceinline__ int point_cell(const GridShape& g, float x, float y, float z) {
  const int ix = axis_cell(x, g.lo[0], g.inv, g.dim[0]);
  const int iy = axis_cell(y, g.lo[1], g.inv, g.dim[1]);
  const int iz = axis_cell(z, g.lo[2], g.inv, g.dim[2]);
  return (iz * g.dim[1] + iy) * g.dim[0] + ix;
}

// The grid of a row whose finite points span [lo, hi]: an edge of at least
// r2^(1/2) * (1 + 2^-6), enlarged by 1.25 until at most kMaxCells cells.
// A box that is not finite (or holds no point), or a radius with no finite
// positive edge, gives use = 0.
__device__ void grid_shape(const float* lo, const float* hi, float r2, GridShape* g) {
  float ext[3];
  bool ok = true;
  for (int a = 0; a < 3; ++a) {
    ext[a] = __fsub_rn(hi[a], lo[a]);
    ok = ok && finite_f(ext[a]) && ext[a] >= 0.0f;
    g->lo[a] = lo[a];
  }
  float e = __fmul_rn(sqrtf(r2), 1.015625f);
  ok = ok && e > 0.0f && finite_f(e);
  g->use = ok ? 1 : 0;
  if (!ok) return;
  e = fmaxf(e, fmaxf(ext[0], fmaxf(ext[1], ext[2])) * (1.0f / kMaxCells));
  for (;;) {
    const float inv = 1.0f / e;
    long long cells = 1;
    for (int a = 0; a < 3; ++a) {
      g->dim[a] = static_cast<int>(fminf(floorf(__fmul_rn(ext[a], inv)),
                                         static_cast<float>(kMaxCells - 1))) + 1;
      cells *= g->dim[a];
    }
    g->inv = inv;
    if (cells <= kMaxCells) return;
    e = __fmul_rn(e, 1.25f);
  }
}

// Grid (ctas, b); a warp takes query q = blockIdx.x * warps + warp, then
// every (ctas * warps)-th. Each CTA builds the grid of its row (see the
// note at the head of this file), then a query tests the candidates of
// its 9 runs, 64 a step (an index from the cell-sorted list, then its
// three coordinates from the planes), sets the in-radius indices in its
// warp's bitmap, and reads the bitmap out in index order. A query whose
// runs hold more than `cap` candidates scans the planes in index order,
// as every query of a row without a grid does. kGather: also write the
// centred coordinates (kVec: 16 bytes a lane) from the planes.
template <bool kGather, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
ball_query_grid_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
                       int n, int s, int ns, float r2, int cap, bool stage_vec,
                       int* __restrict__ idx_out, float* __restrict__ grouped) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* box = reinterpret_cast<float*>(smem);              // [6][32]
  GridShape* shape = reinterpret_cast<GridShape*>(smem + 768);
  int* wsum = reinterpret_cast<int*>(smem + 800);             // [32]
  const int n4 = round_up(n, 4);
  const int nw = (n + 31) >> 5;
  const int sh = bitmap_shift(n);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warps = nthreads >> 5;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.y;
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  float* px = reinterpret_cast<float*>(smem + kGridHeader);  // index order
  float* py = px + n4;
  float* pz = py + n4;
  unsigned* words = reinterpret_cast<unsigned*>(pz + n4);  // grid_region
  unsigned* code = words;
  int* cells = reinterpret_cast<int*>(
      smem + kGridHeader + 12 * static_cast<size_t>(n4) + grid_region(n, ns, warps));
  uint16_t* sorted = reinterpret_cast<uint16_t*>(cells + kMaxCells + 4);

  for (int t = tid; t < kMaxCells + 4; t += nthreads) cells[t] = 0;
  float lo[3] = {inf(), inf(), inf()};
  float hi[3] = {-inf(), -inf(), -inf()};
  stage_planes<true>(p, n, n4, px, stage_vec, lo, hi);
  for (int a = 0; a < 3; ++a) {
    for (int off = 16; off > 0; off >>= 1) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(kFullMask, lo[a], off));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(kFullMask, hi[a], off));
    }
    if (lane == 0) {
      box[a * 32 + warp] = lo[a];
      box[(3 + a) * 32 + warp] = hi[a];
    }
  }
  __syncthreads();
  if (warp == 0) {
    for (int a = 0; a < 3; ++a) {
      lo[a] = lane < warps ? box[a * 32 + lane] : inf();
      hi[a] = lane < warps ? box[(3 + a) * 32 + lane] : -inf();
      for (int off = 16; off > 0; off >>= 1) {
        lo[a] = fminf(lo[a], __shfl_xor_sync(kFullMask, lo[a], off));
        hi[a] = fmaxf(hi[a], __shfl_xor_sync(kFullMask, hi[a], off));
      }
    }
    if (lane == 0) grid_shape(lo, hi, r2, shape);
  }
  __syncthreads();
  const GridShape g = *shape;

  if (g.use) {
    // a point's rank in its cell is the count its atomic saw; the order
    // within a cell is the atomics'
#pragma unroll 4
    for (int j = tid; j < n; j += nthreads) {
      const float x = px[j], y = py[j], z = pz[j];
      unsigned cj = 0xffffffffu;  // not finite: in no cell
      if (finite3(x, y, z)) {
        const int cell = point_cell(g, x, y, z);
        cj = static_cast<unsigned>(cell) << 16 | atomicAdd(&cells[cell], 1);
      }
      code[j] = cj;
    }
    __syncthreads();
    // exclusive scan of the ncell + 1 counts: cells[k] is the start of
    // cell k, cells[ncell] the number of points in the grid
    const int ncell = g.dim[0] * g.dim[1] * g.dim[2];
    const int per = (ncell + 1 + nthreads - 1) / nthreads;
    const int c0 = min(tid * per, ncell + 1);
    const int c1 = min(c0 + per, ncell + 1);
    int sum = 0;
    for (int k = c0; k < c1; ++k) sum += cells[k];
    int incl = sum;
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFullMask, incl, off);
      if (lane >= off) incl += t;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int v = lane < warps ? wsum[lane] : 0;
      int w = v;
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(kFullMask, w, off);
        if (lane >= off) w += t;
      }
      if (lane < warps) wsum[lane] = w - v;
    }
    __syncthreads();
    int run = wsum[warp] + incl - sum;
    for (int k = c0; k < c1; ++k) {
      const int m = cells[k];
      cells[k] = run;
      run += m;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = tid; j < n; j += nthreads) {
      const unsigned cj = code[j];
      if (cj != 0xffffffffu) sorted[cells[cj >> 16] + static_cast<int>(cj & 0xffffu)] = j;
    }
    __syncthreads();
  }
  // the codes' region becomes the warps' bitmaps and slots; each warp
  // zeroes its own bitmap
  const int bw = bitmap_words(n);
  unsigned* bits = words + warp * (bw + ns);
  int* sel = reinterpret_cast<int*>(bits + bw);
  for (int t = lane; t < bw; t += 32) bits[t] = 0u;
  __syncwarp();

  const int step = gridDim.x * warps;
  int q = blockIdx.x * warps + warp;
  // the next query's centre is loaded while this one is served
  float3 next = q < s ? make_float3(new_xyz[(static_cast<size_t>(b) * s + q) * 3],
                                    new_xyz[(static_cast<size_t>(b) * s + q) * 3 + 1],
                                    new_xyz[(static_cast<size_t>(b) * s + q) * 3 + 2])
                      : make_float3(0.0f, 0.0f, 0.0f);
  for (; q < s; q += step) {
    const size_t row = static_cast<size_t>(b) * s + q;
    const float cx = next.x;
    const float cy = next.y;
    const float cz = next.z;
    if (q + step < s) {
      const float* c = new_xyz + (row + step) * 3;
      next = make_float3(c[0], c[1], c[2]);
    }
    int count = -1;  // warp-uniform; -1 until a route has selected
    if (g.use) {
      const int ix = axis_cell(cx, g.lo[0], g.inv, g.dim[0]);
      const int iy = axis_cell(cy, g.lo[1], g.inv, g.dim[1]);
      const int iz = axis_cell(cz, g.lo[2], g.inv, g.dim[2]);
      const int xa = max(ix - 1, 0);
      const int xb = min(ix + 1, g.dim[0] - 1);
      // the 3 x 3 runs of three x-adjacent cells, each contiguous in cell
      // order, laid end to end: candidate t of the query is list entry t +
      // shift[r] for the last run r that starts at or before t
      int first[9], shift[9];
      int total = 0;
#pragma unroll
      for (int r = 0; r < 9; ++r) {
        const int y = iy + r % 3 - 1;
        const int z = iz + r / 3 - 1;
        int begin = 0, end = 0;
        if (y >= 0 && y < g.dim[1] && z >= 0 && z < g.dim[2]) {
          const int base = (z * g.dim[1] + y) * g.dim[0];
          begin = cells[base + xa];
          end = cells[base + xb + 1];
        }
        first[r] = total;
        shift[r] = begin - total;
        total += end - begin;
      }
      if (total <= cap) {
        count = 0;
        // two independent steps of 32 candidates a pass
        for (int t0 = 0; t0 < total; t0 += 64) {
          int k[2];
          bool in[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int t = t0 + 32 * u + lane;
            const int tt = min(t, total - 1);
            int sh_t = shift[0];
#pragma unroll
            for (int r = 1; r < 9; ++r) sh_t = tt >= first[r] ? shift[r] : sh_t;
            // past the end, the last entry: loaded, never counted
            k[u] = sorted[tt + sh_t];
            in[u] = t < total && sq_dist(cx, cy, cz, px[k[u]], py[k[u]], pz[k[u]]) <= r2;
          }
          count += __popc(__ballot_sync(kFullMask, in[0])) +
                   __popc(__ballot_sync(kFullMask, in[1]));
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int j = k[u];
            if (in[u]) atomicOr(&bits[(j >> 5) + (j >> (5 + sh))], 1u << (j & 31));
          }
        }
        __syncwarp();
        // lane l's run of words, stored from (l << sh) + l on
        const int w0 = lane << sh;
        const int w1 = min(w0 + (1 << sh), nw);
        int mine = 0;
#pragma unroll 8
        for (int w = w0; w < w1; ++w) mine += __popc(bits[w + lane]);
        int incl = mine;
        for (int off = 1; off < 32; off <<= 1) {
          const int t = __shfl_up_sync(kFullMask, incl, off);
          if (lane >= off) incl += t;
        }
        int rank = incl - mine;  // in-radius indices in the earlier lanes' runs
        for (int w = w0; w < w1; ++w) {
          unsigned word = bits[w + lane];
          if (word == 0u) continue;
          bits[w + lane] = 0u;
          for (; word != 0u && rank < ns; word &= word - 1u) {
            sel[rank++] = (w << 5) + __ffs(static_cast<int>(word)) - 1;
          }
        }
      }
    }
    if (count < 0) count = scan_select<4>(px, n4, n, cx, cy, cz, r2, ns, sel, lane);
    finish_slots(sel, count, ns, n, idx_out + row * ns, lane);
    if constexpr (kGather) {
      write_coords<kVec ? 4 : 1>(grouped + row * ns * 3,
                                 [=](int j, int ch) { return px[ch * n4 + j]; }, sel, ns, cx,
                                 cy, cz, lane);
    }
    __syncwarp();  // sel and the bitmap are rewritten by the next query
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(shared_addr(bar)), "r"(count)
               : "memory");
}

// The barrier's one arrival of a phase, which also expects `bytes` of
// copied data before the phase can complete (the data may land first).
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(shared_addr(bar)),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t"
      ".reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t"
      "}" ::"r"(shared_addr(bar)), "r"(parity) : "memory");
}

// One thread copies `bytes` (a multiple of 16) of global memory at src to
// shared memory at dst (both 16-byte aligned), completing on `bar`.
__device__ __forceinline__ void bulk_fetch(void* dst, const void* src, uint32_t bytes,
                                           uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(shared_addr(dst)), "l"(src), "r"(bytes), "r"(shared_addr(bar)) : "memory");
}

// The 12 coordinates (x y z each) of points j .. j + 3 of a stage: three
// 16-byte loads where `vec` (the stage's points start 16-byte aligned;
// j % 4 == 0), else 12 of 4 bytes.
__device__ __forceinline__ void load4(const float* pts, int j, bool vec, float* c) {
  if (vec) {
    const float4* p4 = reinterpret_cast<const float4*>(pts + 3 * j);
    const float4 u = p4[0], v = p4[1], w = p4[2];
    c[0] = u.x, c[1] = u.y, c[2] = u.z, c[3] = u.w, c[4] = v.x, c[5] = v.y;
    c[6] = v.z, c[7] = v.w, c[8] = w.x, c[9] = w.y, c[10] = w.z, c[11] = w.w;
  } else {
#pragma unroll
    for (int t = 0; t < 12; ++t) c[t] = pts[3 * j + t];
  }
}

// The sum of the bytes of v below byte m (m <= 8): one dp4a a word.
__device__ __forceinline__ int bytes_below(unsigned long long v, int m) {
  const unsigned lo = m >= 4 ? 0x01010101u : (1u << (8 * m)) - 1u & 0x01010101u;
  const unsigned hi = m >= 8 ? 0x01010101u : m <= 4 ? 0u : (1u << (8 * (m - 4))) - 1u & 0x01010101u;
  return static_cast<int>(
      __dp4a(static_cast<unsigned>(v), lo, __dp4a(static_cast<unsigned>(v >> 32), hi, 0u)));
}

// Grid (ctas, b); `group` warps serve each query, warps / group queries a
// CTA: query q = blockIdx.x * (warps / group) + warp / group. The row
// streams through kStreamStages stages of shared memory in blocks of block
// = 128 * kStreamChunks * group points, index order, each block one bulk
// copy (cp.async.bulk) issued by thread 0 and counted on the stage's
// barrier. Warp g of a query tests kStreamChunks chunks of 128 points of
// each block (its sub-block, points g * 128 * kStreamChunks on): lane l the 4 adjacent points
// 4 l .. 4 l + 3 of a chunk (three 16-byte loads from the stage), every
// test independent, a bit each. One prefix over the lanes of their counts
// (a byte a chunk, packed) ranks the warp's hits in index order, and the
// warp writes its count. After one __syncthreads every warp knows every
// query's count (lane l sums query l's), so the CTA stops at once when
// none is short of ns; each lane places its hits below ns (ranked after
// its query's earlier warps' counts) into the query's slots with their
// centred coordinates (kGather), read from the stage. A query stops
// testing after the block where its count reaches ns. Thread 0 then
// copies the block kStreamStages - 1 ahead into the stage of the block
// before, which every warp has placed by then. A short row walks the whole row;
// one with no hit is padded with point n - 1 (in the last block). Then each
// query's warps write its padded row of indices and points.
// kProbe (measurement only; `stamps` is read only then): thread 0 records
// the SM's clock at 0 the start, 1 after the first copies, 2 + 4 k after
// the wait, the barrier, the placing and the next copy's issue of block k
// < 12, 50 after the drain and 51 at the end; the global timer at the
// start and end (52, 53) and the last block tested (54); 64 slots a CTA.
template <bool kGather, bool kProbe>
__global__ void __launch_bounds__(kMaxThreads)
ball_query_stream_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
                         int n, int s, int ns, float r2, int group, int* __restrict__ idx_out,
                         float* __restrict__ grouped, long long* __restrict__ stamps) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* stamp_at =
      kProbe ? stamps + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * 64
             : nullptr;
  const auto stamp = [&](int at) {
    if constexpr (kProbe) {
      if (threadIdx.x == 0) {
        stamp_at[at] = clock64();
        if (at == 0 || at == 51) {
          long long t;
          asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
          stamp_at[52 + at / 51] = t;
        }
      }
    }
  };
  const auto stamp_block = [&](int k, int phase) {
    if constexpr (kProbe) {
      if (k < 12) stamp(2 + 4 * k + phase);
    }
  };
  stamp(0);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // a barrier a stage
  const int block = stream_block(group);
  const size_t stage_bytes = stream_stage_bytes(block);
  unsigned char* stage0 = smem + kStreamHeader;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int queries = warps / group;
  const int qg = warp / group;      // the CTA's query this warp serves
  const int g = warp - qg * group;  // its part of the query's warps
  int* counts = reinterpret_cast<int*>(stage0 + kStreamStages * stage_bytes);  // [2][warps]
  int* sel = counts + 2 * warps + qg * ns;
  float* crd = reinterpret_cast<float*>(counts + 2 * warps + queries * ns) + 3 * qg * ns;
  const int b = blockIdx.y;
  const int q = blockIdx.x * queries + qg;
  const size_t row = static_cast<size_t>(b) * s + q;
  // a block's copy starts at the 16-byte boundary at or below its first
  // point: `off` floats ahead of it in the stage (block * 12 bytes is a
  // multiple of 16, so the same for every block of the row)
  const uintptr_t p = reinterpret_cast<uintptr_t>(xyz + static_cast<size_t>(b) * n * 3);
  const int off = static_cast<int>(p & 15u) >> 2;
  const bool vec = off == 0;
  const char* from = reinterpret_cast<const char*>(p - (p & 15u));
  const int nblocks = (n - 1) / block + 1;
  const auto fetch = [&](int k) {  // thread 0
    const int len = min(block, n - k * block);
    const uint32_t bytes = static_cast<uint32_t>(round16(4 * off + 12 * static_cast<size_t>(len)));
    const int st = k % kStreamStages;
    mbar_arrive_expect(full + st, bytes);
    bulk_fetch(stage0 + st * stage_bytes, from + static_cast<size_t>(k) * block * 12, bytes,
               full + st);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStreamStages; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int k = 0; k < min(kStreamStages, nblocks); ++k) fetch(k);
  }
  float cx = 0.0f, cy = 0.0f, cz = 0.0f;  // while the first blocks come
  if (q < s) {
    cx = __ldg(new_xyz + row * 3);
    cy = __ldg(new_xyz + row * 3 + 1);
    cz = __ldg(new_xyz + row * 3 + 2);
  }
  __syncthreads();  // the barriers are set before any thread waits on them
  stamp(1);

  // count: the in-radius indices of this warp's query so far; lane l <
  // queries keeps query l's in `all` (a missing query is full)
  int count = q < s ? 0 : ns;
  int all = lane < queries && blockIdx.x * queries + lane < s ? 0 : ns;
  const int first = g * 128 * kStreamChunks + 4 * lane;  // the lane's first point of each block
  int k = 0;
  for (; k < nblocks; ++k) {
    const int st = k % kStreamStages;
    mbar_wait(full + st, static_cast<uint32_t>(k / kStreamStages) & 1u);
    stamp_block(k, 0);
    const float* pts = reinterpret_cast<const float*>(stage0 + st * stage_bytes) + off;
    const int len = min(block, n - k * block);
    int* cnt = counts + (k & 1) * warps;
    unsigned bits = 0u;  // bit 4 m + t: point first + 128 m + t in radius
    const auto test = [&](bool whole) {
#pragma unroll
      for (int m = 0; m < kStreamChunks; ++m) {
        const int j = first + 128 * m;
        float c[12];
        load4(pts, j, vec, c);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if ((whole || j + t < len) &&
              sq_dist(cx, cy, cz, c[3 * t], c[3 * t + 1], c[3 * t + 2]) <= r2) {
            bits |= 1u << (4 * m + t);
          }
        }
      }
    };
    if (count < ns) {
      if (len == block) {  // every block but the row's last
        test(true);
      } else {
        test(false);
      }
    }
    // the lane's count in each chunk, a byte each (at most 128 a chunk),
    // and their inclusive prefix over the lanes
    unsigned long long mine = 0ull;
#pragma unroll
    for (int m = 0; m < kStreamChunks; ++m) {
      mine |= static_cast<unsigned long long>(__popc(bits >> (4 * m) & 0xfu)) << (8 * m);
    }
    unsigned long long incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long t = __shfl_up_sync(kFullMask, incl, d);
      if (lane >= d) incl += t;
    }
    const unsigned long long totals = __shfl_sync(kFullMask, incl, 31);
    const int c = bytes_below(totals, kStreamChunks);
    if (lane == 0) cnt[warp] = c;
    // every warp's count of this block; every warp has placed the block
    // before, so its stage is free
    __syncthreads();
    stamp_block(k, 1);
    if (lane < queries) {
      for (int i = 0; i < group; ++i) all += cnt[lane * group + i];
    }
    const bool go = __any_sync(kFullMask, lane < queries && all < ns);
    if (c > 0 && count < ns) {
      const int v = lane < g ? cnt[qg * group + lane] : 0;
      const int at = count + static_cast<int>(__reduce_add_sync(kFullMask, v));
      const unsigned long long before = incl - mine;
      // the lane's hits in index order, each ranked after the warp's
      // earlier chunks, the earlier lanes' hits in its chunk and its own
      for (unsigned h = bits; h != 0u; h &= h - 1u) {
        const int bit = __ffs(static_cast<int>(h)) - 1;
        const int m = bit >> 2;
        const int pos = at + bytes_below(totals, m) +
                        static_cast<int>(before >> (8 * m) & 0xffull) +
                        __popc(bits & ((1u << bit) - 1u) & (0xfu << (4 * m)));
        if (pos >= ns) break;
        const int j = first + 128 * m + (bit & 3);
        sel[pos] = k * block + j;
        if constexpr (kGather) {
          crd[3 * pos] = __fsub_rn(pts[3 * j], cx);
          crd[3 * pos + 1] = __fsub_rn(pts[3 * j + 1], cy);
          crd[3 * pos + 2] = __fsub_rn(pts[3 * j + 2], cz);
        }
      }
    }
    count = __shfl_sync(kFullMask, all, qg);
    if constexpr (kGather) {
      // no point in radius: the row is padded with point n - 1
      if (count == 0 && k == nblocks - 1 && g == 0 && lane < 3) {
        crd[lane] = __fsub_rn(pts[3 * (len - 1) + lane], lane == 0 ? cx : (lane == 1 ? cy : cz));
      }
    }
    stamp_block(k, 2);
    if (!go) break;
    // the block kStreamStages - 1 ahead goes into the stage of the block
    // before, which every warp had placed by the barrier
    if (threadIdx.x == 0 && k >= 1 && k - 1 + kStreamStages < nblocks) {
      fetch(k - 1 + kStreamStages);
    }
    stamp_block(k, 3);
  }
  // the blocks copied ahead of the stop land before the CTA leaves
  const int issued = k == 0 ? kStreamStages - 1 : k + kStreamStages - 2;  // the last copied
  for (int j = k + 1; j <= min(nblocks - 1, issued); ++j) {
    mbar_wait(full + j % kStreamStages, static_cast<uint32_t>(j / kStreamStages) & 1u);
  }
  stamp(50);
  if constexpr (kProbe) {
    if (threadIdx.x == 0) stamp_at[54] = k;
  }
  __syncthreads();  // every warp's slots of the last block
  if (q < s) {
    const int found = min(count, ns);
    const int pad = found > 0 ? sel[0] : n - 1;
    int* out = idx_out + row * ns;
    for (int t = g * 32 + lane; t < ns; t += group * 32) out[t] = t < found ? sel[t] : pad;
    if constexpr (kGather) {
      float* dst = grouped + row * ns * 3;
      for (int t = g * 32 + lane; t < 3 * ns; t += group * 32) {
        dst[t] = crd[t < 3 * found ? t : t % 3];
      }
    }
  }
  stamp(51);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The checks every forward shares: a plan of `ctas` CTAs of `warps` warps
// a row, and shared memory within the card's limit.
bool plan_ok(int b, int n, int s, int ns, int ctas, int warps, size_t smem) {
  return b >= 1 && n >= 1 && s >= 1 && ns >= 1 && ctas >= 1 && warps >= 1 &&
         warps * 32 <= kMaxThreads && smem <= static_cast<size_t>(kMaxSmem);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Launch `kernel` on a (ctas, b) grid after the plan's checks.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), bool ok, int b, int ctas, int warps, size_t smem,
           void* stream, Args... args) {
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(ctas, b), warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xyz (b, n, 3), new_xyz (b, s, 3) f32 -> idx (b, s, ns) i32, `ctas` CTAs
// of `warps` warps a row: ballot != 0 the independent ballots (needs n <=
// kBallotMaxN), else the index-order scan.
extern "C" int p2c_ball_query(const float* xyz, const float* new_xyz, int* idx,
                              int b, int n, int s, int ns, float r2, int ballot, int ctas,
                              int warps, void* stream) {
  if (!ballot) {
    const size_t smem = scan_smem(n, ns, warps);
    return launch(ball_query_scan_kernel, plan_ok(b, n, s, ns, ctas, warps, smem), b, ctas,
                  warps, smem, stream, xyz, new_xyz, n, s, ns, r2,
                  n % 4 == 0 && aligned16(xyz), idx);
  }
  const size_t smem = ballot_smem(ns, warps);
  return launch(ball_query_ballot_kernel<0>,
                plan_ok(b, n, s, ns, ctas, warps, smem) && n <= kBallotMaxN, b, ctas, warps,
                smem, stream, xyz, new_xyz, n, s, ns, r2, n % 4 == 0 && aligned16(xyz),
                ns % 4 == 0 && aligned16(idx), idx);
}

// For measurement only (kernel_sweep.py --split): the ballot kernel of
// p2c_ball_query ended after its ballots (stop 1) or its placing (stop 2);
// `idx` holds nothing meaningful after it.
extern "C" int p2c_ball_query_probe(int stop, const float* xyz, const float* new_xyz,
                                    int* idx, int b, int n, int s, int ns, float r2,
                                    int ctas, int warps, void* stream) {
  const size_t smem = ballot_smem(ns, warps);
  const bool ok = plan_ok(b, n, s, ns, ctas, warps, smem) && n <= kBallotMaxN &&
                  (stop == 1 || stop == 2);
  return launch(stop == 1 ? ball_query_ballot_kernel<1> : ball_query_ballot_kernel<2>, ok,
                b, ctas, warps, smem, stream, xyz, new_xyz, n, s, ns, r2,
                n % 4 == 0 && aligned16(xyz), false, idx);
}

// xyz (b, n, 3), new_xyz (b, s, 3) f32 -> idx (b, s, ns) i32 and, unless
// `grouped` is null (the selection alone, for timing it), grouped (b, s,
// ns, 3) f32: the cell grid with `cap` (needs n <= 65535). 16-byte stores
// where ns * 3 % 4 == 0 and `grouped` is 16-byte aligned.
extern "C" int p2c_ball_query_grouped(const float* xyz, const float* new_xyz,
                                      int* idx, float* grouped, int b, int n,
                                      int s, int ns, float r2, int ctas,
                                      int warps, int cap, void* stream) {
  const bool gather = grouped != nullptr;
  const bool vec = ns * 3 % 4 == 0 && aligned16(grouped);
  const size_t smem = grid_smem(n, ns, warps);
  const auto kernel = !gather ? ball_query_grid_kernel<false, false>
                      : vec   ? ball_query_grid_kernel<true, true>
                              : ball_query_grid_kernel<true, false>;
  const bool stage_vec = n % 4 == 0 && aligned16(xyz);
  return launch(kernel, plan_ok(b, n, s, ns, ctas, warps, smem) && n <= 65535 && cap >= 0,
                b, ctas, warps, smem, stream, xyz, new_xyz, n, s, ns, r2, cap, stage_vec,
                idx, grouped);
}

namespace {

int launch_stream(const float* xyz, const float* new_xyz, int* idx, float* grouped, int b,
                  int n, int s, int ns, float r2, int ctas, int warps, int group,
                  long long* stamps, void* stream) {
  if (group < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool gather = grouped != nullptr;
  const size_t smem = stream_smem(ns, warps, group, gather);
  const auto kernel = stamps != nullptr ? (gather ? ball_query_stream_kernel<true, true>
                                                  : ball_query_stream_kernel<false, true>)
                                         : (gather ? ball_query_stream_kernel<true, false>
                                                  : ball_query_stream_kernel<false, false>);
  return launch(kernel,
                plan_ok(b, n, s, ns, ctas, warps, smem) && n <= 0x7fffffff / 3 &&
                    warps % group == 0,
                b, ctas, warps, smem, stream, xyz, new_xyz, n, s, ns, r2, group, idx, grouped,
                stamps);
}

}  // namespace

// xyz (b, n, 3), new_xyz (b, s, 3) f32 -> idx (b, s, ns) i32 and, unless
// `grouped` is null (idx only), grouped (b, s, ns, 3) f32: the row
// streamed through shared memory in blocks of stream_block(group) points,
// any n with 3 n < 2^31; `ctas` CTAs of `warps` warps a row, `group`
// warps a query.
extern "C" int p2c_ball_query_stream(const float* xyz, const float* new_xyz, int* idx,
                                     float* grouped, int b, int n, int s, int ns, float r2,
                                     int ctas, int warps, int group, void* stream) {
  return launch_stream(xyz, new_xyz, idx, grouped, b, n, s, ns, r2, ctas, warps, group,
                       nullptr, stream);
}

// For measurement only (kernel_sweep.py --stream-split): p2c_ball_query_stream
// with each CTA's clock stamps in `stamps` (64 int64 a CTA, b * ctas CTAs).
extern "C" int p2c_ball_query_stream_probe(const float* xyz, const float* new_xyz, int* idx,
                                           float* grouped, int b, int n, int s, int ns,
                                           float r2, int ctas, int warps, int group,
                                           long long* stamps, void* stream) {
  return launch_stream(xyz, new_xyz, idx, grouped, b, n, s, ns, r2, ctas, warps, group,
                       stamps, stream);
}

// xyz (b, n, 3), feats (b, n, c), new_xyz (b, s, 3) f32 -> idx (b, s, ns)
// i32, grouped (b, s, ns, 3 + c) f32: the index-order scan, `ctas`
// persistent CTAs of `warps` warps a row. `store` (enum Store): kBulk
// reads 16 bytes a lane and sends each block with one bulk copy, and
// needs c % 4 == 0, ns * (3 + c) % 4 == 0 and 16-byte aligned `feats` and
// `grouped`; where those fail, the kernel takes kScalar (4-byte reads and
// stores).
extern "C" int p2c_sa_grouped_features(const float* xyz, const float* feats,
                                       const float* new_xyz, int* idx,
                                       float* grouped, int b, int n, int s,
                                       int ns, int c, float r2, int store, int ctas,
                                       int warps, void* stream) {
  if (store == kBulk && !(c % 4 == 0 && ns * (3 + c) % 4 == 0 && aligned16(grouped) &&
                          aligned16(feats))) {
    store = kScalar;
  }
  const size_t smem = sa_smem(n, ns, c, warps, store);
  const auto kernel = store == kBulk ? sa_group_kernel<kBulk> : sa_group_kernel<kScalar>;
  const bool stage_vec = n % 4 == 0 && aligned16(xyz);
  return launch(kernel,
                plan_ok(b, n, s, ns, ctas, warps, smem) && c >= 1 &&
                    (store == kScalar || store == kBulk),
                b, ctas, warps, smem, stream, xyz, feats, new_xyz, n, s, ns, c, r2,
                stage_vec, idx, grouped);
}
