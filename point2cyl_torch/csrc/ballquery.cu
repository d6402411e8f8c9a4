// Ball query, with and without fused neighbour gather, and the SA1
// gather's scatter-add backward, for Hopper (sm_90a).
//
// Replaces four TPU kernels of point2cyl_tpu/ops/pallas_ballquery.py:
//   - _ballquery_kernel (pallas_call at :580, reached through
//     ball_query_pallas): indices only. SA1 whenever N <= 1024 (the N=512
//     A/B protocol) and any stage the fused kernels below do not cover.
//     Entry point p2c_ball_query.
//   - _ballquery_grouped_kernel (pallas_call at :637, reached through
//     ball_query_grouped_pallas / ball_query_grouped): ball query, then
//     grouped = xyz[idx] - centre. SA1 of the backbone (N=8192, no
//     features). Entry point p2c_ball_query_grouped.
//   - _sa_grouped_exact_kernel (pallas_call at :474, reached through
//     sa_grouped_exact_pallas / sa_grouped_exact): exact ball query, then
//     grouped = [xyz[idx] - centre | feats[idx]]. SA2 (N=512, C=128).
//     Entry point p2c_sa_grouped_features.
//   - _bqg_scatter_kernel (pallas_call at :767, in _bqg_bwd): the SA1
//     gather's backward, d_xyz[b, idx] += d_grouped. Entry point
//     p2c_ball_query_grouped_backward.
// The SA2 gather's backward (_sa_exact_scatter_kernel) is
// p2c_sa_grouped_backward in target_sum.cu.
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
//     ball_query_plan), which takes the index-order scan
//     (ball_query_scan_kernel) for rows whose grid does not fit shared
//     memory (N above ~11.9 K at nsample 64). Permuting the planes into
//     cell order, so that a candidate's coordinates sit beside its
//     neighbours', cost more in the build than it saved in the tests
//     (PERF.md).
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
//   - The idx-only query (p2c_ball_query) is the same index-order scan
//     without the gather, a warp per query.
//
// The SA1 backward: d_xyz[b, idx[b, q, k], ch] += dg[b, q, k, ch] over
// every query q and slot k; the d_new_xyz = -sum_k dg term stays in
// PyTorch, as JAX keeps it outside its kernel (pallas_ballquery.py:790).
// It is bound by bytes: it reads dg once and writes the (b, n, 3) table.
// One thread per dg element, consecutive threads on consecutive channels,
// adds with float atomics (RED) into the table the wrapper zeroed, which
// lives in L2 (2.5 MB at B=4). The order of the adds into one address is
// not fixed, so the sums may differ from run to run in the last bits; the
// TPU kernel's one-hot matmul order is not reproduced either.

#include <cstdint>

#include <cuda_runtime.h>

#include "ballquery_layout.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxSmem = 232448;  // 227 KB a block may opt into on sm_90
constexpr int kMaxThreads = 1024;
constexpr int kScatterThreads = 256;
constexpr int kScatterMaxBlocks = 132 * 16;

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
// aligned dst), from the planes px, py, pz in shared memory.
template <int V>
__device__ __forceinline__ void write_coords(float* dst, const float* px, const float* py,
                                             const float* pz, const int* sel, int ns,
                                             float cx, float cy, float cz, int lane) {
  const int total = ns * 3 / V;
  for (int v = lane; v < total; v += 32) {
    int slot = V * v / 3;
    int ch = V * v - 3 * slot;
    float val[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float centre = ch == 0 ? cx : (ch == 1 ? cy : cz);
      const float* plane = ch == 0 ? px : (ch == 1 ? py : pz);
      val[i] = __fsub_rn(plane[sel[slot]], centre);
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
// every (ctas * warps)-th, and selects in index order. kGather: also write
// the centred coordinates (kVec: 16 bytes a lane).
template <bool kGather, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
ball_query_scan_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
                       int n, int s, int ns, float r2, bool stage_vec,
                       int* __restrict__ idx_out, float* __restrict__ grouped) {
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
    if constexpr (kGather) {
      write_coords<kVec ? 4 : 1>(grouped + row * ns * 3, sx, sx + n4, sx + 2 * n4, sel, ns,
                                 cx, cy, cz, lane);
    }
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
      write_coords<kVec ? 4 : 1>(grouped + row * ns * 3, px, py, pz, sel, ns, cx, cy, cz,
                                 lane);
    }
    __syncwarp();  // sel and the bitmap are rewritten by the next query
  }
}


// out (b, n, w) += dg (b, rows, w) at out[b, idx[b, r], :]; rows = s * ns.
// kWidth > 0 fixes the row width at compile time (SA1's 3 coordinates);
// kWidth == 0 reads it from w.
template <int kWidth>
__global__ void __launch_bounds__(kScatterThreads)
group_scatter_kernel(const int* __restrict__ idx, const float* __restrict__ dg,
                     int rows, int n, int w, size_t total,
                     float* __restrict__ out) {
  const int width = kWidth > 0 ? kWidth : w;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const size_t r = e / width;  // b * rows + (q * ns + k)
    const int ch = static_cast<int>(e - r * width);
    const size_t b = r / rows;
    const int j = idx[r];
    atomicAdd(out + (b * n + j) * width + ch, dg[e]);
  }
}

template <int kWidth>
int launch_scatter(const int* idx, const float* dg, float* out, int b,
                   int rows, int n, int w, void* stream) {
  if (b < 1 || rows < 1 || n < 1 || w < 1 || (kWidth > 0 && w != kWidth)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t total = static_cast<size_t>(b) * rows * w;
  size_t blocks = (total + kScatterThreads - 1) / kScatterThreads;
  if (blocks > kScatterMaxBlocks) blocks = kScatterMaxBlocks;
  group_scatter_kernel<kWidth>
      <<<static_cast<unsigned>(blocks), kScatterThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(idx, dg, rows, n, w, total, out);
  return static_cast<int>(cudaGetLastError());
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

int launch_scan(bool gather, bool vec, const float* xyz, const float* new_xyz, int* idx,
                float* grouped, int b, int n, int s, int ns, float r2, int ctas,
                int warps, void* stream) {
  const size_t smem = scan_smem(n, ns, warps);
  const auto kernel = !gather ? ball_query_scan_kernel<false, false>
                      : vec   ? ball_query_scan_kernel<true, true>
                              : ball_query_scan_kernel<true, false>;
  const bool stage_vec = n % 4 == 0 && aligned16(xyz);
  return launch(kernel, plan_ok(b, n, s, ns, ctas, warps, smem), b, ctas, warps, smem,
                stream, xyz, new_xyz, n, s, ns, r2, stage_vec, idx, grouped);
}

}  // namespace

// xyz (b, n, 3), new_xyz (b, s, 3) f32 -> idx (b, s, ns) i32: the
// index-order scan, `ctas` CTAs of `warps` warps a row.
extern "C" int p2c_ball_query(const float* xyz, const float* new_xyz, int* idx,
                              int b, int n, int s, int ns, float r2, int ctas,
                              int warps, void* stream) {
  return launch_scan(false, false, xyz, new_xyz, idx, nullptr, b, n, s, ns, r2, ctas,
                     warps, stream);
}

// xyz (b, n, 3), new_xyz (b, s, 3) f32 -> idx (b, s, ns) i32 and, unless
// `grouped` is null (the selection alone, for timing it), grouped (b, s,
// ns, 3) f32. grid != 0: the cell grid with `cap` (needs n <= 65535);
// else the index-order scan. 16-byte stores where ns * 3 % 4 == 0 and
// `grouped` is 16-byte aligned.
extern "C" int p2c_ball_query_grouped(const float* xyz, const float* new_xyz,
                                      int* idx, float* grouped, int b, int n,
                                      int s, int ns, float r2, int grid, int ctas,
                                      int warps, int cap, void* stream) {
  const bool gather = grouped != nullptr;
  const bool vec = ns * 3 % 4 == 0 && aligned16(grouped);
  if (!grid) {
    return launch_scan(gather, vec, xyz, new_xyz, idx, grouped, b, n, s, ns, r2, ctas,
                       warps, stream);
  }
  const size_t smem = grid_smem(n, ns, warps);
  const auto kernel = !gather ? ball_query_grid_kernel<false, false>
                      : vec   ? ball_query_grid_kernel<true, true>
                              : ball_query_grid_kernel<true, false>;
  const bool stage_vec = n % 4 == 0 && aligned16(xyz);
  return launch(kernel, plan_ok(b, n, s, ns, ctas, warps, smem) && n <= 65535 && cap >= 0,
                b, ctas, warps, smem, stream, xyz, new_xyz, n, s, ns, r2, cap, stage_vec,
                idx, grouped);
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

// idx (b, rows) i32, dg (b, rows, 3) f32 -> d_xyz (b, n, 3) f32, which the
// caller has zeroed.
extern "C" int p2c_ball_query_grouped_backward(const int* idx, const float* dg,
                                               float* d_xyz, int b, int rows,
                                               int n, void* stream) {
  return launch_scatter<3>(idx, dg, d_xyz, b, rows, n, 3, stream);
}
