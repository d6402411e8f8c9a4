// 3-NN inverse-distance interpolation for Hopper (sm_90a).
//
// Replaces point2cyl_tpu/ops/pallas_knn.py:_knn3_kernel (pallas_call at
// :205 in _interp_fwd_impl, reached through three_nn_interpolate_pallas).
// Entry point p2c_three_nn_interpolate. The backward (_knn3_bwd_kernel)
// is p2c_three_nn_backward in target_sum.cu.
//
// What the forward computes: for each destination point, the 3 nearest
// source points by exact squared distance ((dx*dx + dy*dy) + dz*dz, no
// FMA), ties to the lowest source index; weights 1/(d + eps) normalised
// over the three; out = w0*f[i0] + w1*f[i1] + w2*f[i2] in that order.
// Distances are not quantised: the TPU kernel packs the source index into
// the 10 low mantissa bits (weights off by up to 2^-13 relative, S capped
// at 1024); this kernel does neither, and takes any S whose coordinates
// fit shared memory (S <= 19370). When the caller passes idx/w buffers
// (training), the forward also writes each point's 3 source indices and
// weights, (b, n, 3) each.
//
// What bounds the forward on this card: by the roofline, the bytes it
// writes (67 MB of output at FP1, B=16, 512 -> 8192 points, C=128: 0.022
// ms); as measured, the search's instructions: 16*8192*512 distance
// evaluations and top-3 insertions of about 30 instruction slots each
// (the exact difference form rules out the |s|^2 + |d|^2 - 2 s.d
// expansion and its FMAs), 0.060 ms alone at FP1, B=16.
//
// What the forward's design does about it:
//   - Search, one thread per destination point. The block stages its
//     batch row's source coordinates in shared memory once, SoA, so every
//     lane of a warp reads the same sx[j..j+3], sy[..], sz[..] as three
//     16-byte broadcast loads that serve 4 sources for 32 points. Each
//     thread keeps a sorted top 3 in registers; sources come in increasing
//     index order and a strict < keeps the lower index of equal
//     distances, so no merge across lanes is needed. The last s % 4
//     sources are read from global memory, so the staged arrays stay
//     16-byte aligned and S <= 19370 still fits 227 KB.
//   - When B x N is too small to fill the card (FP2; FP1 at B=4), L = 2
//     or 4 lanes search for one point, each over every L-th 4-source
//     chunk, and merge their lists by (distance, index) with shuffles.
//     The wrapper picks L (ops/cuda_knn.py:three_nn_lanes).
//   - Interpolation, a warp per output row. Lanes shuffle out the
//     (idx, w) of the warp's points; the warp reads the three source rows
//     (feats stays in L2: 4 MB at FP1, B=16) and writes the output row,
//     16 bytes a lane (one store a lane per row at C=128), when C % 4 == 0
//     and feats and out are 16-byte aligned, else 4 bytes a lane (the
//     scalar path, taken by that rule and no other). Rows are written a
//     few (row, element) items at a time, their loads in flight together.
//   - The arithmetic is the earlier kernel's, so results are unchanged
//     bit for bit: weights __fdiv_rn(1, d + eps) normalised by their sum
//     ((r0 + r1) + r2), out = (w0*f0 + w1*f1) + w2*f2 with _rn intrinsics.
// It reaches 0.079 ms at FP1, B=16 (the bound is 0.022 ms) and 0.012 ms
// at FP2 on the H100 (PERF.md): the search and the writes do not yet
// overlap.
//
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 128;  // destination points a block, one a thread
constexpr int kMaxSmem = 232448;  // 227 KB a block may opt into on sm_90
constexpr int kNoIndex = 0x7fffffff;

// (d2, i2) comes before (d1, i1): smaller distance, then lower index.
__device__ __forceinline__ bool before(float d2, int i2, float d1, int i1) {
  return d2 < d1 || (d2 == d1 && i2 < i1);
}

// Source j at squared distance d enters the sorted top 3 (d0 <= d1 <= d2)
// if it comes before (d2, i2).
template <bool kAscending>
__device__ __forceinline__ void insert(float d, int j, float& d0, float& d1,
                                       float& d2, int& i0, int& i1, int& i2) {
  // a scan in increasing index order needs only the distance: a strict <
  // keeps the lower index of two equal distances
  auto first = [](float da, int ja, float db, int jb) {
    return kAscending ? da < db : before(da, ja, db, jb);
  };
  if (first(d, j, d2, i2)) {
    if (first(d, j, d1, i1)) {
      d2 = d1;
      i2 = i1;
      if (first(d, j, d0, i0)) {
        d1 = d0;
        i1 = i0;
        d0 = d;
        i0 = j;
      } else {
        d1 = d;
        i1 = j;
      }
    } else {
      d2 = d;
      i2 = j;
    }
  }
}

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz, float x,
                                         float y, float z) {
  const float dx = __fsub_rn(qx, x);
  const float dy = __fsub_rn(qy, y);
  const float dz = __fsub_rn(qz, z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__device__ __forceinline__ float combine(float f0, float f1, float f2, float w0,
                                         float w1, float w2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(f0, w0), __fmul_rn(f1, w1)),
                   __fmul_rn(f2, w2));
}

__device__ __forceinline__ float4 combine(float4 f0, float4 f1, float4 f2, float w0,
                                          float w1, float w2) {
  return make_float4(combine(f0.x, f1.x, f2.x, w0, w1, w2),
                     combine(f0.y, f1.y, f2.y, w0, w1, w2),
                     combine(f0.z, f1.z, f2.z, w0, w1, w2),
                     combine(f0.w, f1.w, f2.w, w0, w1, w2));
}

// The warp writes the output rows of its `rows` points; point t's sources
// and weights are in lane t * L. T is float4 (16 bytes a lane) or float.
// Work items are (row, element) pairs, kBatch at a time, so each lane has
// 3 * kBatch independent loads in flight before it stores.
template <int L, int kBatch, typename T>
__device__ __forceinline__ void write_rows(const float* f, float* out_rows, int rows,
                                           int c, int i0, int i1, int i2, float w0,
                                           float w1, float w2) {
  const int lane = threadIdx.x & 31;
  const int width = c * sizeof(float) / sizeof(T);  // elements a row
  const int per_lane = (width + 31) >> 5;
  const int items = rows * per_lane;
  const T* g = reinterpret_cast<const T*>(f);
  T* o = reinterpret_cast<T*>(out_rows);
  for (int e0 = 0; e0 < items; e0 += kBatch) {
    T a[kBatch], bq[kBatch], cq[kBatch];
    float v0[kBatch], v1[kBatch], v2[kBatch];
    size_t at[kBatch];
    bool live[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u;
      const int t = min(e / per_lane, rows - 1);  // warp-uniform
      const int v = lane + 32 * (e - t * per_lane);
      const int from = t * L;
      const int j0 = __shfl_sync(kFullMask, i0, from);
      const int j1 = __shfl_sync(kFullMask, i1, from);
      const int j2 = __shfl_sync(kFullMask, i2, from);
      v0[u] = __shfl_sync(kFullMask, w0, from);
      v1[u] = __shfl_sync(kFullMask, w1, from);
      v2[u] = __shfl_sync(kFullMask, w2, from);
      live[u] = e < items && v < width;
      at[u] = static_cast<size_t>(t) * width + v;
      if (live[u]) {
        a[u] = g[static_cast<size_t>(j0) * width + v];
        bq[u] = g[static_cast<size_t>(j1) * width + v];
        cq[u] = g[static_cast<size_t>(j2) * width + v];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (live[u]) o[at[u]] = combine(a[u], bq[u], cq[u], v0[u], v1[u], v2[u]);
    }
  }
}

// Grid (ceil(n / (kThreads / L)), b): L lanes a destination point. `vec`:
// C % 4 == 0 and feats, out 16-byte aligned, checked by the launcher.
// With one lane a point the grid is large (B * N / 128 blocks): 64
// registers keep 8 blocks on an SM, so that FP1 at B=16 runs in one wave,
// and rows are written 2 items at a time. A split search has few blocks
// and needs loads in flight more than blocks: 4 items at a time.
template <bool kSave, int L>
__global__ void __launch_bounds__(kThreads, L == 1 ? 8 : 1)
knn3_kernel(const float* __restrict__ dst, const float* __restrict__ src,
            const float* __restrict__ feats, int n, int s, int c, float eps,
            bool vec, float* __restrict__ out, int* __restrict__ idx_out,
            float* __restrict__ w_out) {
  extern __shared__ float4 smem4[];  // x[s4] | y[s4] | z[s4]
  constexpr int kPoints = kThreads / L;
  const int s4 = s & ~3;
  float* sx = reinterpret_cast<float*>(smem4);
  float* sy = sx + s4;
  float* sz = sy + s4;

  const int b = blockIdx.y;
  const float* p = src + static_cast<size_t>(b) * s * 3;
  for (int t = threadIdx.x; t < 3 * s4; t += kThreads) {
    const int j = t / 3;
    sx[(t - 3 * j) * s4 + j] = p[t];
  }
  __syncthreads();

  // lane `sub` of a point's L scans 4-source chunks sub, sub + L, ... and
  // then the tail sources s4 + sub, s4 + sub + L, ...: in increasing index
  // order. A thread past the end searches for the last point and writes
  // nothing.
  const int lane = threadIdx.x & 31;
  const int sub = lane & (L - 1);
  const int i = blockIdx.x * kPoints + threadIdx.x / L;
  const size_t row = static_cast<size_t>(b) * n + (i < n ? i : n - 1);
  const float qx = dst[row * 3];
  const float qy = dst[row * 3 + 1];
  const float qz = dst[row * 3 + 2];
  float d0 = __int_as_float(0x7f800000), d1 = d0, d2 = d0;
  int i0 = kNoIndex, i1 = kNoIndex, i2 = kNoIndex;
#pragma unroll 2
  for (int j = 4 * sub; j < s4; j += 4 * L) {
    const float4 x = *reinterpret_cast<const float4*>(sx + j);
    const float4 y = *reinterpret_cast<const float4*>(sy + j);
    const float4 z = *reinterpret_cast<const float4*>(sz + j);
    insert<true>(sq_dist(qx, qy, qz, x.x, y.x, z.x), j, d0, d1, d2, i0, i1, i2);
    insert<true>(sq_dist(qx, qy, qz, x.y, y.y, z.y), j + 1, d0, d1, d2, i0, i1, i2);
    insert<true>(sq_dist(qx, qy, qz, x.z, y.z, z.z), j + 2, d0, d1, d2, i0, i1, i2);
    insert<true>(sq_dist(qx, qy, qz, x.w, y.w, z.w), j + 3, d0, d1, d2, i0, i1, i2);
  }
  for (int j = s4 + sub; j < s; j += L) {
    insert<true>(sq_dist(qx, qy, qz, p[3 * j], p[3 * j + 1], p[3 * j + 2]), j, d0,
                 d1, d2, i0, i1, i2);
  }
  // the L lanes of a point merge their lists, (distance, index) in order
#pragma unroll
  for (int off = 1; off < L; off <<= 1) {
    const float e0 = __shfl_xor_sync(kFullMask, d0, off);
    const float e1 = __shfl_xor_sync(kFullMask, d1, off);
    const float e2 = __shfl_xor_sync(kFullMask, d2, off);
    const int k0 = __shfl_xor_sync(kFullMask, i0, off);
    const int k1 = __shfl_xor_sync(kFullMask, i1, off);
    const int k2 = __shfl_xor_sync(kFullMask, i2, off);
    insert<false>(e0, k0, d0, d1, d2, i0, i1, i2);
    insert<false>(e1, k1, d0, d1, d2, i0, i1, i2);
    insert<false>(e2, k2, d0, d1, d2, i0, i1, i2);
  }

  const float r0 = __fdiv_rn(1.0f, __fadd_rn(d0, eps));
  const float r1 = __fdiv_rn(1.0f, __fadd_rn(d1, eps));
  const float r2 = __fdiv_rn(1.0f, __fadd_rn(d2, eps));
  const float norm = __fadd_rn(__fadd_rn(r0, r1), r2);
  const float w0 = __fdiv_rn(r0, norm);
  const float w1 = __fdiv_rn(r1, norm);
  const float w2 = __fdiv_rn(r2, norm);
  if (kSave && sub == 0 && i < n) {
    idx_out[row * 3] = i0;
    idx_out[row * 3 + 1] = i1;
    idx_out[row * 3 + 2] = i2;
    w_out[row * 3] = w0;
    w_out[row * 3 + 1] = w1;
    w_out[row * 3 + 2] = w2;
  }

  // the warp's points and their output rows
  const int first = blockIdx.x * kPoints + (threadIdx.x & ~31) / L;
  const int rows = min(32 / L, n - first);  // warp-uniform
  if (rows <= 0) return;
  const float* f = feats + static_cast<size_t>(b) * s * c;
  float* o = out + (static_cast<size_t>(b) * n + first) * c;
  if (vec) {
    write_rows<L, L == 1 ? 2 : 4, float4>(f, o, rows, c, i0, i1, i2, w0, w1, w2);
  } else {
    write_rows<L, L == 1 ? 2 : 4, float>(f, o, rows, c, i0, i1, i2, w0, w1, w2);
  }
}

template <bool kSave, int L>
int launch(const float* dst, const float* src, const float* feats, float* out,
           int* idx, float* w, int b, int n, int s, int c, float eps,
           void* stream) {
  const size_t smem = 3 * static_cast<size_t>(s & ~3) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn3_kernel<kSave, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(feats) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  constexpr int kPoints = kThreads / L;
  const dim3 grid((n + kPoints - 1) / kPoints, b);
  knn3_kernel<kSave, L><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      dst, src, feats, n, s, c, eps, vec, out, idx, w);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSave>
int launch_lanes(const float* dst, const float* src, const float* feats, float* out,
                 int* idx, float* w, int b, int n, int s, int c, float eps,
                 int lanes, void* stream) {
  switch (lanes) {
    case 1: return launch<kSave, 1>(dst, src, feats, out, idx, w, b, n, s, c, eps, stream);
    case 2: return launch<kSave, 2>(dst, src, feats, out, idx, w, b, n, s, c, eps, stream);
    case 4: return launch<kSave, 4>(dst, src, feats, out, idx, w, b, n, s, c, eps, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dst (b, n, 3), src (b, s, 3), feats (b, s, c) f32 -> out (b, n, c) f32,
// and, when idx and w are not null, the 3 source indices (b, n, 3) i32 and
// weights (b, n, 3) f32 of each destination point, with `lanes` (1, 2 or
// 4) threads searching for each point. Needs n >= 1, s >= 3, c >= 1 and
// 3 * s * 4 bytes of shared memory.
extern "C" int p2c_three_nn_interpolate(const float* dst, const float* src,
                                        const float* feats, float* out,
                                        int* idx, float* w, int b, int n,
                                        int s, int c, float eps, int lanes,
                                        void* stream) {
  const size_t smem = 3 * static_cast<size_t>(s) * sizeof(float);
  if (b < 1 || n < 1 || c < 1 || s < 3 || smem > static_cast<size_t>(kMaxSmem) ||
      (idx == nullptr) != (w == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (idx != nullptr) {
    return launch_lanes<true>(dst, src, feats, out, idx, w, b, n, s, c, eps, lanes,
                              stream);
  }
  return launch_lanes<false>(dst, src, feats, out, nullptr, nullptr, b, n, s, c, eps,
                             lanes, stream);
}
