// Ball query, with and without fused neighbour gather, and the gather's
// scatter-add backward, for Hopper (sm_90a).
//
// Replaces five TPU kernels of point2cyl_tpu/ops/pallas_ballquery.py:
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
//   - _sa_exact_scatter_kernel (pallas_call at :876, in _sae_bwd): the SA2
//     gather's backward onto [xyz | feats]. Entry point
//     p2c_sa_grouped_backward.
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
// What bounds the forward on this card: the bytes it writes. At SA2 (B=16)
// the grouped tensor is 16*128*64*131*4 B = 69 MB; at SA1 it is 25 MB with
// the indices. The scan is cheap: it stops once nsample points are found.
//
// What the forward's design does about it: one warp per query centre, the
// batch row's coordinates staged once per block in shared memory (96 KB
// at N=8192, shared by the block's 32 warps), and a scan of N in index
// order, 32 points a step: a ballot of the in-radius test, a popc prefix
// for each lane's output slot, and an early stop at nsample. The gather
// writes each query's contiguous (nsample, 3 + c) block with consecutive
// lanes on consecutive addresses, and reads feature rows from global
// memory with the lanes across the channels (SA2's 512 x 128 feature row
// does not fit shared memory beside its coordinates, and lives in L2).
//
// The backward: out[b, idx[b, q, k], ch] += dg[b, q, k, ch] over every
// query q and slot k; the d_new_xyz = -sum_k dg[..., :3] term stays in
// PyTorch, as JAX keeps it outside its kernel (pallas_ballquery.py:790).
// It is bound by bytes: it reads dg once (17.2 MB at SA2, B=4) and writes
// the (b, n, w) table. One thread per dg element, consecutive threads on
// consecutive channels, adds with float atomics (RED) into the table the
// wrapper zeroed, which lives in L2 (2.5 MB at SA1, 1.1 MB at SA2). The
// order of the adds into one address is not fixed, so the sums may differ
// from run to run in the last bits; the TPU kernel's one-hot matmul
// order is not reproduced either.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxSmem = 232448;  // 227 KB a block may opt into on sm_90
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

// grid (ceil(s / warps_per_block), b); one warp per query centre.
// Dynamic shared memory: x[n] | y[n] | z[n] floats, then nsample int slots
// per warp. kGather: also write the grouped rows; kFeats: with features.
template <bool kGather, bool kFeats>
__global__ void ball_query_group_kernel(const float* __restrict__ xyz,
                                        const float* __restrict__ feats,
                                        const float* __restrict__ new_xyz,
                                        int n, int s, int ns, int c, float r2,
                                        int* __restrict__ idx_out,
                                        float* __restrict__ grouped) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = smem + n;
  float* sz = smem + 2 * n;
  int* slots = reinterpret_cast<int*>(smem + 3 * n);

  const int b = blockIdx.y;
  const int warps_per_block = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  for (int t = threadIdx.x; t < 3 * n; t += blockDim.x) {
    const int j = t / 3;
    smem[(t - 3 * j) * n + j] = p[t];  // (n, 3) -> planes x | y | z
  }
  __syncthreads();

  const int q = blockIdx.x * warps_per_block + warp;
  if (q >= s) return;  // no barrier follows
  int* sel = slots + warp * ns;
  const size_t row = static_cast<size_t>(b) * s + q;
  const float cx = new_xyz[row * 3];
  const float cy = new_xyz[row * 3 + 1];
  const float cz = new_xyz[row * 3 + 2];

  int count = 0;  // warp-uniform
  for (int base = 0; base < n && count < ns; base += 32) {
    const int j = base + lane;
    const bool in = j < n && sq_dist(cx, cy, cz, sx[j], sy[j], sz[j]) <= r2;
    const unsigned hits = __ballot_sync(kFullMask, in);
    if (in) {
      const int pos = count + __popc(hits & ((1u << lane) - 1u));
      if (pos < ns) sel[pos] = j;
    }
    count += __popc(hits);
  }
  __syncwarp();
  const int found = count < ns ? count : ns;
  const int first = found > 0 ? sel[0] : n - 1;
  for (int t = found + lane; t < ns; t += 32) sel[t] = first;
  __syncwarp();

  int* idx_row = idx_out + row * ns;
  for (int t = lane; t < ns; t += 32) idx_row[t] = sel[t];
  if (!kGather) return;

  const int width = 3 + c;
  float* g = grouped + row * static_cast<size_t>(ns) * width;
  const float* f = kFeats ? feats + static_cast<size_t>(b) * n * c : nullptr;
  const int total = ns * width;
  int slot = lane / width;
  int ch = lane - slot * width;
  for (int e = lane; e < total; e += 32) {
    const int j = sel[slot];
    float v;
    if (ch == 0) {
      v = __fsub_rn(sx[j], cx);
    } else if (ch == 1) {
      v = __fsub_rn(sy[j], cy);
    } else if (ch == 2) {
      v = __fsub_rn(sz[j], cz);
    } else {
      v = f[static_cast<size_t>(j) * c + (ch - 3)];
    }
    g[e] = v;
    ch += 32;
    while (ch >= width) {
      ch -= width;
      ++slot;
    }
  }
}

template <bool kGather, bool kFeats>
int launch(const float* xyz, const float* feats, const float* new_xyz,
           int* idx, float* grouped, int b, int n, int s, int ns, int c,
           float r2, void* stream) {
  const int warps_per_block = n > 1024 ? 32 : 8;
  const size_t smem = (3 * static_cast<size_t>(n) +
                       static_cast<size_t>(warps_per_block) * ns) * 4;
  if (smem > static_cast<size_t>(kMaxSmem) || ns < 1 || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ball_query_group_kernel<kGather, kFeats>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((s + warps_per_block - 1) / warps_per_block, b);
  ball_query_group_kernel<kGather, kFeats>
      <<<grid, warps_per_block * 32, smem, static_cast<cudaStream_t>(stream)>>>(
          xyz, feats, new_xyz, n, s, ns, c, r2, idx, grouped);
  return static_cast<int>(cudaGetLastError());
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

}  // namespace

// xyz (b, n, 3), new_xyz (b, s, 3) f32 -> idx (b, s, ns) i32.
extern "C" int p2c_ball_query(const float* xyz, const float* new_xyz, int* idx,
                              int b, int n, int s, int ns, float r2,
                              void* stream) {
  return launch<false, false>(xyz, nullptr, new_xyz, idx, nullptr, b, n, s,
                              ns, 0, r2, stream);
}

// xyz (b, n, 3), new_xyz (b, s, 3) f32 -> idx (b, s, ns) i32,
// grouped (b, s, ns, 3) f32.
extern "C" int p2c_ball_query_grouped(const float* xyz, const float* new_xyz,
                                      int* idx, float* grouped, int b, int n,
                                      int s, int ns, float r2, void* stream) {
  return launch<true, false>(xyz, nullptr, new_xyz, idx, grouped, b, n, s, ns,
                             0, r2, stream);
}

// xyz (b, n, 3), feats (b, n, c), new_xyz (b, s, 3) f32 -> idx (b, s, ns)
// i32, grouped (b, s, ns, 3 + c) f32.
extern "C" int p2c_sa_grouped_features(const float* xyz, const float* feats,
                                       const float* new_xyz, int* idx,
                                       float* grouped, int b, int n, int s,
                                       int ns, int c, float r2, void* stream) {
  return launch<true, true>(xyz, feats, new_xyz, idx, grouped, b, n, s, ns, c,
                            r2, stream);
}

// idx (b, rows) i32, dg (b, rows, 3) f32 -> d_xyz (b, n, 3) f32, which the
// caller has zeroed.
extern "C" int p2c_ball_query_grouped_backward(const int* idx, const float* dg,
                                               float* d_xyz, int b, int rows,
                                               int n, void* stream) {
  return launch_scatter<3>(idx, dg, d_xyz, b, rows, n, 3, stream);
}

// idx (b, rows) i32, dg (b, rows, w) f32 -> d_table (b, n, w) f32 with
// w = 3 + c, which the caller has zeroed.
extern "C" int p2c_sa_grouped_backward(const int* idx, const float* dg,
                                       float* d_table, int b, int rows, int n,
                                       int w, void* stream) {
  return launch_scatter<0>(idx, dg, d_table, b, rows, n, w, stream);
}
