// Ball query with fused neighbour gather for Hopper (sm_90a).
//
// Replaces two TPU kernels of point2cyl_tpu/ops/pallas_ballquery.py:
//   - _ballquery_grouped_kernel (pallas_call at :637, reached through
//     ball_query_grouped_pallas / ball_query_grouped): ball query, then
//     grouped = xyz[idx] - centre. SA1 of the backbone (N=8192, no
//     features). Entry point p2c_ball_query_grouped.
//   - _sa_grouped_exact_kernel (pallas_call at :474, reached through
//     sa_grouped_exact_pallas / sa_grouped_exact): exact ball query, then
//     grouped = [xyz[idx] - centre | feats[idx]]. SA2 (N=512, C=128).
//     Entry point p2c_sa_grouped_features.
//
// What it computes: for each query centre, the first nsample point
// indices (ascending) whose squared distance is <= r2, short rows padded
// with the first one (a row with none gives n-1), and the gathered rows in
// the layout (b, s, nsample, 3 [+ c]). Selection is exact at every N: the
// TPU kernel's blocked selection above N=1024 is not reproduced. The
// distance is ((dx*dx + dy*dy) + dz*dz) of exact differences with explicit
// round-to-nearest intrinsics (no FMA), so membership equals the JAX
// Pallas kernels (pallas_ballquery.py:_exact_d) bit for bit. The gather
// copies values, so it is exact where the TPU's one-hot matmul gather is
// about 1e-5 off.
//
// What bounds it on this card: the bytes it writes. At SA2 (B=16) the
// grouped tensor is 16*128*64*131*4 B = 69 MB; at SA1 it is 25 MB with
// the indices. The scan is cheap: it stops once nsample points are found.
//
// What the design does about it: one warp per query centre, the batch
// row's coordinates staged once per block in shared memory (96 KB at
// N=8192, shared by the block's 32 warps), and a scan of N in index order,
// 32 points a step: a ballot of the in-radius test, a popc prefix for each
// lane's output slot, and an early stop at nsample. The gather writes each
// query's contiguous (nsample, 3 + c) block with consecutive lanes on
// consecutive addresses, and reads feature rows from global memory with
// the lanes across the channels (SA2's 512 x 128 feature row does not fit
// shared memory beside its coordinates, and lives in L2).

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxSmem = 232448;  // 227 KB a block may opt into on sm_90

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
// per warp.
template <bool kFeats>
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

template <bool kFeats>
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
        ball_query_group_kernel<kFeats>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((s + warps_per_block - 1) / warps_per_block, b);
  ball_query_group_kernel<kFeats>
      <<<grid, warps_per_block * 32, smem, static_cast<cudaStream_t>(stream)>>>(
          xyz, feats, new_xyz, n, s, ns, c, r2, idx, grouped);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xyz (b, n, 3), new_xyz (b, s, 3) f32 -> idx (b, s, ns) i32,
// grouped (b, s, ns, 3) f32.
extern "C" int p2c_ball_query_grouped(const float* xyz, const float* new_xyz,
                                      int* idx, float* grouped, int b, int n,
                                      int s, int ns, float r2, void* stream) {
  return launch<false>(xyz, nullptr, new_xyz, idx, grouped, b, n, s, ns, 0,
                       r2, stream);
}

// xyz (b, n, 3), feats (b, n, c), new_xyz (b, s, 3) f32 -> idx (b, s, ns)
// i32, grouped (b, s, ns, 3 + c) f32.
extern "C" int p2c_sa_grouped_features(const float* xyz, const float* feats,
                                       const float* new_xyz, int* idx,
                                       float* grouped, int b, int n, int s,
                                       int ns, int c, float r2, void* stream) {
  return launch<true>(xyz, feats, new_xyz, idx, grouped, b, n, s, ns, c, r2,
                      stream);
}
