// 3-NN inverse-distance interpolation and its backward for Hopper (sm_90a).
//
// Replaces two TPU kernels of point2cyl_tpu/ops/pallas_knn.py:
//   - _knn3_kernel (pallas_call at :205 in _interp_fwd_impl, reached
//     through three_nn_interpolate_pallas). Entry point
//     p2c_three_nn_interpolate.
//   - _knn3_bwd_kernel (pallas_call at :141 in _interp_bwd_feats, the
//     custom VJP's feature cotangent d_feats = W^T g). Entry point
//     p2c_three_nn_backward.
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
// What bounds the forward on this card: the bytes it writes. At FP1
// (B=16, 512 -> 8192 points, C=128) the output is 67 MB; the 16*8192*512
// distance evaluations are a few microseconds of the card's float32 rate.
//
// What the forward's design does about it: one warp per destination point
// (8 per warp, 8 warps a block), the batch row's source coordinates staged
// once per block in shared memory. Each lane scans every 32nd source and
// keeps its own sorted top 3; three shuffle rounds merge the lanes' lists.
// The lanes then read the three source feature rows and write the output
// row with consecutive lanes on consecutive channels.
//
// The backward: d_feats[b, idx[b, i, k], ch] += w[b, i, k] * g[b, i, ch].
// It reads the forward's saved (idx, w) instead of recomputing the
// distances as the TPU kernel does (0.8 MB at FP1, B=4, against a second
// 4*8192*512 distance scan). It is bound by the bytes of g (16.8 MB at
// FP1, B=4). One thread per g element, consecutive threads on consecutive
// channels, three float atomic adds (RED) into the (b, s, c) table the
// wrapper zeroed, which stays in L2 (1 MB at FP1). The order of the adds
// into one address is not fixed, so sums may differ from run to run in
// the last bits.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kPointsPerWarp = 8;
constexpr int kMaxSmem = 232448;  // 227 KB a block may opt into on sm_90
constexpr int kNoIndex = 0x7fffffff;
constexpr int kScatterThreads = 256;
constexpr int kScatterMaxBlocks = 132 * 16;

__device__ __forceinline__ bool before(float d2, int i2, float d1, int i1) {
  return d2 < d1 || (d2 == d1 && i2 < i1);
}

template <bool kSave>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
knn3_kernel(const float* __restrict__ dst, const float* __restrict__ src,
            const float* __restrict__ feats, int n, int s, int c, float eps,
            float* __restrict__ out, int* __restrict__ idx_out,
            float* __restrict__ w_out) {
  extern __shared__ float smem[];  // x[s] | y[s] | z[s]
  float* sx = smem;
  float* sy = smem + s;
  float* sz = smem + 2 * s;

  const int b = blockIdx.y;
  const float* p = src + static_cast<size_t>(b) * s * 3;
  for (int t = threadIdx.x; t < 3 * s; t += blockDim.x) {
    const int j = t / 3;
    smem[(t - 3 * j) * s + j] = p[t];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int first = (blockIdx.x * kWarpsPerBlock + warp) * kPointsPerWarp;
  const float* f = feats + static_cast<size_t>(b) * s * c;

  for (int t = 0; t < kPointsPerWarp; ++t) {
    const int i = first + t;
    if (i >= n) break;  // warp-uniform
    const size_t row = static_cast<size_t>(b) * n + i;
    const float qx = dst[row * 3];
    const float qy = dst[row * 3 + 1];
    const float qz = dst[row * 3 + 2];

    // This lane's sorted 3 nearest; its sources come in increasing index
    // order, so a strict < keeps the lower index of two equal distances.
    float d0 = __int_as_float(0x7f800000), d1 = d0, d2 = d0;
    int i0 = kNoIndex, i1 = kNoIndex, i2 = kNoIndex;
    for (int j = lane; j < s; j += 32) {
      const float dx = __fsub_rn(qx, sx[j]);
      const float dy = __fsub_rn(qy, sy[j]);
      const float dz = __fsub_rn(qz, sz[j]);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      if (d < d2) {
        if (d < d1) {
          d2 = d1;
          i2 = i1;
          if (d < d0) {
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

    // Merge: three rounds of a warp argmin over the lanes' list heads.
    float sel_d[3];
    int sel_i[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      float bd = d0;
      int bi = i0;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float od = __shfl_xor_sync(kFullMask, bd, off);
        const int oi = __shfl_xor_sync(kFullMask, bi, off);
        if (before(od, oi, bd, bi)) {
          bd = od;
          bi = oi;
        }
      }
      sel_d[r] = bd;
      sel_i[r] = bi;
      if (i0 == bi) {  // each source index lives in exactly one lane
        d0 = d1;
        i0 = i1;
        d1 = d2;
        i1 = i2;
        d2 = __int_as_float(0x7f800000);
        i2 = kNoIndex;
      }
    }

    const float r0 = __fdiv_rn(1.0f, __fadd_rn(sel_d[0], eps));
    const float r1 = __fdiv_rn(1.0f, __fadd_rn(sel_d[1], eps));
    const float r2 = __fdiv_rn(1.0f, __fadd_rn(sel_d[2], eps));
    const float norm = __fadd_rn(__fadd_rn(r0, r1), r2);
    const float w0 = __fdiv_rn(r0, norm);
    const float w1 = __fdiv_rn(r1, norm);
    const float w2 = __fdiv_rn(r2, norm);
    if (kSave && lane == 0) {
      idx_out[row * 3] = sel_i[0];
      idx_out[row * 3 + 1] = sel_i[1];
      idx_out[row * 3 + 2] = sel_i[2];
      w_out[row * 3] = w0;
      w_out[row * 3 + 1] = w1;
      w_out[row * 3 + 2] = w2;
    }
    const float* f0 = f + static_cast<size_t>(sel_i[0]) * c;
    const float* f1 = f + static_cast<size_t>(sel_i[1]) * c;
    const float* f2 = f + static_cast<size_t>(sel_i[2]) * c;
    float* o = out + row * c;
    for (int ch = lane; ch < c; ch += 32) {
      o[ch] = __fadd_rn(__fadd_rn(__fmul_rn(f0[ch], w0), __fmul_rn(f1[ch], w1)),
                        __fmul_rn(f2[ch], w2));
    }
  }
}

template <bool kSave>
int launch(const float* dst, const float* src, const float* feats, float* out,
           int* idx, float* w, int b, int n, int s, int c, float eps,
           void* stream) {
  const size_t smem = 3 * static_cast<size_t>(s) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn3_kernel<kSave>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int per_block = kWarpsPerBlock * kPointsPerWarp;
  const dim3 grid((n + per_block - 1) / per_block, b);
  knn3_kernel<kSave><<<grid, kWarpsPerBlock * 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      dst, src, feats, n, s, c, eps, out, idx, w);
  return static_cast<int>(cudaGetLastError());
}

// out (b, s, c) += w[b, i, k] * g[b, i, :] at out[b, idx[b, i, k], :].
__global__ void __launch_bounds__(kScatterThreads)
knn3_backward_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                     const float* __restrict__ w, int n, int s, int c,
                     size_t total, float* __restrict__ out) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const size_t row = e / c;  // b * n + i
    const int ch = static_cast<int>(e - row * c);
    const size_t base = (row / n) * s;
    const float gv = g[e];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const size_t j = base + idx[row * 3 + k];
      atomicAdd(out + j * c + ch, __fmul_rn(w[row * 3 + k], gv));
    }
  }
}

}  // namespace

// dst (b, n, 3), src (b, s, 3), feats (b, s, c) f32 -> out (b, n, c) f32,
// and, when idx and w are not null, the 3 source indices (b, n, 3) i32 and
// weights (b, n, 3) f32 of each destination point. Needs s >= 3 and
// 3 * s * 4 bytes of shared memory.
extern "C" int p2c_three_nn_interpolate(const float* dst, const float* src,
                                        const float* feats, float* out,
                                        int* idx, float* w, int b, int n,
                                        int s, int c, float eps,
                                        void* stream) {
  const size_t smem = 3 * static_cast<size_t>(s) * sizeof(float);
  if (s < 3 || smem > static_cast<size_t>(kMaxSmem) ||
      (idx == nullptr) != (w == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (idx != nullptr) {
    return launch<true>(dst, src, feats, out, idx, w, b, n, s, c, eps, stream);
  }
  return launch<false>(dst, src, feats, out, nullptr, nullptr, b, n, s, c, eps,
                       stream);
}

// g (b, n, c), idx (b, n, 3) i32, w (b, n, 3) f32 -> d_feats (b, s, c) f32,
// which the caller has zeroed.
extern "C" int p2c_three_nn_backward(const float* g, const int* idx,
                                     const float* w, float* d_feats, int b,
                                     int n, int s, int c, void* stream) {
  if (b < 1 || n < 1 || s < 1 || c < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t total = static_cast<size_t>(b) * n * c;
  size_t blocks = (total + kScatterThreads - 1) / kScatterThreads;
  if (blocks > kScatterMaxBlocks) blocks = kScatterMaxBlocks;
  knn3_backward_kernel<<<static_cast<unsigned>(blocks), kScatterThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      g, idx, w, n, s, c, total, d_feats);
  return static_cast<int>(cudaGetLastError());
}
