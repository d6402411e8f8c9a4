// 3-NN inverse-distance interpolation for Hopper (sm_90a).
//
// Replaces: point2cyl_tpu/ops/pallas_knn.py:_knn3_kernel (pallas_call at
// :205 in _interp_fwd_impl, reached through three_nn_interpolate_pallas).
// Forward only; the backward kernel (_knn3_bwd_kernel) comes with training.
//
// What it computes: for each destination point, the 3 nearest source
// points by exact squared distance ((dx*dx + dy*dy) + dz*dz, no FMA), ties
// to the lowest source index; weights 1/(d + eps) normalised over the
// three; out = w0*f[i0] + w1*f[i1] + w2*f[i2] in that order. Distances are
// not quantised: the TPU kernel packs the source index into the 10 low
// mantissa bits (weights off by up to 2^-13 relative, S capped at 1024);
// this kernel does neither, and takes any S whose coordinates fit shared
// memory (S <= 19370).
//
// What bounds it on this card: the bytes it writes. At FP1 (B=16,
// 512 -> 8192 points, C=128) the output is 67 MB; the 16*8192*512
// distance evaluations are a few microseconds of the card's float32 rate.
//
// What the design does about it: one warp per destination point (8 per
// warp, 8 warps a block), the batch row's source coordinates staged once
// per block in shared memory. Each lane scans every 32nd source and keeps
// its own sorted top 3; three shuffle rounds merge the lanes' lists. The
// lanes then read the three source feature rows and write the output row
// with consecutive lanes on consecutive channels.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kPointsPerWarp = 8;
constexpr int kMaxSmem = 232448;  // 227 KB a block may opt into on sm_90
constexpr int kNoIndex = 0x7fffffff;

__device__ __forceinline__ bool before(float d2, int i2, float d1, int i1) {
  return d2 < d1 || (d2 == d1 && i2 < i1);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
knn3_kernel(const float* __restrict__ dst, const float* __restrict__ src,
            const float* __restrict__ feats, int n, int s, int c, float eps,
            float* __restrict__ out) {
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

}  // namespace

// dst (b, n, 3), src (b, s, 3), feats (b, s, c) f32 -> out (b, n, c) f32.
// Needs s >= 3 and 3 * s * 4 bytes of shared memory.
extern "C" int p2c_three_nn_interpolate(const float* dst, const float* src,
                                        const float* feats, float* out, int b,
                                        int n, int s, int c, float eps,
                                        void* stream) {
  const size_t smem = 3 * static_cast<size_t>(s) * sizeof(float);
  if (s < 3 || smem > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int per_block = kWarpsPerBlock * kPointsPerWarp;
  const dim3 grid((n + per_block - 1) / per_block, b);
  knn3_kernel<<<grid, kWarpsPerBlock * 32, smem,
                static_cast<cudaStream_t>(stream)>>>(dst, src, feats, n, s, c,
                                                     eps, out);
  return static_cast<int>(cudaGetLastError());
}
