// Ordered per-target sums for Hopper (sm_90a): the 3-NN backward and the
// SA1 and SA2 gathers' backwards, one kernel family.
//
// Replaces three TPU kernels:
//   - point2cyl_tpu/ops/pallas_knn.py:_knn3_bwd_kernel (pallas_call at
//     :141 in _interp_bwd_feats, the custom VJP's feature cotangent
//     d_feats = W^T g). Entry point p2c_three_nn_backward.
//   - point2cyl_tpu/ops/pallas_ballquery.py:_sa_exact_scatter_kernel
//     (pallas_call at :876 in _sae_bwd): the SA2 gather's backward onto
//     [xyz | feats]. Entry point p2c_sa_grouped_backward.
//   - point2cyl_tpu/ops/pallas_ballquery.py:_bqg_scatter_kernel
//     (pallas_call at :767 in _bqg_bwd): the SA1 gather's backward onto
//     xyz, d_xyz[b, idx] += d_grouped. The same entry point, 3 wide.
//
// What they compute: out[b, t, :] is the sum of v_e over the entries e of
// cloud b whose target idx[b, e] is t. At 3-NN, e = 3 i + k is point i's
// k-th source, v_e = w[b, e] * g[b, i, :] and the targets are the S
// sources; at SA1 and SA2, e = q * nsample + k is slot k of ball q, v_e =
// dg[b, q, k, :] and the targets are the N rows of the point table. Each
// sum is the float32 sum, from 0, of its terms in ascending e
// (__fmul_rn, __fadd_rn): equal bit for bit to np.add.at on the host and
// from run to run. The TPU kernels accumulate each output block in order
// on one core, so their results are fixed too.
//
// What bounds them on this card: by the roofline, the bytes (g read once:
// 16.8 MB at FP1, B=4, 0.0050 ms; dg 17.2 MB at SA2, 1.6 MB at SA1 beside
// its 0.4 MB of indices and 0.4 MB table). As built, each row of g is read
// once for each of its entries' targets, three times at 3-NN (50 MB from
// L2 at FP1, where g, written by the MLP's backward just before, still
// lies), and each CTA reads its cloud's index entries once.
//
// The design: gather by target, no atomics in global memory and no fill
// of the output.
//   1. A CTA owns up to `per_cta` targets of one cloud, 2^k apart (CTA j
//      of 2^k takes targets j, j + 2^k, ...), grid (2^k, B): a ball short
//      of nsample points pads with its first index, so low indices collect
//      most entries, and spread this way they fall on different CTAs. The
//      plan comes from the caller (ops/cuda_scatter.py:scatter_plan):
//      about 132 CTAs or more at B=4.
//   2. It takes its cloud's index entries in windows (one window where the
//      window fits shared memory: all 24,576 entries at FP1, all 32,768 at
//      SA1), reading them with 16-byte loads, 12 in flight a thread. Two
//      ways to list them (enum Listing), chosen by the plan:
//      - kBitmaps, for few targets with many entries each (FP1, FP2 and
//        SA2: 4-16 targets a CTA, 12-48 entries a target). An entry of one of
//        its targets sets its bit in that target's bitmap of the window
//        and its word's bit in the target's summary of non-zero words
//        (shared atomicOr), and adds one to its count: none of these
//        depends on the order of the atomics. Each warp scans the counts
//        into the lists' starts. A warp a target then reads its bitmap in
//        entry order, lane l a run of words (a pad word after each run
//        puts the lanes on 32 banks), the non-zero ones only, and one
//        prefix over the lanes' popcounts places each set bit's entry:
//        every list is in ascending entry order. A lane writes a word of a
//        few bits itself, the whole warp a denser one (a padded ball:
//        words of 32 bits). Per-warp counts, a scan and ranks from
//        __match_any_sync, the first build, took four times as long to
//        list at FP1 (PERF.md).
//      - kCounts, for many targets with few entries each and rows of at
//        most kListMaxWidth floats: SA1's gather backward only (8,192 targets,
//        about 4 entries each, 3 wide; 256 targets a CTA at B=4, where
//        bitmaps would take 1,024 CTAs of 205 KB each, 7.8 waves and 0.098
//        ms). An entry of one of its targets adds one to the target's
//        count (shared atomicAdd; a count does not depend on the order)
//        and is staged as (entry << 16 | target) in its warp's region, at
//        a place from a shared atomic on the warp's fill. A block-wide scan
//        gives the lists' starts, each staged entry takes the next place
//        of its target's list (a cursor, the order within a list
//        arbitrary), and each list is sorted ascending: by one thread up
//        to kLaneSortMax entries (in registers, a bitonic network the
//        size of the warp's longest such list), else by a warp (up to 32
//        a bitonic network of shuffles, more one in shared memory whose
//        compare-exchanges all put the smaller entry first, so that places
//        past the list's end never take part: a padded ball sends up to
//        nsample entries to one target, a dense cluster far more). Every
//        CTA reads all of its cloud's entries (16.8 MB from L2 at SA1, the
//        larger part of its time); clusters sharing one read through
//        distributed shared memory measured slower (PERF.md).
//      A list holds uint16 entry ids within the window (at most 65,536
//      entries).
//   3. The sums. kCounts: the thread that sorted a list of at most
//      kLaneSortMax entries sums it from its registers, kListRows rows'
//      loads in flight; the warp that sorted a longer one sums it (lane u
//      loads entry u's row, and the adds go in list order through
//      shuffles). kBitmaps: the sums are cut into items, a target and a
//      32-lane share of its row (16 bytes a lane where C % 4 == 0 and g's
//      rows are 16-byte aligned, else 4 bytes: SA2's 131 channels make 5
//      shares), each item to the next free warp, so a target that many
//      entries share runs on as many warps as its row has shares. The
//      lanes walk their list in order, 32 registers of rows' loads in
//      flight and the adds in sequence, and write their share of the row
//      once. Either way a target with no entries writes zeros, and a later
//      window reads the row back and goes on adding in the same order.
//   g is read through its batch and row strides: FP2's cotangent is a
//   slice of the gradient of a concatenation, row stride 384, 512 bytes
//   into the row.
// A target with many entries serialises the warps of its shares (a
// 3-point cloud at 3-NN sends a third of all entries to each target).

#include <cstdint>

#include <cuda_runtime.h>

#include "target_sum_layout.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxSmem = 232448;  // 227 KB a block may opt into on sm_90
constexpr int kListLoads = 8;     // index loads a thread keeps in flight (kCounts)
constexpr int kLaneSortMax = 16;  // longest list a thread sorts alone (kCounts)
constexpr int kListRows = 8;      // rows a thread's sum keeps in flight (kCounts)

enum Mode { kThreeNN = 0, kGroup = 1 };

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float scale(float w, float v) { return __fmul_rn(w, v); }

__device__ __forceinline__ float4 scale(float w, float4 v) {
  return make_float4(__fmul_rn(w, v.x), __fmul_rn(w, v.y), __fmul_rn(w, v.z),
                     __fmul_rn(w, v.w));
}

template <typename T>
__device__ __forceinline__ T zero() {
  return T{};
}

// A warp's share of a target: out_row[v] (lane l holds element v of the
// row, in elements of T) becomes the sum, in list order, of the listed
// entries' element v, from 0 when `first`, else from out_row[v] itself.
// kBatch rows' loads are in flight together (32 registers of them; 16
// and as many weights for 4-byte rows at 3-NN); the adds stay in list
// order.
template <int kMode, typename T>
__device__ __forceinline__ void sum_share(const uint16_t* list, int beg, int end, int e0,
                                          const float* gb, long long g_row,
                                          const float* wb, int v, int width, bool first,
                                          T* out_row) {
  constexpr int kFloats = static_cast<int>(sizeof(T) / sizeof(float));
  constexpr int kBatch = kMode == kThreeNN && kFloats == 1 ? 16 : 32 / kFloats;
  const bool live = v < width;
  T acc = first || !live ? zero<T>() : out_row[v];
  for (int p = beg; p < end; p += kBatch) {
    T val[kBatch];
    float wt[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      wt[u] = 1.0f;
      if (p + u < end) {  // warp-uniform
        const int e = e0 + list[p + u];
        const int row = kMode == kThreeNN ? e / 3 : e;
        if (kMode == kThreeNN) wt[u] = wb[e];
        if (live) val[u] = reinterpret_cast<const T*>(gb + row * g_row)[v];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (p + u < end && live) {
        acc = add(acc, kMode == kThreeNN ? scale(wt[u], val[u]) : val[u]);
      }
    }
  }
  if (live) out_row[v] = acc;
}

// The bitmaps listing (kBitmaps). Grid (2^shift, b), `warps` warps a CTA,
// sum_smem(window, per_cta) bytes of shared memory; CTA k owns targets k,
// k + 2^shift, ..., at most per_cta of them. idx (b, entries) i32; w (b, entries) f32 at 3-NN; g's
// row r of cloud b at g + b * g_batch + r * g_row, c floats; out (b,
// targets, c) f32. `load_vec`: entries % 4 == 0 and idx 16-byte aligned;
// T = float4 needs c % 4 == 0 and 16-byte aligned rows of g and out.
// kStop > 0 ends each window after phase kStop (1 the bitmaps, 2 the
// lists), writing nothing: p2c_target_sum_probe times the phases so.
template <int kMode, typename T, int kStop>
__global__ void __launch_bounds__(kSumMaxWarps * 32)
target_sum_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                  const float* __restrict__ g, long long g_batch, long long g_row,
                  int targets, int entries, int c, int per_cta, int shift, int window,
                  bool load_vec, float* __restrict__ out) {
  constexpr int kLoads = 12;  // index loads a thread keeps in flight
  extern __shared__ int4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int sh = sum_bitmap_shift(window);
  const int words = sum_bitmap_words(window);  // a target's bitmap, padded
  // then a bit for each of its words that is not zero
  const int stride = words + sum_summary_words(window);
  unsigned* bits = reinterpret_cast<unsigned*>(smem);
  uint16_t* list = reinterpret_cast<uint16_t*>(smem + sum_bitmaps_bytes(window, per_cta));
  int* sizes = reinterpret_cast<int*>(smem + sum_bitmaps_bytes(window, per_cta) +
                                      sum_list_bytes(window));
  int* starts = sizes + per_cta;
  int* next = starts + per_cta + 1;

  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int b = blockIdx.y;
  const int first_target = blockIdx.x;
  const int tile = min(per_cta, (targets - first_target + (1 << shift) - 1) >> shift);
  if (tile <= 0) return;  // the whole CTA: no target this far
  const int* ib = idx + static_cast<size_t>(b) * entries;
  const float* wb = kMode == kThreeNN ? w + static_cast<size_t>(b) * entries : nullptr;
  const float* gb = g + b * g_batch;
  float* ob = out + static_cast<size_t>(b) * targets * c;
  const int width = c / static_cast<int>(sizeof(T) / sizeof(float));
  const int shares = (width + 31) >> 5;  // 32-element shares of a row

  // the entry's place among the CTA's targets, or >= tile
  const unsigned apart = (1u << shift) - 1u;
  auto local = [&](int v) {
    const unsigned u = static_cast<unsigned>(v) - static_cast<unsigned>(first_target);
    return (u & apart) == 0u ? u >> shift : ~0u;
  };
  // entry e of the window, of local target lt < tile: its bit in the
  // target's bitmap, its word's bit in the summary, one more in the count
  // (none of them depends on the order of the atomics)
  auto mark = [&](int e, unsigned lt) {
    const int wd = e >> 5;
    atomicOr(&bits[lt * stride + wd + (wd >> sh)], 1u << (e & 31));
    atomicOr(&bits[lt * stride + words + (wd >> 5)], 1u << (wd & 31));
    atomicAdd(&sizes[lt], 1);
  };

  for (int e0 = 0; e0 < entries; e0 += window) {
    const int len = min(window, entries - e0);
    const int nw = (len + 31) >> 5;  // bitmap words in use
    for (int i = threadIdx.x; i < tile * stride; i += blockDim.x) bits[i] = 0u;
    if (threadIdx.x < tile) sizes[threadIdx.x] = 0;
    if (threadIdx.x == 0) *next = 0;
    __syncthreads();

    // 1. each entry of the CTA's targets marks itself; kLoads 16-byte
    // loads (4 entries each) a thread in flight
    if (load_vec) {
      const int4* src = reinterpret_cast<const int4*>(ib + e0);
      const int quads = len >> 2;
      for (int q0 = threadIdx.x; q0 < quads; q0 += kLoads * blockDim.x) {
        int4 v[kLoads];
#pragma unroll
        for (int k = 0; k < kLoads; ++k) {
          const int q = q0 + k * blockDim.x;
          if (q < quads) v[k] = src[q];
        }
#pragma unroll
        for (int k = 0; k < kLoads; ++k) {
          const int q = q0 + k * blockDim.x;
          if (q < quads) {
            const int entry[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const unsigned lt = local(entry[u]);
              if (lt < static_cast<unsigned>(tile)) mark(4 * q + u, lt);
            }
          }
        }
      }
    } else {
      for (int e1 = threadIdx.x; e1 < len; e1 += kLoads * blockDim.x) {
        int v[kLoads];
#pragma unroll
        for (int k = 0; k < kLoads; ++k) {
          const int e = e1 + k * blockDim.x;
          if (e < len) v[k] = ib[e0 + e];
        }
#pragma unroll
        for (int k = 0; k < kLoads; ++k) {
          const int e = e1 + k * blockDim.x;
          const unsigned lt = e < len ? local(v[k]) : ~0u;
          if (lt < static_cast<unsigned>(tile)) mark(e, lt);
        }
      }
    }
    __syncthreads();
    if (kStop == 1) continue;

    // 2. every warp scans the counts: lane l's `before` is where target
    // l's list begins (warp 0 keeps them for phase 3). Then a warp a
    // target reads its bitmap in entry order, lane l a run of 2^sh words,
    // and writes the set bits' entries in ascending order.
    {
      const int size = lane < tile ? sizes[lane] : 0;
      int before = size;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(kFullMask, before, off);
        if (lane >= off) before += t;
      }
      before -= size;
      if (warp == 0) {
        if (lane < tile) starts[lane] = before;
        if (lane == 31) starts[tile] = before + size;  // the end
      }
      const int lo = lane << sh;
      const int hi = min(lo + (1 << sh), nw);
      for (int lt = warp; lt < tile; lt += warps) {
        const unsigned* tb = bits + lt * stride + lane;  // word wd at tb[wd]
        const unsigned* nonzero = bits + lt * stride + words;
        // fn(wd) for each word of the lane's run that is not zero, in order
        auto each_word = [&](auto&& fn) {
          for (int sw = lo >> 5; lo < hi && sw < (hi + 31) >> 5; ++sw) {
            const int base = sw << 5;
            unsigned m = nonzero[sw];
            if (base < lo) m &= ~0u << (lo - base);
            if (hi - base < 32) m &= (1u << (hi - base)) - 1u;
            for (; m != 0u; m &= m - 1u) fn(base + __ffs(static_cast<int>(m)) - 1);
          }
        };
        int mine = 0;
        each_word([&](int wd) { mine += __popc(tb[wd]); });
        int incl = mine;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int t = __shfl_up_sync(kFullMask, incl, off);
          if (lane >= off) incl += t;
        }
        const int first_at = __shfl_sync(kFullMask, before, lt) + incl - mine;
        // a lane writes the entries of its run's words of a few bits itself;
        // a denser word (short balls at SA2 pad with their first index:
        // words of 32 bits) is left to the whole warp below
        int at = first_at;
        bool dense_seen = false;
        each_word([&](int wd) {
          const unsigned word = tb[wd];
          if (__popc(word) > 4) {
            dense_seen = true;
            at += __popc(word);
            return;
          }
          for (unsigned left = word; left != 0u; left &= left - 1u) {
            list[at++] = static_cast<uint16_t>((wd << 5) + __ffs(static_cast<int>(left)) - 1);
          }
        });
        if (__any_sync(kFullMask, dense_seen)) {
          at = first_at;
          for (int k = 0; k < (1 << sh); ++k) {
            const int wd = lo + k;
            const unsigned word = wd < hi ? tb[wd] : 0u;
            for (unsigned lanes = __ballot_sync(kFullMask, __popc(word) > 4); lanes != 0u;
                 lanes &= lanes - 1u) {
              const int from = __ffs(static_cast<int>(lanes)) - 1;
              const unsigned bitsof = __shfl_sync(kFullMask, word, from);
              const int base = __shfl_sync(kFullMask, at, from);
              if (bitsof >> lane & 1u) {
                list[base + __popc(bitsof & below)] =
                    static_cast<uint16_t>((((from << sh) + k) << 5) + lane);
              }
            }
            at += __popc(word);
          }
        }
      }
    }
    __syncthreads();
    if (kStop == 2) continue;

    // 3. sum: the CTA's (target, 32-element share of its row) items, each
    // to the next free warp
    for (;;) {
      int item = 0;
      if (lane == 0) item = atomicAdd(next, 1);
      item = __shfl_sync(kFullMask, item, 0);
      if (item >= tile * shares) break;
      const int lt = item / shares;
      const size_t target = first_target + (static_cast<size_t>(lt) << shift);
      sum_share<kMode, T>(list, starts[lt], starts[lt + 1], e0, gb, g_row, wb,
                          (item % shares) * 32 + lane, width, e0 == 0,
                          reinterpret_cast<T*>(ob + target * c));
    }
    __syncthreads();  // the next window rewrites the bitmaps and the lists
  }
}


// Sort id[0, kN) ascending in registers: a bitonic network, every index
// known at compile time (kN a power of two; places past a list's end hold
// a key above every entry).
template <int kN>
__device__ __forceinline__ void sort_regs(int (&id)[kLaneSortMax]) {
#pragma unroll
  for (int k = 2; k <= kN; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const int l = i ^ j;
        if (l > i) {
          const int lo = min(id[i], id[l]);
          const int hi = max(id[i], id[l]);
          id[i] = (i & k) == 0 ? lo : hi;
          id[l] = (i & k) == 0 ? hi : lo;
        }
      }
    }
  }
}

// A thread's sum of one target's row of c <= kListMaxWidth floats over n <=
// kLaneSortMax entries: out_row[ch] becomes the sum, in list order, of the
// element ch of the entries id(0), ..., id(n - 1) (id may read registers),
// from 0 when `first`, else from out_row[ch] itself; kListRows rows' loads
// in flight.
template <typename Id>
__device__ __forceinline__ void sum_row(Id&& id, int n, int e0, const float* gb,
                                        long long g_row, int c, bool first, float* out_row) {
  float acc[kListMaxWidth];
#pragma unroll
  for (int ch = 0; ch < kListMaxWidth; ++ch) acc[ch] = first || ch >= c ? 0.0f : out_row[ch];
#pragma unroll
  for (int p = 0; p < kLaneSortMax; p += kListRows) {  // every id(u) at a u known here
    if (p >= n) break;
    float val[kListRows][kListMaxWidth];
#pragma unroll
    for (int u = 0; u < kListRows; ++u) {
      if (p + u < n) {
        const float* row = gb + (e0 + id(p + u)) * g_row;
#pragma unroll
        for (int ch = 0; ch < kListMaxWidth; ++ch) val[u][ch] = ch < c ? row[ch] : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kListRows; ++u) {
      if (p + u < n) {
#pragma unroll
        for (int ch = 0; ch < kListMaxWidth; ++ch) acc[ch] = add(acc[ch], val[u][ch]);
      }
    }
  }
#pragma unroll
  for (int ch = 0; ch < kListMaxWidth; ++ch) {
    if (ch < c) out_row[ch] = acc[ch];
  }
}

// A warp's sum of one target's row of c <= kListMaxWidth floats over a long
// list: lane u loads the row of entry p + u of each 32 (all in flight),
// and every lane adds them in list order, each value from its lane by a
// shuffle; lane ch writes element ch. The same sums as sum_row.
__device__ __forceinline__ void warp_sum_row(const uint16_t* list, int n, int e0,
                                             const float* gb, long long g_row, int c,
                                             bool first, float* out_row, int lane) {
  float acc[kListMaxWidth];
#pragma unroll
  for (int ch = 0; ch < kListMaxWidth; ++ch) acc[ch] = first || ch >= c ? 0.0f : out_row[ch];
  for (int p = 0; p < n; p += 32) {
    float val[kListMaxWidth] = {};
    if (p + lane < n) {
      const float* row = gb + (e0 + list[p + lane]) * g_row;
#pragma unroll
      for (int ch = 0; ch < kListMaxWidth; ++ch) {
        if (ch < c) val[ch] = row[ch];
      }
    }
    const int m = min(32, n - p);
    for (int u = 0; u < m; ++u) {
#pragma unroll
      for (int ch = 0; ch < kListMaxWidth; ++ch) {
        acc[ch] = add(acc[ch], __shfl_sync(kFullMask, val[ch], u));
      }
    }
  }
#pragma unroll
  for (int ch = 0; ch < kListMaxWidth; ++ch) {
    if (lane == ch && ch < c) out_row[ch] = acc[ch];
  }
}

// Sort s[0, len) ascending, the whole warp (len > 1): up to 32 entries a
// bitonic network of shuffles in registers; more, a bitonic network in
// shared memory over the next power of two whose first step of each merge
// compares mirrored places, so that every compare-exchange puts the
// smaller entry at the lower place, and a pair reaching past len (an
// entry past the end counts as the largest) is skipped.
__device__ __forceinline__ void warp_sort(uint16_t* s, int len, int lane) {
  if (len <= 32) {
    // in registers: lane l holds entry l, the lanes past len a key above
    // every entry; a bitonic network of shuffles
    int x = lane < len ? s[lane] : 0x10000 + lane;
#pragma unroll
    for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
      for (int j = k >> 1; j > 0; j >>= 1) {
        const int y = __shfl_xor_sync(kFullMask, x, j);
        x = ((lane & j) == 0) == ((lane & k) == 0) ? min(x, y) : max(x, y);
      }
    }
    if (lane < len) s[lane] = static_cast<uint16_t>(x);
    __syncwarp();
    return;
  }
  int n = 2;
  while (n < len) n <<= 1;
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = lane; p < n >> 1; p += 32) {
        const int i = (p & ~(j - 1)) << 1 | (p & (j - 1));  // bit j of i clear
        const int other = j == k >> 1 ? (i | (k - 1)) - (i & (k - 1)) : i + j;
        if (other < len) {
          const uint16_t a = s[i];
          const uint16_t c = s[other];
          if (c < a) {
            s[i] = c;
            s[other] = a;
          }
        }
      }
      __syncwarp();
    }
  }
}

// The counts listing (kCounts), SA1's gather backward: the sums of rows
// of c <= kListMaxWidth floats, unweighted. Grid (2^shift, b), `warps`
// warps a CTA, list_smem(window, per_cta) bytes of shared memory; CTA k
// owns targets k, k + 2^shift, ..., at most per_cta of them. The
// arguments are those of target_sum_kernel (w unused). Each window: every
// thread tests its share of the window's entries (16-byte loads,
// kListLoads in flight); an entry of one of the CTA's targets adds one to
// the target's count and is staged in its warp's region (a shared atomic
// on the warp's fill: the warps never contend). A block-wide scan of the
// counts gives the lists' starts, each staged entry takes the next place
// of its list, and each list is sorted ascending and summed: one thread
// up to kLaneSortMax entries, else a warp. kStop 1 or 2 ends each window
// after that phase (the staging, the lists), writing nothing; kStop 3
// runs whole and records the phases' clocks (stamp).
template <int kStop>
__global__ void __launch_bounds__(kSumMaxWarps * 32)
target_list_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                   const float* __restrict__ g, long long g_batch, long long g_row,
                   int targets, int entries, int c, int per_cta, int shift, int window,
                   bool load_vec, float* __restrict__ out) {
  extern __shared__ int4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  unsigned* stage = reinterpret_cast<unsigned*>(smem);  // a region a warp
  uint16_t* list = reinterpret_cast<uint16_t*>(smem + list_stage_bytes(window));
  int* sizes = reinterpret_cast<int*>(smem + list_stage_bytes(window) + sum_list_bytes(window));
  int* starts = sizes + per_cta;
  int* fill = starts + per_cta + 1;  // entries each warp staged
  int* wsum = fill + kSumMaxWarps;   // 32 warps' partial sums

  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int first_target = blockIdx.x;
  const int tile = min(per_cta, (targets - first_target + (1 << shift) - 1) >> shift);
  if (tile <= 0) return;  // the whole CTA: no target this far
  const unsigned apart = (1u << shift) - 1u;
  const int* ib = idx + static_cast<size_t>(b) * entries;
  const float* gb = g + b * g_batch;
  float* ob = out + static_cast<size_t>(b) * targets * c;
  // kStop == 3: thread 0 records the SM's clock at the phases' ends of the
  // first window (0 the start, 1 the zeroing, 2 the staging, 3 the scan and
  // placing, 4 the sorts and sums), and the global timer at its start and
  // end (5, 6), past the output's b * targets * c floats (rounded up to 8
  // bytes); a CTA has 8 slots, the last unused
  long long* stamps = reinterpret_cast<long long*>(
                          out + ((static_cast<size_t>(gridDim.y) * targets * c + 1) & ~size_t{1})) +
                      (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * 8;
  auto stamp = [&](int at) {
    if (kStop == 3 && threadIdx.x == 0) {
      stamps[at] = clock64();
      if (at == 0 || at == 4) {
        long long t;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
        stamps[5 + at / 4] = t;
      }
    }
  };
  stamp(0);

  for (int e0 = 0; e0 < entries; e0 += window) {
    const int len = min(window, entries - e0);
    const int units = load_vec ? len >> 2 : len;  // int4s or ints
    // a warp's region: the entries it reads, 32 units a round of the block
    const int region = (load_vec ? 128 : 32) * ((units + blockDim.x - 1) / blockDim.x);
    unsigned* mine = stage + warp * region;
    for (int i = threadIdx.x; i < tile; i += blockDim.x) sizes[i] = 0;
    if (threadIdx.x < warps) fill[threadIdx.x] = 0;
    __syncthreads();
    if (e0 == 0) stamp(1);

    // 1. each entry of the CTA's targets: one more in its target's count,
    // and staged as (entry << 16 | target) in the warp's region
    for (int u0 = threadIdx.x; u0 < units; u0 += kListLoads * blockDim.x) {
      int ent[kListLoads * 4];
#pragma unroll
      for (int k = 0; k < kListLoads; ++k) {
        const int q = u0 + k * blockDim.x;
        if (load_vec) {
          const int4 v = q < units ? reinterpret_cast<const int4*>(ib + e0)[q]
                                   : make_int4(0, 0, 0, 0);
          ent[4 * k] = v.x;
          ent[4 * k + 1] = v.y;
          ent[4 * k + 2] = v.z;
          ent[4 * k + 3] = v.w;
        } else {
          ent[4 * k] = q < units ? ib[e0 + q] : 0;
        }
      }
#pragma unroll
      for (int i = 0; i < kListLoads * 4; ++i) {
        if (!load_vec && (i & 3) != 0) continue;
        const int q = u0 + (i >> 2) * blockDim.x;
        const unsigned u = static_cast<unsigned>(ent[i]) - static_cast<unsigned>(first_target);
        const unsigned lt = u >> shift;
        if (q < units && (u & apart) == 0u && lt < static_cast<unsigned>(tile)) {
          const int e = load_vec ? 4 * q + (i & 3) : q;
          atomicAdd(&sizes[lt], 1);
          mine[atomicAdd(&fill[warp], 1)] = static_cast<unsigned>(e) << 16 | lt;
        }
      }
    }
    __syncthreads();
    if (e0 == 0) stamp(2);
    if (kStop == 1) continue;

    // 2. a block-wide scan of the counts into the lists' starts (each
    // thread a run of counts, then the warps' sums), the counts becoming
    // the lists' cursors; each staged entry to the next place of its
    // list; each list sorted ascending and summed, a short one by one
    // thread, a longer by a warp
    const int per = (tile + blockDim.x - 1) / blockDim.x;
    const int c0 = min(static_cast<int>(threadIdx.x) * per, tile);
    const int c1 = min(c0 + per, tile);
    int sum = 0;
    for (int k = c0; k < c1; ++k) sum += sizes[k];
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFullMask, incl, off);
      if (lane >= off) incl += t;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int v = lane < warps ? wsum[lane] : 0;
      int run = v;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(kFullMask, run, off);
        if (lane >= off) run += t;
      }
      if (lane < warps) wsum[lane] = run - v;
      if (lane == 31) starts[tile] = run;  // the end
    }
    __syncthreads();
    int run = wsum[warp] + incl - sum;
    for (int k = c0; k < c1; ++k) {
      const int m = sizes[k];
      starts[k] = run;
      sizes[k] = run;
      run += m;
    }
    __syncthreads();
    for (int i = lane; i < fill[warp]; i += 32) {  // the warp's own region
      const unsigned code = mine[i];
      list[atomicAdd(&sizes[code & 0xffffu], 1)] = static_cast<uint16_t>(code >> 16);
    }
    __syncthreads();
    if (e0 == 0) stamp(3);
    // a list longer than kLaneSortMax: sorted and summed by a warp
    for (int lt = warp; lt < tile; lt += warps) {
      const int n = starts[lt + 1] - starts[lt];
      if (n > kLaneSortMax) {
        warp_sort(list + starts[lt], n, lane);
        if (kStop != 2) {
          const size_t target = first_target + (static_cast<size_t>(lt) << shift);
          warp_sum_row(list + starts[lt], n, e0, gb, g_row, c, e0 == 0, ob + target * c, lane);
        }
      }
    }
    // a shorter one: a thread a target loads it into registers, sorts it
    // there (a network the size of the warp's longest such list) and sums
    // it from there
    for (int lt0 = threadIdx.x - lane; lt0 < tile; lt0 += blockDim.x) {
      const int lt = lt0 + lane;
      const int beg = lt < tile ? starts[lt] : 0;
      const int n = lt < tile ? starts[lt + 1] - beg : 0;
      const bool regs = n <= kLaneSortMax;
      int id[kLaneSortMax];
#pragma unroll
      for (int u = 0; u < kLaneSortMax; ++u) id[u] = regs && u < n ? list[beg + u] : 0x10000;
      const int most = __reduce_max_sync(kFullMask, regs ? n : 0);
      if (most > 8) {
        sort_regs<16>(id);
      } else if (most > 4) {
        sort_regs<8>(id);
      } else if (most > 1) {
        sort_regs<4>(id);
      }
      if (lt < tile && regs && kStop != 2) {
        sum_row([&](int u) { return id[u]; }, n, e0, gb, g_row, c, e0 == 0,
                ob + (first_target + (static_cast<size_t>(lt) << shift)) * c);
      }
    }
    __syncthreads();  // the next window rewrites the counts and the lists
    if (e0 == 0) stamp(4);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

using Kernel = void (*)(const int*, const float*, const float*, long long, long long, int,
                        int, int, int, int, int, bool, float*);

template <int kMode, int kStop>
Kernel pick(bool vec, int listing) {
  if (kMode == kGroup && listing == kCounts) return target_list_kernel<kStop>;
  return vec ? target_sum_kernel<kMode, float4, kStop> : target_sum_kernel<kMode, float, kStop>;
}

// CTAs a cloud, 2^shift: the fewest that give each at most per_cta
// targets (targets k, k + 2^shift, ...: consecutive targets on different
// CTAs, so that the low indices that short balls pad with spread out).
int cta_shift(int targets, int per_cta) {
  const int needed = (targets + per_cta - 1) / per_cta;
  int shift = 0;
  while ((1 << shift) < needed) ++shift;
  return shift;
}

template <int kMode, int kStop>
int launch(const int* idx, const float* w, const float* g, long long g_batch,
           long long g_row, float* out, int b, int targets, int entries, int c,
           int per_cta, int warps, int window, int listing, void* stream) {
  const bool counts = listing == kCounts;
  const size_t smem = counts ? list_smem(window, per_cta) : sum_smem(window, per_cta);
  if (idx == nullptr || g == nullptr || out == nullptr || (kMode == kThreeNN && !w) ||
      b < 1 || b > 65535 || targets < 1 || entries < 1 || c < 1 || per_cta < 1 ||
      per_cta > (counts ? kListMaxTargets : kSumMaxTargets) || warps < 1 ||
      warps > kSumMaxWarps || window < 4 || window > kSumMaxWindow || window % 4 != 0 ||
      g_batch < 0 || g_row < 0 || (listing != kBitmaps && !counts) ||
      (counts && (kMode != kGroup || c > kListMaxWidth)) ||
      smem > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = c % 4 == 0 && g_batch % 4 == 0 && g_row % 4 == 0 && aligned16(g) &&
                   aligned16(out);
  const bool load_vec = entries % 4 == 0 && aligned16(idx);
  const Kernel kernel = pick<kMode, kStop>(vec, listing);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int shift = cta_shift(targets, per_cta);
  kernel<<<dim3(1u << shift, b), warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      idx, w, g, g_batch, g_row, targets, entries, c, per_cta, shift, window, load_vec, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g: row i of cloud b at g + b * g_batch + i * g_row (c floats, adjacent);
// idx (b, n, 3) i32 and w (b, n, 3) f32, the sources and weights the
// forward saved -> d_feats (b, s, c) f32, every row written. At most
// `per_cta` targets and `warps` warps a CTA, entries in windows of
// `window`, lists from bitmaps (ops/cuda_scatter.py:scatter_plan).
extern "C" int p2c_three_nn_backward(const float* g, const int* idx, const float* w,
                                     float* d_feats, int b, int n, int s, int c,
                                     long long g_batch, long long g_row, int per_cta,
                                     int warps, int window, void* stream) {
  if (n < 1 || n > (1 << 29)) return static_cast<int>(cudaErrorInvalidValue);
  return launch<kThreeNN, 0>(idx, w, g, g_batch, g_row, d_feats, b, s, 3 * n, c, per_cta,
                             warps, window, kBitmaps, stream);
}

// idx (b, rows) i32; dg: row r of cloud b at dg + b * dg_batch + r *
// dg_row (w floats, adjacent) -> d_table (b, n, w) f32, every row written.
// Lists as `listing` says (enum Listing; kCounts takes w <= kListMaxWidth
// only, SA1).
extern "C" int p2c_sa_grouped_backward(const int* idx, const float* dg, float* d_table,
                                       int b, int rows, int n, int w, long long dg_batch,
                                       long long dg_row, int per_cta, int warps,
                                       int window, int listing, void* stream) {
  return launch<kGroup, 0>(idx, nullptr, dg, dg_batch, dg_row, d_table, b, n, rows, w,
                           per_cta, warps, window, listing, stream);
}

// For measurement only (kernel_sweep.py --split): the kernel of
// p2c_three_nn_backward (three_nn 1; w the weights, entries 3 n) or of
// p2c_sa_grouped_backward (three_nn 0, w null), ended after phase `stop`
// (1 the marks or staging, 2 the lists), `out` not written; or (stop 3,
// counts listing) run whole with each CTA's clocks of its first window
// (8 int64: the SM clock at the start, after the counts' zeroing, the
// staging, the scan and placing, and the sorts and sums; the global timer
// at the start and the end; one unused) past the output, whose buffer has
// room for them.
extern "C" int p2c_target_sum_probe(int three_nn, int stop, const int* idx, const float* w,
                                    const float* g, long long g_batch, long long g_row,
                                    float* out, int b, int targets, int entries, int c,
                                    int per_cta, int warps, int window, int listing,
                                    void* stream) {
  if (stop < 1 || stop > 3 || (stop == 3 && (listing != kCounts || three_nn))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using Launch = int (*)(const int*, const float*, const float*, long long, long long, float*,
                         int, int, int, int, int, int, int, int, void*);
  const Launch run = three_nn ? (stop == 1   ? launch<kThreeNN, 1>
                                 : stop == 2 ? launch<kThreeNN, 2>
                                             : launch<kThreeNN, 3>)
                              : (stop == 1   ? launch<kGroup, 1>
                                 : stop == 2 ? launch<kGroup, 2>
                                             : launch<kGroup, 3>);
  return run(idx, w, g, g_batch, g_row, out, b, targets, entries, c, per_cta, warps, window,
             listing, stream);
}
