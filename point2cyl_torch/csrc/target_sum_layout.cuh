// Shared-memory layout of the ordered per-target sums in target_sum.cu.
//
// The launch plan of ops/cuda_scatter.py (scatter_plan) sizes the same
// layout in Python; tests/test_torch_ops.py compiles this header with the
// host's C++ compiler and holds both sides to the same totals. Plain
// C++17 outside nvcc, so that the test needs no CUDA toolkit.

#pragma once

#include <cstddef>

#ifdef __CUDACC__
#define P2C_HD __host__ __device__
#else
#define P2C_HD
#endif

constexpr int kSumMaxTargets = 32;    // targets a CTA owns, at most
constexpr int kSumMaxWarps = 16;      // warps a CTA, at most
constexpr int kSumMaxWindow = 65536;  // entries a window: list entries are uint16

P2C_HD constexpr size_t sum_round16(size_t x) { return (x + 15) / 16 * 16; }

// A cloud's entries are taken in `windows` windows of sum_window entries
// each (the last may be shorter): a multiple of 4, so that every window
// starts on a 16-byte boundary of the index array.
P2C_HD constexpr int sum_window(int entries, int windows) {
  return ((entries + windows - 1) / windows + 3) / 4 * 4;
}

// A target's bitmap has a bit per entry of the window, word w = e / 32.
// Lane l of the warp that lists the target reads words [l << sh, (l + 1)
// << sh), the smallest power-of-two run with 32 runs covering the window,
// so the runs are in entry order across lanes; word w is stored at w + (w
// >> sh), a pad word after each run, so that the lanes' reads of one step
// fall on 32 banks.
P2C_HD constexpr int sum_bitmap_shift(int window) {
  int sh = 0;
  while ((32 << sh) < (window + 31) / 32) ++sh;
  return sh;
}

P2C_HD constexpr int sum_bitmap_words(int window) {
  return (window + 31) / 32 + ((window + 31) / 32 >> sum_bitmap_shift(window)) + 1;
}

// After a target's bitmap, a bit for each of its words that is not zero,
// so that the lists are read out of the words that hold entries only.
P2C_HD constexpr int sum_summary_words(int window) { return ((window + 31) / 32 + 31) / 32; }

// The regions, in order: each target's bitmap and its summary (uint32);
// the lists of entry ids (uint16), with room for every entry of the
// window in one target, the worst skew; each target's entry count and
// list start (and one more for the end), and the count of items taken
// (int32).
P2C_HD constexpr size_t sum_bitmaps_bytes(int window, int targets) {
  return sum_round16(4 * static_cast<size_t>(targets) *
                     (sum_bitmap_words(window) + sum_summary_words(window)));
}

P2C_HD constexpr size_t sum_list_bytes(int window) {
  return sum_round16(2 * static_cast<size_t>(window));
}

P2C_HD constexpr size_t sum_smem(int window, int targets) {
  return sum_bitmaps_bytes(window, targets) + sum_list_bytes(window) +
         sum_round16(4 * (2 * static_cast<size_t>(targets) + 2));
}
