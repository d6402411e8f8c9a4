// Shared-memory layouts of the ball-query kernels in ballquery.cu.
//
// The launch plans of ops/cuda_ballquery.py (ball_query_plan) size the
// same layouts in Python; tests/test_torch_ops.py compiles this header
// with the host's C++ compiler and holds both sides to the same totals.
// Plain C++17 outside nvcc, so that the test needs no CUDA toolkit.

#pragma once

#include <cstddef>

#ifdef __CUDACC__
#define P2C_HD __host__ __device__
#else
#define P2C_HD
#endif

constexpr int kMaxCells = 4096;    // cells of a row's grid, at most
constexpr int kGridHeader = 1024;  // bytes ahead of the grid kernel's planes
constexpr int kBallotMaxN = 1024;  // most points a row of the idx-only ballots: 32 steps
constexpr int kStreamStages = 3;   // row blocks a streamed CTA holds in flight
constexpr int kStreamChunks = 8;   // chunks of 128 points a streamed warp tests a block
constexpr int kStreamHeader = 64;  // bytes ahead of the streamed query's stages

// How the SA2 kernel writes a query's grouped block: 4 bytes a lane
// straight into `grouped`, or composed in shared memory and sent with one
// bulk copy.
enum Store { kScalar = 0, kBulk = 1 };

P2C_HD constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

P2C_HD constexpr size_t round16(size_t x) { return (x + 15) / 16 * 16; }

// Shared memory of the scan kernel: planes 3 * n4 floats, then ns int
// slots a warp.
P2C_HD constexpr size_t scan_smem(int n, int ns, int warps) {
  return 12 * static_cast<size_t>(round_up(n, 4)) + 4 * static_cast<size_t>(warps) * ns;
}

// Points of a block of the streamed query with `group` warps a query.
P2C_HD constexpr int stream_block(int group) { return 128 * kStreamChunks * group; }

// A stage of the streamed query: a block of `block` points (x y z each, in
// index order) copied from the 16-byte boundary at or below its first
// point, so up to 12 bytes ahead of it and a round-up to 16 bytes after.
P2C_HD constexpr size_t stream_stage_bytes(int block) {
  return 12 * static_cast<size_t>(block) + 16;
}

// Shared memory of the streamed query: a kStreamHeader-byte header (a
// barrier a stage), kStreamStages stages, an int count a warp for each of
// two blocks, then for each of the CTA's warps / group queries ns int
// slots and, where it gathers, ns centred points (3 floats each).
P2C_HD constexpr size_t stream_smem(int ns, int warps, int group, int gather) {
  return kStreamHeader + kStreamStages * stream_stage_bytes(stream_block(group)) +
         8 * static_cast<size_t>(warps) +
         static_cast<size_t>(warps / group) * ns * (gather ? 16 : 4);
}

// Shared memory of the idx-only ballot kernel: ns int slots a warp.
P2C_HD constexpr size_t ballot_smem(int ns, int warps) {
  return 4 * static_cast<size_t>(warps) * ns;
}

// Shared memory of the SA2 kernel: planes 3 * n4 floats, ns int slots a
// warp, a warp's query centre (16 bytes a warp), and for kBulk two blocks
// of ns * (3 + c) floats.
P2C_HD constexpr size_t sa_smem(int n, int ns, int c, int warps, int store) {
  return 12 * static_cast<size_t>(round_up(n, 4)) +
         round16(4 * static_cast<size_t>(warps) * ns) + 16 * static_cast<size_t>(warps) +
         (store == kBulk ? 8 * static_cast<size_t>(ns) * (3 + c) : 0);
}

// A warp's bitmap in the grid kernel has a bit per point, word w = j / 32.
// Lane l reads out words [l << sh, (l + 1) << sh), the smallest
// power-of-two run with 32 runs covering the row, so the runs are in index
// order across lanes; word w is stored at w + (w >> sh), a pad word after
// each run, so that the lanes' reads of one step fall on 32 banks.
P2C_HD constexpr int bitmap_shift(int n) {
  int sh = 0;
  while ((32 << sh) < (n + 31) / 32) ++sh;
  return sh;
}

P2C_HD constexpr int bitmap_words(int n) {
  return (n + 31) / 32 + ((n + 31) / 32 >> bitmap_shift(n)) + 1;
}

// The grid kernel's region after the planes: each point's (cell, rank)
// code while the grid is built, each warp's bitmap and ns int slots
// afterwards.
P2C_HD constexpr size_t grid_region(int n, int ns, int warps) {
  const size_t plane = 4 * static_cast<size_t>(round_up(n, 4));
  const size_t warp_bytes = 4 * static_cast<size_t>(warps) * (bitmap_words(n) + ns);
  return round16(plane > warp_bytes ? plane : warp_bytes);
}

// Shared memory of the grid kernel: a kGridHeader-byte header (box and
// scan scratch, the grid's shape); the x, y and z planes of n4 floats in
// index order; grid_region; kMaxCells + 4 cell offsets; the cell-sorted
// point indices (n4 uint16).
P2C_HD constexpr size_t grid_smem(int n, int ns, int warps) {
  return kGridHeader + 14 * static_cast<size_t>(round_up(n, 4)) + grid_region(n, ns, warps) +
         4 * (kMaxCells + 4);
}
