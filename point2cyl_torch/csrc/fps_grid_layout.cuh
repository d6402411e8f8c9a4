// Launch limits and layouts of the FPS kernels above fps.cu's 16,384
// points: fps_cluster.cu (one thread-block cluster a cloud) and fps_grid.cu
// (several CTAs a cloud meeting in global memory).
//
// The launch plan of ops/cuda_fps.py (fps_grid_plan) sizes the same
// launches in Python; tests/test_torch_large_n.py compiles this header with
// the host's C++ compiler and holds both sides to the same values.
// Plain C++17 outside nvcc, so that the test needs no CUDA toolkit.

#pragma once

#ifdef __CUDACC__
#define P2C_FPS_HD __host__ __device__
#else
#define P2C_FPS_HD
#endif

constexpr int kGridMaxThreads = 1024;  // threads a CTA, at most
constexpr int kGridPPT = 8;            // points a thread holds in registers
constexpr int kGridRegs = 64;          // registers a thread, at most (__launch_bounds__)
constexpr int kSmRegs = 65536;         // registers an SM holds
constexpr int kGridMeetWords = 32;     // int64 words of a cloud's meeting place (grid route)
constexpr int kClusterMaxCtas = 16;    // CTAs a cluster, at most (16 is non-portable)
constexpr int kRecordBytes = 20;       // a record's payload: distance bits, ~index, x, y, z
constexpr int kRecordStride = 32;      // bytes between records in shared memory

// Points one cluster holds in registers: the cluster route's largest cloud.
constexpr long long kClusterCapacity =
    static_cast<long long>(kClusterMaxCtas) * kGridMaxThreads * kGridPPT;

// CTAs of `threads` threads one SM holds at once, by registers (the
// kernels' shared memory is a few KB).
P2C_FPS_HD constexpr int grid_blocks_per_sm(int threads) {
  return kSmRegs / (kGridRegs * threads);
}

// Points of a cloud beyond the registers of `ctas` CTAs of `threads`
// threads holding kGridPPT points each: read from global memory every step.
P2C_FPS_HD constexpr long long grid_streamed(long long n, int ctas, int threads) {
  const long long held = static_cast<long long>(ctas) * threads * kGridPPT;
  return n > held ? n - held : 0;
}
