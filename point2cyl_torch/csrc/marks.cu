// Phase markers: one empty kernel per phase of core/profiling.py's PHASES,
// in its order. A marker launched inside a step body is captured into the
// step's CUDA graph, so every replay shows in the profiler's device trace
// where each phase starts (the kernel's name is p2c_mark_<phase>).
#include <cuda_runtime.h>

extern "C" {
__global__ void p2c_mark_train_forward() {}
__global__ void p2c_mark_train_loss() {}
__global__ void p2c_mark_train_sketch() {}
__global__ void p2c_mark_train_igr() {}
__global__ void p2c_mark_train_backward() {}
__global__ void p2c_mark_train_update() {}
__global__ void p2c_mark_serve_backbone() {}
__global__ void p2c_mark_serve_decomposition() {}
__global__ void p2c_mark_serve_encoder() {}
__global__ void p2c_mark_serve_pack() {}
__global__ void p2c_mark_end() {}
}

namespace {

using Mark = void (*)();

const Mark kMarks[] = {
    p2c_mark_train_forward,
    p2c_mark_train_loss,
    p2c_mark_train_sketch,
    p2c_mark_train_igr,
    p2c_mark_train_backward,
    p2c_mark_train_update,
    p2c_mark_serve_backbone,
    p2c_mark_serve_decomposition,
    p2c_mark_serve_encoder,
    p2c_mark_serve_pack,
    p2c_mark_end,
};

constexpr int kPhases = sizeof(kMarks) / sizeof(kMarks[0]);

}  // namespace

// Launch phase `phase`'s marker, one thread, on `stream`.
extern "C" int p2c_mark(int phase, void* stream) {
  if (phase < 0 || phase >= kPhases) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t status =
      cudaLaunchKernel(reinterpret_cast<const void*>(kMarks[phase]), dim3(1), dim3(1),
                       nullptr, 0, static_cast<cudaStream_t>(stream));
  if (status != cudaSuccess) {
    return static_cast<int>(status);
  }
  return static_cast<int>(cudaGetLastError());
}
