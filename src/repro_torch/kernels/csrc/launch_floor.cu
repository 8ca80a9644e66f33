// An empty kernel: timed beside a kernel in the same CUDA graph, its time
// is the floor a launch cannot go under (chip_smoke.py phases 4 and 7,
// `python -m repro_torch.launch.profile_paged`).
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// one launch of the empty kernel on `stream`; returns a cudaError_t
extern "C" int repro_launch_floor(void* stream) {
    empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
    return (int)cudaGetLastError();
}
