// An empty kernel, launched `n` times back to back from one C loop: the
// card's floor per launch, against which a launch-bound kernel's time is
// read.  A measurement probe: no module of the port launches it.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int launch_floor_launch(int n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < n; ++i) empty_kernel<<<1, 32, 0, s>>>();
  return static_cast<int>(cudaGetLastError());
}
