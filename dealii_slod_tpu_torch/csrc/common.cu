// C-interface helpers shared by the kernel wrappers.
#include <cuda_runtime.h>

extern "C" const char* slod_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
