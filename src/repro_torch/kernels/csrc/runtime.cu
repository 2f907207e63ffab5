// Error reporting for the Python wrappers: every launcher returns the
// cudaError_t of cudaGetLastError() right after its launch, and the wrapper
// turns a non-zero code into an exception with this text.
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
