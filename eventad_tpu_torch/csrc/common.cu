// Error text for the codes the kernel entry points return.
#include "common.cuh"

EVENTAD_API const char* eventad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
