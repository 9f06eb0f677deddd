// Error text for the codes the kernel entry points return, so the Python
// wrappers can raise with the CUDA runtime's own message.
#include <cuda_runtime.h>

extern "C" const char* l2i_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
