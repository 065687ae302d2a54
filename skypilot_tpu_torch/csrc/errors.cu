// Error text for the status codes the kernels' entry points return.
#include "common.cuh"

extern "C" const char* skk_error_string(int code) {
  if (code == skk::kErrUnsupported) return "unsupported dtype or shape";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
