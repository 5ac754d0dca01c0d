// The message for a CUDA error code, for the Python wrappers' exceptions.
#include "common.cuh"

INFODIFF_EXPORT const char* infodiff_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
