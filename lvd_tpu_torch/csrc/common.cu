#include "common.cuh"

LVD_EXPORT const char* lvd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
