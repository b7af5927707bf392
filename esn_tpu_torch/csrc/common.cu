// Error reporting for the launch functions' return codes.
#include "common.cuh"

extern "C" const char* esn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
