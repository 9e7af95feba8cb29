// Error text for the status codes the kernel entry points return.

#include <cuda_runtime.h>

extern "C" const char* tgn_error_string(int status) {
    return cudaGetErrorString((cudaError_t)status);
}
