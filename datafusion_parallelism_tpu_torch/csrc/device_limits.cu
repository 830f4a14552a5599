// The device's properties that the wrappers plan launches by (K17's tile,
// K5's gather layout), read from the device rather than held as constants.

#include <cuda_runtime.h>

// out[0]: dynamic shared memory a block may opt into; [1]: shared memory of
// an SM; [2]: L2 bytes; [3]: SMs.
extern "C" int dfp_device_limits(int device, long long* out) {
  const cudaDeviceAttr attrs[4] = {cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                   cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                   cudaDevAttrL2CacheSize, cudaDevAttrMultiProcessorCount};
  for (int k = 0; k < 4; ++k) {
    int v = 0;
    const cudaError_t e = cudaDeviceGetAttribute(&v, attrs[k], device);
    if (e != cudaSuccess) return (int)e;
    out[k] = v;
  }
  return 0;
}
