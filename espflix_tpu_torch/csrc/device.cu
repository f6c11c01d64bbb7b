// The kernel library's current device.
//
// The library links its own copy of the CUDA runtime, whose current
// device is its own: a kernel launches on that device and must be given
// one of its streams.  build.launch selects the device of the tensors it
// passes (cuda:1 under a mesh of several cards) before each launch.

#include <cuda_runtime.h>

extern "C" int esp_set_device(int device) {
  return (int)cudaSetDevice(device);
}
