// The device of a C entry's calling thread, shared by every library here.
//
// Each entry takes the card's index and makes it the calling thread's
// device before it launches or asks of a kernel. cudaSetDevice on a thread
// already on that device still costs a driver call, and an entry that set
// another device would leave the caller's thread on it, so every entry
// goes through use_device, which sets the device only where the thread is
// on another one (tests/test_torch_use_device.py holds the sources to
// that).

#pragma once

#include <cuda_runtime.h>

namespace {

// Sets the calling thread's device only where it is on another one.
inline cudaError_t use_device(int device) {
  int current = -1;
  const cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current == device) return cudaSuccess;
  return cudaSetDevice(device);
}

}  // namespace
