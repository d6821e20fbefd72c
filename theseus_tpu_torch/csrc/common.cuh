// Shared definitions for the theseus_tpu_torch CUDA kernels.
//
// Every kernel is a template over the floating type (float, double) and is
// exposed through a plain C entry point per type (suffix _f32 / _f64) that
// launches on the stream it is given and returns cudaGetLastError().
#pragma once

#include <cuda_runtime.h>

#define TH_EXPORT extern "C" __attribute__((visibility("default")))

// Threads per block for the one-thread-per-item kernels.
constexpr int TH_BLOCK = 128;

inline unsigned th_blocks(long long n) {
  return static_cast<unsigned>((n + TH_BLOCK - 1) / TH_BLOCK);
}
