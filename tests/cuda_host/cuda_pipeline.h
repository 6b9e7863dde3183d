// A host stand-in for CUDA's pipeline primitives (cp.async), for the host
// build of the port's kernels (tests/cuda_host_kernels.py): a copy is done
// at once, so commit and wait have nothing to do. A kernel that reads a
// buffer while its copy is still in flight on the card reads it finished
// here; a missing barrier still shows, as a race between threads.
#pragma once
#include <cstddef>
#include <cstring>

inline void __pipeline_memcpy_async(void* dst, const void* src, std::size_t size,
                                    std::size_t zfill = 0) {
  std::memcpy(dst, src, size - zfill);
  if (zfill) std::memset(static_cast<char*>(dst) + size - zfill, 0, zfill);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(std::size_t) {}
