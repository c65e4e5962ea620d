// The launch a kernel library's C entry point makes, and the queries beside it.
//
// Each library computes the launch of a call (grid, threads per block,
// dynamic shared bytes, cluster size) through one function per kernel
// instantiation, which both its launcher and its `<name>_launch_config`
// query call, so the query cannot drift from the launch. Its
// `<name>_attributes` query returns cudaFuncGetAttributes of the kernel the
// same call would launch and the blocks of it an SM holds at that launch
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), after the launcher's own
// cudaFuncAttributeMaxDynamicSharedMemorySize setting. The static analysis
// (ddim_cold_torch/analysis/kernel_checks.py) holds its own prediction of
// the launch against the first and its shared-memory and register limits
// against the second, on the card.

#pragma once

#include <cuda_runtime.h>

namespace lq {

struct Launch {
  int gx, gy, gz;   // grid
  int threads;      // threads per block
  size_t smem;      // dynamic shared bytes
  int cluster;      // blocks per thread-block cluster (1: none)
};

// out[0..5] = grid x, y, z, threads, dynamic shared bytes, cluster
inline void put(const Launch& l, long long* out) {
  out[0] = l.gx;
  out[1] = l.gy;
  out[2] = l.gz;
  out[3] = l.threads;
  out[4] = static_cast<long long>(l.smem);
  out[5] = l.cluster;
}

// out[0..5] = sharedSizeBytes (static), maxDynamicSharedSizeBytes, numRegs,
// localSizeBytes (spills), maxThreadsPerBlock, and the blocks of `fn` one SM
// holds at launch `l`
inline cudaError_t attributes(const void* fn, const Launch& l, long long* out) {
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(l.smem));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, l.threads, l.smem);
  if (err != cudaSuccess) return err;
  out[0] = static_cast<long long>(a.sharedSizeBytes);
  out[1] = a.maxDynamicSharedSizeBytes;
  out[2] = a.numRegs;
  out[3] = static_cast<long long>(a.localSizeBytes);
  out[4] = a.maxThreadsPerBlock;
  out[5] = blocks;
  return cudaSuccess;
}

}  // namespace lq
