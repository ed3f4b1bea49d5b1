// Hopper (sm_90a) yardsticks of the kernels' bounds: a pointer chase, the
// card's dependent-load latency, and an empty kernel, the least a launch
// through this library costs.  Plain C interface, loaded with ctypes by
// repro_torch/kernels/_build.py; the entry points launch on the caller's
// stream and return cudaGetLastError().
//
// They replace no TPU kernel and no path of the port calls them:
// chip_smoke.py times them (phases 5 and 7).  In the chase one thread walks
// `steps` links of a cycle through `next` (p = next[p]), each load's
// address the value of the one before, by the same read-only path (__ldg)
// the descents take.  Its time over `steps`
// is one dependent round trip: to HBM for a cold buffer larger than the
// L2 cache (L_HBM), to L2 for a warm buffer of a few MiB (L_L2).  A BST
// lane's descent is such a chain, one round trip per global load on it, so
// round trips x L_HBM bound a kernel whose every lane must make them.  The
// empty kernel, launched with a kernel's own grid, threads and dynamic
// shared memory, is that kernel's floor: what no body can take away.

#include <cuda_runtime.h>

namespace {

__global__ void pointer_chase_kernel(const int* __restrict__ next, int start,
                                     int steps, int* __restrict__ out) {
  int p = start;
  for (int s = 0; s < steps; ++s) p = __ldg(next + p);
  out[0] = p;
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// next: (N,) int32, a permutation whose cycle holds `start`; out: (1,) int32
// receives where the walk ended.  One CTA of one thread.
int pointer_chase(const void* next, int start, int steps, void* out, void* stream) {
  if (steps < 0 || start < 0) return static_cast<int>(cudaErrorInvalidValue);
  pointer_chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(next), start, steps, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel of `grid` CTAs of `threads` threads with `smem_bytes` of
// dynamic shared memory (at most 48 KiB), in clusters of `cluster` CTAs
// (1: no cluster).
int empty_launch(int grid, int threads, int smem_bytes, int cluster, void* stream) {
  if (grid < 1 || threads < 1 || threads > 1024 || smem_bytes < 0 || smem_bytes > 48 * 1024 ||
      cluster < 1 || cluster > 8 || grid % cluster != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchAttribute dims = {};
  dims.id = cudaLaunchAttributeClusterDimension;
  dims.val.clusterDim.x = cluster;
  dims.val.clusterDim.y = 1;
  dims.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(grid);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem_bytes;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = &dims;
  config.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t rc = cudaLaunchKernelEx(&config, empty_kernel);
  return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
}

}  // extern "C"
