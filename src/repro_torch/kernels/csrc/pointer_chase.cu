// Hopper (sm_90a) pointer chase: the card's dependent-load latency, the
// yardstick of the BST kernels' latency bound.  Plain C interface, loaded
// with ctypes by repro_torch/kernels/_build.py; the entry point launches on
// the caller's stream and returns cudaGetLastError().
//
// It replaces no TPU kernel and no path of the port calls it: chip_smoke.py
// phase 5 times it.  One thread walks `steps` links of a cycle through
// `next` (p = next[p]), each load's address the value of the one before, by
// the same read-only path (__ldg) the descents take.  Its time over `steps`
// is one dependent round trip: to HBM for a cold buffer larger than the
// L2 cache (L_HBM), to L2 for a warm buffer of a few MiB (L_L2).  A BST
// lane's descent is such a chain, one round trip per global load on it, so
// round trips x L_HBM bound a kernel whose every lane must make them.

#include <cuda_runtime.h>

namespace {

__global__ void pointer_chase_kernel(const int* __restrict__ next, int start,
                                     int steps, int* __restrict__ out) {
  int p = start;
  for (int s = 0; s < steps; ++s) p = __ldg(next + p);
  out[0] = p;
}

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

}  // extern "C"
