// Hopper (sm_90a) kernel K4: queue-mapped buffer placement, the paper's
// labeling network (§II.C.3), for the MoE expert dispatch.  Plain C
// interface, loaded with ctypes by repro_torch/kernels/_build.py; the entry
// point launches on the caller's stream and returns cudaGetLastError().
//
// What it replaces: repro/kernels/queue_dispatch.py _queue_dispatch_kernel,
// reached through queue_dispatch_pallas.  Same function, per row of dest
// (B int32 lanes, a negative value marks an inactive lane, a value >= n_dest
// counts as n_dest - 1 as the Pallas kernel's clip makes it):
//   label[i]  = #{j < i : lane j active, dest[j] == dest[i]}   (FIFO order)
//   kept      = active & label < capacity
//   buffers[d, c] = the lane with destination d and label c, else -1
//   counts[d] = min(#{active lanes with destination d}, capacity)
//   overflow  = active & ~kept   (int32 0/1, as the Pallas kernel writes it)
// with a leading group axis G: one call serves every dispatch group of a MoE
// layer, one CTA per group row.
//
// It is not the TPU body.  The Pallas kernel builds a (B, n_dest) one-hot,
// takes its cumulative sum over the lanes and materialises a
// (B, n_dest * capacity) match matrix to scatter the buffer image, all in
// VMEM.  Here one CTA walks its row in tiles of 256 lanes.  In a tile each
// warp ranks its lanes among their same-destination peers with
// __match_any_sync and __popc(peers & lanemask_lt); the lowest lane of each
// peer group writes the warp's count for that destination to a
// (warps x n_dest) table in shared memory; one thread per destination turns
// its column into an exclusive scan over the warps, starting from the
// running count of that destination over the earlier tiles.  A lane's label
// is its warp's prefix plus its rank, so every label is that of the serial
// FIFO network: earlier lanes, earlier warps and earlier tiles come first
// (no atomics, whose order would not be FIFO).  A kept lane stores its index
// at buffers[d, label]; at the end each destination's slots past its count
// are filled with -1, so every buffer slot is written exactly once.
//
// What bounds it on this card: nothing the card is short of.  At the MoE
// prefill shape (G = 32 rows of B = 512 lanes, n_dest = 8, capacity = 80)
// it reads 64 KiB and writes 145 KiB, some 0.06 us of HBM time; the decode
// shape (G = 1, B = 8) is smaller still.  So its time is the launch and the
// four block-wide barriers per tile, not bytes or operations; the design
// keeps it to one launch per MoE layer for all groups, where the Pallas
// kernel's wrapper is vmapped per row.  The count table takes
// (8 warps + 1) x n_dest ints of shared memory, so n_dest is bounded by
// kMaxDest (36 KiB at 1024, inside the 48 KiB a launch gets without opting
// in); the wrapper raises above it.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kThreads = 256;                // threads per CTA = lanes per tile
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDest = 1024;               // (kWarps + 1) * kMaxDest ints of shared memory
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
queue_dispatch_kernel(const int* __restrict__ dest, int B, int n_dest, int capacity,
                      int* __restrict__ buffers, int* __restrict__ counts,
                      int* __restrict__ overflow) {
  extern __shared__ int smem[];
  int* warp_prefix = smem;              // [kWarps][n_dest]: counts, then exclusive prefixes
  int* seen = smem + kWarps * n_dest;   // [n_dest]: active lanes per destination so far

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const unsigned lanes_below = (1u << (tid & 31)) - 1u;
  const size_t row = blockIdx.x;
  const int* drow = dest + row * B;
  int* orow = overflow + row * B;
  int* brow = buffers + row * static_cast<size_t>(n_dest) * capacity;

  for (int d = tid; d < n_dest; d += kThreads) seen[d] = 0;
  __syncthreads();

  // The trip count is the same for every thread, so every lane of every
  // warp reaches each __match_any_sync and __syncthreads.
  for (int tile = 0; tile < B; tile += kThreads) {
    for (int j = tid; j < kWarps * n_dest; j += kThreads) warp_prefix[j] = 0;
    __syncthreads();

    const int i = tile + tid;
    const int raw = i < B ? drow[i] : -1;
    const bool active = raw >= 0;
    const int d = min(raw, n_dest - 1);  // the Pallas kernel's clip
    const unsigned peers = __match_any_sync(kFullMask, active ? d : -1);
    const int rank = __popc(peers & lanes_below);
    if (active && rank == 0) warp_prefix[warp * n_dest + d] = __popc(peers);
    __syncthreads();

    for (int dd = tid; dd < n_dest; dd += kThreads) {
      int run = seen[dd];
      for (int w = 0; w < kWarps; ++w) {
        const int c = warp_prefix[w * n_dest + dd];
        warp_prefix[w * n_dest + dd] = run;
        run += c;
      }
      seen[dd] = run;
    }
    __syncthreads();

    if (i < B) {
      int over = 0;
      if (active) {
        const int label = warp_prefix[warp * n_dest + d] + rank;
        if (label < capacity) {
          brow[static_cast<size_t>(d) * capacity + label] = i;
        } else {
          over = 1;
        }
      }
      orow[i] = over;
    }
    __syncthreads();  // the next tile clears warp_prefix; the tail reads seen
  }

  for (int d = tid; d < n_dest; d += kThreads) {
    counts[row * n_dest + d] = min(seen[d], capacity);
  }
  const int slots = n_dest * capacity;
  for (int s = tid; s < slots; s += kThreads) {
    const int d = s / capacity;
    if (s - d * capacity >= seen[d]) brow[s] = -1;  // a slot no lane took
  }
}

}  // namespace

extern "C" {

// The largest n_dest the kernel takes (its shared-memory count table).
int queue_dispatch_max_dest() { return kMaxDest; }

// dest: (G, B) int32, contiguous; buffers: (G, n_dest, capacity), counts:
// (G, n_dest), overflow: (G, B), all int32 and contiguous.  1 <= n_dest <=
// kMaxDest, capacity >= 1, n_dest * capacity <= INT_MAX.
int queue_dispatch(const void* dest, int G, int B, int n_dest, int capacity,
                   void* buffers, void* counts, void* overflow, void* stream) {
  if (G < 0 || B < 0 || n_dest < 1 || n_dest > kMaxDest || capacity < 1 ||
      static_cast<long long>(n_dest) * capacity > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (G == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(kWarps + 1) * n_dest * sizeof(int);
  queue_dispatch_kernel<<<G, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(dest), B, n_dest, capacity, static_cast<int*>(buffers),
      static_cast<int*>(counts), static_cast<int*>(overflow));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
