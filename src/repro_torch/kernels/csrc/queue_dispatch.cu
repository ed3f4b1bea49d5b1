// Hopper (sm_90a) kernel K4: queue-mapped buffer placement, the paper's
// labeling network (§II.C.3), for the MoE expert dispatch.  Plain C
// interface, loaded with ctypes by repro_torch/kernels/_build.py; the entry
// point launches on the caller's stream and returns cudaGetLastError().
//
// What it replaces: repro/kernels/queue_dispatch.py _queue_dispatch_kernel,
// reached through queue_dispatch_pallas, and the torch ops around it that
// make the JAX package's DispatchPlan (repro/core/buffers.py
// queue_dispatch).  Per row of dest (B int32 lanes, a negative value marks
// an inactive lane, a value >= n_dest counts as n_dest - 1 as the Pallas
// kernel's clip makes it):
//   label[i]  = #{j < i : lane j active, dest[j] == dest[i]}   (FIFO order)
//   kept      = active & label < capacity                       (bool)
//   slot      = kept ? label : -1                               (int32)
//   buffers[d, c] = the lane with destination d and label c, else -1
//   counts[d] = min(#{active lanes with destination d}, capacity)
//   overflow  = active & ~kept                                  (bool)
// with a leading group axis G: one launch serves every dispatch group of a
// MoE layer and writes the whole plan, so a queue dispatch is this one
// kernel and nothing else.
//
// It is not the TPU body.  The Pallas kernel builds a (B, n_dest) one-hot,
// takes its cumulative sum over the lanes and materialises a
// (B, n_dest * capacity) match matrix to scatter the buffer image, all in
// VMEM.  Here, for n_dest <= 32 (every MoE config of the repo), a CTA of
// whole warps, sized from its lanes up to kMaxThreads, loads them into
// registers before its first barrier: lane r * threads + tid in register
// r, up to kMaxRegs a thread, so every lane makes one dependent HBM round
// trip.  For each register a warp ranks its lanes among their
// same-destination peers by ballots over the bits of the destination
// (peers = the lanes that agree on every bit), and lane d of the warp
// counts destination d the same way; the counts go to an (n_dest x
// registers * warps) table in shared memory.  After one barrier a group of
// lanes per destination (as many as the table has positions, up to a
// warp) turns its column into an exclusive scan with warp shuffles; after
// a second barrier each lane reads its label from the table and stores
// its outputs.  A row of up to kMaxThreads lanes takes one CTA
// (queue_dispatch_kernel: the MoE prefill's 32 rows of 512, the decode
// row of 8); a longer one a cluster of up to kMaxCluster CTAs
// (queue_dispatch_cluster_kernel), one chunk of the row each, which read
// the earlier chunks' per-destination totals from their distributed
// shared memory, so the stores of a long row are spread over that many
// SMs.  Rows past a cluster's one pass are walked by one CTA in passes.
// Labels are those of the serial FIFO network: earlier lanes of a warp,
// then earlier warps, then earlier registers, then earlier chunks or
// passes come first (no atomics, whose order would not be FIFO).  Each
// buffer slot is written once: by its lane, or as -1 by its destination's
// lanes, which know the count.  Above 32 destinations
// (queue_dispatch_wide_kernel, up to kMaxDest) a CTA of 256 threads walks
// the row in tiles with __match_any_sync ranks and a (warps x n_dest)
// table in shared memory, four barriers a tile.
//
// What bounds it on this card: nothing the card is short of.  At the MoE
// prefill shape (G = 32 rows of B = 512 lanes, n_dest = 8, capacity = 80)
// it reads 64 KiB and writes 272 KiB, some 0.1 us of HBM time, and each
// lane makes one dependent round trip (about 0.34 us); the decode shape
// (G = 1, B = 8) is smaller still.  So its time is the launch, one round
// trip, two barriers and the stores; the design keeps it to one launch per
// MoE layer for all groups, where the Pallas kernel's wrapper is vmapped
// per row and the JAX package's plan adds a dozen ops around it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;   // threads of a narrow CTA at most (lanes of one chunk)
constexpr int kMaxRegs = 8;        // lanes a thread holds per pass
constexpr int kMaxCluster = 8;     // CTAs of a long row (the portable cluster size)
constexpr int kNarrowDest = 32;    // the narrow bodies: one warp lane per destination
constexpr int kMaxDest = 1024;     // the wide body's (kWideWarps + 1) x n_dest table
constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

struct Row {  // one dispatch group's inputs and outputs
  const int* dest;
  int* slot;
  uint8_t* kept;
  int* buffers;
  int* counts;
  uint8_t* overflow;
};

__device__ __forceinline__ Row row_of(size_t g, const int* dest, int B, int n_dest, int capacity,
                                      int* slot, uint8_t* kept, int* buffers, int* counts,
                                      uint8_t* overflow) {
  return {dest + g * B, slot + g * B, kept + g * B,
          buffers + g * static_cast<size_t>(n_dest) * capacity, counts + g * n_dest,
          overflow + g * B};
}

// The narrow bodies' geometry, the same on host and device.  A row takes
// `cluster_size` CTAs of `chunk_of` lanes each, in CTAs of
// `narrow_threads(lanes)` (whole warps, one lane each up to kMaxThreads);
// the table's column stride is odd, so that the lanes of a warp that
// write or read one position of n_dest columns hit distinct banks.
__host__ __device__ __forceinline__ int cluster_size(int B) {
  const int ctas = (B + kMaxThreads - 1) / kMaxThreads;
  return ctas < 1 ? 1 : (ctas < kMaxCluster ? ctas : kMaxCluster);
}

__host__ __device__ __forceinline__ int chunk_of(int B) {
  const int c = cluster_size(B);
  return (B + c - 1) / c;
}

__host__ __device__ __forceinline__ int narrow_threads(int lanes) {
  const int warps = (lanes + 31) / 32;
  return warps < 1 ? 32 : (warps * 32 < kMaxThreads ? warps * 32 : kMaxThreads);
}

__host__ __device__ __forceinline__ int pass_regs(int lanes, int threads) {
  const int regs = lanes > 0 ? (lanes + threads - 1) / threads : 0;
  return regs < kMaxRegs ? regs : kMaxRegs;
}

__host__ __device__ __forceinline__ int table_stride(int lanes, int threads) {
  return (pass_regs(lanes, threads) * (threads / 32)) | 1;
}

// Ints of shared memory before the table: per destination, the running
// totals (in a cluster also the earlier chunks' totals and the kept count).
constexpr int kHeadInts = 3 * kNarrowDest;

__host__ __device__ __forceinline__ size_t narrow_smem_bytes(int lanes, int n_dest) {
  return (kHeadInts + static_cast<size_t>(n_dest) * table_stride(lanes, narrow_threads(lanes))) *
         sizeof(int);
}

// Which body a (B, n_dest) row takes: 0 one narrow CTA, 1 a cluster, 2 wide.
__host__ __forceinline__ int body_of(int B, int n_dest) {
  if (n_dest > kNarrowDest) return 2;
  return B > kMaxThreads && chunk_of(B) <= kMaxThreads * kMaxRegs ? 1 : 0;
}

// One pass of a narrow CTA over the `n` lanes of its row from `lo`: the
// loads (before any barrier), the warp ranks, and the per-warp counts into
// `table`.  Returns the registers in use, the same for every thread.
__device__ __forceinline__ int rank_lanes(const int* drow, int lo, int n, int n_dest, int stride,
                                          int* table, int (&d)[kMaxRegs], int (&rank)[kMaxRegs]) {
  const int threads = blockDim.x;
  const int warps = threads >> 5;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int regs = pass_regs(n, threads);
  const int bits = n_dest > 1 ? 32 - __clz(n_dest - 1) : 0;
#pragma unroll
  for (int r = 0; r < kMaxRegs; ++r) {
    const int i = r * threads + tid;
    d[r] = r < regs && i < n ? __ldg(drow + lo + i) : -1;
  }
  // Every loop bound here is the same for all threads of the CTA, so every
  // lane reaches each ballot.
#pragma unroll
  for (int r = 0; r < kMaxRegs; ++r) {
    if (r >= regs) break;
    const bool active = d[r] >= 0;
    d[r] = active ? min(d[r], n_dest - 1) : -1;  // the Pallas kernel's clip
    unsigned peers = __ballot_sync(kFullMask, active);
    unsigned own = peers;  // the active lanes whose destination is `lane`
#pragma unroll
    for (int b = 0; b < 5; ++b) {  // n_dest <= 32: at most 5 bits
      if (b >= bits) break;
      const unsigned ones = __ballot_sync(kFullMask, (d[r] >> b) & 1);
      peers &= (d[r] >> b) & 1 ? ones : ~ones;
      own &= (lane >> b) & 1 ? ones : ~ones;
    }
    rank[r] = __popc(peers & ((1u << lane) - 1u));
    if (lane < n_dest) table[lane * stride + r * warps + warp] = __popc(own);
  }
  return regs;
}

// Lanes per destination group: the table's positions rounded up to a
// power of two, at most a warp.
__device__ __forceinline__ int group_width(int positions) {
  int width = 1;
  while (width < positions && width < 32) width <<= 1;
  return width;
}

// A destination's group of `width` lanes (this lane the j-th) scans its
// `column` of `positions` counts into exclusive prefixes from `run`, and
// returns `run` plus the column's total to every lane of the group.  A
// lane without a destination (`owner` false) takes part in the shuffles
// only.
__device__ __forceinline__ int scan_column(int* column, int positions, bool owner, int j,
                                           int width, int run) {
  for (int p0 = 0; p0 < positions; p0 += width) {
    const int p = p0 + j;
    const int c = owner && p < positions ? column[p] : 0;
    int incl = c;
    for (int o = 1; o < width; o <<= 1) {
      const int t = __shfl_up_sync(kFullMask, incl, o, width);
      if (j >= o) incl += t;
    }
    if (owner && p < positions) column[p] = run + incl - c;
    run += __shfl_sync(kFullMask, incl, width - 1, width);
  }
  return run;
}

// Each lane's label (its warp's prefix in the table, its rank and, in a
// cluster, `before` for its destination: the earlier chunks' lanes), and
// its outputs.
__device__ __forceinline__ void place_lanes(const Row& row, int lo, int n, int regs, int capacity,
                                            const int* table, int stride, const int* before,
                                            const int (&d)[kMaxRegs], const int (&rank)[kMaxRegs]) {
  const int threads = blockDim.x;
  const int warps = threads >> 5;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
#pragma unroll
  for (int r = 0; r < kMaxRegs; ++r) {
    if (r >= regs) break;
    const int i = r * threads + tid;
    if (i >= n) break;
    const int at = lo + i;
    const bool active = d[r] >= 0;
    const int label =
        active ? (before ? before[d[r]] : 0) + table[d[r] * stride + r * warps + warp] + rank[r]
               : 0;
    const bool keep = active && label < capacity;
    row.slot[at] = keep ? label : -1;
    row.kept[at] = keep;
    row.overflow[at] = active && !keep;
    if (keep) row.buffers[static_cast<size_t>(d[r]) * capacity + label] = at;
  }
}

// A row of up to kMaxThreads lanes, or one too long for a cluster's one
// pass: one CTA, in passes of threads * kMaxRegs lanes.
__global__ void __launch_bounds__(kMaxThreads)
queue_dispatch_kernel(const int* __restrict__ dest, int B, int n_dest, int capacity,
                      int* __restrict__ slot, uint8_t* __restrict__ kept,
                      int* __restrict__ buffers, int* __restrict__ counts,
                      uint8_t* __restrict__ overflow) {
  extern __shared__ int smem[];
  int* seen = smem;                // [n_dest]: active lanes per destination over earlier passes
  int* table = smem + kHeadInts;   // [n_dest][stride]: counts, then exclusive prefixes
  const Row row = row_of(blockIdx.x, dest, B, n_dest, capacity, slot, kept, buffers, counts,
                         overflow);
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int stride = table_stride(B, blockDim.x);
  const int per_pass = blockDim.x * kMaxRegs;

  for (int base = 0;; base += per_pass) {
    const bool last = B - base <= per_pass;
    const int n = last ? B - base : per_pass;
    int d[kMaxRegs], rank[kMaxRegs];
    const int regs = rank_lanes(row.dest, base, n, n_dest, stride, table, d, rank);
    __syncthreads();

    const int positions = regs * warps;
    const int width = group_width(positions);
    const int j = lane & (width - 1);
    for (int d0 = warp * (32 / width); d0 < n_dest; d0 += warps * (32 / width)) {
      const int dd = d0 + lane / width;
      const bool owner = dd < n_dest;
      const int run = scan_column(table + dd * stride, positions, owner, j, width,
                                  owner && base > 0 ? seen[dd] : 0);
      if (!owner) continue;
      if (!last) {
        if (j == 0) seen[dd] = run;
        continue;
      }
      const int n_kept = min(run, capacity);
      if (j == 0) row.counts[dd] = n_kept;
      int* buf = row.buffers + static_cast<size_t>(dd) * capacity;
      for (int c = n_kept + j; c < capacity; c += width) buf[c] = -1;  // a slot no lane took
    }
    __syncthreads();

    place_lanes(row, base, n, regs, capacity, table, stride, nullptr, d, rank);
    if (last) break;
    __syncthreads();  // the next pass rewrites the table
  }
}

// A row of more than kMaxThreads lanes, one pass of each CTA of a cluster
// (cluster_size(B) CTAs of chunk_of(B) lanes).  After its scan each CTA
// holds its chunk's totals per destination; after a cluster barrier each
// reads the earlier chunks' totals (its offsets) and all of them (the
// counts) from the others' shared memory, CTA d % cluster writes
// destination d's count and -1s, and a last cluster barrier keeps every
// CTA's shared memory alive until the others have read it.
__global__ void __launch_bounds__(kMaxThreads)
queue_dispatch_cluster_kernel(const int* __restrict__ dest, int B, int n_dest, int capacity,
                              int* __restrict__ slot, uint8_t* __restrict__ kept,
                              int* __restrict__ buffers, int* __restrict__ counts,
                              uint8_t* __restrict__ overflow) {
  extern __shared__ int smem[];
  int* totals = smem;                    // [n_dest]: this chunk's active lanes per destination
  int* before = smem + kNarrowDest;      // [n_dest]: the earlier chunks' active lanes
  int* n_kept = smem + 2 * kNarrowDest;  // [n_dest]: the row's kept lanes
  int* table = smem + kHeadInts;         // [n_dest][stride]: counts, then exclusive prefixes
  cg::cluster_group cluster = cg::this_cluster();
  const int ctas = static_cast<int>(cluster.num_blocks());
  const int part = static_cast<int>(cluster.block_rank());
  const Row row = row_of(blockIdx.x / ctas, dest, B, n_dest, capacity, slot, kept, buffers,
                         counts, overflow);
  const int warps = blockDim.x >> 5;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int chunk = chunk_of(B);
  const int lo = part * chunk;
  const int n = max(0, min(B - lo, chunk));
  const int stride = table_stride(chunk, blockDim.x);

  int d[kMaxRegs], rank[kMaxRegs];
  const int regs = rank_lanes(row.dest, lo, n, n_dest, stride, table, d, rank);
  __syncthreads();

  const int positions = regs * warps;
  const int width = group_width(positions);
  const int j = lane & (width - 1);
  for (int d0 = warp * (32 / width); d0 < n_dest; d0 += warps * (32 / width)) {
    const int dd = d0 + lane / width;
    const bool owner = dd < n_dest;
    const int run = scan_column(table + dd * stride, positions, owner, j, width, 0);
    if (owner && j == 0) totals[dd] = run;
  }
  cluster.sync();

  for (int dd = tid; dd < n_dest; dd += blockDim.x) {
    int earlier = 0, total = 0;
    for (int k = 0; k < ctas; ++k) {
      const int t = cluster.map_shared_rank(totals, k)[dd];
      earlier += k < part ? t : 0;
      total += t;
    }
    before[dd] = earlier;
    n_kept[dd] = min(total, capacity);
    if (dd % ctas == part) row.counts[dd] = n_kept[dd];
  }
  __syncthreads();

  for (int dd = part; dd < n_dest; dd += ctas) {
    int* buf = row.buffers + static_cast<size_t>(dd) * capacity;
    for (int c = n_kept[dd] + tid; c < capacity; c += blockDim.x) buf[c] = -1;  // no lane took it
  }
  place_lanes(row, lo, n, regs, capacity, table, stride, before, d, rank);
  cluster.sync();
}

__global__ void __launch_bounds__(kWideThreads)
queue_dispatch_wide_kernel(const int* __restrict__ dest, int B, int n_dest, int capacity,
                           int* __restrict__ slot, uint8_t* __restrict__ kept,
                           int* __restrict__ buffers, int* __restrict__ counts,
                           uint8_t* __restrict__ overflow) {
  extern __shared__ int smem[];
  int* warp_prefix = smem;                  // [kWideWarps][n_dest]: counts, then prefixes
  int* seen = smem + kWideWarps * n_dest;   // [n_dest]: active lanes per destination so far

  const Row row = row_of(blockIdx.x, dest, B, n_dest, capacity, slot, kept, buffers, counts,
                         overflow);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const unsigned lanes_below = (1u << (tid & 31)) - 1u;

  for (int d = tid; d < n_dest; d += kWideThreads) seen[d] = 0;
  __syncthreads();

  for (int tile = 0; tile < B; tile += kWideThreads) {
    for (int j = tid; j < kWideWarps * n_dest; j += kWideThreads) warp_prefix[j] = 0;
    __syncthreads();

    const int i = tile + tid;
    const int raw = i < B ? __ldg(row.dest + i) : -1;
    const bool active = raw >= 0;
    const int d = min(raw, n_dest - 1);  // the Pallas kernel's clip
    const unsigned peers = __match_any_sync(kFullMask, active ? d : -1);
    const int rank = __popc(peers & lanes_below);
    if (active && rank == 0) warp_prefix[warp * n_dest + d] = __popc(peers);
    __syncthreads();

    for (int dd = tid; dd < n_dest; dd += kWideThreads) {
      int run = seen[dd];
      for (int w = 0; w < kWideWarps; ++w) {
        const int c = warp_prefix[w * n_dest + dd];
        warp_prefix[w * n_dest + dd] = run;
        run += c;
      }
      seen[dd] = run;
    }
    __syncthreads();

    if (i < B) {
      const int label = active ? warp_prefix[warp * n_dest + d] + rank : 0;
      const bool keep = active && label < capacity;
      row.slot[i] = keep ? label : -1;
      row.kept[i] = keep;
      row.overflow[i] = active && !keep;
      if (keep) row.buffers[static_cast<size_t>(d) * capacity + label] = i;
    }
    __syncthreads();  // the next tile clears warp_prefix; the tail reads seen
  }

  for (int d = tid; d < n_dest; d += kWideThreads) row.counts[d] = min(seen[d], capacity);
  const int slots = n_dest * capacity;
  for (int s = tid; s < slots; s += kWideThreads) {
    const int d = s / capacity;
    if (s - d * capacity >= seen[d]) row.buffers[s] = -1;  // a slot no lane took
  }
}

}  // namespace

extern "C" {

// The largest n_dest the kernel takes (the wide body's count table).
int queue_dispatch_max_dest() { return kMaxDest; }

// The launch for rows of B lanes: CTAs per row, threads per CTA and
// dynamic shared memory in bytes (chip_smoke.py times an empty kernel of
// the same launch).
int queue_dispatch_ctas(int B, int n_dest) {
  return body_of(B, n_dest) == 1 ? cluster_size(B) : 1;
}

int queue_dispatch_threads(int B, int n_dest) {
  switch (body_of(B, n_dest)) {
    case 0: return narrow_threads(B);
    case 1: return narrow_threads(chunk_of(B));
    default: return kWideThreads;
  }
}

int queue_dispatch_smem_bytes(int B, int n_dest) {
  switch (body_of(B, n_dest)) {
    case 0: return static_cast<int>(narrow_smem_bytes(B, n_dest));
    case 1: return static_cast<int>(narrow_smem_bytes(chunk_of(B), n_dest));
    default: return static_cast<int>((kWideWarps + 1) * n_dest * sizeof(int));
  }
}

// dest: (G, B) int32; slot: (G, B) int32; kept: (G, B) bool; buffers:
// (G, n_dest, capacity) int32; counts: (G, n_dest) int32; overflow: (G, B)
// bool; all contiguous.  1 <= n_dest <= kMaxDest, capacity >= 1,
// n_dest * capacity <= INT_MAX.
int queue_dispatch(const void* dest, int G, int B, int n_dest, int capacity, void* slot,
                   void* kept, void* buffers, void* counts, void* overflow, void* stream) {
  if (G < 0 || B < 0 || n_dest < 1 || n_dest > kMaxDest || capacity < 1 ||
      static_cast<long long>(n_dest) * capacity > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int body = body_of(B, n_dest);
  const int ctas = queue_dispatch_ctas(B, n_dest);
  if (static_cast<long long>(G) * ctas > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0) return static_cast<int>(cudaSuccess);
  cudaLaunchAttribute cluster = {};
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = ctas;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(G * ctas);
  config.blockDim = dim3(queue_dispatch_threads(B, n_dest));
  config.dynamicSmemBytes = queue_dispatch_smem_bytes(B, n_dest);
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = &cluster;
  config.numAttrs = body == 1 ? 1 : 0;
  const auto kernel = body == 0   ? queue_dispatch_kernel
                      : body == 1 ? queue_dispatch_cluster_kernel
                                  : queue_dispatch_wide_kernel;
  const cudaError_t rc = cudaLaunchKernelEx(
      &config, kernel, static_cast<const int*>(dest), B, n_dest, capacity,
      static_cast<int*>(slot), static_cast<uint8_t*>(kept), static_cast<int*>(buffers),
      static_cast<int*>(counts), static_cast<uint8_t*>(overflow));
  return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
}

}  // extern "C"
