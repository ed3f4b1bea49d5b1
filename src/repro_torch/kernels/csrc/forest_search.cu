// Hopper (sm_90a) kernels of the BST search path: the forest descent and the
// in-kernel hybrid dispatch, each with and without the delta write buffer.
// Plain C interface, loaded with ctypes by repro_torch/kernels/_build.py;
// each entry point launches on the caller's stream and returns
// cudaGetLastError() (or the error of the launch's own setup).
//
// What each kernel replaces (the JAX package's Pallas TPU kernel):
//   forest_descend<ORDERED, false>   -> repro/kernels/bst_search.py
//       _forest_search_kernel with dispatch=None, with_delta=False, reached
//       through bst_ordered_forest_pallas / bst_search_forest_pallas /
//       bst_search_pallas (hrz: a forest of one row; dup: every grid row
//       reads row 0).
//   hybrid_descend<ORDERED, MAPPING, false> -> the same body with
//       dispatch=(mapping, capacity), through bst_hybrid_forest_pallas
//       (_dispatch_lanes for the queue/direct placement).
//   <..., true> (entry points forest_descend_delta / hybrid_descend_delta)
//       -> the same body with with_delta=True (bst_search.py:228-246): the
//       sorted delta buffer of pending upserts and tombstones resolved in
//       the same pass, after the whole descent (after the stall round).
//
// What bounds them on this card: each lane walks H+1 levels, and the address
// of every level's node depends on the compare at the level above, so one
// lane is a chain of H+1 dependent global loads (about 24 for the 2^24-key
// tree).  The bytes are few (a key, and a value where needed, per level) and
// the arithmetic is a handful of int32 compares, so neither DRAM bandwidth
// nor the ALUs is the limit: it is load latency times depth, hidden only by
// the number of lanes in flight.  The byte bound (distinct nodes touched
// over 3.35 TB/s) that chip_smoke.py reports is therefore far below what the
// chain allows.
//
// What the design does about it: one thread per query lane with few
// registers, so many lanes are resident per SM; the top levels, which every
// lane reads, sit in shared memory; deeper levels go through the read-only
// path (__ldg) and stay int32; a lane that hits stops at once; the value of a
// node is read only where a result needs it (a hit, or any turn in the
// ordered configuration).  The hybrid kernel runs each 512-lane chunk as one
// CTA: the dispatch labels are computed in shared memory, and the stall
// round is a second pass behind a block-wide vote, so chunks that do not
// overflow pay nothing for it.  Making the chain itself shorter (software
// prefetch of both children, several lanes per thread) is later work.
//
// The delta configuration.  The buffer is four (C,) int32 operands: keys in
// ascending order with an INT32_MAX tail of empty slots, values, tombstone
// flags and signed rank weights (0 on empty slots).  Each CTA stages keys,
// values and tombstones in dynamic shared memory and, for the ordered
// configuration, the exclusive prefix of the weights (a block-wide scan).
// An active lane then does one lower-bound binary search, pos = #keys < q:
// hit = pos < C && keys[pos] == q, value and tombstone are read at pos, and
// the rank gains prefix[pos].  Live keys are unique and sorted (ingest
// dedups them) and empty slots carry weight 0, so this equals the Pallas
// body's broadcast sums bit for bit.  A query equal to INT32_MAX is outside
// the op contract (it would meet the empty slots' key), so no input of the
// path carries one.  The staging takes 16 C + 132 bytes of shared memory per
// CTA, so the capacity is bounded by what one CTA may opt in to (227 KiB on
// the H100: C up to about 14,000; delta_capacity_limit() says exactly), and
// it bounds occupancy: a 4096-entry buffer leaves room for three CTAs per SM.
// Making it fast is later work.
//
// Sentinels stay int32: INT32_MIN (no predecessor), INT32_MAX (no successor)
// and -1 (no value).

#include <climits>
#include <cstddef>
#include <map>
#include <mutex>
#include <utility>

#include <cuda_runtime.h>

namespace {

constexpr int kSentinelValue = -1;
constexpr int kForestBlock = 256;  // lanes per CTA of forest_descend
constexpr int kHybridBlock = 512;  // lanes per dispatch chunk (plans.KERNEL_BLOCK_Q)
constexpr int kMaxStagedLevels = 8;  // levels staged in shared memory, at most
constexpr int kMaxStaged = (1 << kMaxStagedLevels) - 1;
constexpr int kQueue = 0;
constexpr int kDirect = 1;
constexpr int kWarpSums = 32;  // per-warp partials of the weight scan

struct Outputs {
  int* val;
  bool* found;
  int* pred_key;
  int* pred_value;
  int* succ_key;
  int* succ_value;
  int* rank;
};

// The delta buffer's four (C,) operands.
struct Delta {
  const int* keys;
  const int* values;
  const int* tombstone;
  const int* weight;
  int capacity;
};

struct Lane {
  int idx;
  int val;
  bool found;
  int pred_key;
  int pred_value;
  int succ_key;
  int succ_value;
  int rank;
};

__device__ __forceinline__ Lane init_lane() {
  return Lane{0, kSentinelValue, false, INT_MIN, kSentinelValue,
              INT_MAX, kSentinelValue, 0};
}

// Stage the first `levels` levels of a flat row in shared memory.
__device__ __forceinline__ void stage(const int* __restrict__ keys,
                                      const int* __restrict__ values,
                                      int levels, int* s_keys, int* s_vals) {
  const int n = (1 << levels) - 1;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s_keys[i] = keys[i];
    s_vals[i] = values[i];
  }
}

// Compare-descend levels [l0, l1) of one flat row for a lane whose gate is
// open.  Levels below `staged` read the shared copy, deeper ones the row.
// The update order follows the Pallas body (_descend_one_level).
template <bool ORDERED>
__device__ __forceinline__ void descend(Lane& s, int q, bool gate, int l0,
                                        int l1, int height, int staged,
                                        const int* s_keys, const int* s_vals,
                                        const int* __restrict__ keys,
                                        const int* __restrict__ values,
                                        int n) {
  if (!gate) return;
  for (int l = l0; l < l1 && !s.found; ++l) {
    const int i = min(max(s.idx, 0), n - 1);
    const bool shared = l < staged;
    const int nk = shared ? s_keys[i] : __ldg(keys + i);
    const bool hit = nk == q;
    const bool go_right = !hit && q > nk;
    int nv = 0;
    if (ORDERED || hit) nv = shared ? s_vals[i] : __ldg(values + i);
    if (hit) {
      s.val = nv;
      s.found = true;
    }
    if (ORDERED) {
      const int left = (1 << (height - l)) - 1;
      const bool go_left = !hit && q < nk;
      if (go_right) {
        s.pred_key = nk;
        s.pred_value = nv;
      }
      if (go_left) {
        s.succ_key = nk;
        s.succ_value = nv;
      }
      if (go_right) s.rank += left + 1;
      if (hit) s.rank += left;
    }
    if (!s.found) s.idx = 2 * s.idx + 1 + (go_right ? 1 : 0);
  }
}

// Exclusive prefix sum of one int per thread over the block (blockDim.x a
// multiple of 32, at most 1024).  Every thread of the block must call it.
__device__ int block_exclusive_scan(int x, int* s_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    const int w = lane < n_warps ? s_warp[lane] : 0;
    int w_incl = w;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w_incl, o);
      if (lane >= o) w_incl += y;
    }
    if (lane < n_warps) s_warp[lane] = w_incl - w;
  }
  __syncthreads();
  return s_warp[warp] + incl - x;
}

// Dynamic shared memory of the delta staging, in ints: keys, values and
// tombstones (C each), then for the ordered configuration the weight prefix
// (C + 1) and the scan's per-warp partials.
__host__ __device__ inline int delta_smem_ints(int capacity, bool ordered) {
  return ordered ? 4 * capacity + 1 + kWarpSums : 3 * capacity;
}

// Stage the delta buffer in dynamic shared memory.  Every thread of the block
// must call it; the caller's __syncthreads() publishes the last writes.
template <bool ORDERED>
__device__ void stage_delta(const Delta& d, int* smem) {
  const int C = d.capacity;
  int* s_pre = smem + 3 * C;
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    smem[i] = d.keys[i];
    smem[C + i] = d.values[i];
    smem[2 * C + i] = d.tombstone[i];
    if (ORDERED) s_pre[i + 1] = d.weight[i];
  }
  if (!ORDERED) return;
  __syncthreads();
  // s_pre[p] = sum of weight[i] over i < p: each thread sums a contiguous
  // segment, the block scans the segment sums, each thread rewrites its own.
  const int per = (C + blockDim.x - 1) / blockDim.x;
  const int begin = min(static_cast<int>(threadIdx.x) * per, C);
  const int end = min(begin + per, C);
  int local = 0;
  for (int i = begin; i < end; ++i) local += s_pre[i + 1];
  int run = block_exclusive_scan(local, s_pre + C + 1);
  if (threadIdx.x == 0) s_pre[0] = 0;
  for (int i = begin; i < end; ++i) {
    run += s_pre[i + 1];
    s_pre[i + 1] = run;
  }
}

// Resolve one active lane against the staged buffer: delta-hit > tombstone >
// tree-hit on value/found, and (ordered) the signed weight of the entries
// below q added to the rank.  Membership gets no rank correction.
template <bool ORDERED>
__device__ __forceinline__ void resolve_delta(Lane& s, int q, bool act,
                                              const int* smem, int C) {
  if (!act) return;
  int lo = 0;
  int hi = C;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (smem[mid] < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  if (lo < C && smem[lo] == q) {
    const bool dead = smem[2 * C + lo] != 0;
    s.val = dead ? kSentinelValue : smem[C + lo];
    s.found = !dead;
  }
  if (ORDERED) s.rank += smem[3 * C + lo];
}

template <bool ORDERED>
__device__ __forceinline__ void store(const Outputs& out, size_t o,
                                      const Lane& s) {
  out.val[o] = s.val;
  out.found[o] = s.found;
  if (ORDERED) {
    out.pred_key[o] = s.pred_key;
    out.pred_value[o] = s.pred_value;
    out.succ_key[o] = s.succ_key;
    out.succ_value[o] = s.succ_value;
    out.rank[o] = s.rank;
  }
}

// K1 (and K2 with WITH_DELTA): grid (ceil(B / 256), T); lane b of query
// row t descends tree row t, or row 0 when the rows share one tree (dup).
template <bool ORDERED, bool WITH_DELTA>
__global__ void __launch_bounds__(kForestBlock)
    forest_descend_kernel(const int* __restrict__ keys,
                          const int* __restrict__ values, int n, int height,
                          int reg_levels, bool shared_tree,
                          const int* __restrict__ queries,
                          const bool* __restrict__ active, int B,
                          Outputs out, Delta delta) {
  __shared__ int s_keys[kMaxStaged];
  __shared__ int s_vals[kMaxStaged];
  extern __shared__ int s_delta[];
  const int t = blockIdx.y;
  const size_t row = shared_tree ? 0 : static_cast<size_t>(t) * n;
  const int* rk = keys + row;
  const int* rv = values + row;
  stage(rk, rv, reg_levels, s_keys, s_vals);
  if constexpr (WITH_DELTA) stage_delta<ORDERED>(delta, s_delta);
  __syncthreads();

  const int b = blockIdx.x * kForestBlock + threadIdx.x;
  if (b >= B) return;  // ragged edge of the last block
  const size_t o = static_cast<size_t>(t) * B + b;
  const bool act = active == nullptr || active[o];
  const int q = queries[o];
  Lane s = init_lane();
  descend<ORDERED>(s, q, act, 0, height + 1, height, reg_levels, s_keys,
                   s_vals, rk, rv, n);
  if constexpr (WITH_DELTA) {
    resolve_delta<ORDERED>(s, q, act, s_delta, delta.capacity);
  }
  store<ORDERED>(out, o, s);
}

// K3 (and K2 with WITH_DELTA): one CTA per 512-lane chunk.  Route through
// [0, split), place the live lanes into per-subtree buffers (queue or
// direct), descend the placed lanes through [split, H], then replay the
// overflow lanes through the same levels from the route state; the delta
// buffer resolves after all of that.  Lanes past B are padding: inactive,
// never live.
template <bool ORDERED, int MAPPING, bool WITH_DELTA>
__global__ void __launch_bounds__(kHybridBlock)
    hybrid_descend_kernel(const int* __restrict__ keys,
                          const int* __restrict__ values, int n, int height,
                          int split, int capacity,
                          const int* __restrict__ queries,
                          const bool* __restrict__ active, int B, Outputs out,
                          int* __restrict__ overflow_out, Delta delta) {
  __shared__ int s_keys[kMaxStaged];
  __shared__ int s_vals[kMaxStaged];
  __shared__ int s_dest[kHybridBlock];  // a live lane's subtree, else -1
  extern __shared__ int s_delta[];
  const int staged = min(split, kMaxStagedLevels);
  stage(keys, values, staged, s_keys, s_vals);
  if constexpr (WITH_DELTA) stage_delta<ORDERED>(delta, s_delta);
  __syncthreads();

  const int tid = threadIdx.x;
  const int b = blockIdx.x * kHybridBlock + tid;
  const bool in = b < B;
  const bool act = in && (active == nullptr || active[b]);
  const int q = in ? queries[b] : 0;
  Lane s = init_lane();
  descend<ORDERED>(s, q, act, 0, split, height, staged, s_keys, s_vals, keys,
                   values, n);

  const int n_sub = 1 << split;
  const bool live = act && !s.found;
  const int dest = min(max(s.idx - (n_sub - 1), 0), n_sub - 1);
  s_dest[tid] = live ? dest : -1;
  __syncthreads();

  bool clash = false;
  if (live) {
    if (MAPPING == kQueue) {
      // label = earlier live lanes of the chunk with the same subtree
      int label = 0;
      for (int j = 0; j < tid && label < capacity; ++j) {
        label += s_dest[j] == dest;
      }
      clash = label >= capacity;
    } else {
      // lane i owns slot i % capacity; it clashes with a live lane
      // k * capacity back that shares its subtree
      for (int off = capacity; off < kHybridBlock && off <= tid; off += capacity) {
        clash = clash || s_dest[tid - off] == dest;
      }
    }
  }
  const bool overflow = live && clash;

  descend<ORDERED>(s, q, act && !overflow, split, height + 1, height, staged,
                   s_keys, s_vals, keys, values, n);
  if (__syncthreads_or(overflow)) {  // the stall round
    descend<ORDERED>(s, q, overflow, split, height + 1, height, staged,
                     s_keys, s_vals, keys, values, n);
  }
  if (!in) return;
  if constexpr (WITH_DELTA) {
    resolve_delta<ORDERED>(s, q, act, s_delta, delta.capacity);
  }
  if (overflow_out != nullptr) overflow_out[b] = overflow;
  store<ORDERED>(out, b, s);
}

Outputs make_outputs(int* val, bool* found, int* pred_key, int* pred_value,
                     int* succ_key, int* succ_value, int* rank) {
  return Outputs{val, found, pred_key, pred_value, succ_key, succ_value, rank};
}

// Opt a kernel in to `bytes` of dynamic shared memory (above the 48 KiB
// default a launch is refused without it).  The attribute is set only when
// `bytes` exceeds the largest opt-in made so far for this kernel on the
// current device, so a steady stream of launches sets it once.
cudaError_t allow_smem(const void* kernel, size_t bytes) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> allowed;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const std::lock_guard<std::mutex> lock(mu);
  size_t& have = allowed[{kernel, dev}];
  if (bytes <= have) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e == cudaSuccess) have = bytes;
  return e;
}

}  // namespace

extern "C" {

// The message of a cudaError code, for every entry point of the library.
const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int hybrid_block_q() { return kHybridBlock; }

// keys/values: (n_rows, n) int32; queries: (T, B) int32; active: (T, B) bool
// or null; outputs (T, B).  pred/succ/rank outputs are read only if ordered.
int forest_descend(const int* keys, const int* values, int n, int height,
                   int reg_levels, int shared_tree, const int* queries,
                   const bool* active, int T, int B, int ordered, int* val,
                   bool* found, int* pred_key, int* pred_value, int* succ_key,
                   int* succ_value, int* rank, void* stream) {
  const dim3 grid((B + kForestBlock - 1) / kForestBlock, T);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Outputs out =
      make_outputs(val, found, pred_key, pred_value, succ_key, succ_value, rank);
  if (ordered) {
    forest_descend_kernel<true, false><<<grid, kForestBlock, 0, st>>>(
        keys, values, n, height, reg_levels, shared_tree != 0, queries, active,
        B, out, Delta{});
  } else {
    forest_descend_kernel<false, false><<<grid, kForestBlock, 0, st>>>(
        keys, values, n, height, reg_levels, shared_tree != 0, queries, active,
        B, out, Delta{});
  }
  return static_cast<int>(cudaGetLastError());
}

// forest_descend with the delta buffer (K2): dkeys/dvals/dtomb/dweight are
// (capacity,) int32 on the device.
int forest_descend_delta(const int* keys, const int* values, int n, int height,
                         int reg_levels, int shared_tree, const int* queries,
                         const bool* active, int T, int B, int ordered,
                         const int* dkeys, const int* dvals, const int* dtomb,
                         const int* dweight, int capacity, int* val,
                         bool* found, int* pred_key, int* pred_value,
                         int* succ_key, int* succ_value, int* rank,
                         void* stream) {
  const dim3 grid((B + kForestBlock - 1) / kForestBlock, T);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Outputs out =
      make_outputs(val, found, pred_key, pred_value, succ_key, succ_value, rank);
  const Delta d{dkeys, dvals, dtomb, dweight, capacity};
  const size_t smem = sizeof(int) * delta_smem_ints(capacity, ordered != 0);
#define REPRO_FOREST_DELTA_LAUNCH(ORD)                                        \
  do {                                                                        \
    const cudaError_t e = allow_smem(                                         \
        reinterpret_cast<const void*>(&forest_descend_kernel<ORD, true>), smem); \
    if (e != cudaSuccess) return static_cast<int>(e);                         \
    forest_descend_kernel<ORD, true><<<grid, kForestBlock, smem, st>>>(       \
        keys, values, n, height, reg_levels, shared_tree != 0, queries,       \
        active, B, out, d);                                                   \
  } while (0)
  if (ordered) {
    REPRO_FOREST_DELTA_LAUNCH(true);
  } else {
    REPRO_FOREST_DELTA_LAUNCH(false);
  }
#undef REPRO_FOREST_DELTA_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// keys/values: (n,) int32; queries: (B,) int32; active: (B,) bool or null;
// mapping 0 = queue, 1 = direct; overflow_out: (B,) int32 or null.
int hybrid_descend(const int* keys, const int* values, int n, int height,
                   int split, int mapping, int capacity, const int* queries,
                   const bool* active, int B, int ordered, int* val,
                   bool* found, int* pred_key, int* pred_value, int* succ_key,
                   int* succ_value, int* rank, int* overflow_out,
                   void* stream) {
  const dim3 grid((B + kHybridBlock - 1) / kHybridBlock);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Outputs out =
      make_outputs(val, found, pred_key, pred_value, succ_key, succ_value, rank);
#define REPRO_HYBRID_LAUNCH(ORD, MAP)                                        \
  hybrid_descend_kernel<ORD, MAP, false><<<grid, kHybridBlock, 0, st>>>(     \
      keys, values, n, height, split, capacity, queries, active, B, out,     \
      overflow_out, Delta{})
  if (ordered && mapping == kQueue) {
    REPRO_HYBRID_LAUNCH(true, kQueue);
  } else if (ordered) {
    REPRO_HYBRID_LAUNCH(true, kDirect);
  } else if (mapping == kQueue) {
    REPRO_HYBRID_LAUNCH(false, kQueue);
  } else {
    REPRO_HYBRID_LAUNCH(false, kDirect);
  }
#undef REPRO_HYBRID_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// hybrid_descend with the delta buffer (K2), resolved after the stall round.
int hybrid_descend_delta(const int* keys, const int* values, int n,
                         int height, int split, int mapping, int capacity,
                         const int* queries, const bool* active, int B,
                         int ordered, const int* dkeys, const int* dvals,
                         const int* dtomb, const int* dweight,
                         int delta_capacity, int* val, bool* found,
                         int* pred_key, int* pred_value, int* succ_key,
                         int* succ_value, int* rank, int* overflow_out,
                         void* stream) {
  const dim3 grid((B + kHybridBlock - 1) / kHybridBlock);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Outputs out =
      make_outputs(val, found, pred_key, pred_value, succ_key, succ_value, rank);
  const Delta d{dkeys, dvals, dtomb, dweight, delta_capacity};
  const size_t smem = sizeof(int) * delta_smem_ints(delta_capacity, ordered != 0);
#define REPRO_HYBRID_DELTA_LAUNCH(ORD, MAP)                                   \
  do {                                                                        \
    const cudaError_t e =                                                     \
        allow_smem(reinterpret_cast<const void*>(                             \
                       &hybrid_descend_kernel<ORD, MAP, true>),               \
                   smem);                                                     \
    if (e != cudaSuccess) return static_cast<int>(e);                         \
    hybrid_descend_kernel<ORD, MAP, true><<<grid, kHybridBlock, smem, st>>>(  \
        keys, values, n, height, split, capacity, queries, active, B, out,    \
        overflow_out, d);                                                     \
  } while (0)
  if (ordered && mapping == kQueue) {
    REPRO_HYBRID_DELTA_LAUNCH(true, kQueue);
  } else if (ordered) {
    REPRO_HYBRID_DELTA_LAUNCH(true, kDirect);
  } else if (mapping == kQueue) {
    REPRO_HYBRID_DELTA_LAUNCH(false, kQueue);
  } else {
    REPRO_HYBRID_DELTA_LAUNCH(false, kDirect);
  }
#undef REPRO_HYBRID_DELTA_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// The largest delta capacity whose ordered staging fits in one CTA of the
// forest (hybrid = 0) or hybrid (hybrid = 1) kernel on the current device:
// the shared memory a block may opt in to, less the kernel's static shared
// memory.  A negative return is -(cudaError_t).
int delta_capacity_limit(int hybrid) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaFuncAttributes attr;
  e = hybrid ? cudaFuncGetAttributes(&attr,
                                     hybrid_descend_kernel<true, kQueue, true>)
             : cudaFuncGetAttributes(&attr, forest_descend_kernel<true, true>);
  if (e != cudaSuccess) return -static_cast<int>(e);
  const int ints =
      (optin - static_cast<int>(attr.sharedSizeBytes)) / static_cast<int>(sizeof(int));
  return (ints - 1 - kWarpSums) / 4;
}

}  // extern "C"
