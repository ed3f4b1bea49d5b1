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
// What bounds them on this card.  Each lane walks H+1 levels and the
// address of every level's node depends on the compare at the level above,
// so a lane is a chain of dependent loads (H+1 = 24 for the 2^24-key tree).
// The bytes are few and the arithmetic is a handful of int32 compares, so
// neither the HBM rate nor the ALUs is the limit: it is the dependent round
// trips on the chain, each an HBM latency (L_HBM) once the L2 is cold, and
// the rate at which the memory system serves the lanes' scattered 32-byte
// sectors, about one per lane per level below the staged ones.
// chip_smoke.py reports both the byte bound and round trips x L_HBM
// (L_HBM from csrc/pointer_chase.cu).
//
// The forest kernel (K1, K2 forest): one thread per lane, 256 per CTA; the
// top REGISTER_LEVELS levels staged in shared memory, deeper levels one
// __ldg round trip each (about 21); the value read where a result needs it
// (a hit, or any turn in the ordered configuration); the delta buffer
// staged whole in dynamic shared memory: keys, values, tombstones and (for
// the ordered configuration) the exclusive prefix of the weights, a
// block-wide scan.  A lane then does one lower-bound binary search, pos =
// #keys < q: hit = pos < C && keys[pos] == q, value and tombstone at pos,
// and the rank gains prefix[pos].  The staging takes 16 C + 132 bytes of
// one CTA's shared memory, so C is bounded by what one CTA may opt in to
// (227 KiB on the H100: about 14,000; delta_capacity_limit() says
// exactly).
//
// The hybrid body (K3, K2 hybrid), one 512-thread CTA per 512-lane
// dispatch chunk:
//  * Stage the top S = max(8, split) levels (at most 11) of keys in shared
//    memory, so the route through [0, split) never leaves it.
//  * Queue labels as K4 makes them, with no loop over earlier lanes: a warp
//    ranks its live lanes among their same-destination peers
//    (__match_any_sync; rank = popc of the peers below), the lowest lane of
//    each peer group writes the warp's count to a (16 warps x 2^split)
//    table in dynamic shared memory, one thread per destination turns its
//    column into an exclusive scan over the warps, and label = prefix +
//    rank: the serial FIFO label, without atomics.  The table bounds the
//    queue split at 11 (128 KiB; hybrid_max_queue_split()).  The direct
//    mapping's clash stays ceil(512 / capacity) - 1 compares.
//  * Below S, K = 2 levels per round trip: the 2^K - 1 keys under a lane's
//    node are K contiguous runs of the BFS layout (depth j: (idx + 1) 2^j
//    - 1 + m), loaded at once and resolved in registers, a hit stopping the
//    lane inside the group.  The same nodes are compared in the same order
//    as a level-by-level descent, so the rank arithmetic is unchanged.  A
//    lane keeps node indices only; the values it needs (the hit's, the last
//    right and left turns') are gathered in one round trip at the end.
//    At H = 23: 1 + 8 + 1 round trips a lane instead of 1 + 21 (+1).
//  * The stall round: an overflow lane replays [split, H] from its route
//    state, as the Pallas body does; it reads nothing another lane writes,
//    so it runs in the same pass as the placed lanes, behind no vote.
//  * The delta buffer stays in global memory: each CTA stages a sample (the
//    first key of every line of 32 slots; lines of 64, 128, ... slots past
//    64,992 slots ordered or 131,072 membership, so that it fits 16 KiB) and, ordered, the weight of the slots before each line; a
//    lane finds its line in the sample, reads that line's keys (and
//    weights) in one round trip before the route, and its value and
//    tombstone during the descent.  pos, the hit and the weight below q are
//    those of a binary search over the whole buffer, so any capacity runs.
// Tried on the card and not kept (PERF.md, PR 16): 3 and 4 levels per round
// trip (no faster: the scattered sectors a lane reads per level stay about
// one, and more bytes cost more than fewer trips save), the chunk spread
// over a cluster of 2, 4 or 8 CTAs (no faster), the whole buffer staged per
// CTA (slower), the delta line loaded before the route but counted after
// the descent (no faster, 64-100 registers).
//
// Sentinels stay int32: INT32_MIN (no predecessor), INT32_MAX (no successor)
// and -1 (no value).

#include <algorithm>
#include <climits>
#include <cstddef>
#include <cstdint>
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

// Exclusive prefix in place over a[0..n] of the values in a[1..n]: each
// thread sums a contiguous segment, the block scans the segment sums, each
// thread rewrites its own.  Every thread of the block must call it.
__device__ void block_prefix(int* a, int n, int* s_warp) {
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int begin = min(static_cast<int>(threadIdx.x) * per, n);
  const int end = min(begin + per, n);
  int local = 0;
  for (int i = begin; i < end; ++i) local += a[i + 1];
  int run = block_exclusive_scan(local, s_warp);
  if (threadIdx.x == 0) a[0] = 0;
  for (int i = begin; i < end; ++i) {
    run += a[i + 1];
    a[i + 1] = run;
  }
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
  block_prefix(s_pre, C, s_pre + C + 1);  // s_pre[p] = sum of weight[i], i < p
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

// ---------------------------------------------------------------------------
// K3 and K2 hybrid: the hybrid body (hybrid_descend_kernel), one 512-thread
// CTA per 512-lane dispatch chunk.  A lane's descent is kept by node index
// (Walk); the values a result needs are gathered once, after the descent.

constexpr int kChunkWarps = kHybridBlock / 32;
constexpr int kHybLevelsPerTrip = 2;  // global levels per round trip (K)
constexpr int kHybStagedLevels = 8;   // levels staged in shared memory (S) ...
constexpr int kHybMaxStagedLevels = 11;  // ... raised to the split, up to 11
constexpr int kHybStaged = (1 << kHybMaxStagedLevels) - 1;  // 2047 keys: 8 KiB
constexpr int kLine = 32;  // delta slots per sampled line: 128 bytes of keys
constexpr int kSampleInts = 4096;  // the delta sample's shared memory, in ints
constexpr unsigned kFullMask = 0xffffffffu;

struct Walk {
  int idx;        // the next node to compare
  bool found;
  int hit;        // the node that matched
  int pred_key;   // the key and node of the last right turn (node -1: none)
  int pred_node;
  int succ_key;   // the key and node of the last left turn
  int succ_node;
  int rank;
};

__device__ __forceinline__ Walk init_walk() {
  return Walk{0, false, -1, INT_MIN, -1, INT_MAX, -1, 0};
}

// One compare at `node` of level l, in the Pallas body's update order
// (_descend_one_level).  Returns whether the lane turned right.
template <bool ORDERED>
__device__ __forceinline__ bool walk_step(Walk& w, int q, int nk, int node,
                                          int l, int height) {
  const bool hit = nk == q;
  const bool right = !hit && q > nk;
  if (ORDERED) {
    const int left = (1 << (height - l)) - 1;
    if (hit) {
      w.rank += left;
    } else if (right) {
      w.pred_key = nk;
      w.pred_node = node;
      w.rank += left + 1;
    } else {
      w.succ_key = nk;
      w.succ_node = node;
    }
  }
  if (hit) {
    w.found = true;
    w.hit = node;
  } else {
    w.idx = 2 * node + 1 + (right ? 1 : 0);
  }
  return right;
}

// kk[BASE + m] for m < 2^J, by a mux over the bits of m: every index is a
// constant, so the keys stay in registers.
template <int BASE, int J, int N>
__device__ __forceinline__ int mux(const int (&kk)[N], int m) {
  if constexpr (J == 0) {
    return kk[BASE];
  } else {
    const int lo = mux<BASE, J - 1, N>(kk, m);
    const int hi = mux<BASE + (1 << (J - 1)), J - 1, N>(kk, m);
    return ((m >> (J - 1)) & 1) ? hi : lo;
  }
}

// The keys of depths J..K-1 under the node i1 - 1 (depth j: the 2^j keys
// from (i1 << j) - 1), for the depths below g.
template <int J, int K, int N>
__device__ __forceinline__ void load_runs(int (&kk)[N], const int* __restrict__ keys,
                                          unsigned i1, int g) {
  if constexpr (J < K) {
#pragma unroll
    for (int m = 0; m < (1 << J); ++m) {
      kk[(1 << J) - 1 + m] = J < g ? __ldg(keys + ((i1 << J) - 1u + m)) : 0;
    }
    load_runs<J + 1, K, N>(kk, keys, i1, g);
  }
}

// Compare depths J..g-1 of a loaded group; m is the path below i1 - 1.
template <bool ORDERED, int J, int K, int N>
__device__ __forceinline__ void resolve_runs(Walk& w, int q, const int (&kk)[N],
                                             unsigned i1, int m, int g, int l,
                                             int height) {
  if constexpr (J < K) {
    if (J < g && !w.found) {
      const int nk = mux<(1 << J) - 1, J, N>(kk, m);
      const int node = static_cast<int>((i1 << J) - 1u) + m;
      const bool right = walk_step<ORDERED>(w, q, nk, node, l + J, height);
      resolve_runs<ORDERED, J + 1, K, N>(w, q, kk, i1, 2 * m + (right ? 1 : 0), g, l,
                                         height);
    }
  }
}

// Levels [l0, l1) of the tree for a lane that has not hit.  Levels below
// `staged` read the shared copy one at a time; deeper ones go K levels per
// round trip: the 2^K - 1 keys of the K levels under the lane's node are
// K contiguous runs of the BFS layout (depth j: (idx + 1) 2^j - 1 + m,
// m < 2^j), loaded at once and resolved in registers.  The nodes compared
// and their order are those of a level-by-level descent.
template <bool ORDERED, int K>
__device__ __forceinline__ void walk_levels(Walk& w, int q, int l0, int l1,
                                            int height, int staged,
                                            const int* s_keys,
                                            const int* __restrict__ keys) {
  int l = l0;
  for (; l < min(l1, staged) && !w.found; ++l) {
    walk_step<ORDERED>(w, q, s_keys[w.idx], w.idx, l, height);
  }
  l = max(l, staged);
  for (; l < l1 && !w.found; l += K) {
    const int g = min(K, l1 - l);
    const unsigned i1 = static_cast<unsigned>(w.idx) + 1u;
    int kk[(1 << K) - 1];
    load_runs<0, K>(kk, keys, i1, g);
    resolve_runs<ORDERED, 0, K>(w, q, kk, i1, 0, g, l, height);
  }
}

// Sum of p[lo, hi): eight 16-byte loads for a whole aligned line.
__device__ __forceinline__ int slot_sum(const int* __restrict__ p, int lo,
                                        int hi, bool vec) {
  int s = 0;
  if (vec && hi - lo == kLine) {
    const int4* v = reinterpret_cast<const int4*>(p + lo);
#pragma unroll
    for (int i = 0; i < kLine / 4; ++i) {
      const int4 x = __ldg(v + i);
      s += x.x + x.y + x.z + x.w;
    }
    return s;
  }
  for (int i = lo; i < hi; ++i) s += __ldg(p + i);
  return s;
}

// The delta buffer's sample: the first key of each `line` slots, and for
// the ordered configuration the signed weight of the slots before each
// sampled line (a thread sums a line, the block scans the sums).  Shared
// memory: n_lines + (ordered) n_lines + 1 + kWarpSums ints.  Every thread
// of the block must call it; the caller's __syncthreads() publishes the
// last writes.
template <bool ORDERED>
__device__ void stage_lines(const Delta& d, int line, int* s) {
  const int C = d.capacity;
  const int n_lines = (C + line - 1) / line;
  const bool vec = (reinterpret_cast<uintptr_t>(d.weight) & 15) == 0;
  int* s_pre = s + n_lines;
  for (int j = threadIdx.x; j < n_lines; j += blockDim.x) {
    s[j] = __ldg(d.keys + j * line);
    if (ORDERED) {
      const int lo = j * line;
      const int hi = min(lo + line, C);
      int sum = 0;
      for (int p = lo; p < hi; p += kLine) sum += slot_sum(d.weight, p, min(p + kLine, hi), vec);
      s_pre[j + 1] = sum;
    }
  }
  if (!ORDERED) return;
  __syncthreads();
  block_prefix(s_pre, n_lines, s_pre + n_lines + 1);
}

// A lane's slot in the delta buffer, from the sample and one line of keys
// (and weights) in global memory: pos = #keys < q.  Returns the slot if
// keys[pos] == q, else -1; `below` gets the weight of the slots under q.
template <bool ORDERED>
__device__ __forceinline__ int probe_lines(const Delta& d, int line,
                                           const int* s, int q, int& below) {
  const int C = d.capacity;
  const int n_lines = (C + line - 1) / line;
  int lo = 0;
  int hi = n_lines;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  below = 0;
  if (lo == 0) return s[0] == q ? 0 : -1;  // nothing below q
  const bool vec =
      ((reinterpret_cast<uintptr_t>(d.keys) | reinterpret_cast<uintptr_t>(d.weight)) & 15) == 0;
  const int begin = (lo - 1) * line;
  const int end = min(begin + line, C);
  int n_below = 0;
  bool eq = false;
  int wsum = 0;
  for (int p = begin; p < end; p += kLine) {
    if (vec && p + kLine <= end) {
      const int4* kv = reinterpret_cast<const int4*>(d.keys + p);
      const int4* wv = reinterpret_cast<const int4*>(d.weight + p);
#pragma unroll
      for (int i = 0; i < kLine / 4; ++i) {
        const int4 k4 = __ldg(kv + i);
        int4 w4 = make_int4(0, 0, 0, 0);
        if (ORDERED) w4 = __ldg(wv + i);
        const int kx[4] = {k4.x, k4.y, k4.z, k4.w};
        const int wx[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          n_below += kx[u] < q;
          eq = eq || kx[u] == q;
          if (ORDERED && kx[u] < q) wsum += wx[u];
        }
      }
    } else {
      for (int i = p; i < min(p + kLine, end); ++i) {
        const int k = __ldg(d.keys + i);
        n_below += k < q;
        eq = eq || k == q;
        if (ORDERED && k < q) wsum += __ldg(d.weight + i);
      }
    }
  }
  if (ORDERED) below = s[n_lines + lo - 1] + wsum;
  const int pos = begin + n_below;
  // keys[pos] is in the line, or it opens the next sampled line
  return eq || (pos == end && lo < n_lines && s[lo] == q) ? pos : -1;
}

struct HybArgs {
  const int* keys;
  const int* values;
  int height;
  int split;
  int staged;  // levels staged in shared memory
  int capacity;
  const int* queries;
  const bool* active;
  int B;
  Outputs out;
  int* overflow;
  Delta delta;
  int line;  // delta slots per sampled line
};

// Dynamic shared memory of the hybrid body, in ints: the queue label table
// (16 warps x 2^split counts, padded to 4 ints), then the delta buffer's
// sample.
__host__ __device__ inline int hyb_table_ints(int split, int mapping) {
  return mapping == kQueue ? ((kChunkWarps << split) + 3) & ~3 : 0;
}

__host__ __device__ inline int hyb_delta_ints(int capacity, int line, bool ordered) {
  if (capacity == 0) return 0;
  const int n_lines = (capacity + line - 1) / line;
  return ordered ? 2 * n_lines + 1 + kWarpSums : n_lines;
}

// The sampled line of a C-slot buffer: the smallest kLine * 2^e whose
// sample fits kSampleInts.
inline int hyb_delta_line(int capacity, bool ordered) {
  int line = kLine;
  while (hyb_delta_ints(capacity, line, ordered) > kSampleInts) line *= 2;
  return line;
}

// Levels staged in shared memory: at least the route's, so it never leaves
// shared memory while the queue table fits.
inline int hyb_staged_levels(int split) {
  return std::min(std::max(kHybStagedLevels, split), kHybMaxStagedLevels);
}

template <bool ORDERED, int MAPPING, bool WITH_DELTA>
__global__ void __launch_bounds__(kHybridBlock)
    hybrid_descend_kernel(const HybArgs a) {
  __shared__ int s_keys[kHybStaged];
  __shared__ int s_dest[MAPPING == kDirect ? kHybridBlock : 1];  // a live lane's subtree, else -1
  extern __shared__ int smem[];
  const int n_sub = 1 << a.split;
  int* table = smem;  // queue: [kChunkWarps][n_sub]
  int* s_delta = smem + hyb_table_ints(a.split, MAPPING);

  const int tid = threadIdx.x;
  const int b = blockIdx.x * kHybridBlock + tid;
  const bool in = b < a.B;
  const bool act = in && (a.active == nullptr || a.active[b]);
  const int q = in ? a.queries[b] : 0;

  const int staged = min(a.staged, a.height + 1);
  for (int i = tid; i < (1 << staged) - 1; i += kHybridBlock) s_keys[i] = a.keys[i];
  if constexpr (MAPPING == kQueue) {
    for (int i = tid; i < kChunkWarps * n_sub; i += kHybridBlock) table[i] = 0;
  }
  if constexpr (WITH_DELTA) stage_lines<ORDERED>(a.delta, a.line, s_delta);
  __syncthreads();

  // The delta buffer first: its value and tombstone loads are consumed
  // after the descent.
  int d_pos = -1;
  int d_below = 0;
  int d_val = 0;
  int d_tomb = 0;
  if constexpr (WITH_DELTA) {
    if (act) {
      d_pos = probe_lines<ORDERED>(a.delta, a.line, s_delta, q, d_below);
      if (d_pos >= 0) {
        d_val = __ldg(a.delta.values + d_pos);
        d_tomb = __ldg(a.delta.tombstone + d_pos);
      }
    }
  }

  // The route through [0, split): shared memory, since staged >= split
  // wherever the queue table fits.
  Walk w = init_walk();
  if (act) {
    walk_levels<ORDERED, kHybLevelsPerTrip>(w, q, 0, a.split, a.height, staged, s_keys,
                                            a.keys);
  }
  const bool live = act && !w.found;
  const int dest = min(max(w.idx - (n_sub - 1), 0), n_sub - 1);

  // Placement of the chunk's live lanes.
  bool clash = false;
  if constexpr (MAPPING == kQueue) {
    // FIFO labels as K4 makes them: rank among the warp's same-destination
    // peers, the warp's count in a (warps x n_sub) table, one thread per
    // destination scanning its column over the warps; label = prefix + rank.
    const unsigned peers = __match_any_sync(kFullMask, live ? dest : -1);
    const int rank = __popc(peers & ((1u << (tid & 31)) - 1u));
    const int warp = tid >> 5;
    if (live && rank == 0) table[warp * n_sub + dest] = __popc(peers);
    __syncthreads();
    for (int d = tid; d < n_sub; d += kHybridBlock) {
      int run = 0;
      for (int v = 0; v < kChunkWarps; ++v) {
        const int c = table[v * n_sub + d];
        table[v * n_sub + d] = run;
        run += c;
      }
    }
    __syncthreads();
    if (live) clash = table[warp * n_sub + dest] + rank >= a.capacity;
  } else {
    // lane i owns slot i % capacity; it clashes with a live lane
    // k * capacity back that shares its subtree
    s_dest[tid] = live ? dest : -1;
    __syncthreads();
    if (live) {
      for (int off = a.capacity; off < kHybridBlock && off <= tid; off += a.capacity) {
        clash = clash || s_dest[tid - off] == dest;
      }
    }
  }
  const bool overflow = live && clash;

  // The placed lanes descend [split, H]; the overflow lanes replay the same
  // levels from the route state (the stall round).  A lane reads nothing
  // another lane writes, so the replay runs in the same pass.
  if (act) {
    walk_levels<ORDERED, kHybLevelsPerTrip>(w, q, a.split, a.height + 1, a.height, staged,
                                            s_keys, a.keys);
  }
  if (!in) return;

  // One round trip for the values: the hit's, and (ordered) the last right
  // and left turns'.
  Lane s = init_lane();
  s.found = w.found;
  if (w.found) s.val = __ldg(a.values + w.hit);
  if (ORDERED) {
    s.pred_key = w.pred_key;
    s.succ_key = w.succ_key;
    s.rank = w.rank;
    if (w.pred_node >= 0) s.pred_value = __ldg(a.values + w.pred_node);
    if (w.succ_node >= 0) s.succ_value = __ldg(a.values + w.succ_node);
  }
  if constexpr (WITH_DELTA) {
    // delta-hit > tombstone > tree-hit; the weight below q joins the rank
    if (d_pos >= 0) {
      s.val = d_tomb != 0 ? kSentinelValue : d_val;
      s.found = d_tomb == 0;
    }
    if (ORDERED) s.rank += d_below;
  }
  if (a.overflow != nullptr) a.overflow[b] = overflow;
  store<ORDERED>(a.out, b, s);
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

// The dynamic shared memory a launch needs, in bytes.
size_t hyb_smem_bytes(int split, int mapping, int capacity, int line, bool ordered) {
  return sizeof(int) * (static_cast<size_t>(hyb_table_ints(split, mapping)) +
                        static_cast<size_t>(hyb_delta_ints(capacity, line, ordered)));
}

// The shared memory one CTA of the hybrid body may take dynamically: the
// opt-in limit less its static shared memory (the direct mapping's, the
// larger).  Queried once per device.  -(cudaError_t) on failure.
int hyb_smem_budget() {
  static std::mutex mu;
  static std::map<int, int> budgets;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  const std::lock_guard<std::mutex> lock(mu);
  const auto it = budgets.find(dev);
  if (it != budgets.end()) return it->second;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, hybrid_descend_kernel<true, kDirect, true>);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return budgets[dev] = optin - static_cast<int>(attr.sharedSizeBytes);
}

template <bool ORDERED, int MAPPING, bool WITH_DELTA>
cudaError_t launch_hybrid(const HybArgs& a, size_t smem, cudaStream_t st) {
  const auto kernel = hybrid_descend_kernel<ORDERED, MAPPING, WITH_DELTA>;
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.B + kHybridBlock - 1) / kHybridBlock);
  kernel<<<grid, kHybridBlock, smem, st>>>(a);
  return cudaGetLastError();
}

// Both entry points: Delta{} (capacity 0) runs without the buffer.
int hyb_entry(const int* keys, const int* values, int height, int split,
              int mapping, int capacity, const int* queries, const bool* active,
              int B, bool ordered, const Delta& d, const Outputs& out,
              int* overflow_out, void* stream) {
  const bool with_delta = d.capacity > 0;
  const int line = with_delta ? hyb_delta_line(d.capacity, ordered) : kLine;
  const HybArgs a{keys, values, height, split, hyb_staged_levels(split), capacity,
                  queries, active, B, out, overflow_out, d, line};
  const int budget = hyb_smem_budget();
  if (budget < 0) return -budget;
  const size_t smem = hyb_smem_bytes(split, mapping, d.capacity, line, ordered);
  if (smem > static_cast<size_t>(budget)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
#define REPRO_HYBRID_LAUNCH(DELTA)                                      \
  if (ordered && mapping == kQueue) {                                   \
    e = launch_hybrid<true, kQueue, DELTA>(a, smem, st);                \
  } else if (ordered) {                                                 \
    e = launch_hybrid<true, kDirect, DELTA>(a, smem, st);               \
  } else if (mapping == kQueue) {                                       \
    e = launch_hybrid<false, kQueue, DELTA>(a, smem, st);               \
  } else {                                                              \
    e = launch_hybrid<false, kDirect, DELTA>(a, smem, st);              \
  }
  if (with_delta) {
    REPRO_HYBRID_LAUNCH(true)
  } else {
    REPRO_HYBRID_LAUNCH(false)
  }
#undef REPRO_HYBRID_LAUNCH
  return static_cast<int>(e);
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
// mapping 0 = queue, 1 = direct; overflow_out: (B,) int32 or null.  A queue
// split whose label table does not fit (hybrid_max_queue_split) is refused.
int hybrid_descend(const int* keys, const int* values, int n, int height,
                   int split, int mapping, int capacity, const int* queries,
                   const bool* active, int B, int ordered, int* val,
                   bool* found, int* pred_key, int* pred_value, int* succ_key,
                   int* succ_value, int* rank, int* overflow_out,
                   void* stream) {
  (void)n;
  return hyb_entry(keys, values, height, split, mapping, capacity, queries, active, B,
                   ordered != 0, Delta{},
                   make_outputs(val, found, pred_key, pred_value, succ_key, succ_value, rank),
                   overflow_out, stream);
}

// hybrid_descend with the delta buffer (K2), resolved after the stall round.
// Any capacity >= 1: the buffer stays in global memory, a sample of it in
// shared memory.
int hybrid_descend_delta(const int* keys, const int* values, int n,
                         int height, int split, int mapping, int capacity,
                         const int* queries, const bool* active, int B,
                         int ordered, const int* dkeys, const int* dvals,
                         const int* dtomb, const int* dweight,
                         int delta_capacity, int* val, bool* found,
                         int* pred_key, int* pred_value, int* succ_key,
                         int* succ_value, int* rank, int* overflow_out,
                         void* stream) {
  (void)n;
  if (delta_capacity < 1) return static_cast<int>(cudaErrorInvalidValue);
  return hyb_entry(keys, values, height, split, mapping, capacity, queries, active, B,
                   ordered != 0, Delta{dkeys, dvals, dtomb, dweight, delta_capacity},
                   make_outputs(val, found, pred_key, pred_value, succ_key, succ_value, rank),
                   overflow_out, stream);
}

// The hybrid body's design, for the latency bound chip_smoke.py reports:
// levels per global round trip, and levels staged in shared memory at a
// split level.
int hybrid_levels_per_trip() { return kHybLevelsPerTrip; }

int hybrid_staged_levels(int split) { return hyb_staged_levels(split); }

// Delta slots per sampled line at a capacity, and the dynamic shared memory
// of one CTA of the hybrid body (capacity 0: no delta buffer), in bytes.
int hybrid_delta_line(int capacity, int ordered) {
  return hyb_delta_line(capacity, ordered != 0);
}

int hybrid_smem_bytes(int split, int mapping, int capacity, int ordered) {
  const int line = capacity > 0 ? hyb_delta_line(capacity, ordered != 0) : kLine;
  return static_cast<int>(hyb_smem_bytes(split, mapping, capacity, line, ordered != 0));
}

// The largest split level whose queue label table fits one CTA of the
// hybrid body beside the largest delta sample, on the current device.
// A negative return is -(cudaError_t).
int hybrid_max_queue_split() {
  const int budget = hyb_smem_budget();
  if (budget < 0) return budget;
  int split = 0;
  while (sizeof(int) * (static_cast<size_t>(hyb_table_ints(split + 1, kQueue)) + kSampleInts) <=
         static_cast<size_t>(budget)) {
    ++split;
  }
  return split;
}

// The largest delta capacity whose ordered staging fits in one CTA of the
// forest kernel on the current device: the shared memory a block may opt
// in to, less the kernel's static shared memory.  A negative return is
// -(cudaError_t).
int delta_capacity_limit() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, forest_descend_kernel<true, true>);
  if (e != cudaSuccess) return -static_cast<int>(e);
  const int ints =
      (optin - static_cast<int>(attr.sharedSizeBytes)) / static_cast<int>(sizeof(int));
  return (ints - 1 - kWarpSums) / 4;
}

}  // extern "C"
