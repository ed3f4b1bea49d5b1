// Hopper (sm_90a) K5's backward: dq, dk and dv of the flash attention
// forward (flash_attention.cu) from q, k, v, its output o, the output's
// gradient dO and the forward's row log-sum-exp.  Plain C interface,
// loaded with ctypes by repro_torch/kernels/_build.py; the entry point
// launches on the caller's stream and returns cudaGetLastError().
//
// What it replaces: no TPU kernel.  The JAX package trains through
// _blockwise_attn (repro/models/attention.py), which XLA differentiates;
// the port trains through K5, so it needs K5's backward as a kernel of its
// own.  Three kernels a call: a pre-pass (delta = rowsum(dO o o), one warp
// a q row, dq_acc and dQ's semaphores zeroed), the main kernel, and in bf16 a cast of the
// fp32 dq_acc into dq.  The main kernel is one CTA per (128- or 64-row kv
// tile, kv head row), which loops over its GQA group's q head rows and, of
// each, the 64-row q tiles that can see the tile (causal, window), and per
// q tile recomputes P = exp(scale S - lse) (0 where masked, and for a row
// that sees no key), dP = dO V^T, dS = scale P o (dP - delta), then
// dV += P^T dO, dK += dS^T Q and dQ += dS K, the last added to the fp32
// dq_acc (every kv tile of the row adds to it, in a fixed order: see "dQ's
// order" below, so a call gives the same bits every time, as XLA's
// gradient does).  Summing the group's q heads inside the CTA gives dK and
// dV without atomics.
//
// What bounds it on this card: the five products, 2.5 times the forward's
// operations (171.9 GFLOP at qwen3-1.7b's training shape, B*H 64, BHkv 32,
// S 2048, d 128, causal), against about 0.2 GB of operands and gradients:
// the tensor cores bound it, 0.174 ms at 989 TFLOP/s bf16.  Two bodies:
//
// - bf16 (the training dtype): flash_bwd_bf16_kernel<D>, all five products
//   on the tensor cores with wgmma, Q/dO tiles fed by TMA from a producer
//   warpgroup, 128-row kv tiles; see its section below.
// - fp32: flash_bwd_kernel<float, D>, FlashAttention-2's schedule on the
//   CUDA cores in fp32.  The tensor cores take fp32 only as TF32, which
//   cannot hold the fp32 checks (1e-4 against the plain version, 1e-3 on
//   every gradient of the 28-layer model), so fp32 keeps the exact body.

#include <type_traits>

#include "hopper.cuh"

namespace {

// ------------------------------------------------------- dQ's order
//
// Every kv tile that sees a 64-row q tile adds its dQ partial sums into the
// same rows of the fp32 dq_acc.  The tiles add in the order of their index,
// from the q tile's first visible kv tile on, so the sums round the same
// way in every call.  A semaphore per (q head row, q tile), which the
// pre-pass zeroes, counts the kv tiles that have added: the CTA of kv tile
// j waits until it reads j - j0 (j0 = first_kv_tile), adds, and bumps it.
// A CTA draws its (kv head row, kv tile) as a ticket, one atomic at its
// start, in the grid's order; it waits only on CTAs that drew earlier
// tickets and so are running or done, so no wait can deadlock, whatever
// order the hardware starts CTAs in.  Every CTA walks its q tiles from the
// last one down, the GQA group's q heads inside: kv tiles that run side by
// side then reach a q tile at the same step, each just after the one
// before it, and a wait lasts about one add.  (Walking up, as before, kv
// tile 0 would reach the last q tiles last and hold every later tile.)
//
// The semaphores are int32 (BH, T + 1), T = ceil(Sq / 64) q tiles a head
// row; column T of a launch's first row is its ticket counter.  A wait
// that outlasts kWaitCycles traps: a fault, not a hang.

using bf16_t = bf16;

constexpr int kQTile = 64;                    // q rows a tile of dQ's order, both bodies
constexpr long long kWaitCycles = 1LL << 34;  // ~8.7 s at 1.98 GHz

__host__ __device__ __forceinline__ int q_tiles(int Sq) { return (Sq + kQTile - 1) / kQTile; }

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// The q tiles [lo, hi) whose rows see a key of kv tile j, rows [n j,
// min(n j + n, Skv)): causal, qpos >= the tile's first key; window, qpos -
// its last key < window.
struct QTiles {
  int lo, hi;
};
__device__ __forceinline__ QTiles visible_q_tiles(int j, int n, int Sq, int Skv, long long offset,
                                                  int causal, int window) {
  const long long k0 = static_cast<long long>(j) * n;
  const long long k_last = min(k0 + n, static_cast<long long>(Skv)) - 1;
  long long i_lo = 0;
  long long i_hi = Sq;
  if (causal) i_lo = max(0LL, k0 - offset);
  if (window > 0) i_hi = min(i_hi, k_last + window - offset);
  const int lo = static_cast<int>(i_lo / kQTile);
  return {lo, i_hi > i_lo ? static_cast<int>((i_hi + kQTile - 1) / kQTile) : lo};
}

// The first kv tile of n rows whose q tiles hold q tile qt: 0, or with a
// window the first whose last key lies past 64 qt + offset - window (the
// inverse of visible_q_tiles; the CPU tests hold the two together).
__device__ __forceinline__ int first_kv_tile(int qt, int n, long long offset, int window) {
  if (window <= 0) return 0;
  const long long x = static_cast<long long>(kQTile) * qt + offset - window;
  return static_cast<int>(max(0LL, floor_div(x - (n - 1), n) + 1));
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.global.acquire.gpu.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release_inc(int* p) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(1) : "memory");
}

// Spin until *sem >= turn.
__device__ __forceinline__ void wait_turn(const int* sem, int turn) {
  const long long t0 = clock64();
  while (ld_acquire(sem) < turn) {
    if (clock64() - t0 > kWaitCycles) __trap();
  }
}

// ------------------------------------------------------- the fp32 body
//
// One CTA per (64-row kv tile, kv head row): K and V of the tile in shared
// memory as padded fp32 rows (170 KB a CTA at d = 128, one CTA an SM), dK
// and dV in registers; each thread computes a 4 x 4 block of S and dP and
// an (rows x 4) block of dK, dV and dQ with fp32 FMAs, and dQ goes to the
// fp32 dq_acc with atomicAdd, one CTA at a time in dQ's order.  The
// pre-pass and the cast below serve both bodies.

constexpr int kBwdThreads = 256;
constexpr int kBwdRows = 64;  // kv rows a CTA, q rows a step
static_assert(kBwdRows == kQTile, "the fp32 body's q steps are dQ's q tiles");

template <typename T>
__device__ __forceinline__ float4 ld4(const T* p);
template <>
__device__ __forceinline__ float4 ld4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <>
__device__ __forceinline__ float4 ld4<bf16>(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T>
__device__ __forceinline__ void st4(T* p, float4 x);
template <>
__device__ __forceinline__ void st4<float>(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
template <>
__device__ __forceinline__ void st4<bf16>(bf16* p, float4 x) {
  uint2 u;
  u.x = pack_bf16(x.x, x.y);
  u.y = pack_bf16(x.z, x.w);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int D>
struct BwdSmem {
  static constexpr int kLdD = D + 4;          // a (64, D) tile's row, floats (16-byte rows, no conflicts)
  static constexpr int kLdT = kBwdRows + 4;   // a (64, 64) tile's row
  static constexpr int kTileD = kBwdRows * kLdD;
  static constexpr int kTileT = kBwdRows * kLdT;
  // K, V, Q, dO; P, dS; the q tile's lse and delta
  static constexpr int kFloats = 4 * kTileD + 2 * kTileT + 2 * kBwdRows;
  static constexpr int kBytes = kFloats * 4;
};

// Rows [row0, row0 + 64) of a (rows, D) matrix into a padded fp32 tile;
// rows past `rows` are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int row0, int rows) {
  constexpr int kChunks = D / 4;
  for (int ci = threadIdx.x; ci < kBwdRows * kChunks; ci += kBwdThreads) {
    const int r = ci / kChunks;
    const int c = ci % kChunks;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows) x = ld4(src + static_cast<size_t>(row0 + r) * D + 4 * c);
    *reinterpret_cast<float4*>(dst + r * BwdSmem<D>::kLdD + 4 * c) = x;
  }
}

// A q row's share of zeroing dQ's semaphores: the first row of a q tile
// zeroes the tile's, the first row of a head row its column T too (the
// ticket counter, in a launch's first row).
__device__ __forceinline__ void zero_semaphores(int* sems, long long bh, int i, int Sq) {
  if (i % kQTile) return;
  const int tiles = q_tiles(Sq);
  int* row = sems + bh * (tiles + 1);
  row[i / kQTile] = 0;
  if (i == 0) row[tiles] = 0;
}

// The pre-pass: delta[row] = sum_d dO[row, d] o[row, d] (fp32), the row of
// dq_acc and dQ's semaphores zeroed.  One warp a row, eight rows a CTA.
template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_pre_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                     float* __restrict__ delta, float* __restrict__ dq_acc, int* __restrict__ sems,
                     int Sq, long long rows) {
  const long long row = static_cast<long long>(blockIdx.x) * (kBwdThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // uniform across the warp
  if (lane == 0) zero_semaphores(sems, row / Sq, static_cast<int>(row % Sq), Sq);
  float sum = 0.f;
  for (int c = lane; c < D / 4; c += 32) {
    const size_t off = static_cast<size_t>(row) * D + 4 * c;
    sum = dot4(ld4(o + off), ld4(dout + off), sum);
    *reinterpret_cast<float4*>(dq_acc + off) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, s);
  if (lane == 0) delta[row] = sum;
}


// The main kernel.  Thread layouts (256 threads):
// - S and dP, (64 q, 64 kv): ty = tid / 16 and tx = tid % 16 own rows
//   ty + 16 i and columns tx + 16 j (i, j < 4);
// - dK, dV (64 kv, D) and dQ (64 q, D): td = tid % (D / 4) owns columns
//   4 td .. 4 td + 3 and tc = tid / (D / 4) the kRows rows tc kRows + i.
template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq_acc,
                 int* __restrict__ sems, T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv,
                 int group, int causal, int window, float scale) {
  using M = BwdSmem<D>;
  constexpr int kLdD = M::kLdD;
  constexpr int kLdT = M::kLdT;
  constexpr int kTd = D / 4;                       // threads along d
  constexpr int kRows = kBwdRows * kTd / kBwdThreads;  // rows of dK/dV/dQ a thread
  static_assert(kRows >= 1 && kBwdThreads % kTd == 0, "head dim out of range");
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + M::kTileD;
  float* qs = vs + M::kTileD;
  float* dos = qs + M::kTileD;
  float* ps = dos + M::kTileD;
  float* dss = ps + M::kTileT;
  float* lse_s = dss + M::kTileT;
  float* del_s = lse_s + kBwdRows;

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int td = tid % kTd;
  const int tc = tid / kTd;
  const int tiles = q_tiles(Sq);
  // The ticket, in the grid's order (kv tile fastest): a kv head row's
  // tiles draw in the order in which they add dQ.
  __shared__ int ticket;
  if (tid == 0) ticket = atomicAdd(sems + tiles, 1);
  __syncthreads();
  const int kv_tile = ticket % gridDim.x;
  const int k0 = kv_tile * kBwdRows;
  const int hk = ticket / gridDim.x;
  const long long offset = static_cast<long long>(Skv) - Sq;  // q sits at the end of kv

  load_rows<T, D>(ks, k + static_cast<size_t>(hk) * Skv * D, k0, Skv);
  load_rows<T, D>(vs, v + static_cast<size_t>(hk) * Skv * D, k0, Skv);
  const QTiles qts = visible_q_tiles(kv_tile, kBwdRows, Sq, Skv, offset, causal, window);

  float dk_acc[kRows][4];
  float dv_acc[kRows][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
  }

  for (int qt = qts.hi - 1; qt >= qts.lo; --qt) {
    for (int h = 0; h < group; ++h) {
      const int bh = hk * group + h;
      const size_t row_base = static_cast<size_t>(bh) * Sq;
      const int q0 = qt * kBwdRows;
      __syncthreads();  // the previous step's products are done with Q, dO, P, dS
      load_rows<T, D>(qs, q + row_base * D, q0, Sq);
      load_rows<T, D>(dos, dout + row_base * D, q0, Sq);
      if (tid < kBwdRows) {
        const bool in = q0 + tid < Sq;
        lse_s[tid] = in ? lse[row_base + q0 + tid] : 0.f;
        del_s[tid] = in ? delta[row_base + q0 + tid] : 0.f;
      }
      __syncthreads();

      // S = Q K^T and dP = dO V^T, then P and dS into shared memory.
      float s[4][4];
      float dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
      }
#pragma unroll 4
      for (int c = 0; c < D; c += 4) {
        float4 a[4], b[4], da[4], vb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * kLdD + c);
          da[i] = *reinterpret_cast<const float4*>(dos + (ty + 16 * i) * kLdD + c);
          b[i] = *reinterpret_cast<const float4*>(ks + (tx + 16 * i) * kLdD + c);
          vb[i] = *reinterpret_cast<const float4*>(vs + (tx + 16 * i) * kLdD + c);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = dot4(a[i], b[j], s[i][j]);
            dp[i][j] = dot4(da[i], vb[j], dp[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const long long qpos = q0 + r + offset;
        const bool row_live = q0 + r < Sq;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const long long kpos = k0 + c;
          bool vis = row_live && kpos < Skv;
          if (causal) vis = vis && kpos <= qpos;
          if (window > 0) vis = vis && qpos - kpos < window;
          const float p = vis ? expf(fmaf(s[i][j], scale, -lse_s[r])) : 0.f;
          ps[r * kLdT + c] = p;
          dss[r * kLdT + c] = p * (dp[i][j] - del_s[r]) * scale;
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q over the tile's q rows.
      for (int r = 0; r < kBwdRows; ++r) {
        const float4 dov = *reinterpret_cast<const float4*>(dos + r * kLdD + 4 * td);
        const float4 qv = *reinterpret_cast<const float4*>(qs + r * kLdD + 4 * td);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = ps[r * kLdT + tc * kRows + i];
          const float ds = dss[r * kLdT + tc * kRows + i];
          dv_acc[i][0] = fmaf(p, dov.x, dv_acc[i][0]);
          dv_acc[i][1] = fmaf(p, dov.y, dv_acc[i][1]);
          dv_acc[i][2] = fmaf(p, dov.z, dv_acc[i][2]);
          dv_acc[i][3] = fmaf(p, dov.w, dv_acc[i][3]);
          dk_acc[i][0] = fmaf(ds, qv.x, dk_acc[i][0]);
          dk_acc[i][1] = fmaf(ds, qv.y, dk_acc[i][1]);
          dk_acc[i][2] = fmaf(ds, qv.z, dk_acc[i][2]);
          dk_acc[i][3] = fmaf(ds, qv.w, dk_acc[i][3]);
        }
      }
      // dQ += dS K over the tile's kv rows, added to dq_acc.
      float dq[kRows][4];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) dq[i][j] = 0.f;
      }
      for (int c = 0; c < kBwdRows; ++c) {
        const float4 kv = *reinterpret_cast<const float4*>(ks + c * kLdD + 4 * td);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float ds = dss[(tc * kRows + i) * kLdT + c];
          dq[i][0] = fmaf(ds, kv.x, dq[i][0]);
          dq[i][1] = fmaf(ds, kv.y, dq[i][1]);
          dq[i][2] = fmaf(ds, kv.z, dq[i][2]);
          dq[i][3] = fmaf(ds, kv.w, dq[i][3]);
        }
      }
      // dQ's turn (one thread waits for it), the adds, then every add
      // visible before the semaphore moves on.
      int* sem = sems + static_cast<size_t>(bh) * (tiles + 1) + qt;
      if (tid == 0) wait_turn(sem, kv_tile - first_kv_tile(qt, kBwdRows, offset, window));
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = q0 + tc * kRows + i;
        if (r >= Sq) continue;
        float* dst = dq_acc + (row_base + r) * D + 4 * td;
#pragma unroll
        for (int c = 0; c < 4; ++c) atomicAdd(dst + c, dq[i][c]);
      }
      __threadfence();
      __syncthreads();
      if (tid == 0) red_release_inc(sem);
    }
  }

  // dK and dV of the tile's rows (zeros where no q row sees a key).
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int c = k0 + tc * kRows + i;
    if (c >= Skv) continue;
    const size_t off = (static_cast<size_t>(hk) * Skv + c) * D + 4 * td;
    st4(dk + off, make_float4(dk_acc[i][0], dk_acc[i][1], dk_acc[i][2], dk_acc[i][3]));
    st4(dv + off, make_float4(dv_acc[i][0], dv_acc[i][1], dv_acc[i][2], dv_acc[i][3]));
  }
}

// ------------------------------------------------------- the bf16 body
//
// Warp-specialised, tensor-core backward for Hopper, on FlashAttention-3's
// schedule.  A CTA owns kBwdN = 128 kv rows of one kv head row and runs
// three warpgroups: two consumer warpgroups of 64 kv rows each and one
// producer warpgroup, of which one thread issues every TMA copy.  Shared
// memory holds the K and V tiles (loaded once), a ring of kBwdStages Q and
// dO tiles of kBwdM = 64 q rows with their rows' lse and delta, and two
// dS^T tiles (161 KiB at d = 128).  Per q tile a consumer warpgroup
// computes, on the tensor cores with fp32 accumulators:
//
//   S^T = K Q^T and dP^T = V dO^T      (m64n64k16; both operands K-major
//                                       in shared memory, as the forward's S)
//   P^T = 2^(S^T scale log2 e - lse log2 e), dS^T = P^T o (dP^T - delta) scale
//                                      (registers; P^T = 0 where masked and
//                                       for a row whose lse is -inf)
//   dV += P^T dO and dK += dS^T Q      (m64nDk16; P^T and dS^T packed to
//                                       bf16 in registers as the A operand,
//                                       dO and Q MN-major through the
//                                       transpose bit, as the forward's V)
//   dQ = dS K                          (A = dS^T from shared memory, B = K,
//                                       both MN-major; at d = 128 each
//                                       warpgroup takes one 64-column half
//                                       of d, below that the warpgroups
//                                       take turns, a q tile each)
//
// and stores dQ's fp32 partial sums into one of two shared tiles, which one
// warp of the producer warpgroup, the dQ writer, adds into dq_acc with one
// bulk reduction (cp.reduce.async.bulk .add.f32) once the q tile's
// semaphore gives this kv tile its turn (dQ's order above): the consumers
// never wait on another CTA, only, two q tiles later, for the writer to
// have read the tile.  dK and dV stay in registers across the GQA
// group's q heads and their q tiles; they are stored once, with no atomics.
// The producer's ring lets the next tile's Q, dO, lse and delta land while
// this one is computed.  The two consumer warpgroups meet once a q tile,
// when both halves of dS^T are stored, so they run in step: the tensor
// cores wait while both compute P and dS, which overlaps only the wgmma
// in flight (dP while P is computed, dV and dK while dS^T is stored).
// Issuing dV before computing dS, or a third ring stage, measured within
// the spread of this schedule, which was kept as the simpler.  P and dS are
// rounded to bf16 before their products, as the tensor cores take them;
// the plain version keeps them in fp32.

constexpr int kBwdN = 128;              // kv rows a CTA
constexpr int kBwdM = 64;               // q rows a step
constexpr int kBwdStages = 2;           // Q/dO ring depth
constexpr int kBwdProducerRegs = 40;    // setmaxnreg: 128 x 40 + 256 x 232 = 384 x 168
constexpr int kBwdConsumerRegs = 232;
// Named barriers (0 is __syncthreads, 1 the consumers' dS^T): shared dQ
// tile b free (+ b) and full (+ b), b = step % 2 (below d = 128 also the
// warpgroup that computes the step's dQ).
constexpr int kBarDqFree = 2;
constexpr int kBarDqFull = 4;

template <int D>
struct BwdBf16Smem {
  static constexpr int kKV = kBwdN * D * 2;      // the K or V tile
  static constexpr int kQ = kBwdM * D * 2;       // a Q or dO tile
  static constexpr int kDs = kBwdN * kBwdM * 2;  // a dS^T tile: (kv, q) bf16, 128-byte rows
  static constexpr int kRow = kBwdM * 4;         // a q tile's lse term or delta
  static constexpr int kStageTx = 2 * kQ + 2 * kRow;  // bytes TMA lands a stage
  static constexpr int kK = 0;
  static constexpr int kV = kKV;
  static constexpr int kQs = 2 * kKV;                   // + s * kQ
  static constexpr int kDOs = kQs + kBwdStages * kQ;    // + s * kQ
  static constexpr int kDS = kDOs + kBwdStages * kQ;    // + b * kDs
  static constexpr int kLse = kDS + 2 * kDs;            // + s * kRow
  static constexpr int kDelta = kLse + kBwdStages * kRow;
  // two of dQ's fp32 tiles, each as dq_acc holds it (dq_tile_col)
  static constexpr int kDqTile = kBwdM * D * 4;
  static constexpr int kDq = kDelta + kBwdStages * kRow;  // + b * kDqTile
  // then the mbarriers: K/V landed, and per stage landed and released
  static constexpr int kBarriers = kDq + 2 * kDqTile;
  static constexpr int kBytes = kBarriers + 8 * (1 + 2 * kBwdStages) + 1024;  // + alignment slack
};
static_assert(BwdBf16Smem<128>::kBytes + 64 <= 232448,
              "the bf16 body's shared memory (and its ticket) past what a CTA can opt in to");

// The bf16 body's dq_acc: (BH, Sq64, D) fp32, every 64-row q tile of a
// head row contiguous, as the dQ writer adds it with one bulk reduction,
// and within a row each 8-float chunk c stored at c ^ (row & 7) (fewer
// where the row has fewer chunks): the consumers' stores of their
// fragments then hit every bank once.  The cast reads it back.
template <int D>
__host__ __device__ __forceinline__ int dq_tile_col(int row, int col) {
  constexpr int kMask = D / 8 - 1 < 7 ? D / 8 - 1 : 7;
  return ((col / 8) ^ (row & kMask)) * 8 + col % 8;
}

// dq = dq_acc in bf16, four elements a thread, from the tile layout.
template <int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_cast_bf16_kernel(const float* __restrict__ acc, bf16* __restrict__ out, int Sq,
                           long long n4) {
  const long long i = static_cast<long long>(blockIdx.x) * kBwdThreads + threadIdx.x;
  if (i >= n4) return;
  const long long row = i / (D / 4);  // bh Sq + s
  const int s = static_cast<int>(row % Sq);
  const int col = 4 * static_cast<int>(i % (D / 4));
  const long long src = ((row / Sq) * (q_tiles(Sq) * kQTile) + s) * D + dq_tile_col<D>(s, col);
  st4(out + 4 * i, *reinterpret_cast<const float4*>(acc + src));
}

// The bf16 body's pre-pass: per q row of a head padded to a multiple of
// kBwdM rows, delta (as flash_bwd_pre_kernel's) and the row's lse term in
// log2 units, -lse log2 e, or -inf for a row that sees no key and for the
// padding rows (their P is then exactly 0); dq_acc's rows, the padding's
// too, and dQ's semaphores zeroed.  The main kernel's TMA boxes of these
// then start on a 64-value boundary.
template <int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_pre_bf16_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, float* __restrict__ delta_p,
                          float* __restrict__ nlse_p, float* __restrict__ dq_acc,
                          int* __restrict__ sems, int Sq, long long rows_p) {
  const long long row_p = static_cast<long long>(blockIdx.x) * (kBwdThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row_p >= rows_p) return;  // uniform across the warp
  const int sq_p = (Sq + kBwdM - 1) / kBwdM * kBwdM;
  const long long bh = row_p / sq_p;
  const int i = static_cast<int>(row_p % sq_p);
  if (lane == 0 && i < Sq) zero_semaphores(sems, bh, i, Sq);
  for (int c = lane; c < D / 4; c += 32) {
    *reinterpret_cast<float4*>(dq_acc + static_cast<size_t>(row_p) * D + 4 * c) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (i >= Sq) {
    if (lane == 0) {
      delta_p[row_p] = 0.f;
      nlse_p[row_p] = -INFINITY;
    }
    return;
  }
  const long long row = bh * Sq + i;
  float sum = 0.f;
  for (int c = lane; c < D / 4; c += 32) {
    const size_t off = static_cast<size_t>(row) * D + 4 * c;
    sum = dot4(ld4(o + off), ld4(dout + off), sum);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, s);
  if (lane == 0) {
    const float l = lse[row];
    delta_p[row_p] = sum;
    nlse_p[row_p] = l == -INFINITY ? -INFINITY : -l * kLog2e;
  }
}

// Whether every (kv row, q row) pair of kv rows [k0, k0 + 64) and q rows
// [q0, q0 + 64) is visible, so the tile pair needs no element mask (rows
// past Sq are handled by their lse).
__device__ __forceinline__ bool pair_is_full(int k0, int q0, long long offset, int Skv, int causal,
                                             int window) {
  if (k0 + 64 > Skv) return false;
  if (causal && k0 + 63 > q0 + offset) return false;
  if (window > 0 && q0 + 63 + offset - k0 >= window) return false;
  return true;
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// dst[0, bytes / 4) += src's floats, by the bulk-copy engine.
__device__ __forceinline__ void bulk_reduce_add(float* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
               ::"l"(dst), "r"(src), "r"(bytes) : "memory");
}

template <int D>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_bwd_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tnlse,
                      const __grid_constant__ CUtensorMap tdelta, float* __restrict__ dq_acc,
                      int* __restrict__ sems, bf16* __restrict__ dk, bf16* __restrict__ dv,
                      int Sq, int Skv, int group, int causal, int window, float scale, float sl2) {
  using L = Layout<D>;
  using M = BwdBf16Smem<D>;
  constexpr int kDqCols = D == 128 ? 64 : D;  // dQ columns a warpgroup computes
  // a q tile's dQ: the warpgroups that compute it and the writer warp
  constexpr int kDqThreads = (D == 128 ? 2 : 1) * kWarpgroup + 32;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);  // the same bytes, generic address
  const uint32_t sk = base + M::kK;
  const uint32_t sv = base + M::kV;
  const uint32_t kv_full = base + M::kBarriers;
  const uint32_t full = kv_full + 8;                // + 8 s
  const uint32_t released = full + 8 * kBwdStages;  // + 8 s
  const int tiles = q_tiles(Sq);

  __shared__ int ticket;
  if (threadIdx.x == 0) {
    // Under a causal mask the first kv tiles are seen by the most q rows:
    // the tile is the ticket's slow digit, so they start first.
    ticket = atomicAdd(sems + tiles, 1);
    mbar_init(kv_full, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(released + 8 * s, 2 * kWarpgroup / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int hk = ticket % gridDim.x;
  const int kv_tile = ticket / gridDim.x;
  const int k0 = kv_tile * kBwdN;
  const long long offset = static_cast<long long>(Skv) - Sq;  // q sits at the end of kv
  // Step i: q tile qts.hi - 1 - i / group (the last first), q head i % group.
  const QTiles qts = visible_q_tiles(kv_tile, kBwdN, Sq, Skv, offset, causal, window);
  const int n_iter = group * (qts.hi - qts.lo);
  const int sq_p = tiles * kBwdM;  // the pre-pass's padded rows a head

  const int wg = threadIdx.x / kWarpgroup;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kBwdProducerRegs));
    const int warp = threadIdx.x / 32 - 2 * kWarpgroup / 32;
    const int lane = threadIdx.x % 32;
    if (warp == 0 && lane == 0 && n_iter > 0) {
      // Producer: K and V once, then step i's Q, dO, lse and delta into
      // stage i % kBwdStages once the consumers have released its previous use.
      mbar_expect_tx(kv_full, 2 * M::kKV);
      tma_tile<D>(sk, &tk, kv_full, kBwdN, k0, hk);
      tma_tile<D>(sv, &tv, kv_full, kBwdN, k0, hk);
      for (int i = 0; i < n_iter; ++i) {
        const int s = i % kBwdStages;
        const int bh = hk * group + i % group;
        const int q0 = (qts.hi - 1 - i / group) * kBwdM;
        if (i >= kBwdStages) mbar_wait(released + 8 * s, (i / kBwdStages + 1) & 1);
        const uint32_t bar = full + 8 * s;
        mbar_expect_tx(bar, M::kStageTx);
        tma_tile<D>(base + M::kQs + s * M::kQ, &tq, bar, kBwdM, q0, bh);
        tma_tile<D>(base + M::kDOs + s * M::kQ, &tdo, bar, kBwdM, q0, bh);
        tma_load_1d(base + M::kLse + s * M::kRow, &tnlse, bar, bh * sq_p + q0);
        tma_load_1d(base + M::kDelta + s * M::kRow, &tdelta, bar, bh * sq_p + q0);
      }
    } else if (warp == 1 && n_iter > 0) {
      // The dQ writer: step i's dQ tile (shared tile i % 2), once this kv
      // tile has its turn at the q tile's semaphore (waited for while the
      // consumers compute) and its warpgroups have stored it, added into
      // dq_acc with one bulk reduction; the shared tile free again for
      // step i + 2 once read, the semaphore bumped once the additions are
      // done.  Lane 0 does the work, the warp meets the barriers.
      named_arrive(kBarDqFree, kDqThreads);  // both tiles start free
      if (n_iter > 1) named_arrive(kBarDqFree + 1, kDqThreads);
      for (int i = 0; i < n_iter; ++i) {
        const int b = i & 1;
        const int bh = hk * group + i % group;
        const int qt = qts.hi - 1 - i / group;
        int* sem = sems + static_cast<size_t>(bh) * (tiles + 1) + qt;
        if (lane == 0) wait_turn(sem, kv_tile - first_kv_tile(qt, kBwdN, offset, window));
        __syncwarp();
        named_sync(kBarDqFull + b, kDqThreads);
        if (lane == 0) {
          asm volatile("fence.proxy.async.global;\n" ::: "memory");
          bulk_reduce_add(dq_acc + (static_cast<size_t>(bh) * sq_p + qt * kBwdM) * D,
                          base + M::kDq + b * M::kDqTile, M::kDqTile);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        }
        __syncwarp();
        if (i + 2 < n_iter) named_arrive(kBarDqFree + b, kDqThreads);
        if (lane == 0) {
          asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
          asm volatile("fence.proxy.async.global;\n" ::: "memory");
          red_release_inc(sem);
        }
        __syncwarp();
      }
    }
    return;
  }

  // Consumers.  Thread t of warpgroup wg holds, of every 64-row product,
  // rows r and r + 8 (r = 16 (t / 32) + (t % 32) / 4) and of each 8-column
  // chunk j the columns 8 j + 2 quad + {0, 1} (hopper.cuh's fragment
  // layout): kv rows 64 wg + r (+ 8) of dK, dV, S^T, dP^T, q columns of
  // S^T and dP^T, q rows of dQ.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kBwdConsumerRegs));
  const int t = threadIdx.x % kWarpgroup;
  const int lane = t % 32;
  const int quad = lane % 4;
  const int r = 16 * (t / 32) + lane / 4;
  const int kw = k0 + 64 * wg;  // this warpgroup's first kv row
  const uint32_t k_wg = sk + 64 * wg * L::kRowBytes;
  const uint32_t v_wg = sv + 64 * wg * L::kRowBytes;
  float dk_acc[D / 2];
  float dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  if (n_iter > 0) mbar_wait(kv_full, 0);
  __syncwarp();

  for (int it = 0; it < n_iter; ++it) {
    const int s = it % kBwdStages;
    const int q0 = (qts.hi - 1 - it / group) * kBwdM;
    const uint32_t sq = base + M::kQs + s * M::kQ;
    const uint32_t sdo = base + M::kDOs + s * M::kQ;
    const float* nlse_s = reinterpret_cast<const float*>(gbase + M::kLse + s * M::kRow);
    const float* delta_s = reinterpret_cast<const float*>(gbase + M::kDelta + s * M::kRow);
    mbar_wait(full + 8 * s, (it / kBwdStages) & 1);
    __syncwarp();  // wgmma is .aligned: the warp must be converged

    // S^T and dP^T, one commit group each.
    float st[kBwdM / 2];
    float dpt[kBwdM / 2];
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<kBwdM>(st, kmajor_desc<D>(k_wg, kBwdN, kk), kmajor_desc<D>(sq, kBwdM, kk), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<kBwdM>(dpt, kmajor_desc<D>(v_wg, kBwdN, kk), kmajor_desc<D>(sdo, kBwdM, kk), kk > 0);
    }
    wgmma_commit();

    // P^T in place of S^T.  Column c (q row q0 + c) adds its lse term,
    // -lse log2 e, which the pre-pass made -inf for a row past Sq or one
    // that sees no key (lse = -inf): their P is exactly 0.
    wgmma_wait<1>();
    fence_regs(st);
    const bool full_pair = pair_is_full(kw, q0, offset, Skv, causal, window);
#pragma unroll
    for (int j = 0; j < kBwdM / 8; ++j) {
      const int c = 8 * j + 2 * quad;
      const float2 nl2 = *reinterpret_cast<const float2*>(nlse_s + c);
      const float nl[2] = {nl2.x, nl2.y};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          float p = exp2_approx(fmaf(st[i], sl2, nl[e]));
          if (!full_pair) {
            const long long kpos = kw + r + 8 * h;
            const long long qpos = q0 + c + e + offset;
            bool vis = kpos < Skv;
            if (causal) vis = vis && kpos <= qpos;
            if (window > 0) vis = vis && qpos - kpos < window;
            p = vis ? p : 0.f;
          }
          st[i] = p;
        }
      }
    }
    // dS^T = P^T o (dP^T - delta) scale in place of dP^T.
    wgmma_wait<0>();
    fence_regs(dpt);
#pragma unroll
    for (int j = 0; j < kBwdM / 8; ++j) {
      const float2 del = *reinterpret_cast<const float2*>(delta_s + 8 * j + 2 * quad);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        dpt[4 * j + 2 * h] = st[4 * j + 2 * h] * (dpt[4 * j + 2 * h] - del.x) * scale;
        dpt[4 * j + 2 * h + 1] = st[4 * j + 2 * h + 1] * (dpt[4 * j + 2 * h + 1] - del.y) * scale;
      }
    }
    // Both packed to bf16 as A fragments: the accumulator layout is the A
    // operand's, k16 slice kk = columns 16 kk .. 16 kk + 15.
    uint32_t pf[kBwdM / 16][4];
    uint32_t dsf[kBwdM / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBwdM / 16; ++kk) {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        pf[kk][w] = pack_bf16(st[8 * kk + 2 * w], st[8 * kk + 2 * w + 1]);
        dsf[kk][w] = pack_bf16(dpt[8 * kk + 2 * w], dpt[8 * kk + 2 * w + 1]);
      }
    }

    // dV += P^T dO and dK += dS^T Q: one commit group.
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBwdM / 16; ++kk) {
      wgmma_rs<D>(dv_acc, pf[kk], mnmajor_desc<D>(sdo, kBwdM, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < kBwdM / 16; ++kk) {
      wgmma_rs<D>(dk_acc, dsf[kk], mnmajor_desc<D>(sq, kBwdM, kk), 1);
    }
    wgmma_commit();

    // dS^T into shared memory while they run: tile it % 2, kv row 64 wg +
    // r (+ 8), 128 bytes of q a row in 16-byte chunks swizzled by the row
    // (the 128-byte swizzle mnmajor_desc<64> describes).  dsf[kk][w] holds
    // row r + 8 (w % 2), columns 16 kk + 8 (w / 2) + 2 quad + {0, 1}.
    const uint32_t sds = base + M::kDS + (it & 1) * M::kDs;
#pragma unroll
    for (int kk = 0; kk < kBwdM / 16; ++kk) {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int row = 64 * wg + r + 8 * (w % 2);
        const int chunk = 2 * kk + w / 2;
        const uint32_t addr = sds + row * 128 + ((chunk ^ (row & 7)) << 4) + 4 * quad;
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(dsf[kk][w]) : "memory");
      }
    }
    // Visible to wgmma (the async proxy), then both warpgroups' halves.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(2 * kWarpgroup) : "memory");

    // dQ = dS K: rows q0 .. q0 + 63, this warpgroup's columns.
    const bool does_dq = D == 128 || (it & 1) == wg;
    float dq[kDqCols / 2];
    if (does_dq) {
      const uint32_t kb = sk + (D == 128 ? wg * kBwdN * L::kRowBytes : 0);
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBwdN / 16; ++kk) {
        wgmma_ss<kDqCols, 1, 1>(dq, mnmajor_desc<64>(sds, kBwdN, kk), mnmajor_desc<D>(kb, kBwdN, kk),
                                kk > 0);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(pf);
    fence_regs(dsf);
    if (does_dq) fence_regs(dq);
    // Q and dO of the stage are read: release it.
    __syncwarp();
    if (lane == 0) mbar_arrive(released + 8 * s);
    if (does_dq) {
      // Into shared tile it % 2 in dq_acc's layout, once the writer has read
      // its step it - 2, then visible to the writer's bulk reduction (the
      // async proxy); rows past Sq hold zeros.
      const int b = it & 1;
      named_sync(kBarDqFree + b, kDqThreads);
      float* sdq = reinterpret_cast<float*>(gbase + M::kDq + b * M::kDqTile);
      const int col0 = (D == 128 ? 64 * wg : 0) + 2 * quad;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r + 8 * h;
#pragma unroll
        for (int j = 0; j < kDqCols / 8; ++j) {
          *reinterpret_cast<float2*>(sdq + row * D + dq_tile_col<D>(row, col0 + 8 * j)) =
              make_float2(dq[4 * j + 2 * h], dq[4 * j + 2 * h + 1]);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_arrive(kBarDqFull + b, kDqThreads);
    }
    __syncwarp();
  }

  // dK and dV of this warpgroup's kv rows (zeros where no q row sees a key).
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = kw + r + 8 * h;
    if (row >= Skv) continue;
    const size_t off = (static_cast<size_t>(hk) * Skv + row) * D + 2 * quad;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * j) = pack_bf16(dk_acc[4 * j + 2 * h], dk_acc[4 * j + 2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * j) = pack_bf16(dv_acc[4 * j + 2 * h], dv_acc[4 * j + 2 * h + 1]);
    }
  }
}

// ------------------------------------------------------------- host side
struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  void *dq, *dk, *dv;
  float* dq_acc;
  float* delta;
  int* sems;
  int BH, BHkv, Sq, Skv, causal, window;
  float scale;
  int stages;  // kStagePre | kStageMain | kStageCast: which of the kernels to launch
  cudaStream_t stream;
};

constexpr int kStagePre = 1, kStageMain = 2, kStageCast = 4;


// The bf16 pre-pass's rows: every head's Sq rows padded to kBwdM.
long long padded_rows(const BwdArgs& a) {
  return static_cast<long long>(a.BH) * ((a.Sq + kBwdM - 1) / kBwdM * kBwdM);
}

template <int D>
cudaError_t launch_bwd_bf16_main(const BwdArgs& a) {
  using M = BwdBf16Smem<D>;
  CUtensorMap tq, tk, tv, tdo, tnlse, tdelta;
  const long long rows_p = padded_rows(a);
  if (!encode_rows<D>(&tq, a.q, a.Sq, a.BH, kBwdM) ||
      !encode_rows<D>(&tdo, a.dout, a.Sq, a.BH, kBwdM) ||
      !encode_rows<D>(&tk, a.k, a.Skv, a.BHkv, kBwdN) ||
      !encode_rows<D>(&tv, a.v, a.Skv, a.BHkv, kBwdN) ||
      !encode_vector(&tnlse, a.delta + rows_p, rows_p, kBwdM) ||
      !encode_vector(&tdelta, a.delta, rows_p, kBwdM)) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t e =
      allow_smem(reinterpret_cast<const void*>(&flash_bwd_bf16_kernel<D>), M::kBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.BHkv, (a.Skv + kBwdN - 1) / kBwdN);
  flash_bwd_bf16_kernel<D><<<grid, kBf16Threads, M::kBytes, a.stream>>>(
      tq, tk, tv, tdo, tnlse, tdelta, a.dq_acc, a.sems, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.Sq, a.Skv, a.BH / a.BHkv, a.causal, a.window, a.scale, a.scale * kLog2e);
  return cudaGetLastError();
}

template <typename T, int D>
int launch_bwd(const BwdArgs& a) {
  const long long rows = static_cast<long long>(a.BH) * a.Sq;
  constexpr int kRowsPerCta = kBwdThreads / 32;
  if (a.stages & kStagePre) {
    if constexpr (std::is_same_v<T, float>) {
      flash_bwd_pre_kernel<T, D><<<static_cast<unsigned>((rows + kRowsPerCta - 1) / kRowsPerCta),
                                   kBwdThreads, 0, a.stream>>>(
          static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta, a.dq_acc, a.sems,
          a.Sq, rows);
    } else {
      const long long rows_p = padded_rows(a);
      flash_bwd_pre_bf16_kernel<D>
          <<<static_cast<unsigned>((rows_p + kRowsPerCta - 1) / kRowsPerCta), kBwdThreads, 0,
             a.stream>>>(static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dout), a.lse,
                         a.delta, a.delta + rows_p, a.dq_acc, a.sems, a.Sq, rows_p);
    }
  } else if (a.stages & kStageMain) {
    // the main kernel alone: its semaphores zeroed as the pre-pass does
    const size_t sem_bytes = static_cast<size_t>(a.BH) * (q_tiles(a.Sq) + 1) * sizeof(int);
    const cudaError_t m = cudaMemsetAsync(a.sems, 0, sem_bytes, a.stream);
    if (m != cudaSuccess) return static_cast<int>(m);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if ((a.stages & kStageMain) && a.Skv > 0) {
    if constexpr (std::is_same_v<T, float>) {
      e = allow_smem(reinterpret_cast<const void*>(&flash_bwd_kernel<T, D>), BwdSmem<D>::kBytes);
      if (e != cudaSuccess) return static_cast<int>(e);
      const dim3 grid((a.Skv + kBwdRows - 1) / kBwdRows, a.BHkv);
      flash_bwd_kernel<T, D><<<grid, kBwdThreads, BwdSmem<D>::kBytes, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
          static_cast<const T*>(a.dout), a.lse, a.delta, a.dq_acc, a.sems, static_cast<T*>(a.dk),
          static_cast<T*>(a.dv), a.Sq, a.Skv, a.BH / a.BHkv, a.causal, a.window, a.scale);
      e = cudaGetLastError();
    } else {
      e = launch_bwd_bf16_main<D>(a);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if constexpr (!std::is_same_v<T, float>) {  // fp32 accumulates in dq itself
    if (a.stages & kStageCast) {
      const long long n4 = rows * D / 4;
      flash_bwd_cast_bf16_kernel<D><<<static_cast<unsigned>((n4 + kBwdThreads - 1) / kBwdThreads),
                                      kBwdThreads, 0, a.stream>>>(a.dq_acc, static_cast<bf16*>(a.dq),
                                                                  a.Sq, n4);
      e = cudaGetLastError();
    }
  }
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

// K5's backward.  q, k, v, o, dout, dq, dk, dv as the forward's q, k, v, o
// (dout and dq shaped as o, dk and dv as k), all of one dtype; lse the
// forward's (BH, Sq) fp32 output; dq_acc fp32 scratch: in fp32 dq itself,
// in bf16 (BH, Sq64, d) in the bf16 body's tile layout (dq_tile_col);
// delta fp32 scratch of 2 BH Sq64 values,
// Sq64 = Sq rounded up to a multiple of 64 (the fp32 body uses the first BH
// Sq), and sems int32 scratch of BH (Sq64 / 64 + 1) values (dQ's
// semaphores and the launch's ticket counter); all but sems 16-byte
// aligned, BH Sq64 below 2^31.  Three kernels on the stream: the pre-pass (delta, dq_acc and
// sems zeroed; bf16: flash_bwd_pre_bf16_kernel<D>, which also writes each
// row's lse term), the main kernel (bf16: flash_bwd_bf16_kernel<D>, fp32:
// flash_bwd_kernel<float, D>), and in bf16 the cast of dq_acc into dq.
// stages is a mask of them (1 pre-pass, 2 main kernel, 4 cast): a call
// launches those its bits name, 7 all three; one kernel alone can be timed
// on the scratch a full call left (the main kernel without the pre-pass
// zeroes sems first, with a memset on the stream).
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const void* lse, void* dq, void* dk, void* dv,
                        void* dq_acc, void* delta, void* sems, int BH, int BHkv, int Sq, int Skv,
                        int d, int bf16, int causal, int window, float scale, int stages,
                        void* stream) {
  if (BH <= 0 || BHkv <= 0 || BH % BHkv != 0 || Sq <= 0 || Skv < 0 || stages <= 0 ||
      stages > (kStagePre | kStageMain | kStageCast) ||
      static_cast<long long>(BH) * ((Sq + kBwdM - 1) / kBwdM * kBwdM) > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdArgs a{q, k, v, o, dout, static_cast<const float*>(lse), dq, dk, dv,
                  static_cast<float*>(dq_acc), static_cast<float*>(delta), static_cast<int*>(sems),
                  BH, BHkv, Sq, Skv,
                  causal, window, scale, stages, static_cast<cudaStream_t>(stream)};
  switch (d) {
    case 16: return bf16 ? launch_bwd<bf16_t, 16>(a) : launch_bwd<float, 16>(a);
    case 32: return bf16 ? launch_bwd<bf16_t, 32>(a) : launch_bwd<float, 32>(a);
    case 64: return bf16 ? launch_bwd<bf16_t, 64>(a) : launch_bwd<float, 64>(a);
    case 128: return bf16 ? launch_bwd<bf16_t, 128>(a) : launch_bwd<float, 128>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of one CTA of the backward's fp32 main kernel at
// head dim d (-1 for a d it has no instantiation of).
int flash_bwd_smem_bytes(int d) {
  switch (d) {
    case 16: return BwdSmem<16>::kBytes;
    case 32: return BwdSmem<32>::kBytes;
    case 64: return BwdSmem<64>::kBytes;
    case 128: return BwdSmem<128>::kBytes;
    default: return -1;
  }
}

// The same for the bf16 main kernel, flash_bwd_bf16_kernel<D>.
int flash_bwd_bf16_smem_bytes(int d) {
  switch (d) {
    case 16: return BwdBf16Smem<16>::kBytes;
    case 32: return BwdBf16Smem<32>::kBytes;
    case 64: return BwdBf16Smem<64>::kBytes;
    case 128: return BwdBf16Smem<128>::kBytes;
    default: return -1;
  }
}

}  // extern "C"
