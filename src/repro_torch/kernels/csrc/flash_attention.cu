// Hopper (sm_90a) kernel K5: blockwise online-softmax attention (flash
// attention) for the LM prefill path (its backward: flash_attention_bwd.cu).  Plain C interface, loaded with ctypes
// by repro_torch/kernels/_build.py; the entry point launches on the caller's
// stream and returns cudaGetLastError().
//
// What it replaces: repro/kernels/flash_attention.py _flash_kernel, reached
// through flash_attention_pallas.  Same function: q (BH, Sq, d) against
// k/v (BHkv, Skv, d), q row b reads kv row b / group (group = BH / BHkv,
// rows flattened as (batch, head)), scores scaled by `scale`, causal and
// sliding-window masks with q aligned at the end of kv (q row i sits at
// position i + Skv - Sq), fp32 running max m (starting at -1e30), sum l
// and accumulator; a masked score is -1e30 and its weight 0, and a row that
// sees no key (l == 0) gives 0.  Output in q's dtype (fp32 or bf16).
//
// It is not the TPU grid.  The Pallas kernel walks kv blocks as the
// innermost, sequential grid axis and carries m/l/acc in VMEM scratch from
// one grid step to the next.  Here a CTA owns a block of q rows of one head
// row and loops over the kv tiles itself; m, l and the accumulator live in
// registers.  Both bodies skip whole kv tiles that no row of the CTA can see
// (above the causal diagonal, or older than the window; exact, since such a
// tile has alpha = 1 and p = 0), so a causal prefill does half the work, and
// launch the q blocks with the most kv tiles first.
//
// What bounds it on this card: at the LM slices' prefill shapes (B*H = 64
// or 128, BHkv = 32, S = 2048, d = 128, causal, bf16) the work is 69 or 137
// GFLOP against 100 or 168 MB of q/k/v/o, so the tensor cores bound it
// (~0.07 ms at 989 TFLOP/s bf16 for qwen3's shape).  Two bodies:
//
// - bf16 (the serving dtype): both products on the tensor cores with
//   wgmma.  A CTA of three warpgroups owns 128 q rows: two consumer
//   warpgroups of 64 rows, each computing S = Q K^T (m64nNk16, both operands
//   in shared memory, N = 128 kv rows a tile) into fp32 registers, the
//   online softmax there (a row's max and sum across its quad of threads),
//   and O += P V with P packed to bf16 in registers as the A operand and V
//   read MN-major through the transpose bit; one producer warpgroup, whose
//   one thread keeps a two-stage ring of K/V tiles filled by TMA, with
//   mbarriers for "landed" and "released", and setmaxnreg moving registers
//   from it to the consumers.  TMA zero-fills rows past Skv or Sq, so any
//   Sq, Skv >= 1 is taken without padding.  Each warpgroup runs its two
//   products and its softmax in turn; the other warpgroup's work fills the
//   gaps.  Overlapping them within a warpgroup (S of the next tile issued
//   before P V of this one) needs two tiles' fragments live at once, more
//   than the 168 registers ptxas gives a thread of a 384-thread CTA, and
//   ptxas then serialises the wgmma; at a 64-row kv tile it fits but
//   gains nothing over the 128-row tile kept here.  P is rounded to bf16 before
//   P V, as the tensor cores take it; the plain version keeps P in fp32,
//   a difference of at most about 2^-9 of sum p|v| / l, far inside the
//   bf16 tolerance.
// - fp32: scalar FMAs on the CUDA cores (64 q rows a CTA, four threads a
//   row, fp32 K/V tiles of 32 rows in shared memory).  The tensor cores take
//   fp32 only as TF32, about three decimal digits, which cannot hold the
//   fp32 checks (1e-5 against the plain version, 1e-3 on the logits of the
//   28-layer model), so fp32 keeps the exact body.

#include "hopper.cuh"

namespace {

// ------------------------------------------------------------ the fp32 body

constexpr int kThreads = 256;                     // threads per CTA
constexpr int kLanesPerRow = 4;                   // threads sharing one q row
constexpr int kBlockQ = kThreads / kLanesPerRow;  // q rows per CTA
constexpr int kBlockK = 32;                       // kv rows per staged tile
constexpr float kNegInf = -1e30f;                 // the Pallas kernel's NEG_INF
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// One CTA: q rows [q0, q0 + kBlockQ) of head row blockIdx.y.  Thread t
// serves row q0 + t / 4 and, of its head dim, the float4 chunks
// t % 4 + 4 i.  Rows past Sq run the loop (they help stage tiles and take
// part in the shuffles) but write nothing.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                 int Sq, int Skv, int group, int causal, int window, float scale) {
  static_assert(D % (4 * kLanesPerRow) == 0, "head dim must split into float4 chunks");
  constexpr int kChunks = D / 4;                // float4 chunks per row
  constexpr int kOwn = kChunks / kLanesPerRow;  // chunks per thread
  __shared__ __align__(16) float ks[kBlockK * D];
  __shared__ __align__(16) float vs[kBlockK * D];

  const int tid = threadIdx.x;
  const int lane = tid % kLanesPerRow;
  // The last q blocks see the most kv tiles under a causal mask: launch
  // them first so the short ones fill the tail.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int bh = blockIdx.y;
  const int row = q0 + tid / kLanesPerRow;
  const bool live = row < Sq;
  const int offset = Skv - Sq;  // q sits at the end of kv
  const int qpos = row + offset;
  const size_t kv_base = static_cast<size_t>(bh / group) * Skv * D;

  float qr[4 * kOwn];
  float acc[4 * kOwn];
  const T* qrow = q + (static_cast<size_t>(bh) * Sq + (live ? row : 0)) * D;
#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    const float4 x = live ? load4(qrow + 4 * (lane + kLanesPerRow * i))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[4 * i + 0] = x.x * scale;
    qr[4 * i + 1] = x.y * scale;
    qr[4 * i + 2] = x.z * scale;
    qr[4 * i + 3] = x.w * scale;
    acc[4 * i + 0] = acc[4 * i + 1] = acc[4 * i + 2] = acc[4 * i + 3] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  // The kv positions any row of this CTA can see; whole tiles outside them
  // are skipped (alpha = 1 and p = 0 there, so skipping is exact).
  const int last_row = min(q0 + kBlockQ, Sq) - 1;
  int kv_lo = 0;
  int kv_hi = Skv;
  if (causal) kv_hi = min(kv_hi, last_row + offset + 1);
  if (window > 0) kv_lo = max(0, q0 + offset - window + 1) / kBlockK * kBlockK;

  for (int k0 = kv_lo; k0 < kv_hi; k0 += kBlockK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int ci = tid; ci < kBlockK * kChunks; ci += kThreads) {
      const int r = ci / kChunks;
      const int c = ci % kChunks;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vx = kx;
      if (k0 + r < Skv) {
        const size_t off = kv_base + static_cast<size_t>(k0 + r) * D + 4 * c;
        kx = load4(k + off);
        vx = load4(v + off);
      }
      store4(ks + r * D + 4 * c, kx);
      store4(vs + r * D + 4 * c, vx);
    }
    __syncthreads();

    float s[kBlockK];
    uint32_t visible = 0;
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kOwn; ++i) {
        const float4 kk = *reinterpret_cast<const float4*>(
            ks + j * D + 4 * (lane + kLanesPerRow * i));
        part = fmaf(qr[4 * i + 0], kk.x, part);
        part = fmaf(qr[4 * i + 1], kk.y, part);
        part = fmaf(qr[4 * i + 2], kk.z, part);
        part = fmaf(qr[4 * i + 3], kk.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kpos = k0 + j;
      bool vis = kpos < Skv;
      if (causal) vis = vis && kpos <= qpos;
      if (window > 0) vis = vis && kpos > qpos - window;
      s[j] = vis ? part : kNegInf;
      visible |= static_cast<uint32_t>(vis) << j;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      s[j] = (visible >> j & 1u) ? expf(s[j] - m_new) : 0.f;
      p_sum += s[j];
    }
    l = l * alpha + p_sum;
    m = m_new;
#pragma unroll
    for (int e = 0; e < 4 * kOwn; ++e) acc[e] *= alpha;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
#pragma unroll
      for (int i = 0; i < kOwn; ++i) {
        const float4 vv = *reinterpret_cast<const float4*>(
            vs + j * D + 4 * (lane + kLanesPerRow * i));
        acc[4 * i + 0] = fmaf(s[j], vv.x, acc[4 * i + 0]);
        acc[4 * i + 1] = fmaf(s[j], vv.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(s[j], vv.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(s[j], vv.w, acc[4 * i + 3]);
      }
    }
  }

  if (!live) return;
  T* orow = o + (static_cast<size_t>(bh) * Sq + row) * D;
#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);  // a row that saw no key
    if (l != 0.f) {
      x = make_float4(acc[4 * i + 0] / l, acc[4 * i + 1] / l, acc[4 * i + 2] / l,
                      acc[4 * i + 3] / l);
    }
    store4(orow + 4 * (lane + kLanesPerRow * i), x);
  }
  // The row's log-sum-exp of its visible scaled scores, for the backward
  // (every lane of the row holds the same m and l).
  if (lse != nullptr && lane == 0) {
    lse[static_cast<size_t>(bh) * Sq + row] = l != 0.f ? m + logf(l) : -INFINITY;
  }
}

// ------------------------------------------------------------ the bf16 body
//
// Warp-specialised, tensor-core flash attention for Hopper.  A CTA owns
// kBlockM = 128 q rows of one head row and runs three warpgroups: two
// consumer warpgroups of 64 q rows each and one producer warpgroup, of
// which one thread issues every TMA copy.  Shared memory holds the Q tile
// and a ring of kStages K and V tiles of kBlockN kv rows (160 KiB at
// d = 128); mbarriers say when a K or V tile has landed (TMA's complete_tx)
// and when every consumer warp is done with it, K and V apart, since K is
// free as soon as S is computed.  Tiles are stored as TMA writes them:
// panels of at most 64 columns (128 bytes a row), rows swizzled at the
// panel's width, which is what the wgmma descriptors describe
// (hopper.cuh).

constexpr int kBlockM = 128;             // q rows per CTA
constexpr int kBlockN = 128;             // kv rows per tile (64 measured slower)
constexpr int kStages = 2;               // K/V ring depth
constexpr int kProducerRegs = 40;        // setmaxnreg: 128 x 40 + 256 x 232 <= 65536
constexpr int kConsumerRegs = 232;

// The kv tiles a CTA visits: [t_lo, t_hi) of kBlockN rows.  Tiles that no
// row of the CTA can see are skipped (above the causal diagonal, or older
// than every row's window; exact, since there alpha = 1 and p = 0).
struct Span {
  int t_lo, t_hi;
};

template <int N>
__device__ __forceinline__ Span kv_span(int q0, int Sq, int Skv, int causal, int window) {
  const long long offset = static_cast<long long>(Skv) - Sq;  // q sits at the end of kv
  const long long last = min(q0 + kBlockM, Sq) - 1 + offset;  // the last row's position
  long long hi = Skv;
  long long lo = 0;
  if (causal) hi = min(hi, last + 1);
  if (window > 0) lo = max(0LL, q0 + offset - window + 1);
  const int t_lo = static_cast<int>(lo / N);
  const int t_hi = hi > 0 ? static_cast<int>((hi + N - 1) / N) : 0;
  return Span{t_lo, max(t_lo, t_hi)};
}

// Whether every (row, key) pair of the CTA's rows and tile [k0, k0 + N) is
// visible, so the tile needs no element mask.
template <int N>
__device__ __forceinline__ bool tile_is_full(int k0, int q0, int Sq, int Skv, int causal,
                                             int window) {
  const long long offset = static_cast<long long>(Skv) - Sq;
  if (k0 + N > Skv) return false;
  if (causal && k0 + N - 1 > q0 + offset) return false;
  if (window > 0 && k0 < q0 + kBlockM + offset - window) return false;
  return true;
}

// One consumer thread's share of 64 q rows: the wgmma accumulator layout.
// Thread t (of 128) holds rows r = 16 (t / 32) + (t % 32) / 4 and r + 8, and
// of each 8-column chunk j the columns 8 j + 2 (t % 4) + {0, 1}: element
// i of a fragment is row r + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (t % 4)
// + i % 2.  A row's max and sum come from the quad of threads that hold it.
template <int D, int N>
struct Consumer {
  float o[D / 2];  // the output rows, unnormalised
  float m[2];      // running row max of the scores, times scale * log2(e)
  float l[2];      // this thread's part of the running sum

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
  }

  // Issue S = Q K^T for this warpgroup's 64 rows and one kv tile.
  __device__ __forceinline__ void issue_scores(float (&s)[N / 2], uint32_t q_tile,
                                               uint32_t k_tile) {
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<N>(s, kmajor_desc<D>(q_tile, kBlockM, kk), kmajor_desc<D>(k_tile, N, kk), kk > 0);
    }
    wgmma_commit();
  }

  // Issue O += P V: P from registers, V from shared memory.
  __device__ __forceinline__ void issue_pv(const uint32_t (&p)[N / 16][4], uint32_t v_tile) {
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) wgmma_rs<D>(o, p[kk], mnmajor_desc<D>(v_tile, N, kk), 1);
    wgmma_commit();
  }

  // The online-softmax statistics of one tile, in registers: mask (kMask:
  // tiles that cross the diagonal, the window edge or Skv), the tile's row
  // max (of the raw scores: the scale is positive), the new running max m
  // in log2 units, alpha, and p = 2^(s * sl2 - m) in place of s (one FFMA
  // and one ex2), summed into l.  A masked score is -inf: its weight is 0
  // and it never raises m, which starts at -1e30, so a row that has seen
  // no key keeps alpha = 1 and l = 0.  Touches neither o nor the P
  // fragments.
  template <bool kMask>
  __device__ __forceinline__ void softmax(float (&s)[N / 2], float (&alpha)[2], float sl2,
                                          int kpos0, int qpos, int Skv, int causal, int window) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int h = (i >> 1) & 1;
      if (kMask) {
        const int kpos = kpos0 + 8 * (i >> 2) + (i & 1);
        const int qp = qpos + 8 * h;
        bool vis = kpos < Skv;
        if (causal) vis = vis && kpos <= qp;
        if (window > 0) vis = vis && qp - kpos < window;
        s[i] = vis ? s[i] : -INFINITY;
      }
      mx[h] = fmaxf(mx[h], s[i]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h] * sl2);
      alpha[h] = exp2_approx(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int h = (i >> 1) & 1;
      s[i] = exp2_approx(fmaf(s[i], sl2, -m[h]));
      l[h] += s[i];
    }
  }

  // The element mask only where the tile needs it.
  __device__ __forceinline__ void update(float (&s)[N / 2], float (&alpha)[2], float sl2, int k0,
                                         int q0, int qpos, int quad, int Sq, int Skv, int causal,
                                         int window) {
    if (tile_is_full<N>(k0, q0, Sq, Skv, causal, window)) {
      softmax<false>(s, alpha, sl2, 0, 0, Skv, causal, window);
    } else {
      softmax<true>(s, alpha, sl2, k0 + 2 * quad, qpos, Skv, causal, window);
    }
  }

  // Rescale o by alpha (once the P V that accumulates into it is done) and
  // pack p to bf16 as the A fragments of the next P V: the accumulator's
  // layout is the A operand's.
  __device__ __forceinline__ void rescale_and_pack(const float (&s)[N / 2], const float (&alpha)[2],
                                                   uint32_t (&p)[N / 16][4]) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  }

  // O / l in bf16; a row that saw no key (l == 0) gives 0.  With kLse,
  // also the row's log-sum-exp of its scaled scores into `lse`, (m + log2
  // l) ln 2 (m is in log2 units), -inf for a row that saw no key.
  template <bool kLse>
  __device__ __forceinline__ void store(bf16* out, float* lse, int row, int Sq, int quad) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = l[h];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = sum != 0.f ? 1.f / sum : 0.f;
      const int r = row + 8 * h;
      if (r >= Sq) continue;
      if constexpr (kLse) {
        if (quad == 0) lse[r] = sum != 0.f ? (m[h] + log2f(sum)) * kLn2 : -INFINITY;
      }
      bf16* dst = out + static_cast<size_t>(r) * D + 2 * quad;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            pack_bf16(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
      }
    }
  }
};

template <int D>
struct Bf16Smem {
  static constexpr int kQ = kBlockM * D * 2;
  static constexpr int kTile = kBlockN * D * 2;
  // then the mbarriers: q, and per stage K landed, V landed, K free, V free
  static constexpr int kBarriers = kQ + 2 * kStages * kTile;
  static constexpr int kBytes = kBarriers + 8 * (1 + 4 * kStages) + 1024;  // + alignment slack
};

// kLse: also store each row's log-sum-exp (the training forward); the
// serving forward is the instantiation without it, which stores nothing
// more and passes a null `lse`.
template <int D, bool kLse>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                      float* __restrict__ lse, int Sq, int Skv, int group, int causal,
                      int window, float sl2) {
  using L = Layout<D>;
  using M = Bf16Smem<D>;
  constexpr int N = kBlockN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + M::kQ;               // + s * kTile
  const uint32_t sv = sk + kStages * M::kTile;  // + s * kTile
  const uint32_t bar_q = sq + M::kBarriers;
  const uint32_t k_full = bar_q + 8;            // + 8 s
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t k_free = v_full + 8 * kStages;
  const uint32_t v_free = k_free + 8 * kStages;

  // The last q blocks see the most kv tiles under a causal mask: launch
  // them first so the short ones fill the tail.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const int bh = blockIdx.y;
  const Span span = kv_span<N>(q0, Sq, Skv, causal, window);
  const int n_tiles = span.t_hi - span.t_lo;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_free + 8 * s, 2 * kWarpgroup / 32);  // one arrival per consumer warp
      mbar_init(v_free + 8 * s, 2 * kWarpgroup / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWarpgroup;
  if (wg == 2) {
    // Producer: one thread keeps the ring full.  Tile i goes to stage
    // i % kStages once the consumers have released that stage's previous
    // tile (K and V apart: K is free once S is computed).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 2 * kWarpgroup) {
      mbar_expect_tx(bar_q, M::kQ);
      tma_tile<D>(sq, &tq, bar_q, kBlockM, q0, bh);
      const int kv_head = bh / group;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t parity = (i / kStages + 1) & 1;  // the release of tile i - kStages
        const int k0 = (span.t_lo + i) * N;
        if (i >= kStages) mbar_wait(k_free + 8 * s, parity);
        mbar_expect_tx(k_full + 8 * s, M::kTile);
        tma_tile<D>(sk + s * M::kTile, &tk, k_full + 8 * s, N, k0, kv_head);
        if (i >= kStages) mbar_wait(v_free + 8 * s, parity);
        mbar_expect_tx(v_full + 8 * s, M::kTile);
        tma_tile<D>(sv + s * M::kTile, &tv, v_full + 8 * s, N, k0, kv_head);
      }
    }
  } else {
    // Consumers: per tile, S on the tensor cores, the softmax in
    // registers, O += P V on the tensor cores.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int lane = threadIdx.x % 32;
    const int quad = lane % 4;
    const int row = q0 + 64 * wg + 16 * (threadIdx.x % kWarpgroup / 32) + lane / 4;
    const int qpos = row + Skv - Sq;
    const uint32_t q_tile = sq + 64 * wg * L::kRowBytes;
    Consumer<D, N> c;
    c.init();
    float sc[N / 2];
    uint32_t p[N / 16][4];
    float alpha[2];
    mbar_wait(bar_q, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const uint32_t parity = (i / kStages) & 1;
      mbar_wait(k_full + 8 * s, parity);
      c.issue_scores(sc, q_tile, sk + s * M::kTile);
      wgmma_wait<0>();
      fence_regs(sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(k_free + 8 * s);
      c.update(sc, alpha, sl2, (span.t_lo + i) * N, q0, qpos, quad, Sq, Skv, causal, window);
      c.rescale_and_pack(sc, alpha, p);
      mbar_wait(v_full + 8 * s, parity);
      c.issue_pv(p, sv + s * M::kTile);
      wgmma_wait<0>();
      fence_regs(c.o);
      __syncwarp();
      if (lane == 0) mbar_arrive(v_free + 8 * s);
    }
    c.template store<kLse>(o + static_cast<size_t>(bh) * Sq * D,
                           kLse ? lse + static_cast<size_t>(bh) * Sq : nullptr, row, Sq, quad);
  }
}

// ------------------------------------------------------------- host side
template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
            int BHkv, int Sq, int Skv, int causal, int window, float scale,
            cudaStream_t stream) {
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, BH);
  flash_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, Sq, Skv, BH / BHkv, causal, window, scale);
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                int BHkv, int Sq, int Skv, int causal, int window, float scale,
                cudaStream_t stream) {
  using M = Bf16Smem<D>;
  CUtensorMap tq, tk, tv;
  // With Skv = 0 no tile is loaded; the maps only need to be well formed.
  const void* kb = Skv > 0 ? k : q;
  const void* vb = Skv > 0 ? v : q;
  const int kv_rows = Skv > 0 ? Skv : 1;
  if (!encode_rows<D>(&tq, q, Sq, BH, kBlockM) ||
      !encode_rows<D>(&tk, kb, kv_rows, BHkv, kBlockN) ||
      !encode_rows<D>(&tv, vb, kv_rows, BHkv, kBlockN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool with_lse = lse != nullptr;
  const cudaError_t e = allow_smem(
      with_lse ? reinterpret_cast<const void*>(&flash_fwd_bf16_kernel<D, true>)
               : reinterpret_cast<const void*>(&flash_fwd_bf16_kernel<D, false>),
      M::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + kBlockM - 1) / kBlockM, BH);
  if (with_lse) {
    flash_fwd_bf16_kernel<D, true><<<grid, kBf16Threads, M::kBytes, stream>>>(
        tq, tk, tv, static_cast<bf16*>(o), lse, Sq, Skv, BH / BHkv, causal, window,
        scale * kLog2e);
  } else {
    flash_fwd_bf16_kernel<D, false><<<grid, kBf16Threads, M::kBytes, stream>>>(
        tq, tk, tv, static_cast<bf16*>(o), nullptr, Sq, Skv, BH / BHkv, causal, window,
        scale * kLog2e);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_head_dim_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                         int BHkv, int Sq, int Skv, int d, int causal, int window, float scale,
                         cudaStream_t stream) {
  switch (d) {
    case 16: return launch_bf16<16>(q, k, v, o, lse, BH, BHkv, Sq, Skv, causal, window, scale, stream);
    case 32: return launch_bf16<32>(q, k, v, o, lse, BH, BHkv, Sq, Skv, causal, window, scale, stream);
    case 64: return launch_bf16<64>(q, k, v, o, lse, BH, BHkv, Sq, Skv, causal, window, scale, stream);
    case 128: return launch_bf16<128>(q, k, v, o, lse, BH, BHkv, Sq, Skv, causal, window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_head_dim_fp32(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                         int BHkv, int Sq, int Skv, int d, int causal, int window, float scale,
                         cudaStream_t stream) {
  switch (d) {
    case 16: launch<float, 16>(q, k, v, o, lse, BH, BHkv, Sq, Skv, causal, window, scale, stream); break;
    case 32: launch<float, 32>(q, k, v, o, lse, BH, BHkv, Sq, Skv, causal, window, scale, stream); break;
    case 64: launch<float, 64>(q, k, v, o, lse, BH, BHkv, Sq, Skv, causal, window, scale, stream); break;
    case 128: launch<float, 128>(q, k, v, o, lse, BH, BHkv, Sq, Skv, causal, window, scale, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q: (BH, Sq, d); k, v: (BHkv, Skv, d); o: (BH, Sq, d); all contiguous, of
// one dtype (bf16 != 0: bfloat16, else float32), 16-byte aligned.  BH is a
// multiple of BHkv, at most 65535; d one of 16, 32, 64, 128; window 0 for
// none, else >= 1.  lse: null, or fp32 (BH, Sq), which receives each row's
// log-sum-exp of its visible scaled scores (-inf for a row that sees no
// key): what the backward recomputes P from.
int flash_attention(const void* q, const void* k, const void* v, void* o, void* lse,
                    int BH, int BHkv, int Sq, int Skv, int d, int bf16,
                    int causal, int window, float scale, void* stream) {
  if (BH <= 0 || BHkv <= 0 || BH % BHkv != 0 || Sq <= 0 || Skv < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (bf16) {
    return launch_head_dim_bf16(q, k, v, o, lse_f, BH, BHkv, Sq, Skv, d, causal, window, scale, st);
  }
  return launch_head_dim_fp32(q, k, v, o, lse_f, BH, BHkv, Sq, Skv, d, causal, window, scale, st);
}

// Dynamic shared memory of one CTA of the bf16 body at head dim d (-1 for
// a d it has no instantiation of).
int flash_bf16_smem_bytes(int d) {
  switch (d) {
    case 16: return Bf16Smem<16>::kBytes;
    case 32: return Bf16Smem<32>::kBytes;
    case 64: return Bf16Smem<64>::kBytes;
    case 128: return Bf16Smem<128>::kBytes;
    default: return -1;
  }
}

}  // extern "C"

