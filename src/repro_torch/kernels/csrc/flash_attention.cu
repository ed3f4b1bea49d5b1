// Hopper (sm_90a) kernel K5: blockwise online-softmax attention (flash
// attention) for the LM prefill path.  Plain C interface, loaded with ctypes
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

#include <cuda.h>  // CUtensorMap and its enums (types only; no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

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
// panel's width, which is what the wgmma descriptors below describe.

using bf16 = __nv_bfloat16;

constexpr int kBlockM = 128;             // q rows per CTA
constexpr int kWarpgroup = 128;          // threads per warpgroup
constexpr int kBf16Threads = 3 * kWarpgroup;
constexpr int kBlockN = 128;             // kv rows per tile (64 measured slower)
constexpr int kStages = 2;               // K/V ring depth
constexpr int kProducerRegs = 40;        // setmaxnreg: 128 x 40 + 256 x 232 <= 65536
constexpr int kConsumerRegs = 232;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// How a (rows, D) bf16 tile lies in shared memory: D splits into panels of
// kPanelCols columns, each panel rows x kRowBytes, row-major; within a row
// the 16-byte chunk c sits at c ^ (address bits 7..9), the hardware's
// 128-, 64- or 32-byte swizzle (d = 64 and 128, 32, 16).
template <int D>
struct Layout {
  static constexpr int kRowBytes = 2 * D < 128 ? 2 * D : 128;
  static constexpr int kPanelCols = kRowBytes / 2;
  static constexpr int kPanels = D / kPanelCols;
  // wgmma descriptor layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr uint64_t kSwizzle = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr CUtensorMapSwizzle kTmaSwizzle =
      kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
};

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle mode.  Tiles start on 1024 bytes,
// so the base-offset field stays 0.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 | swizzle << 62;
}

// The k16 slice kk of a K-major operand (Q, or K for S = Q K^T): 16 head-dim
// columns of a tile whose panels hold `rows` rows.  8-row groups lie
// 8 x kRowBytes apart (SBO); a slice never crosses a swizzle row, so LBO is
// unused (1).
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows, int kk) {
  using L = Layout<D>;
  const uint32_t byte = 32u * kk;
  return gmma_desc(tile + byte / L::kRowBytes * rows * L::kRowBytes + byte % L::kRowBytes, 16,
                   8 * L::kRowBytes, L::kSwizzle);
}

// The k16 slice kk of V for O += P V, where the product's K is the kv row:
// V is (kv, d) with d contiguous, MN-major, read with wgmma's transpose bit.
// 16 kv rows per slice; 8-row groups along K lie 8 x kRowBytes apart (SBO),
// 64-column panels along N lie `rows` x kRowBytes apart (LBO).
template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int rows, int kk) {
  using L = Layout<D>;
  return gmma_desc(tile + 16u * kk * L::kRowBytes, rows * L::kRowBytes, 8 * L::kRowBytes,
                   L::kSwizzle);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x N fp32, the accumulator fragment) = / += A (smem, K-major) x B
// (smem, K-major)^T: one m64nNk16 for N the kv tile.
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d);
// d (64 x N fp32) += A (registers, 64 x 16 bf16) x B (smem, MN-major): one
// m64nNk16 for N the head dim.
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},\n"
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7},\n"
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},\n"
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},\n"
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},\n"
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// ------------------------------------------------- mbarriers and TMA (PTX)
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// One box of a 3-D tensor map (column, row, head row) into shared memory;
// completion is counted in bytes on `bar`.  Rows past the tensor's end
// arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(head)
      : "memory");
}
// All panels of one (rows, D) tile.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int rows, int row, int head) {
  using L = Layout<D>;
#pragma unroll
  for (int p = 0; p < L::kPanels; ++p) {
    tma_load(dst + p * rows * L::kRowBytes, map, bar, p * L::kPanelCols, row, head);
  }
}

// 2^x on the special-function unit (flush to zero): 2^-inf = 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

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


// ------------------------------------------------------------ the backward
//
// K5's backward: dq, dk and dv of the forward above from q, k, v, its
// output o, the output's gradient dO and the forward's row log-sum-exp.
// The TPU kernel has no backward (the JAX package trains through
// _blockwise_attn, which XLA differentiates), so this replaces none; it is
// FlashAttention-2's recompute schedule on the CUDA cores, in fp32 for
// both dtypes:
//
// - a pre-pass, one warp a q row: delta = rowsum(dO o o), and dq_acc zeroed;
// - the main kernel, one CTA per (64-row kv tile, kv head row): K and V of
//   the tile in shared memory, dK and dV in registers; it loops over the
//   GQA group's q head rows and, of each, the 64-row q tiles that can see
//   the tile (causal, window), and per q tile recomputes
//   P = exp(scale S - lse) (0 where masked, and for a row that sees no
//   key), dP = dO V^T, dS = scale P o (dP - delta), then
//   dV += P^T dO, dK += dS^T Q and dQ += dS K, the last added to the fp32
//   dq_acc with atomicAdd (every kv tile of the row adds to it);
// - in bf16, a cast of dq_acc into dq.
//
// Summing the group's q heads inside the CTA gives dK and dV without
// atomics.  What bounds it on this card: the five products (2.5 times the
// forward's operations) on the CUDA cores' fp32 FMAs, 67 TFLOP/s at best,
// where the tensor cores would give 989 in bf16 (wgmma and TMA are later
// work); the operands are staged in shared memory as fp32 with padded rows
// (170 KB a CTA at d = 128, one CTA an SM), each thread computes a 4 x 4
// block of S and dP and an (rows x 4) block of dK, dV and dQ.

using bf16_t = bf16;

constexpr int kBwdThreads = 256;
constexpr int kBwdRows = 64;  // kv rows a CTA, q rows a step

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

// The pre-pass: delta[row] = sum_d dO[row, d] o[row, d] (fp32), and the row
// of dq_acc zeroed.  One warp a row, eight rows a CTA.
template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_pre_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                     float* __restrict__ delta, float* __restrict__ dq_acc, long long rows) {
  const long long row = static_cast<long long>(blockIdx.x) * (kBwdThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // uniform across the warp
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

// dq = dq_acc in T, four elements a thread.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_cast_kernel(const float* __restrict__ acc, T* __restrict__ out, long long n4) {
  const long long i = static_cast<long long>(blockIdx.x) * kBwdThreads + threadIdx.x;
  if (i < n4) st4(out + 4 * i, *reinterpret_cast<const float4*>(acc + 4 * i));
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
                 T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv, int group, int causal,
                 int window, float scale) {
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
  // Under a causal mask the first kv tiles are seen by the most q rows:
  // they are launched first (blockIdx.x), so the short ones fill the tail.
  const int k0 = blockIdx.x * kBwdRows;
  const int hk = blockIdx.y;
  const long long offset = static_cast<long long>(Skv) - Sq;  // q sits at the end of kv

  load_rows<T, D>(ks, k + static_cast<size_t>(hk) * Skv * D, k0, Skv);
  load_rows<T, D>(vs, v + static_cast<size_t>(hk) * Skv * D, k0, Skv);

  // The q rows that can see a key of [k0, k0 + 64): causal, qpos >= k0;
  // window, qpos - (k0 + 63) < window.
  long long i_lo = 0;
  long long i_hi = Sq;
  if (causal) i_lo = max(0LL, k0 - offset);
  if (window > 0) i_hi = min(i_hi, k0 + kBwdRows - 1 + static_cast<long long>(window) - offset);
  const int qt_lo = static_cast<int>(i_lo / kBwdRows);
  const int qt_hi = i_hi > i_lo ? static_cast<int>((i_hi + kBwdRows - 1) / kBwdRows) : qt_lo;

  float dk_acc[kRows][4];
  float dv_acc[kRows][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
  }

  for (int h = 0; h < group; ++h) {
    const int bh = hk * group + h;
    const size_t row_base = static_cast<size_t>(bh) * Sq;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
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
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = q0 + tc * kRows + i;
        if (r >= Sq) continue;
        float* dst = dq_acc + (row_base + r) * D + 4 * td;
#pragma unroll
        for (int j = 0; j < 4; ++j) atomicAdd(dst + j, dq[i][j]);
      }
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 3-D tensor map (column, row, head row) over a contiguous (heads, rows,
// D) bf16 tensor, in boxes of one panel's columns x box_rows rows, swizzled
// as Layout<D> says; rows past `rows` read as zeros.
template <int D>
bool encode_rows(CUtensorMap* map, const void* base, int rows, int heads, int box_rows) {
  using L = Layout<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(L::kPanelCols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, L::kTmaSwizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Opt a kernel in to `bytes` of dynamic shared memory (above the 48 KiB
// default a launch is refused without it), once per kernel and device.
cudaError_t allow_smem(const void* kernel, int bytes) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, int> allowed;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const std::lock_guard<std::mutex> lock(mu);
  int& have = allowed[{kernel, dev}];
  if (bytes <= have) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) have = bytes;
  return e;
}


struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  void *dq, *dk, *dv;
  float* dq_acc;
  float* delta;
  int BH, BHkv, Sq, Skv, causal, window;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_bwd(const BwdArgs& a) {
  const long long rows = static_cast<long long>(a.BH) * a.Sq;
  constexpr int kRowsPerCta = kBwdThreads / 32;
  flash_bwd_pre_kernel<T, D><<<static_cast<unsigned>((rows + kRowsPerCta - 1) / kRowsPerCta),
                               kBwdThreads, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta, a.dq_acc, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (a.Skv > 0) {
    e = allow_smem(reinterpret_cast<const void*>(&flash_bwd_kernel<T, D>), BwdSmem<D>::kBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((a.Skv + kBwdRows - 1) / kBwdRows, a.BHkv);
    flash_bwd_kernel<T, D><<<grid, kBwdThreads, BwdSmem<D>::kBytes, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), a.lse, a.delta, a.dq_acc, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.Sq, a.Skv, a.BH / a.BHkv, a.causal, a.window, a.scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (static_cast<const void*>(a.dq) != static_cast<const void*>(a.dq_acc)) {
    const long long n4 = rows * D / 4;
    flash_bwd_cast_kernel<T><<<static_cast<unsigned>((n4 + kBwdThreads - 1) / kBwdThreads),
                               kBwdThreads, 0, a.stream>>>(a.dq_acc, static_cast<T*>(a.dq), n4);
    e = cudaGetLastError();
  }
  return static_cast<int>(e);
}

constexpr float kLog2e = 1.4426950408889634f;

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

// K5's backward.  q, k, v, o, dout, dq, dk, dv as the forward's q, k, v, o
// (dout and dq shaped as o, dk and dv as k), all of one dtype; lse the
// forward's (BH, Sq) fp32 output; dq_acc fp32 (BH, Sq, d) and delta fp32
// (BH, Sq) scratch (in fp32, dq_acc may be dq itself).  Three kernels on the
// stream: the pre-pass (delta, dq_acc zeroed), the main kernel, and in bf16
// the cast of dq_acc into dq.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const void* lse, void* dq, void* dk, void* dv,
                        void* dq_acc, void* delta, int BH, int BHkv, int Sq, int Skv, int d,
                        int bf16, int causal, int window, float scale, void* stream) {
  if (BH <= 0 || BHkv <= 0 || BH % BHkv != 0 || Sq <= 0 || Skv < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdArgs a{q, k, v, o, dout, static_cast<const float*>(lse), dq, dk, dv,
                  static_cast<float*>(dq_acc), static_cast<float*>(delta), BH, BHkv, Sq, Skv,
                  causal, window, scale, static_cast<cudaStream_t>(stream)};
  switch (d) {
    case 16: return bf16 ? launch_bwd<bf16_t, 16>(a) : launch_bwd<float, 16>(a);
    case 32: return bf16 ? launch_bwd<bf16_t, 32>(a) : launch_bwd<float, 32>(a);
    case 64: return bf16 ? launch_bwd<bf16_t, 64>(a) : launch_bwd<float, 64>(a);
    case 128: return bf16 ? launch_bwd<bf16_t, 128>(a) : launch_bwd<float, 128>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of one CTA of the backward's main kernel at head
// dim d (-1 for a d it has no instantiation of).
int flash_bwd_smem_bytes(int d) {
  switch (d) {
    case 16: return BwdSmem<16>::kBytes;
    case 32: return BwdSmem<32>::kBytes;
    case 64: return BwdSmem<64>::kBytes;
    case 128: return BwdSmem<128>::kBytes;
    default: return -1;
  }
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
