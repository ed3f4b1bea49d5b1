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
// one grid step to the next.  Here one CTA owns 64 q rows of one head row
// and loops over the kv tiles itself; m, l and the accumulator live in
// registers.  Four threads share a q row, each holding a quarter of its
// head dim (float4 chunks c, c+4, c+8, ...) for q and the accumulator; a
// score is their four partial dot products summed by two xor shuffles, so
// all four hold the same bits of it and run the same softmax.  K and V
// tiles of 32 rows are staged in shared memory as fp32 (coalesced loads of
// 4 elements a thread; rows past Skv are zero-filled and masked, so a
// ragged last tile needs no padding of the inputs and any Sq, Skv >= 1 is
// taken).  The TPU's 512/1024 block shapes are VMEM sizes and do not carry
// over: 64 x 32 tiles keep the 32 KiB of staging and about 100 registers
// a thread inside two CTAs per SM.
//
// What bounds it on this card: at the LM slice's shape (B*H = 64, BHkv = 32,
// S = 2048, d = 128, causal, bf16) the work is about 69 GFLOP against
// about 100 MB of q/k/v/o, so a tensor-core kernel would be compute-bound
// (~0.07 ms at 989 TFLOP/s bf16).  This kernel does its products as scalar
// fp32 FMAs on the CUDA cores (67 TFLOP/s fp32 peak), two FMAs per shared-
// memory float read, so it is bound by the FMA pipes and the shared-memory
// reads that feed them, some 15-30x above the tensor-core bound.  What the
// design does about it: it skips whole kv tiles that no row of the CTA can
// see (above the causal diagonal, or older than the window; exact, since
// such a tile has alpha = 1 and p = 0), so a causal prefill does half the
// work; it launches the q blocks with the most kv tiles first; it keeps
// every intermediate in registers or shared memory, so device memory sees
// each q row and each output row once.  Moving the two products onto the
// tensor cores (mma.sync, then wgmma with TMA-fed tiles) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;                     // threads per CTA
constexpr int kLanesPerRow = 4;                   // threads sharing one q row
constexpr int kBlockQ = kThreads / kLanesPerRow;  // q rows per CTA
constexpr int kBlockK = 32;                       // kv rows per staged tile
constexpr float kNegInf = -1e30f;                 // the Pallas kernel's NEG_INF

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&a);
  raw.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// One CTA: q rows [q0, q0 + kBlockQ) of head row blockIdx.y.  Thread t
// serves row q0 + t / 4 and, of its head dim, the float4 chunks
// t % 4 + 4 i.  Rows past Sq run the loop (they help stage tiles and take
// part in the shuffles) but write nothing.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                 int group, int causal, int window, float scale) {
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
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o, int BH,
            int BHkv, int Sq, int Skv, int causal, int window, float scale,
            cudaStream_t stream) {
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, BH);
  flash_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Skv, BH / BHkv, causal, window, scale);
}

template <typename T>
int launch_head_dim(const void* q, const void* k, const void* v, void* o,
                    int BH, int BHkv, int Sq, int Skv, int d, int causal,
                    int window, float scale, cudaStream_t stream) {
  switch (d) {
    case 16: launch<T, 16>(q, k, v, o, BH, BHkv, Sq, Skv, causal, window, scale, stream); break;
    case 32: launch<T, 32>(q, k, v, o, BH, BHkv, Sq, Skv, causal, window, scale, stream); break;
    case 64: launch<T, 64>(q, k, v, o, BH, BHkv, Sq, Skv, causal, window, scale, stream); break;
    case 128: launch<T, 128>(q, k, v, o, BH, BHkv, Sq, Skv, causal, window, scale, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q: (BH, Sq, d); k, v: (BHkv, Skv, d); o: (BH, Sq, d); all contiguous, of
// one dtype (bf16 != 0: bfloat16, else float32), 16-byte aligned.  BH is a
// multiple of BHkv, at most 65535; d one of 16, 32, 64, 128; window 0 for
// none, else >= 1.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int BH, int BHkv, int Sq, int Skv, int d, int bf16,
                    int causal, int window, float scale, void* stream) {
  if (BH <= 0 || BHkv <= 0 || BH % BHkv != 0 || Sq <= 0 || Skv < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_head_dim<__nv_bfloat16>(q, k, v, o, BH, BHkv, Sq, Skv, d,
                                          causal, window, scale, st);
  }
  return launch_head_dim<float>(q, k, v, o, BH, BHkv, Sq, Skv, d, causal,
                                window, scale, st);
}

}  // extern "C"
