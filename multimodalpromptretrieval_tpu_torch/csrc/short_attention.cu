// Short-sequence attention per (batch, head), for Hopper (sm_90a).
//
// Replaces the Pallas kernel _kernel behind short_attention
// (multimodalpromptretrieval_tpu/ops/short_attention.py). That kernel pads L
// to a multiple of 8, packs G heads into one (G*Lp, G*Lp) product and masks
// the off-block and padded columns to -1e9: three matrix-unit tile tricks.
// The function they compute is plain per-head attention over the L real
// keys (a masked score is exp(-1e9 - m) == 0 in fp32), which is what this
// kernel computes. Its plain PyTorch version is short_attention_reference
// (multimodalpromptretrieval_tpu_torch/ops/short_attention.py).
//
// Semantics, kept exactly: fp32 scores s = (q . k) * scale (the scale is
// always applied), no bias, no mask; exact softmax (max, exp, sum, divide);
// p rounded to the value dtype before P.V, which accumulates in fp32.
//
// Design: one block per (batch, head), 8 warps. The head's K and V tiles
// (L x 64, at most 128 x 64) are staged once into shared memory as fp32,
// rows padded by one word so that lanes reading different keys hit
// different banks. Each warp then takes query rows warp, warp + 8, ...: it
// writes the row's L scores into its own shared score row (lanes over
// keys), normalises them, and accumulates P.V with lanes over the head
// dimension. q, k and v are read through (batch, head, row) strides, so
// head views of a packed projection need no copy; the output is contiguous
// (B, H, L, 64). Plain CUDA cores in fp32: right first, fast later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kHeadDim = 64;
constexpr int kStride = kHeadDim + 1;
constexpr int kMaxLen = 128;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Strides {
  int64_t b, h, r;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
short_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, Strides qs, Strides ks,
                       Strides vs, T* __restrict__ out, int H, int L,
                       float scale) {
  extern __shared__ float smem[];
  float* s_k = smem;                      // [L][kStride]
  float* s_v = s_k + L * kStride;         // [L][kStride]
  float* s_p = s_v + L * kStride;         // [kWarps][L]
  float* s_q = s_p + kWarps * L;          // [kWarps][kHeadDim]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;

  for (int i = threadIdx.x; i < L * kHeadDim; i += kThreads) {
    const int r = i / kHeadDim, d = i % kHeadDim;
    s_k[r * kStride + d] = to_float(kb[r * ks.r + d]);
    s_v[r * kStride + d] = to_float(vb[r * vs.r + d]);
  }
  __syncthreads();

  float* prow = s_p + warp * L;
  float* qrow = s_q + warp * kHeadDim;
  T* ob = out + (static_cast<int64_t>(b) * H + h) * L * kHeadDim;
  for (int r = warp; r < L; r += kWarps) {
    qrow[lane] = to_float(qb[r * qs.r + lane]);
    qrow[lane + 32] = to_float(qb[r * qs.r + lane + 32]);
    __syncwarp();
    float m = -INFINITY;
    for (int c = lane; c < L; c += 32) {
      const float* krow = s_k + c * kStride;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) s = fmaf(qrow[d], krow[d], s);
      s *= scale;
      prow[c] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int c = lane; c < L; c += 32) {
      const float e = expf(prow[c] - m);
      prow[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int c = lane; c < L; c += 32)
      prow[c] = to_float(from_float<T>(prow[c] / sum));
    __syncwarp();
    float acc0 = 0.f, acc1 = 0.f;
    for (int c = 0; c < L; ++c) {
      const float p = prow[c];
      const float* vrow = s_v + c * kStride;
      acc0 = fmaf(p, vrow[lane], acc0);
      acc1 = fmaf(p, vrow[lane + 32], acc1);
    }
    ob[r * kHeadDim + lane] = from_float<T>(acc0);
    ob[r * kHeadDim + lane + 32] = from_float<T>(acc1);
    __syncwarp();  // the next row reuses qrow and prow
  }
}

size_t smem_bytes(int L) {
  return sizeof(float) * (static_cast<size_t>(2) * L * kStride +
                          static_cast<size_t>(kWarps) * (L + kHeadDim));
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, Strides qs,
                   Strides ks, Strides vs, void* out, int B, int H, int L,
                   float scale, cudaStream_t stream) {
  auto kernel = short_attention_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(kMaxLen)));
  if (err != cudaSuccess) return err;
  kernel<<<B * H, kThreads, smem_bytes(L), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qs, ks, vs, static_cast<T*>(out), H, L,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v: (B, H, L, 64) through (batch, head, row) strides in elements,
// head-dim stride 1; out: (B, H, L, 64) contiguous. dtype: 0 = float32,
// 1 = bfloat16. Dh must be 64 and 1 <= L <= 128.
int mpr_short_attention(const void* q, const void* k, const void* v,
                        int64_t q_bs, int64_t q_hs, int64_t q_rs,
                        int64_t k_bs, int64_t k_hs, int64_t k_rs,
                        int64_t v_bs, int64_t v_hs, int64_t v_rs, void* out,
                        int B, int H, int L, int Dh, float scale, int dtype,
                        void* stream) {
  if (Dh != kHeadDim || L < 1 || L > kMaxLen || B < 1 || H < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{q_bs, q_hs, q_rs}, ks{k_bs, k_hs, k_rs},
      vs{v_bs, v_hs, v_rs};
  cudaError_t err =
      dtype == 0
          ? launch<float>(q, k, v, qs, ks, vs, out, B, H, L, scale, s)
          : launch<__nv_bfloat16>(q, k, v, qs, ks, vs, out, B, H, L, scale,
                                  s);
  return static_cast<int>(err);
}

}  // extern "C"
