// Single-query attention over row-layout KV caches, for Hopper (sm_90a).
//
// Replaces two Pallas kernels of multimodalpromptretrieval_tpu/ops/
// decode_attention.py, which the greedy decode loop runs for its self- and
// cross-attention at every step:
//   * _make_kernel -> decode_attention (K6, decode_attention_impl "pallas";
//     the same function as "xla"): fp32 products of q and k;
//   * _make_fused_kernel -> decode_attention_fused (K7, "fused"; the same
//     function as the JAX default "indicator"): each product rounded to the
//     compute dtype before the fp32 sum.
// One source, one kernel template; kRoundProducts tells the two apart. The
// plain PyTorch versions are decode_attention_reference and
// decode_attention_indicator_reference (multimodalpromptretrieval_tpu_torch/
// ops/decode_attention.py).
//
// Rounding points, as in the JAX kernels:
//   * score = sum over the head's 64 dims of q*k in fp32, rounded to the
//     compute dtype and back;
//   * times scale (when not 1), plus the fp32 bias row, plus the key mask in
//     its additive form, 0 or -1e9;
//   * softmax over T: max, exp, sum, p / sum (an IEEE divide: no fast-math);
//   * p rounded to the compute dtype, P.V accumulated in fp32, the output
//     rounded once.
//
// What bounds it on the H100: at serving size (B=512, T=82 cross keys,
// W=512) one call reads the K and V caches once, 2 * B * T * W elements
// (86 MB at bf16), against ~2 * B * T * W multiply-adds: bound by the bytes
// of the caches. The design reads each cache element exactly once, with
// 16-byte loads by neighbouring lanes on neighbouring addresses, straight
// from the row caches through batch and row strides (no head transposes, no
// copies); scores and probabilities never leave shared memory.
//
// Design: one block per batch row, one warp per head (blockDim = 32 * H).
// A warp splits into 4 groups of 8 lanes; group g takes keys t = g, g+4, ...
// and lane j of a group the 8 head dims [8j, 8j+8), so a group reads one
// 128-byte key row (bf16) per step and reduces it with 3 shuffles. The fp32
// scores of all heads sit in shared memory (H x T floats: T up to ~7,000 at
// 8 heads, the wrapper refuses more); the warp normalises its own row, then
// the same lane split accumulates P.V and a 2-shuffle reduction over the
// groups leaves the head's 64 outputs on the 8 lanes of group 0.
// Instantiated for head dim 64, the d_kv of every T5 size.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kHeadDim = 64;
constexpr int kGroups = 4;                     // key rows in flight per warp
constexpr int kLanesPerRow = 32 / kGroups;     // 8
constexpr int kDimsPerLane = kHeadDim / kLanesPerRow;  // 8: one 16 B bf16 load
constexpr int kMaxHeads = 32;                  // 1,024 threads
constexpr float kNegInf = -1e9f;
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&x)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&x)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
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

template <typename T, bool kRoundProducts>
__global__ void decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    int64_t q_bstride, int64_t k_bstride, int64_t k_rstride,
    int64_t v_bstride, int64_t v_rstride, const float* __restrict__ bias,
    const int* __restrict__ mask, T* __restrict__ out, int T_len, int H,
    float scale) {
  extern __shared__ float s_p[];  // [H][T_len]
  const int b = blockIdx.x;
  const int h = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / kLanesPerRow, j = lane % kLanesPerRow;
  const int d0 = h * kHeadDim + j * kDimsPerLane;
  float* sp = s_p + static_cast<int64_t>(h) * T_len;

  float qv[kDimsPerLane];
  load8(q + b * q_bstride + d0, qv);
  const T* kb = k + b * k_bstride + d0;
  const T* vb = v + b * v_bstride + d0;
  const int* mask_b = mask != nullptr ? mask + static_cast<int64_t>(b) * T_len
                                      : nullptr;
  const float* bias_h = bias != nullptr
                            ? bias + static_cast<int64_t>(h) * T_len
                            : nullptr;

  // scores: group g takes keys t0 + g; every lane joins the shuffles
  for (int t0 = 0; t0 < T_len; t0 += kGroups) {
    const int t = t0 + g;
    float acc = 0.f;
    if (t < T_len) {
      float kv[kDimsPerLane];
      load8(kb + t * k_rstride, kv);
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        if (kRoundProducts) {
          // __fmul_rn is never contracted into an fma: the product is
          // rounded to fp32, then to the compute dtype
          acc += round_to(__fmul_rn(qv[i], kv[i]), T());
        } else {
          acc = fmaf(qv[i], kv[i], acc);
        }
      }
    }
#pragma unroll
    for (int off = kLanesPerRow / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (t < T_len && j == 0) {
      float s = round_to(acc, T());
      if (scale != 1.f) s *= scale;
      if (bias_h != nullptr) s += bias_h[t];
      if (mask_b != nullptr) s += mask_b[t] != 0 ? 0.f : kNegInf;
      sp[t] = s;
    }
  }
  __syncwarp();

  // softmax of the warp's own head over T; p rounded to the compute dtype
  float m = -INFINITY;
  for (int t = lane; t < T_len; t += 32) m = fmaxf(m, sp[t]);
  m = warp_max(m);
  float sum = 0.f;
  for (int t = lane; t < T_len; t += 32) {
    const float e = expf(sp[t] - m);
    sp[t] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  for (int t = lane; t < T_len; t += 32) sp[t] = round_to(sp[t] / sum, T());
  __syncwarp();

  // P.V in fp32, then a reduction over the 4 groups
  float o[kDimsPerLane];
#pragma unroll
  for (int i = 0; i < kDimsPerLane; ++i) o[i] = 0.f;
  for (int t = g; t < T_len; t += kGroups) {
    const float p = sp[t];
    float vv[kDimsPerLane];
    load8(vb + t * v_rstride, vv);
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) o[i] = fmaf(p, vv[i], o[i]);
  }
#pragma unroll
  for (int i = 0; i < kDimsPerLane; ++i) {
    o[i] += __shfl_xor_sync(0xffffffffu, o[i], 8);
    o[i] += __shfl_xor_sync(0xffffffffu, o[i], 16);
  }
  if (g == 0) {
    const int W = H * kHeadDim;
    store8(out + static_cast<int64_t>(b) * W + d0, o);
  }
}

size_t smem_bytes(int T_len, int H) {
  return sizeof(float) * static_cast<size_t>(T_len) * H;
}

template <typename T, bool kRound>
cudaError_t launch(const void* q, const void* k, const void* v, int64_t q_bs,
                   int64_t k_bs, int64_t k_rs, int64_t v_bs, int64_t v_rs,
                   const void* bias, const void* mask, void* out, int B,
                   int T_len, int H, float scale, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<T, kRound>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  kernel<<<B, 32 * H, smem_bytes(T_len, H), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_bs, k_bs, k_rs, v_bs, v_rs,
      static_cast<const float*>(bias), static_cast<const int*>(mask),
      static_cast<T*>(out), T_len, H, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest T whose H x T fp32 score rows fit in shared memory.
int mpr_decode_attention_max_len(int H) {
  if (H < 1 || H > kMaxHeads) return 0;
  return static_cast<int>(kMaxSmem / (sizeof(float) * H));
}

// q (B, W) rows of stride q_bstride; k, v (B, T, W) with batch / row
// strides; W = H * 64 and every row start and stride 16-byte aligned (the
// wrapper checks). bias: (H, T) fp32 or null; mask: (B, T) int32 or null;
// out: (B, W) contiguous. round_products: 0 = K6, 1 = K7. dtype: 0 =
// float32, 1 = bfloat16.
int mpr_decode_attention(const void* q, const void* k, const void* v,
                         int64_t q_bstride, int64_t k_bstride,
                         int64_t k_rstride, int64_t v_bstride,
                         int64_t v_rstride, const void* bias,
                         const void* mask, void* out, int B, int T_len, int H,
                         int Dh, float scale, int round_products, int dtype,
                         void* stream) {
  if (Dh != kHeadDim || H < 1 || H > kMaxHeads || T_len < 1 || B < 1 ||
      smem_bytes(T_len, H) > static_cast<size_t>(kMaxSmem))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = round_products
              ? launch<float, true>(q, k, v, q_bstride, k_bstride, k_rstride,
                                    v_bstride, v_rstride, bias, mask, out, B,
                                    T_len, H, scale, s)
              : launch<float, false>(q, k, v, q_bstride, k_bstride, k_rstride,
                                     v_bstride, v_rstride, bias, mask, out, B,
                                     T_len, H, scale, s);
  } else {
    err = round_products
              ? launch<__nv_bfloat16, true>(q, k, v, q_bstride, k_bstride,
                                            k_rstride, v_bstride, v_rstride,
                                            bias, mask, out, B, T_len, H,
                                            scale, s)
              : launch<__nv_bfloat16, false>(q, k, v, q_bstride, k_bstride,
                                             k_rstride, v_bstride, v_rstride,
                                             bias, mask, out, B, T_len, H,
                                             scale, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
