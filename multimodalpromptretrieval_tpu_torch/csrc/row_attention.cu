// Row-layout attention over packed [q | k | v] rows, for Hopper (sm_90a).
//
// Replaces two Pallas kernels of
// multimodalpromptretrieval_tpu/ops/row_attention.py: _make_packed_kernel /
// _packed_forward behind row_attention_packed (the attention of both CLIP
// towers and of the T5 encoder; q, k and v are column slices of one packed
// tensor) and _make_kernel / _forward behind row_attention (the same
// function over three separately allocated (B, L, W) tensors, no causal
// term). q, k and v each come with their own batch and row strides, so one
// kernel serves both. The plain PyTorch versions are
// row_attention_packed_reference and row_attention_reference
// (multimodalpromptretrieval_tpu_torch/ops/row_attention.py).
//
// Semantics, kept exactly:
//   * inputs read straight from the fused QKV GEMM output (B, L, 3W) through
//     strides: no split copies, no head transposes; the output is (B, L, W)
//     rows, ready for the out-projection;
//   * scores in fp32: s = (q . k) * scale (+ bias[h]); a key-mask zero
//     REPLACES s with -1e9; causal ADDS -1e9 to future keys. -1e9, not
//     -inf, so a fully masked row gives uniform probabilities, not NaN;
//   * exact softmax (max, exp, sum, divide), p rounded to the value dtype
//     before P.V, which accumulates in fp32.
//
// What bounds it on the H100: at the serving shapes (ViT L=50, text L<=80,
// T5 encoder L<=562, head dim 64) the work per (sequence, head) is tiny and
// the kernel reads q/k/v once from device memory, so it is bound by memory
// traffic and latency, not by the tensor cores. The exact-softmax contract
// (p normalised and rounded BEFORE P.V) rules out a one-pass online softmax.
//
// Design: one block per (query tile of 32, head, sequence), 8 warps, each
// warp owning 4 query rows. Keys and values stream through shared memory in
// tiles of 64 rows (converted to fp32, rows padded by one word so the
// per-lane key reads hit distinct banks). Pass 1 writes every fp32 score of
// the tile's rows into a shared score block (32 x L floats); each warp then
// normalises its own rows; pass 2 streams V and accumulates P.V in
// registers, lanes over the head dimension. Shared memory grows with L
// (97 KB at L=562), so any L up to ~1,600 fits; beyond that the wrapper
// refuses. Plain CUDA cores in fp32: making it fast (wgmma tiles, causal
// tile skipping) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kQueryTile = kWarps * kRowsPerWarp;
constexpr int kKeyTile = 64;
constexpr float kNegInf = -1e9f;
constexpr int kMaxSmem = 227 * 1024;
// The one head dim of every tower on the serving path (ViT-B/32, the CLIP
// text tower, t5-small and t5-large); another is instantiated when a
// configuration needs it.
constexpr int kHeadDim = 64;

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

template <typename T, int DH>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           int64_t row_stride, int count,
                                           int L) {
  constexpr int kStride = DH + 1;
  for (int i = threadIdx.x; i < count * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    dst[r * kStride + d] = r < L ? to_float(src[r * row_stride + d]) : 0.f;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
row_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, int64_t q_bstride,
                     int64_t q_rstride, int64_t k_bstride, int64_t k_rstride,
                     int64_t v_bstride, int64_t v_rstride,
                     const float* __restrict__ bias,
                     const int* __restrict__ mask, T* __restrict__ out,
                     int L, int H, float scale, int causal) {
  constexpr int kStride = DH + 1;
  constexpr int kPerLane = (DH + 31) / 32;
  extern __shared__ float smem[];
  float* s_scores = smem;                      // [kQueryTile][L]
  float* s_q = s_scores + kQueryTile * L;      // [kQueryTile][DH + 1]
  float* s_kv = s_q + kQueryTile * kStride;    // [kKeyTile][DH + 1]

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kQueryTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qb = q + b * q_bstride + h * DH;
  const T* kb = k + b * k_bstride + h * DH;
  const T* vb = v + b * v_bstride + h * DH;
  const int W = H * DH;

  stage_rows<T, DH>(s_q, qb + q0 * q_rstride, q_rstride, kQueryTile,
                    L - q0);

  // pass 1: fp32 scores of this tile's rows against every key
  for (int k0 = 0; k0 < L; k0 += kKeyTile) {
    __syncthreads();  // s_q staged / previous key tile consumed
    stage_rows<T, DH>(s_kv, kb + k0 * k_rstride, k_rstride, kKeyTile,
                      L - k0);
    __syncthreads();
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const int qi = q0 + r;
      if (qi >= L) break;
      const float* qrow = s_q + r * kStride;
      for (int c = lane; c < kKeyTile && k0 + c < L; c += 32) {
        const int kj = k0 + c;
        const float* krow = s_kv + c * kStride;
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < DH; ++d) s = fmaf(qrow[d], krow[d], s);
        if (scale != 1.f) s *= scale;
        if (bias != nullptr) s += bias[(static_cast<int64_t>(h) * L + qi) * L + kj];
        if (mask != nullptr && mask[static_cast<int64_t>(b) * L + kj] == 0)
          s = kNegInf;
        if (causal && kj > qi) s += kNegInf;
        s_scores[r * L + kj] = s;
      }
    }
  }
  __syncwarp();

  // exact softmax of the warp's own rows; p rounded to the value dtype
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    if (q0 + r >= L) break;
    float* srow = s_scores + r * L;
    float m = -INFINITY;
    for (int j = lane; j < L; j += 32) m = fmaxf(m, srow[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(srow[j] - m);
      srow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < L; j += 32)
      srow[j] = to_float(from_float<T>(srow[j] / sum));
  }
  __syncwarp();

  // pass 2: P.V in fp32, lanes over the head dimension
  float acc[kRowsPerWarp][kPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) acc[rr][i] = 0.f;
  for (int k0 = 0; k0 < L; k0 += kKeyTile) {
    __syncthreads();
    stage_rows<T, DH>(s_kv, vb + k0 * v_rstride, v_rstride, kKeyTile,
                      L - k0);
    __syncthreads();
    const int n = min(kKeyTile, L - k0);
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      if (q0 + r >= L) break;
      const float* prow = s_scores + r * L + k0;
      for (int c = 0; c < n; ++c) {
        const float p = prow[c];
        const float* vrow = s_kv + c * kStride;
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
          const int d = lane + 32 * i;
          if (d < DH) acc[rr][i] = fmaf(p, vrow[d], acc[rr][i]);
        }
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int qi = q0 + warp * kRowsPerWarp + rr;
    if (qi >= L) break;
    T* orow = out + (static_cast<int64_t>(b) * L + qi) * W + h * DH;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < DH) orow[d] = from_float<T>(acc[rr][i]);
    }
  }
}

size_t smem_bytes(int L, int Dh) {
  return sizeof(float) *
         (static_cast<size_t>(kQueryTile) * L +
          static_cast<size_t>(kQueryTile + kKeyTile) * (Dh + 1));
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   int64_t q_bs, int64_t q_rs, int64_t k_bs, int64_t k_rs,
                   int64_t v_bs, int64_t v_rs, const void* bias,
                   const void* mask, void* out, int B, int L, int H,
                   float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes(L, DH);
  auto kernel = row_attention_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + kQueryTile - 1) / kQueryTile, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
      static_cast<const float*>(bias), static_cast<const int*>(mask),
      static_cast<T*>(out), L, H, scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest sequence length whose score block fits in shared memory.
int mpr_row_attention_max_len(int Dh) {
  const size_t fixed = smem_bytes(0, Dh);
  return static_cast<int>((kMaxSmem - fixed) / (sizeof(float) * kQueryTile));
}

// Dh must be kHeadDim. dtype: 0 = float32, 1 = bfloat16. Strides are in
// elements; each tensor's head-dim stride is 1. bias: (H, L, L) fp32 or
// null; mask: (B, L) int32 or null; out: (B, L, H*Dh) contiguous.
int mpr_row_attention(const void* q, const void* k, const void* v,
                      int64_t q_bstride, int64_t q_rstride,
                      int64_t k_bstride, int64_t k_rstride,
                      int64_t v_bstride, int64_t v_rstride,
                      const void* bias, const void* mask, void* out, int B,
                      int L, int H, int Dh, float scale, int causal,
                      int dtype, void* stream) {
  if (Dh != kHeadDim || smem_bytes(L, Dh) > static_cast<size_t>(kMaxSmem))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0
          ? launch<float, kHeadDim>(q, k, v, q_bstride, q_rstride, k_bstride,
                                    k_rstride, v_bstride, v_rstride, bias,
                                    mask, out, B, L, H, scale, causal, s)
          : launch<__nv_bfloat16, kHeadDim>(q, k, v, q_bstride, q_rstride,
                                            k_bstride, k_rstride, v_bstride,
                                            v_rstride, bias, mask, out, B, L,
                                            H, scale, causal, s);
  return static_cast<int>(err);
}

const char* mpr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
