// Blockwise (flash) multi-head attention over (B, H, L, Dh), for Hopper
// (sm_90a). Forward only, as the TPU kernel is.
//
// Replaces the Pallas kernel _flash_kernel behind _flash_attention
// (multimodalpromptretrieval_tpu/ops/attention.py), which the T5 encoder and
// both CLIP towers run under attention_impl "pallas" / "auto". Its plain
// PyTorch version is flash_attention_reference
// (multimodalpromptretrieval_tpu_torch/ops/attention.py).
//
// Semantics, kept exactly (the function of the TPU kernel, not of
// _attention_xla: at bf16 the two round at different points):
//   * the key axis runs in the TPU kernel's blocks of block_k keys (the
//     wrapper passes the JAX clamps); keys past Lk pad the last block, are
//     masked by col < Lk, and carry zero values;
//   * per block: fp32 scores q.k * scale + bias; a key-mask zero, a padded
//     key or (causal) a future key REPLACES the score with -1e9; the running
//     max m_new = max(m, block max) (m starts at -1e9, not -inf);
//     p = exp(s - m_new); alpha = exp(m - m_new); l = l * alpha + sum(p) in
//     fp32 over the unrounded p; acc = acc * alpha + P.V with p ROUNDED to
//     the value dtype against this block's running max;
//   * with causal, a key block that lies wholly after a query row's TPU
//     query block (block_q rows) is skipped for that row, as the TPU grid
//     skips it; this changes a value only for a row masked so far;
//   * output acc / l, rounded once.
// Padded keys are not loaded: each adds exp(-1e9 - m_new) to l (1 when the
// row is fully masked so far, else 0) and nothing to acc.
//
// What bounds it on the H100: at the serving shapes (ViT L=50, text L=16,
// T5 encoder L=82..562, head dim 64) it reads q/k/v once and does
// 4 * L^2 * 64 flops per (sequence, head) on the CUDA cores in fp32: the
// small L keep it latency- and instruction-bound rather than bound by
// device memory. The design keeps every score and probability in shared
// memory and reads q/k/v straight from the strided (B, H, L, Dh) views of
// the fused QKV GEMM output (no head-split copies); it writes the output as
// (B, L, H, Dh) rows so the head merge after it is free. Tensor-core tiles
// (wgmma) are later work.
//
// Design: one block per ((batch, head), 32-row query tile), 8 warps of 4
// query rows each, the running m / l / acc of a row in its warp's
// registers (lanes over the 64 head dims). For each TPU key block the block
// streams K through a 64-row shared tile and writes the fp32 scores of its
// 32 rows x the block's keys into shared memory (32 x min(block_k, Lk)
// floats, 128 KB at block_k = 1,024), then each warp takes its rows' block
// max, exponentiates, rounds p in place, and the block streams V through
// the same shared tile for P.V. Instantiated for head dim 64.

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

// rows [0, count) of a strided (rows, DH) source into fp32 shared rows of
// DH + 1 words (the pad keeps per-lane row reads on distinct banks); rows
// at or past `valid` are zero
template <typename T, int DH>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           int64_t row_stride, int count,
                                           int valid) {
  constexpr int kStride = DH + 1;
  for (int i = threadIdx.x; i < count * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    dst[r * kStride + d] = r < valid ? to_float(src[r * row_stride + d]) : 0.f;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    int64_t q_bs, int64_t q_hs, int64_t q_rs, int64_t k_bs, int64_t k_hs,
    int64_t k_rs, int64_t v_bs, int64_t v_hs, int64_t v_rs,
    const float* __restrict__ bias, int bias_b, int bias_h,
    const int* __restrict__ mask, T* __restrict__ out, int H, int Lq, int Lk,
    float scale, int causal, int block_q, int block_k) {
  constexpr int kStride = DH + 1;
  constexpr int kPerLane = DH / 32;
  extern __shared__ float smem[];
  const int cols = min(block_k, Lk);            // score columns per key block
  float* s_scores = smem;                       // [kQueryTile][cols]
  float* s_q = s_scores + kQueryTile * cols;    // [kQueryTile][DH + 1]
  float* s_kv = s_q + kQueryTile * kStride;     // [kKeyTile][DH + 1]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * kQueryTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qb = q + b * q_bs + h * q_hs;
  const T* kb = k + b * k_bs + h * k_hs;
  const T* vb = v + b * v_bs + h * v_hs;
  const float* bias_bh =
      bias != nullptr
          ? bias + static_cast<int64_t>((b % bias_b) * bias_h + h % bias_h) *
                       Lq * Lk
          : nullptr;
  const int* mask_b =
      mask != nullptr ? mask + static_cast<int64_t>(b) * Lk : nullptr;

  stage_rows<T, DH>(s_q, qb + q0 * q_rs, q_rs, kQueryTile, Lq - q0);

  // a row's running state: the TPU kernel's m / l / acc scratch
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) acc[rr][i] = 0.f;
  }
  // whether the TPU grid computes key block kb0 for query row qi
  auto live = [&](int qi, int kb0) {
    return !causal || kb0 <= (qi / block_q) * block_q + block_q - 1;
  };
  const int last_row = min(q0 + kQueryTile, Lq) - 1;

  for (int kb0 = 0; kb0 < Lk; kb0 += block_k) {
    // skipped for every row of the tile, and so is every later block
    if (!live(last_row, kb0)) break;
    const int kend = min(kb0 + block_k, Lk);
    const int n_pad = kb0 + block_k - kend;

    // pass 1: the block's fp32 scores of the tile's rows
    for (int k0 = kb0; k0 < kend; k0 += kKeyTile) {
      __syncthreads();  // s_q staged / the previous tile consumed
      stage_rows<T, DH>(s_kv, kb + k0 * k_rs, k_rs, kKeyTile, kend - k0);
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int r = warp * kRowsPerWarp + rr;
        const int qi = q0 + r;
        if (qi >= Lq) break;
        if (!live(qi, kb0)) continue;
        const float* qrow = s_q + r * kStride;
        for (int c = lane; c < kKeyTile && k0 + c < kend; c += 32) {
          const int kj = k0 + c;
          const float* krow = s_kv + c * kStride;
          float s = 0.f;
#pragma unroll
          for (int d = 0; d < DH; ++d) s = fmaf(qrow[d], krow[d], s);
          if (scale != 1.f) s *= scale;
          if (bias_bh != nullptr) s += bias_bh[static_cast<int64_t>(qi) * Lk + kj];
          const bool valid = (mask_b == nullptr || mask_b[kj] != 0) &&
                             (!causal || kj <= qi);
          s_scores[r * cols + (kj - kb0)] = valid ? s : kNegInf;
        }
      }
    }
    __syncwarp();

    // online-softmax step of each of the warp's rows
    float alpha[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) alpha[rr] = 1.f;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const int qi = q0 + r;
      if (qi >= Lq) break;
      if (!live(qi, kb0)) continue;
      float* srow = s_scores + r * cols;
      const int n = kend - kb0;
      float mc = n_pad > 0 ? kNegInf : -INFINITY;
      for (int j = lane; j < n; j += 32) mc = fmaxf(mc, srow[j]);
      const float m_new = fmaxf(m[rr], warp_max(mc));
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(srow[j] - m_new);
        sum += p;
        srow[j] = to_float(from_float<T>(p));
      }
      sum = warp_sum(sum);
      if (n_pad > 0) sum += static_cast<float>(n_pad) * expf(kNegInf - m_new);
      alpha[rr] = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha[rr] + sum;
      m[rr] = m_new;
    }
    __syncwarp();

    // pass 2: the block's P.V in fp32, lanes over the head dims
    float pv[kRowsPerWarp][kPerLane];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) pv[rr][i] = 0.f;
    for (int k0 = kb0; k0 < kend; k0 += kKeyTile) {
      __syncthreads();
      stage_rows<T, DH>(s_kv, vb + k0 * v_rs, v_rs, kKeyTile, kend - k0);
      __syncthreads();
      const int n = min(kKeyTile, kend - k0);
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int r = warp * kRowsPerWarp + rr;
        const int qi = q0 + r;
        if (qi >= Lq) break;
        if (!live(qi, kb0)) continue;
        const float* prow = s_scores + r * cols + (k0 - kb0);
        for (int c = 0; c < n; ++c) {
          const float p = prow[c];
          const float* vrow = s_kv + c * kStride;
#pragma unroll
          for (int i = 0; i < kPerLane; ++i)
            pv[rr][i] = fmaf(p, vrow[lane + 32 * i], pv[rr][i]);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int qi = q0 + warp * kRowsPerWarp + rr;
      if (qi >= Lq || !live(qi, kb0)) continue;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i)
        acc[rr][i] = acc[rr][i] * alpha[rr] + pv[rr][i];
    }
  }

  // out is (B, Lq, H, DH) rows
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int qi = q0 + warp * kRowsPerWarp + rr;
    if (qi >= Lq) break;
    T* orow = out + ((static_cast<int64_t>(b) * Lq + qi) * H + h) * DH;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i)
      orow[lane + 32 * i] = from_float<T>(acc[rr][i] / l[rr]);
  }
}

size_t smem_bytes(int cols, int Dh) {
  return sizeof(float) *
         (static_cast<size_t>(kQueryTile) * cols +
          static_cast<size_t>(kQueryTile + kKeyTile) * (Dh + 1));
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int64_t* st, const void* bias, int bias_b,
                   int bias_h, const void* mask, void* out, int B, int H,
                   int Lq, int Lk, float scale, int causal, int block_q,
                   int block_k, cudaStream_t stream) {
  const int cols = block_k < Lk ? block_k : Lk;
  auto kernel = flash_attention_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Lq + kQueryTile - 1) / kQueryTile);
  kernel<<<grid, kThreads, smem_bytes(cols, DH), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], static_cast<const float*>(bias), bias_b, bias_h,
      static_cast<const int*>(mask), static_cast<T*>(out), H, Lq, Lk, scale,
      causal, block_q, block_k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest number of score columns (keys of one TPU block) that fits.
int mpr_flash_attention_max_cols(int Dh) {
  const size_t fixed = smem_bytes(0, Dh);
  return static_cast<int>((kMaxSmem - fixed) / (sizeof(float) * kQueryTile));
}

// q (B, H, Lq, Dh), k / v (B, H, Lk, Dh) through (batch, head, row) strides
// with unit last stride; Dh must be kHeadDim. bias: (bias_b, bias_h, Lq, Lk)
// fp32 contiguous or null, read at row (b % bias_b, h % bias_h); mask:
// (B, Lk) int32 or null; out: (B, Lq, H, Dh) contiguous. block_q / block_k:
// the TPU kernel's clamped blocks. dtype: 0 = float32, 1 = bfloat16.
int mpr_flash_attention(const void* q, const void* k, const void* v,
                        int64_t q_bs, int64_t q_hs, int64_t q_rs,
                        int64_t k_bs, int64_t k_hs, int64_t k_rs,
                        int64_t v_bs, int64_t v_hs, int64_t v_rs,
                        const void* bias, int bias_b, int bias_h,
                        const void* mask, void* out, int B, int H, int Lq,
                        int Lk, int Dh, float scale, int causal, int block_q,
                        int block_k, int dtype, void* stream) {
  const int cols = block_k < Lk ? block_k : Lk;
  if (Dh != kHeadDim || B < 1 || H < 1 || Lq < 1 || Lk < 1 || block_q < 1 ||
      block_k < 1 || bias_b < 1 || bias_h < 1 ||
      (Lq + kQueryTile - 1) / kQueryTile > 65535 ||
      smem_bytes(cols, Dh) > static_cast<size_t>(kMaxSmem))
    return cudaErrorInvalidValue;
  const int64_t st[9] = {q_bs, q_hs, q_rs, k_bs, k_hs, k_rs, v_bs, v_hs, v_rs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0
          ? launch<float, kHeadDim>(q, k, v, st, bias, bias_b, bias_h, mask,
                                    out, B, H, Lq, Lk, scale, causal, block_q,
                                    block_k, s)
          : launch<__nv_bfloat16, kHeadDim>(q, k, v, st, bias, bias_b, bias_h,
                                            mask, out, B, H, Lq, Lk, scale,
                                            causal, block_q, block_k, s);
  return static_cast<int>(err);
}

}  // extern "C"
