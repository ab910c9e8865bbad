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
// What bounds it on the H100: at the serving shapes (ViT L=50, text L=16,
// T5 encoder L=82..562, head dim 64) the function moves q, k, v and the
// output once and does 4 * L * L * 64 operations per (sequence, head), a
// tenth of the time of its bytes at the bf16 tensor-core rate: it is bound
// by bytes. Its earlier form did the products in fp32 on the CUDA cores at
// two shared-memory reads per multiply-add and staged k and v once per 32
// query rows, which left it 12x over that bound.
//
// Design, bf16 (tiles of attention_tiles.cuh; both products on the tensor
// cores, mma.sync m16n8k16 with fp32 accumulators):
//   * L <= 64 (ViT 50, text 16), row_attention_small_kernel: one block of 4
//     warps per (head, sequence) stages q, k and v once by cp.async; a warp
//     owns 16 query rows against all keys, so scores, the exact softmax
//     (quad shuffles) and the probabilities stay in registers, the rounded
//     accumulators of S being the A fragments of P. One barrier in all.
//   * longer L (T5 82..562), row_attention_mma_kernel: one block of 8 warps
//     per (32 query rows, head, sequence). Key tiles then value tiles of 64
//     rows stream through a ring of three shared buffers by cp.async, two
//     in flight while one is used. Scale, bias, mask and the causal term
//     are applied to the accumulators of S, which go into an fp32 score
//     block in shared memory (32 rows x L rounded up to 64, + 8 words a row
//     against bank conflicts: the exact-softmax contract rules out a
//     one-pass online softmax). Eight lanes to a row then take max, exp and
//     sum in place; O = P.V multiplies by 1 / sum and rounds p to bf16 as
//     it loads its fragments from that block.
// In both, the output tile leaves through shared memory in 16-byte rows,
// the bias is read in the dtype it comes in (fp32 or bf16), exp is the
// hardware's (__expf) and a row is normalised by one reciprocal (a true
// division per element takes a slow path for the zero weights of masked
// keys); both stay far inside the bf16 rounding of p. With causal and
// neither mask nor bias, the longer-L kernel skips the keys after a tile's
// last query row: each would weigh exp(s - 1e9 - max) == 0, since the
// diagonal is unmasked. (With a key mask a row's whole past can be masked,
// and then its future keys weigh as much as its masked ones: nothing is
// skipped.) Tensors whose base or strides are not 16-byte aligned take
// 2-byte loads instead of cp.async; nothing is copied.
//
// fp32 (row_attention_f32_kernel) keeps full fp32 products on the CUDA
// cores (no TF32), 32 query rows a block, with 16-byte loads where aligned
// and each staged key or value word used for four query rows.
//
// The largest L is 1,536 for both dtypes (mpr_row_attention_max_len): the
// 32-row score block beside the staged tiles in 227 KB of shared memory.

#include "attention_tiles.cuh"

namespace {

using namespace mpr_tiles;

__device__ __forceinline__ float bias_at(const void* bias, int64_t i,
                                         int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(bias)[i])
                 : static_cast<const float*>(bias)[i];
}

// score-block row length in words for `keys` keys
__host__ __device__ inline int score_stride(int keys) {
  return (keys + kTileRows - 1) / kTileRows * kTileRows + kScorePad;
}

// MIN_BLOCKS: blocks the compiler must fit on an SM by holding the
// registers down (4 where the score block is small enough for four: 29%
// faster at L=82, but 4-17% slower at L=562, where only two fit anyway)
template <int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS) row_attention_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, int64_t q_bstride, int64_t q_rstride,
    int64_t k_bstride, int64_t k_rstride, int64_t v_bstride,
    int64_t v_rstride, const void* __restrict__ bias, int bias_bf16,
    const int* __restrict__ mask, bf16* __restrict__ out, int L, int H,
    float scale, int causal, int vec) {
  constexpr int R = kQueryRows;
  constexpr int NRG = kRowGroups;
  constexpr int PAIRS = NRG / 2;  // 16-wide column pairs per warp per tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_raw);   // [32][72], later O
  bf16* s_kv = s_q + kQueryRows * kRowElems;                   // kStages x [64][72]
  float* s_inv = reinterpret_cast<float*>(s_kv + kStages * kTileElems);  // [R]
  float* s_p = s_inv + R;                          // [R][stride]

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % NRG, cs = warp / NRG;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qb = q + b * q_bstride + h * kHeadDim;
  const bf16* kb = k + b * k_bstride + h * kHeadDim;
  const bf16* vb = v + b * v_bstride + h * kHeadDim;
  const int* mask_b =
      mask != nullptr ? mask + static_cast<int64_t>(b) * L : nullptr;
  const int W = H * kHeadDim;

  // keys this tile reads: all, or (causal, no mask, no bias) those up to
  // its last query row
  const bool skip = causal && mask == nullptr && bias == nullptr;
  const int Lk = skip ? min(L, q0 + R) : L;
  const int n_tiles = (Lk + kTileRows - 1) / kTileRows;
  const int stride = score_stride(Lk);
  const int rows_valid = min(R, L - q0);
  const bool active = rg * 16 < rows_valid;  // warp-uniform

  // the stream of tiles: key tiles 0..n-1, then value tiles 0..n-1, through
  // a ring of kStages shared buffers, kStages - 1 tiles in flight
  auto prefetch = [&](int j) {
    if (j < 2 * n_tiles) {
      const int jt = j < n_tiles ? j : j - n_tiles;
      stage_tile(s_kv + (j % kStages) * kTileElems,
                 j < n_tiles ? kb + jt * kTileRows * k_rstride
                             : vb + jt * kTileRows * v_rstride,
                 j < n_tiles ? k_rstride : v_rstride, kTileRows,
                 min(kTileRows, Lk - jt * kTileRows), vec);
    }
    cp_async_commit();  // one group per tile index, empty past the end
  };
  stage_tile(s_q, qb + q0 * q_rstride, q_rstride, R, rows_valid, vec);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) prefetch(j);

  uint32_t qf[4][4];
  float o[PAIRS][2][4];
#pragma unroll
  for (int p = 0; p < PAIRS; ++p)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[p][nt][e] = 0.f;
  // the lane's two query rows and where their bias rows start
  const int qi2[2] = {q0 + rg * 16 + g, q0 + rg * 16 + g + 8};
  const int64_t brow[2] = {(static_cast<int64_t>(h) * L + qi2[0]) * L,
                           (static_cast<int64_t>(h) * L + qi2[1]) * L};
  static_assert(PAIRS == 1, "a warp takes 16 keys of each key tile");
  const int n0 = cs * 16;  // the warp's keys within a key tile
  // The bias and mask words of the warp's 16 x 16 scores of key tile `tile`
  // (zeros past the last tile), asked for before the product so that
  // their latency hides behind it. (Asking one tile ahead, into a second
  // set of registers, was slower at L=82 and no faster at L=562.)
  auto fetch = [&](int tile, float (&badd)[2][2][2], bool (&masked)[2][2]) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kje = tile * kTileRows + n0 + nt * 8 + 2 * t + e;
        const bool in = active && tile < n_tiles && kje < Lk;
        masked[nt][e] = in && mask_b != nullptr && mask_b[kje] == 0;
#pragma unroll
        for (int half = 0; half < 2; ++half)
          badd[nt][half][e] = in && bias != nullptr && qi2[half] < L
                                  ? bias_at(bias, brow[half] + kje, bias_bf16)
                                  : 0.f;
      }
  };
  for (int i = 0; i < 2 * n_tiles; ++i) {
    const bf16* cur = s_kv + (i % kStages) * kTileElems;
    cp_async_wait<kStages - 2>();
    // tile i (and, at i == 0, the query tile) has landed, and tile i - 1,
    // whose buffer the next copy takes, is consumed
    __syncthreads();
    prefetch(i + kStages - 1);
    if (i == 0 && active) load_q_frags(qf, s_q, rg * 16, lane);

    if (i == n_tiles) {
      // exact softmax, kLanesPerRow neighbouring lanes to a row (rows past
      // the last valid one hold unused values and are carried along): the
      // row's exponentials in place, zeros up to the next multiple of 16
      // keys, which O reads, and 1 / sum beside them; O multiplies and
      // rounds p to bf16 as it loads
      const int Lk16 = (Lk + 15) / 16 * 16;
      const int r = threadIdx.x / kLanesPerRow;
      float* srow = s_p + r * stride;
      const int sub = threadIdx.x % kLanesPerRow;
      float m = -INFINITY;
      for (int j = sub; j < Lk; j += kLanesPerRow) m = fmaxf(m, srow[j]);
      m = group_max<kLanesPerRow>(m);
      float sum = 0.f;
      for (int j = sub; j < Lk16; j += kLanesPerRow) {
        const float e = j < Lk ? fast_exp(srow[j] - m) : 0.f;
        srow[j] = e;
        sum += e;
      }
      sum = group_sum<kLanesPerRow>(sum);
      if (sub == 0) s_inv[r] = 1.f / sum;
      __syncthreads();  // the probabilities are published
    }

    if (i < n_tiles) {
      // S: the warp's 16 rows against its share of this tile's keys
      const int k0 = i * kTileRows;
      const int tile_valid = min(kTileRows, Lk - k0);
      if (active && n0 < tile_valid) {
        float badd[2][2][2];
        bool masked[2][2];
        fetch(i, badd, masked);
        float acc[2][4];
        qk_16x16(acc, qf, cur, n0, lane);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = rg * 16 + g + half * 8;
            const int kj = k0 + n0 + nt * 8 + 2 * t;
            float s[2] = {acc[nt][half * 2], acc[nt][half * 2 + 1]};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (scale != 1.f) s[e] *= scale;
              s[e] += badd[nt][half][e];
              if (masked[nt][e]) s[e] = kNegInf;
              if (causal && kj + e > qi2[half]) s[e] += kNegInf;
            }
            *reinterpret_cast<float2*>(s_p + r * stride + kj) =
                make_float2(s[0], s[1]);
          }
      }
    } else if (active) {
      // O: the warp's 16 rows against its share of the head dims
      const int jt = i - n_tiles;
      const int tile_valid = min(kTileRows, Lk - jt * kTileRows);
      const int ksteps = (tile_valid + 15) / 16;
      const float inv_lo = s_inv[rg * 16 + g], inv_hi = s_inv[rg * 16 + g + 8];
      for (int ks = 0; ks < ksteps; ++ks) {
        uint32_t a[4];
        load_p_frag(a, s_p, stride, rg * 16, jt * kTileRows + ks * 16, inv_lo,
                    inv_hi, lane);
#pragma unroll
        for (int p = 0; p < PAIRS; ++p)
          pv_16x16(o[p], a, cur, ks * 16, (cs * PAIRS + p) * 16, lane);
      }
    }
  }

  // the query tile's shared rows now carry the output tile
  if (active)
    put_o_tile<PAIRS>(s_q, o, rg * 16, cs * PAIRS * 16, 1.f, 1.f, lane);
  __syncthreads();
  store_o_tile(out + (static_cast<int64_t>(b) * L + q0) * W + h * kHeadDim, W,
               s_q, rows_valid);
}

// L <= 64: one block of 4 warps per (head, sequence), q, k and v staged once,
// a warp per 16 query rows, scores and probabilities in registers.
__global__ void __launch_bounds__(kSmallThreads) row_attention_small_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, int64_t q_bstride, int64_t q_rstride,
    int64_t k_bstride, int64_t k_rstride, int64_t v_bstride,
    int64_t v_rstride, const void* __restrict__ bias, int bias_bf16,
    const int* __restrict__ mask, bf16* __restrict__ out, int L, int H,
    float scale, int causal, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_raw);  // [64][72], later O
  bf16* s_k = s_q + kTileElems;
  bf16* s_v = s_k + kTileElems;

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int W = H * kHeadDim;
  stage_tile(s_q, q + b * q_bstride + h * kHeadDim, q_rstride, kTileRows,
             L, vec);
  stage_tile(s_k, k + b * k_bstride + h * kHeadDim, k_rstride, kTileRows,
             L, vec);
  stage_tile(s_v, v + b * v_bstride + h * kHeadDim, v_rstride, kTileRows,
             L, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int row0 = warp * 16;
  if (row0 >= L) return;  // no barrier follows

  uint32_t qf[4][4];
  load_q_frags(qf, s_q, row0, lane);
  float sacc[8][4];
  qk_16xK<4>(sacc, qf, s_k, L, lane);

  const int* mask_b =
      mask != nullptr ? mask + static_cast<int64_t>(b) * L : nullptr;
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kj = nt * 8 + 2 * t + e;
      const bool in = kj < L;
      const bool masked = in && mask_b != nullptr && mask_b[kj] == 0;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int qi = row0 + g + half * 8;
        float x = sacc[nt][half * 2 + e];
        if (scale != 1.f) x *= scale;
        if (bias != nullptr && in && qi < L)
          x += bias_at(bias, (static_cast<int64_t>(h) * L + qi) * L + kj,
                       bias_bf16);
        if (masked) x = kNegInf;
        if (causal && kj > qi) x += kNegInf;
        if (!in) x = -INFINITY;  // no such key: weight 0
        sacc[nt][half * 2 + e] = x;
        m[half] = fmaxf(m[half], x);
      }
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    m[half] = group_max<4>(m[half]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = fast_exp(sacc[nt][half * 2 + e] - m[half]);
        sacc[nt][half * 2 + e] = p;
        sum[half] += p;
      }
    const float inv = 1.f / group_sum<4>(sum[half]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        sacc[nt][half * 2 + e] *= inv;  // O rounds it to bf16
  }

  float o[4][2][4];
  pv_16xK<4>(o, sacc, s_v, L, lane);
  store_o_rows(out + static_cast<int64_t>(b) * L * W + h * kHeadDim, W, s_q,
               o, row0, L, 1.f, 1.f, lane);
}

__global__ void __launch_bounds__(kThreads) row_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, int64_t q_bstride, int64_t q_rstride,
    int64_t k_bstride, int64_t k_rstride, int64_t v_bstride,
    int64_t v_rstride, const void* __restrict__ bias, int bias_bf16,
    const int* __restrict__ mask, float* __restrict__ out, int L, int H,
    float scale, int causal, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_scores = reinterpret_cast<float*>(smem_raw);  // [32][L]
  float* s_q = s_scores + kF32QueryTile * L;             // [32][65]
  float* s_kv = s_q + kF32QueryTile * kF32Stride;        // [64][65]

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kF32QueryTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * kF32RowsPerWarp;  // the warp's first row of the tile
  const float* qb = q + b * q_bstride + h * kHeadDim;
  const float* kb = k + b * k_bstride + h * kHeadDim;
  const float* vb = v + b * v_bstride + h * kHeadDim;
  const int W = H * kHeadDim;

  stage_rows_f32(s_q, qb + q0 * q_rstride, q_rstride, kF32QueryTile, L - q0,
                 vec);

  // pass 1: fp32 scores of this tile's rows against every key
  for (int k0 = 0; k0 < L; k0 += kF32KeyTile) {
    __syncthreads();  // s_q staged / previous key tile consumed
    stage_rows_f32(s_kv, kb + k0 * k_rstride, k_rstride, kF32KeyTile, L - k0,
                   vec);
    __syncthreads();
    if (q0 + r0 >= L) continue;
    for (int c = lane; c < kF32KeyTile && k0 + c < L; c += 32) {
      const int kj = k0 + c;
      float s[kF32RowsPerWarp];
      qk_rows_f32(s, s_q + r0 * kF32Stride, s_kv + c * kF32Stride);
      const bool masked =
          mask != nullptr && mask[static_cast<int64_t>(b) * L + kj] == 0;
#pragma unroll
      for (int rr = 0; rr < kF32RowsPerWarp; ++rr) {
        const int qi = q0 + r0 + rr;
        if (qi >= L) break;
        float x = s[rr];
        if (scale != 1.f) x *= scale;
        if (bias != nullptr)
          x += bias_at(bias, (static_cast<int64_t>(h) * L + qi) * L + kj,
                       bias_bf16);
        if (masked) x = kNegInf;
        if (causal && kj > qi) x += kNegInf;
        s_scores[(r0 + rr) * L + kj] = x;
      }
    }
  }
  __syncwarp();

  // exact softmax of the warp's own rows
  for (int rr = 0; rr < kF32RowsPerWarp; ++rr) {
    if (q0 + r0 + rr >= L) break;
    float* srow = s_scores + (r0 + rr) * L;
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
    for (int j = lane; j < L; j += 32) srow[j] = srow[j] / sum;
  }
  __syncwarp();

  // pass 2: P.V in fp32, lanes over the head dimension
  float acc[kF32RowsPerWarp][2];
#pragma unroll
  for (int rr = 0; rr < kF32RowsPerWarp; ++rr) acc[rr][0] = acc[rr][1] = 0.f;
  for (int k0 = 0; k0 < L; k0 += kF32KeyTile) {
    __syncthreads();
    stage_rows_f32(s_kv, vb + k0 * v_rstride, v_rstride, kF32KeyTile, L - k0,
                   vec);
    __syncthreads();
    if (q0 + r0 >= L) continue;
    pv_rows_f32(acc, s_scores + r0 * L + k0, L, s_kv,
                min(kF32KeyTile, L - k0), lane);
  }
#pragma unroll
  for (int rr = 0; rr < kF32RowsPerWarp; ++rr) {
    const int qi = q0 + r0 + rr;
    if (qi >= L) break;
    float* orow = out + (static_cast<int64_t>(b) * L + qi) * W + h * kHeadDim;
    orow[lane] = acc[rr][0];
    orow[lane + 32] = acc[rr][1];
  }
}

constexpr size_t kSmallSmem = 3 * kTileElems * sizeof(bf16);  // q, k, v
constexpr size_t kMmaFixedSmem = (kQueryRows * kRowElems + kStages * kTileElems) * sizeof(bf16) +
    kQueryRows * sizeof(float);

size_t mma_smem_bytes(int L) {
  return kMmaFixedSmem + sizeof(float) * kQueryRows * score_stride(L);
}

size_t f32_smem_bytes(int L) {
  return sizeof(float) * (static_cast<size_t>(kF32QueryTile) * L +
                          static_cast<size_t>(kF32QueryTile + kF32KeyTile) *
                              kF32Stride);
}

// Largest L of both dtypes: the 32-row score block of the bf16 kernel (the
// fp32 kernel's block of 32 unpadded rows is smaller).
constexpr int kMaxLen =
    ((kMaxSmem - static_cast<int>(kMmaFixedSmem)) / (4 * kQueryRows) -
     kScorePad) /
    kTileRows * kTileRows;

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
}

}  // namespace

extern "C" {

// Largest sequence length whose score block fits in shared memory.
int mpr_row_attention_max_len(int /*Dh*/) { return kMaxLen; }

// Dh must be 64. dtype / bias_dtype: 0 = float32, 1 = bfloat16. Strides are
// in elements; each tensor's head-dim stride is 1. bias: (H, L, L)
// contiguous or null; mask: (B, L) int32 or null; out: (B, L, H*Dh)
// contiguous.
int mpr_row_attention(const void* q, const void* k, const void* v,
                      int64_t q_bstride, int64_t q_rstride,
                      int64_t k_bstride, int64_t k_rstride,
                      int64_t v_bstride, int64_t v_rstride,
                      const void* bias, int bias_dtype, const void* mask,
                      void* out, int B, int L, int H, int Dh, float scale,
                      int causal, int dtype, void* stream) {
  if (Dh != kHeadDim || L < 1 || L > kMaxLen || B < 1 || H < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte loads need aligned bases and strides (in elements of the dtype)
  const int64_t per16 = dtype == 0 ? 4 : 8;
  const bool vec = aligned16(q) && aligned16(k) && aligned16(v) &&
                   q_bstride % per16 == 0 && q_rstride % per16 == 0 &&
                   k_bstride % per16 == 0 && k_rstride % per16 == 0 &&
                   v_bstride % per16 == 0 && v_rstride % per16 == 0;
  const int* m = static_cast<const int*>(mask);
  cudaError_t err;
  if (dtype == 0) {
    if ((err = allow_smem(row_attention_f32_kernel)) != cudaSuccess)
      return err;
    dim3 grid((L + kF32QueryTile - 1) / kF32QueryTile, H, B);
    row_attention_f32_kernel<<<grid, kThreads, f32_smem_bytes(L), s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), q_bstride, q_rstride, k_bstride,
        k_rstride, v_bstride, v_rstride, bias, bias_dtype, m,
        static_cast<float*>(out), L, H, scale, causal, vec);
  } else {
    const bf16* qp = static_cast<const bf16*>(q);
    const bf16* kp = static_cast<const bf16*>(k);
    const bf16* vp = static_cast<const bf16*>(v);
    bf16* op = static_cast<bf16*>(out);
    if (L <= kTileRows) {
      dim3 grid(1, H, B);
      row_attention_small_kernel<<<grid, kSmallThreads, kSmallSmem, s>>>(
          qp, kp, vp, q_bstride, q_rstride, k_bstride, k_rstride, v_bstride,
          v_rstride, bias, bias_dtype, m, op, L, H, scale, causal, vec);
    } else {
      auto kernel = 4 * (mma_smem_bytes(L) + 1024) <= kSmSmem
                        ? row_attention_mma_kernel<4>
                        : row_attention_mma_kernel<1>;
      if ((err = allow_smem(kernel)) != cudaSuccess) return err;
      dim3 grid((L + kQueryRows - 1) / kQueryRows, H, B);
      kernel<<<grid, kThreads, mma_smem_bytes(L), s>>>(
          qp, kp, vp, q_bstride, q_rstride, k_bstride, k_rstride, v_bstride,
          v_rstride, bias, bias_dtype, m, op, L, H, scale, causal, vec);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* mpr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
