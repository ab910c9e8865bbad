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
// T5 encoder L=82..562, head dim 64) the function moves q, k, v and the
// output once and does 4 * Lq * Lk * 64 operations per (batch, head), a
// tenth of the time of its bytes at the bf16 tensor-core rate: it is bound
// by bytes. Its earlier form did the products in fp32 on the CUDA cores and
// staged k and v once per 32 query rows, 17x over that bound.
//
// Design, bf16 (tiles of attention_tiles.cuh; both products on the tensor
// cores, mma.sync m16n8k16 with fp32 accumulators):
//   * Lk <= 64 (ViT 50, text 16; one TPU key block),
//     flash_attention_small_kernel: one block of 4 warps per ((batch, head),
//     64 query rows) stages q, k and v once by cp.async; a warp owns 16
//     query rows against all keys, so the masked scores, the block's max,
//     the unnormalised p and its fp32 sum stay in registers, the rounded
//     accumulators of S being the A fragments of P. One barrier in all.
//   * longer Lk, flash_attention_mma_kernel: one block of 8 warps per
//     ((batch, head), 32 query rows). For each TPU key block, key tiles
//     then value tiles of 64 rows stream through a ring of three shared
//     buffers by cp.async; the masked scores of the whole block go into an
//     fp32 block in shared memory (m_new is the max over a whole TPU block,
//     so p cannot be rounded tile by tile; 32 rows x 1,024 keys fit); eight
//     lanes to a row take the online-softmax step (m, l and alpha of a row
//     live in shared memory); the block's P.V rounds the unnormalised p to
//     bf16 as it loads its fragments and is folded as
//     acc = acc * alpha + P.V. At every serving shape there is one TPU
//     block.
// Output tiles leave through shared memory in 16-byte rows, as
// (B, Lq, H, Dh) so that the head merge after it is free. exp is the
// hardware's (__expf), far inside the bf16 rounding of p. With causal and
// neither mask nor bias, the longer-Lk kernel does not compute the keys
// after a tile's last query row: key 0 is valid for every row, so the
// running max is a real score from the first block on and such a key adds
// exp(-1e9 - m) == 0 to l and to acc. Tensors whose base or strides are
// not 16-byte aligned take 2-byte loads instead of cp.async.
//
// fp32 (flash_attention_f32_kernel) keeps full fp32 products on the CUDA
// cores (no TF32), 32 query rows a block, 16-byte loads where aligned, each
// staged key or value word used for four query rows.
//
// The largest key block is 1,536 keys (mpr_flash_attention_max_cols).

#include <initializer_list>

#include "attention_tiles.cuh"

namespace {

using namespace mpr_tiles;

__host__ __device__ inline int score_stride(int keys) {
  return (keys + kTileRows - 1) / kTileRows * kTileRows + kScorePad;
}

// MIN_BLOCKS: blocks the compiler must fit on an SM by holding the
// registers down (4 where the score block is small enough for four: 29%
// faster at L=82, but 4-17% slower at L=562, where only two fit anyway)
template <int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS) flash_attention_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, int64_t q_bs, int64_t q_hs, int64_t q_rs,
    int64_t k_bs, int64_t k_hs, int64_t k_rs, int64_t v_bs, int64_t v_hs,
    int64_t v_rs, const float* __restrict__ bias, int bias_b, int bias_h,
    const int* __restrict__ mask, bf16* __restrict__ out, int H, int Lq,
    int Lk, float scale, int causal, int block_q, int block_k, int vec) {
  constexpr int R = kQueryRows;
  constexpr int NRG = kRowGroups;
  constexpr int PAIRS = NRG / 2;  // 16-wide column pairs per warp per tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_raw);   // [32][72], later O
  bf16* s_kv = s_q + kQueryRows * kRowElems;                   // kStages x [64][72]
  float* s_m =
      reinterpret_cast<float*>(s_kv + kStages * kTileElems);  // [64]
  float* s_l = s_m + kTileRows;                                  // [64]
  float* s_alpha = s_l + kTileRows;                              // [64]
  float* s_p = s_alpha + kTileRows;                // [R][stride]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % NRG, cs = warp / NRG;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qb = q + b * q_bs + h * q_hs;
  const bf16* kb = k + b * k_bs + h * k_hs;
  const bf16* vb = v + b * v_bs + h * v_hs;
  const float* bias_bh =
      bias != nullptr
          ? bias + static_cast<int64_t>((b % bias_b) * bias_h + h % bias_h) *
                       Lq * Lk
          : nullptr;
  const int* mask_b =
      mask != nullptr ? mask + static_cast<int64_t>(b) * Lk : nullptr;

  const int stride = score_stride(min(block_k, Lk));
  const int rows_valid = min(R, Lq - q0);
  const bool active = rg * 16 < rows_valid;  // warp-uniform
  // keys after the tile's last query row add exactly nothing (see above)
  const bool trim = causal && mask == nullptr && bias == nullptr;
  // whether the TPU grid computes key block kb0 for query row qi
  auto live = [&](int qi, int kb0) {
    return !causal || kb0 <= (qi / block_q) * block_q + block_q - 1;
  };
  const int last_row = q0 + rows_valid - 1;

  for (int i = threadIdx.x; i < kTileRows; i += kThreads) {
    s_m[i] = kNegInf;
    s_l[i] = 0.f;
  }
  stage_tile(s_q, qb + q0 * q_rs, q_rs, R, rows_valid, vec);  // first commit

  uint32_t qf[4][4];
  float o[PAIRS][2][4];
#pragma unroll
  for (int p = 0; p < PAIRS; ++p)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[p][nt][e] = 0.f;
  bool have_q = false;
  static_assert(PAIRS == 1, "a warp takes 16 keys of each key tile");
  const int n0 = cs * 16;  // the warp's keys within a key tile
  // the lane's two query rows and their bias rows
  const int qi2[2] = {q0 + rg * 16 + g, q0 + rg * 16 + g + 8};
  const float* brow[2] = {
      bias_bh != nullptr ? bias_bh + static_cast<int64_t>(qi2[0]) * Lk : nullptr,
      bias_bh != nullptr ? bias_bh + static_cast<int64_t>(qi2[1]) * Lk : nullptr};

  for (int kb0 = 0; kb0 < Lk; kb0 += block_k) {
    // skipped for every row of the tile, and so is every later block
    if (!live(last_row, kb0)) break;
    if (trim && kb0 > last_row) break;
    const int kend = min(kb0 + block_k, Lk);
    // score columns of this block: its keys, or those up to the last row
    const int ncols = trim ? min(kend, last_row + 1) - kb0 : kend - kb0;
    // the block's other keys (padding past Lk, trimmed future keys) are not
    // computed: each counts as a score of -1e9
    const int uncounted = block_k - ncols;
    const int n_tiles = (ncols + kTileRows - 1) / kTileRows;

    float pv[PAIRS][2][4];
#pragma unroll
    for (int p = 0; p < PAIRS; ++p)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[p][nt][e] = 0.f;

    // the block's stream of tiles: key tiles 0..n-1, then value tiles,
    // through a ring of kStages shared buffers, kStages - 1 tiles in flight
    auto prefetch = [&](int j) {
      if (j < 2 * n_tiles) {
        const int jt = j < n_tiles ? j : j - n_tiles;
        const int row = kb0 + jt * kTileRows;
        stage_tile(s_kv + (j % kStages) * kTileElems,
                   j < n_tiles ? kb + row * k_rs : vb + row * v_rs,
                   j < n_tiles ? k_rs : v_rs, kTileRows,
                   min(kTileRows, ncols - jt * kTileRows), vec);
      }
      cp_async_commit();  // one group per tile index, empty past the end
    };
    // The bias and mask words of the warp's 16 x 16 scores of the block's
    // key tile `tile` (zeros past the last tile), asked for before the
    // product so that their latency hides behind it.
    auto fetch = [&](int tile, float (&badd)[2][2][2],
                     bool (&unmasked)[2][2]) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kje = kb0 + tile * kTileRows + n0 + nt * 8 + 2 * t + e;
          const bool in = active && tile < n_tiles && kje < kb0 + ncols;
          unmasked[nt][e] = in && (mask_b == nullptr || mask_b[kje] != 0);
#pragma unroll
          for (int half = 0; half < 2; ++half)
            badd[nt][half][e] = in && bias_bh != nullptr && qi2[half] < Lq
                                    ? brow[half][kje]
                                    : 0.f;
        }
    };
#pragma unroll
    for (int j = 0; j < kStages - 1; ++j) prefetch(j);
    for (int i = 0; i < 2 * n_tiles; ++i) {
      const bf16* cur = s_kv + (i % kStages) * kTileElems;
      cp_async_wait<kStages - 2>();
      // tile i (and, at first, the query tile) has landed, and tile i - 1,
      // whose buffer the next copy takes, is consumed
      __syncthreads();
      prefetch(i + kStages - 1);
      if (!have_q) {
        if (active) load_q_frags(qf, s_q, rg * 16, lane);
        have_q = true;
      }

      if (i == n_tiles) {
        // online-softmax step, kLanesPerRow neighbouring lanes to a row
        // (rows past the last valid one hold unused values and are carried
        // along); the unnormalised p in place (P.V rounds it to bf16 as it
        // loads), zeros up to the next multiple of 16 keys, which P.V reads.
        // A row that the TPU grid skips here keeps its state and gets zero
        // probabilities.
        const int ncols16 = (ncols + 15) / 16 * 16;
        const int r = threadIdx.x / kLanesPerRow;
        const int sub = threadIdx.x % kLanesPerRow;
        float* srow = s_p + r * stride;
        const bool lv = live(q0 + r, kb0);
        float mc = uncounted > 0 ? kNegInf : -INFINITY;
        for (int j = sub; j < ncols; j += kLanesPerRow)
          mc = fmaxf(mc, srow[j]);
        const float m_old = s_m[r];
        const float m_new = fmaxf(m_old, group_max<kLanesPerRow>(mc));
        float sum = 0.f;
        for (int j = sub; j < ncols16; j += kLanesPerRow) {
          const float p = j < ncols ? fast_exp(srow[j] - m_new) : 0.f;
          sum += p;
          srow[j] = lv ? p : 0.f;
        }
        sum = group_sum<kLanesPerRow>(sum);
        if (uncounted > 0)
          sum += static_cast<float>(uncounted) * fast_exp(kNegInf - m_new);
        if (sub == 0) {
          const float alpha = lv ? fast_exp(m_old - m_new) : 1.f;
          s_alpha[r] = alpha;
          if (lv) {
            s_l[r] = s_l[r] * alpha + sum;
            s_m[r] = m_new;
          }
        }
        __syncthreads();  // p and alpha are published
      }

      if (i < n_tiles) {
        // S: the warp's 16 rows against its share of this tile's keys
        const int k0 = kb0 + i * kTileRows;
        const int tile_valid = min(kTileRows, kb0 + ncols - k0);
        if (active && n0 < tile_valid) {
          float badd[2][2][2];
          bool unmasked[2][2];
          fetch(i, badd, unmasked);
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
                if (!unmasked[nt][e] || (causal && kj + e > qi2[half]))
                  s[e] = kNegInf;
              }
              *reinterpret_cast<float2*>(s_p + r * stride + (kj - kb0)) =
                  make_float2(s[0], s[1]);
            }
        }
      } else if (active) {
        // P.V: the warp's 16 rows against its share of the head dims
        const int jt = i - n_tiles;
        const int tile_valid = min(kTileRows, ncols - jt * kTileRows);
        const int ksteps = (tile_valid + 15) / 16;
        for (int ks = 0; ks < ksteps; ++ks) {
          uint32_t a[4];
          load_p_frag(a, s_p, stride, rg * 16, jt * kTileRows + ks * 16, 1.f,
                      1.f, lane);
#pragma unroll
          for (int p = 0; p < PAIRS; ++p)
            pv_16x16(pv[p], a, cur, ks * 16, (cs * PAIRS + p) * 16, lane);
        }
      }
    }
    // every warp is done with the block's tiles and probabilities
    __syncthreads();
    if (active) {
      const float a_lo = s_alpha[rg * 16 + g], a_hi = s_alpha[rg * 16 + g + 8];
#pragma unroll
      for (int p = 0; p < PAIRS; ++p)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          o[p][nt][0] = o[p][nt][0] * a_lo + pv[p][nt][0];
          o[p][nt][1] = o[p][nt][1] * a_lo + pv[p][nt][1];
          o[p][nt][2] = o[p][nt][2] * a_hi + pv[p][nt][2];
          o[p][nt][3] = o[p][nt][3] * a_hi + pv[p][nt][3];
        }
    }
  }

  // acc / l, rounded once, through the query tile's shared rows
  if (active) {
    const float l_lo = s_l[rg * 16 + g], l_hi = s_l[rg * 16 + g + 8];
#pragma unroll
    for (int p = 0; p < PAIRS; ++p)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        o[p][nt][0] /= l_lo;
        o[p][nt][1] /= l_lo;
        o[p][nt][2] /= l_hi;
        o[p][nt][3] /= l_hi;
      }
    put_o_tile<PAIRS>(s_q, o, rg * 16, cs * PAIRS * 16, 1.f, 1.f, lane);
  }
  __syncthreads();
  // out is (B, Lq, H, 64) rows
  store_o_tile(out + ((static_cast<int64_t>(b) * Lq + q0) * H + h) * kHeadDim,
               static_cast<int64_t>(H) * kHeadDim, s_q, rows_valid);
}

// Lk <= 64 (one key tile, one TPU key block): one block of 4 warps per
// ((batch, head), 64 query rows), q, k and v staged once, a warp per 16
// query rows, scores and probabilities in registers. `uncounted`: the keys
// that pad the TPU block, each a score of -1e9.
__global__ void __launch_bounds__(kSmallThreads) flash_attention_small_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, int64_t q_bs, int64_t q_hs, int64_t q_rs,
    int64_t k_bs, int64_t k_hs, int64_t k_rs, int64_t v_bs, int64_t v_hs,
    int64_t v_rs, const float* __restrict__ bias, int bias_b, int bias_h,
    const int* __restrict__ mask, bf16* __restrict__ out, int H, int Lq,
    int Lk, float scale, int causal, int uncounted, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_raw);  // [64][72], later O
  bf16* s_k = s_q + kTileElems;
  bf16* s_v = s_k + kTileElems;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * kTileRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rows_valid = min(kTileRows, Lq - q0);
  stage_tile(s_q, q + b * q_bs + h * q_hs + q0 * q_rs, q_rs, kTileRows,
             rows_valid, vec);
  stage_tile(s_k, k + b * k_bs + h * k_hs, k_rs, kTileRows, Lk, vec);
  stage_tile(s_v, v + b * v_bs + h * v_hs, v_rs, kTileRows, Lk, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int row0 = warp * 16;
  if (row0 >= rows_valid) return;  // no barrier follows

  uint32_t qf[4][4];
  load_q_frags(qf, s_q, row0, lane);
  float sacc[8][4];
  qk_16xK<4>(sacc, qf, s_k, Lk, lane);

  const float* bias_bh =
      bias != nullptr
          ? bias + static_cast<int64_t>((b % bias_b) * bias_h + h % bias_h) *
                       Lq * Lk
          : nullptr;
  const int* mask_b =
      mask != nullptr ? mask + static_cast<int64_t>(b) * Lk : nullptr;
  float m[2];
  m[0] = m[1] = uncounted > 0 ? kNegInf : -INFINITY;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kj = nt * 8 + 2 * t + e;
      const bool in = kj < Lk;
      const bool unmasked = in && (mask_b == nullptr || mask_b[kj] != 0);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int qi = q0 + row0 + g + half * 8;
        float x = sacc[nt][half * 2 + e];
        if (scale != 1.f) x *= scale;
        if (bias_bh != nullptr && in && qi < Lq)
          x += bias_bh[static_cast<int64_t>(qi) * Lk + kj];
        if (!unmasked || (causal && kj > qi)) x = kNegInf;
        if (!in) x = -INFINITY;  // counted through `uncounted`
        sacc[nt][half * 2 + e] = x;
        m[half] = fmaxf(m[half], x);
      }
    }
  float inv_l[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    // the running max starts at -1e9
    const float m_new = fmaxf(kNegInf, group_max<4>(m[half]));
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = fast_exp(sacc[nt][half * 2 + e] - m_new);
        sum += p;
        sacc[nt][half * 2 + e] = p;  // P.V rounds it to bf16
      }
    sum = group_sum<4>(sum);
    if (uncounted > 0)
      sum += static_cast<float>(uncounted) * fast_exp(kNegInf - m_new);
    inv_l[half] = 1.f / sum;
  }

  float o[4][2][4];
  pv_16xK<4>(o, sacc, s_v, Lk, lane);
#pragma unroll
  for (int dp = 0; dp < 4; ++dp)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      o[dp][nt][0] *= inv_l[0];
      o[dp][nt][1] *= inv_l[0];
      o[dp][nt][2] *= inv_l[1];
      o[dp][nt][3] *= inv_l[1];
    }
  // out is (B, Lq, H, 64) rows
  store_o_rows(out + ((static_cast<int64_t>(b) * Lq + q0) * H + h) * kHeadDim,
               static_cast<int64_t>(H) * kHeadDim, s_q, o, row0, rows_valid,
               1.f, 1.f, lane);
}

__global__ void __launch_bounds__(kThreads) flash_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, int64_t q_bs, int64_t q_hs, int64_t q_rs,
    int64_t k_bs, int64_t k_hs, int64_t k_rs, int64_t v_bs, int64_t v_hs,
    int64_t v_rs, const float* __restrict__ bias, int bias_b, int bias_h,
    const int* __restrict__ mask, float* __restrict__ out, int H, int Lq,
    int Lk, float scale, int causal, int block_q, int block_k, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cols = min(block_k, Lk);            // score columns per key block
  float* s_scores = reinterpret_cast<float*>(smem_raw);  // [32][cols]
  float* s_q = s_scores + kF32QueryTile * cols;          // [32][65]
  float* s_kv = s_q + kF32QueryTile * kF32Stride;        // [64][65]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * kF32QueryTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * kF32RowsPerWarp;
  const float* qb = q + b * q_bs + h * q_hs;
  const float* kb = k + b * k_bs + h * k_hs;
  const float* vb = v + b * v_bs + h * v_hs;
  const float* bias_bh =
      bias != nullptr
          ? bias + static_cast<int64_t>((b % bias_b) * bias_h + h % bias_h) *
                       Lq * Lk
          : nullptr;
  const int* mask_b =
      mask != nullptr ? mask + static_cast<int64_t>(b) * Lk : nullptr;

  stage_rows_f32(s_q, qb + q0 * q_rs, q_rs, kF32QueryTile, Lq - q0, vec);

  // a row's running state: the TPU kernel's m / l / acc scratch
  float m[kF32RowsPerWarp], l[kF32RowsPerWarp], acc[kF32RowsPerWarp][2];
#pragma unroll
  for (int rr = 0; rr < kF32RowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
    acc[rr][0] = acc[rr][1] = 0.f;
  }
  // whether the TPU grid computes key block kb0 for query row qi
  auto live = [&](int qi, int kb0) {
    return !causal || kb0 <= (qi / block_q) * block_q + block_q - 1;
  };
  const int last_row = min(q0 + kF32QueryTile, Lq) - 1;

  for (int kb0 = 0; kb0 < Lk; kb0 += block_k) {
    // skipped for every row of the tile, and so is every later block
    if (!live(last_row, kb0)) break;
    const int kend = min(kb0 + block_k, Lk);
    const int n_pad = kb0 + block_k - kend;

    // pass 1: the block's fp32 scores of the tile's rows
    for (int k0 = kb0; k0 < kend; k0 += kF32KeyTile) {
      __syncthreads();  // s_q staged / the previous tile consumed
      stage_rows_f32(s_kv, kb + k0 * k_rs, k_rs, kF32KeyTile, kend - k0, vec);
      __syncthreads();
      if (q0 + r0 >= Lq) continue;
      for (int c = lane; c < kF32KeyTile && k0 + c < kend; c += 32) {
        const int kj = k0 + c;
        float s[kF32RowsPerWarp];
        qk_rows_f32(s, s_q + r0 * kF32Stride, s_kv + c * kF32Stride);
        const bool unmasked = mask_b == nullptr || mask_b[kj] != 0;
#pragma unroll
        for (int rr = 0; rr < kF32RowsPerWarp; ++rr) {
          const int qi = q0 + r0 + rr;
          if (qi >= Lq) break;
          if (!live(qi, kb0)) continue;
          float x = s[rr];
          if (scale != 1.f) x *= scale;
          if (bias_bh != nullptr) x += bias_bh[static_cast<int64_t>(qi) * Lk + kj];
          const bool valid = unmasked && (!causal || kj <= qi);
          s_scores[(r0 + rr) * cols + (kj - kb0)] = valid ? x : kNegInf;
        }
      }
    }
    __syncwarp();

    // online-softmax step of each of the warp's rows; rows the TPU grid
    // skips here keep their state and get zero probabilities
    float alpha[kF32RowsPerWarp];
    const int n = kend - kb0;
#pragma unroll
    for (int rr = 0; rr < kF32RowsPerWarp; ++rr) {
      alpha[rr] = 1.f;
      const int qi = q0 + r0 + rr;
      if (qi >= Lq) continue;
      float* srow = s_scores + (r0 + rr) * cols;
      if (!live(qi, kb0)) {
        for (int j = lane; j < n; j += 32) srow[j] = 0.f;
        continue;
      }
      float mc = n_pad > 0 ? kNegInf : -INFINITY;
      for (int j = lane; j < n; j += 32) mc = fmaxf(mc, srow[j]);
      const float m_new = fmaxf(m[rr], warp_max(mc));
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(srow[j] - m_new);
        sum += p;
        srow[j] = p;
      }
      sum = warp_sum(sum);
      if (n_pad > 0) sum += static_cast<float>(n_pad) * expf(kNegInf - m_new);
      alpha[rr] = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha[rr] + sum;
      m[rr] = m_new;
    }
    __syncwarp();

    // pass 2: the block's P.V in fp32, lanes over the head dims
    float pv[kF32RowsPerWarp][2];
#pragma unroll
    for (int rr = 0; rr < kF32RowsPerWarp; ++rr) pv[rr][0] = pv[rr][1] = 0.f;
    for (int k0 = kb0; k0 < kend; k0 += kF32KeyTile) {
      __syncthreads();
      stage_rows_f32(s_kv, vb + k0 * v_rs, v_rs, kF32KeyTile, kend - k0, vec);
      __syncthreads();
      if (q0 + r0 >= Lq) continue;
      pv_rows_f32(pv, s_scores + r0 * cols + (k0 - kb0), cols, s_kv,
                  min(kF32KeyTile, kend - k0), lane);
    }
#pragma unroll
    for (int rr = 0; rr < kF32RowsPerWarp; ++rr) {
      const int qi = q0 + r0 + rr;
      if (qi >= Lq || !live(qi, kb0)) continue;
      acc[rr][0] = acc[rr][0] * alpha[rr] + pv[rr][0];
      acc[rr][1] = acc[rr][1] * alpha[rr] + pv[rr][1];
    }
  }

  // out is (B, Lq, H, 64) rows
#pragma unroll
  for (int rr = 0; rr < kF32RowsPerWarp; ++rr) {
    const int qi = q0 + r0 + rr;
    if (qi >= Lq) break;
    float* orow = out + ((static_cast<int64_t>(b) * Lq + qi) * H + h) * kHeadDim;
    orow[lane] = acc[rr][0] / l[rr];
    orow[lane + 32] = acc[rr][1] / l[rr];
  }
}

// staged tiles and the rows' m / l / alpha
constexpr size_t kMmaFixedSmem =
    (kQueryRows * kRowElems + kStages * kTileElems) * sizeof(bf16) + 3 * kTileRows * sizeof(float);

size_t mma_smem_bytes(int cols) {
  return kMmaFixedSmem + sizeof(float) * kQueryRows * score_stride(cols);
}

size_t f32_smem_bytes(int cols) {
  return sizeof(float) * (static_cast<size_t>(kF32QueryTile) * cols +
                          static_cast<size_t>(kF32QueryTile + kF32KeyTile) *
                              kF32Stride);
}

// Largest key block of both dtypes: the 32-row score block of the bf16
// kernel (the fp32 kernel's block of 32 unpadded rows is smaller).
constexpr int kMaxCols =
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

// Largest number of score columns (keys of one TPU block) that fits.
int mpr_flash_attention_max_cols(int /*Dh*/) { return kMaxCols; }

// q (B, H, Lq, Dh), k / v (B, H, Lk, Dh) through (batch, head, row) strides
// with unit last stride; Dh must be 64. bias: (bias_b, bias_h, Lq, Lk)
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
      block_k < 1 || bias_b < 1 || bias_h < 1 || cols > kMaxCols ||
      (Lq + 31) / 32 > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte loads need aligned bases and strides (in elements of the dtype)
  const int64_t per16 = dtype == 0 ? 4 : 8;
  bool vec = aligned16(q) && aligned16(k) && aligned16(v);
  for (int64_t st : {q_bs, q_hs, q_rs, k_bs, k_hs, k_rs, v_bs, v_hs, v_rs})
    vec = vec && st % per16 == 0;
  const float* bp = static_cast<const float*>(bias);
  const int* mp = static_cast<const int*>(mask);
  cudaError_t err;
  if (dtype == 0) {
    if ((err = allow_smem(flash_attention_f32_kernel)) != cudaSuccess)
      return err;
    dim3 grid(B * H, (Lq + kF32QueryTile - 1) / kF32QueryTile);
    flash_attention_f32_kernel<<<grid, kThreads, f32_smem_bytes(cols), s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), q_bs, q_hs, q_rs, k_bs, k_hs, k_rs,
        v_bs, v_hs, v_rs, bp, bias_b, bias_h, mp, static_cast<float*>(out),
        H, Lq, Lk, scale, causal, block_q, block_k, vec);
  } else {
    const bf16* qp = static_cast<const bf16*>(q);
    const bf16* kp = static_cast<const bf16*>(k);
    const bf16* vp = static_cast<const bf16*>(v);
    bf16* op = static_cast<bf16*>(out);
    if (Lk <= kTileRows && Lk <= block_k) {
      dim3 grid(B * H, (Lq + kTileRows - 1) / kTileRows);
      flash_attention_small_kernel<<<grid, kSmallThreads,
                                     3 * kTileElems * sizeof(bf16), s>>>(
          qp, kp, vp, q_bs, q_hs, q_rs, k_bs, k_hs, k_rs, v_bs, v_hs, v_rs, bp,
          bias_b, bias_h, mp, op, H, Lq, Lk, scale, causal, block_k - Lk, vec);
    } else {
      auto kernel = 4 * (mma_smem_bytes(cols) + 1024) <= kSmSmem
                        ? flash_attention_mma_kernel<4>
                        : flash_attention_mma_kernel<1>;
      if ((err = allow_smem(kernel)) != cudaSuccess) return err;
      dim3 grid(B * H, (Lq + kQueryRows - 1) / kQueryRows);
      kernel<<<grid, kThreads, mma_smem_bytes(cols), s>>>(
          qp, kp, vp, q_bs, q_hs, q_rs, k_bs, k_hs, k_rs, v_bs, v_hs, v_rs, bp,
          bias_b, bias_h, mp, op, H, Lq, Lk, scale, causal, block_q, block_k,
          vec);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
