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
// q, k and v are read through (batch, head, row) strides, so head views of a
// packed projection need no copy; the output is contiguous (B, H, L, 64).
//
// What bounds it on the H100: q, k, v and the output move once and a head
// does 4 * L * L * 64 operations, a tenth of the time of its bytes at the
// bf16 tensor-core rate: it is bound by bytes. Its earlier form did every
// product in fp32 on the CUDA cores, one query row a warp at a time with the
// scores in shared memory, and ran 10x over that bound.
//
// Design, bf16 (short_attention_mma_kernel, tiles of attention_tiles.cuh,
// both products on the tensor cores by mma.sync m16n8k16): a head's q, k and
// v are staged once by cp.async through their own strides. A warp owns 16
// query rows against every key; the scores, the exact softmax (quad
// shuffles, __expf, one reciprocal a row) and the probabilities stay in
// registers, the rounded accumulators of S being the A fragments of P, so
// there is one barrier in all and no score ever touches shared memory. The
// template parameter KP is the number of 16-key steps a warp carries:
//   * KP = 1, L <= 16 (the text tower's 16): four heads a block, a warp each;
//   * KP = 2, L <= 32: two heads a block, two warps each;
//   * KP = 4, L <= 64 (the ViT's 50): one head a block, ceil(L / 16) warps;
//   * KP = 8, L <= 128 (T5's 82): one head a block, up to 8 warps, 64 score
//     registers a thread over two key tiles.
// Packing heads keeps four warps in every block of the short shapes, where
// a head is one warp of work. Tensors whose base or strides are not
// 16-byte aligned take 2-byte loads instead of cp.async; nothing is copied.
//
// fp32 (short_attention_f32_kernel) keeps full fp32 products on the CUDA
// cores (no TF32), 32 query rows a block, 16-byte loads where aligned and
// each staged key or value word used for four query rows; expf and a true
// division, as the plain version.

#include "attention_tiles.cuh"

namespace {

using namespace mpr_tiles;

constexpr int kMaxLen = 128;

struct Strides {
  int64_t b, h, r;  // batch, head, row; in elements
};

// heads that share a block, and the block's threads at most
__host__ __device__ constexpr int heads_per_block(int KP) {
  return KP >= 4 ? 1 : 4 / KP;
}
__host__ __device__ constexpr int max_threads(int KP) {
  return 32 * KP * heads_per_block(KP);
}

template <int KP>
__global__ void __launch_bounds__(max_threads(KP), KP == 8 ? 2 : 1)
short_attention_mma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, Strides qs, Strides ks,
                           Strides vs, bf16* __restrict__ out, int n_heads,
                           int H, int L, float scale, int vec) {
  constexpr int HPB = heads_per_block(KP);
  constexpr int kTile = 16 * KP * kRowElems;  // a staged q, k or v
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int warps_per_head = blockDim.x / 32 / HPB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = warp / warps_per_head, hw = warp % warps_per_head;
  const int head = blockIdx.x * HPB + slot;  // b * H + h
  bf16* s_q = reinterpret_cast<bf16*>(smem_raw) + slot * 3 * kTile;
  bf16* s_k = s_q + kTile;  // s_q later carries the output rows
  bf16* s_v = s_k + kTile;

  if (head < n_heads) {
    const int b = head / H, h = head % H;
    const int rows = (L + 15) / 16 * 16;  // the 16-key steps read whole
    const int tid = hw * 32 + lane, n = warps_per_head * 32;
    stage_tile_part(s_q, q + b * qs.b + h * qs.h, qs.r, rows, L, vec, tid, n);
    stage_tile_part(s_k, k + b * ks.b + h * ks.h, ks.r, rows, L, vec, tid, n);
    stage_tile_part(s_v, v + b * vs.b + h * vs.h, vs.r, rows, L, vec, tid, n);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int row0 = hw * 16;
  if (head >= n_heads || row0 >= L) return;  // no barrier follows

  uint32_t qf[4][4];
  load_q_frags(qf, s_q, row0, lane);
  float sacc[2 * KP][4];
  qk_16xK<KP>(sacc, qf, s_k, L, lane);
  softmax_16xK<KP>(sacc, L, scale, lane);
  float o[4][2][4];
  pv_16xK<KP>(o, sacc, s_v, L, lane);
  store_o_rows(out + static_cast<int64_t>(head) * L * kHeadDim, kHeadDim, s_q,
               o, row0, L, 1.f, 1.f, lane);
}

__global__ void __launch_bounds__(kThreads) short_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, Strides qs, Strides ks, Strides vs,
    float* __restrict__ out, int H, int L, float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_scores = reinterpret_cast<float*>(smem_raw);  // [32][L]
  float* s_q = s_scores + kF32QueryTile * L;             // [32][65]
  float* s_kv = s_q + kF32QueryTile * kF32Stride;        // [64][65]

  const int head = blockIdx.y, b = head / H, h = head % H;
  const int q0 = blockIdx.x * kF32QueryTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * kF32RowsPerWarp;  // the warp's first row of the tile
  const bool idle = q0 + r0 >= L;         // warp-uniform
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;

  // only the rows that are read: whole warps of query rows (zeros past L),
  // and below the keys and values that exist
  stage_rows_f32(s_q, qb + q0 * qs.r, qs.r,
                 min(kF32QueryTile, (L - q0 + kF32RowsPerWarp - 1) /
                                        kF32RowsPerWarp * kF32RowsPerWarp),
                 L - q0, vec);

  // pass 1: fp32 scores of this tile's rows against every key
  for (int k0 = 0; k0 < L; k0 += kF32KeyTile) {
    __syncthreads();  // s_q staged / previous key tile consumed
    stage_rows_f32(s_kv, kb + k0 * ks.r, ks.r, min(kF32KeyTile, L - k0),
                   L - k0, vec);
    __syncthreads();
    if (idle) continue;
    for (int c = lane; c < kF32KeyTile && k0 + c < L; c += 32) {
      float s[kF32RowsPerWarp];
      qk_rows_f32(s, s_q + r0 * kF32Stride, s_kv + c * kF32Stride);
#pragma unroll
      for (int rr = 0; rr < kF32RowsPerWarp; ++rr)
        s_scores[(r0 + rr) * L + k0 + c] = s[rr] * scale;
    }
  }
  __syncwarp();

  // exact softmax of the warp's own rows (rows past L hold zeros' scores)
  for (int rr = 0; rr < kF32RowsPerWarp && !idle; ++rr) {
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
    stage_rows_f32(s_kv, vb + k0 * vs.r, vs.r, min(kF32KeyTile, L - k0),
                   L - k0, vec);
    __syncthreads();
    if (idle) continue;
    pv_rows_f32(acc, s_scores + r0 * L + k0, L, s_kv,
                min(kF32KeyTile, L - k0), lane);
  }
#pragma unroll
  for (int rr = 0; rr < kF32RowsPerWarp; ++rr) {
    const int qi = q0 + r0 + rr;
    if (qi >= L) break;
    float* orow = out + (static_cast<int64_t>(head) * L + qi) * kHeadDim;
    orow[lane] = acc[rr][0];
    orow[lane + 32] = acc[rr][1];
  }
}

template <int KP>
cudaError_t launch_mma(const bf16* q, const bf16* k, const bf16* v, Strides qs,
                       Strides ks, Strides vs, bf16* out, int B, int H, int L,
                       float scale, int vec, cudaStream_t stream) {
  constexpr int HPB = heads_per_block(KP);
  constexpr size_t smem = HPB * 3 * 16 * KP * kRowElems * sizeof(bf16);
  auto kernel = short_attention_mma_kernel<KP>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int n_heads = B * H;
  const int threads = HPB > 1 ? max_threads(KP) : 32 * ((L + 15) / 16);
  kernel<<<(n_heads + HPB - 1) / HPB, threads, smem, stream>>>(
      q, k, v, qs, ks, vs, out, n_heads, H, L, scale, vec);
  return cudaGetLastError();
}

bool strides_aligned(Strides s, int64_t per16) {
  return s.b % per16 == 0 && s.h % per16 == 0 && s.r % per16 == 0;
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
  // 16-byte loads need aligned bases and strides (in elements of the dtype)
  const int64_t per16 = dtype == 0 ? 4 : 8;
  const int vec = aligned16(q) && aligned16(k) && aligned16(v) &&
                  strides_aligned(qs, per16) && strides_aligned(ks, per16) &&
                  strides_aligned(vs, per16);
  if (dtype == 0) {
    const size_t smem =
        sizeof(float) * (static_cast<size_t>(kF32QueryTile) * L +
                         (kF32QueryTile + kF32KeyTile) * kF32Stride);
    dim3 grid((L + kF32QueryTile - 1) / kF32QueryTile, B * H);
    // a warp takes 4 query rows: no more warps than L has rows for
    const int warps =
        min(kWarps, (L + kF32RowsPerWarp - 1) / kF32RowsPerWarp);
    short_attention_f32_kernel<<<grid, 32 * warps, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), qs, ks, vs, static_cast<float*>(out),
        H, L, scale, vec);
    return static_cast<int>(cudaGetLastError());
  }
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(out);
  cudaError_t err;
  if (L <= 16)
    err = launch_mma<1>(qp, kp, vp, qs, ks, vs, op, B, H, L, scale, vec, s);
  else if (L <= 32)
    err = launch_mma<2>(qp, kp, vp, qs, ks, vs, op, B, H, L, scale, vec, s);
  else if (L <= 64)
    err = launch_mma<4>(qp, kp, vp, qs, ks, vs, op, B, H, L, scale, vec, s);
  else
    err = launch_mma<8>(qp, kp, vp, qs, ks, vs, op, B, H, L, scale, vec, s);
  return static_cast<int>(err);
}

}  // extern "C"
