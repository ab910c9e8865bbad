// Absorbed latent decode attention (K11), for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no latent attention. The port
// added it for the LM generator (models/moe_lm.py), whose DeepSeek-V3
// attention caches one row of C + R values a token and layer (the normed
// latent c, 512, then the roped shared key part k_pe, 64) in place of
// per-head K and V. With W_UK absorbed into the query and W_UV applied after
// (ops/mla.py), a decode step's attention is, per head h of a row,
//     s_j = (q_lat[h] . c_j + q_pe[h] . k_pe_j) * scale
//     o[h] = softmax_j(s_j over the row's valid keys j < length) . c_j
// so all heads share one key and one value row a token. Its plain PyTorch
// version is mla_decode_attention_reference (ops/mla.py).
//
// What bounds it on the H100: the cache. A step reads each row's length x
// 576 values once (bf16: 1,152 bytes a token) and does 2 x (576 + 512) x 16
// operations a token, ~30 a byte, far below the card's ~295: bytes.
//
// Design, bf16 (mla_decode_mma_kernel): a block takes one batch row and 16
// heads, so a row's cache is read once for all of them, and 16 heads are
// exactly the M of mma.sync m16n8k16. The row's cache streams through in
// tiles of 32 tokens (cp.async, two stages, rows padded to C + R + 8
// elements so that ldmatrix rows fall on distinct banks); per tile
//   S = [q_lat | q_pe] . [c | k_pe]^T   each of 4 warps 8 tokens over the
//                                       whole C + R, both operands by
//                                       ldmatrix from shared memory;
//   online softmax in fp32, 8 threads a head, over a 16 x 32 block in
//   shared memory (scores, then exponentials; the running max and sum in
//   the threads that own the head);
//   O += P . c                          each warp C / 4 of the output
//                                       columns, P rounded to bf16 as it is
//                                       packed (as a flash kernel does), c
//                                       by ldmatrix.trans.
// The (16, C) output sums stay in fp32 registers and are divided by the
// head's sum once at the end; a head with no valid key writes zeros.
//
// fp32 (mla_decode_f32_kernel) keeps full fp32 products on the CUDA cores
// (no TF32): a block a (row, head), the scores of every key in shared
// memory, then an exact softmax (expf, one division a value) and the output
// sums in ascending key order.

#include "attention_tiles.cuh"

namespace {

using namespace mpr_tiles;

constexpr int kLatent = 512;  // C: the latent (value) width a block takes
constexpr int kHeads = 16;    // heads of a block: the M of the mma
constexpr int kTile = 32;     // tokens of a staged cache tile
constexpr int kWarpsMla = 4;  // each 8 tokens of S, C / 4 columns of O
constexpr int kThreadsMla = kWarpsMla * 32;
constexpr int kPStride = kTile + 4;  // fp32 row of the score block

struct MlaArgs {
  const void* q_lat;    // (B, H, C)
  const void* q_pe;     // (B, H, R)
  const void* cache;    // (B, T_max, C + R)
  const int8_t* key_ok; // (B, T_max), nonzero: a valid key
  void* out;            // (B, H, C) contiguous
  int64_t sq_b, sq_h, sp_b, sp_h, sc_b, sc_t, sk_b;
  int H, C, R, length;
  float scale;
};

__global__ void __launch_bounds__(kThreadsMla)
mla_decode_mma_kernel(MlaArgs p) {
  constexpr int C = kLatent;
  constexpr int NT = C / kWarpsMla / 8;  // 8-column tiles of a warp's O
  static_assert(NT % 2 == 0, "output columns of a warp");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = C + p.R, LD = W + 8, pieces = W / 8;
  bf16* s_q = reinterpret_cast<bf16*>(smem_raw);        // kHeads x LD
  bf16* s_kv = s_q + kHeads * LD;                        // 2 x kTile x LD
  float* s_p = reinterpret_cast<float*>(s_kv + 2 * kTile * LD);
  float* s_alpha = s_p + kHeads * kPStride;              // kHeads
  float* s_l = s_alpha + kHeads;                         // kHeads

  const int b = blockIdx.x, h0 = blockIdx.y * kHeads;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bf16* q_lat = static_cast<const bf16*>(p.q_lat) + b * p.sq_b;
  const bf16* q_pe = static_cast<const bf16*>(p.q_pe) + b * p.sp_b;
  const bf16* cache = static_cast<const bf16*>(p.cache) + b * p.sc_b;
  const int8_t* ok = p.key_ok + b * p.sk_b;
  const int length = p.length;

  // [q_lat | q_pe] of the block's heads; heads past H are zero
  for (int i = tid; i < kHeads * pieces; i += kThreadsMla) {
    const int r = i / pieces, c = (i % pieces) * 8, head = h0 + r;
    bf16* d = s_q + r * LD + c;
    if (head >= p.H)
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    else if (c < C)
      cp_async16(d, q_lat + head * p.sq_h + c);
    else
      cp_async16(d, q_pe + head * p.sp_h + (c - C));
  }
  // the cache rows of tile j; rows at or past length are zero, so that a
  // weight of 0 never meets a value that is not finite
  auto load_tile = [&](int j) {
    bf16* dst = s_kv + (j & 1) * kTile * LD;
    const int t0 = j * kTile;
    for (int i = tid; i < kTile * pieces; i += kThreadsMla) {
      const int r = i / pieces, c = (i % pieces) * 8;
      bf16* d = dst + r * LD + c;
      if (t0 + r < length)
        cp_async16(d, cache + int64_t(t0 + r) * p.sc_t + c);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  };
  load_tile(0);
  cp_async_commit();

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  // the softmax threads: 8 a head
  const int s_row = tid / 8, s_sub = tid % 8;
  float m_run = -INFINITY, l_run = 0.f;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = (length + kTile - 1) / kTile;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_tile(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile j (and the query) landed
    const bf16* kv = s_kv + (j & 1) * kTile * LD;

    // S: the warp's 8 tokens against the 16 heads over W, two 16-wide k
    // steps an ldmatrix of the keys
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    const bf16* kp = kv + (warp * 8 + (lane & 7)) * LD + (lane >> 3) * 8;
    const bf16* qp = s_q + (lane & 15) * LD + (lane >> 4) * 8;
    for (int k0 = 0; k0 < W; k0 += 32) {
      uint32_t bk[4], a0[4], a1[4];
      ldmatrix_x4(bk, kp + k0);
      ldmatrix_x4(a0, qp + k0);
      ldmatrix_x4(a1, qp + k0 + 16);
      mma_bf16(s, a0, bk[0], bk[1]);
      mma_bf16(s, a1, bk[2], bk[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = warp * 8 + 2 * t + (e & 1);
      const int tok = j * kTile + key;
      const bool valid = tok < length && ok[tok] != 0;
      s_p[(g + (e >> 1) * 8) * kPStride + key] =
          valid ? s[e] * p.scale : -INFINITY;
    }
    __syncthreads();

    // online softmax of the tile: 8 threads a head, 4 tokens each
    {
      float* row = s_p + s_row * kPStride + s_sub * 4;
      float x[4], mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < 4; ++e) mx = fmaxf(mx, x[e] = row[e]);
      const float m_new = fmaxf(m_run, group_max<8>(mx));
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = fast_exp(m_run - base);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) sum += (row[e] = fast_exp(x[e] - base));
      l_run = l_run * alpha + group_sum<8>(sum);
      m_run = m_new;
      if (s_sub == 0) s_alpha[s_row] = alpha;
    }
    __syncthreads();

    // O = alpha O + P . c over the warp's C / 4 columns
    const float a_lo = s_alpha[g], a_hi = s_alpha[g + 8];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      acc[i][0] *= a_lo;
      acc[i][1] *= a_lo;
      acc[i][2] *= a_hi;
      acc[i][3] *= a_hi;
    }
    const int d0 = warp * (C / kWarpsMla);
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      uint32_t a[4];
      load_p_frag(a, s_p, kPStride, 0, ks * 16, 1.f, 1.f, lane);
      const bf16* vp =
          kv + (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD + d0 +
          (lane >> 4) * 8;
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vp + np * 16);
        mma_bf16(acc[2 * np], a, bv[0], bv[1]);
        mma_bf16(acc[2 * np + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // the tile's slot and the score block are free again
  }
  cp_async_wait<0>();

  if (s_sub == 0) s_l[s_row] = l_run;
  __syncthreads();
  const float l_lo = s_l[g], l_hi = s_l[g + 8];
  const float f_lo = l_lo > 0.f ? 1.f / l_lo : 0.f;
  const float f_hi = l_hi > 0.f ? 1.f / l_hi : 0.f;
  bf16* out = static_cast<bf16*>(p.out) + (int64_t(b) * p.H) * C;
  const int d0 = warp * (C / kWarpsMla);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int head = h0 + g + half * 8;
    if (head >= p.H) continue;
    const float f = half ? f_hi : f_lo;
#pragma unroll
    for (int i = 0; i < NT; ++i)
      *reinterpret_cast<__nv_bfloat162*>(out + head * C + d0 + i * 8 +
                                         2 * t) =
          __floats2bfloat162_rn(acc[i][2 * half] * f,
                                acc[i][2 * half + 1] * f);
  }
}

size_t mma_smem(int R) {
  const size_t ld = kLatent + R + 8;
  return sizeof(bf16) * (kHeads + 2 * kTile) * ld +
         sizeof(float) * (kHeads * kPStride + 2 * kHeads);
}

// fp32: a block a (row, head) (module comment)
__global__ void __launch_bounds__(kThreadsMla)
mla_decode_f32_kernel(MlaArgs p) {
  extern __shared__ __align__(16) float smem_f[];
  const int W = p.C + p.R, length = p.length;
  float* s_q = smem_f;          // W
  float* s_s = smem_f + W;      // length
  __shared__ float s_red[kWarpsMla];
  const int b = blockIdx.x, head = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* q_lat =
      static_cast<const float*>(p.q_lat) + b * p.sq_b + head * p.sq_h;
  const float* q_pe =
      static_cast<const float*>(p.q_pe) + b * p.sp_b + head * p.sp_h;
  const float* cache = static_cast<const float*>(p.cache) + b * p.sc_b;
  const int8_t* ok = p.key_ok + b * p.sk_b;
  for (int i = tid; i < W; i += kThreadsMla)
    s_q[i] = i < p.C ? q_lat[i] : q_pe[i - p.C];
  __syncthreads();
  for (int j = warp; j < length; j += kWarpsMla) {
    const float* row = cache + int64_t(j) * p.sc_t;
    float dot = 0.f;
    for (int i = lane; i < W; i += 32) dot = fmaf(s_q[i], row[i], dot);
    dot = warp_sum(dot);
    if (lane == 0) s_s[j] = ok[j] != 0 ? dot * p.scale : -INFINITY;
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int j = tid; j < length; j += kThreadsMla) mx = fmaxf(mx, s_s[j]);
  mx = warp_max(mx);
  if (lane == 0) s_red[warp] = mx;
  __syncthreads();
  mx = s_red[0];
  for (int w = 1; w < kWarpsMla; ++w) mx = fmaxf(mx, s_red[w]);
  __syncthreads();
  float* out = static_cast<float*>(p.out) + (int64_t(b) * p.H + head) * p.C;
  if (mx == -INFINITY) {  // no valid key
    for (int d = tid; d < p.C; d += kThreadsMla) out[d] = 0.f;
    return;
  }
  float sum = 0.f;
  for (int j = tid; j < length; j += kThreadsMla) {
    const float e = expf(s_s[j] - mx);
    s_s[j] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  if (lane == 0) s_red[warp] = sum;
  __syncthreads();
  sum = 0.f;
  for (int w = 0; w < kWarpsMla; ++w) sum += s_red[w];
  for (int d = tid; d < p.C; d += kThreadsMla) {
    float o = 0.f;
    for (int j = 0; j < length; ++j)
      o = fmaf(s_s[j], cache[int64_t(j) * p.sc_t + d], o);
    out[d] = o / sum;
  }
}

}  // namespace

extern "C" {

// q_lat (B, H, C) and q_pe (B, H, R) through (batch, head) strides, cache
// (B, T_max, C + R) through (batch, token) strides, last dimensions
// contiguous; key_ok (B, T_max) int8 through its batch stride; out (B, H, C)
// contiguous; keys [0, length). dtype: 0 = float32, 1 = bfloat16. bf16: C
// 512, R a multiple of 32, bases and strides 16-byte aligned.
// fp32: C + R + length at most 12,288.
int mpr_mla_decode_attention(const void* q_lat, const void* q_pe,
                             const void* cache, const int8_t* key_ok,
                             void* out, int64_t sq_b, int64_t sq_h,
                             int64_t sp_b, int64_t sp_h, int64_t sc_b,
                             int64_t sc_t, int64_t sk_b, int B, int H, int C,
                             int R, int length, float scale, int dtype,
                             void* stream) {
  if (B < 1 || H < 1 || C < 1 || R < 1 || length < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const MlaArgs p{q_lat, q_pe, cache, key_ok, out, sq_b, sq_h, sp_b,
                  sp_h, sc_b, sc_t, sk_b, H, C, R, length, scale};
  if (dtype == 0) {
    const size_t smem = sizeof(float) * (C + R + length);
    if (smem > 48 * 1024) return cudaErrorInvalidValue;
    mla_decode_f32_kernel<<<dim3(B, H), kThreadsMla, smem, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  if (C != kLatent || R % 32 ||
      !(aligned16(q_lat) && aligned16(q_pe) && aligned16(cache)) ||
      sq_b % 8 || sq_h % 8 || sp_b % 8 || sp_h % 8 || sc_b % 8 || sc_t % 8)
    return cudaErrorInvalidValue;
  const size_t smem = mma_smem(R);
  cudaError_t err = cudaFuncSetAttribute(
      mla_decode_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, (H + kHeads - 1) / kHeads);
  mla_decode_mma_kernel<<<grid, kThreadsMla, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
