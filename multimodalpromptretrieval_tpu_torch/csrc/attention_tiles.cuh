// Tile building blocks shared by the attention kernels (row_attention.cu,
// flash_attention.cu, short_attention.cu), for Hopper (sm_90a), head dim 64.
//
// bf16 inputs: tiles of 64 rows x 64 bf16 go from device memory to shared
// memory in 16-byte pieces (cp.async; a scalar path serves tensors whose
// base or strides are not 16-byte aligned), into rows padded to 72 elements
// (144 bytes), so that the eight 16-byte rows of one ldmatrix fall on
// distinct banks. The two products of attention run on the tensor cores
// (mma.sync.m16n8k16, bf16 operands, fp32 accumulators):
//   S = Q.Kt   Q fragments by ldmatrix from the query tile, K fragments by
//              ldmatrix from the key tile as stored ([key][d] is the "col"
//              operand layout);
//   O += P.V   P fragments rounded and packed from an fp32 block of
//              exponentials in shared memory, V fragments by ldmatrix.trans
//              from the value tile as stored.
// Up to 64 keys (one key tile) a block has 4 warps, each with 16 query rows
// against all keys: scores, softmax and probabilities stay in registers
// (qk_16xK<4>, pv_16xK<4>; short_attention.cu takes the same blocks over
// one to eight 16-key steps, up to two key tiles with 64 score registers a
// thread, with softmax_16xK between them). Longer rows go through an fp32
// score block in shared
// memory, in blocks of 8 warps over 32 query rows: 2 row groups of 16 rows
// times 4 column splits. In S a warp takes its row group against 16 of each
// key tile's 64 keys, in O its row group against 16 of the 64 head dims, so
// no sum crosses warps. (32 rows, not 64: two blocks then fit on an SM at
// L=562, and the last query tile of L=82 wastes less.) The softmax between
// the two runs 8 neighbouring lanes to a row. exp is the hardware's
// (__expf) and a row is divided by multiplying with one reciprocal: both
// stay far inside bf16's rounding, and a true division per element takes a
// slow path for the many zero probabilities of masked keys.
//
// fp32 inputs keep full fp32 products on the CUDA cores (8 warps): rows staged as
// fp32 with one word of padding, each lane holding one key against four
// query rows (S) or two head dims against four rows (O).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace mpr_tiles {

using bf16 = __nv_bfloat16;

constexpr int kHeadDim = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileRows = 64;               // rows of a staged bf16 tile
constexpr int kRowElems = kHeadDim + 8;     // padded bf16 row (144 bytes)
constexpr int kTileElems = kTileRows * kRowElems;
constexpr int kStages = 3;  // ring of staged key / value tiles
// the score-block kernels: 2 row groups of 16 query rows x 4 column splits
constexpr int kRowGroups = 2;
constexpr int kQueryRows = kRowGroups * 16;
constexpr int kLanesPerRow = kThreads / kQueryRows;
constexpr int kScorePad = 8;  // fp32 score row = keys rounded up to 64, + 8
constexpr float kNegInf = -1e9f;
constexpr int kMaxSmem = 227 * 1024;  // of one block
constexpr size_t kSmSmem = 228 * 1024;  // of an SM; a block reserves 1 KB more

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

// max / sum over aligned groups of LANES neighbouring lanes (every lane of
// the warp must call)
template <int LANES>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <int LANES>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// bf16 kernels: exp by the hardware's ex2 (relative error of some 1e-6 at
// the scores' sizes, against 4e-3 of the bf16 rounding that follows);
// exact at 0 and 0 at -1e9 and -inf, which the masking relies on
__device__ __forceinline__ float fast_exp(float x) { return __expf(x); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Rows [0, rows) of a strided (rows, 64) bf16 source into a padded tile;
// rows at or past `valid` are zero. `vec`: the source rows are 16-byte aligned,
// so they go by cp.async (the caller commits and waits); else by 2-byte
// loads. The copy is shared by `nthreads` threads, of which this is `tid`.
__device__ __forceinline__ void stage_tile_part(bf16* dst, const bf16* src,
                                                int64_t row_stride, int rows,
                                                int valid, bool vec, int tid,
                                                int nthreads) {
  for (int i = tid; i < rows * 8; i += nthreads) {
    const int r = i >> 3, c = (i & 7) * 8;
    bf16* d = dst + r * kRowElems + c;
    if (r >= valid) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    } else if (vec) {
      cp_async16(d, src + r * row_stride + c);
    } else {
      const bf16* s = src + r * row_stride + c;
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = s[e];
    }
  }
}

// The same, by every thread of the block.
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src,
                                           int64_t row_stride, int rows,
                                           int valid, bool vec) {
  stage_tile_part(dst, src, row_stride, rows, valid, vec, threadIdx.x,
                  blockDim.x);
}

// The A fragments of a warp's 16 query rows (row0..row0+15 of the tile) for
// the four 16-wide steps over the head dim.
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[4][4],
                                             const bf16* s_q, int row0,
                                             int lane) {
  const bf16* p = s_q + (row0 + (lane & 15)) * kRowElems + (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) ldmatrix_x4(qf[ks], p + ks * 16);
}

// acc = Q (16 rows) . Kt for keys n0..n0+15 of the staged key tile:
// acc[0] holds keys n0..n0+7, acc[1] keys n0+8..n0+15. In each, a lane
// (g = lane / 4, t = lane % 4) has rows g (elements 0, 1) and g + 8
// (elements 2, 3) at keys 2t and 2t + 1.
__device__ __forceinline__ void qk_16x16(float (&acc)[2][4],
                                         const uint32_t (&qf)[4][4],
                                         const bf16* s_k, int n0, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const bf16* p = s_k + (n0 + ((lane >> 4) << 3) + (lane & 7)) * kRowElems +
                  ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t b[4];
    ldmatrix_x4(b, p + ks * 16);
    mma_bf16(acc[0], qf[ks], b[0], b[1]);
    mma_bf16(acc[1], qf[ks], b[2], b[3]);
  }
}

// The A fragment of P: rows row0..row0+15, columns c0..c0+15 of an fp32
// block (c0 and stride even), each value times its row's factor (f_lo for
// row row0 + lane / 4, f_hi for the row 8 below) and rounded to bf16 here.
__device__ __forceinline__ void load_p_frag(uint32_t (&a)[4],
                                            const float* s_p, int stride,
                                            int row0, int c0, float f_lo,
                                            float f_hi, int lane) {
  const float* p0 = s_p + (row0 + (lane >> 2)) * stride + c0 + 2 * (lane & 3);
  const float* p1 = p0 + 8 * stride;
  float2 x = *reinterpret_cast<const float2*>(p0);
  a[0] = pack_bf16(x.x * f_lo, x.y * f_lo);
  x = *reinterpret_cast<const float2*>(p1);
  a[1] = pack_bf16(x.x * f_hi, x.y * f_hi);
  x = *reinterpret_cast<const float2*>(p0 + 8);
  a[2] = pack_bf16(x.x * f_lo, x.y * f_lo);
  x = *reinterpret_cast<const float2*>(p1 + 8);
  a[3] = pack_bf16(x.x * f_hi, x.y * f_hi);
}

// o += P (16 rows x keys k0..k0+15 of the staged value tile) . V at head
// dims d0..d0+15: o[0] holds dims d0..d0+7, o[1] dims d0+8..d0+15, laid out
// as qk_16x16's accumulators.
__device__ __forceinline__ void pv_16x16(float (&o)[2][4],
                                         const uint32_t (&a)[4],
                                         const bf16* s_v, int k0, int d0,
                                         int lane) {
  uint32_t b[4];
  ldmatrix_x4_trans(b, s_v + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                 kRowElems +
                           d0 + (lane >> 4) * 8);
  mma_bf16(o[0], a, b[0], b[1]);
  mma_bf16(o[1], a, b[2], b[3]);
}

// A warp's output accumulators (PAIRS pairs of 8-wide head-dim tiles from
// dim d_first on, rows row0 + g and row0 + g + 8), each multiplied by its
// row's factor and rounded, into a padded bf16 tile.
template <int PAIRS>
__device__ __forceinline__ void put_o_tile(bf16* s_o,
                                           const float (&o)[PAIRS][2][4],
                                           int row0, int d_first, float f_lo,
                                           float f_hi, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int p = 0; p < PAIRS; ++p)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int d = d_first + p * 16 + nt * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(s_o + (row0 + g) * kRowElems + d) =
          __floats2bfloat162_rn(o[p][nt][0] * f_lo, o[p][nt][1] * f_lo);
      *reinterpret_cast<__nv_bfloat162*>(s_o + (row0 + g + 8) * kRowElems +
                                         d) =
          __floats2bfloat162_rn(o[p][nt][2] * f_hi, o[p][nt][3] * f_hi);
    }
}

// The first `rows` rows of a padded bf16 tile to device memory, 16 bytes a
// thread; `dst` rows are `row_stride` elements apart and 16-byte aligned.
__device__ __forceinline__ void store_o_tile(bf16* dst, int64_t row_stride,
                                             const bf16* s_o, int rows) {
  for (int i = threadIdx.x; i < rows * 8; i += blockDim.x) {
    const int r = i >> 3, c = (i & 7) * 8;
    *reinterpret_cast<uint4*>(dst + r * row_stride + c) =
        *reinterpret_cast<const uint4*>(s_o + r * kRowElems + c);
  }
}

// --- one key tile (at most 64 keys): scores and probabilities in registers --
//
// Blocks of kSmallWarps warps; a warp owns 16 query rows against all the
// keys, so after the tiles have landed no barrier is needed: the row
// statistics are quad shuffles, and the accumulators of S, rounded, are the
// A fragments of P.
constexpr int kSmallWarps = 4;
constexpr int kSmallThreads = kSmallWarps * 32;

// sacc[nt] = Q (16 rows) . Kt for keys 8 nt..8 nt + 7 of KP 16-key steps,
// for the steps below n_keys (the others stay 0). The staged key rows lie
// one after another, so KP = 8 spans two 64-row tiles: all 128 scores of a
// warp's 16 rows in 64 registers a thread, and the exact softmax still needs
// no score block in shared memory and no barrier between the products.
template <int KP>
__device__ __forceinline__ void qk_16xK(float (&sacc)[2 * KP][4],
                                        const uint32_t (&qf)[4][4],
                                        const bf16* s_k, int n_keys,
                                        int lane) {
#pragma unroll
  for (int np = 0; np < KP; ++np) {
    float acc[2][4] = {};
    if (np * 16 < n_keys) qk_16x16(acc, qf, s_k, np * 16, lane);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sacc[2 * np][e] = acc[0][e];
      sacc[2 * np + 1][e] = acc[1][e];
    }
  }
}

// o (16 rows x 64 head dims) = P . V, P the values of sacc (qk_16xK's
// layout) rounded to bf16 here, over the 16-key steps below n_keys
template <int KP>
__device__ __forceinline__ void pv_16xK(float (&o)[4][2][4],
                                        const float (&sacc)[2 * KP][4],
                                        const bf16* s_v, int n_keys,
                                        int lane) {
#pragma unroll
  for (int dp = 0; dp < 4; ++dp)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dp][nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KP; ++ks) {
    if (ks * 16 >= n_keys) continue;
    const uint32_t a[4] = {pack_bf16(sacc[2 * ks][0], sacc[2 * ks][1]),
                           pack_bf16(sacc[2 * ks][2], sacc[2 * ks][3]),
                           pack_bf16(sacc[2 * ks + 1][0], sacc[2 * ks + 1][1]),
                           pack_bf16(sacc[2 * ks + 1][2], sacc[2 * ks + 1][3])};
#pragma unroll
    for (int dp = 0; dp < 4; ++dp)
      pv_16x16(o[dp], a, s_v, ks * 16, dp * 16, lane);
  }
}

// Exact softmax of a warp's 16 rows of scores in registers (qk_16xK's
// layout), in place: each score times `scale`, keys at or past n_keys weigh
// 0, max and sum over the four lanes of a row, exp by fast_exp, one
// reciprocal a row. What comes out is the normalised p in fp32; pv_16xK
// rounds it.
template <int KP>
__device__ __forceinline__ void softmax_16xK(float (&sacc)[2 * KP][4],
                                             int n_keys, float scale,
                                             int lane) {
  const int t = lane & 3;
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < 2 * KP; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool in = nt * 8 + 2 * t + e < n_keys;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float x = in ? sacc[nt][half * 2 + e] * scale : -INFINITY;
        sacc[nt][half * 2 + e] = x;
        m[half] = fmaxf(m[half], x);
      }
    }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    m[half] = group_max<4>(m[half]);
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2 * KP; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = fast_exp(sacc[nt][half * 2 + e] - m[half]);
        sacc[nt][half * 2 + e] = p;
        sum += p;
      }
    const float inv = 1.f / group_sum<4>(sum);
#pragma unroll
    for (int nt = 0; nt < 2 * KP; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) sacc[nt][half * 2 + e] *= inv;
  }
}

// A warp's 16 output rows (row0.. of the tile, the first `rows` of the tile
// valid), each times its row's factor, through its own rows of a padded
// shared tile to device memory in 16-byte pieces.
__device__ __forceinline__ void store_o_rows(bf16* dst, int64_t row_stride,
                                             bf16* s_o,
                                             const float (&o)[4][2][4],
                                             int row0, int rows, float f_lo,
                                             float f_hi, int lane) {
  __syncwarp();
  put_o_tile<4>(s_o, o, row0, 0, f_lo, f_hi, lane);
  __syncwarp();
  for (int i = lane; i < 16 * 8; i += 32) {
    const int r = row0 + (i >> 3), c = (i & 7) * 8;
    if (r < rows)
      *reinterpret_cast<uint4*>(dst + r * row_stride + c) =
          *reinterpret_cast<const uint4*>(s_o + r * kRowElems + c);
  }
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Stride = kHeadDim + 1;  // one word of padding per row
constexpr int kF32RowsPerWarp = 4;
constexpr int kF32QueryTile = kWarps * kF32RowsPerWarp;
constexpr int kF32KeyTile = 64;

// rows [0, count) of a strided (rows, 64) fp32 source into padded shared
// rows; rows at or past `valid` are zero. `vec`: 16-byte aligned rows.
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* src,
                                               int64_t row_stride, int count,
                                               int valid, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < count * (kHeadDim / 4); i += blockDim.x) {
      const int r = i / (kHeadDim / 4), c = (i % (kHeadDim / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < valid)
        x = *reinterpret_cast<const float4*>(src + r * row_stride + c);
      float* d = dst + r * kF32Stride + c;
      d[0] = x.x;
      d[1] = x.y;
      d[2] = x.z;
      d[3] = x.w;
    }
  } else {
    for (int i = threadIdx.x; i < count * kHeadDim; i += blockDim.x) {
      const int r = i / kHeadDim, d = i % kHeadDim;
      dst[r * kF32Stride + d] = r < valid ? src[r * row_stride + d] : 0.f;
    }
  }
}

// s[rr] = q row (warp's row rr) . key row `krow`, summed over the head dim
// in ascending order, one key against the warp's four query rows.
__device__ __forceinline__ void qk_rows_f32(float (&s)[kF32RowsPerWarp],
                                            const float* s_q_warp,
                                            const float* krow) {
#pragma unroll
  for (int rr = 0; rr < kF32RowsPerWarp; ++rr) s[rr] = 0.f;
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) {
    const float kv = krow[d];
#pragma unroll
    for (int rr = 0; rr < kF32RowsPerWarp; ++rr)
      s[rr] = fmaf(s_q_warp[rr * kF32Stride + d], kv, s[rr]);
  }
}

// acc[rr][i] += sum over the n staged value rows of p[rr][c] * v[c][d],
// d = lane + 32 i, keys in ascending order; prow = the warp's first
// probability row at this tile's first key, rows `pstride` apart.
__device__ __forceinline__ void pv_rows_f32(float (&acc)[kF32RowsPerWarp][2],
                                            const float* prow, int pstride,
                                            const float* s_v, int n,
                                            int lane) {
  for (int c = 0; c < n; ++c) {
    const float v0 = s_v[c * kF32Stride + lane];
    const float v1 = s_v[c * kF32Stride + lane + 32];
#pragma unroll
    for (int rr = 0; rr < kF32RowsPerWarp; ++rr) {
      const float p = prow[rr * pstride + c];
      acc[rr][0] = fmaf(p, v0, acc[rr][0]);
      acc[rr][1] = fmaf(p, v1, acc[rr][1]);
    }
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace mpr_tiles
