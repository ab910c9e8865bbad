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
// What bounds it on the H100: one call reads the K and V caches once,
// 2 * B * T * W elements (59.8 MB at t5-large's cross-attention, B=128,
// T=114, W=1024, bf16), against ~2 * B * T * W multiply-adds: bound by the
// bytes of the caches. A single query has no matrix product, and K7's
// per-product rounding rules out the tensor cores.
//
// Design: one warp per (batch row, head) pair, four pairs a block (one a
// block below 1,024 pairs, so that a small batch still spreads over the
// SMs: eval's batch of one makes 8 blocks at 8 heads). The warps of a block
// share nothing and never wait for each other: no block barrier. At most
// 64 registers a thread, so that 8 blocks (32 warps) fit an SM: t5-small's
// 512 rows x 8 heads make 1,024 blocks, one wave on 132 SMs; t5-large's
// 128 x 16 make 512. A warp walks its head's K rows, then its V rows, in
// tiles of 3 KB (24 key rows in bf16, 12 in fp32):
//   * bf16 past 32 keys: through its own ring of 2 tiles in shared memory,
//     filled by 16-byte cp.async copies, one commit group per tile. Both
//     slots are requested at the start and each is refilled as soon as it
//     is read, so a tile is always in flight (the earlier design had one
//     16-byte load a lane) and V's first tile is requested while the last
//     K tiles are scored and the softmax runs;
//   * bf16 up to 32 keys (the decode's self-attention), and fp32 at every
//     T, straight from device memory, every row of a tile loaded before
//     the first is used: with so few keys the copies into shared memory
//     cost more than they hide, and an fp32 tile's 12 rows in flight a
//     warp already cover the latency (the ring was 1-5% slower in fp32).
// The head's fp32 scores (T floats) sit in the warp's shared memory.
//   * Scores: the warp splits into 4 groups of 8 lanes; group g takes rows
//     g, g + 4, ... of a tile, and lane j of a group 8 of the 64 head dims
//     (bf16: dims [8j, 8j+8); fp32: [4j, 4j+4) and [32+4j, 32+4j+4)), so
//     that the 8 lanes of a group read one 128-byte stretch of a row per
//     16-byte load: no bank conflicts without padding. 3 shuffles sum a
//     row's products; the bias and mask of the tile's rows are loaded
//     before the tile is waited for. K7 rounds its products two at a time
//     (one packed conversion, each product rounded on its own).
//   * Softmax: after the last K tile the warp normalises its own scores in
//     place (max, exponentials and their sum, p rounded), in the order of
//     the earlier design, while V's first tile lands.
//   * P.V: the same row split, fp32 accumulators, then 2 shuffles over the
//     groups; the 8 lanes of group 0 store the head's 64 outputs. In bf16
//     every sum runs in the earlier design's order.
// Past 56,576 keys the scores leave no room for the ring: the kernel reads
// the rows from device memory again, so every T up to 58,112 (the scores
// filling the 227 KB) runs at any head count.
// Instantiated for head dim 64, the d_kv of every T5 size.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "attention_tiles.cuh"

namespace {

using mpr_tiles::cp_async16;
using mpr_tiles::cp_async_commit;
using mpr_tiles::cp_async_wait;

constexpr int kHeadDim = 64;
constexpr int kGroups = 4;                     // key rows a warp reads at once
constexpr int kLanesPerRow = 32 / kGroups;     // 8
constexpr int kLaneDims = kHeadDim / kLanesPerRow;  // 8 dims a lane
constexpr int kTileBytes = 3072;               // a tile: 24 bf16 / 12 fp32 rows
constexpr int kStages = 2;                     // ring slots a warp
constexpr int kDirectMaxLen = 32;              // T up to: no ring
constexpr int kRingMaxElemBytes = 2;           // dtypes the ring takes: bf16
constexpr int kMaxWarps = 4;                   // (row, head) pairs a block
constexpr int kMinBlocks = 8;                  // an SM: <= 64 registers
constexpr int kSpreadPairs = 1024;             // fewer pairs: one a block
constexpr int kMaxHeads = 32;
constexpr float kNegInf = -1e9f;
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// two values rounded to the compute dtype each (one packed conversion)
__device__ __forceinline__ float2 round_pair(float a, float b, float) {
  return make_float2(a, b);
}
__device__ __forceinline__ float2 round_pair(float a, float b,
                                             __nv_bfloat16) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

// element offset of lane j's piece p within a 64-element row: 16-byte
// pieces, the 8 lanes of a group on 8 neighbouring pieces
template <typename T>
struct Pieces {
  static constexpr int kElems = 16 / sizeof(T);         // 8 bf16, 4 fp32
  static constexpr int kCount = kLaneDims / kElems;     // 1 bf16, 2 fp32
  static constexpr int kPerRow = kHeadDim / kElems;     // 8 bf16, 16 fp32
  // key rows a tile (24 bf16, 12 fp32) and group steps a tile (6, 3)
  static constexpr int kTileRows = kTileBytes / (kHeadDim * sizeof(T));
  static constexpr int kSteps = kTileRows / kGroups;
  static_assert(kSteps >= 1 && kSteps <= kLanesPerRow,
                "a lane writes one row's score a tile");
  static __device__ __forceinline__ int offset(int p, int j) {
    return p * kLanesPerRow * kElems + j * kElems;
  }
};

// a lane's 16-byte pieces of one row, as loaded (unpacked where used, so
// that a tile's loads can all be in flight before the first is needed)
template <typename T>
struct Row {
  uint4 p[Pieces<T>::kCount];
};

template <typename T>
__device__ __forceinline__ Row<T> fetch(const T* row, int j) {
  Row<T> r;
#pragma unroll
  for (int p = 0; p < Pieces<T>::kCount; ++p)
    r.p[p] = *reinterpret_cast<const uint4*>(row + Pieces<T>::offset(p, j));
  return r;
}

__device__ __forceinline__ void unpack16(const uint4& raw, float* x, float) {
  x[0] = __uint_as_float(raw.x);
  x[1] = __uint_as_float(raw.y);
  x[2] = __uint_as_float(raw.z);
  x[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void unpack16(const uint4& raw, float* x,
                                         __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// lane j's 8 dims of a row
template <typename T>
__device__ __forceinline__ void unpack(const Row<T>& r,
                                       float (&x)[kLaneDims]) {
#pragma unroll
  for (int p = 0; p < Pieces<T>::kCount; ++p)
    unpack16(r.p[p], x + p * Pieces<T>::kElems, T());
}

__device__ __forceinline__ void store16(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* x) {
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

size_t score_bytes(int T_len) {
  return (sizeof(float) * static_cast<size_t>(T_len) + 15) / 16 * 16;
}

template <typename T>
int slot_rows(int T_len) {
  return T_len < Pieces<T>::kTileRows ? T_len : Pieces<T>::kTileRows;
}

template <typename T>
size_t ring_bytes(int T_len) {
  const int tiles =
      2 * ((T_len + Pieces<T>::kTileRows - 1) / Pieces<T>::kTileRows);
  return static_cast<size_t>(tiles < kStages ? tiles : kStages) *
         slot_rows<T>(T_len) * kHeadDim * sizeof(T);
}

// One warp per (batch row, head) pair; the warps of a block share nothing
// and never wait for each other. Shared memory: a region of warp_bytes a
// warp, the head's T fp32 scores, then (kStaged) its ring.
template <typename T, bool kRoundProducts, bool kStaged>
__global__ void __launch_bounds__(32 * kMaxWarps, kMinBlocks)
decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    int64_t q_bstride, int64_t k_bstride, int64_t k_rstride,
    int64_t v_bstride, int64_t v_rstride, const float* __restrict__ bias,
    const int* __restrict__ mask, T* __restrict__ out, int pairs, int T_len,
    int H, float scale, int warp_bytes, int ring_offset, int rows_per_slot) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pair = blockIdx.x * (blockDim.x / 32) + warp;
  if (pair >= pairs) return;  // no block barrier below
  const int b = pair / H, h = pair % H;
  unsigned char* region = smem + static_cast<size_t>(warp) * warp_bytes;
  float* s_score = reinterpret_cast<float*>(region);        // [T_len]
  T* ring = reinterpret_cast<T*>(region + ring_offset);     // [slots][rows][64]
  constexpr int kTileRows = Pieces<T>::kTileRows, kSteps = Pieces<T>::kSteps;
  const int g = lane / kLanesPerRow, j = lane % kLanesPerRow;
  const int n = (T_len + kTileRows - 1) / kTileRows;  // tiles of K, of V
  const T* kb = k + b * k_bstride + h * kHeadDim;
  const T* vb = v + b * v_bstride + h * kHeadDim;
  const float* bias_h = bias != nullptr
                            ? bias + static_cast<int64_t>(h) * T_len
                            : nullptr;
  const int* mask_b = mask != nullptr ? mask + static_cast<int64_t>(b) * T_len
                                      : nullptr;

  // tile u of the stream K 0..n-1, V 0..n-1 into ring slot u % kStages:
  // lane l copies the 16-byte pieces l, l + 32, ... of the tile, rows
  // r0, r0 + kRowStep, ... at one column
  constexpr int kRowStep = 32 / Pieces<T>::kPerRow;
  const int r0 = lane / Pieces<T>::kPerRow;
  const int col = (lane % Pieces<T>::kPerRow) * Pieces<T>::kElems;
  auto issue = [&](int u) {
    const bool is_k = u < n;
    const int t0 = (is_k ? u : u - n) * kTileRows;
    const int rows = min(kTileRows, T_len - t0);
    const int64_t rs = is_k ? k_rstride : v_rstride;
    const T* src = (is_k ? kb : vb) + t0 * rs + r0 * rs + col;
    T* dst = ring + ((u % kStages) * rows_per_slot + r0) * kHeadDim + col;
#pragma unroll
    for (int m = 0; m < kTileRows / kRowStep; ++m)
      if (r0 + m * kRowStep < rows)
        cp_async16(dst + m * kRowStep * kHeadDim, src + m * kRowStep * rs);
  };

  if (kStaged) {
#pragma unroll
    for (int u = 0; u < kStages; ++u) {
      if (u < 2 * n) issue(u);
      cp_async_commit();  // one group per tile index, empty past the end
    }
  }
  // tile u's rows (ring slot or device memory) and their stride, once
  // every lane's part has landed
  auto rows_of = [&](int u, const T*& rows, int64_t& rs) {
    if (kStaged) {
      cp_async_wait<kStages - 1>();  // tile u has landed (this lane's part)
      rows = ring + (u % kStages) * rows_per_slot * kHeadDim;
      rs = kHeadDim;
    } else {
      rs = u < n ? k_rstride : v_rstride;
      rows = (u < n ? kb : vb) + (u < n ? u : u - n) * kTileRows * rs;
    }
    __syncwarp();  // every lane's part of tile u; every score or p
  };
  // after tile u's steps: its slot takes tile u + kStages
  auto refill = [&](int u) {
    if (kStaged) {
      __syncwarp();  // slot u % kStages is read
      if (u + kStages < 2 * n) issue(u + kStages);
      cp_async_commit();
    }
  };
  // the rows of a tile that this lane's group takes: from device memory
  // all loads in flight at once, before the first is needed; from the ring
  // (a short latency) one step's row at a time. Steps past T are skipped
  // by the whole warp.
  auto fetch_tile = [&](const T* rows, int64_t rs, int t0,
                        Row<T> (&tile)[kSteps]) {
    if (kStaged) return;
#pragma unroll
    for (int i = 0; i < kSteps; ++i)
      if (t0 + g + kGroups * i < T_len)
        tile[i] = fetch(rows + (g + kGroups * i) * rs, j);
  };
  auto row_at = [&](const T* rows, int64_t rs, const Row<T> (&tile)[kSteps],
                    int i) {
    return kStaged ? fetch(rows + (g + kGroups * i) * rs, j) : tile[i];
  };

  float qv[kLaneDims];
  unpack(fetch(q + b * q_bstride + h * kHeadDim, j), qv);
  for (int u = 0; u < n; ++u) {
    const int t0 = u * kTileRows;
    // the bias and mask terms of the score lane j writes in this tile
    float b_add = 0.f, m_add = 0.f;
    if (j < kSteps) {
      const int t = t0 + g + kGroups * j;
      if (t < T_len) {
        if (bias_h != nullptr) b_add = bias_h[t];
        if (mask_b != nullptr) m_add = mask_b[t] != 0 ? 0.f : kNegInf;
      }
    }
    const T* rows;
    int64_t rs;
    rows_of(u, rows, rs);
    Row<T> tile[kSteps];
    fetch_tile(rows, rs, t0, tile);
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      if (t0 + kGroups * i >= T_len) break;
      const int t = t0 + g + kGroups * i;
      float acc = 0.f;
      if (t < T_len) {
        float kv[kLaneDims];
        unpack(row_at(rows, rs, tile, i), kv);
#pragma unroll
        for (int e = 0; e < kLaneDims; e += 2) {
          if (kRoundProducts) {
            // __fmul_rn is never contracted into an fma: each product is
            // rounded to fp32, then to the compute dtype
            const float2 pr = round_pair(__fmul_rn(qv[e], kv[e]),
                                         __fmul_rn(qv[e + 1], kv[e + 1]),
                                         T());
            acc += pr.x;
            acc += pr.y;
          } else {
            acc = fmaf(qv[e], kv[e], acc);
            acc = fmaf(qv[e + 1], kv[e + 1], acc);
          }
        }
      }
#pragma unroll
      for (int off = kLanesPerRow / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (t < T_len && j == i) {
        float s = round_to(acc, T());
        if (scale != 1.f) s *= scale;
        if (bias_h != nullptr) s += b_add;
        if (mask_b != nullptr) s += m_add;
        s_score[t] = s;
      }
    }
    refill(u);
  }

  // softmax of the head over T, p rounded to the compute dtype, while V's
  // first tiles land
  __syncwarp();
  float m = -INFINITY;
  for (int t = lane; t < T_len; t += 32) m = fmaxf(m, s_score[t]);
  m = warp_max(m);
  float sum = 0.f;
  for (int t = lane; t < T_len; t += 32) {
    const float e = expf(s_score[t] - m);
    s_score[t] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  for (int t = lane; t < T_len; t += 32)
    s_score[t] = round_to(s_score[t] / sum, T());

  float o[kLaneDims];
#pragma unroll
  for (int i = 0; i < kLaneDims; ++i) o[i] = 0.f;
  for (int u = n; u < 2 * n; ++u) {
    const int t0 = (u - n) * kTileRows;
    const T* rows;
    int64_t rs;
    rows_of(u, rows, rs);
    Row<T> tile[kSteps];
    fetch_tile(rows, rs, t0, tile);
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      if (t0 + kGroups * i >= T_len) break;
      const int t = t0 + g + kGroups * i;
      if (t < T_len) {
        const float p = s_score[t];
        float vv[kLaneDims];
        unpack(row_at(rows, rs, tile, i), vv);
#pragma unroll
        for (int e = 0; e < kLaneDims; ++e) o[e] = fmaf(p, vv[e], o[e]);
      }
    }
    refill(u);
  }

  // P.V summed over the 4 groups; group 0 stores the head's 64 outputs
#pragma unroll
  for (int e = 0; e < kLaneDims; ++e) {
    o[e] += __shfl_xor_sync(0xffffffffu, o[e], 8);
    o[e] += __shfl_xor_sync(0xffffffffu, o[e], 16);
  }
  if (g == 0) {
    T* ob = out + static_cast<int64_t>(b) * H * kHeadDim + h * kHeadDim;
#pragma unroll
    for (int p = 0; p < Pieces<T>::kCount; ++p)
      store16(ob + Pieces<T>::offset(p, j), o + p * Pieces<T>::kElems);
  }
}

template <typename T, bool kRound, bool kStaged>
cudaError_t launch(const void* q, const void* k, const void* v, int64_t q_bs,
                   int64_t k_bs, int64_t k_rs, int64_t v_bs, int64_t v_rs,
                   const void* bias, const void* mask, void* out, int B,
                   int T_len, int H, float scale, size_t warp_bytes,
                   cudaStream_t stream) {
  auto kernel = decode_attention_kernel<T, kRound, kStaged>;
  const int pairs = B * H;
  int warps = static_cast<int>(kMaxSmem / warp_bytes);
  if (warps > kMaxWarps) warps = kMaxWarps;
  if (pairs < kSpreadPairs) warps = 1;  // spread a small batch over the SMs
  const size_t smem = warps * warp_bytes;
  if (smem > 48 * 1024) {  // only past ~3,000 keys: no host call below
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(pairs + warps - 1) / warps, 32 * warps, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_bs, k_bs, k_rs, v_bs, v_rs,
      static_cast<const float*>(bias), static_cast<const int*>(mask),
      static_cast<T*>(out), pairs, T_len, H, scale,
      static_cast<int>(warp_bytes), static_cast<int>(score_bytes(T_len)),
      slot_rows<T>(T_len));
  return cudaGetLastError();
}

template <typename T, bool kRound>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     int64_t q_bs, int64_t k_bs, int64_t k_rs, int64_t v_bs,
                     int64_t v_rs, const void* bias, const void* mask,
                     void* out, int B, int T_len, int H, float scale,
                     cudaStream_t stream) {
  if constexpr (sizeof(T) <= kRingMaxElemBytes) {
    const size_t staged = score_bytes(T_len) + ring_bytes<T>(T_len);
    if (T_len > kDirectMaxLen && staged <= static_cast<size_t>(kMaxSmem))
      return launch<T, kRound, true>(q, k, v, q_bs, k_bs, k_rs, v_bs, v_rs,
                                     bias, mask, out, B, T_len, H, scale,
                                     staged, stream);
  }
  // fp32, few keys, or the scores alone fill the shared memory: rows
  // from device memory
  return launch<T, kRound, false>(q, k, v, q_bs, k_bs, k_rs, v_bs, v_rs,
                                  bias, mask, out, B, T_len, H, scale,
                                  score_bytes(T_len), stream);
}

}  // namespace

extern "C" {

// Largest T whose fp32 scores (one head's: a warp holds one) fit in
// shared memory; the same at every head count from 1 to 32.
int mpr_decode_attention_max_len(int H) {
  if (H < 1 || H > kMaxHeads) return 0;
  return static_cast<int>(kMaxSmem / sizeof(float));
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
      T_len > mpr_decode_attention_max_len(H) ||
      static_cast<int64_t>(B) * H > 0x7fffffff - kMaxWarps)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = round_products
              ? dispatch<float, true>(q, k, v, q_bstride, k_bstride,
                                      k_rstride, v_bstride, v_rstride, bias,
                                      mask, out, B, T_len, H, scale, s)
              : dispatch<float, false>(q, k, v, q_bstride, k_bstride,
                                       k_rstride, v_bstride, v_rstride, bias,
                                       mask, out, B, T_len, H, scale, s);
  } else {
    err = round_products
              ? dispatch<__nv_bfloat16, true>(q, k, v, q_bstride, k_bstride,
                                              k_rstride, v_bstride, v_rstride,
                                              bias, mask, out, B, T_len, H,
                                              scale, s)
              : dispatch<__nv_bfloat16, false>(q, k, v, q_bstride, k_bstride,
                                               k_rstride, v_bstride,
                                               v_rstride, bias, mask, out, B,
                                               T_len, H, scale, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
