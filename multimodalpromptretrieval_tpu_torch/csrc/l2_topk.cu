// Fused L2 distance + top-k over the retrieval index, for Hopper (sm_90a).
//
// Replaces the Pallas kernel _topk_kernel / _l2_topk_pallas behind
// l2_topk(impl="pallas") (multimodalpromptretrieval_tpu/ops/topk.py), the
// nearest-neighbour search of the serving path. Its plain PyTorch version
// is l2_topk_reference (multimodalpromptretrieval_tpu_torch/ops/topk.py).
//
// Semantics, kept exactly:
//   * squared distance in the JAX form (qsq - 2*dot) + nsq, fp32 products
//     and sums on the CUDA cores (no TF32, no split bf16 product: either
//     would change the low bits of every distance and with them the order
//     of near ties);
//   * ties go to the lower corpus index (a stable ascending sort of the
//     distance row);
//   * distances returned as sqrt(max(d, 0)), ascending (or, with `squared`,
//     the squared distances the ranking compared: a merge of top-k lists of
//     row blocks needs them, since two squared distances can share a root).
//
// What bounds it on the H100: the serving index is small (N = 1,230 rows of
// 1,024 fp32 = 5 MB, inside the 50 MB L2) and B = 512 queries make 1.3
// GFLOP of fp32 multiply-adds: it is bound by operations. Its earlier form
// gave each thread one index row against 8 queries, nine shared-memory
// loads for eight multiply-adds, and fetched every index row from L2 64
// times: shared memory, not the FP32 pipe, set its pace (9.6x the bound).
// Shared memory stays the scarce thing: an SM has 128 FP32 lanes and takes
// 128 bytes a clock from shared memory, and an 8 x 8 block of dots, the
// largest that leaves two blocks' worth of registers, still needs one byte
// per multiply-add.
//
// Design: the TPU kernel carried a running top-k across sequential grid
// steps in scratch memory. Blocks on Hopper run in parallel with nothing
// carried between them, so the reduction takes two passes.
//   1. tile_dist_kernel<TQ>, one block per (TQ queries, 64 index rows): a
//      register-tiled product. Both operands stream through a ring of three
//      shared buffers in 32-column chunks by 16-byte cp.async (rows padded
//      to 36 words, so that the 16-byte reads below fall on distinct
//      banks). The 4 * TQ threads are 4 column groups: a group takes 8 of a
//      chunk's 32 columns, and each of its TQ threads an 8 x 8 block of the
//      tile's dots (queries ty + TQ / 8 * i, rows tx + 8 j), so a 16-byte
//      shared load feeds 32 multiply-adds and the sums run along D in
//      ascending order within a thread. The column split is what gives the
//      small problem enough threads: 8 x 8 blocks alone would leave 2 warps
//      an SM. The groups' partial dots meet in shared memory and group 0
//      writes the distances to a (B, tiles * 64) scratch matrix, 3.4e38
//      (as on the TPU) for the rows past N. At the serving sizes the matrix
//      is 2.6 MB and stays in L2. The queries' squared norms are summed
//      from the staged chunks on the way. TQ is 64, or 32 where that fills
//      the 132 SMs more evenly (B = 512, N = 1,230: 320 half-size blocks,
//      three to an SM at most, instead of 160, two to an SM at most).
//   2. select_topk_kernel, one block of 4 warps per query: every thread
//      keeps the best (distance, index) of its share of the row that it has
//      not given yet; a round is one block-wide lexicographic argmin, after
//      which only the thread that won rescans its share. fetch == 1 (the
//      serving default) is one scan and one reduction. A thread holds one
//      candidate, not a list, so nothing bounds k but N: the rounds run
//      over the distance matrix, which holds the whole row, and k == N
//      gives the whole row in order.

#include <climits>

#include "attention_tiles.cuh"

namespace {

using mpr_tiles::aligned16;
using mpr_tiles::cp_async16;
using mpr_tiles::cp_async_commit;
using mpr_tiles::cp_async_wait;

constexpr int kTileRows = 64;  // index rows of a block
constexpr int kChunk = 32;     // columns staged per step
constexpr int kStride = kChunk + 4;  // padded shared row: 144 bytes
constexpr int kStages = 3;     // ring of staged chunks
constexpr int kGroups = 4;     // column groups
constexpr int kGroupCols = kChunk / kGroups;
constexpr int kSelectThreads = 128;  // of the block that selects a query's k
constexpr int kSms = 132;
constexpr float kBig = 3.4e38f;  // the padded tail's distance (as on TPU)

__host__ __device__ constexpr int stage_floats(int TQ) {
  return (TQ + kTileRows) * kStride;  // queries, then index rows
}

__device__ __forceinline__ bool better(float d1, int i1, float d2, int i2) {
  return d1 < d2 || (d1 == d2 && i1 < i2);
}

// Four columns from column d on of one row into a staged chunk: by cp.async
// where `vec` (16-byte aligned rows, D a multiple of 4), zeros for a row
// that does not exist and for columns past D.
__device__ __forceinline__ void stage4(float* dst, const float* src,
                                       bool row_ok, int d, int D, bool vec) {
  if (row_ok && vec && d < D) {
    cp_async16(dst, src);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[i] = row_ok && d + i < D ? src[i] : 0.f;
  }
}

template <int TQ>
__global__ void __launch_bounds__(kGroups * TQ, 512 / (kGroups * TQ))
tile_dist_kernel(const float* __restrict__ query,
                 const float* __restrict__ index,
                 const float* __restrict__ index_sq, int B, int N, int D,
                 int vec, float* __restrict__ dist) {
  constexpr int kThreads = kGroups * TQ;
  constexpr int kQStep = TQ / 8;         // between a thread's 8 queries
  constexpr int kColThreads = kChunk / 4;  // threads along a staged row
  constexpr int kRowStep = kThreads / kColThreads;  // between staged rows
  constexpr int kStageFloats = stage_floats(TQ);
  static_assert((kGroups - 1) * 64 * TQ <= kStages * kStageFloats,
                "the partial dots reuse the ring");
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_qsq[TQ];

  const int b0 = blockIdx.x * TQ, n0 = blockIdx.y * kTileRows;
  const int tid = threadIdx.x;
  const int grp = tid / TQ, tg = tid % TQ;
  const int ty = tg / 8, tx = tg % 8;
  const int n_chunks = (D + kChunk - 1) / kChunk;

  // a thread stages the same 4 columns of rows srow, srow + kRowStep, ...
  // of every chunk: TQ query rows, then the 64 index rows
  const int srow = tid / kColThreads, scol = (tid % kColThreads) * 4;
  const float* q_src = query + static_cast<int64_t>(b0 + srow) * D + scol;
  const float* x_src = index + static_cast<int64_t>(n0 + srow) * D + scol;
  auto prefetch = [&](int c) {
    if (c < n_chunks) {
      float* dst =
          smem + (c % kStages) * kStageFloats + srow * kStride + scol;
      const int d = c * kChunk + scol;
#pragma unroll
      for (int it = 0; it < TQ / kRowStep; ++it)
        stage4(dst + it * kRowStep * kStride,
               q_src + static_cast<int64_t>(it * kRowStep) * D + c * kChunk,
               b0 + srow + it * kRowStep < B, d, D, vec);
#pragma unroll
      for (int it = 0; it < kTileRows / kRowStep; ++it)
        stage4(dst + (TQ + it * kRowStep) * kStride,
               x_src + static_cast<int64_t>(it * kRowStep) * D + c * kChunk,
               n0 + srow + it * kRowStep < N, d, D, vec);
    }
    cp_async_commit();  // one group per chunk index, empty past the end
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float qq = 0.f;  // a quarter of each chunk of query tid / 4, squared, summed

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) prefetch(c);
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    // chunk c has landed, and chunk c - 1, whose buffer the next copy
    // takes, is consumed
    __syncthreads();
    prefetch(c + kStages - 1);
    const float* s_q = smem + (c % kStages) * kStageFloats;
    const float* s_x = s_q + TQ * kStride;
#pragma unroll
    for (int s = 0; s < kGroupCols / 4; ++s) {
      const int col = grp * kGroupCols + s * 4;
      float4 x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        x[j] = *reinterpret_cast<const float4*>(s_x + (tx + 8 * j) * kStride +
                                                col);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(
            s_q + (ty + kQStep * i) * kStride + col);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float a = acc[i][j];
          a = fmaf(qv.x, x[j].x, a);
          a = fmaf(qv.y, x[j].y, a);
          a = fmaf(qv.z, x[j].z, a);
          acc[i][j] = fmaf(qv.w, x[j].w, a);
        }
      }
    }
    const float* p = s_q + (tid / 4) * kStride + (tid % 4) * (kChunk / 4);
#pragma unroll
    for (int i = 0; i < kChunk / 4; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + i);
      qq = fmaf(a.x, a.x, qq);
      qq = fmaf(a.y, a.y, qq);
      qq = fmaf(a.z, a.z, qq);
      qq = fmaf(a.w, a.w, qq);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every chunk is consumed: the ring is free

  // the groups' partial dots meet in group 0
  float* s_red = smem;  // [kGroups - 1][8 x 8][TQ threads]
  if (grp > 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        s_red[((grp - 1) * 64 + i * 8 + j) * TQ + tg] = acc[i][j];
  }
  qq += __shfl_xor_sync(0xffffffffu, qq, 1);
  qq += __shfl_xor_sync(0xffffffffu, qq, 2);
  if (tid % 4 == 0) s_qsq[tid / 4] = qq;
  __syncthreads();
  if (grp != 0) return;  // no barrier follows

  const int64_t stride = static_cast<int64_t>(gridDim.y) * kTileRows;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + tx + 8 * j;
    const float nsq = n < N ? index_sq[n] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float dot = acc[i][j];
#pragma unroll
      for (int g = 0; g < kGroups - 1; ++g)
        dot += s_red[(g * 64 + i * 8 + j) * TQ + tg];
      const int qi = ty + kQStep * i;
      if (b0 + qi < B)
        dist[(b0 + qi) * stride + n] =
            n < N ? (s_qsq[qi] - 2.f * dot) + nsq : kBig;
    }
  }
}

// One block per query: the `fetch` best (distance, index) of the query's
// row of the distance matrix (`stride` entries, those past N at 3.4e38), in
// ascending order with ties to the lower index, and their square roots (the
// squared distances themselves with `squared`).
__global__ void __launch_bounds__(kSelectThreads)
select_topk_kernel(const float* __restrict__ dist, int N, int64_t stride,
                   int fetch, int squared, float* __restrict__ out_d,
                   int* __restrict__ out_i) {
  constexpr int kWarps = kSelectThreads / 32;
  __shared__ float s_d[2][kWarps];  // the warps' bests, by round parity
  __shared__ int s_i[2][kWarps];
  const int b = blockIdx.x, tid = threadIdx.x;
  const float4* row = reinterpret_cast<const float4*>(dist + b * stride);

  // A thread's share is every 128th group of 4 entries. Candidates leave in
  // ascending order, so those a thread has given are the ones up to its
  // last.
  float last_d = -INFINITY, ld;
  int last_i = -1, li;
  auto scan = [&]() {  // the best of the share that is past the last given
    ld = INFINITY;
    li = INT_MAX;
#pragma unroll 4
    for (int n4 = tid; n4 * 4 < N; n4 += kSelectThreads) {
      const float4 v = row[n4];
      const float d[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (better(last_d, last_i, d[e], n4 * 4 + e) &&
            better(d[e], n4 * 4 + e, ld, li)) {
          ld = d[e];
          li = n4 * 4 + e;
        }
    }
  };
  scan();
  for (int r = 0; r < fetch; ++r) {
    float bd = ld;
    int bi = li;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (better(od, oi, bd, bi)) {
        bd = od;
        bi = oi;
      }
    }
    if (tid % 32 == 0) {
      s_d[r & 1][tid / 32] = bd;
      s_i[r & 1][tid / 32] = bi;
    }
    // one barrier a round: the buffer of round r is written again in round
    // r + 2, behind the barrier of round r + 1
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (better(s_d[r & 1][w], s_i[r & 1][w], bd, bi)) {
        bd = s_d[r & 1][w];
        bi = s_i[r & 1][w];
      }
    if (tid == 0) {
      out_d[static_cast<int64_t>(b) * fetch + r] =
          squared ? bd : sqrtf(fmaxf(bd, 0.f));
      out_i[static_cast<int64_t>(b) * fetch + r] = bi;
    }
    if (li == bi) {  // indices are unique: one thread gave it
      last_d = ld;
      last_i = li;
      scan();
    }
  }
}

template <int TQ>
cudaError_t launch_dist(const float* query, const float* index,
                        const float* index_sq, int B, int N, int D, int vec,
                        float* dist, int n_tiles, cudaStream_t stream) {
  constexpr size_t smem = kStages * stage_floats(TQ) * sizeof(float);
  auto kernel = tile_dist_kernel<TQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((B + TQ - 1) / TQ, n_tiles);
  kernel<<<grid, kGroups * TQ, smem, stream>>>(query, index, index_sq, B, N,
                                               D, vec, dist);
  return cudaGetLastError();
}

// Work the fullest SM is left with when the blocks of `tq` queries by 64
// rows go round the SMs, in query rows.
int64_t makespan(int B, int n_tiles, int tq) {
  const int64_t blocks = static_cast<int64_t>((B + tq - 1) / tq) * n_tiles;
  return (blocks + kSms - 1) / kSms * tq;
}

}  // namespace

extern "C" {

// Entries of a query's row of the distance scratch: N rounded up to whole
// row tiles (the scratch holds B such rows).
int mpr_l2_topk_scratch_cols(int N) {
  return (N + kTileRows - 1) / kTileRows * kTileRows;
}

// query (B, D), index (N, D), index_sq (N,): fp32, contiguous. scratch:
// B * mpr_l2_topk_scratch_cols(N) floats. out: (B, k), 1 <= k <= N; out_d
// holds squared distances when `squared` is non-zero.
int mpr_l2_topk(const void* query, const void* index, const void* index_sq,
                int B, int N, int D, int k, void* scratch, void* out_d,
                void* out_i, int squared, void* stream) {
  if (k < 1 || k > N || B < 1 || D < 1)
    return cudaErrorInvalidValue;
  const int n_tiles = mpr_l2_topk_scratch_cols(N) / kTileRows;
  if (n_tiles > 65535) return cudaErrorInvalidValue;  // the grid's y extent
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(query);
  const float* x = static_cast<const float*>(index);
  const float* nsq = static_cast<const float*>(index_sq);
  float* dist = static_cast<float*>(scratch);
  const int vec = aligned16(query) && aligned16(index) && D % 4 == 0;
  // half-size blocks where they leave the fullest SM less to do
  const bool half = makespan(B, n_tiles, 32) < makespan(B, n_tiles, 64);
  cudaError_t err =
      half ? launch_dist<32>(q, x, nsq, B, N, D, vec, dist, n_tiles, s)
           : launch_dist<64>(q, x, nsq, B, N, D, vec, dist, n_tiles, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  select_topk_kernel<<<B, kSelectThreads, 0, s>>>(
      dist, N, static_cast<int64_t>(n_tiles) * kTileRows, k, squared,
      static_cast<float*>(out_d), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
