// Fused L2 distance + top-k over the retrieval index, for Hopper (sm_90a).
//
// Replaces the Pallas kernel _topk_kernel / _l2_topk_pallas behind
// l2_topk(impl="pallas") (multimodalpromptretrieval_tpu/ops/topk.py), the
// nearest-neighbour search of the serving path. Its plain PyTorch version
// is l2_topk_reference (multimodalpromptretrieval_tpu_torch/ops/topk.py).
//
// Semantics, kept exactly:
//   * squared distance in the JAX form qsq - 2*dot + nsq, fp32 products and
//     sums on the CUDA cores (no TF32);
//   * ties go to the lower corpus index (a stable ascending sort of the
//     distance row);
//   * distances returned as sqrt(max(d, 0)), ascending.
//
// What bounds it on the H100: the serving index is small (N = 1,230 rows of
// 1,024 fp32 = 5 MB, inside the 50 MB L2) and B = 512 queries make about
// 1.3 GFLOP, so launch latency and the selection, not bandwidth, dominate.
//
// Design: the TPU kernel carried a running top-k across sequential grid
// steps in scratch memory. Blocks on Hopper run in parallel with nothing
// carried between them, so the reduction takes two passes:
//   1. one block per (8 queries, slice of 256 index rows): the slice and
//      the queries stream through shared memory in 32-wide column tiles,
//      each thread accumulating its row's 8 dot products; then one warp per
//      query selects the slice's k best by k rounds of a warp-wide
//      lexicographic (distance, index) argmin, and writes them to scratch;
//   2. one warp per query merges the slices' lists the same way and takes
//      the square root.
// k is a runtime value up to kMaxK.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kQ = 8;         // queries per block (one warp each)
constexpr int kRows = 256;    // index rows per slice (one per thread)
constexpr int kDTile = 32;    // columns per shared-memory tile
constexpr int kThreads = 256;
constexpr int kPerLane = kRows / 32;
constexpr int kMaxK = 32;
constexpr float kBig = 3.4e38f;  // the padded tail's distance (as on TPU)

__device__ __forceinline__ bool better(float d1, int i1, float d2, int i2) {
  return d1 < d2 || (d1 == d2 && i1 < i2);
}

__device__ __forceinline__ void warp_argmin(float& d, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, d, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(od, oi, d, i)) {
      d = od;
      i = oi;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
slice_topk_kernel(const float* __restrict__ query,
                  const float* __restrict__ qsq,
                  const float* __restrict__ index,
                  const float* __restrict__ index_sq, int B, int N, int D,
                  int k, float* __restrict__ part_d,
                  int* __restrict__ part_i) {
  __shared__ float s_x[kRows][kDTile + 1];
  __shared__ float s_q[kQ][kDTile];
  __shared__ float s_dist[kQ][kRows];

  const int b0 = blockIdx.x * kQ;
  const int slice = blockIdx.y, n_slices = gridDim.y;
  const int n0 = slice * kRows;
  const int t = threadIdx.x;

  float acc[kQ];
#pragma unroll
  for (int j = 0; j < kQ; ++j) acc[j] = 0.f;
  for (int d0 = 0; d0 < D; d0 += kDTile) {
    __syncthreads();
    for (int e = t; e < kRows * kDTile; e += kThreads) {
      const int r = e / kDTile, c = e % kDTile;
      const int n = n0 + r, d = d0 + c;
      s_x[r][c] = (n < N && d < D) ? index[static_cast<int64_t>(n) * D + d]
                                   : 0.f;
    }
    for (int e = t; e < kQ * kDTile; e += kThreads) {
      const int r = e / kDTile, c = e % kDTile;
      const int b = b0 + r, d = d0 + c;
      s_q[r][c] = (b < B && d < D) ? query[static_cast<int64_t>(b) * D + d]
                                   : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kDTile; ++c) {
      const float x = s_x[t][c];
#pragma unroll
      for (int j = 0; j < kQ; ++j) acc[j] = fmaf(s_q[j][c], x, acc[j]);
    }
  }
  const int n = n0 + t;
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    const int b = min(b0 + j, B - 1);
    s_dist[j][t] = n < N ? (qsq[b] - 2.f * acc[j]) + index_sq[n] : kBig;
  }
  __syncthreads();

  // one warp per query: the slice's k best, ascending
  const int warp = t / 32, lane = t % 32;
  const int b = b0 + warp;
  if (b >= B) return;
  float vals[kPerLane];
#pragma unroll
  for (int m = 0; m < kPerLane; ++m) vals[m] = s_dist[warp][lane + 32 * m];
  unsigned taken = 0;
  float* out_d = part_d + (static_cast<int64_t>(b) * n_slices + slice) * k;
  int* out_i = part_i + (static_cast<int64_t>(b) * n_slices + slice) * k;
  for (int r = 0; r < k; ++r) {
    float bd = INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int m = 0; m < kPerLane; ++m) {
      const int idx = n0 + lane + 32 * m;
      if (!(taken & (1u << m)) && better(vals[m], idx, bd, bi)) {
        bd = vals[m];
        bi = idx;
      }
    }
    warp_argmin(bd, bi);
#pragma unroll
    for (int m = 0; m < kPerLane; ++m)
      if (n0 + lane + 32 * m == bi) taken |= 1u << m;
    if (lane == 0) {
      out_d[r] = bd;
      out_i[r] = bi;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
merge_topk_kernel(float* __restrict__ part_d, int* __restrict__ part_i,
                  int B, int n_cand, int k, float* __restrict__ out_d,
                  int* __restrict__ out_i) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * kQ + warp;
  if (b >= B) return;
  float* cd = part_d + static_cast<int64_t>(b) * n_cand;
  int* ci = part_i + static_cast<int64_t>(b) * n_cand;
  for (int r = 0; r < k; ++r) {
    float bd = INFINITY;
    int bi = INT_MAX, bpos = -1;
    for (int j = lane; j < n_cand; j += 32) {
      if (better(cd[j], ci[j], bd, bi)) {
        bd = cd[j];
        bi = ci[j];
        bpos = j;
      }
    }
    const int mine = bi;
    warp_argmin(bd, bi);
    if (bpos >= 0 && mine == bi) {  // indices are unique: one lane owns it
      cd[bpos] = INFINITY;
      ci[bpos] = INT_MAX;
    }
    __syncwarp();
    if (lane == 0) {
      out_d[static_cast<int64_t>(b) * k + r] = sqrtf(fmaxf(bd, 0.f));
      out_i[static_cast<int64_t>(b) * k + r] = bi;
    }
  }
}

}  // namespace

extern "C" {

// Slices the index is cut into (the scratch holds B * slices * k entries).
int mpr_l2_topk_slices(int N) { return (N + kRows - 1) / kRows; }

int mpr_l2_topk_max_k() { return kMaxK; }

// query (B, D), qsq (B,), index (N, D), index_sq (N,): fp32, contiguous.
// scratch_d/i: B * mpr_l2_topk_slices(N) * k entries. out: (B, k).
int mpr_l2_topk(const void* query, const void* qsq, const void* index,
                const void* index_sq, int B, int N, int D, int k,
                void* scratch_d, void* scratch_i, void* out_d, void* out_i,
                void* stream) {
  if (k < 1 || k > kMaxK || k > N) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_slices = mpr_l2_topk_slices(N);
  dim3 grid1((B + kQ - 1) / kQ, n_slices);
  slice_topk_kernel<<<grid1, kThreads, 0, s>>>(
      static_cast<const float*>(query), static_cast<const float*>(qsq),
      static_cast<const float*>(index), static_cast<const float*>(index_sq),
      B, N, D, k, static_cast<float*>(scratch_d),
      static_cast<int*>(scratch_i));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_topk_kernel<<<(B + kQ - 1) / kQ, kThreads, 0, s>>>(
      static_cast<float*>(scratch_d), static_cast<int*>(scratch_i), B,
      n_slices * k, k, static_cast<float*>(out_d),
      static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
