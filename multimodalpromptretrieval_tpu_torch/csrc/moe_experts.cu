// Routed experts of a mixture-of-experts layer (K10), for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no expert layer. The port
// added it for the LM generator (models/moe_lm.py: Kimi-VL-A3B's 64 routed
// experts of width 1,408, 6 a token). Its plain PyTorch version is
// moe_experts_reference (multimodalpromptretrieval_tpu_torch/ops/moe.py):
// sum_i w_i E_i(h) over each token's k experts, E(h) = W_down(silu(W_gate h)
// * W_up h).
//
// Both kernels run over the tiled layout that ops/moe.tile_rows builds on
// the device: the N k (token, slot) rows sorted by expert, each expert's run
// padded to whole tiles of BM rows; `rows` (tiles * BM) holds the row of
// each place (N k for a pad), `tile_expert` (tiles) each tile's expert, -1
// past the last. A block takes one (tile, block of output columns); a block
// whose tile has no expert returns at once, so the grid is sized from the
// shapes alone and the host never reads the counts.
//   * gate / up (GATED): A = the tile's token rows of h, gathered; B = the
//     expert's gate rows and up rows of the block's columns; both products
//     over the same A tile, then silu(gate) * up rounded once to the input
//     dtype, stored at the place: act (tiles * BM, I).
//   * down: A = the tile's rows of act, B = the expert's W_down rows of the
//     block's columns; each product times the row's routing weight, in
//     fp32, written once to its (token, slot) row of out (N k, d). The
//     caller sums a token's k rows in a fixed order (no atomics).
//
// What bounds it on the H100: at a prefill chunk (58,368 tokens x 6 rows,
// ~5,500 an expert) the products, ~6 TFLOP a layer; at a decode step (512
// tokens, ~48 rows an expert) reading every expert's weights, 1.1 GB a
// layer. bf16: both products on the tensor cores (mma.sync m16n8k16, fp32
// accumulators, the tile helpers of attention_tiles.cuh), the A and B tiles
// brought by cp.async into padded shared rows through a ring of stages:
//   * BM 128 (prefill, many rows an expert): 8 warps of 64 x 64, a block
//     128 rows x 256 B rows (gate / up: 128 columns of each; down: 256
//     columns), BK 64, 3 stages, 128 accumulators a thread;
//   * BM 64 (decode, a few dozen rows an expert): 8 warps of 32 x 64, a
//     block 64 rows x 256 B rows, BK 64, 4 stages: a block streams 256
//     weight rows of the expert once, and the wide B tile halves the
//     re-reads of the gathered rows against 128.
// Chosen among 15 tile shapes at the LM cell's shapes on the H100 (BK 32 or
// 64, 2-6 stages, 4-16 warps, 32-256 rows, 128-256 B rows): 19.5 ms a
// prefill layer (~310 TFLOP/s; the shapes tried read 19.4-26.6), 0.47 ms a
// decode layer (0.47-0.97), the two kernels alone.
// fp32 inputs keep full fp32 products on the CUDA cores (no TF32): tiles of
// 64 rows x 64 B rows, 4 x 4 outputs a thread, sums in ascending k.

#include "attention_tiles.cuh"

namespace {

using namespace mpr_tiles;

struct MoeArgs {
  const void* a;            // gate / up: h (N, K); down: act (places, K)
  const void* w;            // gate / up: (E, 2 n_out, K); down: (E, n_out, K)
  const int* rows;          // (tiles * BM,) the (token, slot) row of a place
  const int* tile_expert;   // (tiles,)
  const float* weight;      // down: (M,) routing weight of each row
  void* out;                // gate / up: act (places, n_out), input dtype;
                            // down: (M, n_out) fp32
  int M, K, n_out, top_k;
};

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

// The A row a place reads: a gathered token row of h (gate / up; a pad reads
// token 0, whose products land in no stored row of down) or the place's own
// row of act (down).
template <bool GATED>
__device__ __forceinline__ int64_t a_row(const MoeArgs& p, int64_t place) {
  if (!GATED) return place;
  const int row = p.rows[place];
  return row < p.M ? row / p.top_k : 0;
}

// The weight row of B row r (of NB) in a block whose first output column is
// n0: gate / up take the gate rows of the block's NB / 2 columns, then their
// up rows (n_out further on); down takes NB columns. Columns past n_out read
// the last one (never stored).
template <bool GATED, int NB>
__device__ __forceinline__ int64_t b_row(int r, int n0, int n_out) {
  if (GATED) {
    const int up = r >= NB / 2;
    const int col = min(n0 + r - up * (NB / 2), n_out - 1);
    return col + up * int64_t(n_out);
  }
  return min(n0 + r, n_out - 1);
}

template <int BM, int NB, int BK, int WM, int WN, int STAGES>
constexpr size_t mma_smem() {
  return sizeof(bf16) * STAGES * (BM + NB) * (BK + 8);
}

// The bf16 kernel (module comment). A warp holds WM-th of the block's rows
// against two groups of B rows: group 0 the warp's share of the first NB / 2
// B rows, group 1 the same share of the last NB / 2 (gate / up: the gate and
// the up rows of the same columns; down: two column ranges).
template <int BM, int NB, int BK, int WM, int WN, int STAGES, bool GATED>
__global__ void __launch_bounds__(WM * WN * 32, 1)
moe_mma_kernel(MoeArgs p) {
  constexpr int kThreads = WM * WN * 32;
  constexpr int LDS = BK + 8;  // padded row: ldmatrix rows on distinct banks
  constexpr int MI = BM / WM / 16;   // 16-row blocks of a warp
  constexpr int WC = NB / 2 / WN;    // B rows of a warp's group
  constexpr int NI = WC / 8;         // 8-column tiles of a group
  constexpr int CPR = BK / 8;        // 16-byte pieces of a staged row
  constexpr int A_PER = BM * CPR / kThreads;
  constexpr int B_PER = NB * CPR / kThreads;
  static_assert(NI % 2 == 0 && BK % 16 == 0, "tile shape");
  static_assert(BM * CPR % kThreads == 0 && NB * CPR % kThreads == 0,
                "staging split");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_a = reinterpret_cast<bf16*>(smem_raw);
  bf16* s_b = s_a + STAGES * BM * LDS;

  const int tile = blockIdx.y;
  const int e = p.tile_expert[tile];
  if (e < 0) return;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WN, wn = warp % WN;
  const int n0 = blockIdx.x * (GATED ? NB / 2 : NB);
  const int64_t place0 = int64_t(tile) * BM;
  const int K = p.K;
  const bf16* a = static_cast<const bf16*>(p.a);
  const bf16* w = static_cast<const bf16*>(p.w) +
                  int64_t(e) * (GATED ? 2 : 1) * p.n_out * K;

  // each thread's pieces of a stage, the same rows at every k step
  const bf16* a_src[A_PER];
  int a_dst[A_PER];
#pragma unroll
  for (int i = 0; i < A_PER; ++i) {
    const int c = tid + i * kThreads, r = c / CPR, col = (c % CPR) * 8;
    a_src[i] = a + a_row<GATED>(p, place0 + r) * K + col;
    a_dst[i] = r * LDS + col;
  }
  const bf16* b_src[B_PER];
  int b_dst[B_PER];
#pragma unroll
  for (int i = 0; i < B_PER; ++i) {
    const int c = tid + i * kThreads, r = c / CPR, col = (c % CPR) * 8;
    b_src[i] = w + b_row<GATED, NB>(r, n0, p.n_out) * K + col;
    b_dst[i] = r * LDS + col;
  }
  auto load_stage = [&](int slot, int kt) {
    bf16* sa = s_a + slot * BM * LDS;
    bf16* sb = s_b + slot * NB * LDS;
#pragma unroll
    for (int i = 0; i < A_PER; ++i)
      cp_async16(sa + a_dst[i], a_src[i] + kt * BK);
#pragma unroll
    for (int i = 0; i < B_PER; ++i)
      cp_async16(sb + b_dst[i], b_src[i] + kt * BK);
  };

  float acc[2][MI][NI][4];
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[g][mi][ni][j] = 0.f;

  const int KT = K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is free again
    if (kt + STAGES - 1 < KT)
      load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const bf16* sa = s_a + (kt % STAGES) * BM * LDS;
    const bf16* sb = s_b + (kt % STAGES) * NB * LDS;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldmatrix_x4(af[mi], sa + (wm * MI * 16 + mi * 16 + (lane & 15)) * LDS +
                                kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int g = 0; g < 2; ++g)
#pragma unroll
        for (int nj = 0; nj < NI / 2; ++nj) {
          uint32_t b[4];
          const int r0 = g * (NB / 2) + wn * WC + nj * 16;
          ldmatrix_x4(b, sb + (r0 + ((lane >> 4) << 3) + (lane & 7)) * LDS +
                             kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            mma_bf16(acc[g][mi][2 * nj], af[mi], b[0], b[1]);
            mma_bf16(acc[g][mi][2 * nj + 1], af[mi], b[2], b[3]);
          }
        }
    }
  }
  cp_async_wait<0>();

  // a lane holds rows g and g + 8 of each 16-row block at columns 2t, 2t + 1
  const int g8 = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t place = place0 + wm * MI * 16 + mi * 16 + g8 + half * 8;
      if (GATED) {
        bf16* act = static_cast<bf16*>(p.out) + place * p.n_out;
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const int n = n0 + wn * WC + ni * 8 + 2 * t;
          if (n >= p.n_out) continue;
          *reinterpret_cast<__nv_bfloat162*>(act + n) = __floats2bfloat162_rn(
              silu(acc[0][mi][ni][2 * half]) * acc[1][mi][ni][2 * half],
              silu(acc[0][mi][ni][2 * half + 1]) *
                  acc[1][mi][ni][2 * half + 1]);
        }
      } else {
        const int row = p.rows[place];
        if (row >= p.M) continue;
        const float wt = p.weight[row];
        float* out = static_cast<float*>(p.out) + int64_t(row) * p.n_out;
#pragma unroll
        for (int g = 0; g < 2; ++g)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) {
            const int n = n0 + g * (NB / 2) + wn * WC + ni * 8 + 2 * t;
            if (n >= p.n_out) continue;
            *reinterpret_cast<float2*>(out + n) =
                make_float2(wt * acc[g][mi][ni][2 * half],
                            wt * acc[g][mi][ni][2 * half + 1]);
          }
      }
    }
}

// fp32 on the CUDA cores: a block 64 rows x 64 B rows (the two groups as
// the bf16 kernel's), BK 16, 256 threads of 4 rows x 2 columns of each
// group; the staged tiles transposed to [k][row] so a thread reads its 4
// rows as one float4.
constexpr int kF32BM = 64, kF32NB = 64, kF32BK = 16, kF32Threads = 256;

template <bool GATED>
__global__ void __launch_bounds__(kF32Threads) moe_f32_kernel(MoeArgs p) {
  __shared__ __align__(16) float s_a[kF32BK][kF32BM + 4];
  __shared__ __align__(16) float s_b[kF32BK][kF32NB + 4];
  const int tile = blockIdx.y;
  const int e = p.tile_expert[tile];
  if (e < 0) return;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n0 = blockIdx.x * (GATED ? kF32NB / 2 : kF32NB);
  const int64_t place0 = int64_t(tile) * kF32BM;
  const int K = p.K;
  const float* a = static_cast<const float*>(p.a);
  const float* w = static_cast<const float*>(p.w) +
                   int64_t(e) * (GATED ? 2 : 1) * p.n_out * K;
  // a thread stages one 4-wide piece of one row of each tile
  const int lr = tid / 4, lk = (tid % 4) * 4;
  const float* a_src = a + a_row<GATED>(p, place0 + lr) * K + lk;
  const float* b_src = w + b_row<GATED, kF32NB>(lr, n0, p.n_out) * K + lk;

  float acc[4][4] = {};  // rows ty*4 + i; columns 2tx, 2tx+1 of each group
  for (int k0 = 0; k0 < K; k0 += kF32BK) {
    const float4 av = *reinterpret_cast<const float4*>(a_src + k0);
    const float4 bv = *reinterpret_cast<const float4*>(b_src + k0);
    __syncthreads();
    s_a[lk][lr] = av.x;
    s_a[lk + 1][lr] = av.y;
    s_a[lk + 2][lr] = av.z;
    s_a[lk + 3][lr] = av.w;
    s_b[lk][lr] = bv.x;
    s_b[lk + 1][lr] = bv.y;
    s_b[lk + 2][lr] = bv.z;
    s_b[lk + 3][lr] = bv.w;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kF32BK; ++k) {
      const float4 ar = *reinterpret_cast<const float4*>(&s_a[k][ty * 4]);
      const float2 b0 = *reinterpret_cast<const float2*>(&s_b[k][2 * tx]);
      const float2 b1 =
          *reinterpret_cast<const float2*>(&s_b[k][kF32NB / 2 + 2 * tx]);
      const float av4[4] = {ar.x, ar.y, ar.z, ar.w};
      const float bv4[4] = {b0.x, b0.y, b1.x, b1.y};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av4[i], bv4[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t place = place0 + ty * 4 + i;
    if (GATED) {
      const int n = n0 + 2 * tx;
      if (n >= p.n_out) continue;
      float* act = static_cast<float*>(p.out) + place * p.n_out + n;
      act[0] = silu(acc[i][0]) * acc[i][2];
      act[1] = silu(acc[i][1]) * acc[i][3];
    } else {
      const int row = p.rows[place];
      if (row >= p.M) continue;
      const float wt = p.weight[row];
      float* out = static_cast<float*>(p.out) + int64_t(row) * p.n_out;
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int n = n0 + g * (kF32NB / 2) + 2 * tx;
        if (n >= p.n_out) continue;
        out[n] = wt * acc[i][2 * g];
        out[n + 1] = wt * acc[i][2 * g + 1];
      }
    }
  }
}

template <int BM, int NB, int BK, int WM, int WN, int STAGES, bool GATED>
cudaError_t launch_mma(const MoeArgs& p, int n_tiles, cudaStream_t stream) {
  auto kernel = moe_mma_kernel<BM, NB, BK, WM, WN, STAGES, GATED>;
  constexpr size_t smem = mma_smem<BM, NB, BK, WM, WN, STAGES>();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int cols = GATED ? NB / 2 : NB;
  dim3 grid((p.n_out + cols - 1) / cols, n_tiles);
  kernel<<<grid, WM * WN * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool GATED>
cudaError_t launch_f32(const MoeArgs& p, int n_tiles, cudaStream_t stream) {
  const int cols = GATED ? kF32NB / 2 : kF32NB;
  dim3 grid((p.n_out + cols - 1) / cols, n_tiles);
  moe_f32_kernel<GATED><<<grid, kF32Threads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// h (N, d); gate_up (E, 2 I, d) = [gate; up]; down (E, d, I); rows
// (n_tiles * block_m,) and tile_expert (n_tiles,) int32 from tile_rows;
// weight (N top_k,) fp32; act (n_tiles * block_m, I) in the input dtype
// (scratch); out (N top_k, d) fp32, the weighted expert output of each
// (token, slot) row. dtype: 0 = float32 (block_m 64), 1 = bfloat16
// (block_m 128 or 64). d and I multiples of 64; every pointer 16-byte
// aligned.
int mpr_moe_experts(const void* h, const void* gate_up, const void* down,
                    const int* rows, const int* tile_expert,
                    const float* weight, void* act, void* out, int N,
                    int top_k, int d, int inter, int n_tiles, int block_m,
                    int dtype, void* stream) {
  if (N < 1 || top_k < 1 || d < 64 || inter < 64 || d % 64 || inter % 64 ||
      n_tiles < 1 || n_tiles > 65535)
    return cudaErrorInvalidValue;
  if (!(aligned16(h) && aligned16(gate_up) && aligned16(down) &&
        aligned16(act) && aligned16(out)))
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = N * top_k;
  const MoeArgs up{h, gate_up, rows, tile_expert, weight, act, M, d, inter,
                   top_k};
  const MoeArgs dn{act, down, rows, tile_expert, weight, out, M, inter, d,
                   top_k};
  cudaError_t err;
  if (dtype == 0) {
    if (block_m != kF32BM) return cudaErrorInvalidValue;
    err = launch_f32<true>(up, n_tiles, s);
    if (err == cudaSuccess) err = launch_f32<false>(dn, n_tiles, s);
  } else if (block_m == 128) {
    err = launch_mma<128, 256, 64, 2, 4, 3, true>(up, n_tiles, s);
    if (err == cudaSuccess)
      err = launch_mma<128, 256, 64, 2, 4, 3, false>(dn, n_tiles, s);
  } else if (block_m == 64) {
    err = launch_mma<64, 256, 64, 2, 4, 4, true>(up, n_tiles, s);
    if (err == cudaSuccess)
      err = launch_mma<64, 256, 64, 2, 4, 4, false>(dn, n_tiles, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
