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
// past the last. The work is (tile, block of output columns) items; an
// item whose tile has no expert is skipped, so the grid is sized from the
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
// ~5,500 an expert) the products, ~6 TFLOP a layer (6.13 ms at 989 TFLOP/s);
// at a decode step (512 tokens, ~48 rows an expert) reading every expert's
// weights, 1.1 GB a layer. bf16: fp32 accumulators on the tensor cores.
//   * BM 128 (prefill, many rows an expert): Hopper's wgmma fed by TMA.
//     A persistent grid (one block an SM) walks the (tile, column block)
//     items; a block is three warpgroups. The producer keeps a ring of 4
//     stages full: the B rows (gate / up: the block's 128 gate rows and
//     its 128 up rows; down: 256 rows of W_down) as two TMA boxes of 128
//     rows x 64, 128-byte swizzled, behind an mbarrier a stage, and the A
//     tile of 128 rows x 64: down's rows of act by TMA; gate / up's token
//     rows of h by its 128 threads' cp.async, gathered through `rows`
//     straight into the swizzled layout (TMA cannot gather rows). Each of
//     the two consumer warpgroups (setmaxnreg: 224 registers against the
//     producer's 56) runs wgmma m64n256k16 on its 64 rows against the 256
//     B rows, 128 fp32 accumulators a thread, and hands a stage back once
//     the next stage's products are under way; while the consumers run an
//     item's epilogue, the producer loads the next item's stages. The A
//     tile by gathering, against a gather pass that writes the sorted rows
//     of h contiguously for TMA (1.43 GB more a layer, read and written):
//     at the LM cell's prefill (NVIDIA H100 80GB HBM3, 700 W) the two
//     kernels took 10.26-11.39 ms (median 10.76) against 10.80-11.79
//     (11.22), the pass itself 0.99 ms against the 0.24 ms that gate / up
//     gains by TMA, so the gather stays. The two kernels: 6.5 + 3.2 ms,
//     530-590 TFLOP/s, 54-60% of the bound (mma.sync's tiles of 128 x 256:
//     19.5 ms); without the epilogue they ran 4% faster, with half the B
//     bytes 0-5%.
//   The mma.sync and CUDA-core kernels below take one item a block, and a
//   block whose tile has no expert returns at once.
//   * BM 64 (decode, a few dozen rows an expert): mma.sync m16n8k16 with
//     the tile helpers of attention_tiles.cuh, the A and B tiles brought
//     by cp.async into padded shared rows through a ring of 4 stages; 8
//     warps of 32 x 64, a block 64 rows x 256 B rows, BK 64: a block
//     streams 256 weight rows of the expert once, and the wide B tile
//     halves the re-reads of the gathered rows against 128. Chosen among
//     15 tile shapes at the LM cell's decode shape (0.47 ms a layer, the
//     shapes tried 0.47-0.97, the two kernels alone).
// fp32 inputs keep full fp32 products on the CUDA cores (no TF32): tiles of
// 64 rows x 64 B rows, 4 x 4 outputs a thread, sums in ascending k.

#include <cuda.h>

#include <algorithm>

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

// ---------------------------------------------------------------------------
// BM 128 (prefill): wgmma fed by TMA, warp-specialised, persistent
// ---------------------------------------------------------------------------

constexpr int kWgBM = 128;    // rows of a tile (the layout's block_m)
constexpr int kWgBN = 256;    // B rows of a work item
constexpr int kWgBK = 64;     // k of a stage: one 128-byte swizzled row
constexpr int kWgStages = 4;  // ring of (A, B) stages
constexpr int kWgBox = 128;   // rows of one TMA box
constexpr int kWgATile = kWgBM * kWgBK * 2;  // bytes
constexpr int kWgBTile = kWgBN * kWgBK * 2;
constexpr int kWgStage = kWgATile + kWgBTile;
constexpr int kWgThreads = 3 * 128;  // consumer warpgroups 0, 1; producer 2
// the stages, a full and an empty barrier each, 1 KB to align the ring
constexpr size_t kWgSmem = kWgStages * kWgStage + 2 * kWgStages * 8 + 1024;

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// a (kWgBox rows x kWgBK) box at (k, row) of a 2-D tensor map
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row)
      : "memory");
}

__device__ __forceinline__ void cp_async16_to(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// the barrier's phase completes (one of its arrivals) once this thread's
// cp.async copies so far have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// A K-major operand of 128-byte rows, 128-byte swizzled, 8-row groups 1,024
// bytes apart (the layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B); the
// k step of 16 inside the row is + 32 bytes, + 2 in the address field
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// keep the compiler from moving accumulator reads and writes across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256, fp32) (+)= a (64 x 16) . b (256 x 16)^T, both from shared
// memory; scale_d 0 starts the sum
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "
      "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, "
      "%99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, "
      "%121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

// A: the tile's rows of act (down), or of h gathered through `rows` by the
// producer warpgroup's cp.async into the swizzled layout (gate / up; TMA
// cannot gather rows). B: two boxes of the expert's rows (gate / up: the
// block's 128 gate rows, then its 128 up rows; down: 256 rows of W_down).
// Each consumer warpgroup multiplies its 64 rows by the 256 B rows; the
// block walks the (tile, column block) items with a stride of the grid.
template <bool GATED>
__global__ void __launch_bounds__(kWgThreads, 1)
moe_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                 const __grid_constant__ CUtensorMap b_map, MoeArgs p,
                 int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = ring + kWgStages * kWgStage;
  const uint32_t empty = full + kWgStages * 8;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      // full: the TMA boxes' bytes and, gate / up, the 128 producer
      // threads' gathered copies; empty: one arrival a consumer warpgroup
      mbar_init(full + 8 * s, GATED ? 1 + 128 : 1);
      mbar_init(empty + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int cols = GATED ? kWgBN / 2 : kWgBN;  // output columns of an item
  const int n_cb = (p.n_out + cols - 1) / cols;
  const int items = n_tiles * n_cb;
  const int KT = p.K / kWgBK;

  if (tid >= 256) {
    // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int pt = tid - 256;
    if (!GATED && pt != 0) return;
    // gathering: this thread copies 16-byte piece `chunk` of the rows
    // r0 + 16 i, i < 8; (r0 + 16 i) % 8 = r0 % 8, so one swizzled column
    const int chunk = pt & 7, r0 = pt >> 3;
    const uint32_t a_off = r0 * 128 + ((chunk ^ (r0 & 7)) << 4);
    const bf16* a = static_cast<const bf16*>(p.a);
    int stage = 0, phase = 0;
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      const int tile = w / n_cb, e = p.tile_expert[tile];
      if (e < 0) continue;
      const int n0 = (w % n_cb) * cols;
      const int b0 = GATED ? e * 2 * p.n_out + n0 : e * p.n_out + n0;
      const int b1 = GATED ? b0 + p.n_out : b0 + kWgBox;
      const bf16* src[8];
      if (GATED) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          src[i] = a + a_row<true>(p, int64_t(tile) * kWgBM + r0 + 16 * i) *
                           p.K + chunk * 8;
      }
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const uint32_t sa = ring + stage * kWgStage, sb = sa + kWgATile;
        const uint32_t bar = full + 8 * stage;
        if (pt == 0) {
          mbar_expect_tx(bar, GATED ? kWgBTile : kWgStage);
          if (!GATED) tma_load(sa, &a_map, bar, kt * kWgBK, tile * kWgBM);
          tma_load(sb, &b_map, bar, kt * kWgBK, b0);
          tma_load(sb + kWgBTile / 2, &b_map, bar, kt * kWgBK, b1);
        }
        if (GATED) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            cp_async16_to(sa + a_off + i * 16 * 128, src[i] + kt * kWgBK);
          cp_async_arrive(bar);
        }
        if (++stage == kWgStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // consumer warpgroups: rows wg * 64 + [0, 64) of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int wg = tid / 128, warp = (tid / 32) & 3, lane = tid & 31;
    int stage = 0, phase = 0;
    const int r = wg * 64 + warp * 16 + (lane >> 2), c = 2 * (lane & 3);
    float acc[128] = {};
    // an item's expert is read one item ahead and down's rows at the item's
    // start, so that their loads wait behind a k loop, not before one
    int e = blockIdx.x < items ? p.tile_expert[blockIdx.x / n_cb] : -1;
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      const int w_next = w + gridDim.x;
      const bool idle = e < 0;
      e = w_next < items ? p.tile_expert[w_next / n_cb] : -1;
      if (idle) continue;
      const int tile = w / n_cb, n0 = (w % n_cb) * cols;
      int row[2] = {0, 0};
      if (!GATED) {
#pragma unroll
        for (int half = 0; half < 2; ++half)
          row[half] = p.rows[int64_t(tile) * kWgBM + r + 8 * half];
      }
      int prev = 0;
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(full + 8 * stage, phase);
        // the gathered rows were written by the generic proxy
        if (GATED)
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        const uint32_t sa = ring + stage * kWgStage;
        const uint64_t da = smem_desc(sa + wg * (kWgATile / 2));
        const uint64_t db = smem_desc(sa + kWgATile);
        fence_acc(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < kWgBK / 16; ++kk)
          wgmma_256(acc, da + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        fence_acc(acc);
        // the previous stage's products are done: hand its tiles back
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (kt > 0 && (tid & 127) == 0) mbar_arrive(empty + 8 * prev);
        prev = stage;
        if (++stage == kWgStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      // down's weights, read while the last products run
      float wt[2] = {0.f, 0.f};
      if (!GATED) {
#pragma unroll
        for (int half = 0; half < 2; ++half)
          wt[half] = p.weight[min(row[half], p.M - 1)];
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
      if ((tid & 127) == 0) mbar_arrive(empty + 8 * prev);

      // a lane holds rows r = lane / 4 and r + 8 of its warp's 16 at
      // columns 8 j + c + {0, 1}: acc[4 j + 2 half + {0, 1}]
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int64_t place = int64_t(tile) * kWgBM + r + 8 * half;
        if (GATED) {
          // gate columns j < 16, the same columns' up j + 16
          bf16* act = static_cast<bf16*>(p.out) + place * p.n_out;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int n = n0 + 8 * j + c;
            if (n >= p.n_out) continue;
            const int g = 4 * j + 2 * half, u = g + 64;
            *reinterpret_cast<__nv_bfloat162*>(act + n) =
                __floats2bfloat162_rn(silu(acc[g]) * acc[u],
                                      silu(acc[g + 1]) * acc[u + 1]);
          }
        } else {
          if (row[half] >= p.M) continue;
          float* out =
              static_cast<float*>(p.out) + int64_t(row[half]) * p.n_out;
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int n = n0 + 8 * j + c;
            if (n >= p.n_out) continue;
            *reinterpret_cast<float2*>(out + n) =
                make_float2(wt[half] * acc[4 * j + 2 * half],
                            wt[half] * acc[4 * j + 2 * half + 1]);
          }
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link
// against libcuda; cudaGetDriverEntryPointByVersion needs a CUDA 12.5 or
// later toolkit)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      return EncodeTiled(nullptr);
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f)
                                            : EncodeTiled(nullptr);
  }();
  return fn;
}

// (rows, cols) bf16, row-major: boxes of kWgBox rows x kWgBK, 128-byte
// swizzled
cudaError_t box_map(CUtensorMap* map, const void* ptr, int64_t rows,
                    int cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dim[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t stride[1] = {cuuint64_t(cols) * sizeof(bf16)};
  const cuuint32_t box[2] = {kWgBK, kWgBox}, step[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dim,
      stride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// b: the experts' weights as (b_rows, p.K); a persistent grid of one
// block an SM, or fewer where there are fewer items
template <bool GATED>
cudaError_t launch_wgmma(const MoeArgs& p, const void* b, int64_t b_rows,
                         int n_tiles, cudaStream_t stream) {
  CUtensorMap a_map{}, b_map{};
  cudaError_t err = box_map(&b_map, b, b_rows, p.K);
  if (err == cudaSuccess && !GATED)
    err = box_map(&a_map, p.a, int64_t(n_tiles) * kWgBM, p.K);
  if (err != cudaSuccess) return err;
  auto kernel = moe_wgmma_kernel<GATED>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kWgSmem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const int cols = GATED ? kWgBN / 2 : kWgBN;
  const int items = n_tiles * ((p.n_out + cols - 1) / cols);
  kernel<<<std::min(items, sms), kWgThreads, kWgSmem, stream>>>(
      a_map, b_map, p, n_tiles);
  return cudaGetLastError();
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
// aligned. n_tiles is tile_rows' ceil(N top_k / block_m) + E: block_m 128
// reads the expert count E from it, to bound the weights' tensor maps.
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
  } else if (block_m == kWgBM) {
    // tile_rows' tiles: ceil(M / block_m) + E
    const int E = n_tiles - (M + kWgBM - 1) / kWgBM;
    if (E < 1) return cudaErrorInvalidValue;
    err = launch_wgmma<true>(up, gate_up, int64_t(E) * 2 * inter, n_tiles, s);
    if (err == cudaSuccess)
      err = launch_wgmma<false>(dn, down, int64_t(E) * d, n_tiles, s);
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
