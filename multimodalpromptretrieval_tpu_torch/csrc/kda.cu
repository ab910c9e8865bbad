// Kimi Delta Attention (KDA): the chunked prefill (K12) and the fused decode
// step (K13), for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no linear attention. The port
// added them for the Kimi-Linear language model (models/moe_lm.py), whose KDA
// layers carry, per row and head, a (K x V) = (128 x 128) fp32 state S
// through a gated delta rule with a decay for each key channel:
//     S_t = (I - beta_t k_t k_t^T) Diag(alpha_t) S_{t-1} + beta_t k_t v_t^T
//     o_t = S_t^T q_t * scale,        alpha_t = exp(g_t) in (0, 1]^K
// with q_t and k_t L2-normalised (eps 1e-6) inside the kernels. A step whose
// token is not valid (a pad) is the identity (beta 0, g 0). The plain
// PyTorch versions are kda_prefill_reference and kda_decode_reference
// (ops/kda.py).
//
// K13, the decode step (kda_decode_kernel): what bounds it is the state, read
// and written once a step (128 KB a row and head, against ~1.3 KB of q, k,
// v, g, beta in and o out, and 4 operations a state element: bytes). A block
// takes one (row, head) with 256 threads: warp w holds rows 16w .. 16w + 15
// of S, lane l the four columns 4l .. 4l + 3, 64 values in registers, read
// and written as 16-byte vectors (a warp's row of 512 bytes at a time). The
// block decays S, forms k^T S and the delta u = beta (v - S^T k) (partial
// sums over the warps' rows, added in shared memory), adds k u^T, forms
// S^T q the same way, and writes S back in place.
//
// K12, the prefill (kda_prefill_kernel): a block takes one (row, head) and
// walks its tokens in chunks of 64 from a zero state, the state in shared
// memory across them; q, k and v come in before the layer's short causal
// convolution, which it applies (with SiLU) as it loads a chunk's rows.
// In a chunk, with Gamma_r = prod_{t <= r} alpha_t (per channel, from the
// chunk's start) and S0 the state entering it, the delta rule's WY / UT form:
//     A[r][j] = beta_r sum_c k_r[c] k_j[c] exp(G_r[c] - G_j[c])   (j < r)
//     P[r][j] =        sum_c q_r[c] k_j[c] exp(G_r[c] - G_j[c])   (j <= r)
//     (I + A) U = Diag(beta) (V - (Gamma . K) S0)
//     O = scale ((Gamma . Q) S0 + P U)
//     S = Diag(Gamma_last) S0 + (Gamma_last / Gamma . K)^T U
// The pairwise decays are running products of alpha down each column of A
// and P (no exponent of a difference, which could overflow: every factor is
// at most 1), a warp four columns, a lane four channels. The triangular
// system is solved by forward substitution, four threads a value column.
// The four products with S0, U and the chunk's rows run on the tensor cores
// (wmma, TF32 operands, fp32 accumulators; S itself only ever passes
// through fp32). What bounds it is the chunk form's arithmetic (about 0.5 M
// products a token and head, two thirds of it on the tensor cores) and the
// sequential substitution; one block of 512 threads an SM (224 KB of shared
// memory).

#include <mma.h>

#include "attention_tiles.cuh"

namespace {

using namespace mpr_tiles;
using namespace nvcuda;

constexpr int kD = 128;   // key and value width a kernel takes
constexpr int kChunk = 64;
constexpr int kConvMax = 4;  // taps of the fused short convolution, at most
constexpr float kNormEps = 1e-6f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// ---------------------------------------------------------------------------
// K13: one decode step
// ---------------------------------------------------------------------------

constexpr int kDecodeThreads = 256;  // 8 warps x 16 state rows

struct DecodeArgs {
  const void* q;       // (B, H, K)
  const void* k;       // (B, H, K)
  const void* v;       // (B, H, V)
  const float* g;      // (B, H, K) log-decay
  const float* beta;   // (B, H)
  float* state;        // (B, H, K, V), in place
  void* out;           // (B, H, V)
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(kDecodeThreads)
kda_decode_kernel(DecodeArgs p) {
  __shared__ float s_q[kD], s_k[kD], s_a[kD], s_u[kD];
  __shared__ float s_red[kDecodeThreads / 32][kD];
  __shared__ float s_norm[2][4];
  const int64_t bh = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* q = static_cast<const T*>(p.q) + bh * kD;
  const T* k = static_cast<const T*>(p.k) + bh * kD;
  const T* v = static_cast<const T*>(p.v) + bh * kD;
  float qi = 0.f, ki = 0.f;
  if (tid < kD) {
    qi = to_f(q[tid]);
    ki = to_f(k[tid]);
    s_a[tid] = expf(p.g[bh * kD + tid]);
    const float sq = warp_sum(qi * qi), sk = warp_sum(ki * ki);
    if (lane == 0) {
      s_norm[0][warp] = sq;
      s_norm[1][warp] = sk;
    }
  }
  __syncthreads();
  if (tid < kD) {
    const float sq = s_norm[0][0] + s_norm[0][1] + s_norm[0][2] + s_norm[0][3];
    const float sk = s_norm[1][0] + s_norm[1][1] + s_norm[1][2] + s_norm[1][3];
    s_q[tid] = qi * rsqrtf(sq + kNormEps) * p.scale;
    s_k[tid] = ki * rsqrtf(sk + kNormEps);
  }
  __syncthreads();

  float4* S = reinterpret_cast<float4*>(p.state + bh * kD * kD);
  const int r0 = warp * 16;
  float4 s[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = S[(r0 + i) * (kD / 4) + lane];
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float a = s_a[r0 + i], kc = s_k[r0 + i];
    s[i].x *= a; s[i].y *= a; s[i].z *= a; s[i].w *= a;
    acc.x = fmaf(kc, s[i].x, acc.x); acc.y = fmaf(kc, s[i].y, acc.y);
    acc.z = fmaf(kc, s[i].z, acc.z); acc.w = fmaf(kc, s[i].w, acc.w);
  }
  reinterpret_cast<float4*>(s_red[warp])[lane] = acc;
  __syncthreads();
  if (tid < kD) {
    float kv = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeThreads / 32; ++w) kv += s_red[w][tid];
    s_u[tid] = p.beta[bh] * (to_f(v[tid]) - kv);
  }
  __syncthreads();
  const float4 u = reinterpret_cast<const float4*>(s_u)[lane];
  acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float kc = s_k[r0 + i], qc = s_q[r0 + i];
    s[i].x = fmaf(kc, u.x, s[i].x); s[i].y = fmaf(kc, u.y, s[i].y);
    s[i].z = fmaf(kc, u.z, s[i].z); s[i].w = fmaf(kc, u.w, s[i].w);
    acc.x = fmaf(qc, s[i].x, acc.x); acc.y = fmaf(qc, s[i].y, acc.y);
    acc.z = fmaf(qc, s[i].z, acc.z); acc.w = fmaf(qc, s[i].w, acc.w);
    S[(r0 + i) * (kD / 4) + lane] = s[i];
  }
  reinterpret_cast<float4*>(s_red[warp])[lane] = acc;
  __syncthreads();
  if (tid < kD) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeThreads / 32; ++w) o += s_red[w][tid];
    static_cast<T*>(p.out)[bh * kD + tid] = from_f<T>(o);
  }
}

// ---------------------------------------------------------------------------
// K12: the chunked prefill
// ---------------------------------------------------------------------------

constexpr int kPrefillThreads = 512;
constexpr int kPrefillWarps = kPrefillThreads / 32;
// shared memory, in floats: S, then the chunk's K, X (q, then the scaled
// keys), V (then U), alpha, A, P, beta
constexpr int kOffK = kD * kD;
constexpr int kOffX = kOffK + kChunk * kD;
constexpr int kOffV = kOffX + kChunk * kD;
constexpr int kOffAlpha = kOffV + kChunk * kD;
constexpr int kOffA = kOffAlpha + kChunk * kD;
constexpr int kOffP = kOffA + kChunk * kChunk;
constexpr int kOffBeta = kOffP + kChunk * kChunk;
constexpr int kPrefillSmemFloats = kOffBeta + kChunk;
static_assert(kPrefillSmemFloats * 4 <= 232448, "shared memory of a block");

struct PrefillArgs {
  const void* q;        // (B, L, H, K) through (batch, token) strides
  const void* k;
  const void* v;
  const float* g;       // (B, L, H, K) contiguous
  const float* beta;    // (B, L, H) contiguous
  const int8_t* valid;  // (B, L) contiguous
  float* state;         // (B, H, K, V) contiguous, in place
  void* out;            // (B, L, H, V) contiguous
  const void* taps;     // (3 H K, W)
  int64_t sq_b, sq_t, sk_b, sk_t, sv_b, sv_t;
  int H, L, W;
  float scale;
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32,
                             wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 8,
                              wmma::precision::tf32, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32,
                             wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;

template <typename F>
__device__ __forceinline__ void to_tf32(F& f) {
#pragma unroll
  for (int i = 0; i < f.num_elements; ++i) f.x[i] = wmma::__float_to_tf32(f.x[i]);
}

// acc += X[m0 .. m0 + 16, 0 .. 128) . S[0 .. 128, n0 .. n0 + 16)
__device__ __forceinline__ void rows_times_state(FragC& acc, const float* X,
                                                 const float* S, int m0,
                                                 int n0) {
  FragA a;
  FragB b;
#pragma unroll 4
  for (int c = 0; c < kD; c += 8) {
    wmma::load_matrix_sync(a, X + m0 * kD + c, kD);
    wmma::load_matrix_sync(b, S + c * kD + n0, kD);
    to_tf32(a);
    to_tf32(b);
    wmma::mma_sync(acc, a, b, acc);
  }
}

// One of q / k / v at rows r0 .. r0 + 3 of the chunk from t0, channels
// lane + 32 i from ch of base's rows (tap_ch of the taps'): SiLU of the
// causal convolution of W taps (the oldest first) over the
// pre-convolution inputs, zeros before token 0, at pads and past L.
template <typename T>
__device__ __forceinline__ void load_rows(float (&x)[4][4], const T* base,
                                          int64_t s_t, const int8_t* valid,
                                          const T* taps, int W, int L,
                                          int t0, int r0, int ch, int tap_ch,
                                          int lane) {
  constexpr int kHist = kConvMax - 1;
  float pre[4 + kHist][4];
#pragma unroll
  for (int m = 0; m < 4 + kHist; ++m) {
    const int t = t0 + r0 - kHist + m;
    const bool ok = t >= 0 && t < L && valid[t] != 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pre[m][i] = ok ? to_f(base[t * s_t + ch + lane + 32 * i]) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float w[kConvMax];
#pragma unroll
    for (int u = 0; u < kConvMax; ++u) {
      // tap u of W multiplies row r - (W - 1) + u: slot u + kConvMax - W
      const int at = u - (kConvMax - W);
      w[u] = at >= 0 ? to_f(taps[int64_t(tap_ch + lane + 32 * i) * W + at])
                     : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int u = 0; u < kConvMax; ++u) acc = fmaf(w[u], pre[j + u][i], acc);
      x[j][i] = acc / (1.f + expf(-acc));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kPrefillThreads, 1)
kda_prefill_kernel(PrefillArgs p) {
  extern __shared__ __align__(128) float sm[];
  float* S = sm;
  float* Kn = sm + kOffK;
  float* X = sm + kOffX;
  float* Vb = sm + kOffV;
  float* Al = sm + kOffAlpha;
  float* Am = sm + kOffA;
  float* Pm = sm + kOffP;
  float* Be = sm + kOffBeta;

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float4* Sg = reinterpret_cast<float4*>(p.state +
                                         int64_t(blockIdx.x) * kD * kD);
  for (int i = tid; i < kD * kD / 4; i += kPrefillThreads)
    reinterpret_cast<float4*>(S)[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t0 = 0; t0 < p.L; t0 += kChunk) {
    const int n = min(kChunk, p.L - t0);
    // -- the chunk's rows: L2-normalised q and k, v, alpha, beta; identity
    //    rows (pads and rows past the end) all zero but alpha 1. A warp
    //    takes rows 4 warp .. 4 warp + 3, a lane the channels lane + 32 i
    for (int i = tid; i < 2 * kChunk * kChunk; i += kPrefillThreads)
      Am[i] = 0.f;  // A, then P
    {
      const int r0 = warp * 4;
      const int8_t* valid = p.valid + int64_t(b) * p.L;
      bool ok[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ok[j] = r0 + j < n && valid[t0 + r0 + j] != 0;
      float x[4][4];
#pragma unroll
      for (int part = 0; part < 3; ++part) {
        const T* base = static_cast<const T*>(
            part == 0 ? p.q : part == 1 ? p.k : p.v) +
            b * (part == 0 ? p.sq_b : part == 1 ? p.sk_b : p.sv_b);
        const int64_t s_t = part == 0 ? p.sq_t : part == 1 ? p.sk_t : p.sv_t;
        load_rows<T>(x, base, s_t, valid, static_cast<const T*>(p.taps),
                     p.W, p.L, t0, r0, h * kD, (part * p.H + h) * kD, lane);
        float* dst = part == 0 ? X : part == 1 ? Kn : Vb;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float norm = 1.f;
          if (part < 2) {
            float ss = 0.f;
#pragma unroll
            for (int i = 0; i < 4; ++i) ss += x[j][i] * x[j][i];
            norm = rsqrtf(warp_sum(ss) + kNormEps);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
            dst[(r0 + j) * kD + lane + 32 * i] = ok[j] ? x[j][i] * norm : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t at = (int64_t(b) * p.L + t0 + r0 + j) * p.H + h;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          Al[(r0 + j) * kD + lane + 32 * i] =
              ok[j] ? expf(p.g[at * kD + lane + 32 * i]) : 1.f;
        if (lane == 0) Be[r0 + j] = ok[j] ? p.beta[at] : 0.f;
      }
    }
    __syncthreads();

    // -- A and P: a warp takes the columns j = warp + 16 m, a lane the
    //    channels lane + 32 i; the decays run down each column as products
    {
      float kj[4][4], e[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = warp + kPrefillWarps * m;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kj[m][i] = Kn[j * kD + lane + 32 * i];
          e[m][i] = 1.f;
        }
      }
      for (int r = warp; r < kChunk; ++r) {
        float kr[4], qr[4], ar[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = lane + 32 * i;
          kr[i] = Kn[r * kD + c];
          qr[i] = X[r * kD + c];
          ar[i] = Al[r * kD + c];
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int j = warp + kPrefillWarps * m;
          if (j > r) break;  // columns past r start further down
          float da = 0.f, dp = 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (j < r) e[m][i] *= ar[i];
            const float w = kj[m][i] * e[m][i];
            da = fmaf(kr[i], w, da);
            dp = fmaf(qr[i], w, dp);
          }
          da = warp_sum(da);
          dp = warp_sum(dp);
          if (lane == 0) {
            if (j < r) Am[r * kChunk + j] = Be[r] * da;
            Pm[r * kChunk + j] = dp;
          }
        }
      }
    }
    __syncthreads();

    // -- X = Gamma . q (in place), then O = X S0 (a warp's two 16 x 16
    //    tiles stay in registers); V = beta . v
    if (tid < kD) {
      float run = 1.f;
      for (int r = 0; r < kChunk; ++r) {
        run *= Al[r * kD + tid];
        X[r * kD + tid] *= run;
      }
    } else if (tid < 2 * kD) {
      const int c = tid - kD;
      for (int r = 0; r < kChunk; ++r) Vb[r * kD + c] *= Be[r];
    }
    __syncthreads();
    FragC o[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int tile = warp * 2 + i;  // 4 x 8 tiles of (64, 128)
      wmma::fill_fragment(o[i], 0.f);
      rows_times_state(o[i], X, S, (tile / 8) * 16, (tile % 8) * 16);
    }
    __syncthreads();

    // -- X = beta Gamma . k; V = beta v - X S0 (the right-hand side)
    if (tid < kD) {
      float run = 1.f;
      for (int r = 0; r < kChunk; ++r) {
        run *= Al[r * kD + tid];
        X[r * kD + tid] = Kn[r * kD + tid] * run * Be[r];
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int tile = warp * 2 + i;
      const int m0 = (tile / 8) * 16, n0 = (tile % 8) * 16;
      FragC ks, rhs;
      wmma::fill_fragment(ks, 0.f);
      rows_times_state(ks, X, S, m0, n0);
      wmma::load_matrix_sync(rhs, Vb + m0 * kD + n0, kD, wmma::mem_row_major);
#pragma unroll
      for (int e = 0; e < rhs.num_elements; ++e) rhs.x[e] -= ks.x[e];
      wmma::store_matrix_sync(Vb + m0 * kD + n0, rhs, kD, wmma::mem_row_major);
    }
    __syncthreads();

    // -- (I + A) U = V by forward substitution, in place: four threads a
    //    column (one warp holds all four), each a quarter of the sum
    {
      const int col = tid / 4, part = tid % 4;
      for (int r = 1; r < kChunk; ++r) {
        // four sums in flight, so the loads do not wait on each other
        float a4[4] = {0.f, 0.f, 0.f, 0.f};
        int j = part;
        for (; j + 12 < r; j += 16) {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            a4[u] = fmaf(Am[r * kChunk + j + 4 * u],
                         Vb[(j + 4 * u) * kD + col], a4[u]);
        }
        for (; j < r; j += 4)
          a4[0] = fmaf(Am[r * kChunk + j], Vb[j * kD + col], a4[0]);
        float acc = (a4[0] + a4[1]) + (a4[2] + a4[3]);
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        if (part == 0) Vb[r * kD + col] -= acc;
        __syncwarp();
      }
    }
    __syncthreads();

    // -- O += P U; written out (rows of this chunk only), through a warp's
    //    1 KB of the spent A
    {
      float* scratch = Am + warp * 256;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int tile = warp * 2 + i;
        const int m0 = (tile / 8) * 16, n0 = (tile % 8) * 16;
        FragA a;
        FragB bu;
#pragma unroll
        for (int c = 0; c < kChunk; c += 8) {
          wmma::load_matrix_sync(a, Pm + m0 * kChunk + c, kChunk);
          wmma::load_matrix_sync(bu, Vb + c * kD + n0, kD);
          to_tf32(a);
          to_tf32(bu);
          wmma::mma_sync(o[i], a, bu, o[i]);
        }
        wmma::store_matrix_sync(scratch, o[i], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = m0 + e / 16;
          if (r < n)
            static_cast<T*>(p.out)[((int64_t(b) * p.L + t0 + r) * p.H + h) *
                                       kD + n0 + e % 16] =
                from_f<T>(scratch[e] * p.scale);
        }
        __syncwarp();
      }
    }
    __syncthreads();

    // -- X = (Gamma_last / Gamma) . k; S rows decayed by Gamma_last
    if (tid < kD) {
      float run = 1.f;
      for (int r = kChunk - 1; r >= 0; --r) {
        X[r * kD + tid] = Kn[r * kD + tid] * run;
        run *= Al[r * kD + tid];
      }
      Kn[tid] = run;  // Gamma_last of channel tid (this column of K is spent)
    }
    __syncthreads();
    for (int i = tid; i < kD * kD; i += kPrefillThreads) S[i] *= Kn[i / kD];
    __syncthreads();

    // -- S += X^T U: a warp's four 16 x 16 tiles of the (128, 128) state
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tile = warp * 4 + i;
      const int m0 = (tile / 8) * 16, n0 = (tile % 8) * 16;
      FragC acc;
      FragAT a;
      FragB bu;
      wmma::load_matrix_sync(acc, S + m0 * kD + n0, kD, wmma::mem_row_major);
#pragma unroll
      for (int c = 0; c < kChunk; c += 8) {
        wmma::load_matrix_sync(a, X + c * kD + m0, kD);
        wmma::load_matrix_sync(bu, Vb + c * kD + n0, kD);
        to_tf32(a);
        to_tf32(bu);
        wmma::mma_sync(acc, a, bu, acc);
      }
      wmma::store_matrix_sync(S + m0 * kD + n0, acc, kD, wmma::mem_row_major);
    }
    __syncthreads();
  }
  for (int i = tid; i < kD * kD / 4; i += kPrefillThreads)
    Sg[i] = reinterpret_cast<const float4*>(S)[i];
}

}  // namespace

extern "C" {

// One KDA decode step, in place on state. q, k, v (B, H, 128), g (B, H, 128)
// fp32, beta (B, H) fp32, state (B, H, 128, 128) fp32, out (B, H, 128), all
// contiguous. dtype: 0 = float32 q / k / v / out, 1 = bfloat16.
int mpr_kda_decode(const void* q, const void* k, const void* v,
                   const float* g, const float* beta, float* state, void* out,
                   int B, int H, int K, int V, float scale, int dtype,
                   void* stream) {
  if (B < 1 || H < 1 || K != kD || V != kD) return cudaErrorInvalidValue;
  if (int64_t(B) * H > 2147483647) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DecodeArgs p{q, k, v, g, beta, state, out, scale};
  if (dtype == 0)
    kda_decode_kernel<float><<<B * H, kDecodeThreads, 0, s>>>(p);
  else
    kda_decode_kernel<bf16><<<B * H, kDecodeThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The KDA prefill over L tokens from a zero state, the final state written
// into state. q, k, v (B, L, H, 128) through (batch, token) strides (heads
// contiguous, 128 apart), taken through the short convolution of taps
// (3 H 128, W <= 4) and SiLU first (zeros before token 0 and at pads); g
// (B, L, H, 128) fp32, beta (B, L, H) fp32, valid (B, L) int8 (0: an
// identity step), state (B, H, 128, 128) fp32 (only written), out
// (B, L, H, 128), all contiguous. dtype as mpr_kda_decode.
int mpr_kda_prefill(const void* q, const void* k, const void* v,
                    const float* g, const float* beta, const int8_t* valid,
                    float* state, void* out, const void* taps,
                    int64_t sq_b, int64_t sq_t, int64_t sk_b, int64_t sk_t,
                    int64_t sv_b, int64_t sv_t, int B, int L, int H, int K,
                    int V, int W, float scale, int dtype, void* stream) {
  if (B < 1 || L < 1 || H < 1 || K != kD || V != kD || taps == nullptr ||
      W < 1 || W > kConvMax)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PrefillArgs p{q, k, v, g, beta, valid, state, out, taps, sq_b,
                      sq_t, sk_b, sk_t, sv_b, sv_t, H, L, W, scale};
  const int smem = kPrefillSmemFloats * 4;
  cudaError_t err;
  if (dtype == 0) {
    err = cudaFuncSetAttribute(kda_prefill_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kda_prefill_kernel<float><<<B * H, kPrefillThreads, smem, s>>>(p);
  } else {
    err = cudaFuncSetAttribute(kda_prefill_kernel<bf16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kda_prefill_kernel<bf16><<<B * H, kPrefillThreads, smem, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
