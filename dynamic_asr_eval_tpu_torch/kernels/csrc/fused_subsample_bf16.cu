// Fused x8 dw-striding subsampling stack in bf16, forward and backward, with
// every pointwise product on Hopper's tensor cores (sm_90a): the main path's
// route.  f32 input goes to the CUDA-core kernels of fused_subsample.cu.
//
// Replaces the JAX package's kernels/subsample.py: `fused_subsample`
// (:504-529), whose forward is the Pallas call `_fwd_pallas` (:278-300, body
// `_fwd_kernel` :239) and whose backward is `_bwd_pallas` (:438-485, body
// `_bwd_kernel` :333) under `_fused_bwd` (:532-566).
//
// What it computes.  x [B, T, F] bf16 (F % 8 == 0); weights f32 in the JAX
// layouts, packed into one buffer (`Pack`): k9, dw1, dw2 [9, C] with (dt, df)
// row-major, pw1, pw2 [C_in, C_out], biases [C]; C <= 256.  Every 3x3 conv has
// stride 2 and padding (1, 1); there are no masks between stages (the TPU
// kernel's semantics):
//   s0 = act(conv3x3(x; k9) + b0)                                [B, T0, F0, C]
//   d1 = dwconv3x3(s0; dw1) + bdw1;  s1 = act(d1 @ pw1 + bpw1)    [B, T1, F1, C]
//   d2 = dwconv3x3(s1; dw2) + bdw2;  out = act(d2 @ pw2 + bpw2)   [B, T2, F2, C]
// with T_{k+1} = ceil(T_k / 2), F0 = F/2, F1 = F/4, F2 = F/8.  Sums are f32,
// rounded to bf16 where `_tile_forward` (:201-231) rounds: after stage 0,
// after each depthwise conv, after each pointwise product and again after its
// bias, after each activation (run in f32); the depthwise and pointwise
// weights and biases are rounded to bf16 first, k9 and b0 stay f32.  Weight
// gradients come back in f32.  No atomics: two runs give the same bits.
//
// Bound on this card.  At the flagship window (B 2, T 16384, F 80, C 256) the
// forward is ~30.8 GFLOP, 26.8 of them in the two pointwise products, and
// must move ~26 MB: ~31 us at 989 TFLOP/s bf16, bound by operations.  The
// backward (no gx) is ~89 GFLOP (~90 us).
//
// Design.
// - `tc_pw_kernel`: one block owns up to 80 output positions (five m16
//   tiles: R whole rows of the stage's output grid, or 80 columns of one row
//   where a row is longer) and all C output channels, 16 warps of 16
//   channels each (32 warps an SM: the A-tile build is latency-bound).  It loops over the input channels in chunks of 32 (the K of the
//   product): builds the chunk's A tile [80 x 32] in bf16 in shared memory,
//   streams the chunk of the bf16 pointwise weights in through a cp.async
//   double buffer, and accumulates with mma.sync m16n8k16 (bf16 in, f32
//   sums), operands through ldmatrix from rows padded by 16 bytes (no bank
//   conflicts).  The A tile comes from
//   - SRC_X (stage 1): the block's x rows, loaded once; per chunk it computes
//     each s0 value its taps need once (2R+1 rows), then the depthwise conv;
//   - SRC_S (stage 2): the s1 rows it needs, by cp.async, double-buffered;
//   - SRC_LOAD (the input gradients gd = gz @ pw^T): a plain [M, CP] tensor;
//     the weights are then staged [n][k] by whole-row copies and the
//     transpose comes from ldmatrix (non-.trans for that operand).
//   The epilogue applies bias, the roundings and the activation (EPI_ACT), or
//   also keeps z (EPI_RECOMPUTE), or gives gz = g * act'(z) (EPI_GRAD).
// - The forward is three launches: pw1/pw2 to bf16 (padded [CP, CP], once a
//   call, so no block rounds f32 weights), x -> s1 (s1 stays in device
//   memory: 84 MB at the flagship, ~0.05 ms each way), s1 -> out.
// - The backward recomputes the forward (stage 1 keeping d1, z1 and s1;
//   stage 2 keeping d2 and giving gz2), then takes each product's input
//   gradient with SRC_LOAD and its weight gradient with `tc_wgrad_kernel`:
//   gW = A^T Gz over fixed position ranges, one 128 x 128 output tile a
//   block, A read with ldmatrix.trans, the bias gradient in the same pass,
//   f32 partials summed in order by `reduce_kernel`.  The depthwise and
//   stage-0 gradients (`dw_bwd_kernel`) stay on CUDA cores, one thread a
//   channel, reading the gradient rows (and for stage 0 the x rows, which
//   give z0 again) from shared-memory tiles.
// - Intermediates are [M, CP] bf16 with CP = C rounded up to 32 and zeros in
//   the padding channels, so that every tile copy is 16-byte aligned and C
//   need not be a multiple of 16.  Index math is 32-bit, derived per block or
//   per small loop; no per-element 64-bit division.
// wgmma, TMA and keeping s1 on chip are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int MAX_C = 256;
constexpr int THREADS = 256;
constexpr int PW_THREADS = 512;     // tc_pw_kernel: 16 warps of 16 output channels
constexpr int PW_WARPS = PW_THREADS / 32;
constexpr int NW = MAX_C / PW_WARPS;  // output channels a warp
constexpr int MT = 5;               // m16 tiles a tc_pw_kernel block
constexpr int BMP = 16 * MT;        // positions a tc_pw_kernel block
constexpr int KC = 32;              // input channels a chunk
constexpr int S0_PAIRS = 1;         // pairs of s0 values a lane computes side by side
constexpr int LDA = KC + 8;         // A tile row stride (elements; 16 bytes of padding)
constexpr int LDAF = MAX_C + 8;     // SRC_X: the whole A tile [80, CP] at once
constexpr int LDB = MAX_C + 8;      // K-major weight chunk [KC][n] row stride
constexpr int LDBT = KC + 8;        // N-major weight chunk [n][KC] row stride
constexpr int WG_TILE = 128;        // tc_wgrad_kernel output tile (k and n)
constexpr int WG_STEP = 32;         // positions a shared-memory step
constexpr int LDW = WG_TILE + 8;
constexpr int DW_RI = 8;            // input rows a dw_bwd_kernel group
constexpr int DW_FI = 40;           // input columns a dw_bwd_kernel block

enum Act { SILU = 0, RELU = 1, GELU = 2 };
enum Src { SRC_X = 0, SRC_S = 1, SRC_LOAD = 2 };
enum Epi { EPI_ACT = 0, EPI_RECOMPUTE = 1, EPI_GRAD = 2, EPI_PLAIN = 3 };

struct Dims {
  int B, T, F, C, CP;
  int T0, F0, T1, F1, T2, F2;
  long long M0, M1, M2;             // positions of s0, s1, out
};

Dims make_dims(int B, int T, int F, int C) {
  Dims d;
  d.B = B; d.T = T; d.F = F; d.C = C; d.CP = (C + KC - 1) / KC * KC;
  d.T0 = (T + 1) / 2; d.T1 = (d.T0 + 1) / 2; d.T2 = (d.T1 + 1) / 2;
  d.F0 = F / 2; d.F1 = F / 4; d.F2 = F / 8;
  d.M0 = (long long)B * d.T0 * d.F0;
  d.M1 = (long long)B * d.T1 * d.F1;
  d.M2 = (long long)B * d.T2 * d.F2;
  return d;
}

// Offsets (in floats) of the weights in the packed buffer, the order of
// `fused_subsample`'s arguments.
struct Pack {
  long long k9, b0, dw1, bdw1, pw1, bpw1, dw2, bdw2, pw2, bpw2, total;
};

Pack make_pack(int C) {
  const long long c = C, cc = (long long)C * C;
  Pack p;
  p.k9 = 0; p.b0 = 9 * c; p.dw1 = 10 * c; p.bdw1 = 19 * c; p.pw1 = 20 * c;
  p.bpw1 = 20 * c + cc; p.dw2 = 21 * c + cc; p.bdw2 = 30 * c + cc; p.pw2 = 31 * c + cc;
  p.bpw2 = 31 * c + 2 * cc; p.total = 32 * c + 2 * cc;
  return p;
}

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ bf16 to_bf(float x) { return __float2bfloat16(x); }
__device__ __forceinline__ float rnd(float x) { return to_f(to_bf(x)); }

constexpr float GELU_C = 0.7978845608028654f;  // sqrt(2 / pi)

// the logistic function by the special-function unit (__expf, __fdividef:
// a few f32 ulps, far below the bf16 rounding that follows)
__device__ __forceinline__ float sigmoid(float z) { return __fdividef(1.f, 1.f + __expf(-z)); }

__device__ __forceinline__ float act_f(int act, float z) {
  if (act == SILU) return z * sigmoid(z);
  if (act == RELU) return fmaxf(z, 0.f);
  // tanh approximation, as jax.nn.gelu's default
  return 0.5f * z * (1.f + tanhf(GELU_C * (z + 0.044715f * z * z * z)));
}

__device__ __forceinline__ float act_grad(int act, float z) {
  if (act == SILU) {
    const float s = sigmoid(z);
    return s * (1.f + z * (1.f - s));
  }
  if (act == RELU) return z > 0.f ? 1.f : 0.f;
  const float t = tanhf(GELU_C * (z + 0.044715f * z * z * z));
  return 0.5f * (1.f + t) + 0.5f * z * (1.f - t * t) * GELU_C * (1.f + 3.f * 0.044715f * z * z);
}

// f = act(z) and g = act'(z), sharing the logistic (SiLU) or tanh (GELU)
__device__ __forceinline__ void act_and_grad(int act, float z, float& f, float& g) {
  if (act == SILU) {
    const float s = sigmoid(z);
    f = z * s;
    g = s * (1.f + z * (1.f - s));
  } else if (act == RELU) {
    f = fmaxf(z, 0.f);
    g = z > 0.f ? 1.f : 0.f;
  } else {
    const float t = tanhf(GELU_C * (z + 0.044715f * z * z * z));
    f = 0.5f * z * (1.f + t);
    g = 0.5f * (1.f + t) + 0.5f * z * (1.f - t * t) * GELU_C * (1.f + 3.f * 0.044715f * z * z);
  }
}

// ---------------------------------------------------------------------------
// PTX: asynchronous copies, ldmatrix, mma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8x8 b16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// c[16x8] += a[16x16] . b[16x8], bf16 in, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// fragments
//
// mma.m16n8k16 layouts, lane = 4 g + t: an accumulator tile [16 x 8] holds
// (row g, cols 2t, 2t+1) in c[0], c[1] and (row g+8, same cols) in c[2],
// c[3]; an A operand [16 x 16] holds (row g | g+8, cols 2t, 2t+1 | 2t+8,
// 2t+9) as bf16 pairs a[0] = (g, lo), a[1] = (g+8, lo), a[2] = (g, hi),
// a[3] = (g+8, hi).
// ---------------------------------------------------------------------------

// A operand: rows [r0, r0+16) x cols [k0, k0+16) of a row-major tile
// (stride lds), with ldsm_x4; also the B operand of two n-tiles [n0, n0+16)
// when the tile is K-major ([k][n]) and read with ldsm_x4_trans: r[0], r[1]
// for n-tile n0, r[2], r[3] for n0+8
__device__ __forceinline__ const bf16* frag_a(const bf16* tile, int lds, int r0, int k0,
                                              int lane) {
  return tile + (r0 + (lane & 15)) * lds + k0 + (lane >> 4) * 8;
}

// B operand of two n-tiles [n0, n0+16) x k [k0, k0+16) from an N-major tile
// ([n][k], row-major) with ldsm_x4: r[0], r[1] for n-tile n0, r[2], r[3] for
// n0+8.  Read with ldsm_x4_trans from a tile stored [m][k] (row = the sum's
// index), the same addresses give the A operand of rows k [k0, k0+16) x
// m [n0, n0+16): the transposed tile.
__device__ __forceinline__ const bf16* frag_b(const bf16* tile, int lds, int n0, int k0,
                                              int lane) {
  return tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * lds + k0 + ((lane >> 3) & 1) * 8;
}

// ---------------------------------------------------------------------------
// pointwise products on the tensor cores
// ---------------------------------------------------------------------------

struct PwArgs {
  const bf16* x;       // SRC_X: [B, T, F]
  const bf16* src;     // SRC_S: s1 [M1, CP]; SRC_LOAD: A [M, CP]
  const float* k9;     // SRC_X: stage-0 weights [9, C] and bias [C]
  const float* b0;
  const float* dw;     // SRC_X, SRC_S: this stage's depthwise weights [9, C], bias [C]
  const float* bdw;
  const bf16* w;       // bf16 pointwise weights [CP, CP]: W[k][n] = w[k*CP + n]
                       // (SRC_LOAD: W[k][n] = w[n*CP + k], the transpose)
  const float* bias;   // pointwise bias [C] (not read by EPI_PLAIN)
  const bf16* g;       // EPI_GRAD: gradient at the activation's output [M, C]
  bf16* a_out;         // EPI_RECOMPUTE, EPI_GRAD: the A tile (depthwise output) [M, CP]
  bf16* z_out;         // EPI_RECOMPUTE: pre-activation [M, CP]
  bf16* out;           // EPI_ACT, EPI_RECOMPUTE: activation; EPI_GRAD: gz; EPI_PLAIN: A @ W
  int ldo;             // out's row stride: CP, or C for the caller's output
  int B, T, F, C, CP;
  int Ti, Fi, To, Fo;  // the depthwise conv's input and output grid (SRC_X, SRC_S)
  int R, FW, nrb, ncc; // a block's tile: R rows x FW columns of the output grid;
                       // nrb row blocks and ncc column chunks a batch element
  long long M;         // output positions
  int act;
};

// shared-memory carve-up of a tc_pw_kernel block, in bytes
struct PwLayout {
  int b, b_elems, a, a_elems, lda, t, t_elems, tr, tw, x, xr, xw, total;
};

__host__ __device__ inline PwLayout pw_layout(int src, const PwArgs& a) {
  PwLayout L;
  L.b = 0;
  L.b_elems = src == SRC_LOAD ? a.CP * LDBT : KC * LDB;
  L.a = L.b + 2 * L.b_elems * 2;
  L.lda = src == SRC_X ? LDAF : LDA;
  L.a_elems = BMP * L.lda;
  L.t = L.a + (src == SRC_LOAD ? 2 : 1) * L.a_elems * 2;
  L.tr = 2 * a.R + 1;  // rows and columns of the depthwise conv's input tile
  L.tw = 2 * a.FW + 1;
  L.t_elems = src == SRC_LOAD ? 0 : L.tr * L.tw * KC;
  L.x = L.t + (src == SRC_S ? 2 : 1) * L.t_elems * 2;
  L.xr = src == SRC_X ? 4 * a.R + 3 : 0;  // x rows and columns under the s0 tile
  // (rows padded to 16 bytes, with room for the 5th tap of a pair)
  L.xw = src == SRC_X ? (4 * a.FW + 5 + 3) / 4 * 4 : 0;
  L.total = L.x + L.xr * L.xw * 4;
  return L;
}

// C[m, n] = sum_k A[m, k] W[k, n] for the block's <= 80 positions m and all
// n < CP, A built chunk by chunk in shared memory by SRC, C consumed by EPI.
template <int SRC, int EPI>
__global__ void __launch_bounds__(PW_THREADS, 2) tc_pw_kernel(PwArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const PwLayout L = pw_layout(SRC, a);
  bf16* Bs = reinterpret_cast<bf16*>(smem + L.b);
  bf16* As = reinterpret_cast<bf16*>(smem + L.a);
  bf16* ts = reinterpret_cast<bf16*>(smem + L.t);
  float* xs = reinterpret_cast<float*>(smem + L.x);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int C = a.C, CP = a.CP, nchunks = CP / KC;

  // the block's tile: batch element b, output rows [r0, r0+R), columns
  // [f0, f0+FW); SRC_LOAD: rows [m0, m0+BMP) of A
  int b = 0, r0 = 0, f0 = 0;
  long long m0 = 0;
  if (SRC == SRC_LOAD) {
    m0 = (long long)blockIdx.x * BMP;
  } else {
    int bid = blockIdx.x;
    f0 = (bid % a.ncc) * a.FW;
    bid /= a.ncc;
    r0 = (bid % a.nrb) * a.R;
    b = bid / a.nrb;
  }
  // the output position of tile row p, or -1
  auto pos_m = [&](int p) -> long long {
    if (SRC == SRC_LOAD) return m0 + p < a.M ? m0 + p : -1;
    const int r = p / a.FW, f = p - r * a.FW;
    if (r >= a.R || r0 + r >= a.To || f0 + f >= a.Fo) return -1;
    return ((long long)b * a.To + r0 + r) * a.Fo + f0 + f;
  };

  auto load_b = [&](int kc, int buf) {
    bf16* dst = Bs + buf * L.b_elems;
    const int k0 = kc * KC;
    if (SRC == SRC_LOAD) {  // [n][kk] = w[n*CP + k0 + kk]: 64 bytes of each row
      for (int i = tid; i < CP * (KC / 8); i += PW_THREADS) {
        const int n = i >> 2, q = i & 3;
        cp_async16(dst + n * LDBT + q * 8, a.w + (long long)n * CP + k0 + q * 8, true);
      }
    } else {                // [kk][n] = w[(k0 + kk)*CP + n]: whole rows
      const int per = CP / 8;
      for (int i = tid; i < KC * per; i += PW_THREADS) {
        const int kk = i / per, q = i - kk * per;
        cp_async16(dst + kk * LDB + q * 8, a.w + (long long)(k0 + kk) * CP + q * 8, true);
      }
    }
  };
  auto load_a = [&](int kc, int buf) {  // SRC_LOAD
    bf16* dst = As + buf * L.a_elems;
    for (int i = tid; i < BMP * (KC / 8); i += PW_THREADS) {
      const int p = i >> 2, q = i & 3;
      const long long m = m0 + p;
      const bool ok = m < a.M;
      cp_async16(dst + p * LDA + q * 8, ok ? a.src + m * CP + kc * KC + q * 8 : a.src, ok);
    }
  };
  auto load_s = [&](int kc, int buf) {  // SRC_S: the s1 tile, zero outside the grid
    bf16* dst = ts + buf * L.t_elems;
    for (int i = tid; i < L.tr * L.tw * (KC / 8); i += PW_THREADS) {
      const int pos = i >> 2, q = i & 3;
      const int ti = pos / L.tw, tj = pos - ti * L.tw;
      const int gr = 2 * r0 - 1 + ti, gc = 2 * f0 - 1 + tj;
      const bool ok = gr >= 0 && gr < a.Ti && gc >= 0 && gc < a.Fi;
      cp_async16(dst + pos * KC + q * 8,
                 ok ? a.src + (((long long)b * a.Ti + gr) * a.Fi + gc) * CP + kc * KC + q * 8
                    : a.src, ok);
    }
  };
  // SRC_X: s0 for the chunk's channels at every position of the tile, once:
  // one lane a channel, a warp S0_PAIRS pairs of neighbouring positions of a
  // row at a time, whose x taps (3 x 5 values, broadcasts) come in as one
  // float4 and one float a row.  Pairs are numbered row by row, npr a row;
  // past the last pair a warp computes pair 0 again and stores nothing.
  auto build_s0 = [&](int kc) {
    const int ch = kc * KC + lane;
    float k9c[9], b0c = 0.f;
#pragma unroll
    for (int j = 0; j < 9; ++j) k9c[j] = ch < C ? a.k9[j * C + ch] : 0.f;
    if (ch < C) b0c = a.b0[ch];
    const int npr = (L.tw + 1) / 2, npairs = L.tr * npr;
    int pi[S0_PAIRS], pj[S0_PAIRS];  // row and pair within the row of each slot
#pragma unroll
    for (int u = 0; u < S0_PAIRS; ++u) {
      const int q = warp + u * PW_WARPS;
      pi[u] = q / npr;
      pj[u] = q - pi[u] * npr;
    }
    for (int q0 = warp; q0 < npairs; q0 += S0_PAIRS * PW_WARPS) {
      float sv[S0_PAIRS][2];
#pragma unroll
      for (int u = 0; u < S0_PAIRS; ++u) {
        const bool live = q0 + u * PW_WARPS < npairs;
        const int i = live ? pi[u] : 0, j = live ? 2 * pj[u] : 0;
        const float* xt = xs + 2 * i * L.xw + 2 * j;
        float acc2[2];
#pragma unroll
        for (int dt = 0; dt < 3; ++dt) {
          const float4 v = *reinterpret_cast<const float4*>(xt + dt * L.xw);
          const float v4 = xt[dt * L.xw + 4];
          if (dt == 0) {  // `_stage0`'s order: tap 0 and the bias first
            acc2[0] = v.x * k9c[0] + b0c;
            acc2[1] = v.z * k9c[0] + b0c;
          } else {
            acc2[0] += v.x * k9c[3 * dt];
            acc2[1] += v.z * k9c[3 * dt];
          }
          acc2[0] += v.y * k9c[3 * dt + 1];
          acc2[0] += v.z * k9c[3 * dt + 2];
          acc2[1] += v.w * k9c[3 * dt + 1];
          acc2[1] += v4 * k9c[3 * dt + 2];
        }
        const int gr = 2 * r0 - 1 + i;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gc = 2 * f0 - 1 + j + e;
          sv[u][e] = (gr >= 0 && gr < a.Ti && gc >= 0 && gc < a.Fi)
                         ? act_f(a.act, rnd(acc2[e])) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < S0_PAIRS; ++u) {
        if (q0 + u * PW_WARPS < npairs) {
          const int j = 2 * pj[u];
          bf16* dst = ts + (pi[u] * L.tw + j) * KC + lane;
          dst[0] = to_bf(sv[u][0]);
          if (j + 1 < L.tw) dst[KC] = to_bf(sv[u][1]);
        }
        // next slot: S0_PAIRS * PW_WARPS pairs on
        pj[u] += S0_PAIRS * PW_WARPS;
        while (pj[u] >= npr) {
          pj[u] -= npr;
          ++pi[u];
        }
      }
    }
  };
  // the A tile of a chunk: the depthwise conv of the tile t (s0 or s1), two
  // positions a lane side by side; a position outside the grid (or past
  // BMP) reads position 0's taps and gives 0
  auto build_a = [&](const bf16* t, int kc) {
    const int ch = kc * KC + lane;
    float dwc[9], bdwc = 0.f;
#pragma unroll
    for (int j = 0; j < 9; ++j) dwc[j] = ch < C ? rnd(a.dw[j * C + ch]) : 0.f;
    if (ch < C) bdwc = rnd(a.bdw[ch]);
    for (int p0 = warp; p0 < BMP; p0 += 2 * PW_WARPS) {
      long long m[2];
      float v[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int p = p0 + u * PW_WARPS;
        m[u] = p < BMP ? pos_m(p) : -1;
        const int pc = m[u] >= 0 ? p : 0;
        const int r = pc / a.FW, f = pc - r * a.FW;
        const bf16* tt = t + (2 * r * L.tw + 2 * f) * KC + lane;
        float acc = to_f(tt[0]) * dwc[0] + bdwc;
#pragma unroll
        for (int j = 1; j < 9; ++j) acc += to_f(tt[((j / 3) * L.tw + j % 3) * KC]) * dwc[j];
        v[u] = m[u] >= 0 ? rnd(acc) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int p = p0 + u * PW_WARPS;
        if ((EPI == EPI_RECOMPUTE || EPI == EPI_GRAD) && m[u] >= 0)
          a.a_out[m[u] * CP + ch] = to_bf(v[u]);
        if (p < BMP) As[p * L.lda + (SRC == SRC_X ? kc * KC : 0) + lane] = to_bf(v[u]);
      }
    }
  };

  // warp w owns output channels [NW w, NW w + NW): NW / 8 n-tiles
  const int n0 = warp * NW;
  const bool active = n0 < CP;
  float acc[MT][NW / 8][4];  // set to 0 just before the products: not live while A is built
  auto zero_acc = [&]() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NW / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  };
  auto mma_chunk = [&](const bf16* A, int lda, const bf16* Bt) {
    if (!active) return;
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      uint32_t bfr[NW / 16][4];
#pragma unroll
      for (int np = 0; np < NW / 16; ++np) {
        if (SRC == SRC_LOAD)
          ldsm_x4(bfr[np], frag_b(Bt, LDBT, n0 + np * 16, ks * 16, lane));
        else
          ldsm_x4_trans(bfr[np], frag_a(Bt, LDB, ks * 16, n0 + np * 16, lane));
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t af[4];
        ldsm_x4(af, frag_a(A, lda, mt * 16, ks * 16, lane));
#pragma unroll
        for (int np = 0; np < NW / 16; ++np) {
          mma_bf16(acc[mt][2 * np], af, bfr[np][0], bfr[np][1]);
          mma_bf16(acc[mt][2 * np + 1], af, bfr[np][2], bfr[np][3]);
        }
      }
    }
  };

  if (SRC == SRC_X) {
    // the block's x rows, once, zero outside the input
    for (int i = tid; i < L.xr * L.xw; i += PW_THREADS) {
      const int u = i / L.xw, v = i - u * L.xw;
      const int t = 4 * r0 - 3 + u, f = 4 * f0 - 3 + v;
      xs[i] = (t >= 0 && t < a.T && f >= 0 && f < a.F)
                  ? to_f(a.x[((long long)b * a.T + t) * a.F + f]) : 0.f;
    }
    // the whole A tile first, chunk by chunk (no accumulator is live yet),
    // while the first two weight chunks come in; then the products
    load_b(0, 0);
    cp_async_commit();
    if (nchunks > 1) load_b(1, 1);
    cp_async_commit();
    for (int kc = 0; kc < nchunks; ++kc) {
      __syncthreads();  // x has landed / the last chunk's s0 tile is consumed
      build_s0(kc);
      __syncthreads();
      build_a(ts, kc);
    }
    zero_acc();
    for (int kc = 0; kc < nchunks; ++kc) {
      if (kc >= 1 && kc + 1 < nchunks) load_b(kc + 1, (kc + 1) & 1);
      if (kc >= 1) cp_async_commit();
      cp_async_wait_1();
      __syncthreads();
      mma_chunk(As + kc * KC, L.lda, Bs + (kc & 1) * L.b_elems);
      __syncthreads();  // this buffer is refilled next iteration
    }
  } else {
    if (SRC == SRC_S) load_s(0, 0);
    else load_a(0, 0);
    load_b(0, 0);
    cp_async_commit();
    zero_acc();
    for (int kc = 0; kc < nchunks; ++kc) {
      if (kc + 1 < nchunks) {
        if (SRC == SRC_S) load_s(kc + 1, (kc + 1) & 1);
        else load_a(kc + 1, (kc + 1) & 1);
        load_b(kc + 1, (kc + 1) & 1);
      }
      cp_async_commit();
      cp_async_wait_1();
      __syncthreads();
      if (SRC == SRC_S) {
        build_a(ts + (kc & 1) * L.t_elems, kc);
        __syncthreads();
        mma_chunk(As, LDA, Bs + (kc & 1) * L.b_elems);
      } else {
        mma_chunk(As + (kc & 1) * L.a_elems, LDA, Bs + (kc & 1) * L.b_elems);
      }
      __syncthreads();  // these buffers are refilled next iteration
    }
  }
  if (!active) return;

  // the epilogue, from the accumulators
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = pos_m(mt * 16 + g + 8 * h);
      if (m < 0) continue;
#pragma unroll
      for (int nt = 0; nt < NW / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + nt * 8 + 2 * tq + e;
          const float v = acc[mt][nt][2 * h + e];
          if (EPI == EPI_PLAIN) {
            a.out[m * a.ldo + n] = to_bf(v);
            continue;
          }
          const float z = rnd(rnd(v) + (n < C ? rnd(a.bias[n]) : 0.f));
          if (EPI == EPI_GRAD) {
            const float gg = n < C ? to_f(a.g[m * C + n]) : 0.f;
            a.out[m * a.ldo + n] = to_bf(gg * act_grad(a.act, z));
            continue;
          }
          if (EPI == EPI_RECOMPUTE) a.z_out[m * CP + n] = to_bf(z);
          if (n < a.ldo) a.out[m * a.ldo + n] = to_bf(act_f(a.act, z));
        }
      }
    }
  }
}

// Partials of gW[k, n] = sum_m A[m, k] Gz[m, n] (and gb[n] = sum_m Gz[m, n]
// in the blocks of the first k tile) over positions [p*rows, (p+1)*rows):
// part[p] = [gW (C*C), gb (C)].  A and Gz are [M, CP]; 8 warps as 4 (32 k
// rows each) x 2 (64 n columns each) of a 128 x 128 output tile.
__global__ void __launch_bounds__(THREADS) tc_wgrad_kernel(const bf16* __restrict__ A,
                                                           const bf16* __restrict__ Gz,
                                                           long long M, long long rows, int C,
                                                           int CP, float* __restrict__ part) {
  __shared__ __align__(16) bf16 As[2][WG_STEP * LDW];
  __shared__ __align__(16) bf16 Gs[2][WG_STEP * LDW];
  const int tiles = (CP + WG_TILE - 1) / WG_TILE;
  const int k0 = (blockIdx.x / tiles) * WG_TILE;
  const int n0 = (blockIdx.x % tiles) * WG_TILE;
  const long long p = blockIdx.y;
  const long long mbeg = p * rows;
  const long long mend = mbeg + rows < M ? mbeg + rows : M;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int wk = warp & 3, wn = warp >> 2;
  const bool active = k0 + wk * 32 < CP && n0 + wn * 64 < CP;
  const bool bias = k0 == 0 && tid < WG_TILE;

  auto load = [&](long long ms, int buf) {
    for (int i = tid; i < 2 * WG_STEP * (WG_TILE / 8); i += THREADS) {
      const int which = i / (WG_STEP * (WG_TILE / 8));
      const int rem = i - which * (WG_STEP * (WG_TILE / 8));
      const int mm = rem >> 4, q = rem & 15;
      const long long m = ms + mm;
      const int col = (which ? n0 : k0) + q * 8;
      const bf16* src = which ? Gz : A;
      const bool ok = m < mend && col < CP;
      cp_async16((which ? Gs[buf] : As[buf]) + mm * LDW + q * 8, ok ? src + m * CP + col : src, ok);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;
  float bsum = 0.f;

  load(mbeg, 0);
  cp_async_commit();
  int buf = 0;
  for (long long ms = mbeg; ms < mend; ms += WG_STEP, buf ^= 1) {
    if (ms + WG_STEP < mend) load(ms + WG_STEP, buf ^ 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    if (active) {
#pragma unroll
      for (int ks = 0; ks < WG_STEP / 16; ++ks) {
        uint32_t af[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldsm_x4_trans(af[i], frag_b(As[buf], LDW, ks * 16, wk * 32 + i * 16, lane));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bfr[4];
          ldsm_x4_trans(bfr, frag_a(Gs[buf], LDW, ks * 16, wn * 64 + np * 16, lane));
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_bf16(acc[i][2 * np], af[i], bfr[0], bfr[1]);
            mma_bf16(acc[i][2 * np + 1], af[i], bfr[2], bfr[3]);
          }
        }
      }
    }
    if (bias) {
#pragma unroll 8
      for (int mm = 0; mm < WG_STEP; ++mm) bsum += to_f(Gs[buf][mm * LDW + tid]);
    }
    __syncthreads();  // this buffer is refilled next step
  }

  float* out = part + p * ((long long)C * C + C);
  if (active) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = k0 + wk * 32 + i * 16 + g + 8 * (e >> 1);
          const int n = n0 + wn * 64 + nt * 8 + 2 * tq + (e & 1);
          if (k < C && n < C) out[(long long)k * C + n] = acc[i][nt][e];
        }
  }
  if (bias && n0 + tid < C) out[(long long)C * C + n0 + tid] = bsum;
}

// ---------------------------------------------------------------------------
// depthwise and stage-0 gradients (CUDA cores)
// ---------------------------------------------------------------------------

constexpr int DW_GR = DW_RI / 2 + 1;      // gradient rows under a group of input rows
constexpr int DW_GW = DW_FI / 2 + 1;      // gradient columns under a block's input columns
constexpr int DW_XR = 2 * DW_RI + 1;      // stage 0: x rows and columns under them
constexpr int DW_XW = (2 * DW_FI + 1 + 3) / 4 * 4;  // rows padded to 16 bytes

struct DwBwdArgs {
  const bf16* gd;      // gradient at the depthwise output [B, To, Fo, CP]
  const float* dw;     // depthwise weights [9, C]
  int Ti, Fi, To, Fo;  // input and output grids of the depthwise conv
  int NR, nrb, ncc;    // input rows a block (a multiple of DW_RI); row blocks and
                       // column chunks of DW_FI a batch element
  // stage 1 input (STAGE0 == false): s1 and z1 as stored, gz1 written, [M1, CP]
  const bf16* s_in;
  const bf16* z_in;
  bf16* gz_out;
  // stage 0 input (STAGE0 == true): s0, z0 recomputed from x
  const bf16* x;
  const float* k9;
  const float* b0;
  float* G;            // [M0, 9]: sum_c k9[j, c] gz0[p, c], or null
  int T, F, C, CP;
  int act;
  float* part;         // per block: STAGE0: [gk9 9C, gb0 C, gdw 9C, gbdw C]; else [gdw 9C, gbdw C]
};

__host__ __device__ inline int dw_smem(bool stage0, bool with_g, int CP) {
  int bytes = DW_GR * DW_GW * CP * 2;
  if (stage0) bytes += DW_XR * DW_XW * 4;
  if (stage0 && with_g) bytes += (DW_FI * (CP + 1) + 9 * CP) * 4;
  return bytes;
}

// Gradient through one depthwise conv, gathered at its input: every input
// element sums the taps that read it, then goes through the activation
// before it.  A block covers NR input rows x DW_FI columns of one batch
// element, DW_RI rows at a time, with the gradient rows under them (and for
// stage 0 the x rows) in shared memory; one thread a channel.  Each block
// writes its partial weight gradients.
template <bool STAGE0>
__global__ void __launch_bounds__(THREADS) dw_bwd_kernel(DwBwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.C, CP = a.CP;
  bf16* gds = reinterpret_cast<bf16*>(smem);                     // [DW_GR][DW_GW][CP]
  float* xs = reinterpret_cast<float*>(smem + DW_GR * DW_GW * CP * 2);  // [DW_XR][DW_XW]
  float* gzs = xs + DW_XR * DW_XW;                               // [DW_FI][CP + 1]
  float* k9s = gzs + DW_FI * (CP + 1);                           // [9][CP]
  const int tid = threadIdx.x;
  const int c = tid;
  const bool active = c < CP, real = c < C;
  const bool with_g = STAGE0 && a.G != nullptr;
  int bid = blockIdx.x;
  const int fi0 = (bid % a.ncc) * DW_FI;
  bid /= a.ncc;
  const int rbeg = (bid % a.nrb) * a.NR;
  const int b = bid / a.nrb;
  const int rend = rbeg + a.NR < a.Ti ? rbeg + a.NR : a.Ti;
  const int fend = fi0 + DW_FI < a.Fi ? fi0 + DW_FI : a.Fi;

  float w[9], gw[9], gb = 0.f, k9c[9], gk[9], gk0 = 0.f, b0c = 0.f;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    w[j] = real ? rnd(a.dw[j * C + c]) : 0.f;
    gw[j] = 0.f;
    gk[j] = 0.f;
    k9c[j] = (STAGE0 && real) ? a.k9[j * C + c] : 0.f;
  }
  if (STAGE0 && real) b0c = a.b0[c];
  if (with_g)
    for (int idx = tid; idx < 9 * CP; idx += THREADS) {
      const int j = idx / CP, cc = idx - j * CP;
      k9s[idx] = cc < C ? a.k9[j * C + cc] : 0.f;
    }

  for (int ri0 = rbeg; ri0 < rend; ri0 += DW_RI) {
    __syncthreads();  // the last group's tiles are consumed
    const int ro0 = ri0 / 2, fo0 = fi0 / 2;
    for (int i = tid; i < DW_GR * DW_GW * (CP / 8); i += THREADS) {
      const int pos = i / (CP / 8), q = i - pos * (CP / 8);
      const int u = pos / DW_GW, v = pos - u * DW_GW;
      const bool ok = ro0 + u < a.To && fo0 + v < a.Fo;
      cp_async16(gds + pos * CP + q * 8,
                 ok ? a.gd + (((long long)b * a.To + ro0 + u) * a.Fo + fo0 + v) * CP + q * 8
                    : a.gd, ok);
    }
    cp_async_commit();
    if (STAGE0) {
      for (int i = tid; i < DW_XR * DW_XW; i += THREADS) {
        const int u = i / DW_XW, v = i - u * DW_XW;
        const int t = 2 * ri0 - 1 + u, f = 2 * fi0 - 1 + v;
        xs[i] = (t >= 0 && t < a.T && f >= 0 && f < a.F)
                    ? to_f(a.x[((long long)b * a.T + t) * a.F + f]) : 0.f;
      }
    }
    cp_async_wait_0();
    __syncthreads();

    for (int i = 0; i < DW_RI && ri0 + i < rend; ++i) {
      const int ri = ri0 + i;
      // output (ro, fo) reads input (ri, fi) at tap (dt, df) when
      // 2 ro = ri + 1 - dt and 2 fo = fi + 1 - df: an even row takes dt 1
      // (tile row i/2), an odd one dt 0 and 2 (tile rows (i+1)/2, (i-1)/2);
      // an even column takes df 1 (tile column j/2), the odd one after it df 0
      // and 2 (j/2 + 1, j/2).  The tile is zero past the output grid.
      auto row = [&](auto odd_tag) {
        constexpr bool ODD = decltype(odd_tag)::value;
        constexpr int NR = ODD ? 2 : 1;
        const bf16* grow[NR];
        int dts[NR];
        if (ODD) {
          grow[0] = gds + ((i + 1) / 2) * DW_GW * CP + c; dts[0] = 0;
          grow[NR - 1] = gds + ((i - 1) / 2) * DW_GW * CP + c; dts[NR - 1] = 2;
        } else {
          grow[0] = gds + (i / 2) * DW_GW * CP + c; dts[0] = 1;
        }
        // an even column and the odd one after it (fi0 and Fi are even)
        for (int j = 0; fi0 + j < fend; j += 2) {
          const long long p = ((long long)b * a.Ti + ri) * a.Fi + fi0 + j;
          float s[2], z[2], gz[2] = {0.f, 0.f}, xt[2][9];
          if (active) {
            float ag[2];
            if (STAGE0) {  // the x taps of both: one float4 and one float a row
#pragma unroll
              for (int dt = 0; dt < 3; ++dt) {
                const float* xr = xs + (2 * i + dt) * DW_XW + 2 * j;
                const float4 v = *reinterpret_cast<const float4*>(xr);
                xt[0][3 * dt] = v.x; xt[0][3 * dt + 1] = v.y; xt[0][3 * dt + 2] = v.z;
                xt[1][3 * dt] = v.z; xt[1][3 * dt + 1] = v.w; xt[1][3 * dt + 2] = xr[4];
              }
            }
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (STAGE0) {
                float acc = xt[e][0] * k9c[0] + b0c;  // `_stage0`'s order
#pragma unroll
                for (int t = 1; t < 9; ++t) acc += xt[e][t] * k9c[t];
                z[e] = rnd(acc);
                act_and_grad(a.act, z[e], s[e], ag[e]);
                s[e] = rnd(s[e]);
              } else {
                s[e] = to_f(a.s_in[(p + e) * CP + c]);
                z[e] = to_f(a.z_in[(p + e) * CP + c]);
                float unused;
                act_and_grad(a.act, z[e], unused, ag[e]);
              }
            }
            float gs[2] = {0.f, 0.f};
#pragma unroll
            for (int q = 0; q < NR; ++q) {
              const float g_lo = to_f(grow[q][(j / 2) * CP]);      // column j/2
              const float g_hi = to_f(grow[q][(j / 2 + 1) * CP]);  // column j/2 + 1
              const int t = 3 * dts[q];
              gs[0] += w[t + 1] * g_lo;
              gw[t + 1] += s[0] * g_lo;
              if (!ODD) gb += g_lo;  // every output position has its centre tap here
              gs[1] += w[t] * g_hi;
              gw[t] += s[1] * g_hi;
              gs[1] += w[t + 2] * g_lo;
              gw[t + 2] += s[1] * g_lo;
            }
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              gz[e] = rnd(rnd(gs[e]) * ag[e]);
              if (STAGE0) {
#pragma unroll
                for (int t = 0; t < 9; ++t) gk[t] += xt[e][t] * gz[e];
                gk0 += gz[e];
              } else {
                a.gz_out[(p + e) * CP + c] = to_bf(gz[e]);
              }
            }
          }
          if (with_g && active) {
            gzs[j * (CP + 1) + c] = gz[0];
            gzs[(j + 1) * (CP + 1) + c] = gz[1];
          }
        }
      };
      if (ri & 1) row(std::true_type{});
      else row(std::false_type{});
      if (with_g) {
        __syncthreads();
        // G[p, t] = sum_c k9[t, c] gz0[p, c]: one (position, tap) pair a thread
        for (int q = tid; q < (fend - fi0) * 9; q += THREADS) {
          const int jj = q / 9, t = q - 9 * jj;
          float sum = 0.f;
          for (int cc = 0; cc < CP; ++cc) sum += k9s[t * CP + cc] * gzs[jj * (CP + 1) + cc];
          a.G[(((long long)b * a.Ti + ri) * a.Fi + fi0 + jj) * 9 + t] = sum;
        }
        __syncthreads();
      }
    }
  }
  if (!real) return;
  float* out = a.part + (long long)blockIdx.x * (STAGE0 ? 20 : 10) * C;
  if (STAGE0) {
#pragma unroll
    for (int j = 0; j < 9; ++j) out[j * C + c] = gk[j];
    out[9 * C + c] = gk0;
    out += 10 * C;
  }
#pragma unroll
  for (int j = 0; j < 9; ++j) out[j * C + c] = gw[j];
  out[9 * C + c] = gb;
}

// gx[b, t, f] = sum over the stage-0 taps that read x[b, t, f] of G
__global__ void __launch_bounds__(THREADS) gx_kernel(const float* __restrict__ G, Dims d,
                                                      bf16* __restrict__ gx) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long n = (long long)d.B * d.T * d.F;
  if (idx >= n) return;
  const int f = (int)(idx % d.F);
  const int t = (int)((idx / d.F) % d.T);
  const int b = (int)(idx / ((long long)d.F * d.T));
  float acc = 0.f;
#pragma unroll
  for (int dt = 0; dt < 3; ++dt) {
    const int rr = t + 1 - dt;
    if (rr < 0 || (rr & 1) || rr / 2 >= d.T0) continue;
#pragma unroll
    for (int df = 0; df < 3; ++df) {
      const int ff = f + 1 - df;
      if (ff < 0 || (ff & 1) || ff / 2 >= d.F0) continue;
      acc += G[(((long long)b * d.T0 + rr / 2) * d.F0 + ff / 2) * 9 + 3 * dt + df];
    }
  }
  gx[idx] = to_bf(acc);
}

// out[i] = sum_p part[p * stride + i], p in order
__global__ void __launch_bounds__(THREADS) reduce_kernel(const float* __restrict__ part,
                                                         long long P, long long stride,
                                                         long long n, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (long long p = 0; p < P; ++p) s += part[p * stride + i];
  out[i] = s;
}

// pw1 and pw2 (blockIdx.y) to bf16 [CP, CP], zero past C
__global__ void __launch_bounds__(THREADS) weights_kernel(const float* __restrict__ pw1,
                                                          const float* __restrict__ pw2, int C,
                                                          int CP, bf16* __restrict__ out1,
                                                          bf16* __restrict__ out2) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= CP * CP) return;
  const int k = i / CP, n = i - k * CP;
  const float* w = blockIdx.y ? pw2 : pw1;
  (blockIdx.y ? out2 : out1)[i] = (k < C && n < C) ? to_bf(w[k * C + n]) : to_bf(0.f);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }
size_t align256(size_t n) { return (n + 255) & ~(size_t)255; }

// position ranges of a weight gradient: about two blocks an SM, each range a
// multiple of WG_STEP
struct WgradSplit {
  long long rows, P;
};

WgradSplit wgrad_split(long long M, int CP) {
  const long long tiles = ceil_div(CP, WG_TILE);
  const long long parts = ceil_div(264, tiles * tiles);
  WgradSplit s;
  s.rows = ceil_div(ceil_div(M, parts), WG_STEP) * WG_STEP;
  s.P = ceil_div(M, s.rows);
  return s;
}

// a depthwise backward's blocks: about 512, each NR input rows
DwBwdArgs dw_split(const Dims& d, int Ti, int Fi, int To, int Fo) {
  DwBwdArgs a = {};
  a.Ti = Ti; a.Fi = Fi; a.To = To; a.Fo = Fo;
  a.ncc = (int)ceil_div(Fi, DW_FI);
  a.NR = (int)(ceil_div(ceil_div((long long)d.B * Ti * a.ncc, 512), DW_RI) * DW_RI);
  a.nrb = (int)ceil_div(Ti, a.NR);
  a.T = d.T; a.F = d.F; a.C = d.C; a.CP = d.CP;
  return a;
}

long long dw_blocks(const Dims& d, const DwBwdArgs& a) { return (long long)d.B * a.nrb * a.ncc; }

// The scratch, carved from one workspace: the forward's (pass 0) is the
// bf16 weights and s1; the backward's (pass 1) adds the rest.
struct Work {
  size_t pw1b, pw2b, s1, d1, z1, gz1, gd1, d2, gz2, gd2, G, part_pw2, part_pw1, part_dw2,
      part_dw1, total;
};

Work make_work(const Dims& d, int pass) {
  Work w = {};
  const long long C = d.C, CP = d.CP;
  size_t off = 0;
  auto take = [&](size_t bytes) { const size_t at = off; off += align256(bytes); return at; };
  w.pw1b = take(CP * CP * 2);
  w.pw2b = take(CP * CP * 2);
  w.s1 = take(d.M1 * CP * 2);
  if (pass == 1) {
    w.d1 = take(d.M1 * CP * 2);
    w.z1 = take(d.M1 * CP * 2);
    w.gz1 = take(d.M1 * CP * 2);
    w.gd1 = take(d.M1 * CP * 2);
    w.d2 = take(d.M2 * CP * 2);
    w.gz2 = take(d.M2 * CP * 2);
    w.gd2 = take(d.M2 * CP * 2);
    w.G = take(d.M0 * 9 * sizeof(float));
    w.part_pw2 = take(wgrad_split(d.M2, d.CP).P * (C * C + C) * sizeof(float));
    w.part_pw1 = take(wgrad_split(d.M1, d.CP).P * (C * C + C) * sizeof(float));
    w.part_dw2 = take(dw_blocks(d, dw_split(d, d.T1, d.F1, d.T2, d.F2)) * 10 * C * sizeof(float));
    w.part_dw1 = take(dw_blocks(d, dw_split(d, d.T0, d.F0, d.T1, d.F1)) * 20 * C * sizeof(float));
  }
  w.total = off;
  return w;
}

#define DAE_TRY(expr)                       \
  do {                                      \
    cudaError_t e_ = (expr);                \
    if (e_ != cudaSuccess) return (int)e_;  \
  } while (0)

// a stage's product: stage 1 (x -> s1) or 2 (s1 -> out), tiles of R rows x FW
// columns of the output grid
PwArgs stage_args(const Dims& d, const float* w, const char* work, int stage, int act) {
  const Pack pk = make_pack(d.C);
  const Work wk = make_work(d, 0);
  PwArgs a = {};
  a.B = d.B; a.T = d.T; a.F = d.F; a.C = d.C; a.CP = d.CP;
  a.act = act;
  a.k9 = w + pk.k9;
  a.b0 = w + pk.b0;
  a.ldo = d.CP;
  if (stage == 1) {
    a.dw = w + pk.dw1; a.bdw = w + pk.bdw1; a.bias = w + pk.bpw1;
    a.w = reinterpret_cast<const bf16*>(work + wk.pw1b);
    a.Ti = d.T0; a.Fi = d.F0; a.To = d.T1; a.Fo = d.F1; a.M = d.M1;
  } else {
    a.dw = w + pk.dw2; a.bdw = w + pk.bdw2; a.bias = w + pk.bpw2;
    a.w = reinterpret_cast<const bf16*>(work + wk.pw2b);
    a.Ti = d.T1; a.Fi = d.F1; a.To = d.T2; a.Fo = d.F2; a.M = d.M2;
  }
  a.FW = a.Fo < BMP ? a.Fo : BMP;
  a.R = BMP / a.FW;
  a.nrb = (int)ceil_div(a.To, a.R);
  a.ncc = (int)ceil_div(a.Fo, a.FW);
  return a;
}

// gd = gz @ W^T for one product: gz [M, CP] against the bf16 weights
PwArgs input_grad_args(const Dims& d, const char* work, size_t wb, size_t gz, size_t gd,
                       long long M) {
  PwArgs a = {};
  a.C = d.C; a.CP = d.CP; a.ldo = d.CP; a.M = M;
  a.w = reinterpret_cast<const bf16*>(work + wb);
  a.src = reinterpret_cast<const bf16*>(work + gz);
  a.out = reinterpret_cast<bf16*>(const_cast<char*>(work) + gd);
  return a;
}

template <int SRC, int EPI>
cudaError_t launch_pw(const PwArgs& a, cudaStream_t stream) {
  const int smem = pw_layout(SRC, a).total;
  cudaError_t e = cudaFuncSetAttribute(tc_pw_kernel<SRC, EPI>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const long long blocks = SRC == SRC_LOAD ? ceil_div(a.M, BMP) : (long long)a.B * a.nrb * a.ncc;
  tc_pw_kernel<SRC, EPI><<<(unsigned)blocks, PW_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_weights(const Dims& d, const float* w, char* work, cudaStream_t stream) {
  const Pack pk = make_pack(d.C);
  const Work wk = make_work(d, 0);
  weights_kernel<<<dim3((unsigned)ceil_div((long long)d.CP * d.CP, THREADS), 2), THREADS, 0,
                   stream>>>(w + pk.pw1, w + pk.pw2, d.C, d.CP,
                             reinterpret_cast<bf16*>(work + wk.pw1b),
                             reinterpret_cast<bf16*>(work + wk.pw2b));
  return cudaGetLastError();
}

cudaError_t launch_reduce(const float* part, long long P, long long stride, long long n,
                          float* out, cudaStream_t stream) {
  reduce_kernel<<<(unsigned)ceil_div(n, THREADS), THREADS, 0, stream>>>(part, P, stride, n, out);
  return cudaGetLastError();
}

cudaError_t launch_wgrad(const Dims& d, const char* work, size_t A, size_t Gz, long long M,
                         size_t part, float* out, cudaStream_t stream) {
  const WgradSplit s = wgrad_split(M, d.CP);
  const int tiles = (int)ceil_div(d.CP, WG_TILE);
  float* p = reinterpret_cast<float*>(const_cast<char*>(work) + part);
  tc_wgrad_kernel<<<dim3(tiles * tiles, (unsigned)s.P), THREADS, 0, stream>>>(
      reinterpret_cast<const bf16*>(work + A), reinterpret_cast<const bf16*>(work + Gz), M, s.rows,
      d.C, d.CP, p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long n = (long long)d.C * d.C + d.C;
  return launch_reduce(p, s.P, n, n, out, stream);
}

template <bool STAGE0>
cudaError_t launch_dw_bwd(const Dims& d, const DwBwdArgs& a, float* out, cudaStream_t stream) {
  const int smem = dw_smem(STAGE0, a.G != nullptr, d.CP);
  cudaError_t e = cudaFuncSetAttribute(dw_bwd_kernel<STAGE0>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const long long P = dw_blocks(d, a);
  dw_bwd_kernel<STAGE0><<<(unsigned)P, THREADS, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long n = (STAGE0 ? 20LL : 10LL) * d.C;
  return launch_reduce(a.part, P, n, n, out, stream);
}

int forward(const bf16* x, const Dims& d, const float* w, int act, bf16* out, char* work,
            cudaStream_t stream) {
  const Work wk = make_work(d, 0);
  DAE_TRY(launch_weights(d, w, work, stream));
  PwArgs a = stage_args(d, w, work, 1, act);
  a.x = x;
  a.out = reinterpret_cast<bf16*>(work + wk.s1);
  DAE_TRY((launch_pw<SRC_X, EPI_ACT>(a, stream)));
  PwArgs b = stage_args(d, w, work, 2, act);
  b.src = reinterpret_cast<const bf16*>(work + wk.s1);
  b.out = out;
  b.ldo = d.C;
  DAE_TRY((launch_pw<SRC_S, EPI_ACT>(b, stream)));
  return 0;
}

int backward(const bf16* x, const bf16* g, const Dims& d, const float* w, int act, bf16* gx,
             float* gw, char* work, cudaStream_t stream) {
  const Pack pk = make_pack(d.C);
  const Work wk = make_work(d, 1);
  auto at = [&](size_t off) { return reinterpret_cast<bf16*>(work + off); };
  DAE_TRY(launch_weights(d, w, work, stream));

  // recompute stage 1: d1, z1, s1
  PwArgs s1a = stage_args(d, w, work, 1, act);
  s1a.x = x;
  s1a.a_out = at(wk.d1);
  s1a.z_out = at(wk.z1);
  s1a.out = at(wk.s1);
  DAE_TRY((launch_pw<SRC_X, EPI_RECOMPUTE>(s1a, stream)));
  // recompute stage 2: d2, and gz2 = g * act'(z2)
  PwArgs s2a = stage_args(d, w, work, 2, act);
  s2a.src = at(wk.s1);
  s2a.g = g;
  s2a.a_out = at(wk.d2);
  s2a.out = at(wk.gz2);
  DAE_TRY((launch_pw<SRC_S, EPI_GRAD>(s2a, stream)));
  // gpw2, gbpw2
  DAE_TRY(launch_wgrad(d, work, wk.d2, wk.gz2, d.M2, wk.part_pw2, gw + pk.pw2, stream));
  // gd2 = gz2 @ pw2^T
  DAE_TRY((launch_pw<SRC_LOAD, EPI_PLAIN>(input_grad_args(d, work, wk.pw2b, wk.gz2, wk.gd2, d.M2),
                                          stream)));
  // through depthwise 2 and the stage-1 activation: gz1; gdw2, gbdw2
  DwBwdArgs b2 = dw_split(d, d.T1, d.F1, d.T2, d.F2);
  b2.gd = at(wk.gd2); b2.dw = w + pk.dw2;
  b2.s_in = at(wk.s1); b2.z_in = at(wk.z1); b2.gz_out = at(wk.gz1);
  b2.act = act; b2.part = reinterpret_cast<float*>(work + wk.part_dw2);
  DAE_TRY(launch_dw_bwd<false>(d, b2, gw + pk.dw2, stream));
  // gpw1, gbpw1
  DAE_TRY(launch_wgrad(d, work, wk.d1, wk.gz1, d.M1, wk.part_pw1, gw + pk.pw1, stream));
  // gd1 = gz1 @ pw1^T
  DAE_TRY((launch_pw<SRC_LOAD, EPI_PLAIN>(input_grad_args(d, work, wk.pw1b, wk.gz1, wk.gd1, d.M1),
                                          stream)));
  // through depthwise 1, the stage-0 activation and conv: gk9, gb0, gdw1, gbdw1, G
  DwBwdArgs b1 = dw_split(d, d.T0, d.F0, d.T1, d.F1);
  b1.gd = at(wk.gd1); b1.dw = w + pk.dw1;
  b1.x = x; b1.k9 = w + pk.k9; b1.b0 = w + pk.b0;
  b1.G = gx != nullptr ? reinterpret_cast<float*>(work + wk.G) : nullptr;
  b1.act = act; b1.part = reinterpret_cast<float*>(work + wk.part_dw1);
  DAE_TRY(launch_dw_bwd<true>(d, b1, gw + pk.k9, stream));
  if (gx != nullptr) {
    const long long n = (long long)d.B * d.T * d.F;
    gx_kernel<<<(unsigned)ceil_div(n, THREADS), THREADS, 0, stream>>>(b1.G, d, gx);
    DAE_TRY(cudaGetLastError());
  }
  return 0;
}

bool dims_ok(int B, int T, int F, int C) {
  return B >= 1 && T >= 1 && F >= 8 && F % 8 == 0 && C >= 1 && C <= MAX_C;
}

}  // namespace

// The entry points of fused_subsample.cu, for bf16 only (dtype 1; 0 is
// refused).  act: 0 silu, 1 relu, 2 gelu (tanh).  w: the packed f32 weights
// (k9, b0, dw1, bdw1, pw1, bpw1, dw2, bdw2, pw2, bpw2).  Tensors are
// contiguous.  Each entry point returns a cudaError_t.

// Bytes of scratch the forward (pass 0) or the backward (pass 1) needs; -1
// for what the kernels do not take
extern "C" long long dae_fused_subsample_workspace(int dtype, int pass, int B, int T, int F,
                                                   int C) {
  if (!dims_ok(B, T, F, C) || dtype != 1 || (pass != 0 && pass != 1)) return -1;
  return (long long)make_work(make_dims(B, T, F, C), pass).total;
}

// x [B, T, F] -> out [B, T2, F2, C]; work holds the forward's workspace bytes
extern "C" int dae_fused_subsample_fwd(int dtype, int act, const void* x, int B, int T, int F,
                                       int C, const float* w, void* out, void* work,
                                       void* stream) {
  if (!dims_ok(B, T, F, C) || dtype != 1 || act < 0 || act > 2) return (int)cudaErrorInvalidValue;
  return forward(static_cast<const bf16*>(x), make_dims(B, T, F, C), w, act,
                 static_cast<bf16*>(out), static_cast<char*>(work),
                 static_cast<cudaStream_t>(stream));
}

// g [B, T2, F2, C] -> gx [B, T, F] (skipped when gx is null) and the packed
// f32 weight gradients gw; work holds the backward's workspace bytes
extern "C" int dae_fused_subsample_bwd(int dtype, int act, const void* x, const void* g, int B,
                                       int T, int F, int C, const float* w, void* gx, float* gw,
                                       void* work, void* stream) {
  if (!dims_ok(B, T, F, C) || dtype != 1 || act < 0 || act > 2) return (int)cudaErrorInvalidValue;
  return backward(static_cast<const bf16*>(x), static_cast<const bf16*>(g), make_dims(B, T, F, C),
                  w, act, static_cast<bf16*>(gx), gw, static_cast<char*>(work),
                  static_cast<cudaStream_t>(stream));
}

extern "C" const char* dae_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
