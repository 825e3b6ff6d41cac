// Fused x8 dw-striding subsampling stack in f32, forward and backward, with
// every pointwise product on Hopper's tensor cores (sm_90a) as three TF32
// products of split operands ("3xTF32"): the parity route.  bf16 input goes
// to fused_subsample_bf16.cu instead.
//
// Replaces the JAX package's kernels/subsample.py: `fused_subsample`
// (:504-529), whose forward is the Pallas call `_fwd_pallas` (:278-300, body
// `_fwd_kernel` :239) and whose backward is `_bwd_pallas` (:438-485, body
// `_bwd_kernel` :333) under `_fused_bwd` (:532-566).
//
// What it computes.  x [B, T, F] f32 (F % 8 == 0); weights f32 in the JAX
// layouts, packed into one buffer (`Pack`): k9, dw1, dw2 [9, C] with (dt, df)
// row-major, pw1, pw2 [C_in, C_out], biases [C]; C <= 256.  Every 3x3 conv has
// stride 2 and padding (1, 1); there are no masks between stages (the TPU
// kernel's semantics):
//   s0 = act(conv3x3(x; k9) + b0)                                [B, T0, F0, C]
//   d1 = dwconv3x3(s0; dw1) + bdw1;  s1 = act(d1 @ pw1 + bpw1)    [B, T1, F1, C]
//   d2 = dwconv3x3(s1; dw2) + bdw2;  out = act(d2 @ pw2 + bpw2)   [B, T2, F2, C]
// with T_{k+1} = ceil(T_k / 2), F0 = F/2, F1 = F/4, F2 = F/8.  Every sum is
// f32.  Weight gradients come back in f32.  No atomics: two runs give the same
// bits.  The logistic function is taken by the special-function unit
// (__expf, __fdividef: a few f32 ulps).
//
// Why 3xTF32.  One TF32 product keeps 10 bits of each operand's mantissa,
// ~1e-3 relative, outside the 1e-4 this route is held to.  Each operand x is
// split once, big = tf32(x) and small = tf32(x - big), rounded as
// cvt.rna.tf32.f32 rounds (to nearest, ties away from zero; written as the
// two integer instructions (bits + 0x1000) & 0xffffe000, which ptxas does not
// expand as it does the cvt), and every product a.b is taken as
// small_a.big_b + big_a.small_b + big_a.big_b, three mma.sync.m16n8k8 TF32
// products into one f32 accumulator, the small terms first.  The operands are
// split where they are made, never in the inner loop: the pointwise weights
// once a call (`weights_kernel`), an A tile as a block builds it, the weight
// gradient's tiles as they land in shared memory.  The inner loops hold
// shared-memory loads and HMMAs only.
//
// Bound on this card.  At the flagship window (B 2, T 16384, F 80, C 256) the
// forward is ~30.8 GFLOP, 26.8 of them in the two pointwise products, and
// must move ~26 MB: taking the products as three TF32 products at 495 TFLOP/s
// and the rest on the CUDA cores at 67 TFLOP/s, 0.22 ms, bound by operations.
// The backward (no gx) is ~89.4 GFLOP, 80.5 of them products: 0.62 ms.
//
// Design (the tiling of fused_subsample_bf16.cu with TF32 operands).
// - `tc_pw_kernel`: one block owns up to 80 output positions (five m16
//   tiles: R whole rows of the stage's output grid, or 80 columns of one row
//   where a row is longer) and all C output channels, 16 warps of 16
//   channels each.  It loops over the input channels in chunks of KC = 16
//   (the K of the product): builds the chunk's A tile [80 x 16], split into
//   big and small f32 tiles in shared memory (rows padded by 16 bytes), and
//   accumulates with mma.sync m16n8k8: A through ldmatrix (a non-.trans
//   ldmatrix of 32-bit elements hands each lane the element at (g, t), so
//   two .x4 loads give the big and small A fragments of one m16 tile), B as
//   one 16-byte load a lane from the weights stored in fragment order.  A
//   half-warp builds one position's 16 channels at a time.  The A tile
//   comes from
//   - SRC_X (stage 1): the block's x rows, loaded once; per chunk it computes
//     each s0 value its taps need once (2R+1 rows), then the depthwise conv;
//     the next chunk's weights come in (cp.async) while a chunk is built;
//   - SRC_S (stage 2): the s1 rows it needs, by cp.async, double-buffered;
//   - SRC_LOAD (the input gradients gd = gz @ pw^T): a plain [M, CP] tensor,
//     double-buffered and split once it lands; the weights are then the
//     transposed copy that `weights_kernel` wrote.
//   The epilogue applies bias and the activation (EPI_ACT), or also keeps z
//   (EPI_RECOMPUTE), or gives gz = g * act'(z) (EPI_GRAD).
// - The forward is three launches: pw1/pw2 split into fragment order (once a
//   call), x -> s1 (s1 stays in device memory: 168 MB at the flagship), s1 ->
//   out.
// - The backward recomputes the forward (stage 1 keeping d1, z1 and s1;
//   stage 2 keeping d2 and giving gz2), then takes each product's input
//   gradient with SRC_LOAD and its weight gradient with `tc_wgrad_kernel`:
//   gW = A^T Gz over fixed position ranges, one 128 x 128 output tile a
//   block, 16 positions a step: the A and Gz rows land by cp.async (two
//   steps at once) and are split into fragment order in shared memory
//   (the transpose the contraction over positions needs, as there is no
//   ldmatrix.trans for 32-bit elements), the bias gradient summed from the
//   landed rows; f32 partials summed in order by `reduce_kernel`.  The
//   depthwise and stage-0 gradients (`dw_bwd_kernel`) stay on CUDA cores,
//   one thread a channel, reading the gradient rows (and for stage 0 the x
//   rows, which give z0 again) from shared-memory tiles.
// - Intermediates are [M, CP] f32 with CP = C rounded up to 16 and zeros in
//   the padding channels, so that every tile copy is 16-byte aligned and C
//   need not be a multiple of 16.  Index math is 32-bit, derived per block or
//   per small loop; no per-element 64-bit division.
// - Shared memory (a block may take 227 KB): tc_pw_kernel's SRC_X block takes
//   106 KB (two 32 KB weight chunks, 12.5 KB of A tile, the s0 tile, the x
//   rows), so two blocks (32 warps) share an SM, as in the bf16 kernels;
//   KC = 16 is what keeps two weight chunks of 256 split channels that small.
//   tc_wgrad_kernel takes 65 KB, dw_bwd_kernel up to 89 KB (20 input columns
//   a block): two blocks an SM each.
// - What the numbers chose (flagship window, NVIDIA H100 80GB HBM3 at 700 W,
//   kernels/attention_variants.py --module subsample, forward / backward ms,
//   cuDNN f32 3.09-3.14 / 9.56-9.62 in the same calls; this design 1.62-1.65
//   / 3.94-4.01):
//   - one block an SM (launch bounds (512, 1): no spills) 1.86 / 4.21; two
//     (64 registers, 24-148 bytes spilled) win on the A-tile build, which is
//     latency-bound;
//   - KC = 32 does not fit stage 2's double buffers (245 KB);
//   - 8 warps of 32 channels (half the A-tile reads) 1.63-1.68 / 4.02-4.04;
//   - the weight gradient's steps of 32 positions (one block an SM) 0.82 ms
//     against 0.69 for both its launches, 3 or 4 steps in flight 0.64 against
//     0.64-0.65 for 2; its 128 registers spill 188 bytes, and a split loop not
//     unrolled, which spills none, is no faster;
//   - dropping one phase of stage 1's kernel (1.33 ms forward) each: the
//     products 0.89, the s0 build 0.79, the depthwise A tile 0.98: the three
//     run one after another (0.44 + 0.55 + 0.35 ms), not overlapped.  The
//     weight gradient without its products takes 0.39 of 0.69 ms: landing and
//     splitting the f32 rows (the A and Gz tensors are 168 MB each at stage 1).
// wgmma, TMA, warp-specialised producers and keeping s1 on chip are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int MAX_C = 256;
constexpr int THREADS = 256;
constexpr int PW_THREADS = 512;       // tc_pw_kernel: 16 warps of 16 output channels
constexpr int PW_WARPS = PW_THREADS / 32;
constexpr int NW = MAX_C / PW_WARPS;  // output channels a warp
constexpr int MT = 5;                 // m16 tiles a tc_pw_kernel block
constexpr int BMP = 16 * MT;          // positions a tc_pw_kernel block
constexpr int KC = 16;                // input channels a chunk
constexpr int SLOTS = PW_THREADS / KC;  // half-warps: one position's KC channels each
constexpr int LDA = KC + 4;           // A tile row stride (floats; 16 bytes of padding)
constexpr int WG_TILE = 128;          // tc_wgrad_kernel output tile (k and n)
constexpr int WG_STEP = 16;           // positions a shared-memory step
constexpr int WG_STAGES = 2;          // steps landing at once (cp.async groups)
constexpr int LDR = WG_TILE + 4;      // its landed rows' stride (floats)
constexpr int DW_RI = 8;              // input rows a dw_bwd_kernel group
constexpr int DW_FI = 20;             // input columns a dw_bwd_kernel block
static_assert(KC % NW == 0, "CP, a multiple of KC, holds whole warps' output channels");

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

constexpr float GELU_C = 0.7978845608028654f;  // sqrt(2 / pi)

// the logistic function by the special-function unit (__expf, __fdividef)
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

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero, the
// low 13 bits zero: cvt.rna.tf32.f32's result for every finite x (and for
// inf; a NaN stays a NaN or becomes inf, and its product is NaN either way)
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small to ~21 bits, both TF32
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = round_tf32(x);
  small = round_tf32(x - __uint_as_float(big));
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

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// four 8x8 b16 matrices (8 rows of 16 bytes); lane l gives the row address
// of matrix l / 8 and receives, of each, the 32-bit word at (row l / 4,
// word l % 4)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// c[16x8] += a[16x8] . b[8x8], TF32 in, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// fragments
//
// mma.m16n8k8 TF32 layouts, lane = 4 g + t: A [16 x 8] a0 (g, t), a1 (g+8,
// t), a2 (g, t+4), a3 (g+8, t+4); B [8 x 8] b0 (k t, n g), b1 (k t+4, n g);
// C [16 x 8] c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1).
// A B operand in fragment order is one uint4 a lane: (big b0, big b1, small
// b0, small b1); a k8 x n8 tile is 32 such, lane by lane (512 bytes).
// ---------------------------------------------------------------------------

// A operand: rows [r0, r0+16) x cols [k0, k0+8) of a row-major tile of TF32
// words (stride lds, a multiple of 4), with ldsm_x4: matrices (rows r0.., k0),
// (r0+8.., k0), (r0.., k0+4), (r0+8.., k0+4) are a0, a1, a2, a3
__device__ __forceinline__ const uint32_t* frag_a(const uint32_t* tile, int lds, int r0, int k0,
                                                  int lane) {
  return tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * lds + k0 + (lane >> 4) * 4;
}

// c += a.b as three TF32 products, the small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&a_big)[4],
                                     const uint32_t (&a_small)[4], uint4 b) {
  mma_tf32(c, a_small, b.x, b.y);
  mma_tf32(c, a_big, b.z, b.w);
  mma_tf32(c, a_big, b.x, b.y);
}

__device__ __forceinline__ void load_u4(uint32_t (&r)[4], const uint32_t* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
}

// ---------------------------------------------------------------------------
// pointwise products on the tensor cores
// ---------------------------------------------------------------------------

struct PwArgs {
  const float* x;      // SRC_X: [B, T, F]
  const float* src;    // SRC_S: s1 [M1, CP]; SRC_LOAD: A [M, CP]
  const float* k9;     // SRC_X: stage-0 weights [9, C] and bias [C]
  const float* b0;
  const float* dw;     // SRC_X, SRC_S: this stage's depthwise weights [9, C], bias [C]
  const float* bias_dw;
  const uint32_t* w;   // the split pointwise weights W [CP, CP] in B-fragment order
                       // (`weights_kernel`; SRC_LOAD: the transpose)
  const float* bias;   // pointwise bias [C] (not read by EPI_PLAIN)
  const float* g;      // EPI_GRAD: gradient at the activation's output [M, C]
  float* a_out;        // EPI_RECOMPUTE, EPI_GRAD: the A tile (depthwise output) [M, CP]
  float* z_out;        // EPI_RECOMPUTE: pre-activation [M, CP]
  float* out;          // EPI_ACT, EPI_RECOMPUTE: activation; EPI_GRAD: gz; EPI_PLAIN: A @ W
  int ldo;             // out's row stride: CP, or C for the caller's output
  int B, T, F, C, CP;
  int Ti, Fi, To, Fo;  // the depthwise conv's input and output grid (SRC_X, SRC_S)
  int R, FW, nrb, ncc; // a block's tile: R rows x FW columns of the output grid;
                       // nrb row blocks and ncc column chunks a batch element
  long long M;         // output positions
  int act;
};

// shared-memory carve-up of a tc_pw_kernel block, in 4-byte words (every
// part a multiple of 4: 16-byte aligned)
struct PwLayout {
  int b, b_elems, ab, as, raw, t, t_elems, tr, tw, x, xr, xw, bytes;
};

__host__ __device__ inline PwLayout pw_layout(int src, const PwArgs& a) {
  PwLayout L;
  L.b = 0;
  L.b_elems = KC * a.CP * 2;            // a chunk of split weights
  L.ab = L.b + 2 * L.b_elems;           // A tile, big and small
  L.as = L.ab + BMP * LDA;
  L.raw = L.as + BMP * LDA;             // SRC_LOAD: two landed chunks of A
  L.t = L.raw + (src == SRC_LOAD ? 2 * BMP * LDA : 0);
  L.tr = 2 * a.R + 1;  // rows and columns of the depthwise conv's input tile
  L.tw = 2 * a.FW + 1;
  L.t_elems = src == SRC_LOAD ? 0 : L.tr * L.tw * KC;
  L.x = L.t + (src == SRC_S ? 2 : 1) * L.t_elems;
  L.xr = src == SRC_X ? 4 * a.R + 3 : 0;  // x rows and columns under the s0 tile
  // (rows padded to 16 bytes, with room for the 5th tap of a pair)
  L.xw = src == SRC_X ? (4 * a.FW + 5 + 3) / 4 * 4 : 0;
  L.bytes = (L.x + L.xr * L.xw) * 4;
  return L;
}

// C[m, n] = sum_k A[m, k] W[k, n] for the block's <= 80 positions m and all
// n < CP, A built chunk by chunk in shared memory by SRC, C consumed by EPI.
template <int SRC, int EPI>
__global__ void __launch_bounds__(PW_THREADS, 2) tc_pw_kernel(PwArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const PwLayout L = pw_layout(SRC, a);
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);
  uint32_t* Bs = words + L.b;
  uint32_t* Ab = words + L.ab;
  uint32_t* As = words + L.as;
  float* raw = reinterpret_cast<float*>(words + L.raw);
  float* ts = reinterpret_cast<float*>(words + L.t);
  float* xs = reinterpret_cast<float*>(words + L.x);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int slot = tid / KC, cl = tid % KC;  // a half-warp, and its channel of the chunk
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

  // chunk kc of the split weights: contiguous in fragment order
  auto load_b = [&](int kc, int buf) {
    uint32_t* dst = Bs + buf * L.b_elems;
    const uint32_t* src = a.w + (long long)kc * L.b_elems;
    for (int i = tid; i < L.b_elems / 4; i += PW_THREADS) cp_async16(dst + 4 * i, src + 4 * i, true);
  };
  auto load_raw = [&](int kc, int buf) {  // SRC_LOAD
    float* dst = raw + buf * BMP * LDA;
    for (int i = tid; i < BMP * (KC / 4); i += PW_THREADS) {
      const int p = i / (KC / 4), q = i % (KC / 4);
      const long long m = m0 + p;
      const bool ok = m < a.M;
      cp_async16(dst + p * LDA + q * 4, ok ? a.src + m * CP + kc * KC + q * 4 : a.src, ok);
    }
  };
  auto load_s = [&](int kc, int buf) {  // SRC_S: the s1 tile, zero outside the grid
    float* dst = ts + buf * L.t_elems;
    for (int i = tid; i < L.tr * L.tw * (KC / 4); i += PW_THREADS) {
      const int pos = i / (KC / 4), q = i % (KC / 4);
      const int ti = pos / L.tw, tj = pos - ti * L.tw;
      const int gr = 2 * r0 - 1 + ti, gc = 2 * f0 - 1 + tj;
      const bool ok = gr >= 0 && gr < a.Ti && gc >= 0 && gc < a.Fi;
      cp_async16(dst + pos * KC + q * 4,
                 ok ? a.src + (((long long)b * a.Ti + gr) * a.Fi + gc) * CP + kc * KC + q * 4
                    : a.src, ok);
    }
  };
  // A tile element (p, k), split
  auto put_a = [&](int p, int k, float v) {
    uint32_t big, small;
    split(v, big, small);
    Ab[p * LDA + k] = big;
    As[p * LDA + k] = small;
  };
  // SRC_X: s0 for the chunk's channels at every position of the tile, once:
  // a half-warp's lane a channel, a half-warp a pair of neighbouring
  // positions of a row at a time, whose x taps (3 x 5 values, broadcasts)
  // come in as one float4 and one float a row.  Pairs are numbered row by
  // row, npr a row.
  auto build_s0 = [&](int kc) {
    const int ch = kc * KC + cl;
    float k9c[9], b0c = 0.f;
#pragma unroll
    for (int j = 0; j < 9; ++j) k9c[j] = ch < C ? a.k9[j * C + ch] : 0.f;
    if (ch < C) b0c = a.b0[ch];
    const int npr = (L.tw + 1) / 2, npairs = L.tr * npr;
    int pi = slot / npr, pj = slot - pi * npr;  // row and pair within the row
    for (int q = slot; q < npairs; q += SLOTS) {
      const int j = 2 * pj;
      const float* xt = xs + 2 * pi * L.xw + 2 * j;
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
      const int gr = 2 * r0 - 1 + pi;
      float* dst = ts + (pi * L.tw + j) * KC + cl;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gc = 2 * f0 - 1 + j + e;
        const float s = (gr >= 0 && gr < a.Ti && gc >= 0 && gc < a.Fi) ? act_f(a.act, acc2[e])
                                                                         : 0.f;
        if (e == 0 || j + 1 < L.tw) dst[e * KC] = s;
      }
      pj += SLOTS;  // next pair: SLOTS pairs on
      while (pj >= npr) {
        pj -= npr;
        ++pi;
      }
    }
  };
  // the A tile of a chunk: the depthwise conv of the tile t (s0 or s1), two
  // positions a half-warp side by side; a position outside the grid reads
  // position 0's taps and gives 0
  auto build_a = [&](const float* t, int kc) {
    const int ch = kc * KC + cl;
    float dwc[9], bdwc = 0.f;
#pragma unroll
    for (int j = 0; j < 9; ++j) dwc[j] = ch < C ? a.dw[j * C + ch] : 0.f;
    if (ch < C) bdwc = a.bias_dw[ch];
    for (int p0 = slot; p0 < BMP; p0 += 2 * SLOTS) {
      long long m[2];
      float v[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int p = p0 + u * SLOTS;
        m[u] = p < BMP ? pos_m(p) : -1;
        const int pc = m[u] >= 0 ? p : 0;
        const int r = pc / a.FW, f = pc - r * a.FW;
        const float* tt = t + (2 * r * L.tw + 2 * f) * KC + cl;
        float acc = tt[0] * dwc[0] + bdwc;
#pragma unroll
        for (int j = 1; j < 9; ++j) acc += tt[((j / 3) * L.tw + j % 3) * KC] * dwc[j];
        v[u] = m[u] >= 0 ? acc : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int p = p0 + u * SLOTS;
        if ((EPI == EPI_RECOMPUTE || EPI == EPI_GRAD) && m[u] >= 0) a.a_out[m[u] * CP + ch] = v[u];
        if (p < BMP) put_a(p, cl, v[u]);
      }
    }
  };
  // SRC_LOAD: a landed chunk of A, split
  auto split_a = [&](const float* r) {
    for (int i = tid; i < BMP * KC; i += PW_THREADS) {
      const int p = i / KC, k = i % KC;
      put_a(p, k, r[p * LDA + k]);
    }
  };

  // warp w owns output channels [NW w, NW w + NW): NW / 8 n-tiles
  const int n0 = warp * NW;
  const bool active = n0 < CP;
  float acc[MT][NW / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NW / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  auto mma_chunk = [&](const uint32_t* Bt) {
    if (!active) return;
#pragma unroll
    for (int ks = 0; ks < KC / 8; ++ks) {
      uint4 bfr[NW / 8];
#pragma unroll
      for (int nt = 0; nt < NW / 8; ++nt)
        bfr[nt] = *reinterpret_cast<const uint4*>(
            Bt + ((ks * (CP / 8) + n0 / 8 + nt) * 32 + lane) * 4);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t ab[4], as[4];
        ldsm_x4(ab, frag_a(Ab, LDA, mt * 16, ks * 8, lane));
        ldsm_x4(as, frag_a(As, LDA, mt * 16, ks * 8, lane));
#pragma unroll
        for (int nt = 0; nt < NW / 8; ++nt) mma3(acc[mt][nt], ab, as, bfr[nt]);
      }
    }
  };

  if (SRC == SRC_X) {
    // the block's x rows, once, zero outside the input
    for (int i = tid; i < L.xr * L.xw; i += PW_THREADS) {
      const int u = i / L.xw, v = i - u * L.xw;
      const int t = 4 * r0 - 3 + u, f = 4 * f0 - 3 + v;
      xs[i] = (t >= 0 && t < a.T && f >= 0 && f < a.F) ? a.x[((long long)b * a.T + t) * a.F + f]
                                                      : 0.f;
    }
    // weight chunk kc in buffer kc & 1: chunks 0 and 1 now, chunk kc + 1
    // once every warp is past chunk kc - 1's products
    load_b(0, 0);
    cp_async_commit();
    if (nchunks > 1) load_b(1, 1);
    cp_async_commit();
    __syncthreads();  // x has landed
    for (int kc = 0; kc < nchunks; ++kc) {
      build_s0(kc);
      __syncthreads();  // the s0 tile is in; every warp is past chunk kc - 1's products
      if (kc >= 1) {
        if (kc + 1 < nchunks) load_b(kc + 1, (kc + 1) & 1);
        cp_async_commit();
      }
      build_a(ts, kc);
      cp_async_wait<1>();
      __syncthreads();  // the A tile and chunk kc's weights are in
      mma_chunk(Bs + (kc & 1) * L.b_elems);
    }
  } else {
    if (SRC == SRC_S) load_s(0, 0);
    else load_raw(0, 0);
    load_b(0, 0);
    cp_async_commit();
    for (int kc = 0; kc < nchunks; ++kc) {
      if (kc + 1 < nchunks) {
        if (SRC == SRC_S) load_s(kc + 1, (kc + 1) & 1);
        else load_raw(kc + 1, (kc + 1) & 1);
        load_b(kc + 1, (kc + 1) & 1);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      if (SRC == SRC_S) build_a(ts + (kc & 1) * L.t_elems, kc);
      else split_a(raw + (kc & 1) * BMP * LDA);
      __syncthreads();
      mma_chunk(Bs + (kc & 1) * L.b_elems);
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
            a.out[m * a.ldo + n] = v;
            continue;
          }
          const float z = v + (n < C ? a.bias[n] : 0.f);
          if (EPI == EPI_GRAD) {
            const float gg = n < C ? a.g[m * C + n] : 0.f;
            a.out[m * a.ldo + n] = gg * act_grad(a.act, z);
            continue;
          }
          if (EPI == EPI_RECOMPUTE) a.z_out[m * CP + n] = z;
          if (n < a.ldo) a.out[m * a.ldo + n] = act_f(a.act, z);
        }
      }
    }
  }
}

// Partials of gW[k, n] = sum_m A[m, k] Gz[m, n] (and gb[n] = sum_m Gz[m, n]
// in the blocks of the first k tile) over positions [p*rows, (p+1)*rows):
// part[p] = [gW (C*C), gb (C)].  A and Gz are [M, CP]; 8 warps as 4 (32 k
// rows each) x 2 (64 n columns each) of a 128 x 128 output tile.  Each step's
// rows land by cp.async, then are split into fragment order: A^T's A
// operand (rows k, the sum over positions along the fragment's k) as
// (big, small) word arrays, one uint4 a lane and m16 x k8 tile for each;
// Gz's B operand as one uint4 a lane and k8 x n8 tile.
constexpr int WG_LANDED = WG_STAGES * 2 * WG_STEP * LDR;  // [stage][A, Gz] floats
constexpr int WG_FRAG = WG_STEP * WG_TILE;          // one tensor's split step, a half
constexpr int WG_SMEM = (WG_LANDED + 4 * WG_FRAG) * 4;

__global__ void __launch_bounds__(THREADS, 2) tc_wgrad_kernel(const float* __restrict__ A,
                                                              const float* __restrict__ Gz,
                                                              long long M, long long rows, int C,
                                                              int CP, float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* landed = reinterpret_cast<float*>(smem);                  // [stage][2][WG_STEP][LDR]
  uint32_t* Af = reinterpret_cast<uint32_t*>(smem) + WG_LANDED;    // big, then small
  uint32_t* Gf = Af + 2 * WG_FRAG;                                 // uint4 (big b0, b1, small b0, b1)
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
  auto rows_of = [&](int buf, int which) { return landed + (buf * 2 + which) * WG_STEP * LDR; };

  auto load = [&](long long ms, int buf) {
    for (int i = tid; i < 2 * WG_STEP * (WG_TILE / 4); i += THREADS) {
      const int which = i / (WG_STEP * (WG_TILE / 4));
      const int rem = i - which * (WG_STEP * (WG_TILE / 4));
      const int mm = rem / (WG_TILE / 4), q = rem % (WG_TILE / 4);
      const long long m = ms + mm;
      const int col = (which ? n0 : k0) + q * 4;
      const float* src = which ? Gz : A;
      const bool ok = m < mend && col < CP;
      cp_async16(rows_of(buf, which) + mm * LDR + q * 4, ok ? src + m * CP + col : src, ok);
    }
  };
  // a thread takes 8 neighbouring positions c of one column r: the landed
  // rows are read with banks 4 c + r (LDR = 4 mod 32), the fragments written
  // at most 2-way conflicted
  auto split_step = [&](int buf) {
    const float* ra = rows_of(buf, 0);
    const float* rg = rows_of(buf, 1);
    for (int i = tid; i < WG_STEP * WG_TILE; i += THREADS) {
      const int c = i & 7, r = (i >> 3) & (WG_TILE - 1), ks = i / (8 * WG_TILE);
      const int t = c & 3, hi = c >> 2;
      // A^T (row k = r, col = position 8 ks + c): a0..a3 are (g, t), (g+8, t), (g, t+4), (g+8, t+4)
      const int wa = ((ks * (WG_TILE / 16) + (r >> 4)) * 32 + (r & 7) * 4 + t) * 4 +
                     ((r >> 3) & 1) + 2 * hi;
      split(ra[(ks * 8 + c) * LDR + r], Af[wa], Af[WG_FRAG + wa]);
      // Gz (k = position 8 ks + c, n = r): b0 (t, g), b1 (t+4, g)
      const int wg = ((ks * (WG_TILE / 8) + (r >> 3)) * 32 + (r & 7) * 4 + t) * 4 + hi;
      split(rg[(ks * 8 + c) * LDR + r], Gf[wg], Gf[wg + 2]);
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

  // step s lands in stage s % WG_STAGES, WG_STAGES - 1 steps ahead
  const int nsteps = (int)((mend - mbeg + WG_STEP - 1) / WG_STEP);
  for (int s = 0; s < WG_STAGES - 1; ++s) {
    if (s < nsteps) load(mbeg + (long long)s * WG_STEP, s);
    cp_async_commit();
  }
  for (int s = 0; s < nsteps; ++s) {
    const int buf = s % WG_STAGES, ahead = s + WG_STAGES - 1;
    if (ahead < nsteps) load(mbeg + (long long)ahead * WG_STEP, ahead % WG_STAGES);
    cp_async_commit();
    cp_async_wait<WG_STAGES - 1>();
    __syncthreads();  // step s's rows are in; every warp is past the last step's products
    split_step(buf);
    if (bias) {
      const float* rg = rows_of(buf, 1);
#pragma unroll 8
      for (int mm = 0; mm < WG_STEP; ++mm) bsum += rg[mm * LDR + tid];
    }
    __syncthreads();  // the fragments are in
    if (active) {
#pragma unroll
      for (int ks = 0; ks < WG_STEP / 8; ++ks) {
        uint32_t ab[2][4], as[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int w = ((ks * (WG_TILE / 16) + wk * 2 + i) * 32 + lane) * 4;
          load_u4(ab[i], Af + w);
          load_u4(as[i], Af + WG_FRAG + w);
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const uint4 bf = *reinterpret_cast<const uint4*>(
              Gf + ((ks * (WG_TILE / 8) + wn * 8 + nt) * 32 + lane) * 4);
#pragma unroll
          for (int i = 0; i < 2; ++i) mma3(acc[i][nt], ab[i], as[i], bf);
        }
      }
    }
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
  const float* gd;     // gradient at the depthwise output [B, To, Fo, CP]
  const float* dw;     // depthwise weights [9, C]
  int Ti, Fi, To, Fo;  // input and output grids of the depthwise conv
  int NR, nrb, ncc;    // input rows a block (a multiple of DW_RI); row blocks and
                       // column chunks of DW_FI a batch element
  // stage 1 input (STAGE0 == false): s1 and z1 as stored, gz1 written, [M1, CP]
  const float* s_in;
  const float* z_in;
  float* gz_out;
  // stage 0 input (STAGE0 == true): s0, z0 recomputed from x
  const float* x;
  const float* k9;
  const float* b0;
  float* G;            // [M0, 9]: sum_c k9[j, c] gz0[p, c], or null
  int T, F, C, CP;
  int act;
  float* part;         // per block: STAGE0: [gk9 9C, gb0 C, gdw 9C, gbdw C]; else [gdw 9C, gbdw C]
};

__host__ __device__ inline int dw_smem(bool stage0, bool with_g, int CP) {
  int bytes = DW_GR * DW_GW * CP * 4;
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
  float* gds = reinterpret_cast<float*>(smem);                   // [DW_GR][DW_GW][CP]
  float* xs = gds + DW_GR * DW_GW * CP;                          // [DW_XR][DW_XW]
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
    w[j] = real ? a.dw[j * C + c] : 0.f;
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
    for (int i = tid; i < DW_GR * DW_GW * (CP / 4); i += THREADS) {
      const int pos = i / (CP / 4), q = i - pos * (CP / 4);
      const int u = pos / DW_GW, v = pos - u * DW_GW;
      const bool ok = ro0 + u < a.To && fo0 + v < a.Fo;
      cp_async16(gds + pos * CP + q * 4,
                 ok ? a.gd + (((long long)b * a.To + ro0 + u) * a.Fo + fo0 + v) * CP + q * 4
                    : a.gd, ok);
    }
    cp_async_commit();
    if (STAGE0) {
      for (int i = tid; i < DW_XR * DW_XW; i += THREADS) {
        const int u = i / DW_XW, v = i - u * DW_XW;
        const int t = 2 * ri0 - 1 + u, f = 2 * fi0 - 1 + v;
        xs[i] = (t >= 0 && t < a.T && f >= 0 && f < a.F) ? a.x[((long long)b * a.T + t) * a.F + f]
                                                        : 0.f;
      }
    }
    cp_async_wait<0>();
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
        const float* grow[NR];
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
                z[e] = acc;
                act_and_grad(a.act, z[e], s[e], ag[e]);
              } else {
                s[e] = a.s_in[(p + e) * CP + c];
                z[e] = a.z_in[(p + e) * CP + c];
                float unused;
                act_and_grad(a.act, z[e], unused, ag[e]);
              }
            }
            float gs[2] = {0.f, 0.f};
#pragma unroll
            for (int q = 0; q < NR; ++q) {
              const float g_lo = grow[q][(j / 2) * CP];      // column j/2
              const float g_hi = grow[q][(j / 2 + 1) * CP];  // column j/2 + 1
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
              gz[e] = gs[e] * ag[e];
              if (STAGE0) {
#pragma unroll
                for (int t = 0; t < 9; ++t) gk[t] += xt[e][t] * gz[e];
                gk0 += gz[e];
              } else {
                a.gz_out[(p + e) * CP + c] = gz[e];
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
                                                      float* __restrict__ gx) {
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
  gx[idx] = acc;
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

// The pointwise weights split into TF32 big and small parts, in the
// B-fragment order tc_pw_kernel reads: W [CP, CP] (zero past C) is pw1
// (blockIdx.y 0), pw2 (1), or the transpose of pw1 (2) or pw2 (3), W[k][n] =
// pw[n][k], for the input gradients.  Word ((ks * CP/8 + nt) * 32 + lane) * 4
// + w holds, for lane = 4 g + t, W[8 ks + t + 4 (w & 1)][8 nt + g]: big for
// w < 2, small for w >= 2.  One (k, n) element a thread.
__global__ void __launch_bounds__(THREADS) weights_kernel(const float* __restrict__ pw1,
                                                          const float* __restrict__ pw2, int C,
                                                          int CP, uint32_t* __restrict__ out,
                                                          uint32_t* __restrict__ out_t) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= CP * CP) return;
  const int h = i & 1, lane = (i >> 1) & 31, frag = i >> 6;
  const int ks = frag / (CP / 8), nt = frag - ks * (CP / 8);
  const int k = 8 * ks + (lane & 3) + 4 * h, n = 8 * nt + (lane >> 2);
  const int which = blockIdx.y;
  const float* pw = (which & 1) ? pw2 : pw1;
  const bool tr = which >= 2;
  const int row = tr ? n : k, col = tr ? k : n;
  const float v = (row < C && col < C) ? pw[row * C + col] : 0.f;
  uint32_t* o = (tr ? out_t : out) + (long long)(which & 1) * CP * CP * 2 +
                ((long long)frag * 32 + lane) * 4;
  split(v, o[h], o[2 + h]);
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
// split weights and s1; the backward's (pass 1) adds the rest.
struct Work {
  size_t pwf, s1, pwt, d1, z1, gz1, gd1, d2, gz2, gd2, G, part_pw2, part_pw1, part_dw2, part_dw1,
      total;
};

Work make_work(const Dims& d, int pass) {
  Work w = {};
  const long long C = d.C, CP = d.CP;
  const size_t weight_bytes = 2 * CP * CP * 2 * 4;  // pw1 and pw2, big and small
  size_t off = 0;
  auto take = [&](size_t bytes) { const size_t at = off; off += align256(bytes); return at; };
  w.pwf = take(weight_bytes);
  w.s1 = take(d.M1 * CP * 4);
  if (pass == 1) {
    w.pwt = take(weight_bytes);
    w.d1 = take(d.M1 * CP * 4);
    w.z1 = take(d.M1 * CP * 4);
    w.gz1 = take(d.M1 * CP * 4);
    w.gd1 = take(d.M1 * CP * 4);
    w.d2 = take(d.M2 * CP * 4);
    w.gz2 = take(d.M2 * CP * 4);
    w.gd2 = take(d.M2 * CP * 4);
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

// split weights of one product in the workspace: pw1 (stage 1) or pw2, or
// their transposes
const uint32_t* split_weights(const Dims& d, const char* work, int stage, bool transposed) {
  const Work wk = make_work(d, transposed ? 1 : 0);
  const char* base = work + (transposed ? wk.pwt : wk.pwf);
  return reinterpret_cast<const uint32_t*>(base) + (stage == 1 ? 0 : (size_t)d.CP * d.CP * 2);
}

// a stage's product: stage 1 (x -> s1) or 2 (s1 -> out), tiles of R rows x FW
// columns of the output grid
PwArgs stage_args(const Dims& d, const float* w, const char* work, int stage, int act) {
  const Pack pk = make_pack(d.C);
  PwArgs a = {};
  a.B = d.B; a.T = d.T; a.F = d.F; a.C = d.C; a.CP = d.CP;
  a.act = act;
  a.k9 = w + pk.k9;
  a.b0 = w + pk.b0;
  a.ldo = d.CP;
  a.w = split_weights(d, work, stage, false);
  if (stage == 1) {
    a.dw = w + pk.dw1; a.bias_dw = w + pk.bdw1; a.bias = w + pk.bpw1;
    a.Ti = d.T0; a.Fi = d.F0; a.To = d.T1; a.Fo = d.F1; a.M = d.M1;
  } else {
    a.dw = w + pk.dw2; a.bias_dw = w + pk.bdw2; a.bias = w + pk.bpw2;
    a.Ti = d.T1; a.Fi = d.F1; a.To = d.T2; a.Fo = d.F2; a.M = d.M2;
  }
  a.FW = a.Fo < BMP ? a.Fo : BMP;
  a.R = BMP / a.FW;
  a.nrb = (int)ceil_div(a.To, a.R);
  a.ncc = (int)ceil_div(a.Fo, a.FW);
  return a;
}

// gd = gz @ W^T for one stage's product: gz [M, CP] against the transposed
// split weights
PwArgs input_grad_args(const Dims& d, char* work, int stage, size_t gz, size_t gd, long long M) {
  PwArgs a = {};
  a.C = d.C; a.CP = d.CP; a.ldo = d.CP; a.M = M;
  a.w = split_weights(d, work, stage, true);
  a.src = reinterpret_cast<const float*>(work + gz);
  a.out = reinterpret_cast<float*>(work + gd);
  return a;
}

template <int SRC, int EPI>
cudaError_t launch_pw(const PwArgs& a, cudaStream_t stream) {
  const int smem = pw_layout(SRC, a).bytes;
  cudaError_t e = cudaFuncSetAttribute(tc_pw_kernel<SRC, EPI>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const long long blocks = SRC == SRC_LOAD ? ceil_div(a.M, BMP) : (long long)a.B * a.nrb * a.ncc;
  tc_pw_kernel<SRC, EPI><<<(unsigned)blocks, PW_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// pass 0: pw1 and pw2 split; pass 1: their transposes too
cudaError_t launch_weights(const Dims& d, const float* w, char* work, int pass,
                           cudaStream_t stream) {
  const Pack pk = make_pack(d.C);
  const Work wk = make_work(d, pass);
  weights_kernel<<<dim3((unsigned)ceil_div((long long)d.CP * d.CP, THREADS), pass == 1 ? 4 : 2),
                   THREADS, 0, stream>>>(w + pk.pw1, w + pk.pw2, d.C, d.CP,
                                         reinterpret_cast<uint32_t*>(work + wk.pwf),
                                         reinterpret_cast<uint32_t*>(work + wk.pwt));
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
  cudaError_t e = cudaFuncSetAttribute(tc_wgrad_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (e != cudaSuccess) return e;
  tc_wgrad_kernel<<<dim3(tiles * tiles, (unsigned)s.P), THREADS, WG_SMEM, stream>>>(
      reinterpret_cast<const float*>(work + A), reinterpret_cast<const float*>(work + Gz), M,
      s.rows, d.C, d.CP, p);
  e = cudaGetLastError();
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

int forward(const float* x, const Dims& d, const float* w, int act, float* out, char* work,
            cudaStream_t stream) {
  const Work wk = make_work(d, 0);
  DAE_TRY(launch_weights(d, w, work, 0, stream));
  PwArgs a = stage_args(d, w, work, 1, act);
  a.x = x;
  a.out = reinterpret_cast<float*>(work + wk.s1);
  DAE_TRY((launch_pw<SRC_X, EPI_ACT>(a, stream)));
  PwArgs b = stage_args(d, w, work, 2, act);
  b.src = reinterpret_cast<const float*>(work + wk.s1);
  b.out = out;
  b.ldo = d.C;
  DAE_TRY((launch_pw<SRC_S, EPI_ACT>(b, stream)));
  return 0;
}

int backward(const float* x, const float* g, const Dims& d, const float* w, int act, float* gx,
             float* gw, char* work, cudaStream_t stream) {
  const Pack pk = make_pack(d.C);
  const Work wk = make_work(d, 1);
  auto at = [&](size_t off) { return reinterpret_cast<float*>(work + off); };
  DAE_TRY(launch_weights(d, w, work, 1, stream));

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
  DAE_TRY((launch_pw<SRC_LOAD, EPI_PLAIN>(input_grad_args(d, work, 2, wk.gz2, wk.gd2, d.M2),
                                          stream)));
  // through depthwise 2 and the stage-1 activation: gz1; gdw2, gbdw2
  DwBwdArgs b2 = dw_split(d, d.T1, d.F1, d.T2, d.F2);
  b2.gd = at(wk.gd2); b2.dw = w + pk.dw2;
  b2.s_in = at(wk.s1); b2.z_in = at(wk.z1); b2.gz_out = at(wk.gz1);
  b2.act = act; b2.part = at(wk.part_dw2);
  DAE_TRY(launch_dw_bwd<false>(d, b2, gw + pk.dw2, stream));
  // gpw1, gbpw1
  DAE_TRY(launch_wgrad(d, work, wk.d1, wk.gz1, d.M1, wk.part_pw1, gw + pk.pw1, stream));
  // gd1 = gz1 @ pw1^T
  DAE_TRY((launch_pw<SRC_LOAD, EPI_PLAIN>(input_grad_args(d, work, 1, wk.gz1, wk.gd1, d.M1),
                                          stream)));
  // through depthwise 1, the stage-0 activation and conv: gk9, gb0, gdw1, gbdw1, G
  DwBwdArgs b1 = dw_split(d, d.T0, d.F0, d.T1, d.F1);
  b1.gd = at(wk.gd1); b1.dw = w + pk.dw1;
  b1.x = x; b1.k9 = w + pk.k9; b1.b0 = w + pk.b0;
  b1.G = gx != nullptr ? at(wk.G) : nullptr;
  b1.act = act; b1.part = at(wk.part_dw1);
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

// The f32 route: dtype 0 only (bf16 goes to fused_subsample_bf16.cu, which
// exports the same entry points).  act: 0 silu, 1 relu, 2 gelu (tanh).  w:
// the packed f32 weights (k9, b0, dw1, bdw1, pw1, bpw1, dw2, bdw2, pw2,
// bpw2).  Tensors are contiguous.  Each entry point returns a cudaError_t.

// Bytes of scratch the forward (pass 0) or the backward (pass 1) needs; -1
// for what the kernels do not take
extern "C" long long dae_fused_subsample_workspace(int dtype, int pass, int B, int T, int F,
                                                   int C) {
  if (!dims_ok(B, T, F, C) || dtype != 0 || (pass != 0 && pass != 1)) return -1;
  return (long long)make_work(make_dims(B, T, F, C), pass).total;
}

// x [B, T, F] -> out [B, T2, F2, C]; work holds the forward's workspace bytes
extern "C" int dae_fused_subsample_fwd(int dtype, int act, const void* x, int B, int T, int F,
                                       int C, const float* w, void* out, void* work,
                                       void* stream) {
  if (!dims_ok(B, T, F, C) || dtype != 0 || act < 0 || act > 2) return (int)cudaErrorInvalidValue;
  return forward(static_cast<const float*>(x), make_dims(B, T, F, C), w, act,
                 static_cast<float*>(out), static_cast<char*>(work),
                 static_cast<cudaStream_t>(stream));
}

// g [B, T2, F2, C] -> gx [B, T, F] (skipped when gx is null) and the packed
// f32 weight gradients gw; work holds the backward's workspace bytes
extern "C" int dae_fused_subsample_bwd(int dtype, int act, const void* x, const void* g, int B,
                                       int T, int F, int C, const float* w, void* gx, float* gw,
                                       void* work, void* stream) {
  if (!dims_ok(B, T, F, C) || dtype != 0 || act < 0 || act > 2) return (int)cudaErrorInvalidValue;
  return backward(static_cast<const float*>(x), static_cast<const float*>(g),
                  make_dims(B, T, F, C), w, act, static_cast<float*>(gx), gw,
                  static_cast<char*>(work), static_cast<cudaStream_t>(stream));
}

extern "C" const char* dae_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
