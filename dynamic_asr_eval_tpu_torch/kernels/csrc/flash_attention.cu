// Masked flash attention for the conformer in f32, forward and backward, on
// Hopper's tensor cores (sm_90a) with error-compensated TF32 ("3xTF32"): the
// parity route.  bf16 input goes to flash_attention_bf16.cu instead.
//
// Replaces the JAX package's kernels/attention.py:56 (`flash_attention`),
// which hands the work to JAX's Pallas TPU kernels
// (jax.experimental.pallas.ops.tpu.flash_attention: `_flash_attention_impl`
// forward, `_flash_attention_bwd_dkv` and `_flash_attention_bwd_dq` backward).
//
// What it computes.  q, k, v [B, T, H, D] f32 (any strides with a contiguous
// last dimension, rows on 16 bytes, D a multiple of 4 up to 128: the wrapper
// pads another D with zeros) and an int32 segment id per frame [B, T].  Key j
// counts for query i only when seg[i] == seg[j] (the TPU kernel's segment-id
// semantics, padding rows included); keys past T are masked by bound.
// Softmax scale 1/sqrt(D) is passed in.
//   forward : O [B, T, H, D] f32, row log-sum-exp L [B, H, T] f32
//   backward: Delta = rowsum(dO * O) (one kernel), then one launch whose
//             blocks each own a key tile (dK, dV: loop over query tiles) or
//             a query tile (dQ: loop over key tiles, recomputing S and dP).
//             P is recomputed from L.  No atomics: every output element is
//             written by one thread after a sum in a fixed order, so two runs
//             give the same bits.
// The softmax's exponentials and the log-sum-exp use expf / logf (full f32
// accuracy, as the CUDA-core kernel this replaces did); every sum is f32.
//
// Why 3xTF32.  One TF32 product keeps 10 bits of each operand's mantissa:
// ~1e-3 relative, far outside the 1e-4 this route is held to.  Each operand
// x is split where it is loaded into a fragment, big = tf32(x) and small =
// tf32(x - big), rounded as cvt.rna.tf32.f32 rounds (to nearest, ties away
// from zero), so big + small keeps ~21 bits, and every product a.b is taken
// as small_a.big_b + big_a.small_b + big_a.big_b, three
// mma.sync.m16n8k8 TF32 products into one f32 accumulator, the small terms
// first (the dropped small_a.small_b is ~2^-22 of a.b).
//
// Bound on this card.  At the flagship shape (B 2, T 2048, H 6, D 128, lengths
// 2048 and 1600) the forward's same-segment pairs need 4*D flops each: 21.4
// GFLOP, 0.32 ms at 67 TFLOP/s on the CUDA cores, 0.13 ms as three TF32
// products at 495 TFLOP/s; the backward needs 2.5x that.  ~50 MB of traffic
// (15 us at 3.35 TB/s): compute bound.
//
// Design (the bf16 kernels' design, flash_attention_bf16.cu, with TF32
// operands).
// - Tiles of 64 own rows per block, 4 warps of 16 rows each; the other side
//   streams through in steps of BN = 16 rows, double-buffered with 16-byte
//   cp.async that zero-fills rows past T and columns past D.  f32 rows are
//   padded by 4 floats (a row stride of 4 mod 32 banks): the two fragment
//   loads below then hit 32 distinct banks per warp.  Shared memory: 67.6 KB
//   forward (3 blocks per SM, all 384 blocks of the flagship in one wave),
//   101.4 KB backward (2 blocks per SM).
// - Fragments are loaded with plain 32-bit shared-memory loads (there is no
//   ldmatrix.trans for 32-bit elements).  m16n8k8 TF32 layouts, lane = 4 g
//   + t: A [16 x 8] a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4); B
//   [8 x 8] b0 (t, g), b1 (t+4, g); C [16 x 8] (g, 2t), (g, 2t+1), (g+8,
//   2t), (g+8, 2t+1).  A row-major operand with k along the row (Q, K, V, dO
//   in S, dP, and their transposes) reads addresses row*LDS + t: banks 4 g +
//   t.
// - The accumulator of one product is the A operand of the next (P and dS)
//   once the key order inside each 8-key step is permuted: A's column t
//   stands for key 2t and column t+4 for key 2t+1.  Then a = (c0, c2, c1,
//   c3) of the accumulator, and the K-major B operand (V, dO, Q, K in P.V,
//   dV, dK, dQ) is read in the same order: b0 from row 2t, b1 from row 2t+1,
//   banks 8 t + g (+ 4): no shuffles and no bank conflicts.
// - Online softmax in registers; a row's max and sum are shared by the 4
//   threads of an mma row quad.
// - Tiles that the segments rule out are skipped: a block compares the min
//   and max segment id of its own tile with those of every step of the other
//   side and visits only steps whose ranges overlap (conservative: a skipped
//   step has no matching pair).  Where both hold one segment id and the step
//   lies inside T, the per-pair mask is skipped as well.
// - What the numbers chose (flagship shape, NVIDIA H100 80GB HBM3 at 700 W,
//   kernels/attention_variants.py, forward / backward ms, SDPA in f32 0.70 /
//   1.95 in the same calls).  The kernels issue ~5 integer and f32
//   instructions per mma, most of them the operand splits, so they are bound
//   by instruction issue, not by the tensor cores:
//   - steps of 16 rows 0.79 / 2.78, of 32 rows 1.13 / 6.02 (more registers
//     than 255 in the backward, spills, and 2 blocks per SM forward, 1
//     backward);
//   - the split by cvt.rna.tf32.f32 0.79 / 2.76, by the integer rounding
//     below 0.55 / 1.87, bit for bit the same outputs (ptxas expands each cvt
//     to ~5 instructions with an inf/NaN check);
//   - under the 3-blocks-per-SM cap ptxas spills ~20 bytes a thread in the
//     D 128 forward; the backward uses 255 registers without spills.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;               // own rows of a block (queries or keys)
constexpr int BN = 16;               // rows of the other side per step
constexpr int WARPS = 4;             // a warp owns 16 rows of the block's tile
constexpr int THREADS = 32 * WARPS;
constexpr int NT_N = BN / 8;         // n-tiles (and k-steps) of 8 across a step

struct Strides {
  long long b, t, h;                 // element strides; the last dim has stride 1
};

// ---------------------------------------------------------------------------
// PTX: asynchronous copies, mma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// 4 bytes from global to shared; zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
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
// fragments: each f32 operand split into big + small TF32 parts
// ---------------------------------------------------------------------------

struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero, the
// low 13 bits zero: cvt.rna.tf32.f32's result for every finite x (and for
// inf; a NaN stays a NaN or becomes inf, and its product is NaN either way),
// in two integer instructions where ptxas expands the cvt to ~5
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = round_tf32(x);
  small = round_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ FragA make_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split(a0, f.big[0], f.small[0]);
  split(a1, f.big[1], f.small[1]);
  split(a2, f.big[2], f.small[2]);
  split(a3, f.big[3], f.small[3]);
  return f;
}

__device__ __forceinline__ FragB make_b(float b0, float b1) {
  FragB f;
  split(b0, f.big[0], f.small[0]);
  split(b1, f.big[1], f.small[1]);
  return f;
}

// c += a.b as three TF32 products, the small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, const FragB& b) {
  mma_tf32(c, a.small, b.big[0], b.big[1]);
  mma_tf32(c, a.big, b.small[0], b.small[1]);
  mma_tf32(c, a.big, b.big[0], b.big[1]);
}

// A operand, k along the row: rows [r0, r0+16) x cols [k0, k0+8) of a
// row-major tile (stride lds)
__device__ __forceinline__ FragA load_a(const float* tile, int lds, int r0, int k0, int g,
                                        int t) {
  const float* p = tile + (r0 + g) * lds + k0 + t;
  return make_a(p[0], p[8 * lds], p[4], p[8 * lds + 4]);
}

// B operand of n-tile [n0, n0+8) x k [k0, k0+8) from an N-major tile ([n][k])
__device__ __forceinline__ FragB load_b_nk(const float* tile, int lds, int n0, int k0, int g,
                                           int t) {
  const float* p = tile + (n0 + g) * lds + k0 + t;
  return make_b(p[0], p[4]);
}

// B operand of n-tile [n0, n0+8) from a K-major tile ([k][n]) in the permuted
// key order of an 8-row k-step at k0: b0 from row k0+2t, b1 from row k0+2t+1
__device__ __forceinline__ FragB load_b_kn(const float* tile, int lds, int k0, int n0, int g,
                                           int t) {
  const float* p = tile + (k0 + 2 * t) * lds + n0 + g;
  return make_b(p[0], p[lds]);
}

// the accumulator of an n-tile as the A operand of an 8-row k-step, in the
// permuted order
__device__ __forceinline__ FragA acc_as_a(const float (&c)[4]) {
  return make_a(c[0], c[2], c[1], c[3]);
}

// ---------------------------------------------------------------------------
// tiles in shared memory
// ---------------------------------------------------------------------------

template <int DP>
struct Tile {
  static constexpr int LDS = DP + 4;  // row stride, floats: 4 mod 32 banks
};

// ROWS rows [row0, row0 + ROWS) of slice (b, h) into dst; rows past T and
// columns past D are zero-filled
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, Strides s,
                                          int b, int h, int row0, int T_len, int D) {
  constexpr int CHUNKS = DP / 4;  // 16-byte chunks of a row
  static_assert(ROWS * CHUNKS % THREADS == 0, "whole chunks per thread");
  const float* base = src + (long long)b * s.b + (long long)h * s.h;
#pragma unroll
  for (int i = 0; i < ROWS * CHUNKS / THREADS; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int r = idx / CHUNKS;
    const int c = idx % CHUNKS;
    const int t = row0 + r;
    const bool ok = t < T_len && c * 4 < D;
    cp_async16(dst + r * Tile<DP>::LDS + c * 4, ok ? base + (long long)t * s.t + c * 4 : src, ok);
  }
}

// BN 4-byte values (segment ids, lse, Delta) of rows [row0, row0 + BN);
// zero past T
__device__ __forceinline__ void load_rows(void* dst, const void* __restrict__ src, int row0,
                                          int T_len) {
  const int r = threadIdx.x;
  if (r < BN) {
    const bool ok = row0 + r < T_len;
    cp_async4(static_cast<char*>(dst) + 4 * r,
              ok ? static_cast<const char*>(src) + 4ll * (row0 + r) : src, ok);
  }
}

// ---------------------------------------------------------------------------
// step skipping
// ---------------------------------------------------------------------------

__device__ __forceinline__ void warp_min_max(int& lo, int& hi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
}

constexpr uint8_t SKIP = 0, MASKED = 1, UNMASKED = 2;

// flags[j] for every step j (rows [j BN, (j+1) BN)) of the other side
// against the block's own rows [own0, own0 + BM): SKIP when their segment
// ranges do not overlap (no pair matches), UNMASKED when both hold one and
// the same id and step j lies inside T, MASKED otherwise.  Each warp takes
// every WARPS-th step, four at a time so that their loads are in flight
// together.  Ends with __syncthreads().
__device__ void build_flags(uint8_t* flags, const int32_t* __restrict__ seg_b, int own0,
                            int nsteps, int T_len) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int mlo = INT_MAX, mhi = INT_MIN;
#pragma unroll
  for (int r = lane; r < BM; r += 32) {
    const int t = own0 + r;
    if (t < T_len) {
      mlo = min(mlo, seg_b[t]);
      mhi = max(mhi, seg_b[t]);
    }
  }
  warp_min_max(mlo, mhi);
  constexpr int U = 4;
  for (int j0 = warp; j0 < nsteps; j0 += U * WARPS) {
    int lo[U], hi[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * WARPS;
      const int t = j * BN + lane;
      const bool ok = lane < BN && j < nsteps && t < T_len;
      lo[u] = ok ? seg_b[t] : INT_MAX;
      hi[u] = ok ? seg_b[t] : INT_MIN;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * WARPS;
      warp_min_max(lo[u], hi[u]);
      if (lane == 0 && j < nsteps) {
        uint8_t f = (hi[u] < mlo || lo[u] > mhi) ? SKIP : MASKED;
        if (f == MASKED && mlo == mhi && lo[u] == hi[u] && lo[u] == mlo && (j + 1) * BN <= T_len)
          f = UNMASKED;
        flags[j] = f;
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ int next_step(const uint8_t* flags, int j, int nsteps) {
  while (j < nsteps && flags[j] == SKIP) ++j;
  return j;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(THREADS, 3)
tf32x3_attention_fwd(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, Strides sq, Strides sk, Strides sv,
                     const int32_t* __restrict__ seg, float* __restrict__ o,
                     float* __restrict__ lse, int H, int T_len, int D, float scale) {
  constexpr int LDS = Tile<DP>::LDS;
  constexpr int KSTEPS = DP / 8;             // k-steps over the head dim
  constexpr int NT_D = DP / 8;               // n-tiles over the head dim
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [BM][LDS]
  float* Ks = Qs + BM * LDS;                   // [2][BN][LDS]
  float* Vs = Ks + 2 * BN * LDS;               // [2][BN][LDS]
  int* kseg = reinterpret_cast<int*>(Vs + 2 * BN * LDS);        // [2][BN]
  uint8_t* flags = reinterpret_cast<uint8_t*>(kseg + 2 * BN);  // [nsteps]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int r0 = warp * 16;
  const int nsteps = (T_len + BN - 1) / BN;
  const int32_t* seg_b = seg + (long long)b * T_len;

  load_tile<DP, BM>(Qs, q, sq, b, h, row0, T_len, D);
  cp_async_commit();
  build_flags(flags, seg_b, row0, nsteps, T_len);

  // this thread's two query rows and their segment ids
  int qseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = row0 + r0 + g + 8 * i;
    qseg[i] = t < T_len ? seg_b[t] : 0;
  }

  auto load_kv = [&](int j, int buf) {
    load_tile<DP, BN>(Ks + buf * BN * LDS, k, sk, b, h, j * BN, T_len, D);
    load_tile<DP, BN>(Vs + buf * BN * LDS, v, sv, b, h, j * BN, T_len, D);
    load_rows(kseg + buf * BN, seg_b, j * BN, T_len);
  };

  int j = next_step(flags, 0, nsteps);  // a step holding an own row is never skipped
  load_kv(j, 0);
  cp_async_commit();

  float m[2] = {-INFINITY, -INFINITY};  // running row max of the scaled scores
  float l[2] = {0.f, 0.f};              // this thread's part of the row sum
  float acc[NT_D][4];
#pragma unroll
  for (int n = 0; n < NT_D; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int buf = 0; j < nsteps; buf ^= 1) {
    const int jn = next_step(flags, j + 1, nsteps);
    if (jn < nsteps) load_kv(jn, buf ^ 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();

    const float* Kb = Ks + buf * BN * LDS;
    const float* Vb = Vs + buf * BN * LDS;
    const int* ks = kseg + buf * BN;

    // S = Q K^T, 16 queries x BN keys per warp
    float s[NT_N][4];
#pragma unroll
    for (int n = 0; n < NT_N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const FragA qa = load_a(Qs, LDS, r0, kk * 8, g, tq);
#pragma unroll
      for (int n = 0; n < NT_N; ++n) mma3(s[n], qa, load_b_nk(Kb, LDS, n * 8, kk * 8, g, tq));
    }

    // mask, online softmax (the row max of S times a positive scale is the
    // row max of the scaled S)
    const bool masked = flags[j] == MASKED;
    const int col0 = j * BN;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT_N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * tq + (e & 1);
        if (masked && !(col0 + c < T_len && ks[c] == qseg[e >> 1])) s[n][e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2], base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i] * scale);
      base[i] = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet
      alpha[i] = expf(m[i] - base[i]);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < NT_N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] * scale - base[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < NT_D; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // O += P V: P straight from the accumulators, k-steps of 8 keys
#pragma unroll
    for (int ks8 = 0; ks8 < NT_N; ++ks8) {
      const FragA pa = acc_as_a(s[ks8]);
#pragma unroll
      for (int dn = 0; dn < NT_D; ++dn) mma3(acc[dn], pa, load_b_kn(Vb, LDS, ks8 * 8, dn * 8, g, tq));
    }
    __syncthreads();  // this buffer is refilled next iteration
    j = jn;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int t = row0 + r0 + g + 8 * i;
    if (t < T_len) {
      const float inv = 1.f / l[i];
      float* orow = o + (((long long)b * T_len + t) * H + h) * D;
#pragma unroll
      for (int n = 0; n < NT_D; ++n)
        if (n * 8 + 2 * tq < D)
          *reinterpret_cast<float2*>(orow + n * 8 + 2 * tq) =
              make_float2(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
      if (tq == 0) lse[(long long)bh * T_len + t] = m[i] + logf(l[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// Delta[b, h, t] = sum_d dO * O in f32, one warp per (b, t, h) row; o and
// dout are contiguous [B, T, H, D]
__global__ void tf32x3_attention_delta(const float* __restrict__ o, const float* __restrict__ dout,
                                       float* __restrict__ delta, long long n_rows, int H,
                                       int T_len, int D) {
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;  // uniform across the warp
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc += o[row * D + d] * dout[row * D + d];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long b = row / ((long long)T_len * H);
    const long long rem = row - b * T_len * H;
    const long long t = rem / H;
    const long long h = rem - t * H;
    delta[(b * H + h) * T_len + t] = acc;
  }
}

// One block per key tile: dV = sum over query steps of P^T dO, dK of dS^T Q.
// Each warp owns 16 keys, computing S^T = K Q^T and dP^T = V dO^T, whose
// accumulators are the A operands of the dV and dK products.
template <int DP>
__device__ __forceinline__ void
dkdv_block(unsigned char* smem, int tile, const float* __restrict__ q,
           const float* __restrict__ k, const float* __restrict__ v, Strides sq, Strides sk,
           Strides sv, const float* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, const int32_t* __restrict__ seg,
           float* __restrict__ dk, float* __restrict__ dv, int H, int T_len, int D,
           float scale) {
  constexpr int LDS = Tile<DP>::LDS;
  constexpr int KSTEPS = DP / 8;
  constexpr int NT_D = DP / 8;
  float* Ks = reinterpret_cast<float*>(smem);  // [BM][LDS]
  float* Vs = Ks + BM * LDS;                   // [BM][LDS]
  float* Qs = Vs + BM * LDS;                   // [2][BN][LDS]
  float* dOs = Qs + 2 * BN * LDS;              // [2][BN][LDS]
  int* qseg = reinterpret_cast<int*>(dOs + 2 * BN * LDS);        // [2][BN]
  float* lse_s = reinterpret_cast<float*>(qseg + 2 * BN);        // [2][BN]
  float* delta_s = lse_s + 2 * BN;                               // [2][BN]
  uint8_t* flags = reinterpret_cast<uint8_t*>(delta_s + 2 * BN);  // [nsteps]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int col0 = tile * BM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int r0 = warp * 16;
  const int nsteps = (T_len + BN - 1) / BN;
  const int32_t* seg_b = seg + (long long)b * T_len;
  const long long row_base = (long long)bh * T_len;
  const Strides so = {(long long)T_len * H * D, (long long)H * D, (long long)D};

  load_tile<DP, BM>(Ks, k, sk, b, h, col0, T_len, D);
  load_tile<DP, BM>(Vs, v, sv, b, h, col0, T_len, D);
  cp_async_commit();
  build_flags(flags, seg_b, col0, nsteps, T_len);

  int kseg[2];  // this thread's two key rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = col0 + r0 + g + 8 * i;
    kseg[i] = t < T_len ? seg_b[t] : 0;
  }

  auto load_q = [&](int i, int buf) {
    load_tile<DP, BN>(Qs + buf * BN * LDS, q, sq, b, h, i * BN, T_len, D);
    load_tile<DP, BN>(dOs + buf * BN * LDS, dout, so, b, h, i * BN, T_len, D);
    load_rows(qseg + buf * BN, seg_b, i * BN, T_len);
    load_rows(lse_s + buf * BN, lse + row_base, i * BN, T_len);
    load_rows(delta_s + buf * BN, delta + row_base, i * BN, T_len);
  };

  float adk[NT_D][4], adv[NT_D][4];
#pragma unroll
  for (int n = 0; n < NT_D; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      adk[n][e] = 0.f;
      adv[n][e] = 0.f;
    }

  int i = next_step(flags, 0, nsteps);
  load_q(i, 0);
  cp_async_commit();
  for (int buf = 0; i < nsteps; buf ^= 1) {
    const int in = next_step(flags, i + 1, nsteps);
    if (in < nsteps) load_q(in, buf ^ 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();

    const float* Qb = Qs + buf * BN * LDS;
    const float* dOb = dOs + buf * BN * LDS;
    const int* qs = qseg + buf * BN;
    const float* ls = lse_s + buf * BN;
    const float* ds_ = delta_s + buf * BN;
    const bool masked = flags[i] == MASKED;
    const int row0 = i * BN;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x BN queries per warp
    float st[NT_N][4], dpt[NT_N][4];
#pragma unroll
    for (int n = 0; n < NT_N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st[n][e] = 0.f;
        dpt[n][e] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const FragA ka = load_a(Ks, LDS, r0, kk * 8, g, tq);
      const FragA va = load_a(Vs, LDS, r0, kk * 8, g, tq);
#pragma unroll
      for (int n = 0; n < NT_N; ++n) {
        mma3(st[n], ka, load_b_nk(Qb, LDS, n * 8, kk * 8, g, tq));
        mma3(dpt[n], va, load_b_nk(dOb, LDS, n * 8, kk * 8, g, tq));
      }
    }
    // P^T and dS^T = P^T (dP^T - Delta) * scale; rows keys, columns queries
#pragma unroll
    for (int n = 0; n < NT_N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * tq + (e & 1);
        float p = expf(st[n][e] * scale - ls[c]);
        if (masked && !(row0 + c < T_len && qs[c] == kseg[e >> 1])) p = 0.f;
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - ds_[c]) * scale;
      }
    // dV += P^T dO and dK += dS^T Q, k-steps of 8 queries
#pragma unroll
    for (int ks8 = 0; ks8 < NT_N; ++ks8) {
      const FragA pa = acc_as_a(st[ks8]);
      const FragA da = acc_as_a(dpt[ks8]);
#pragma unroll
      for (int dn = 0; dn < NT_D; ++dn) {
        mma3(adv[dn], pa, load_b_kn(dOb, LDS, ks8 * 8, dn * 8, g, tq));
        mma3(adk[dn], da, load_b_kn(Qb, LDS, ks8 * 8, dn * 8, g, tq));
      }
    }
    __syncthreads();
    i = in;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = col0 + r0 + g + 8 * r;
    if (t < T_len) {
      const long long off = (((long long)b * T_len + t) * H + h) * D;
#pragma unroll
      for (int n = 0; n < NT_D; ++n)
        if (n * 8 + 2 * tq < D) {
          *reinterpret_cast<float2*>(dk + off + n * 8 + 2 * tq) =
              make_float2(adk[n][2 * r], adk[n][2 * r + 1]);
          *reinterpret_cast<float2*>(dv + off + n * 8 + 2 * tq) =
              make_float2(adv[n][2 * r], adv[n][2 * r + 1]);
        }
    }
  }
}

// One block per query tile: dQ = sum over key steps of dS K, recomputing
// S = Q K^T and dP = dO V^T.
template <int DP>
__device__ __forceinline__ void
dq_block(unsigned char* smem, int tile, const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, Strides sq, Strides sk, Strides sv,
         const float* __restrict__ dout, const float* __restrict__ lse,
         const float* __restrict__ delta, const int32_t* __restrict__ seg,
         float* __restrict__ dq, int H, int T_len, int D, float scale) {
  constexpr int LDS = Tile<DP>::LDS;
  constexpr int KSTEPS = DP / 8;
  constexpr int NT_D = DP / 8;
  float* Qs = reinterpret_cast<float*>(smem);  // [BM][LDS]
  float* dOs = Qs + BM * LDS;                  // [BM][LDS]
  float* Ks = dOs + BM * LDS;                  // [2][BN][LDS]
  float* Vs = Ks + 2 * BN * LDS;               // [2][BN][LDS]
  int* kseg = reinterpret_cast<int*>(Vs + 2 * BN * LDS);        // [2][BN]
  uint8_t* flags = reinterpret_cast<uint8_t*>(kseg + 2 * BN);  // [nsteps]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int row0 = tile * BM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int r0 = warp * 16;
  const int nsteps = (T_len + BN - 1) / BN;
  const int32_t* seg_b = seg + (long long)b * T_len;
  const long long row_base = (long long)bh * T_len;
  const Strides so = {(long long)T_len * H * D, (long long)H * D, (long long)D};

  load_tile<DP, BM>(Qs, q, sq, b, h, row0, T_len, D);
  load_tile<DP, BM>(dOs, dout, so, b, h, row0, T_len, D);
  cp_async_commit();
  build_flags(flags, seg_b, row0, nsteps, T_len);

  int qseg[2];  // this thread's two query rows
  float lse_r[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = row0 + r0 + g + 8 * i;
    const bool ok = t < T_len;
    qseg[i] = ok ? seg_b[t] : 0;
    lse_r[i] = ok ? lse[row_base + t] : 0.f;
    dlt[i] = ok ? delta[row_base + t] : 0.f;
  }

  auto load_kv = [&](int j, int buf) {
    load_tile<DP, BN>(Ks + buf * BN * LDS, k, sk, b, h, j * BN, T_len, D);
    load_tile<DP, BN>(Vs + buf * BN * LDS, v, sv, b, h, j * BN, T_len, D);
    load_rows(kseg + buf * BN, seg_b, j * BN, T_len);
  };

  float adq[NT_D][4];
#pragma unroll
  for (int n = 0; n < NT_D; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[n][e] = 0.f;

  int j = next_step(flags, 0, nsteps);
  load_kv(j, 0);
  cp_async_commit();
  for (int buf = 0; j < nsteps; buf ^= 1) {
    const int jn = next_step(flags, j + 1, nsteps);
    if (jn < nsteps) load_kv(jn, buf ^ 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();

    const float* Kb = Ks + buf * BN * LDS;
    const float* Vb = Vs + buf * BN * LDS;
    const int* ks = kseg + buf * BN;
    const bool masked = flags[j] == MASKED;
    const int col0 = j * BN;

    // S = Q K^T and dP = dO V^T: 16 queries x BN keys per warp
    float s[NT_N][4], dp[NT_N][4];
#pragma unroll
    for (int n = 0; n < NT_N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = 0.f;
        dp[n][e] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const FragA qa = load_a(Qs, LDS, r0, kk * 8, g, tq);
      const FragA oa = load_a(dOs, LDS, r0, kk * 8, g, tq);
#pragma unroll
      for (int n = 0; n < NT_N; ++n) {
        mma3(s[n], qa, load_b_nk(Kb, LDS, n * 8, kk * 8, g, tq));
        mma3(dp[n], oa, load_b_nk(Vb, LDS, n * 8, kk * 8, g, tq));
      }
    }
    // dS = P (dP - Delta) * scale, kept in s
#pragma unroll
    for (int n = 0; n < NT_N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * tq + (e & 1);
        float p = expf(s[n][e] * scale - lse_r[e >> 1]);
        if (masked && !(col0 + c < T_len && ks[c] == qseg[e >> 1])) p = 0.f;
        s[n][e] = p * (dp[n][e] - dlt[e >> 1]) * scale;
      }
    // dQ += dS K, k-steps of 8 keys
#pragma unroll
    for (int ks8 = 0; ks8 < NT_N; ++ks8) {
      const FragA da = acc_as_a(s[ks8]);
#pragma unroll
      for (int dn = 0; dn < NT_D; ++dn) mma3(adq[dn], da, load_b_kn(Kb, LDS, ks8 * 8, dn * 8, g, tq));
    }
    __syncthreads();
    j = jn;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + r0 + g + 8 * r;
    if (t < T_len) {
      float* row = dq + (((long long)b * T_len + t) * H + h) * D;
#pragma unroll
      for (int n = 0; n < NT_D; ++n)
        if (n * 8 + 2 * tq < D)
          *reinterpret_cast<float2*>(row + n * 8 + 2 * tq) =
              make_float2(adq[n][2 * r], adq[n][2 * r + 1]);
    }
  }
}

// The backward's two kernels as one launch: blocks [0, ntiles) of a grid row
// own a key tile (dK, dV), blocks [ntiles, 2 ntiles) a query tile (dQ).  The
// two halves need nothing from each other, and twice the blocks fill the
// card's last wave better than two launches in turn.
template <int DP>
__global__ void __launch_bounds__(THREADS, 2)
tf32x3_attention_bwd(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, Strides sq, Strides sk, Strides sv,
                     const float* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, const int32_t* __restrict__ seg,
                     float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                     int H, int T_len, int D, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ntiles = (T_len + BM - 1) / BM;
  if ((int)blockIdx.x < ntiles)
    dkdv_block<DP>(smem, blockIdx.x, q, k, v, sq, sk, sv, dout, lse, delta, seg, dk, dv, H, T_len,
                   D, scale);
  else
    dq_block<DP>(smem, blockIdx.x - ntiles, q, k, v, sq, sk, sv, dout, lse, delta, seg, dq, H,
                 T_len, D, scale);
}

// shared memory of each kernel: f32 tiles, 4-byte row values, the flags (the
// backward's dK/dV blocks need more than its dQ blocks)
template <int DP>
size_t fwd_smem(int nsteps) {
  return (BM + 4 * BN) * Tile<DP>::LDS * 4 + 2 * BN * 4 + nsteps;
}
template <int DP>
size_t bwd_smem(int nsteps) {
  return (2 * BM + 4 * BN) * Tile<DP>::LDS * 4 + 6 * BN * 4 + nsteps;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int DP>
int launch_fwd(const float* q, const float* k, const float* v, Strides sq, Strides sk,
               Strides sv, const int32_t* seg, float* o, float* lse, int B, int H, int T_len,
               int D, float scale, cudaStream_t st) {
  const int ntiles = (T_len + BM - 1) / BM;
  const size_t smem = fwd_smem<DP>((T_len + BN - 1) / BN);
  cudaError_t e = prepare(tf32x3_attention_fwd<DP>, smem);
  if (e != cudaSuccess) return (int)e;
  tf32x3_attention_fwd<DP><<<dim3(ntiles, B * H), THREADS, smem, st>>>(
      q, k, v, sq, sk, sv, seg, o, lse, H, T_len, D, scale);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_bwd(const float* q, const float* k, const float* v, Strides sq, Strides sk,
               Strides sv, const int32_t* seg, const float* o, const float* dout,
               const float* lse, float* delta, float* dq, float* dk, float* dv, int B, int H,
               int T_len, int D, float scale, cudaStream_t st) {
  const long long n_rows = (long long)B * T_len * H;
  const int rows_per_block = 8;
  const unsigned delta_blocks = (unsigned)((n_rows + rows_per_block - 1) / rows_per_block);
  tf32x3_attention_delta<<<delta_blocks, 32 * rows_per_block, 0, st>>>(
      o, dout, delta, n_rows, H, T_len, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const int ntiles = (T_len + BM - 1) / BM;
  const size_t smem = bwd_smem<DP>((T_len + BN - 1) / BN);
  if ((e = prepare(tf32x3_attention_bwd<DP>, smem)) != cudaSuccess) return (int)e;
  tf32x3_attention_bwd<DP><<<dim3(2 * ntiles, B * H), THREADS, smem, st>>>(
      q, k, v, sq, sk, sv, dout, lse, delta, seg, dq, dk, dv, H, T_len, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Strides are element strides of the batch, time and head dimensions; q, k,
// v rows start on 16 bytes.  The head dim is padded with zeros in shared
// memory to 32, 64 or 128.  Returns a cudaError_t (0 on success).
extern "C" int dae_flash_attention_fwd(const float* q, const float* k, const float* v,
                                       long long sqb, long long sqt, long long sqh,
                                       long long skb, long long skt, long long skh,
                                       long long svb, long long svt, long long svh,
                                       const int32_t* seg, float* o, float* lse, int B,
                                       int H, int T_len, int D, float scale, void* stream) {
  if (D < 4 || D > 128 || D % 4) return (int)cudaErrorInvalidValue;
  const Strides sq = {sqb, sqt, sqh}, sk = {skb, skt, skh}, sv = {svb, svt, svh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 32) return launch_fwd<32>(q, k, v, sq, sk, sv, seg, o, lse, B, H, T_len, D, scale, st);
  if (D <= 64) return launch_fwd<64>(q, k, v, sq, sk, sv, seg, o, lse, B, H, T_len, D, scale, st);
  return launch_fwd<128>(q, k, v, sq, sk, sv, seg, o, lse, B, H, T_len, D, scale, st);
}

// o and dout are contiguous [B, T, H, D] (rows on 16 bytes); dq, dk, dv are
// written contiguous [B, T, H, D]; delta is f32 scratch [B, H, T].
extern "C" int dae_flash_attention_bwd(const float* q, const float* k, const float* v,
                                       long long sqb, long long sqt, long long sqh,
                                       long long skb, long long skt, long long skh,
                                       long long svb, long long svt, long long svh,
                                       const int32_t* seg, const float* o,
                                       const float* dout, const float* lse, float* delta,
                                       float* dq, float* dk, float* dv, int B, int H,
                                       int T_len, int D, float scale, void* stream) {
  if (D < 4 || D > 128 || D % 4) return (int)cudaErrorInvalidValue;
  const Strides sq = {sqb, sqt, sqh}, sk = {skb, skt, skh}, sv = {svb, svt, svh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    return launch_bwd<32>(q, k, v, sq, sk, sv, seg, o, dout, lse, delta, dq, dk, dv, B, H, T_len,
                          D, scale, st);
  if (D <= 64)
    return launch_bwd<64>(q, k, v, sq, sk, sv, seg, o, dout, lse, delta, dq, dk, dv, B, H, T_len,
                          D, scale, st);
  return launch_bwd<128>(q, k, v, sq, sk, sv, seg, o, dout, lse, delta, dq, dk, dv, B, H, T_len, D,
                         scale, st);
}

extern "C" const char* dae_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
