// Masked flash attention for the conformer in bf16, forward and backward, on
// Hopper's tensor cores (sm_90a): the main path's route.  f32 input goes to
// the CUDA-core kernels of flash_attention.cu instead.
//
// Replaces the JAX package's kernels/attention.py:56 (`flash_attention`),
// which hands the work to JAX's Pallas TPU kernels
// (jax.experimental.pallas.ops.tpu.flash_attention: `_flash_attention_impl`
// forward, `_flash_attention_bwd_dkv` and `_flash_attention_bwd_dq` backward).
//
// What it computes.  q, k, v [B, T, H, D] bf16 (any strides with a contiguous
// last dimension, rows on 16 bytes, D a multiple of 8 up to 128) and an int32
// segment id per frame [B, T].  Key j counts for query i only when seg[i] ==
// seg[j] (the TPU kernel's segment-id semantics, padding rows included); keys
// past T are masked by bound.  Softmax scale 1/sqrt(D) is passed in.
// A query block (sequence parallelism): q may hold only rows [q_off, q_off +
// Tq) of the Tk frames that k, v and seg cover; the forward gives those rows,
// the backward their dQ and their share of dK, dV over all Tk keys (a sum
// over the blocks gives the whole).  Each tile's rows and the tiles it
// visits are those of the whole call when q_off is a multiple of 64, so the
// block's O, L and dQ rows are then the whole call's bit for bit.
//   forward : O [B, T, H, D] bf16, row log-sum-exp L [B, H, T] f32
//   backward: Delta = rowsum(dO * O) (one kernel), then one launch whose
//             blocks each own a key tile (dK, dV: loop over query tiles) or
//             a query tile (dQ: loop over key tiles, recomputing S and dP).
//             P is recomputed from L.  No atomics: every output element is
//             written by one thread after a sum in a fixed order, so two runs
//             give the same bits.
// It rounds where the TPU kernel rounds: P (unnormalised, against the running
// row max) to bf16 before P.V; in the backward P before dV and dS (scale
// included) before dK and dQ.  Every sum accumulates in f32.
//
// Bound on this card.  At the flagship shape (B 2, T 2048, H 6, D 128) the
// forward over all pairs is 4*B*H*T^2*D = 25.8 GFLOP: 26 us at 989 TFLOP/s
// (bf16 dense), against ~13 MB of traffic (4 us at 3.35 TB/s).  Compute
// bound; the backward is 2.5x (3.5x with the dQ blocks' recompute).
//
// Design.
// - Every product on the tensor cores with mma.sync.m16n8k16 (bf16 in, f32
//   accumulators): S = QK^T and O += PV forward; S, dP = dO V^T, dV += P^T dO,
//   dK += dS^T Q and dQ += dS K backward.  mma.sync and not wgmma because its
//   f32 accumulator layout is the layout of its A operand: P and dS go from
//   the registers that computed them, rounded to bf16, straight into the next
//   product without a trip through shared memory, and a warp owns 16 rows,
//   so the softmax, the masks and the rounding stay per thread.  Operands
//   come from shared memory through ldmatrix (.trans for V, dO and Q where
//   they are the K-major B operand).  wgmma (64-row warpgroup tiles, operands
//   through shared-memory descriptors, B read once per warpgroup instead of
//   once per warp), TMA and warp specialisation are the next step towards
//   the bound.
// - Tiles of 64 rows, 4 warps of 16 rows each, staged in shared memory as
//   bf16 rows padded by 16 bytes (the 8 row addresses of an ldmatrix phase
//   fall on 8 distinct 4-bank groups: no bank conflicts), loaded with 16-byte
//   cp.async that zero-fills rows past T and columns past D, double-buffered
//   so that the next tile's copy overlaps this tile's products.  The owned
//   tile is loaded once per block.
// - Filling the card: at the flagship shape the forward has 384 blocks.  Q
//   is held in registers and staged in the second V buffer, so a block needs
//   69 KB of shared memory and the register cap of 3 blocks per SM (168) is
//   set: all 384 blocks run in one wave on 132 SMs.  At D 128 ptxas spills
//   ~120 bytes a thread under that cap; they stay because on the H100 the
//   capped kernel ran faster than one with 2 blocks per SM and no spills,
//   and a forward that took the softmax 32 keys at a time to free registers
//   still spilled and was no faster.  The backward's dK/dV and dQ blocks
//   (104 KB, 2 per SM) share one launch of 768 blocks: 2.9 waves instead of
//   two launches of 1.45, which ran slower.
// - Online softmax in registers with exp2 (ex2.approx) and scale*log2(e)
//   folded in; a row's max and sum are shared by the 4 threads of an mma
//   row quad.
// - Tiles that the segments rule out are skipped: a block compares the min
//   and max segment id of its own tile with those of every tile of the other
//   side and visits only tiles whose ranges overlap (conservative: a skipped
//   tile has no matching pair).  Where both tiles hold one segment id and the
//   other tile lies inside T, the per-pair mask is skipped as well.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 64;               // rows of a tile, queries and keys alike
constexpr int WARPS = 4;             // a warp owns 16 rows of the block's tile
constexpr int THREADS = 32 * WARPS;
constexpr int NT_ROWS = BM / 8;      // n-tiles of 8 across a 64-row tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Strides {
  long long b, t, h;                 // element strides; the last dim has stride 1
};

// ---------------------------------------------------------------------------
// PTX: asynchronous copies, ldmatrix, mma, exp2
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

// 2^x by the special-function unit, denormal results flushed to 0 (P below
// 2^-126 is 0 in every product that follows); exp2(-inf) = 0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// fragments
//
// mma.m16n8k16 layouts, lane = 4 g + t: an accumulator tile [16 x 8] holds
// (row g, cols 2t, 2t+1) in c[0], c[1] and (row g+8, same cols) in c[2],
// c[3]; an A operand [16 x 16] holds (row g | g+8, cols 2t, 2t+1 | 2t+8,
// 2t+9) as bf16 pairs a[0] = (g, lo), a[1] = (g+8, lo), a[2] = (g, hi),
// a[3] = (g+8, hi).  So two accumulator tiles side by side (16 x 16) are
// one A operand once rounded: `pack_a`.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// A operand: rows [r0, r0+16) x cols [k0, k0+16) of a row-major tile
// (stride lds); also the B operand of two n-tiles [n0, n0+16) when the
// tile is K-major ([k][n]) and read with ldsm_x4_trans: r = n-tile n0's
// (b0, b1) in r[0], r[1] and n0+8's in r[2], r[3]
__device__ __forceinline__ const bf16* frag_a(const bf16* tile, int lds, int r0, int k0,
                                              int lane) {
  return tile + (r0 + (lane & 15)) * lds + k0 + (lane >> 4) * 8;
}

// B operand of two n-tiles [n0, n0+16) x k [k0, k0+16) from an N-major
// tile ([n][k], row-major): r[0], r[1] for n-tile n0, r[2], r[3] for n0+8
__device__ __forceinline__ const bf16* frag_b(const bf16* tile, int lds, int n0, int k0,
                                              int lane) {
  return tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * lds + k0 + ((lane >> 3) & 1) * 8;
}

// ---------------------------------------------------------------------------
// tiles in shared memory
// ---------------------------------------------------------------------------

template <int DP>
struct Tile {
  static constexpr int LDS = DP + 8;          // row stride, elements (16 bytes of padding)
  static constexpr int ELEMS = BM * LDS;
  static constexpr int BYTES = ELEMS * 2;
};

// rows [row0, row0 + BM) of slice (b, h) into dst; rows past T and columns
// past D are zero-filled
template <int DP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, Strides s,
                                          int b, int h, int row0, int T_len, int D) {
  constexpr int CHUNKS = DP / 8;              // 16-byte chunks of a row
  const bf16* base = src + (long long)b * s.b + (long long)h * s.h;
#pragma unroll
  for (int i = 0; i < BM * CHUNKS / THREADS; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int r = idx / CHUNKS;
    const int c = idx % CHUNKS;
    const int t = row0 + r;
    const bool ok = t < T_len && c * 8 < D;
    cp_async16(dst + r * Tile<DP>::LDS + c * 8, ok ? base + (long long)t * s.t + c * 8 : src, ok);
  }
}

// BM 4-byte values (segment ids, lse, Delta) of rows [row0, row0 + BM);
// zero past T
__device__ __forceinline__ void load_rows(void* dst, const void* __restrict__ src, int row0,
                                          int T_len) {
  const int r = threadIdx.x;
  if (r < BM) {
    const bool ok = row0 + r < T_len;
    cp_async4(static_cast<char*>(dst) + 4 * r,
              ok ? static_cast<const char*>(src) + 4ll * (row0 + r) : src, ok);
  }
}

// ---------------------------------------------------------------------------
// tile skipping
// ---------------------------------------------------------------------------

__device__ __forceinline__ void warp_min_max(int& lo, int& hi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
}

// min and max segment id over rows [r0, r1) of one tile, r1 - r0 <= BM
// (one warp)
__device__ __forceinline__ int2 row_range(const int32_t* __restrict__ seg_b, int r0, int r1) {
  const int lane = threadIdx.x & 31;
  int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
  for (int r = lane; r < BM; r += 32) {
    const int t = r0 + r;
    if (t < r1) {
      lo = min(lo, seg_b[t]);
      hi = max(hi, seg_b[t]);
    }
  }
  warp_min_max(lo, hi);
  return make_int2(lo, hi);
}

constexpr uint8_t SKIP = 0, MASKED = 1, UNMASKED = 2;

// flags[j] for every tile j of the other side (rows [j BM, (j+1) BM) of
// other_seg, other_len rows) against the block's own rows [own0, own1) of
// own_seg: SKIP when their segment ranges do not overlap (no pair matches),
// UNMASKED when both hold one and the same id and tile j lies inside
// other_len, MASKED otherwise.  Each warp takes every WARPS-th tile, four at
// a time so that their loads are in flight together.  Ends with
// __syncthreads().
__device__ void build_flags(uint8_t* flags, const int32_t* __restrict__ own_seg, int own0,
                            int own1, const int32_t* __restrict__ other_seg, int ntiles,
                            int other_len) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int2 mine = row_range(own_seg, own0, own1);
  constexpr int U = 4;
  for (int j0 = warp; j0 < ntiles; j0 += U * WARPS) {
    int lo[U], hi[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * WARPS;
      lo[u] = INT_MAX;
      hi[u] = INT_MIN;
#pragma unroll
      for (int r = lane; r < BM; r += 32) {
        const int t = j * BM + r;
        if (j < ntiles && t < other_len) {
          lo[u] = min(lo[u], other_seg[t]);
          hi[u] = max(hi[u], other_seg[t]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * WARPS;
      warp_min_max(lo[u], hi[u]);
      if (lane == 0 && j < ntiles) {
        uint8_t f = (hi[u] < mine.x || lo[u] > mine.y) ? SKIP : MASKED;
        if (f == MASKED && mine.x == mine.y && lo[u] == hi[u] && lo[u] == mine.x &&
            (j + 1) * BM <= other_len)
          f = UNMASKED;
        flags[j] = f;
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ int next_tile(const uint8_t* flags, int j, int ntiles) {
  while (j < ntiles && flags[j] == SKIP) ++j;
  return j;
}

__device__ __forceinline__ void store_bf16x2(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(THREADS, 3)
tc_attention_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, Strides sq, Strides sk, Strides sv,
                 const int32_t* __restrict__ seg, bf16* __restrict__ o, float* __restrict__ lse,
                 int H, int Tq, int Tk, int q_off, int D, float scale_log2) {
  constexpr int LDS = Tile<DP>::LDS;
  constexpr int KSTEPS = DP / 16;            // k-steps over the head dim
  constexpr int NT_D = DP / 8;               // n-tiles over the head dim
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [2][BM][LDS]
  bf16* Vs = Ks + 2 * Tile<DP>::ELEMS;       // [2][BM][LDS]
  bf16* Qs = Vs + Tile<DP>::ELEMS;           // Q is staged in V's second buffer
  int* kseg = reinterpret_cast<int*>(Vs + 2 * Tile<DP>::ELEMS);  // [2][BM]
  uint8_t* flags = reinterpret_cast<uint8_t*>(kseg + 2 * BM);    // [ntiles]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int ntiles = (Tk + BM - 1) / BM;
  const int32_t* seg_b = seg + (long long)b * Tk;

  load_tile<DP>(Qs, q, sq, b, h, row0, Tq, D);
  cp_async_commit();
  build_flags(flags, seg_b, q_off + row0, q_off + min(row0 + BM, Tq), seg_b, ntiles, Tk);

  // this thread's two query rows and their segment ids
  int qseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = row0 + warp * 16 + g + 8 * i;
    qseg[i] = t < Tq ? seg_b[q_off + t] : 0;
  }

  auto load_kv = [&](int j, int buf) {
    load_tile<DP>(Ks + buf * Tile<DP>::ELEMS, k, sk, b, h, j * BM, Tk, D);
    load_tile<DP>(Vs + buf * Tile<DP>::ELEMS, v, sv, b, h, j * BM, Tk, D);
    load_rows(kseg + buf * BM, seg_b, j * BM, Tk);
  };

  // a tile holding an own row's key is never skipped (q_off + Tq <= Tk)
  int j = next_tile(flags, 0, ntiles);
  load_kv(j, 0);
  cp_async_commit();
  cp_async_wait_1();  // Q has landed
  __syncthreads();
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) ldsm_x4(qf[kk], frag_a(Qs, LDS, warp * 16, kk * 16, lane));
  __syncthreads();  // Q's buffer is free for the second K/V tile

  float m[2] = {-INFINITY, -INFINITY};  // running row max, log2 domain
  float l[2] = {0.f, 0.f};              // this thread's part of the row sum
  float acc[NT_D][4];
#pragma unroll
  for (int n = 0; n < NT_D; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int buf = 0; j < ntiles; buf ^= 1) {
    const int jn = next_tile(flags, j + 1, ntiles);
    if (jn < ntiles) load_kv(jn, buf ^ 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();

    const bf16* Kb = Ks + buf * Tile<DP>::ELEMS;
    const bf16* Vb = Vs + buf * Tile<DP>::ELEMS;
    const int* ks = kseg + buf * BM;

    // S = Q K^T, 16 queries x 64 keys per warp
    float s[NT_ROWS][4];
#pragma unroll
    for (int n = 0; n < NT_ROWS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int np = 0; np < NT_ROWS / 2; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, frag_b(Kb, LDS, np * 16, kk * 16, lane));
        mma_bf16(s[2 * np], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // mask, online softmax in the log2 domain (the row max of S times a
    // positive scale is the row max of the scaled S)
    const bool masked = flags[j] == MASKED;
    const int col0 = j * BM;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT_ROWS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * tq + (e & 1);
        if (masked && !(col0 + c < Tk && ks[c] == qseg[e >> 1])) s[n][e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2], base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i] * scale_log2);
      base[i] = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet
      alpha[i] = fast_exp2(m[i] - base[i]);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < NT_ROWS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(fmaf(s[n][e], scale_log2, -base[e >> 1]));
        s[n][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < NT_D; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // O += P V: P rounded to bf16 straight from the accumulators
#pragma unroll
    for (int ks16 = 0; ks16 < NT_ROWS / 2; ++ks16) {
      uint32_t pa[4];
      pack_a(pa, s[2 * ks16], s[2 * ks16 + 1]);
#pragma unroll
      for (int dp = 0; dp < NT_D / 2; ++dp) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, frag_a(Vb, LDS, ks16 * 16, dp * 16, lane));
        mma_bf16(acc[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this buffer is refilled next iteration
    j = jn;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int t = row0 + warp * 16 + g + 8 * i;
    if (t < Tq) {
      const float inv = 1.f / l[i];
      bf16* orow = o + (((long long)b * Tq + t) * H + h) * D;
#pragma unroll
      for (int n = 0; n < NT_D; ++n)
        if (n * 8 < D)
          store_bf16x2(orow + n * 8 + 2 * tq, acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
      if (tq == 0) lse[(long long)bh * Tq + t] = m[i] * LN2 + logf(l[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// Delta[b, h, t] = sum_d dO * O in f32, one warp per (b, t, h) row; o and
// dout are contiguous [B, T, H, D]
__global__ void tc_attention_delta(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                                   float* __restrict__ delta, long long n_rows, int H, int T_len,
                                   int D) {
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;  // uniform across the warp
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc += __bfloat162float(o[row * D + d]) * __bfloat162float(dout[row * D + d]);
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

// One block per key tile: dV = sum over query tiles of P^T dO, dK of dS^T Q.
// Each warp owns 16 keys and works through a query tile in two halves of 32
// queries, computing S^T = K Q^T and dP^T = V dO^T, whose accumulators are
// the A operands of the dV and dK products.
template <int DP>
__device__ __forceinline__ void
dkdv_block(unsigned char* smem, int tile, const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, Strides sq, Strides sk, Strides sv,
           const bf16* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, const int32_t* __restrict__ seg, bf16* __restrict__ dk,
           bf16* __restrict__ dv, int H, int Tq, int Tk, int q_off, int D, float scale,
           float scale_log2) {
  constexpr int LDS = Tile<DP>::LDS;
  constexpr int KSTEPS = DP / 16;
  constexpr int NT_D = DP / 8;
  constexpr int HALF = BM / 2;               // queries per pass
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [BM][LDS]
  bf16* Vs = Ks + Tile<DP>::ELEMS;           // [BM][LDS]
  bf16* Qs = Vs + Tile<DP>::ELEMS;           // [2][BM][LDS]
  bf16* dOs = Qs + 2 * Tile<DP>::ELEMS;      // [2][BM][LDS]
  int* qseg = reinterpret_cast<int*>(dOs + 2 * Tile<DP>::ELEMS);  // [2][BM]
  float* lse_s = reinterpret_cast<float*>(qseg + 2 * BM);         // [2][BM]
  float* delta_s = lse_s + 2 * BM;                                // [2][BM]
  uint8_t* flags = reinterpret_cast<uint8_t*>(delta_s + 2 * BM);  // [ntiles]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int col0 = tile * BM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int ntiles = (Tq + BM - 1) / BM;     // query tiles
  const int32_t* seg_b = seg + (long long)b * Tk;
  const int32_t* seg_q = seg_b + q_off;      // the query rows' segment ids
  const long long row_base = (long long)bh * Tq;
  const Strides so = {(long long)Tq * H * D, (long long)H * D, (long long)D};

  load_tile<DP>(Ks, k, sk, b, h, col0, Tk, D);
  load_tile<DP>(Vs, v, sv, b, h, col0, Tk, D);
  cp_async_commit();
  build_flags(flags, seg_b, col0, min(col0 + BM, Tk), seg_q, ntiles, Tq);

  int kseg[2];  // this thread's two key rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = col0 + warp * 16 + g + 8 * i;
    kseg[i] = t < Tk ? seg_b[t] : 0;
  }

  auto load_q = [&](int i, int buf) {
    load_tile<DP>(Qs + buf * Tile<DP>::ELEMS, q, sq, b, h, i * BM, Tq, D);
    load_tile<DP>(dOs + buf * Tile<DP>::ELEMS, dout, so, b, h, i * BM, Tq, D);
    load_rows(qseg + buf * BM, seg_q, i * BM, Tq);
    load_rows(lse_s + buf * BM, lse + row_base, i * BM, Tq);
    load_rows(delta_s + buf * BM, delta + row_base, i * BM, Tq);
  };

  float adk[NT_D][4], adv[NT_D][4];
#pragma unroll
  for (int n = 0; n < NT_D; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      adk[n][e] = 0.f;
      adv[n][e] = 0.f;
    }

  // a key tile outside the query block's segments visits no tile (dK, dV 0)
  int i = next_tile(flags, 0, ntiles);
  if (i < ntiles) load_q(i, 0);
  cp_async_commit();
  for (int buf = 0; i < ntiles; buf ^= 1) {
    const int in = next_tile(flags, i + 1, ntiles);
    if (in < ntiles) load_q(in, buf ^ 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();

    const bf16* Qb = Qs + buf * Tile<DP>::ELEMS;
    const bf16* dOb = dOs + buf * Tile<DP>::ELEMS;
    const int* qs = qseg + buf * BM;
    const float* ls = lse_s + buf * BM;
    const float* ds_ = delta_s + buf * BM;
    const bool masked = flags[i] == MASKED;
    const int row0 = i * BM;

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q0 = half * HALF;
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 queries per warp
      float st[HALF / 8][4], dpt[HALF / 8][4];
#pragma unroll
      for (int n = 0; n < HALF / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[n][e] = 0.f;
          dpt[n][e] = 0.f;
        }
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t ka[4], va[4];
        ldsm_x4(ka, frag_a(Ks, LDS, warp * 16, kk * 16, lane));
        ldsm_x4(va, frag_a(Vs, LDS, warp * 16, kk * 16, lane));
#pragma unroll
        for (int np = 0; np < HALF / 16; ++np) {
          uint32_t qb[4], ob[4];
          ldsm_x4(qb, frag_b(Qb, LDS, q0 + np * 16, kk * 16, lane));
          ldsm_x4(ob, frag_b(dOb, LDS, q0 + np * 16, kk * 16, lane));
          mma_bf16(st[2 * np], ka, qb[0], qb[1]);
          mma_bf16(st[2 * np + 1], ka, qb[2], qb[3]);
          mma_bf16(dpt[2 * np], va, ob[0], ob[1]);
          mma_bf16(dpt[2 * np + 1], va, ob[2], ob[3]);
        }
      }
      // P^T and dS^T = P^T (dP^T - Delta) * scale; rows keys, columns queries
#pragma unroll
      for (int n = 0; n < HALF / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = q0 + n * 8 + 2 * tq + (e & 1);
          float p = fast_exp2(st[n][e] * scale_log2 - ls[c] * LOG2E);
          if (masked && !(row0 + c < Tq && qs[c] == kseg[e >> 1])) p = 0.f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - ds_[c]) * scale;
        }
      // dV += P^T dO and dK += dS^T Q, k-steps of 16 queries
#pragma unroll
      for (int ks16 = 0; ks16 < HALF / 16; ++ks16) {
        uint32_t pa[4], da[4];
        pack_a(pa, st[2 * ks16], st[2 * ks16 + 1]);
        pack_a(da, dpt[2 * ks16], dpt[2 * ks16 + 1]);
#pragma unroll
        for (int dp = 0; dp < NT_D / 2; ++dp) {
          uint32_t ob[4], qb[4];
          ldsm_x4_trans(ob, frag_a(dOb, LDS, q0 + ks16 * 16, dp * 16, lane));
          ldsm_x4_trans(qb, frag_a(Qb, LDS, q0 + ks16 * 16, dp * 16, lane));
          mma_bf16(adv[2 * dp], pa, ob[0], ob[1]);
          mma_bf16(adv[2 * dp + 1], pa, ob[2], ob[3]);
          mma_bf16(adk[2 * dp], da, qb[0], qb[1]);
          mma_bf16(adk[2 * dp + 1], da, qb[2], qb[3]);
        }
      }
    }
    __syncthreads();
    i = in;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = col0 + warp * 16 + g + 8 * r;
    if (t < Tk) {
      const long long off = (((long long)b * Tk + t) * H + h) * D;
#pragma unroll
      for (int n = 0; n < NT_D; ++n)
        if (n * 8 < D) {
          store_bf16x2(dk + off + n * 8 + 2 * tq, adk[n][2 * r], adk[n][2 * r + 1]);
          store_bf16x2(dv + off + n * 8 + 2 * tq, adv[n][2 * r], adv[n][2 * r + 1]);
        }
    }
  }
}

// One block per query tile: dQ = sum over key tiles of dS K, recomputing
// S = Q K^T and dP = dO V^T.
template <int DP>
__device__ __forceinline__ void
dq_block(unsigned char* smem, int tile, const bf16* __restrict__ q, const bf16* __restrict__ k,
         const bf16* __restrict__ v, Strides sq, Strides sk, Strides sv,
         const bf16* __restrict__ dout, const float* __restrict__ lse,
         const float* __restrict__ delta, const int32_t* __restrict__ seg, bf16* __restrict__ dq,
         int H, int Tq, int Tk, int q_off, int D, float scale, float scale_log2) {
  constexpr int LDS = Tile<DP>::LDS;
  constexpr int KSTEPS = DP / 16;
  constexpr int NT_D = DP / 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [BM][LDS]
  bf16* dOs = Qs + Tile<DP>::ELEMS;          // [BM][LDS]
  bf16* Ks = dOs + Tile<DP>::ELEMS;          // [2][BM][LDS]
  bf16* Vs = Ks + 2 * Tile<DP>::ELEMS;       // [2][BM][LDS]
  int* kseg = reinterpret_cast<int*>(Vs + 2 * Tile<DP>::ELEMS);  // [2][BM]
  uint8_t* flags = reinterpret_cast<uint8_t*>(kseg + 2 * BM);    // [ntiles]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int row0 = tile * BM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int ntiles = (Tk + BM - 1) / BM;     // key tiles
  const int32_t* seg_b = seg + (long long)b * Tk;
  const long long row_base = (long long)bh * Tq;
  const Strides so = {(long long)Tq * H * D, (long long)H * D, (long long)D};

  load_tile<DP>(Qs, q, sq, b, h, row0, Tq, D);
  load_tile<DP>(dOs, dout, so, b, h, row0, Tq, D);
  cp_async_commit();
  build_flags(flags, seg_b, q_off + row0, q_off + min(row0 + BM, Tq), seg_b, ntiles, Tk);

  int qseg[2];        // this thread's two query rows
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = row0 + warp * 16 + g + 8 * i;
    const bool ok = t < Tq;
    qseg[i] = ok ? seg_b[q_off + t] : 0;
    lse2[i] = ok ? lse[row_base + t] * LOG2E : 0.f;
    dlt[i] = ok ? delta[row_base + t] : 0.f;
  }

  auto load_kv = [&](int j, int buf) {
    load_tile<DP>(Ks + buf * Tile<DP>::ELEMS, k, sk, b, h, j * BM, Tk, D);
    load_tile<DP>(Vs + buf * Tile<DP>::ELEMS, v, sv, b, h, j * BM, Tk, D);
    load_rows(kseg + buf * BM, seg_b, j * BM, Tk);
  };

  float adq[NT_D][4];
#pragma unroll
  for (int n = 0; n < NT_D; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[n][e] = 0.f;

  int j = next_tile(flags, 0, ntiles);
  load_kv(j, 0);
  cp_async_commit();
  for (int buf = 0; j < ntiles; buf ^= 1) {
    const int jn = next_tile(flags, j + 1, ntiles);
    if (jn < ntiles) load_kv(jn, buf ^ 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();

    const bf16* Kb = Ks + buf * Tile<DP>::ELEMS;
    const bf16* Vb = Vs + buf * Tile<DP>::ELEMS;
    const int* ks = kseg + buf * BM;
    const bool masked = flags[j] == MASKED;
    const int col0 = j * BM;

    // S = Q K^T and dP = dO V^T: 16 queries x 64 keys per warp
    float s[NT_ROWS][4], dp[NT_ROWS][4];
#pragma unroll
    for (int n = 0; n < NT_ROWS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = 0.f;
        dp[n][e] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t qa[4], oa[4];
      ldsm_x4(qa, frag_a(Qs, LDS, warp * 16, kk * 16, lane));
      ldsm_x4(oa, frag_a(dOs, LDS, warp * 16, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < NT_ROWS / 2; ++np) {
        uint32_t kb[4], vb[4];
        ldsm_x4(kb, frag_b(Kb, LDS, np * 16, kk * 16, lane));
        ldsm_x4(vb, frag_b(Vb, LDS, np * 16, kk * 16, lane));
        mma_bf16(s[2 * np], qa, kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
        mma_bf16(dp[2 * np], oa, vb[0], vb[1]);
        mma_bf16(dp[2 * np + 1], oa, vb[2], vb[3]);
      }
    }
    // dS = P (dP - Delta) * scale, kept in s
#pragma unroll
    for (int n = 0; n < NT_ROWS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * tq + (e & 1);
        float p = fast_exp2(s[n][e] * scale_log2 - lse2[e >> 1]);
        if (masked && !(col0 + c < Tk && ks[c] == qseg[e >> 1])) p = 0.f;
        s[n][e] = p * (dp[n][e] - dlt[e >> 1]) * scale;
      }
    // dQ += dS K, k-steps of 16 keys
#pragma unroll
    for (int ks16 = 0; ks16 < NT_ROWS / 2; ++ks16) {
      uint32_t da[4];
      pack_a(da, s[2 * ks16], s[2 * ks16 + 1]);
#pragma unroll
      for (int dd = 0; dd < NT_D / 2; ++dd) {
        uint32_t kb[4];
        ldsm_x4_trans(kb, frag_a(Kb, LDS, ks16 * 16, dd * 16, lane));
        mma_bf16(adq[2 * dd], da, kb[0], kb[1]);
        mma_bf16(adq[2 * dd + 1], da, kb[2], kb[3]);
      }
    }
    __syncthreads();
    j = jn;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + warp * 16 + g + 8 * r;
    if (t < Tq) {
      bf16* row = dq + (((long long)b * Tq + t) * H + h) * D;
#pragma unroll
      for (int n = 0; n < NT_D; ++n)
        if (n * 8 < D) store_bf16x2(row + n * 8 + 2 * tq, adq[n][2 * r], adq[n][2 * r + 1]);
    }
  }
}

// The backward's two kernels as one launch: blocks [0, ntk) of a grid row
// own a key tile (dK, dV), blocks [ntk, ntk + ntq) a query tile (dQ).  The
// two halves need nothing from each other, and twice the blocks fill the
// card's last wave better than two launches in turn.
template <int DP>
__global__ void __launch_bounds__(THREADS, 2)
tc_attention_bwd(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                 Strides sq, Strides sk, Strides sv, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const int32_t* __restrict__ seg, bf16* __restrict__ dq, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int H, int Tq, int Tk, int q_off, int D, float scale,
                 float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ntk = (Tk + BM - 1) / BM;
  if ((int)blockIdx.x < ntk)
    dkdv_block<DP>(smem, blockIdx.x, q, k, v, sq, sk, sv, dout, lse, delta, seg, dk, dv, H, Tq, Tk,
                   q_off, D, scale, scale_log2);
  else
    dq_block<DP>(smem, blockIdx.x - ntk, q, k, v, sq, sk, sv, dout, lse, delta, seg, dq, H, Tq, Tk,
                 q_off, D, scale, scale_log2);
}

// shared memory of each kernel: bf16 tiles, 4-byte row values, the flags
// (the backward's dK/dV blocks need more than its dQ blocks)
template <int DP>
size_t fwd_smem(int ntiles) {
  return 4 * Tile<DP>::BYTES + 2 * BM * 4 + ntiles;
}
template <int DP>
size_t bwd_smem(int ntiles) {
  return 6 * Tile<DP>::BYTES + 6 * BM * 4 + ntiles;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int DP>
int launch_fwd(const bf16* q, const bf16* k, const bf16* v, Strides sq, Strides sk, Strides sv,
               const int32_t* seg, bf16* o, float* lse, int B, int H, int Tq, int Tk, int q_off,
               int D, float scale, cudaStream_t st) {
  const int ntq = (Tq + BM - 1) / BM;
  const size_t smem = fwd_smem<DP>((Tk + BM - 1) / BM);
  cudaError_t e = prepare(tc_attention_fwd<DP>, smem);
  if (e != cudaSuccess) return (int)e;
  tc_attention_fwd<DP><<<dim3(ntq, B * H), THREADS, smem, st>>>(
      q, k, v, sq, sk, sv, seg, o, lse, H, Tq, Tk, q_off, D, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_bwd(const bf16* q, const bf16* k, const bf16* v, Strides sq, Strides sk, Strides sv,
               const int32_t* seg, const bf16* o, const bf16* dout, const float* lse,
               float* delta, bf16* dq, bf16* dk, bf16* dv, int B, int H, int Tq, int Tk,
               int q_off, int D, float scale, cudaStream_t st) {
  const long long n_rows = (long long)B * Tq * H;
  const int rows_per_block = 8;
  tc_attention_delta<<<(unsigned)((n_rows + rows_per_block - 1) / rows_per_block),
                     32 * rows_per_block, 0, st>>>(o, dout, delta, n_rows, H, Tq, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const int ntq = (Tq + BM - 1) / BM, ntk = (Tk + BM - 1) / BM;
  const size_t smem = bwd_smem<DP>(ntq > ntk ? ntq : ntk);
  if ((e = prepare(tc_attention_bwd<DP>, smem)) != cudaSuccess) return (int)e;
  tc_attention_bwd<DP><<<dim3(ntk + ntq, B * H), THREADS, smem, st>>>(
      q, k, v, sq, sk, sv, dout, lse, delta, seg, dq, dk, dv, H, Tq, Tk, q_off, D, scale,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

// the query block's rows [q_off, q_off + Tq) lie inside the Tk keys
bool bad_shape(int Tq, int Tk, int q_off) {
  return Tq < 1 || Tk < 1 || q_off < 0 || q_off + Tq > Tk;
}

}  // namespace

// q [B, Tq, H, D] holds rows [q_off, q_off + Tq) of a sequence whose keys
// k, v are [B, Tk, H, D] and whose segment ids seg are [B, Tk]; Tq == Tk
// with q_off 0 is the whole sequence.  Strides are element strides of the
// batch, time and head dimensions; q, k, v rows start on 16 bytes.  The head
// dim is padded with zeros in shared memory to 32, 64 or 128.  o [B, Tq, H,
// D] and lse [B, H, Tq] are written contiguous.  Returns a cudaError_t (0 on
// success).
extern "C" int dae_flash_attention_fwd(const bf16* q, const bf16* k, const bf16* v,
                                       long long sqb, long long sqt, long long sqh,
                                       long long skb, long long skt, long long skh,
                                       long long svb, long long svt, long long svh,
                                       const int32_t* seg, bf16* o, float* lse, int B,
                                       int H, int Tq, int Tk, int q_off, int D, float scale,
                                       void* stream) {
  if (D < 8 || D > 128 || D % 8 || bad_shape(Tq, Tk, q_off)) return (int)cudaErrorInvalidValue;
  const Strides sq = {sqb, sqt, sqh}, sk = {skb, skt, skh}, sv = {svb, svt, svh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    return launch_fwd<32>(q, k, v, sq, sk, sv, seg, o, lse, B, H, Tq, Tk, q_off, D, scale, st);
  if (D <= 64)
    return launch_fwd<64>(q, k, v, sq, sk, sv, seg, o, lse, B, H, Tq, Tk, q_off, D, scale, st);
  return launch_fwd<128>(q, k, v, sq, sk, sv, seg, o, lse, B, H, Tq, Tk, q_off, D, scale, st);
}

// o and dout are contiguous [B, Tq, H, D] (dout's rows on 16 bytes); dq
// [B, Tq, H, D] and dk, dv [B, Tk, H, D] are written contiguous: dk, dv are
// this query block's share of the keys' gradients; delta is f32 scratch
// [B, H, Tq].
extern "C" int dae_flash_attention_bwd(const bf16* q, const bf16* k, const bf16* v,
                                       long long sqb, long long sqt, long long sqh,
                                       long long skb, long long skt, long long skh,
                                       long long svb, long long svt, long long svh,
                                       const int32_t* seg, const bf16* o,
                                       const bf16* dout, const float* lse, float* delta,
                                       bf16* dq, bf16* dk, bf16* dv, int B, int H, int Tq,
                                       int Tk, int q_off, int D, float scale, void* stream) {
  if (D < 8 || D > 128 || D % 8 || bad_shape(Tq, Tk, q_off)) return (int)cudaErrorInvalidValue;
  const Strides sq = {sqb, sqt, sqh}, sk = {skb, skt, skh}, sv = {svb, svt, svh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    return launch_bwd<32>(q, k, v, sq, sk, sv, seg, o, dout, lse, delta, dq, dk, dv, B, H, Tq, Tk,
                          q_off, D, scale, st);
  if (D <= 64)
    return launch_bwd<64>(q, k, v, sq, sk, sv, seg, o, dout, lse, delta, dq, dk, dv, B, H, Tq, Tk,
                          q_off, D, scale, st);
  return launch_bwd<128>(q, k, v, sq, sk, sv, seg, o, dout, lse, delta, dq, dk, dv, B, H, Tq, Tk,
                         q_off, D, scale, st);
}

extern "C" const char* dae_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
