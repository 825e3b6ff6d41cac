// Masked flash attention for the conformer in f32, forward and backward, for
// sm_90a: the CUDA-core route.  bf16 input goes to the tensor-core kernels of
// flash_attention_bf16.cu instead; this file serves f32, the parity route,
// where TF32 tensor cores could not meet the 1e-4 agreement it is held to.
//
// Replaces the JAX package's kernels/attention.py:56 (`flash_attention`),
// which hands the work to JAX's Pallas TPU kernels
// (jax.experimental.pallas.ops.tpu.flash_attention: `_flash_attention_impl`
// forward, `_flash_attention_bwd_dkv` and `_flash_attention_bwd_dq` backward).
//
// What it computes.  q, k, v [B, T, H, D] f32 (any strides with a contiguous
// last dimension) and an int32 segment id per frame [B, T] (valid = 1, pad =
// 0).  Key j counts for query i only when seg[i] == seg[j] (the TPU kernel's
// segment-id semantics, padding rows included).  Keys past T are masked by
// bound.  Softmax scale is passed in (1/sqrt(D)).
//   forward : O [B, T, H, D], row log-sum-exp L [B, H, T]
//   backward: Delta = rowsum(dO * O); dK, dV (one block per key tile, loop
//             over query tiles); dQ (one block per query tile, loop over key
//             tiles).  P is recomputed from L.  No atomics: every output
//             element is written by exactly one thread, so results are the
//             same in every run.
//
// Bound on this card.  At the flagship shape (B 2, T 2048, H 6, D 128) the
// forward is 4*B*H*T^2*D = 25.8 GFLOP: 0.39 ms at 67 TFLOP/s, the f32 rate
// outside the tensor cores, against ~50 MB of traffic (15 us at 3.35 TB/s):
// compute bound.  The backward is about 2.5x the forward.
//
// Design.  Correct and simple: tiles of 64 queries x 64 keys staged in shared
// memory (rows padded to D+1 floats so that the 16 threads of a half-warp
// reading 16 different rows hit 16 different banks), every product on
// CUDA-core FMAs, online softmax with a running max and sum per row in
// registers.  256 threads; a thread owns a 4x4 block of the score tile and a
// 4 x (D/16) block of the output tile.  It never holds the [B, H, T, T]
// matrix in device memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;            // rows per tile (queries and keys alike)
constexpr int MAX_D = 128;
constexpr int LD = MAX_D + 1;     // padded shared-memory row stride, floats
constexpr int LDP = BM + 1;       // padded stride of the score tiles
constexpr int THREADS = 256;
constexpr int DPT = MAX_D / 16;   // output columns per thread

struct Strides {
  long long b, t, h;              // element strides; the last dim has stride 1
};

// rows [row0, row0 + BM) of slice (b, h) into dst [BM][LD]; rows past T are 0
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, Strides s,
                                          int b, int h, int row0, int T_len, int D) {
  for (int idx = threadIdx.x; idx < BM * D; idx += THREADS) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int t = row0 + r;
    float x = 0.f;
    if (t < T_len) x = src[(long long)b * s.b + (long long)t * s.t + (long long)h * s.h + d];
    dst[r * LD + d] = x;
  }
}

// segment ids of rows [row0, row0 + BM); rows past T get `oob`
__device__ __forceinline__ void load_seg(int* dst, const int32_t* __restrict__ seg, int b,
                                         int row0, int T_len, int oob) {
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    const int t = row0 + r;
    dst[r] = t < T_len ? seg[(long long)b * T_len + t] : oob;
  }
}

// per-row f32 values (log-sum-exp, Delta) of rows [row0, row0 + BM)
__device__ __forceinline__ void load_row_vals(float* dst, const float* __restrict__ src,
                                              long long base, int row0, int T_len) {
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    const int t = row0 + r;
    dst[r] = t < T_len ? src[base + t] : 0.f;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// s[i][j] = A[ty + 16 i] . B[tx + 16 j] over d < D, A and B tiles [BM][LD]
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* A, const float* Bt,
                                         int tx, int ty, int D) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bb[j] = Bt[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           Strides sq, Strides sk, Strides sv, const int32_t* __restrict__ seg,
           float* __restrict__ o, float* __restrict__ lse, int H, int T_len, int D, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BM * LD;
  float* Vs = Ks + BM * LD;
  float* Ps = Vs + BM * LD;
  int* qseg = reinterpret_cast<int*>(Ps + BM * LDP);
  int* kseg = qseg + BM;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int row0 = blockIdx.x * BM;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile(Qs, q, sq, b, h, row0, T_len, D);
  load_seg(qseg, seg, b, row0, T_len, -2);

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  for (int col0 = 0; col0 < T_len; col0 += BM) {
    __syncthreads();  // the previous tile's Ks, Vs, Ps are no longer read
    load_tile(Ks, k, sk, b, h, col0, T_len, D);
    load_tile(Vs, v, sv, b, h, col0, T_len, D);
    load_seg(kseg, seg, b, col0, T_len, -1);
    __syncthreads();

    float s[4][4];
    tile_dot(s, Qs, Ks, tx, ty, D);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = qseg[r] == kseg[tx + 16 * j];
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = (m_new == -INFINITY) ? 1.f : expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (s[i][j] == -INFINITY) ? 0.f : expf(s[i][j] - m_new);
        Ps[r * LDP + tx + 16 * j] = p;
        rs += p;
      }
      rs = half_warp_sum(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < BM; ++c) {
      float vb[DPT];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = tx + 16 * j;
        vb[j] = d < D ? Vs[c * LD + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty + 16 * i) * LDP + c];
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(p, vb[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = row0 + ty + 16 * i;
    if (t < T_len) {
      const float inv = 1.f / l[i];
      float* orow = o + (((long long)b * T_len + t) * H + h) * D;
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = tx + 16 * j;
        if (d < D) orow[d] = acc[i][j] * inv;
      }
      if (tx == 0) lse[(long long)bh * T_len + t] = m[i] + logf(l[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// Delta[b, h, t] = sum_d dO * O, one warp per (b, t, h) row; o and dout are
// contiguous [B, T, H, D]
__global__ void bwd_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                                 float* __restrict__ delta, long long n_rows, int H, int T_len,
                                 int D) {
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

__global__ void __launch_bounds__(THREADS)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v,
                Strides sq, Strides sk, Strides sv, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int32_t* __restrict__ seg, float* __restrict__ dk, float* __restrict__ dv,
                int H,
                int T_len, int D, float scale) {
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BM * LD;
  float* Qs = Vs + BM * LD;
  float* dOs = Qs + BM * LD;
  float* Ps = dOs + BM * LD;
  float* dSs = Ps + BM * LDP;
  float* lse_s = dSs + BM * LDP;
  float* delta_s = lse_s + BM;
  int* kseg = reinterpret_cast<int*>(delta_s + BM);
  int* qseg = kseg + BM;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int col0 = blockIdx.x * BM;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const Strides so = {(long long)T_len * H * D, (long long)H * D, (long long)D};
  const long long row_base = (long long)bh * T_len;

  load_tile(Ks, k, sk, b, h, col0, T_len, D);
  load_tile(Vs, v, sv, b, h, col0, T_len, D);
  load_seg(kseg, seg, b, col0, T_len, -1);

  float adk[4][DPT], adv[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      adk[i][j] = 0.f;
      adv[i][j] = 0.f;
    }

  for (int row0 = 0; row0 < T_len; row0 += BM) {
    __syncthreads();
    load_tile(Qs, q, sq, b, h, row0, T_len, D);
    load_tile(dOs, dout, so, b, h, row0, T_len, D);
    load_seg(qseg, seg, b, row0, T_len, -2);
    load_row_vals(lse_s, lse, row_base, row0, T_len);
    load_row_vals(delta_s, delta, row_base, row0, T_len);
    __syncthreads();

    // rows: queries ty + 16 i; columns: keys tx + 16 j
    float s[4][4], dp[4][4];
    tile_dot(s, Qs, Ks, tx, ty, D);
    tile_dot(dp, dOs, Vs, tx, ty, D);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = qseg[r] == kseg[c] ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        Ps[r * LDP + c] = p;
        dSs[r * LDP + c] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();

    // rows: keys ty + 16 i; columns: head dim tx + 16 j
    for (int r = 0; r < BM; ++r) {
      float pa[4], da[4], ob[DPT], qb[DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = Ps[r * LDP + ty + 16 * i];
        da[i] = dSs[r * LDP + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = tx + 16 * j;
        ob[j] = d < D ? dOs[r * LD + d] : 0.f;
        qb[j] = d < D ? Qs[r * LD + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          adv[i][j] = fmaf(pa[i], ob[j], adv[i][j]);
          adk[i][j] = fmaf(da[i], qb[j], adk[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = col0 + ty + 16 * i;
    if (t < T_len) {
      const long long off = (((long long)b * T_len + t) * H + h) * D;
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          dk[off + d] = adk[i][j] * scale;
          dv[off + d] = adv[i][j];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
              Strides sq, Strides sk, Strides sv, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int32_t* __restrict__ seg, float* __restrict__ dq, int H, int T_len, int D,
              float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BM * LD;
  float* Ks = dOs + BM * LD;
  float* Vs = Ks + BM * LD;
  float* dSs = Vs + BM * LD;
  float* lse_s = dSs + BM * LDP;
  float* delta_s = lse_s + BM;
  int* qseg = reinterpret_cast<int*>(delta_s + BM);
  int* kseg = qseg + BM;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int row0 = blockIdx.x * BM;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const Strides so = {(long long)T_len * H * D, (long long)H * D, (long long)D};
  const long long row_base = (long long)bh * T_len;

  load_tile(Qs, q, sq, b, h, row0, T_len, D);
  load_tile(dOs, dout, so, b, h, row0, T_len, D);
  load_seg(qseg, seg, b, row0, T_len, -2);
  load_row_vals(lse_s, lse, row_base, row0, T_len);
  load_row_vals(delta_s, delta, row_base, row0, T_len);

  float adq[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) adq[i][j] = 0.f;

  for (int col0 = 0; col0 < T_len; col0 += BM) {
    __syncthreads();
    load_tile(Ks, k, sk, b, h, col0, T_len, D);
    load_tile(Vs, v, sv, b, h, col0, T_len, D);
    load_seg(kseg, seg, b, col0, T_len, -1);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot(s, Qs, Ks, tx, ty, D);
    tile_dot(dp, dOs, Vs, tx, ty, D);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = qseg[r] == kseg[c] ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        dSs[r * LDP + c] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();

    for (int c = 0; c < BM; ++c) {
      float kb[DPT];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = tx + 16 * j;
        kb[j] = d < D ? Ks[c * LD + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = dSs[(ty + 16 * i) * LDP + c];
#pragma unroll
        for (int j = 0; j < DPT; ++j) adq[i][j] = fmaf(ds, kb[j], adq[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = row0 + ty + 16 * i;
    if (t < T_len) {
      float* row = dq + (((long long)b * T_len + t) * H + h) * D;
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = tx + 16 * j;
        if (d < D) row[d] = adq[i][j] * scale;
      }
    }
  }
}

constexpr size_t kFwdSmem = (3 * BM * LD + BM * LDP) * sizeof(float) + 2 * BM * sizeof(int);
constexpr size_t kDkdvSmem =
    (4 * BM * LD + 2 * BM * LDP + 2 * BM) * sizeof(float) + 2 * BM * sizeof(int);
constexpr size_t kDqSmem =
    (4 * BM * LD + BM * LDP + 2 * BM) * sizeof(float) + 2 * BM * sizeof(int);

}  // namespace

// Strides are element strides of the batch, time and head dimensions.
// Returns a cudaError_t (0 on success).
extern "C" int dae_flash_attention_fwd(const float* q, const float* k, const float* v,
                                       long long sqb, long long sqt, long long sqh,
                                       long long skb, long long skt, long long skh,
                                       long long svb, long long svt, long long svh,
                                       const int32_t* seg, float* o, float* lse, int B,
                                       int H, int T_len, int D, float scale, void* stream) {
  if (D < 1 || D > MAX_D) return (int)cudaErrorInvalidValue;
  const Strides sq = {sqb, sqt, sqh}, sk = {skb, skt, skh}, sv = {svb, svt, svh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kFwdSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T_len + BM - 1) / BM, B * H);
  fwd_kernel<<<grid, THREADS, kFwdSmem, st>>>(q, k, v, sq, sk, sv, seg, o, lse, H, T_len, D,
                                              scale);
  return (int)cudaGetLastError();
}

// o and dout are contiguous [B, T, H, D]; dq, dk, dv are written contiguous
// [B, T, H, D]; delta is f32 scratch [B, H, T].
extern "C" int dae_flash_attention_bwd(const float* q, const float* k, const float* v,
                                       long long sqb, long long sqt, long long sqh,
                                       long long skb, long long skt, long long skh,
                                       long long svb, long long svt, long long svh,
                                       const int32_t* seg, const float* o,
                                       const float* dout, const float* lse, float* delta,
                                       float* dq, float* dk, float* dv, int B, int H,
                                       int T_len, int D, float scale, void* stream) {
  if (D < 1 || D > MAX_D) return (int)cudaErrorInvalidValue;
  const Strides sq = {sqb, sqt, sqh}, sk = {skb, skt, skh}, sv = {svb, svt, svh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_rows = (long long)B * T_len * H;
  const int rows_per_block = 8;
  bwd_delta_kernel<<<(unsigned)((n_rows + rows_per_block - 1) / rows_per_block),
                     32 * rows_per_block, 0, st>>>(o, dout, delta, n_rows, H, T_len, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(bwd_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kDkdvSmem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kDqSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T_len + BM - 1) / BM, B * H);
  bwd_dkdv_kernel<<<grid, THREADS, kDkdvSmem, st>>>(q, k, v, sq, sk, sv, dout, lse, delta, seg,
                                                    dk, dv, H, T_len, D, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bwd_dq_kernel<<<grid, THREADS, kDqSmem, st>>>(q, k, v, sq, sk, sv, dout, lse, delta, seg, dq, H,
                                                T_len, D, scale);
  return (int)cudaGetLastError();
}

extern "C" const char* dae_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
