// Fused x8 dw-striding subsampling stack, forward and backward, for sm_90a,
// on CUDA cores: the f32 (parity) route.  bf16 input goes to the
// tensor-core kernels of fused_subsample_bf16.cu instead.
//
// Replaces the JAX package's kernels/subsample.py: `fused_subsample`
// (:504-529), whose forward is the Pallas call `_fwd_pallas` (:278-300,
// body `_fwd_kernel` :239) and whose backward is `_bwd_pallas` (:438-485,
// body `_bwd_kernel` :333) under `_fused_bwd` (:532-566).
//
// What it computes.  x [B, T, F] (F % 8 == 0) in the compute type T (the
// kernels are templates on it; the entry points take f32); weights f32 in
// the JAX layouts, packed into one buffer (see `Pack`): k9, dw1, dw2 [9, C]
// with (dt, df) row-major, pw1, pw2 [C_in, C_out], biases [C].  Every 3x3
// conv has stride 2 and padding (1, 1); there are no masks between stages
// (the TPU kernel's semantics):
//   s0 = act(conv3x3(x; k9) + b0)                      [B, T0, F0, C]
//   d1 = dwconv3x3(s0; dw1) + bdw1;  s1 = act(d1 @ pw1 + bpw1)   [B, T1, F1, C]
//   d2 = dwconv3x3(s1; dw2) + bdw2;  out = act(d2 @ pw2 + bpw2)  [B, T2, F2, C]
// with T_{k+1} = ceil(T_k / 2), F0 = F/2, F1 = F/4, F2 = F/8.  Every sum is
// taken in f32 and rounded to T where `_tile_forward` (:201-231) rounds:
// after stage 0, after each depthwise conv, after each pointwise product and
// again after its bias, after each activation (run in f32); the depthwise and
// pointwise weights and biases are rounded to T first, k9 and b0 stay f32.
//
// Bound on this card.  At the flagship window (B 2, T 16384, F 80, C 256)
// the forward is ~30.8 GFLOP, 26.9 of them in the two pointwise products,
// and must move ~26 MB (x in, out written): ~31 us at 989 TFLOP/s bf16,
// bound by operations.  The backward is ~93 GFLOP (~94 us).
//
// Design.  Right and simple first, CUDA-core FMAs accumulated in f32:
// - `pw_kernel`: one block per 32 positions x all C output channels.  The
//   block first builds its A tile [32, C] in shared memory: the depthwise
//   conv of the previous stage, computed on the fly (for stage 1 straight
//   from x, recomputing each stage-0 value it reads, so s0 never reaches
//   device memory), then multiplies it by the pointwise weights streamed
//   through shared memory in chunks of 32 rows, and applies bias and
//   activation in registers.  The forward is two launches of it: x -> s1
//   (the one stage tensor in device memory), s1 -> out.
// - The backward recomputes the forward: the same kernel re-runs stage 1
//   (keeping d1, z1, s1) and stage 2 (keeping d2 and writing
//   gz2 = g * act'(z2)).  Input gradients of the pointwise products are the
//   same kernel on the transposed weights.  The depthwise and stage-0
//   gradients are gathers (`dw_bwd_kernel`): each input element sums the
//   taps that read it, so every element has one writer; gx likewise
//   (`gx_kernel`).  Weight gradients are reductions over every position:
//   each block writes f32 partials over a fixed range of positions and
//   `reduce_kernel` sums them in a fixed order.  No atomics: runs repeat
//   bit for bit.
// TF32 tensor cores could not hold the f32 route to its parity bars.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_C = 256;
constexpr int THREADS = 256;
constexpr int BM = 32;             // positions per pw_kernel block
constexpr int BK = 32;             // weight rows per shared-memory chunk
constexpr int NCOL = MAX_C / 32;   // output columns per thread in pw_kernel
constexpr int WG_TILE = 64;        // wgrad_kernel output tile (k and n)
constexpr int WG_ROWS = 1024;      // positions per wgrad_kernel partial
constexpr int WG_STEP = 32;        // positions per shared-memory step
constexpr int DW_POS = 256;        // positions per dw_bwd_kernel partial
constexpr int DW_BATCH = 32;       // positions per G reduction batch

enum Act { SILU = 0, RELU = 1, GELU = 2 };
enum Src { SRC_X = 0, SRC_S = 1, SRC_LOAD = 2 };
enum Epi { EPI_ACT = 0, EPI_RECOMPUTE = 1, EPI_GRAD = 2, EPI_PLAIN = 3 };

struct Dims {
  int B, T, F, C;
  int T0, F0, T1, F1, T2, F2;
  long long M0, M1, M2;            // positions of s0, s1, out
};

Dims make_dims(int B, int T, int F, int C) {
  Dims d;
  d.B = B; d.T = T; d.F = F; d.C = C;
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

__host__ __device__ Pack make_pack(int C) {
  const long long c = C, cc = (long long)C * C;
  Pack p;
  p.k9 = 0; p.b0 = 9 * c; p.dw1 = 10 * c; p.bdw1 = 19 * c; p.pw1 = 20 * c;
  p.bpw1 = 20 * c + cc; p.dw2 = 21 * c + cc; p.bdw2 = 30 * c + cc; p.pw2 = 31 * c + cc;
  p.bpw2 = 31 * c + 2 * cc; p.total = 32 * c + 2 * cc;
  return p;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// round an f32 value to T and back
template <typename T> __device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

constexpr float GELU_C = 0.7978845608028654f;  // sqrt(2 / pi)

__device__ __forceinline__ float act_f(int act, float z) {
  if (act == SILU) return z * (1.f / (1.f + expf(-z)));
  if (act == RELU) return fmaxf(z, 0.f);
  // tanh approximation, as jax.nn.gelu's default
  return 0.5f * z * (1.f + tanhf(GELU_C * (z + 0.044715f * z * z * z)));
}

__device__ __forceinline__ float act_grad(int act, float z) {
  if (act == SILU) {
    const float s = 1.f / (1.f + expf(-z));
    return s * (1.f + z * (1.f - s));
  }
  if (act == RELU) return z > 0.f ? 1.f : 0.f;
  const float t = tanhf(GELU_C * (z + 0.044715f * z * z * z));
  return 0.5f * (1.f + t) + 0.5f * z * (1.f - t * t) * GELU_C * (1.f + 3.f * 0.044715f * z * z);
}

// The 9 taps of x read by stage-0 position (b, r0, f0): x rows 2r0-1..2r0+1,
// columns 2f0-1..2f0+1, zero outside the input.
template <typename T>
__device__ __forceinline__ void x_taps(const T* __restrict__ x, const Dims& d, int b, int r0,
                                       int f0, float* xt) {
#pragma unroll
  for (int dt = 0; dt < 3; ++dt) {
    const int t = 2 * r0 - 1 + dt;
#pragma unroll
    for (int df = 0; df < 3; ++df) {
      const int f = 2 * f0 - 1 + df;
      xt[3 * dt + df] = (t >= 0 && t < d.T && f >= 0 && f < d.F)
                            ? to_f(x[((long long)b * d.T + t) * d.F + f]) : 0.f;
    }
  }
}

// stage-0 pre-activation z0 (rounded to T) from the taps and one channel's
// weights, summed in `_stage0`'s order
template <typename T>
__device__ __forceinline__ float stage0_z(const float* xt, const float* k9c, float b0c) {
  float acc = xt[0] * k9c[0] + b0c;
#pragma unroll
  for (int j = 1; j < 9; ++j) acc += xt[j] * k9c[j];
  return rnd<T>(acc);
}

struct PwArgs {
  const void* x;       // SRC_X: [B, T, F]
  const void* src;     // SRC_S: s1 [B, T1, F1, C]; SRC_LOAD: A [M, C]
  const float* k9;     // SRC_X: stage-0 weights [9, C] and bias [C]
  const float* b0;
  const float* dw;     // SRC_X, SRC_S: this stage's depthwise weights [9, C], bias [C]
  const float* bdw;
  const float* w;      // pointwise weights W[k][n] = w[k*C + n] (or w[n*C + k] if trans)
  const float* bias;   // pointwise bias [C] (not read by EPI_PLAIN)
  int trans;
  const void* g;       // EPI_GRAD: gradient at the activation's output [M, C]
  void* a_out;         // EPI_RECOMPUTE, EPI_GRAD: the A tile (depthwise output) [M, C]
  void* z_out;         // EPI_RECOMPUTE: pre-activation [M, C]
  void* out;           // EPI_ACT, EPI_RECOMPUTE: activation; EPI_GRAD: gz; EPI_PLAIN: A @ W
  Dims d;
  long long M;         // output positions
  int Ti, Fi, To, Fo;  // the depthwise conv's input and output grid (SRC_X, SRC_S)
  int act;
};

// C[m, n] = sum_k A[m, k] W[k, n] for 32 positions m and all n < C, with A
// built in shared memory by SRC and C consumed by EPI.
template <typename T, int SRC, int EPI>
__global__ void __launch_bounds__(THREADS) pw_kernel(PwArgs a) {
  extern __shared__ float smem[];
  const int C = a.d.C;
  float* As = smem;               // [BM][C]
  float* Ws = smem + BM * C;      // [BK][C]
  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * BM;
  const T* x = static_cast<const T*>(a.x);
  const T* src = static_cast<const T*>(a.src);

  // 1. the A tile: one channel per thread, every position of the block
  for (int c = tid; c < C; c += THREADS) {
    float k9c[9], dwc[9], b0c = 0.f, bdwc = 0.f;
    if (SRC != SRC_LOAD) {
#pragma unroll
      for (int j = 0; j < 9; ++j) dwc[j] = rnd<T>(a.dw[j * C + c]);
      bdwc = rnd<T>(a.bdw[c]);
    }
    if (SRC == SRC_X) {
#pragma unroll
      for (int j = 0; j < 9; ++j) k9c[j] = a.k9[j * C + c];
      b0c = a.b0[c];
    }
    for (int i = 0; i < BM; ++i) {
      const long long m = m0 + i;
      float v = 0.f;
      if (m < a.M) {
        if (SRC == SRC_LOAD) {
          v = to_f(src[m * C + c]);
        } else {
          const int fo = (int)(m % a.Fo);
          const int ro = (int)((m / a.Fo) % a.To);
          const int b = (int)(m / ((long long)a.Fo * a.To));
          float acc = bdwc;
#pragma unroll
          for (int dt = 0; dt < 3; ++dt) {
            const int r = 2 * ro - 1 + dt;
#pragma unroll
            for (int df = 0; df < 3; ++df) {
              const int f = 2 * fo - 1 + df;
              float s = 0.f;
              if (r >= 0 && r < a.Ti && f >= 0 && f < a.Fi) {
                if (SRC == SRC_X) {
                  float xt[9];
                  x_taps<T>(x, a.d, b, r, f, xt);
                  s = rnd<T>(act_f(a.act, stage0_z<T>(xt, k9c, b0c)));
                } else {
                  s = to_f(src[(((long long)b * a.Ti + r) * a.Fi + f) * C + c]);
                }
              }
              const int j = 3 * dt + df;
              acc = (j == 0) ? s * dwc[0] + bdwc : acc + s * dwc[j];
            }
          }
          v = rnd<T>(acc);
        }
        if (EPI == EPI_RECOMPUTE || EPI == EPI_GRAD)
          static_cast<T*>(a.a_out)[m * C + c] = from_f<T>(v);
      }
      As[i * C + c] = v;
    }
  }

  // 2. the product, the weights streamed through shared memory
  const int ty = tid / 32;  // rows ty*4 .. ty*4+3
  const int tx = tid % 32;  // columns tx + 32*i
  float acc[4][NCOL];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < NCOL; ++i) acc[r][i] = 0.f;

  for (int k0 = 0; k0 < C; k0 += BK) {
    const int kc = min(BK, C - k0);
    __syncthreads();  // the A tile is complete / the last chunk is consumed
    for (int idx = tid; idx < kc * C; idx += THREADS) {
      const int kk = idx / C, n = idx - kk * C;
      Ws[idx] = rnd<T>(a.trans ? a.w[(long long)n * C + k0 + kk] : a.w[(long long)(k0 + kk) * C + n]);
    }
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      float av[4], bv[NCOL];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = As[(ty * 4 + r) * C + k0 + kk];
#pragma unroll
      for (int i = 0; i < NCOL; ++i) {
        const int n = tx + 32 * i;
        bv[i] = n < C ? Ws[kk * C + n] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int i = 0; i < NCOL; ++i) acc[r][i] = fmaf(av[r], bv[i], acc[r][i]);
    }
  }

  // 3. the epilogue
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long m = m0 + ty * 4 + r;
    if (m >= a.M) continue;
#pragma unroll
    for (int i = 0; i < NCOL; ++i) {
      const int n = tx + 32 * i;
      if (n >= C) continue;
      const long long o = m * C + n;
      if (EPI == EPI_PLAIN) {
        static_cast<T*>(a.out)[o] = from_f<T>(acc[r][i]);
        continue;
      }
      const float z = rnd<T>(rnd<T>(acc[r][i]) + rnd<T>(a.bias[n]));
      if (EPI == EPI_GRAD) {
        const float g = to_f(static_cast<const T*>(a.g)[o]);
        static_cast<T*>(a.out)[o] = from_f<T>(g * act_grad(a.act, z));
        continue;
      }
      if (EPI == EPI_RECOMPUTE) static_cast<T*>(a.z_out)[o] = from_f<T>(z);
      static_cast<T*>(a.out)[o] = from_f<T>(act_f(a.act, z));
    }
  }
}

// Partials of gW[k, n] = sum_m A[m, k] Gz[m, n] and gb[n] = sum_m Gz[m, n]
// over positions [p*WG_ROWS, (p+1)*WG_ROWS): part[p] = [gW (C*C), gb (C)].
template <typename T>
__global__ void __launch_bounds__(THREADS) wgrad_kernel(const T* __restrict__ A,
                                                        const T* __restrict__ Gz, long long M,
                                                        int C, float* __restrict__ part) {
  __shared__ float As[WG_STEP][WG_TILE];
  __shared__ float Bs[WG_STEP][WG_TILE];
  const int tiles = (C + WG_TILE - 1) / WG_TILE;
  const int k0 = (blockIdx.x / tiles) * WG_TILE;
  const int n0 = (blockIdx.x % tiles) * WG_TILE;
  const long long p = blockIdx.y;
  const long long mbeg = p * WG_ROWS;
  const long long mend = mbeg + WG_ROWS < M ? mbeg + WG_ROWS : M;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // k rows ty + 16*i, n columns tx + 16*j
  float acc[4][4], bsum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bsum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  const bool bias_row = (k0 == 0 && ty == 0);
  for (long long ms = mbeg; ms < mend; ms += WG_STEP) {
    __syncthreads();
    for (int idx = tid; idx < WG_STEP * WG_TILE; idx += THREADS) {
      const int mm = idx / WG_TILE, cc = idx % WG_TILE;
      const long long m = ms + mm;
      const bool in_m = m < mend;
      As[mm][cc] = (in_m && k0 + cc < C) ? to_f(A[m * C + k0 + cc]) : 0.f;
      Bs[mm][cc] = (in_m && n0 + cc < C) ? to_f(Gz[m * C + n0 + cc]) : 0.f;
    }
    __syncthreads();
    for (int mm = 0; mm < WG_STEP; ++mm) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[mm][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[mm][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      if (bias_row) {
#pragma unroll
        for (int j = 0; j < 4; ++j) bsum[j] += bv[j];
      }
    }
  }
  float* out = part + p * ((long long)C * C + C);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (k < C && n < C) out[(long long)k * C + n] = acc[i][j];
    }
  }
  if (bias_row) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < C) out[(long long)C * C + n] = bsum[j];
    }
  }
}

struct DwBwdArgs {
  const void* gd;      // gradient at the depthwise output [B, To, Fo, C]
  const float* dw;     // depthwise weights [9, C]
  int Ti, Fi, To, Fo;  // input and output grids of the depthwise conv
  long long Mi;        // input positions
  // stage 1 input (STAGE0 == false): s1 and z1 as stored, gz1 written
  const void* s_in;
  const void* z_in;
  void* gz_out;
  // stage 0 input (STAGE0 == true): s0, z0 recomputed from x
  const void* x;
  const float* k9;
  const float* b0;
  float* G;            // [M0, 9]: sum_c k9[j, c] gz0[p, c], or null
  Dims d;
  int act;
  float* part;         // per block: STAGE0: [gk9 9C, gb0 C, gdw 9C, gbdw C]; else [gdw 9C, gbdw C]
};

// Gradient through one depthwise conv, gathered at its input: every input
// element sums the taps that read it.  Then through the activation before
// it.  Each block covers DW_POS input positions and writes its partial
// weight gradients; one thread per channel.
template <typename T, bool STAGE0>
__global__ void __launch_bounds__(THREADS) dw_bwd_kernel(DwBwdArgs a) {
  __shared__ float gzs[STAGE0 ? DW_BATCH * (MAX_C + 1) : 1];
  __shared__ float k9s[STAGE0 ? 9 * MAX_C : 1];
  const int C = a.d.C;
  const int tid = threadIdx.x;
  const int c = tid;
  const bool active = c < C;
  const long long pbeg = (long long)blockIdx.x * DW_POS;
  const long long pend = pbeg + DW_POS < a.Mi ? pbeg + DW_POS : a.Mi;
  const T* gd = static_cast<const T*>(a.gd);
  const T* x = static_cast<const T*>(a.x);
  const int LDG = C + 1;

  float w[9], gw[9], gb = 0.f, k9c[9], gk[9], gk0 = 0.f, b0c = 0.f;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    w[j] = active ? rnd<T>(a.dw[j * C + c]) : 0.f;
    gw[j] = 0.f;
    gk[j] = 0.f;
    k9c[j] = (STAGE0 && active) ? a.k9[j * C + c] : 0.f;
  }
  if (STAGE0) {
    if (active) b0c = a.b0[c];
    for (int idx = tid; idx < 9 * C; idx += THREADS) k9s[idx] = a.k9[idx];
  }

  for (long long p0 = pbeg; p0 < pend; p0 += DW_BATCH) {
    for (int i = 0; i < DW_BATCH; ++i) {
      const long long p = p0 + i;
      if (p >= pend || !active) continue;
      const int fi = (int)(p % a.Fi);
      const int ri = (int)((p / a.Fi) % a.Ti);
      const int b = (int)(p / ((long long)a.Fi * a.Ti));
      float s, z, xt[9];
      if (STAGE0) {
        x_taps<T>(x, a.d, b, ri, fi, xt);
        z = stage0_z<T>(xt, k9c, b0c);
        s = rnd<T>(act_f(a.act, z));
      } else {
        s = to_f(static_cast<const T*>(a.s_in)[p * C + c]);
        z = to_f(static_cast<const T*>(a.z_in)[p * C + c]);
      }
      float gs = 0.f;
#pragma unroll
      for (int dt = 0; dt < 3; ++dt) {
        const int rr = ri + 1 - dt;  // = 2 ro
        if (rr < 0 || (rr & 1) || rr / 2 >= a.To) continue;
#pragma unroll
        for (int df = 0; df < 3; ++df) {
          const int ff = fi + 1 - df;
          if (ff < 0 || (ff & 1) || ff / 2 >= a.Fo) continue;
          const int j = 3 * dt + df;
          const float g = to_f(gd[(((long long)b * a.To + rr / 2) * a.Fo + ff / 2) * C + c]);
          gs += w[j] * g;
          gw[j] += s * g;
          if (j == 4) gb += g;  // every output position has its centre tap here
        }
      }
      const float gz = rnd<T>(rnd<T>(gs) * act_grad(a.act, z));
      if (STAGE0) {
#pragma unroll
        for (int j = 0; j < 9; ++j) gk[j] += xt[j] * gz;
        gk0 += gz;
        gzs[i * LDG + c] = gz;
      } else {
        static_cast<T*>(a.gz_out)[p * C + c] = from_f<T>(gz);
      }
    }
    if (STAGE0 && a.G != nullptr) {
      __syncthreads();
      // G[p, j] = sum_c k9[j, c] gz0[p, c]: one (position, tap) pair a thread
      for (int q = tid; q < DW_BATCH * 9; q += THREADS) {
        const int i = q / 9, j = q - 9 * (q / 9);
        const long long p = p0 + i;
        if (p >= pend) continue;
        float sum = 0.f;
        for (int cc = 0; cc < C; ++cc) sum += k9s[j * C + cc] * gzs[i * LDG + cc];
        a.G[p * 9 + j] = sum;
      }
      __syncthreads();
    }
  }
  if (!active) return;
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
template <typename T>
__global__ void __launch_bounds__(THREADS) gx_kernel(const float* __restrict__ G, Dims d,
                                                      T* __restrict__ gx) {
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
  gx[idx] = from_f<T>(acc);
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

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }
size_t align256(size_t n) { return (n + 255) & ~(size_t)255; }

// The backward's scratch, carved from one workspace.
struct Work {
  size_t s1, d1, z1, gz1, gd1, d2, gz2, gd2, G, part_pw2, part_pw1, part_dw2, part_dw1, total;
  long long P1, P2, Pd1, Pd0;
};

Work make_work(const Dims& d, size_t es) {
  Work w;
  const long long C = d.C;
  w.P2 = ceil_div(d.M2, WG_ROWS);
  w.P1 = ceil_div(d.M1, WG_ROWS);
  w.Pd1 = ceil_div(d.M1, DW_POS);
  w.Pd0 = ceil_div(d.M0, DW_POS);
  size_t off = 0;
  auto take = [&](size_t bytes) { const size_t at = off; off += align256(bytes); return at; };
  w.s1 = take(d.M1 * C * es);
  w.d1 = take(d.M1 * C * es);
  w.z1 = take(d.M1 * C * es);
  w.gz1 = take(d.M1 * C * es);
  w.gd1 = take(d.M1 * C * es);
  w.d2 = take(d.M2 * C * es);
  w.gz2 = take(d.M2 * C * es);
  w.gd2 = take(d.M2 * C * es);
  w.G = take(d.M0 * 9 * sizeof(float));
  w.part_pw2 = take(w.P2 * (C * C + C) * sizeof(float));
  w.part_pw1 = take(w.P1 * (C * C + C) * sizeof(float));
  w.part_dw2 = take(w.Pd1 * 10 * C * sizeof(float));
  w.part_dw1 = take(w.Pd0 * 20 * C * sizeof(float));
  w.total = off;
  return w;
}

size_t pw_smem(int C) { return (size_t)(BM + BK) * C * sizeof(float); }

template <typename T, int SRC, int EPI>
cudaError_t launch_pw(const PwArgs& a, cudaStream_t stream) {
  const size_t smem = pw_smem(a.d.C);
  cudaError_t e = cudaFuncSetAttribute(pw_kernel<T, SRC, EPI>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  pw_kernel<T, SRC, EPI><<<(unsigned)ceil_div(a.M, BM), THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_reduce(const float* part, long long P, long long stride, long long n,
                          float* out, cudaStream_t stream) {
  reduce_kernel<<<(unsigned)ceil_div(n, THREADS), THREADS, 0, stream>>>(part, P, stride, n, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wgrad(const void* A, const void* Gz, long long M, int C, float* part, long long P,
                         float* out, cudaStream_t stream) {
  const int tiles = (C + WG_TILE - 1) / WG_TILE;
  wgrad_kernel<T><<<dim3(tiles * tiles, (unsigned)P), THREADS, 0, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(Gz), M, C, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long n = (long long)C * C + C;
  return launch_reduce(part, P, n, n, out, stream);
}

PwArgs stage_args(const Dims& d, const float* w, int stage, int act) {
  const Pack pk = make_pack(d.C);
  PwArgs a = {};
  a.d = d;
  a.act = act;
  a.k9 = w + pk.k9;
  a.b0 = w + pk.b0;
  if (stage == 1) {
    a.dw = w + pk.dw1; a.bdw = w + pk.bdw1; a.w = w + pk.pw1; a.bias = w + pk.bpw1;
    a.Ti = d.T0; a.Fi = d.F0; a.To = d.T1; a.Fo = d.F1; a.M = d.M1;
  } else {
    a.dw = w + pk.dw2; a.bdw = w + pk.bdw2; a.w = w + pk.pw2; a.bias = w + pk.bpw2;
    a.Ti = d.T1; a.Fi = d.F1; a.To = d.T2; a.Fo = d.F2; a.M = d.M2;
  }
  return a;
}

#define DAE_TRY(expr)                       \
  do {                                      \
    cudaError_t e_ = (expr);                \
    if (e_ != cudaSuccess) return (int)e_;  \
  } while (0)

template <typename T>
int forward(const void* x, const Dims& d, const float* w, int act, void* s1, void* out,
            cudaStream_t stream) {
  PwArgs a = stage_args(d, w, 1, act);
  a.x = x;
  a.out = s1;
  DAE_TRY((launch_pw<T, SRC_X, EPI_ACT>(a, stream)));
  PwArgs b = stage_args(d, w, 2, act);
  b.src = s1;
  b.out = out;
  DAE_TRY((launch_pw<T, SRC_S, EPI_ACT>(b, stream)));
  return 0;
}

template <typename T>
int backward(const void* x, const void* g, const Dims& d, const float* w, int act, void* gx,
             float* gw, char* work, cudaStream_t stream) {
  const Pack pk = make_pack(d.C);
  const Work wk = make_work(d, sizeof(T));
  const int C = d.C;

  // recompute stage 1: d1, z1, s1
  PwArgs s1a = stage_args(d, w, 1, act);
  s1a.x = x;
  s1a.a_out = work + wk.d1;
  s1a.z_out = work + wk.z1;
  s1a.out = work + wk.s1;
  DAE_TRY((launch_pw<T, SRC_X, EPI_RECOMPUTE>(s1a, stream)));
  // recompute stage 2: d2, and gz2 = g * act'(z2)
  PwArgs s2a = stage_args(d, w, 2, act);
  s2a.src = work + wk.s1;
  s2a.g = g;
  s2a.a_out = work + wk.d2;
  s2a.out = work + wk.gz2;
  DAE_TRY((launch_pw<T, SRC_S, EPI_GRAD>(s2a, stream)));
  // gpw2, gbpw2
  DAE_TRY(launch_wgrad<T>(work + wk.d2, work + wk.gz2, d.M2, C,
                          reinterpret_cast<float*>(work + wk.part_pw2), wk.P2, gw + pk.pw2, stream));
  // gd2 = gz2 @ pw2^T
  PwArgs t2 = {};
  t2.d = d; t2.src = work + wk.gz2; t2.w = w + pk.pw2; t2.trans = 1; t2.M = d.M2;
  t2.out = work + wk.gd2;
  DAE_TRY((launch_pw<T, SRC_LOAD, EPI_PLAIN>(t2, stream)));
  // through depthwise 2 and the stage-1 activation: gz1; gdw2, gbdw2
  DwBwdArgs b2 = {};
  b2.gd = work + wk.gd2; b2.dw = w + pk.dw2;
  b2.Ti = d.T1; b2.Fi = d.F1; b2.To = d.T2; b2.Fo = d.F2; b2.Mi = d.M1;
  b2.s_in = work + wk.s1; b2.z_in = work + wk.z1; b2.gz_out = work + wk.gz1;
  b2.d = d; b2.act = act; b2.part = reinterpret_cast<float*>(work + wk.part_dw2);
  dw_bwd_kernel<T, false><<<(unsigned)wk.Pd1, THREADS, 0, stream>>>(b2);
  DAE_TRY(cudaGetLastError());
  DAE_TRY(launch_reduce(b2.part, wk.Pd1, 10LL * C, 10LL * C, gw + pk.dw2, stream));
  // gpw1, gbpw1
  DAE_TRY(launch_wgrad<T>(work + wk.d1, work + wk.gz1, d.M1, C,
                          reinterpret_cast<float*>(work + wk.part_pw1), wk.P1, gw + pk.pw1, stream));
  // gd1 = gz1 @ pw1^T
  PwArgs t1 = {};
  t1.d = d; t1.src = work + wk.gz1; t1.w = w + pk.pw1; t1.trans = 1; t1.M = d.M1;
  t1.out = work + wk.gd1;
  DAE_TRY((launch_pw<T, SRC_LOAD, EPI_PLAIN>(t1, stream)));
  // through depthwise 1, the stage-0 activation and conv: gk9, gb0, gdw1, gbdw1, G
  DwBwdArgs b1 = {};
  b1.gd = work + wk.gd1; b1.dw = w + pk.dw1;
  b1.Ti = d.T0; b1.Fi = d.F0; b1.To = d.T1; b1.Fo = d.F1; b1.Mi = d.M0;
  b1.x = x; b1.k9 = w + pk.k9; b1.b0 = w + pk.b0;
  b1.G = gx != nullptr ? reinterpret_cast<float*>(work + wk.G) : nullptr;
  b1.d = d; b1.act = act; b1.part = reinterpret_cast<float*>(work + wk.part_dw1);
  dw_bwd_kernel<T, true><<<(unsigned)wk.Pd0, THREADS, 0, stream>>>(b1);
  DAE_TRY(cudaGetLastError());
  DAE_TRY(launch_reduce(b1.part, wk.Pd0, 20LL * C, 20LL * C, gw + pk.k9, stream));
  if (gx != nullptr) {
    const long long n = (long long)d.B * d.T * d.F;
    gx_kernel<T><<<(unsigned)ceil_div(n, THREADS), THREADS, 0, stream>>>(
        b1.G, d, static_cast<T*>(gx));
    DAE_TRY(cudaGetLastError());
  }
  return 0;
}

bool dims_ok(int B, int T, int F, int C) {
  return B >= 1 && T >= 1 && F >= 8 && F % 8 == 0 && C >= 1 && C <= MAX_C;
}

}  // namespace

// The f32 (parity) route: dtype 0 only (bf16 goes to fused_subsample_bf16.cu,
// which exports the same entry points).  act: 0 silu, 1 relu, 2 gelu
// (tanh).  w: the packed f32 weights (k9, b0, dw1, bdw1, pw1, bpw1, dw2,
// bdw2, pw2, bpw2).  Tensors are contiguous.  Each entry point returns a
// cudaError_t.

// Bytes of scratch the forward (pass 0: s1) or the backward (pass 1) needs;
// -1 for what the kernels do not take
extern "C" long long dae_fused_subsample_workspace(int dtype, int pass, int B, int T, int F,
                                                   int C) {
  if (!dims_ok(B, T, F, C) || dtype != 0 || (pass != 0 && pass != 1)) return -1;
  const Dims d = make_dims(B, T, F, C);
  return pass == 0 ? (long long)align256(d.M1 * C * sizeof(float))
                   : (long long)make_work(d, sizeof(float)).total;
}

// x [B, T, F] -> out [B, T2, F2, C]; work holds the forward's workspace (s1)
extern "C" int dae_fused_subsample_fwd(int dtype, int act, const void* x, int B, int T, int F,
                                       int C, const float* w, void* out, void* work, void* stream) {
  if (!dims_ok(B, T, F, C) || dtype != 0 || act < 0 || act > 2) return (int)cudaErrorInvalidValue;
  return forward<float>(x, make_dims(B, T, F, C), w, act, work, out,
                        static_cast<cudaStream_t>(stream));
}

// g [B, T2, F2, C] -> gx [B, T, F] (skipped when gx is null) and the packed
// f32 weight gradients gw; work holds the backward's workspace bytes
extern "C" int dae_fused_subsample_bwd(int dtype, int act, const void* x, const void* g, int B,
                                       int T, int F, int C, const float* w, void* gx, float* gw,
                                       void* work, void* stream) {
  if (!dims_ok(B, T, F, C) || dtype != 0 || act < 0 || act > 2) return (int)cudaErrorInvalidValue;
  return backward<float>(x, g, make_dims(B, T, F, C), w, act, gx, gw, static_cast<char*>(work),
                         static_cast<cudaStream_t>(stream));
}

extern "C" const char* dae_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
