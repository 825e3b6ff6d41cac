// Soft-DTW cost matrix R (forward) and its gradient E (backward), for sm_90a.
//
// Replaces the JAX package's kernels/softdtw.py:129-181 `_softdtw_pallas_fwd`
// (the forward wavefront as a Pallas TPU kernel) and, for the backward, the
// `lax.scan` of `_backward_E` (:92-121), as the reference's numba CUDA
// soft-DTW did both directions.
//
// What it computes.  D [B, N, M] f32 (the Sakoe-Chiba band already applied
// by the caller, as INF outside it).
//   forward : R [B, N+2, M+2] in JAX's padded layout: R[0, 0] = 0, every
//             other border cell INF, and for 1 <= i <= N, 1 <= j <= M
//             R[i, j] = D[i-1, j-1] + softmin_g(R[i-1, j], R[i, j-1], R[i-1, j-1])
//             with the stable softmin of `_softmin3` (:52-56).
//   backward: E [B, N, M], the Cuturi-Blondel recursion of `_backward_E`
//             over the same anti-diagonals in reverse, with R's last row and
//             column read as -INF and R[N+1, M+1] as R[N, M].  Each weight
//             exp((R[nb] - R[cell] - D[nb]) / g) has its exponent clamped at 0,
//             its bound in exact arithmetic, as the port's plain
//             `backward_E_reference` does: next to a band, R - D of an outside
//             cell is a difference of INF-sized f32 values and would overflow.
//
// Bound on this card.  Bytes: D read and R written once, ~2.1 MB at
// (B 4, N = M = 256), 0.63 us at 3.35 TB/s.  The time is set instead by the
// N + M - 1 dependent anti-diagonals: each needs the two before it.
//
// Design.  One block per batch element; the threads stride along the
// current anti-diagonal (any N and M), with __syncthreads() between
// diagonals.  R and E live in device memory (L1/L2-resident at these sizes);
// each diagonal touches only its own cells, where the Pallas body updates
// the whole matrix on every diagonal.  Keeping three rolling diagonals in
// shared memory, and several batch elements per block, are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float INF = 1e10f;
constexpr int THREADS = 256;

__device__ __forceinline__ float softmin3(float a, float b, float c, float gamma) {
  const float za = -a / gamma, zb = -b / gamma, zc = -c / gamma;
  const float zmax = fmaxf(za, fmaxf(zb, zc));
  return -gamma * (zmax + logf(expf(za - zmax) + expf(zb - zmax) + expf(zc - zmax)));
}

__global__ void __launch_bounds__(THREADS) fwd_kernel(const float* __restrict__ D, float* R,
                                                      int N, int M, float gamma) {
  const long long W = M + 2;
  const float* Db = D + (long long)blockIdx.x * N * M;
  float* Rb = R + (long long)blockIdx.x * (N + 2) * W;
  for (int j = threadIdx.x; j < M + 2; j += THREADS) {
    Rb[j] = j == 0 ? 0.f : INF;
    Rb[(N + 1) * W + j] = INF;
  }
  for (int i = 1 + threadIdx.x; i < N + 1; i += THREADS) {
    Rb[i * W] = INF;
    Rb[i * W + M + 1] = INF;
  }
  __syncthreads();
  for (int k = 0; k < N + M - 1; ++k) {  // cells with (i - 1) + (j - 1) == k
    const int lo = k - M + 1 > 0 ? k - M + 1 : 0;
    const int hi = k < N - 1 ? k : N - 1;
    for (int i0 = lo + threadIdx.x; i0 <= hi; i0 += THREADS) {
      const int j0 = k - i0;
      const long long at = (long long)(i0 + 1) * W + j0 + 1;
      Rb[at] = Db[(long long)i0 * M + j0] + softmin3(Rb[at - W], Rb[at - 1], Rb[at - W - 1], gamma);
    }
    __syncthreads();
  }
}

// exp(min(x, 0)): the backward's weights are <= 1 in exact arithmetic
__device__ __forceinline__ float weight(float x) { return expf(fminf(x, 0.f)); }

__global__ void __launch_bounds__(THREADS) bwd_kernel(const float* __restrict__ D,
                                                      const float* __restrict__ R, float* E,
                                                      int N, int M, float gamma) {
  const long long W = M + 2;
  const float* Db = D + (long long)blockIdx.x * N * M;
  const float* Rb = R + (long long)blockIdx.x * (N + 2) * W;
  float* Eb = E + (long long)blockIdx.x * N * M;
  const float r_end = Rb[N * W + M];
  // R, D and E at padded (i, j), 1 <= i <= N+1, 1 <= j <= M+1
  auto r_at = [&](int i, int j) {
    if (i == N + 1 && j == M + 1) return r_end;
    if (i == N + 1 || j == M + 1) return -INF;
    return Rb[i * W + j];
  };
  auto d_at = [&](int i, int j) {
    return (i <= N && j <= M) ? Db[(long long)(i - 1) * M + j - 1] : 0.f;
  };
  auto e_at = [&](int i, int j) {
    if (i == N + 1 && j == M + 1) return 1.f;
    if (i == N + 1 || j == M + 1) return 0.f;
    return Eb[(long long)(i - 1) * M + j - 1];
  };
  for (int k = N + M - 2; k >= 0; --k) {
    const int lo = k - M + 1 > 0 ? k - M + 1 : 0;
    const int hi = k < N - 1 ? k : N - 1;
    for (int i0 = lo + threadIdx.x; i0 <= hi; i0 += THREADS) {
      const int i = i0 + 1, j = k - i0 + 1;
      const float r = Rb[i * W + j];
      const float a = weight((r_at(i + 1, j) - r - d_at(i + 1, j)) / gamma);
      const float b = weight((r_at(i, j + 1) - r - d_at(i, j + 1)) / gamma);
      const float c = weight((r_at(i + 1, j + 1) - r - d_at(i + 1, j + 1)) / gamma);
      Eb[(long long)i0 * M + j - 1] = e_at(i + 1, j) * a + e_at(i, j + 1) * b + e_at(i + 1, j + 1) * c;
    }
    __syncthreads();
  }
}

}  // namespace

// D [B, N, M] f32 contiguous -> R [B, N+2, M+2].  Returns a cudaError_t.
extern "C" int dae_softdtw_fwd(const float* D, float* R, int B, int N, int M, float gamma,
                               void* stream) {
  if (B < 1 || N < 1 || M < 1 || !(gamma > 0.f)) return (int)cudaErrorInvalidValue;
  fwd_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(D, R, N, M, gamma);
  return (int)cudaGetLastError();
}

// D [B, N, M], R [B, N+2, M+2] from dae_softdtw_fwd -> E [B, N, M].
extern "C" int dae_softdtw_bwd(const float* D, const float* R, float* E, int B, int N, int M,
                               float gamma, void* stream) {
  if (B < 1 || N < 1 || M < 1 || !(gamma > 0.f)) return (int)cudaErrorInvalidValue;
  bwd_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(D, R, E, N, M, gamma);
  return (int)cudaGetLastError();
}

extern "C" const char* dae_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
