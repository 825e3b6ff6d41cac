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
//             R[i, j] = D[i-1, j-1] + softmin_g(R[i-1, j], R[i, j-1], R[i-1, j-1]).
//   backward: E [B, N, M], the Cuturi-Blondel recursion of `_backward_E`
//             in reverse, with R's last row and column read as -INF and
//             R[N+1, M+1] as R[N, M]:
//             E[i, j] = E[i+1, j] a + E[i, j+1] b + E[i+1, j+1] c, each weight
//             exp((R[nb] - R[i, j] - D[nb]) / g) with its exponent clamped at
//             0, its bound in exact arithmetic, as the port's plain
//             `backward_weights_reference` does: next to a band, R - D of an
//             outside cell is a difference of INF-sized f32 values and would
//             overflow.
//
// What bounds it on this card.  Not bytes: D read and R written once are
// ~2.1 MB at (B 4, N = M = 256), 0.63 us at 3.35 TB/s.  The recursion is a
// chain: each cell needs its upper, left and upper-left neighbours, so the
// least time is N + M - 1 dependent steps, each as long as the latency of
// one cell's update (forward: SHFL.UP, FSEL, FADD, MUFU.EX2, FFMA, MUFU.LG2,
// FADD, 78 SM cycles on an H100; backward: SHFL.UP, FSEL, FFMA, 34), plus
// what a warp spends between steps on its loads, stores and waits; with
// B = 1 all of it runs on one SM.  `chain_kernel` runs one step's chain
// alone, through the same `fwd_step` / `bwd_step` as the kernels, and times
// it in SM cycles (`dae_softdtw_chain`): N + M - 1 times that is the chain
// floor.
//
// Design.  One block per batch element.  The rows are cut into strips of 32,
// one row per lane; warp w takes strips w, w + NW, ... .  Within a strip lane
// l updates column t - l at step t, so a warp is a diagonal wavefront:
//   - R[i, j-1] is the lane's own previous value (a register),
//   - R[i-1, j] comes from lane l-1 by __shfl_up_sync,
//   - R[i-1, j-1] is what the lane received one step earlier (a register),
// and lane 0 takes its upper neighbour from the strip above through a ring
// in shared memory: one 64-bit slot per column holding the value and the
// writing strip's number.  A warp works CHUNK steps at a time: before a
// chunk it polls the chunk's slots until each holds the number it expects
// (the loads issued in the middle of the chunk before, the test made after
// it), and after the chunk the strip's lane 31 writes its CHUNK values.  No
// fence and no block barrier after the first: a slot is one 64-bit store,
// and the strip below runs about CHUNK + 32 steps behind the strip above.
// The forward's softmin runs in units of R log2(e) / g, so that its two
// exponentials and its logarithm are bare ex2 / lg2; one of its three
// exponentials is of the minimum itself, which is 1, and the one of the
// left and upper-left pair is computed before the shuffled value arrives, so
// the chain holds one ex2 and one lg2.  The backward's three weights depend
// on R and D alone: each lane computes a chunk's weights (expf, as accurate
// as the plain version's exp) before the chunk's E chain, which then holds
// one FMA after the shuffle.
//
// Columns are cut into panels of at most PANEL (the ring holds one panel's
// row, so that no slot is written again before it has been read, whatever M
// is): strip s of panel q is "virtual strip" v = q S + s, and every virtual
// strip waits on the one before it, the first strip of a panel on the last
// strip of the panel before (whose values it does not use); the chain of
// waits is what guarantees a ring slot has been read before it is written
// again.  A lane's first value in a panel (its left edge) is read back from
// the output its warp wrote in the panel before.
//
// D (and R, backward) are staged, and R (E, backward) written out, through a
// warp's own ring of 4 blocks of 32 columns in shared memory: cp.async loads
// each block, coalesced, 3 blocks ahead of its use; row l is skewed by l, so
// that a lane's CHUNK columns (t0 - l ...) are two aligned 128-bit accesses,
// rows 4 banks apart; a finished block is loaded whole into registers and
// written to device memory row by row.  The forward writes R over the D it
// has read.  No atomics: every result is the same bit for bit on every run.

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr float INF = 1e10f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int FWD_WARPS = 8;  // most strips in flight, forward (10 and 12 ran slower)
constexpr int BWD_WARPS = 4;  // backward: its three staging tiles take 52 KB a warp
constexpr int PANEL = 512;    // columns per panel: a warp's ring holds one panel's row
constexpr int TILE = 128;     // columns of a warp's staging ring: 4 blocks of 32
constexpr int TS = TILE + 4;  // floats from one row of a staging tile to the next
constexpr int AHEAD = 3;      // blocks loaded ahead of the one in use
constexpr int CHUNK = 8;      // steps between a warp's loads, stores and ring traffic
constexpr int EDGE = 2;       // ring slots before column 0: the left edge's, and one to align
constexpr unsigned long long NO_TAG = ~0ull;

// PTX:
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// 4 bytes from src into shared dst, asynchronously; zeros where !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}
__device__ __forceinline__ unsigned long long ld_slot(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}
__device__ __forceinline__ void st_slot(unsigned long long* p, unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}
// two slots, 16-byte aligned, in one load (each slot is read whole)
__device__ __forceinline__ void ld_slot2(const unsigned long long* p, unsigned long long& a,
                                         unsigned long long& b) {
  asm volatile("ld.volatile.shared.v2.u64 {%0, %1}, [%2];\n"
               : "=l"(a), "=l"(b)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
}
__device__ __forceinline__ float shfl_up(float v) { return __shfl_up_sync(FULL, v, 1); }
__device__ __forceinline__ void syncwarp() { __syncwarp(); }
// fragments

__device__ __forceinline__ unsigned long long slot(float value, int tag) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(tag)) << 32) |
         __float_as_uint(value);
}
__device__ __forceinline__ float slot_value(unsigned long long w) {
  return __uint_as_float(static_cast<unsigned>(w));
}
__device__ __forceinline__ int slot_tag(unsigned long long w) { return static_cast<int>(w >> 32); }

// wait until the slot holds the value of virtual strip `tag`; returns it
__device__ __forceinline__ float await_slot(const unsigned long long* p, int tag) {
  unsigned long long w = ld_slot(p);
  while (slot_tag(w) != tag) w = ld_slot(p);
  return slot_value(w);
}

// The schedule, shared by both directions (in the backward, rows and columns
// count from the bottom right: "above" is the row below, "left" the column to
// the right).
struct Schedule {
  int N, M, S, NW, P, Q;
  __device__ Schedule(int N_, int M_, int warps) : N(N_), M(M_) {
    S = (N + 31) / 32;
    NW = S < warps ? S : warps;
    P = M < PANEL ? M : PANEL;
    Q = (M + P - 1) / P;
  }
};

// slots of a warp's boundary ring: the edge's, one to align, one a column
__host__ __device__ constexpr int ring_slots(int P) { return EDGE + P + (P & 1); }

// One strip of one panel, as seen from its warp: what both directions share.
struct Strip {
  int q, s, v, c0, Pq, nb, lane;
  unsigned long long* ring_in;   // this warp's ring: written by the strip above
  unsigned long long* ring_out;  // the next virtual strip's warp's ring
  __device__ Strip(const Schedule& g, unsigned long long* rings, int warp, int q_, int s_)
      : q(q_), s(s_) {
    v = q * g.S + s;
    c0 = q * g.P;
    Pq = g.M - c0 < g.P ? g.M - c0 : g.P;
    nb = (Pq + 31) / 32;
    lane = threadIdx.x & 31;
    ring_in = rings + warp * ring_slots(g.P);
    const int succ = s + 1 < g.S ? (s + 1) % g.NW : 0;
    ring_out = rings + succ * ring_slots(g.P);
  }
};

// ---------------------------------------------------------------------------
// the boundary ring and the staging tiles, a chunk at a time
// ---------------------------------------------------------------------------

// Lane 0's upper neighbours for the chunk's columns t0 .. t0 + CHUNK - 1: the
// strip above's last row, polled in three parts so that the loads can be
// issued early and the test made late.  ring_load reads the chunk's slots;
// ring_stale says whether one of them (short of the panel's end) does not
// yet hold the strip above; ring_take keeps their values where the strip
// above is a real one (`use`), `none` elsewhere.
__device__ __forceinline__ void ring_load(const Strip& st, int t0,
                                          unsigned long long (&w)[CHUNK]) {
#pragma unroll
  for (int k = 0; k < CHUNK; k += 2) ld_slot2(st.ring_in + EDGE + t0 + k, w[k], w[k + 1]);
}
__device__ __forceinline__ bool ring_stale(const Strip& st, int t0,
                                           const unsigned long long (&w)[CHUNK]) {
  const unsigned want = static_cast<unsigned>(st.v - 1);
  unsigned bad = 0;
#pragma unroll
  for (int k = 0; k < CHUNK; ++k)
    bad |= t0 + k < st.Pq ? static_cast<unsigned>(w[k] >> 32) ^ want : 0u;
  return bad != 0;
}
__device__ __forceinline__ void ring_take(const Strip& st, int t0, bool use, float none,
                                          const unsigned long long (&w)[CHUNK],
                                          float (&above)[CHUNK]) {
#pragma unroll
  for (int k = 0; k < CHUNK; ++k) above[k] = use && t0 + k < st.Pq ? slot_value(w[k]) : none;
}
// the whole poll, for a chunk whose slots were loaded early into w (`wait`:
// the strip has a strip above to wait for)
__device__ __forceinline__ void ring_chunk(const Strip& st, int t0, bool wait, bool use,
                                           float none, unsigned long long (&w)[CHUNK],
                                           float (&above)[CHUNK]) {
  if (wait)
    while (ring_stale(st, t0, w)) ring_load(st, t0, w);
  ring_take(st, t0, use, none, w, above);
}

// lane 31 publishes the values it computed in the chunk (its columns
// t0 - 31 .. t0 - 31 + CHUNK - 1) for the strip below
__device__ __forceinline__ void publish_chunk(const Strip& st, int t0,
                                              const float (&val)[CHUNK]) {
  if (st.lane != 31) return;
  unsigned long long* out = st.ring_out + EDGE + t0 - 31;
  if (t0 >= 31 && t0 - 31 + CHUNK <= st.Pq) {  // all of them: no tests
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) st_slot(out + k, slot(val[k], st.v));
    return;
  }
#pragma unroll
  for (int k = 0; k < CHUNK; ++k) {
    const int col = t0 + k - 31;
    if (col >= 0 && col < st.Pq) st_slot(out + k, slot(val[k], st.v));
  }
}

// A staging tile holds row r's column x at r * TS + ((x + skew(r)) & (TILE - 1)),
// the skew making a lane's columns of a chunk (row l: t0 - l .. t0 - l +
// CHUNK - 1) contiguous and 16-byte aligned: two 128-bit accesses a chunk,
// free of bank conflicts (rows 4 banks apart).
__device__ __forceinline__ void load_chunk(const float* row, int t0, float (&x)[CHUNK]) {
  const float4* p = reinterpret_cast<const float4*>(row + (t0 & (TILE - 1)));
#pragma unroll
  for (int q = 0; q < CHUNK / 4; ++q) {
    const float4 v = p[q];
    x[4 * q] = v.x;
    x[4 * q + 1] = v.y;
    x[4 * q + 2] = v.z;
    x[4 * q + 3] = v.w;
  }
}
__device__ __forceinline__ void store_chunk(float* row, int t0, const float (&x)[CHUNK],
                                            float scale) {
  float4* p = reinterpret_cast<float4*>(row + (t0 & (TILE - 1)));
#pragma unroll
  for (int q = 0; q < CHUNK / 4; ++q)
    p[q] = make_float4(x[4 * q] * scale, x[4 * q + 1] * scale, x[4 * q + 2] * scale,
                       x[4 * q + 3] * scale);
}

// rows 0 .. rows - 1 of a staged block's column to device memory, `stride`
// floats apart; all 32 loaded first (the barrier keeps the compiler from
// pairing each load with its store, a shared-memory latency a row)
__device__ __forceinline__ void write_rows(float* dst, long long stride, int rows,
                                           const float (&v)[32]) {
  asm volatile("" ::: "memory");
  if (rows >= 32) {
#pragma unroll
    for (int r = 0; r < 32; ++r) dst[r * stride] = v[r];
  } else {
#pragma unroll
    for (int r = 0; r < 32; ++r)
      if (r < rows) dst[r * stride] = v[r];
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

struct Fwd {
  static constexpr int WARPS = FWD_WARPS;
  static constexpr int TILE_FLOATS = 32 * TS;  // D, overwritten by R; row l skewed by l
  const float* Db;
  float* Rb;
  long long W;  // M + 2
  float k;      // log2(e) / g: R in scaled units is R k
  float c;      // g ln 2 = 1 / k

  // stage block b (local columns 32 b .. 32 b + 31) of D for strip s
  __device__ void load(const Schedule& g, const Strip& st, float* tile, int b) const {
    const int col = 32 * b + st.lane;
    const bool ok_col = col < st.Pq;
    const float* src = Db + (long long)32 * st.s * g.M + st.c0 + col;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const bool ok = ok_col && 32 * st.s + r < g.N;
      cp_async4(tile + r * TS + ((col + r) & (TILE - 1)), ok ? src + (long long)r * g.M : Db, ok);
    }
  }
  // write block b of R (in place of D) to device memory
  __device__ void flush(const Schedule& g, const Strip& st, const float* tile, int b) const {
    const int col = 32 * b + st.lane;
    if (col >= st.Pq) return;
    float* dst = Rb + (32 * st.s + 1) * W + st.c0 + col + 1;
    float v[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) v[r] = tile[r * TS + ((col + r) & (TILE - 1))];
    write_rows(dst, W, g.N - 32 * st.s, v);
  }
};

// One step of a lane's forward chain, in scaled units: from its left
// neighbour `cur` and upper left `dia` (which becomes the upper neighbour,
// for the next step), the upper neighbour by shuffle (lane 0: `above`) and
// D `dk`, R of its cell.  R[i-1, j] arrives last.
__device__ __forceinline__ float fwd_step(float cur, float& dia, float above, float dk,
                                          int lane) {
  float up = shfl_up(cur);
  if (lane == 0) up = above;
  const float left = cur, diag = dia;
  dia = up;
  const float m2 = fminf(left, diag);
  const float s2 = 1.f + ex2(-fabsf(left - diag));  // sum over {left, diag} of 2^(m2 - x)
  const float d = up - m2;
  const float e = ex2(-fabsf(d));
  const float A = d <= 0.f ? s2 : 1.f, C = d <= 0.f ? 1.f : s2;
  return (fminf(up, m2) + dk) - lg2(fmaf(A, e, C));
}

// CHUNK steps from step t0, D of the chunk in dk (scaled).  Lane l updates
// column t0 + j - l at step j; RAMP: lanes that have not started
// (t0 + j < l) keep their left edge.
template <bool RAMP>
__device__ __forceinline__ void fwd_chunk(const Fwd& f, const Strip& st, float* row, int t0,
                                          const float (&dk)[CHUNK], const float (&above)[CHUNK],
                                          float& cur, float& dia,
                                          unsigned long long (&w_next)[CHUNK]) {
  const int lane = st.lane;
  float u[CHUNK];
#pragma unroll
  for (int j = 0; j < CHUNK; ++j) {
    if (j == CHUNK / 2) ring_load(st, t0 + CHUNK, w_next);  // the next chunk's slots
    u[j] = fwd_step(cur, dia, above[j], dk[j], lane);
    if (!RAMP || t0 + j >= lane) cur = u[j];
  }
  store_chunk(row, t0, u, f.c);
  publish_chunk(st, t0, u);
}

__device__ void fwd_strip(const Schedule& g, const Fwd& f, const Strip& st, float* tile) {
  const int lane = st.lane, i = 32 * st.s + lane;
  const float k = f.k, inf = INF * k;
  const bool wait = st.v > 0, use = st.s > 0;
  float* row = tile + lane * TS;
  for (int b = 0; b < AHEAD; ++b) {
    if (b < st.nb) f.load(g, st, tile, b);
    cp_async_commit();
  }
  // left edge: R[i+1, c0] (padded), read back from the panel before
  float cur = (st.q == 0 || i >= g.N) ? inf : f.Rb[(i + 1) * f.W + st.c0] * k;
  // lane 0's R[i-1, j-1] for column 0 (the first strip of a panel waits for
  // the slot too: the chain of these waits orders every read of a slot 0
  // before it is written again)
  float dia = st.c0 == 0 ? 0.f : inf;
  if (wait) {
    const float x = await_slot(st.ring_in, st.v - 1);
    if (use) dia = x;
  }
  // only now, when every earlier strip (and every lane of this one: the
  // strip may be its own successor) has read its slot 0, publish this one
  syncwarp();
  if (lane == 31) st_slot(st.ring_out, slot(cur, st.v));
  const int steps = st.Pq + 31, G = (steps + 31) / 32;
  int flushed = 0;
  for (int gi = 0; gi < G; ++gi) {
    cp_async_wait<AHEAD - 1>();
    syncwarp();
    const int t1 = 32 * gi + 32 < steps ? 32 * gi + 32 : steps;
    float dk[CHUNK];
    unsigned long long w[CHUNK];
    load_chunk(row, 32 * gi, dk);
    ring_load(st, 32 * gi, w);
    for (int t0 = 32 * gi; t0 < t1; t0 += CHUNK) {
      float above[CHUNK];
      ring_chunk(st, t0, wait, use, inf, w, above);
      // the next chunk's D, read while this one runs (past the group's end
      // it is not used: that chunk reads its own after the group's wait)
      float next[CHUNK];
      load_chunk(row, t0 + CHUNK, next);
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) dk[j] *= k;
      if (gi == 0)
        fwd_chunk<true>(f, st, row, t0, dk, above, cur, dia, w);
      else
        fwd_chunk<false>(f, st, row, t0, dk, above, cur, dia, w);
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) dk[j] = next[j];
    }
    syncwarp();
    const int upto = gi == G - 1 ? st.nb : gi;
    for (; flushed < upto; ++flushed) f.flush(g, st, tile, flushed);
    syncwarp();
    if (gi + AHEAD < st.nb) f.load(g, st, tile, gi + AHEAD);
    cp_async_commit();
  }
  cp_async_wait<0>();
  syncwarp();
}

// ---------------------------------------------------------------------------
// backward (logical row i' = N - 1 - i, column j' = M - 1 - j of E and D)
// ---------------------------------------------------------------------------

struct Bwd {
  static constexpr int WARPS = BWD_WARPS;
  // R and D tiles: row r is logical row 32 s - 1 + r (the row above the
  // strip, then its 32), skewed by max(r - 1, 0); then E, row l skewed by l
  static constexpr int ROWS = 33;
  static constexpr int TILE_FLOATS = (2 * ROWS + 32) * TS;
  const float* Db;
  const float* Rb;
  float* Eb;
  long long W;
  float inv_g;  // 1 / g

  __device__ void load(const Schedule& g, const Strip& st, float* tile, int b) const {
    const int col = 32 * b + st.lane;
    const int ja = g.M - 1 - (st.c0 + col);  // actual column
    const bool ok_col = col < st.Pq;
    float* rt = tile;
    float* dt = tile + ROWS * TS;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int il = 32 * st.s - 1 + r, ia = g.N - 1 - il;
      const bool ok = ok_col && il >= 0 && il < g.N;
      const int at = r * TS + ((col + (r > 0 ? r - 1 : 0)) & (TILE - 1));
      cp_async4(rt + at, ok ? Rb + (ia + 1) * W + ja + 1 : Rb, ok);
      cp_async4(dt + at, ok ? Db + (long long)ia * g.M + ja : Db, ok);
    }
  }
  __device__ void flush(const Schedule& g, const Strip& st, const float* tile, int b) const {
    const int col = 32 * b + st.lane;
    if (col >= st.Pq) return;
    const int ja = g.M - 1 - (st.c0 + col);
    const float* et = tile + 2 * ROWS * TS;
    float* dst = Eb + (long long)(g.N - 1 - 32 * st.s) * g.M + ja;
    float v[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) v[r] = et[r * TS + ((col + r) & (TILE - 1))];
    write_rows(dst, -(long long)g.M, g.N - 32 * st.s, v);
  }
  // R and D at logical (il, jl), 0 <= il < N, 0 <= jl < M
  __device__ float r_at(const Schedule& g, int il, int jl) const {
    return Rb[(g.N - il) * W + g.M - jl];
  }
  __device__ float d_at(const Schedule& g, int il, int jl) const {
    return Db[(long long)(g.N - 1 - il) * g.M + g.M - 1 - jl];
  }
};

// exp(min((r_nb - r - d_nb) / g, 0)).  expf, not ex2.approx: E sums
// products of up to N + M weights, and the approximation's bias compounds
// along them (at N = M = 2048 past the 1e-4 the kernel is held to, where
// expf stays as close to float64 as the plain version)
__device__ __forceinline__ float weight(float r_nb, float r, float d_nb, float inv_g) {
  return expf(fminf(((r_nb - r) - d_nb) * inv_g, 0.f));
}

// R and D of a lane's left neighbour (its previous column) and upper left
// neighbour, carried from chunk to chunk
struct Carry {
  float r_left, d_left, r_diag, d_diag;
};

// One step of a lane's backward chain: from its left neighbour's E `e_cur`
// and upper left's `e_dia` (which becomes the upper neighbour's, for the
// next step), the upper neighbour's by shuffle (lane 0: `above`) and the
// cell's weights, E of its cell.  E[i+1, j] arrives last.
__device__ __forceinline__ float bwd_step(float e_cur, float& e_dia, float above, float a,
                                          float b, float c, int lane) {
  const float part = fmaf(e_cur, b, e_dia * c);
  float e_up = shfl_up(e_cur);
  if (lane == 0) e_up = above;
  e_dia = e_up;
  return fmaf(e_up, a, part);
}

template <bool RAMP>
__device__ __forceinline__ void bwd_chunk(const Bwd& f, const Strip& st, float* tile, int t0,
                                          const float (&above)[CHUNK], float& e_cur,
                                          float& e_dia, Carry& cy,
                                          unsigned long long (&w_next)[CHUNK]) {
  const int lane = st.lane;
  const float inv_g = f.inv_g;
  float r[CHUNK], d[CHUNK], r0[CHUNK], d0[CHUNK], ru[CHUNK], du[CHUNK];
  load_chunk(tile + (lane + 1) * TS, t0, r);
  load_chunk(tile + (Bwd::ROWS + lane + 1) * TS, t0, d);
  load_chunk(tile, t0, r0);  // the row above the strip: lane 0's upper neighbours
  load_chunk(tile + Bwd::ROWS * TS, t0, d0);
  // the upper neighbours: lane l-1's own, one column earlier
#pragma unroll
  for (int j = 0; j < CHUNK; ++j) {
    ru[j] = shfl_up(j == 0 ? cy.r_left : r[j - 1]);
    du[j] = shfl_up(j == 0 ? cy.d_left : d[j - 1]);
    if (lane == 0) {
      ru[j] = r0[j];
      du[j] = d0[j];
    }
  }
  // the weights: R and D only, off the E chain
  float a[CHUNK], b[CHUNK], c[CHUNK], e[CHUNK];
#pragma unroll
  for (int j = 0; j < CHUNK; ++j) {
    a[j] = weight(ru[j], r[j], du[j], inv_g);
    b[j] = weight(cy.r_left, r[j], cy.d_left, inv_g);
    c[j] = weight(cy.r_diag, r[j], cy.d_diag, inv_g);
    if (!RAMP || t0 + j >= lane) cy = Carry{r[j], d[j], ru[j], du[j]};
  }
#pragma unroll
  for (int j = 0; j < CHUNK; ++j) {
    if (j == CHUNK / 2) ring_load(st, t0 + CHUNK, w_next);  // the next chunk's slots
    e[j] = bwd_step(e_cur, e_dia, above[j], a[j], b[j], c[j], lane);
    if (!RAMP || t0 + j >= lane) e_cur = e[j];
  }
  store_chunk(tile + (2 * Bwd::ROWS + lane) * TS, t0, e, 1.f);
  publish_chunk(st, t0, e);
}

__device__ void bwd_strip(const Schedule& g, const Bwd& f, const Strip& st, float* tile) {
  const int lane = st.lane, il = 32 * st.s + lane;
  const bool wait = st.v > 0, use = st.s > 0;
  for (int b = 0; b < AHEAD; ++b) {
    if (b < st.nb) f.load(g, st, tile, b);
    cp_async_commit();
  }
  // left edge, logical column c0 - 1: E read back from the panel before, and
  // R and D of that column and of the row above (border cells, E = 0 there,
  // in the first panel and above the first row: any finite value will do,
  // but for the corner (-1, -1) whose weight is 1: R[N+1, M+1] = R[N, M])
  const bool row_ok = il < g.N, up_ok = il >= 1 && il <= g.N;
  float e_cur = st.q > 0 && row_ok ? f.Eb[(long long)(g.N - 1 - il) * g.M + g.M - st.c0] : 0.f;
  Carry cy{0.f, 0.f, 0.f, 0.f};
  if (st.q > 0 && row_ok) {
    cy.r_left = f.r_at(g, il, st.c0 - 1);
    cy.d_left = f.d_at(g, il, st.c0 - 1);
  }
  if (st.q > 0 && up_ok) {
    cy.r_diag = f.r_at(g, il - 1, st.c0 - 1);
    cy.d_diag = f.d_at(g, il - 1, st.c0 - 1);
  }
  if (il == 0 && st.q == 0) cy.r_diag = f.r_at(g, 0, 0);
  // lane 0's E of the upper left neighbour for column 0
  float e_dia = st.s == 0 && st.q == 0 ? 1.f : 0.f;
  if (wait) {
    const float x = await_slot(st.ring_in, st.v - 1);
    if (use) e_dia = x;
  }
  syncwarp();
  if (lane == 31) st_slot(st.ring_out, slot(e_cur, st.v));
  const int steps = st.Pq + 31, G = (steps + 31) / 32;
  int flushed = 0;
  for (int gi = 0; gi < G; ++gi) {
    cp_async_wait<AHEAD - 1>();
    syncwarp();
    const int t1 = 32 * gi + 32 < steps ? 32 * gi + 32 : steps;
    unsigned long long w[CHUNK];
    ring_load(st, 32 * gi, w);
    for (int t0 = 32 * gi; t0 < t1; t0 += CHUNK) {
      float above[CHUNK];
      ring_chunk(st, t0, wait, use, 0.f, w, above);
      if (gi == 0)
        bwd_chunk<true>(f, st, tile, t0, above, e_cur, e_dia, cy, w);
      else
        bwd_chunk<false>(f, st, tile, t0, above, e_cur, e_dia, cy, w);
    }
    syncwarp();
    const int upto = gi == G - 1 ? st.nb : gi;
    for (; flushed < upto; ++flushed) f.flush(g, st, tile, flushed);
    syncwarp();
    if (gi + AHEAD < st.nb) f.load(g, st, tile, gi + AHEAD);
    cp_async_commit();
  }
  cp_async_wait<0>();
  syncwarp();
}

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

template <class Dir>
__device__ __forceinline__ float* setup(const Schedule& g, unsigned long long*& rings) {
  extern __shared__ __align__(16) unsigned char smem[];
  rings = reinterpret_cast<unsigned long long*>(smem);
  for (int x = threadIdx.x; x < g.NW * ring_slots(g.P); x += blockDim.x) rings[x] = NO_TAG;
  float* tiles = reinterpret_cast<float*>(rings + g.NW * ring_slots(g.P));
  return tiles + (threadIdx.x >> 5) * Dir::TILE_FLOATS;
}

__global__ void __launch_bounds__(FWD_WARPS * 32) fwd_kernel(const float* __restrict__ D,
                                                             float* __restrict__ R, int N, int M,
                                                             float k, float c) {
  const Schedule g(N, M, FWD_WARPS);
  const Fwd f{D + (long long)blockIdx.x * N * M, R + (long long)blockIdx.x * (N + 2) * (M + 2),
              M + 2, k, c};
  for (int j = threadIdx.x; j < M + 2; j += blockDim.x) {
    f.Rb[j] = j == 0 ? 0.f : INF;
    f.Rb[(N + 1) * f.W + j] = INF;
  }
  for (int i = 1 + threadIdx.x; i < N + 1; i += blockDim.x) {
    f.Rb[i * f.W] = INF;
    f.Rb[i * f.W + M + 1] = INF;
  }
  unsigned long long* rings;
  float* tile = setup<Fwd>(g, rings);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  for (int q = 0; q < g.Q; ++q)
    for (int s = warp; s < g.S; s += g.NW) fwd_strip(g, f, Strip(g, rings, warp, q, s), tile);
}

__global__ void __launch_bounds__(BWD_WARPS * 32) bwd_kernel(const float* __restrict__ D,
                                                             const float* __restrict__ R,
                                                             float* __restrict__ E, int N, int M,
                                                             float inv_g) {
  const Schedule g(N, M, BWD_WARPS);
  const Bwd f{D + (long long)blockIdx.x * N * M, R + (long long)blockIdx.x * (N + 2) * (M + 2),
              E + (long long)blockIdx.x * N * M, M + 2, inv_g};
  unsigned long long* rings;
  float* tile = setup<Bwd>(g, rings);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  for (int q = 0; q < g.Q; ++q)
    for (int s = warp; s < g.S; s += g.NW) bwd_strip(g, f, Strip(g, rings, warp, q, s), tile);
}

// The chain alone: one warp runs `steps` steps (a multiple of CHUNK) of
// fwd_step (backward = 0) or bwd_step from registers, with no loads, stores
// or waits in the loop, alone on its SM, so that a step takes the latency of
// its dependent instructions; N + M - 1 such steps are the least time either
// kernel can take.  out[0] gets the SM cycles and out[1] the nanoseconds of
// the loop (lane 0's clock64 and globaltimer); sink keeps the results live.
__global__ void __launch_bounds__(32) chain_kernel(int backward, int steps,
                                                   const float* __restrict__ in,
                                                   long long* __restrict__ out,
                                                   float* __restrict__ sink) {
  const int lane = threadIdx.x;
  float x[CHUNK];
#pragma unroll
  for (int j = 0; j < CHUNK; ++j) x[j] = in[j];
  float cur = in[lane % CHUNK], dia = in[(lane + 1) % CHUNK];
  __syncwarp();
  long long c0, c1, t0, t1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c0));
  asm volatile("" : "+f"(cur), "+f"(dia));  // the loop starts after the clocks are read
  if (backward) {
    for (int t = 0; t < steps; t += CHUNK) {
#pragma unroll
      for (int j = 0; j < CHUNK; ++j)
        cur = bwd_step(cur, dia, x[j], x[j], x[(j + 1) % CHUNK], x[(j + 2) % CHUNK], lane);
    }
  } else {
    for (int t = 0; t < steps; t += CHUNK) {
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) cur = fwd_step(cur, dia, x[j], x[j], lane);
    }
  }
  asm volatile("" : "+f"(cur), "+f"(dia));  // and ends before they are read again
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c1));
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
  sink[lane] = cur + dia;
  if (lane == 0) {
    out[0] = c1 - c0;
    out[1] = t1 - t0;
  }
}

// Dynamic shared memory past 48 KB has to be allowed for each kernel on
// each device: once, and again only for a launch that needs more.
constexpr int MAX_DEVICES = 64;
std::atomic<int> fwd_smem_allowed[MAX_DEVICES], bwd_smem_allowed[MAX_DEVICES];

template <class Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t smem, std::atomic<int>* allowed) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && (int)smem <= allowed[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && dev < MAX_DEVICES) {
    int seen = allowed[dev].load();
    while ((int)smem > seen && !allowed[dev].compare_exchange_weak(seen, (int)smem)) {
    }
  }
  return err;
}

// warps and dynamic shared memory of a launch
template <class Dir>
void launch_shape(int N, int M, int& threads, size_t& smem) {
  const int S = (N + 31) / 32, NW = S < Dir::WARPS ? S : Dir::WARPS;
  const int P = M < PANEL ? M : PANEL;
  threads = NW * 32;
  smem = (size_t)NW * ring_slots(P) * sizeof(unsigned long long) +
         (size_t)NW * Dir::TILE_FLOATS * sizeof(float);
}

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

}  // namespace

// D [B, N, M] f32 contiguous -> R [B, N+2, M+2].  Returns a cudaError_t.
extern "C" int dae_softdtw_fwd(const float* D, float* R, int B, int N, int M, float gamma,
                               void* stream) {
  if (B < 1 || N < 1 || M < 1 || !(gamma > 0.f)) return (int)cudaErrorInvalidValue;
  int threads;
  size_t smem;
  launch_shape<Fwd>(N, M, threads, smem);
  const cudaError_t err = allow_smem(fwd_kernel, smem, fwd_smem_allowed);
  if (err != cudaSuccess) return (int)err;
  fwd_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(D, R, N, M, LOG2E / gamma,
                                                                      gamma * LN2);
  return (int)cudaGetLastError();
}

// D [B, N, M], R [B, N+2, M+2] from dae_softdtw_fwd -> E [B, N, M].
extern "C" int dae_softdtw_bwd(const float* D, const float* R, float* E, int B, int N, int M,
                               float gamma, void* stream) {
  if (B < 1 || N < 1 || M < 1 || !(gamma > 0.f)) return (int)cudaErrorInvalidValue;
  int threads;
  size_t smem;
  launch_shape<Bwd>(N, M, threads, smem);
  const cudaError_t err = allow_smem(bwd_kernel, smem, bwd_smem_allowed);
  if (err != cudaSuccess) return (int)err;
  bwd_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(D, R, E, N, M,
                                                                      1.f / gamma);
  return (int)cudaGetLastError();
}

// One step of the forward's (backward = 0) or the backward's dependent
// chain, run alone: result[0] the SM cycles and result[1] the nanoseconds
// of `steps` steps (rounded up to a multiple of CHUNK, which it returns in
// result[2]).  Synchronous, on the current device.  Returns a cudaError_t.
extern "C" int dae_softdtw_chain(int backward, int steps, long long* result) {
  if (steps < 1) return (int)cudaErrorInvalidValue;
  steps = (steps + CHUNK - 1) / CHUNK * CHUNK;
  float in[CHUNK];
  for (int j = 0; j < CHUNK; ++j) in[j] = 0.2f + 0.04f * j;  // D, and weights below 1
  float *d_in = nullptr, *d_sink = nullptr;
  long long* d_out = nullptr;
  cudaError_t err = cudaMalloc(&d_in, sizeof in);
  if (err == cudaSuccess) err = cudaMalloc(&d_sink, 32 * sizeof(float));
  if (err == cudaSuccess) err = cudaMalloc(&d_out, 2 * sizeof(long long));
  if (err == cudaSuccess) err = cudaMemcpy(d_in, in, sizeof in, cudaMemcpyHostToDevice);
  if (err == cudaSuccess) {
    chain_kernel<<<1, 32>>>(backward, steps, d_in, d_out, d_sink);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess)
    err = cudaMemcpy(result, d_out, 2 * sizeof(long long), cudaMemcpyDeviceToHost);
  result[2] = steps;
  cudaFree(d_in);
  cudaFree(d_sink);
  cudaFree(d_out);
  return (int)err;
}

extern "C" const char* dae_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
