// Mamba2 SSD chunked scan for Hopper (sm_90a): the forward and the
// reverse-chunk backward, each chunk-parallel on the tensor cores.
// The chunk length Q is a template parameter of every phase: 64 and 32
// are built for each (P, N) (kernels/ssd.py::CHUNKS; kernels/autotune.py
// picks one per (sequence bucket, P, N, dtype)).  A chunk of 128 is not
// built: its backward chunk phase would need 390,752 bytes of shared
// memory at (P, N) = (64, 128) and 244,320 at (64, 16), beyond the
// 232,448 a block may opt into; at the reduced configs' (16, 16) it
// would fit (191,328), but its Q x Q tiles outnumber the warps, which the
// W, cb and dW steps (one tile a warp) do not handle, and no training
// path runs that shape.  SSD is chunk-invariant in exact arithmetic; two
// chunks sum in another order.
//
// Replace repro/kernels/ssd.py::_ssd_kernel and ::_ssd_bwd_kernel.  Per
// chunk c of Q rows the forward computes, in fp32,
//     cum    = cumsum(dt * A)
//     y      = (tri(C.B^T * e^(cum_i - cum_j)) * dt_j).x + (C * e^cum).S_c^T
//     S_c+1  = S_c * e^cum_Q + (x * e^(cum_Q - cum) * dt)^T.B
// and the backward carries the state cotangent dS1 through the chunks in
// reverse, with the reference's nine products per chunk.
//
// Layouts are the JAX package's public ones: x, y, gy, dx [b, S, H, P];
// dt, ddt [b, S, H] fp32; A [H] fp32; B, C, dB, dC [b, S, H, N]; states
// [b, H, P, N] fp32; cstates [b, H, nc, P, N] fp32 (the state entering
// each chunk, the backward's residual); dA partials [b, H, nc] fp32.  x,
// dt, B, C and gy are read in place through their (batch, seq, head)
// strides with the last dim dense, so B and C may be one group expanded
// over the heads with head stride 0.  Rows at or past S read as zero and
// are never written.  Outputs are written contiguous.
//
// Design.  The state entering chunk c is a linear recurrence over the
// chunks, S_c+1 = S_c e^cum_Q,c + L_c, whose terms L_c depend on chunk c
// alone; so does the cotangent, dS1_c-1 = e^cum_Q,c dS1_c + L'_c.  Each
// kernel therefore runs three phases, launched on the caller's stream by
// one C entry point:
//   forward  1. ssd_fwd_states_kernel, grid (chunk, head, batch): L_c =
//               (x * w_last)^T.B into cstates[c + 1] (into the final
//               state for the last chunk);
//            2. ssd_fwd_scan_kernel (csrc/ssd_scan.cuh, which ssd_wgmma.cu
//               shares), grid (P.N tile, head, batch): S_0 =
//               0 and S_c+1 = S_c e^cum_Q + L_c in place, chunk by chunk
//               (the reference's order); the final state last;
//            3. ssd_fwd_out_kernel, grid (chunk, head, batch): y.
//   backward 1. ssd_bwd_states_kernel: L'_c = gy^T.(C e^cum) into an fp32
//               scratch [b, H, nc, P, N] the wrapper allocates;
//            2. ssd_bwd_scan_kernel: the scratch's chunk c becomes dS1_c
//               (from gstate, in reverse chunk order);
//            3. ssd_bwd_chunk_kernel: dx, ddt, dB, dC and one dA partial
//               per chunk from S0 = cstates[c] and dS1_c.
// At the mamba2-780m shape (b 1, S 2048, H 48) phases 1 and 3 run 1536
// blocks where one block per (head, batch) walking the chunks ran 48.
// Every product runs on the tensor cores (tensor_core.cuh: 3xTF32
// mma.sync, one warp per 16 x 8n output tile, the block's 8 warps (16 in
// the backward's chunk phase) over the tiles; products with a causal
// factor skip the tiles and k-steps above the diagonal).  Operands are
// staged in shared memory in fp32 at a pitch of D + 4 floats (cp.async
// where rows are 16-byte aligned), so bf16 inputs run the same 3xTF32
// products: the states, ddt and dA stay
// fp32 in bf16 and keep the fp32 tolerance, which products of fp32
// intermediates in bf16 would not.  A product whose operands are both
// read along k row by row permutes k inside each step of 8 (slot t <->
// 2t, slot t + 4 <-> 2t + 1, which leaves the sum unchanged) so that
// every fragment read hits 32 distinct banks; the others read k in
// order.  Decays are masked before the exp (the reference's chunked
// evaluator masks after it and gives NaN gradients at full width).
//
// Bound on the H100 at the mamba2-780m shape (x [1, 2048, 48, 64], N
// 128, one B/C group): the forward's reference products are 4.4 GFLOP
// (0.0664 ms at the fp32 rate, 0.0270 ms as 3xTF32) against 105 MB
// (0.031 ms); the backward's 9.7 GFLOP (0.1450, 0.0589 ms) against 231
// MB (0.069 ms).  On the tensor cores both are bound by bytes; the
// phases add a pass over the [P, N] states of every chunk (write,
// scan, read: 50 MB each way at this shape).  Shared memory per block
// at (P, N) = (64, 128): states phases 52,496 bytes, forward outputs
// 103,696 (two blocks an SM), backward chunks 177,504 (one block an SM:
// x, gy, B, C, the entering state and two Q x Q tiles; the kernel runs
// 16 warps, which took 11 % less time than 8 on the H100).  At chunk 32
// the backward chunks take 96,960 bytes and 8 warps: two blocks an SM.
//
// Plain C interface (extern "C"), loaded with ctypes by kernels/build.py.
// Every entry point takes the stream it must launch on, allocates
// nothing, does not synchronise, and returns the first CUDA error of its
// launches.  dtype codes: 0 = float32, 1 = bfloat16 (x, B, C, gy and
// their gradients; the rest is fp32).  No atomics, and every sum runs in
// a fixed order: the same inputs give bitwise-equal outputs.
#include <cstdint>

#include "ssd_scan.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int NT = 256;         // threads per block: 8 warps
constexpr int WARPS = NT / 32;

// Chunk geometry: Q rows a chunk, rows per lane of a chunk-wide warp
// scan, the row pitch of a Q x Q tile, and the backward chunk kernel's
// threads (16 warps at chunk 64, 8 at chunk 32) and blocks an SM.
template <int Q>
struct Geom {
  static_assert(Q == 32 || Q == 64, "chunks of 32 or 64 rows are built");
  static constexpr int RL = Q / 32;
  static constexpr int LQ = Q + 4;
  static constexpr int CNT = Q == 64 ? 512 : 256;
  static constexpr int CWARPS = CNT / 32;
  static constexpr int CBLOCKS = Q == 64 ? 1 : 2;
};

struct Strides {
  long long b, s, h;            // elements; the last dim has stride 1
};

// One argument block for every kernel (unused pointers are null).
struct SsdArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* cstates_in;      // backward: the forward's cstates
  const void* gy;
  const float* gstate;
  void* y;
  float* state;
  float* cstates;               // forward: the state entering each chunk
  float* scratch;               // backward: L'_c, then dS1_c
  void* dx;
  float* ddt;
  void* dB;
  void* dC;
  float* dA_part;
  int b, S, H, nc;
  Strides xs, dts, Bs, Cs, gs;
  bool vec;                     // rows of x, B, C (gy) 16-byte aligned
};

// Warp tiles of an M x W output: 16 rows by 8 NB columns, NB column
// tiles of 8 (at most MAXNB), counted row-major.
template <int M, int W, int MAXNB = 4>
struct Tiles {
  static constexpr int nb = W / 8 < MAXNB ? W / 8 : MAXNB;
  static constexpr int cols = W / (8 * nb);
  static constexpr int count = (M / 16) * cols;
  __device__ static int row0(int tile) { return (tile / cols) * 16; }
  __device__ static int col0(int tile) { return (tile % cols) * 8 * nb; }
};

// Rows [row0, row0 + Q) of one head (row stride rs, last dim dense) into
// dst[r * (D + 4) + d] in fp32, rows at or past S as 0, by TH threads.
// fp32: cp.async, 16 bytes a copy when vec; bf16: loads converted to fp32.
template <typename T, int D, int Q, int TH = NT>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           long long rs, int row0, int S,
                                           bool vec) {
  constexpr int LD = D + 4;
  if constexpr (sizeof(T) == 4) {
    if (vec) {
      for (int c = threadIdx.x; c < Q * D / 4; c += TH) {
        const int r = c / (D / 4), d = (c % (D / 4)) * 4, row = row0 + r;
        const bool ok = row < S;
        cp_async16(dst + r * LD + d, ok ? src + row * rs + d : src,
                   ok ? 16 : 0);
      }
    } else {
      for (int e = threadIdx.x; e < Q * D; e += TH) {
        const int r = e / D, d = e % D, row = row0 + r;
        const bool ok = row < S;
        cp_async4(dst + r * LD + d, ok ? src + row * rs + d : src, ok ? 4 : 0);
      }
    }
  } else {
    for (int e = threadIdx.x; e < Q * D; e += TH) {
      const int r = e / D, d = e % D, row = row0 + r;
      dst[r * LD + d] = row < S ? to_f(src[row * rs + d]) : 0.f;
    }
  }
}

// A contiguous [R][D] fp32 matrix into dst at pitch D + 4 (cp.async), by
// TH threads.
template <int R, int D, int TH = NT>
__device__ __forceinline__ void stage_state(float* dst, const float* src) {
  for (int c = threadIdx.x; c < R * D / 4; c += TH) {
    const int r = c / (D / 4), d = (c % (D / 4)) * 4;
    cp_async16(dst + r * (D + 4) + d, src + r * D + d, 16);
  }
}

template <int Q>
__device__ __forceinline__ void load_dt(float* dst, const float* src,
                                        long long row_stride, int row0, int S) {
  if (threadIdx.x < Q) {
    const int row = row0 + threadIdx.x;
    dst[threadIdx.x] = row < S ? src[row * row_stride] : 0.f;
  }
}

// acc[n] += the warp's 16 x 8 NB tile of A.B over k in [k0, k1) (steps
// of 8), as 3xTF32 mma.sync.  a(r, k): row r of the tile (0..15); b(k, n):
// column n of the tile (0..8 NB - 1).  PERM permutes k inside each step
// (slot t <-> 2t, t + 4 <-> 2t + 1) for operands read along k row by row.
template <int NB, bool PERM, typename FA, typename FB>
__device__ __forceinline__ void warp_mma(float (&acc)[NB][4], int k0, int k1,
                                         FA a, FB b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int s0 = PERM ? 2 * t : t, s1 = PERM ? 2 * t + 1 : t + 4;
  for (int kk = k0; kk < k1; kk += 8) {
    uint32_t ab[4], as[4], bb[NB][2], bs[NB][2];
    split_tf32(a(g, kk + s0), ab[0], as[0]);
    split_tf32(a(g + 8, kk + s0), ab[1], as[1]);
    split_tf32(a(g, kk + s1), ab[2], as[2]);
    split_tf32(a(g + 8, kk + s1), ab[3], as[3]);
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      split_tf32(b(kk + s0, 8 * n + g), bb[n][0], bs[n][0]);
      split_tf32(b(kk + s1, 8 * n + g), bb[n][1], bs[n][1]);
    }
    mma_3xtf32<NB>(acc, ab, as, bb, bs);
  }
}

template <int NB>
__device__ __forceinline__ void zero(float (&acc)[NB][4]) {
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// (row, column) within the tile of accumulator element (n, e).
__device__ __forceinline__ int frag_row(int e) {
  return ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int frag_col(int n, int e) {
  return 8 * n + 2 * (threadIdx.x & 3) + (e & 1);
}

// Sums over the lanes of a fragment: a row's 4 lanes (t), a column's 8
// lanes (g), in a fixed butterfly order.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}
__device__ __forceinline__ float col_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 4);
  v += __shfl_xor_sync(FULL, v, 8);
  return v + __shfl_xor_sync(FULL, v, 16);
}

// Store the warp's [16 x 8 NB] tile at (row0, col0) of a row-major
// matrix (ld columns) in T, rows at or past `rows` skipped.
template <typename T, int NB, typename F>
__device__ __forceinline__ void store_tile(T* dst, long long ld, int row0,
                                           int col0, int rows, F value) {
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + frag_row(e), c = col0 + frag_col(n, e);
      if (r < rows) dst[r * ld + c] = from_f<T>(value(n, e, r, c));
    }
}

// Shared memory of each kernel, in floats (see the kernels' carve-up).
template <int P, int N, int Q> constexpr int fwd_states_floats() {
  return Q * (P + 4) + Q * (N + 4) + 5 * Q + 4;
}
template <int P, int N, int Q> constexpr int fwd_out_floats() {
  return Q * (P + 4) + (P > Q ? P : Q) * (N + 4) + Q * (N + 4) +
         Q * Geom<Q>::LQ + 5 * Q + 4;
}
template <int P, int N, int Q> constexpr int bwd_states_floats() {
  return Q * (P + 4) + Q * (N + 4) + 5 * Q + 4;
}
// The backward chunk kernel's warp tiles: Q x Q (cb, dW), Q x P (dx) and
// Q x N (dB, dC), one or two a warp.
template <int Q> using ChunkTQ = Tiles<Q, Q, 2>;
template <int P, int Q> using ChunkTP = Tiles<Q, P, 2>;
template <int N, int Q> using ChunkTN = Tiles<Q, N, 4>;
template <int P, int N, int Q> constexpr int bwd_chunk_floats() {
  return 2 * Q * (P + 4) + 2 * Q * (N + 4) + 2 * Q * Geom<Q>::LQ +
         P * (N + 4) + 9 * Q + ChunkTQ<Q>::cols * Q + (Q / 16) * Q +
         2 * ChunkTN<N, Q>::cols * Q + Geom<Q>::CWARPS + 8;
}

// The block's chunk: (chunk, head, batch) from the grid.
template <int Q>
struct Chunk {
  int c, h, bi, row0;
  long long bh;
  __device__ explicit Chunk(const SsdArgs& a) {
    c = blockIdx.x;
    h = blockIdx.y;
    bi = blockIdx.z;
    row0 = c * Q;
    bh = (long long)bi * a.H + h;
  }
  template <typename T>
  __device__ const T* at(const void* p, const Strides& s) const {
    return static_cast<const T*>(p) + bi * s.b + h * s.h;
  }
};

// ---------------------------------------------------------------------
// Forward, phase 1.  L_c = (x * w_last)^T.B, [P, N] over the chunk's Q
// rows, into cstates[c + 1], or into the final state for the last chunk.
// ---------------------------------------------------------------------
template <typename T, int P, int N, int Q>
__global__ void __launch_bounds__(NT, 2)
ssd_fwd_states_kernel(const SsdArgs a) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [Q][P + 4]
  float* Bm = xs + Q * (P + 4);                  // [Q][N + 4]
  float* dtv = Bm + Q * (N + 4);                 // [Q]
  float* cum = dtv + Q;
  float* ecum = cum + Q;
  float* el = ecum + Q;                          // e^(cum_Q - cum)
  float* wl = el + Q;                            // w_last
  float* sc = wl + Q;                            // [4]
  const Chunk<Q> k(a);
  stage_rows<T, P, Q>(xs, k.template at<T>(a.x, a.xs), a.xs.s, k.row0, a.S,
                      a.vec);
  stage_rows<T, N, Q>(Bm, k.template at<T>(a.B, a.Bs), a.Bs.s, k.row0, a.S,
                      a.vec);
  cp_async_commit();
  load_dt<Q>(dtv, a.dt + k.bi * a.dts.b + k.h * a.dts.h, a.dts.s, k.row0,
             a.S);
  cp_async_wait<0>();
  __syncthreads();
  chunk_decay<Q>(dtv, a.A[k.h], cum, ecum, el, wl, sc);
  __syncthreads();
  using Til = Tiles<P, N>;
  float* dst = k.c + 1 < a.nc ? a.cstates + (k.bh * a.nc + k.c + 1) * P * N
                              : a.state + k.bh * P * N;
  for (int tile = threadIdx.x >> 5; tile < Til::count; tile += WARPS) {
    const int p0 = Til::row0(tile), n0 = Til::col0(tile);
    float acc[Til::nb][4];
    zero(acc);
    warp_mma<Til::nb, true>(
        acc, 0, Q,
        [&](int r, int j) { return xs[j * (P + 4) + p0 + r] * wl[j]; },
        [&](int j, int n) { return Bm[j * (N + 4) + n0 + n]; });
    store_tile<float, Til::nb>(
        dst, N, p0, n0, P, [&](int n, int e, int, int) { return acc[n][e]; });
  }
}

// ---------------------------------------------------------------------
// Forward, phase 3.  y = W.x + e^cum * (C.S_c^T), W = tri(C.B^T *
// e^(cum_i - cum_j)) * dt_j, with S_c = cstates[c] loaded into B's
// buffer once W is formed (so two blocks fit an SM at P 64, N 128).
// ---------------------------------------------------------------------
template <typename T, int P, int N, int Q>
__global__ void __launch_bounds__(NT, 2) ssd_fwd_out_kernel(const SsdArgs a) {
  constexpr int LP = P + 4, LN = N + 4, LQ = Geom<Q>::LQ;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [Q][LP]
  float* BS = xs + Q * LP;                       // [Q][LN] B, then [P][LN] S
  float* Cm = BS + (P > Q ? P : Q) * LN;         // [Q][LN]
  float* Wm = Cm + Q * LN;                       // [Q][LQ]
  float* dtv = Wm + Q * LQ;                      // [Q]
  float* cum = dtv + Q;
  float* ecum = cum + Q;
  float* el = ecum + Q;
  float* wl = el + Q;
  float* sc = wl + Q;                            // [4]
  const Chunk<Q> k(a);
  const int warp = threadIdx.x >> 5;
  stage_rows<T, P, Q>(xs, k.template at<T>(a.x, a.xs), a.xs.s, k.row0, a.S,
                      a.vec);
  stage_rows<T, N, Q>(BS, k.template at<T>(a.B, a.Bs), a.Bs.s, k.row0, a.S,
                      a.vec);
  stage_rows<T, N, Q>(Cm, k.template at<T>(a.C, a.Cs), a.Cs.s, k.row0, a.S,
                      a.vec);
  cp_async_commit();
  load_dt<Q>(dtv, a.dt + k.bi * a.dts.b + k.h * a.dts.h, a.dts.s, k.row0,
             a.S);
  cp_async_wait<0>();
  __syncthreads();
  chunk_decay<Q>(dtv, a.A[k.h], cum, ecum, el, wl, sc);
  __syncthreads();
  using TWm = Tiles<Q, Q>;
  static_assert(TWm::count <= WARPS, "one W tile a warp at most");
  if (warp < TWm::count) {  // W, one 16 x 32 tile a warp; zero above the diagonal
    using Til = TWm;
    const int i0 = Til::row0(warp), j0 = Til::col0(warp);
    float cb[Til::nb][4];
    zero(cb);
    if (j0 <= i0 + 15)
      warp_mma<Til::nb, false>(
          cb, 0, N, [&](int r, int n) { return Cm[(i0 + r) * LN + n]; },
          [&](int n, int j) { return BS[(j0 + j) * LN + n]; });
#pragma unroll
    for (int n = 0; n < Til::nb; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + frag_row(e), j = j0 + frag_col(n, e);
        Wm[i * LQ + j] =
            i >= j ? cb[n][e] * expf(cum[i] - cum[j]) * dtv[j] : 0.f;
      }
  }
  __syncthreads();                               // B is free, W is in
  stage_state<P, N>(BS, a.cstates + (k.bh * a.nc + k.c) * P * N);
  cp_async_commit();
  using Til = Tiles<Q, P>;
  static_assert(Til::count <= WARPS, "one y tile a warp at most");
  const bool mine = warp < Til::count;
  const int i0 = mine ? Til::row0(warp) : 0, p0 = mine ? Til::col0(warp) : 0;
  float yi[Til::nb][4], ys[Til::nb][4];
  zero(yi);
  zero(ys);
  if (mine)      // W.x over the causal k range
    warp_mma<Til::nb, false>(
        yi, 0, i0 + 16, [&](int r, int j) { return Wm[(i0 + r) * LQ + j]; },
        [&](int j, int p) { return xs[j * LP + p0 + p]; });
  cp_async_wait<0>();
  __syncthreads();                               // S_c is in
  if (!mine) return;
  warp_mma<Til::nb, false>(
      ys, 0, N, [&](int r, int n) { return Cm[(i0 + r) * LN + n]; },
      [&](int n, int p) { return BS[(p0 + p) * LN + n]; });
  T* y = static_cast<T*>(a.y) +
         (((long long)k.bi * a.S + k.row0) * a.H + k.h) * P;
  store_tile<T, Til::nb>(y, (long long)a.H * P, i0, p0, a.S - k.row0,
                         [&](int n, int e, int i, int) {
                           return yi[n][e] + ecum[i] * ys[n][e];
                         });
}

// ---------------------------------------------------------------------
// Backward, phase 1.  L'_c = gy^T.(C e^cum), [P, N] over the chunk's Q
// rows, into the scratch's chunk c.
// ---------------------------------------------------------------------
template <typename T, int P, int N, int Q>
__global__ void __launch_bounds__(NT, 2)
ssd_bwd_states_kernel(const SsdArgs a) {
  extern __shared__ float4 smem4[];
  float* Gs = reinterpret_cast<float*>(smem4);   // [Q][P + 4]: gy
  float* Cm = Gs + Q * (P + 4);                  // [Q][N + 4]
  float* dtv = Cm + Q * (N + 4);                 // [Q]
  float* cum = dtv + Q;
  float* ecum = cum + Q;
  float* el = ecum + Q;
  float* wl = el + Q;
  float* sc = wl + Q;                            // [4]
  const Chunk<Q> k(a);
  stage_rows<T, P, Q>(Gs, k.template at<T>(a.gy, a.gs), a.gs.s, k.row0, a.S,
                      a.vec);
  stage_rows<T, N, Q>(Cm, k.template at<T>(a.C, a.Cs), a.Cs.s, k.row0, a.S,
                      a.vec);
  cp_async_commit();
  load_dt<Q>(dtv, a.dt + k.bi * a.dts.b + k.h * a.dts.h, a.dts.s, k.row0,
             a.S);
  cp_async_wait<0>();
  __syncthreads();
  chunk_decay<Q>(dtv, a.A[k.h], cum, ecum, el, wl, sc);
  __syncthreads();
  using Til = Tiles<P, N>;
  float* dst = a.scratch + (k.bh * a.nc + k.c) * P * N;
  for (int tile = threadIdx.x >> 5; tile < Til::count; tile += WARPS) {
    const int p0 = Til::row0(tile), n0 = Til::col0(tile);
    float acc[Til::nb][4];
    zero(acc);
    warp_mma<Til::nb, true>(
        acc, 0, Q, [&](int r, int i) { return Gs[i * (P + 4) + p0 + r]; },
        [&](int i, int n) { return Cm[i * (N + 4) + n0 + n] * ecum[i]; });
    store_tile<float, Til::nb>(
        dst, N, p0, n0, P, [&](int n, int e, int, int) { return acc[n][e]; });
  }
}

// ---------------------------------------------------------------------
// Backward, phase 3.  Per chunk, from S0 = cstates[c] and dS1_c:
//   cb = C.B^T, dW = gy.x^T; W = tri(cb e^..) dt_j, D = tri(dW e^..) dt_j,
//   X = tri(dW e^..) cb (kept only as its row and column sums);
//   dx = W^T.gy + w_last (B.dS1^T);  dB = D^T.C + w_last (x.dS1);
//   dC = D.B + e^cum (gy.S0);
// then cum's cotangent, ddt and the chunk's dA partial (warp 0).  dS1
// and S0 share one buffer: S0 replaces dS1 once dx and dB are done, and
// sum(dS1 * S0) is taken as it arrives.
// ---------------------------------------------------------------------
template <typename T, int P, int N, int Q>
__global__ void __launch_bounds__(Geom<Q>::CNT, Geom<Q>::CBLOCKS)
ssd_bwd_chunk_kernel(const SsdArgs a) {
  constexpr int LP = P + 4, LN = N + 4, LQ = Geom<Q>::LQ, RL = Geom<Q>::RL;
  constexpr int CNT = Geom<Q>::CNT, CWARPS = Geom<Q>::CWARPS;
  using TQ = ChunkTQ<Q>;
  using TP = ChunkTP<P, Q>;
  using TN = ChunkTN<N, Q>;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [Q][LP]
  float* Gs = xs + Q * LP;                       // [Q][LP]: gy
  float* Bm = Gs + Q * LP;                       // [Q][LN]
  float* Cm = Bm + Q * LN;                       // [Q][LN]
  float* Wm = Cm + Q * LN;                       // [Q][LQ]
  float* Dm = Wm + Q * LQ;                       // [Q][LQ]
  float* St = Dm + Q * LQ;                       // [P][LN]: dS1, then S0
  float* dtv = St + P * LN;                      // [Q] vectors
  float* cum = dtv + Q;
  float* ecum = cum + Q;
  float* el = ecum + Q;
  float* wl = el + Q;
  float* rsg = wl + Q;                           // rowsum(gy.S0 * C) e^cum
  float* dwv = rsg + Q;                          // d(w_last)
  float* rX = dwv + Q;                           // sum_j X[i][j] dt_j
  float* cX = rX + Q;                            // sum_i X[i][j]
  float* rXp = cX + Q;                           // [TQ::cols][Q] partials
  float* cXp = rXp + TQ::cols * Q;               // [Q / 16][Q]
  float* rsgp = cXp + (Q / 16) * Q;              // [TN::cols][Q]
  float* dwp = rsgp + TN::cols * Q;              // [TN::cols][Q]
  float* wsum = dwp + TN::cols * Q;              // [CWARPS]
  float* sc = wsum + CWARPS;                     // [8]: e^cum_Q, sum(dS1 S0)
  const Chunk<Q> k(a);
  const int warp = threadIdx.x >> 5;
  const int S = a.S, c = k.c;
  stage_rows<T, P, Q, CNT>(xs, k.template at<T>(a.x, a.xs), a.xs.s, k.row0, S,
                           a.vec);
  stage_rows<T, P, Q, CNT>(Gs, k.template at<T>(a.gy, a.gs), a.gs.s, k.row0,
                           S, a.vec);
  stage_rows<T, N, Q, CNT>(Bm, k.template at<T>(a.B, a.Bs), a.Bs.s, k.row0, S,
                           a.vec);
  stage_rows<T, N, Q, CNT>(Cm, k.template at<T>(a.C, a.Cs), a.Cs.s, k.row0, S,
                           a.vec);
  stage_state<P, N, CNT>(St, a.scratch + (k.bh * a.nc + c) * P * N);
  cp_async_commit();
  load_dt<Q>(dtv, a.dt + k.bi * a.dts.b + k.h * a.dts.h, a.dts.s, k.row0, S);
  cp_async_wait<0>();
  __syncthreads();
  const float A = a.A[k.h];
  chunk_decay<Q>(dtv, A, cum, ecum, el, wl, sc);
  __syncthreads();
  static_assert(TQ::count <= CWARPS, "one Q x Q tile a warp at most");
  static_assert(2 * Q < CNT, "the partial sums' threads");
  if (warp < TQ::count) {  // cb and dW, one 16 x 16 tile a warp: W, D, X's sums
    const int i0 = TQ::row0(warp), j0 = TQ::col0(warp);
    float cb[TQ::nb][4], dW[TQ::nb][4];
    zero(cb);
    zero(dW);
    if (j0 <= i0 + 15) {         // tiles above the diagonal are zero
      warp_mma<TQ::nb, false>(
          cb, 0, N, [&](int r, int n) { return Cm[(i0 + r) * LN + n]; },
          [&](int n, int j) { return Bm[(j0 + j) * LN + n]; });
      warp_mma<TQ::nb, false>(
          dW, 0, P, [&](int r, int p) { return Gs[(i0 + r) * LP + p]; },
          [&](int p, int j) { return xs[(j0 + j) * LP + p]; });
    }
    float rs[2] = {0.f, 0.f}, cs[TQ::nb][2];
#pragma unroll
    for (int n = 0; n < TQ::nb; ++n) {
      cs[n][0] = cs[n][1] = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + frag_row(e), j = j0 + frag_col(n, e);
        float w = 0.f, d = 0.f, xm = 0.f;
        if (i >= j) {            // the decay overflows above the diagonal
          const float decay = expf(cum[i] - cum[j]);
          const float dwd = dW[n][e] * decay;
          w = cb[n][e] * decay * dtv[j];
          d = dwd * dtv[j];
          xm = dwd * cb[n][e];
        }
        Wm[i * LQ + j] = w;
        Dm[i * LQ + j] = d;
        rs[e >> 1] += xm * dtv[j];
        cs[n][e & 1] += xm;
      }
    }
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float r = quad_sum(rs[h]);
      if ((lane & 3) == 0)
        rXp[(j0 / (8 * TQ::nb)) * Q + i0 + frag_row(2 * h)] = r;
    }
#pragma unroll
    for (int n = 0; n < TQ::nb; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = col_sum(cs[n][e]);
        if (lane < 4) cXp[(i0 / 16) * Q + j0 + frag_col(n, e)] = v;
      }
  }
  __syncthreads();
  const long long row_off = ((long long)k.bi * S + k.row0) * a.H + k.h;
  const int rows = S - k.row0;
  // dx = W^T.gy + w_last (B.dS1^T)
  for (int tile = warp; tile < TP::count; tile += CWARPS) {
    const int j0 = TP::row0(tile), p0 = TP::col0(tile);
    float g1[TP::nb][4], g2[TP::nb][4];
    zero(g1);
    zero(g2);
    warp_mma<TP::nb, true>(
        g1, j0, Q, [&](int r, int i) { return Wm[i * LQ + j0 + r]; },
        [&](int i, int p) { return Gs[i * LP + p0 + p]; });
    warp_mma<TP::nb, false>(
        g2, 0, N, [&](int r, int n) { return Bm[(j0 + r) * LN + n]; },
        [&](int n, int p) { return St[(p0 + p) * LN + n]; });
    store_tile<T, TP::nb>(static_cast<T*>(a.dx) + row_off * P,
                          (long long)a.H * P, j0, p0, rows,
                          [&](int n, int e, int j, int) {
                            return g1[n][e] + g2[n][e] * wl[j];
                          });
  }
  // dB = D^T.C + w_last (x.dS1); d(w_last) = rowsum(x.dS1 * B)
  for (int tile = warp; tile < TN::count; tile += CWARPS) {
    const int j0 = TN::row0(tile), n0 = TN::col0(tile);
    float g1[TN::nb][4], g2[TN::nb][4];
    zero(g1);
    zero(g2);
    warp_mma<TN::nb, true>(
        g1, j0, Q, [&](int r, int i) { return Dm[i * LQ + j0 + r]; },
        [&](int i, int n) { return Cm[i * LN + n0 + n]; });
    warp_mma<TN::nb, false>(
        g2, 0, P, [&](int r, int p) { return xs[(j0 + r) * LP + p]; },
        [&](int p, int n) { return St[p * LN + n0 + n]; });
    store_tile<T, TN::nb>(static_cast<T*>(a.dB) + row_off * N,
                          (long long)a.H * N, j0, n0, rows,
                          [&](int n, int e, int j, int) {
                            return g1[n][e] + g2[n][e] * wl[j];
                          });
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < TN::nb; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        rs[e >> 1] +=
            g2[n][e] * Bm[(j0 + frag_row(e)) * LN + n0 + frag_col(n, e)];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float r = quad_sum(rs[h]);
      if ((threadIdx.x & 3) == 0)
        dwp[(n0 / (8 * TN::nb)) * Q + j0 + frag_row(2 * h)] = r;
    }
  }
  __syncthreads();               // every read of dS1 is done
  {  // S0 into dS1's buffer, sum(dS1 * S0) on the way
    const float* s0 = a.cstates_in + (k.bh * a.nc + c) * P * N;
    float part = 0.f;
#pragma unroll 8
    for (int e = threadIdx.x; e < P * N; e += CNT) {
      const int o = (e / N) * LN + e % N;
      const float v = s0[e];
      part += St[o] * v;
      St[o] = v;
    }
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(FULL, part, o);
    if ((threadIdx.x & 31) == 0) wsum[warp] = part;
  }
  __syncthreads();
  // dC = D.B + e^cum (gy.S0); rowsum(gy.S0 * C)
  for (int tile = warp; tile < TN::count; tile += CWARPS) {
    const int i0 = TN::row0(tile), n0 = TN::col0(tile);
    float g1[TN::nb][4], g2[TN::nb][4];
    zero(g1);
    zero(g2);
    warp_mma<TN::nb, false>(
        g1, 0, i0 + 16, [&](int r, int j) { return Dm[(i0 + r) * LQ + j]; },
        [&](int j, int n) { return Bm[j * LN + n0 + n]; });
    warp_mma<TN::nb, false>(
        g2, 0, P, [&](int r, int p) { return Gs[(i0 + r) * LP + p]; },
        [&](int p, int n) { return St[p * LN + n0 + n]; });
    store_tile<T, TN::nb>(static_cast<T*>(a.dC) + row_off * N,
                          (long long)a.H * N, i0, n0, rows,
                          [&](int n, int e, int i, int) {
                            return g1[n][e] + g2[n][e] * ecum[i];
                          });
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < TN::nb; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        rs[e >> 1] +=
            g2[n][e] * Cm[(i0 + frag_row(e)) * LN + n0 + frag_col(n, e)];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float r = quad_sum(rs[h]);
      if ((threadIdx.x & 3) == 0)
        rsgp[(n0 / (8 * TN::nb)) * Q + i0 + frag_row(2 * h)] = r;
    }
  }
  __syncthreads();
  if (threadIdx.x < Q) {         // the partial sums, in a fixed order
    const int i = threadIdx.x;
    float r = 0.f, d = 0.f, g = 0.f;
    for (int t = 0; t < TQ::cols; ++t) r += rXp[t * Q + i];
    for (int t = 0; t < TN::cols; ++t) {
      d += dwp[t * Q + i];
      g += rsgp[t * Q + i];
    }
    rX[i] = r;
    dwv[i] = d;
    rsg[i] = g * ecum[i];
  } else if (threadIdx.x < 2 * Q) {
    const int j = threadIdx.x - Q;
    float s = 0.f;
    for (int t = 0; t < Q / 16; ++t) s += cXp[t * Q + j];
    cX[j] = s;
  } else if (threadIdx.x == 2 * Q) {
    float s = 0.f;
    for (int w = 0; w < CWARPS; ++w) s += wsum[w];
    sc[1] = s;
  }
  __syncthreads();
  if (threadIdx.x < 32) {        // the cum cotangent, ddt and dA (warp 0)
    const int l = threadIdx.x;   // rows RL l .. RL l + RL - 1
    float dc[RL], v[RL], vs = 0.f;
#pragma unroll
    for (int q = 0; q < RL; ++q) {
      const int i = RL * l + q;
      v[q] = dwv[i] * wl[i];
      dc[q] = rX[i] - dtv[i] * cX[i] + rsg[i] - v[q];
      vs += v[q];
    }
    for (int o = 16; o > 0; o >>= 1) vs += __shfl_xor_sync(FULL, vs, o);
    if (l == 31) dc[RL - 1] += sc[1] * sc[0] + vs;   // cum_Q's own terms
    // da_i = sum_{i' >= i} dcum_i': a suffix scan over the lanes
    float s = dc[0];
#pragma unroll
    for (int q = 1; q < RL; ++q) s += dc[q];
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_down_sync(FULL, s, o);
      if (l + o < 32) s += t;
    }
    float after = __shfl_down_sync(FULL, s, 1);
    if (l == 31) after = 0.f;
    float da[RL];
    da[RL - 1] = after + dc[RL - 1];
#pragma unroll
    for (int q = RL - 2; q >= 0; --q) da[q] = da[q + 1] + dc[q];
    float dap = 0.f;
#pragma unroll
    for (int q = 0; q < RL; ++q) {
      const int i = RL * l + q, row = k.row0 + i;
      dap += da[q] * dtv[i];
      if (row < S)
        a.ddt[((long long)k.bi * S + row) * a.H + k.h] =
            cX[i] + dwv[i] * el[i] + da[q] * A;
    }
    for (int o = 16; o > 0; o >>= 1) dap += __shfl_xor_sync(FULL, dap, o);
    if (l == 0) a.dA_part[k.bh * a.nc + c] = dap;
  }
}

// Raise the kernel's dynamic shared-memory limit (above 48 KB a launch
// is refused without it), then launch.
template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int smem_floats, const SsdArgs& a,
           cudaStream_t stream, int threads = NT) {
  const int smem = smem_floats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The scan phase's arguments (csrc/ssd_scan.cuh) over `chunks`: cstates
// (forward) or the scratch (backward).
ScanArgs scan_args(const SsdArgs& a, float* chunks) {
  return ScanArgs{a.dt,      a.A,       chunks,    a.state, a.gstate,
                  a.dts.b,   a.dts.s,   a.dts.h,   a.S,     a.H,
                  a.nc};
}

// The three phases of one direction, in order; the first error stops.
template <typename T, int P, int N, int Q>
int launch_pn(bool bwd, const SsdArgs& a, cudaStream_t stream) {
  static_assert(bwd_chunk_floats<P, N, Q>() * 4 <= 232448,
                "the backward chunk phase exceeds shared memory");
  const dim3 chunks(a.nc, a.H, a.b);
  int err;
  if (!bwd) {
    if ((err = launch(ssd_fwd_states_kernel<T, P, N, Q>, chunks,
                      fwd_states_floats<P, N, Q>(), a, stream)))
      return err;
    if ((err = launch_scan<P, N, Q>(false, scan_args(a, a.cstates), a.b,
                                    stream)))
      return err;
    return launch(ssd_fwd_out_kernel<T, P, N, Q>, chunks,
                  fwd_out_floats<P, N, Q>(), a, stream);
  }
  if ((err = launch(ssd_bwd_states_kernel<T, P, N, Q>, chunks,
                    bwd_states_floats<P, N, Q>(), a, stream)))
    return err;
  if ((err = launch_scan<P, N, Q>(true, scan_args(a, a.scratch), a.b,
                                  stream)))
    return err;
  return launch(ssd_bwd_chunk_kernel<T, P, N, Q>, chunks,
                bwd_chunk_floats<P, N, Q>(), a, stream, Geom<Q>::CNT);
}

template <typename T, int Q>
int launch_q(bool bwd, int P, int N, const SsdArgs& a, cudaStream_t stream) {
  if (P == 64 && N == 128) return launch_pn<T, 64, 128, Q>(bwd, a, stream);
  if (P == 64 && N == 16) return launch_pn<T, 64, 16, Q>(bwd, a, stream);
  if (P == 16 && N == 16) return launch_pn<T, 16, 16, Q>(bwd, a, stream);
  return (int)cudaErrorInvalidValue;
}

// (P, N) instances: mamba2-780m (64, 128), hymba-1.5b (64, 16), the
// reduced test configs (16, 16); each at chunks 64 and 32.
template <typename T>
int launch_t(bool bwd, int P, int N, int chunk, const SsdArgs& a,
             cudaStream_t stream) {
  if (chunk == 64) return launch_q<T, 64>(bwd, P, N, a, stream);
  if (chunk == 32) return launch_q<T, 32>(bwd, P, N, a, stream);
  return (int)cudaErrorInvalidValue;
}

// The rows of one fp32 operand are 16-byte aligned: its base and its
// (batch, seq, head) strides.
bool rows16(const void* p, const Strides& st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % 4 == 0 &&
         st.s % 4 == 0 && st.h % 4 == 0;
}

// ``chunk`` is Q, which sizes cstates, the scratch and the dA partials
// (nc = ceil(S / chunk) each); a chunk that is not built is refused.
int dispatch(bool bwd, int P, int N, int chunk, int dtype, SsdArgs& a,
             void* stream) {
  if (a.b <= 0 || a.S <= 0 || a.H <= 0) return (int)cudaErrorInvalidValue;
  a.vec = rows16(a.x, a.xs) && rows16(a.B, a.Bs) && rows16(a.C, a.Cs) &&
          (a.gy == nullptr || rows16(a.gy, a.gs));
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32) return launch_t<float>(bwd, P, N, chunk, a, s);
  if (dtype == kBF16) return launch_t<__nv_bfloat16>(bwd, P, N, chunk, a, s);
  return (int)cudaErrorInvalidValue;
}

SsdArgs make_args(const void* x, const void* dt, const void* A, const void* B,
                  const void* C, int b, int S, int H, int chunk, int x_sb,
                  int x_ss, int x_sh, int dt_sb, int dt_ss, int dt_sh,
                  int B_sb, int B_ss, int B_sh, int C_sb, int C_ss,
                  int C_sh) {
  SsdArgs a = {};
  a.x = x;
  a.dt = (const float*)dt;
  a.A = (const float*)A;
  a.B = B;
  a.C = C;
  a.b = b;
  a.S = S;
  a.H = H;
  a.nc = chunk > 0 ? (S + chunk - 1) / chunk : 0;
  a.xs = {x_sb, x_ss, x_sh};
  a.dts = {dt_sb, dt_ss, dt_sh};
  a.Bs = {B_sb, B_ss, B_sh};
  a.Cs = {C_sb, C_ss, C_sh};
  return a;
}

}  // namespace

extern "C" {

int ssd_fwd(const void* x, const void* dt, const void* A, const void* B,
            const void* C, void* y, void* state, void* cstates, int b, int S,
            int H, int P, int N, int chunk, int x_sb, int x_ss, int x_sh,
            int dt_sb, int dt_ss, int dt_sh, int B_sb, int B_ss, int B_sh,
            int C_sb, int C_ss, int C_sh, int dtype, void* stream) {
  SsdArgs a = make_args(x, dt, A, B, C, b, S, H, chunk, x_sb, x_ss, x_sh,
                        dt_sb, dt_ss, dt_sh, B_sb, B_ss, B_sh, C_sb, C_ss,
                        C_sh);
  a.y = y;
  a.state = (float*)state;
  a.cstates = (float*)cstates;
  return dispatch(false, P, N, chunk, dtype, a, stream);
}

// scratch: fp32 [b, H, nc, P, N], the wrapper's (its contents on return
// are dS1 per chunk).
int ssd_bwd(const void* x, const void* dt, const void* A, const void* B,
            const void* C, const void* cstates, const void* gy,
            const void* gstate, void* dx, void* ddt, void* dB, void* dC,
            void* dA_part, void* scratch, int b, int S, int H, int P, int N,
            int chunk, int x_sb, int x_ss, int x_sh, int dt_sb, int dt_ss,
            int dt_sh, int B_sb, int B_ss, int B_sh, int C_sb, int C_ss,
            int C_sh, int g_sb, int g_ss, int g_sh, int dtype, void* stream) {
  SsdArgs a = make_args(x, dt, A, B, C, b, S, H, chunk, x_sb, x_ss, x_sh,
                        dt_sb, dt_ss, dt_sh, B_sb, B_ss, B_sh, C_sb, C_ss,
                        C_sh);
  a.cstates_in = (const float*)cstates;
  a.gy = gy;
  a.gs = {g_sb, g_ss, g_sh};
  a.gstate = (const float*)gstate;
  a.dx = dx;
  a.ddt = (float*)ddt;
  a.dB = dB;
  a.dC = dC;
  a.dA_part = (float*)dA_part;
  a.scratch = (float*)scratch;
  return dispatch(true, P, N, chunk, dtype, a, stream);
}

}  // extern "C"
