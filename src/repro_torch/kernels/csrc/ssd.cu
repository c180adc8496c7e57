// Mamba2 SSD chunked scan for Hopper (sm_90a): the forward and the
// reverse-chunk backward.
//
// Replace repro/kernels/ssd.py::_ssd_kernel and ::_ssd_bwd_kernel.  Per
// chunk of Q rows the forward computes, in fp32,
//     cum    = cumsum(dt * A)
//     y      = (tri(C.B^T * e^(cum_i - cum_j)) * dt_j).x + (C * e^cum).S^T
//     S     <- S * e^cum_Q + (x * e^(cum_Q - cum) * dt)^T.B
// and the backward walks the chunks in reverse, rebuilding each from the
// state that entered it (cstates, saved by the forward) and carrying the
// state cotangent dS, with the reference's nine products.
//
// Layouts are the JAX package's public ones: x, y, gy, dx [b, S, H, P];
// dt, ddt [b, S, H] fp32; A [H] fp32; B, C, dB, dC [b, S, H, N]; states
// [b, H, P, N] fp32; cstates [b, H, nc, P, N] fp32; dA partials
// [b, H, nc] fp32.  x, dt, B, C and gy are read in place through their
// (batch, seq, head) strides with the last dim dense, so B and C may be
// one group expanded over the heads with head stride 0 (no per-head
// copies).  Rows at or past S read as zero and are never written: no
// pad copies (the reference's _pad_seq is a TPU layout artefact).
// Outputs are written contiguous.
//
// Bound on the H100: operations.  At the mamba2-780m shape (b 2, S 2048,
// H 48, P 64, N 128, B and C one group) the forward moves 0.21 GB for
// 8.9 GFLOP and the backward 0.51 GB for 19.4 GFLOP (the intra-chunk
// products counted over the causal pairs): 0.13 and 0.29 ms at the fp32
// rate against 0.06 and 0.15 ms of bytes.
// Design (simple first version): one block per (head, batch) walks the
// chunks in order (the TPU grid's sequential chunk axis becomes a loop),
// keeping the [P, N] fp32 state (forward: in registers, copied to shared
// memory for the chunk's y) or dS (backward: in shared memory) on chip
// for the whole sequence: no HBM round trip between chunks.  Q =
// 64: the chunk's x, B, C (and gy, the entering state and three Q x Q
// matrices in the backward) fit in shared memory at P 64, N 128 (~133 KB
// forward, ~219 KB backward; at Q = 128 they would not).  Every tile is
// fp32 with an odd row pitch, so row and column reads are free of bank
// conflicts.  256 threads as a 16 x 16 grid; a thread owns the outputs
// (ty + 16 i, tx + 16 j) of each product and accumulates them in
// registers on CUDA cores.  mma.sync, wgmma and TMA are later work.
//
// Plain C interface (extern "C"), loaded with ctypes by kernels/build.py.
// Every launcher takes the stream it must launch on, allocates nothing,
// does not synchronise, and returns cudaGetLastError() (or the error of
// raising the kernel's shared-memory limit).  dtype codes: 0 = float32,
// 1 = bfloat16 (x, B, C, gy and their gradients; the rest is fp32).  No
// atomics, and every sum runs in a fixed order: the same inputs give
// bitwise-equal outputs.
#include "common.cuh"

namespace {

constexpr int Q = 64;           // chunk length
constexpr int LQ = Q + 1;       // row pitch of a Q x Q tile
constexpr int NT = 256;         // threads per block, a 16 x 16 grid
constexpr unsigned FULL = 0xffffffffu;

struct Strides {
  long long b, s, h;            // elements; the last dim has stride 1
};

// One argument block for both kernels (unused pointers are null).
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
  void* dx;
  float* ddt;
  void* dB;
  void* dC;
  float* dA_part;
  int b, S, H, nc;
  Strides xs, dts, Bs, Cs, gs;
};

// Rows [row0, row0 + Q) of one head into dst[r * ld + d] in fp32; rows at
// or past S read as 0.  Reads are coalesced along d.
template <typename T, int D>
__device__ void load_rows(float* dst, int ld, const T* src,
                          long long row_stride, int row0, int S) {
  for (int idx = threadIdx.x; idx < Q * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int row = row0 + r;
    dst[r * ld + d] = row < S ? to_f(src[row * row_stride + d]) : 0.f;
  }
}

__device__ void load_dt(float* dst, const float* src, long long row_stride,
                        int row0, int S) {
  if (threadIdx.x < Q) {
    const int row = row0 + threadIdx.x;
    dst[threadIdx.x] = row < S ? src[row * row_stride] : 0.f;
  }
}

// acc[i][j] += sum_k a(ty + 16 i, k) * b(k, tx + 16 j): the thread's
// patch of one product over shared-memory operands.
template <int TM, int TN, int K, typename FA, typename FB>
__device__ __forceinline__ void tile_product(float (&acc)[TM][TN], FA a, FB b) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = a(ty + 16 * i, k);
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = b(k, tx + 16 * j);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// Sum over the 16 threads that share a row (one half warp), in a fixed
// butterfly order.
__device__ __forceinline__ float row_sum16(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Per-chunk decay terms, by warp 0 (lane l owns rows 2l and 2l + 1):
// cum = cumsum(dt * A) as a warp scan, e^cum, e^(cum_Q - cum) and
// w_last = e^(cum_Q - cum) * dt; sc[0] = e^cum_Q.
__device__ void chunk_decay(const float* dtv, float A, float* cum, float* ecum,
                            float* el, float* wl, float* sc) {
  if (threadIdx.x >= 32) return;
  const int l = threadIdx.x;
  const float a0 = dtv[2 * l] * A, a1 = dtv[2 * l + 1] * A;
  float s = a0 + a1;
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(FULL, s, o);
    if (l >= o) s += t;
  }
  float excl = __shfl_up_sync(FULL, s, 1);
  if (l == 0) excl = 0.f;
  const float c0 = excl + a0, c1 = c0 + a1;
  const float last = __shfl_sync(FULL, c1, 31);
  cum[2 * l] = c0;
  cum[2 * l + 1] = c1;
  ecum[2 * l] = expf(c0);
  ecum[2 * l + 1] = expf(c1);
  el[2 * l] = expf(last - c0);
  el[2 * l + 1] = expf(last - c1);
  wl[2 * l] = el[2 * l] * dtv[2 * l];
  wl[2 * l + 1] = el[2 * l + 1] * dtv[2 * l + 1];
  if (l == 31) sc[0] = expf(last);
}

// Shared memory of one block, in floats (see the kernels' carve-up).
template <int P, int N> constexpr int fwd_smem_floats() {
  return Q * (P + 1) + 2 * Q * (N + 1) + P * (N + 1) + Q * LQ + 5 * Q + 4;
}
template <int P, int N> constexpr int bwd_smem_floats() {
  return 2 * Q * (P + 1) + 2 * Q * (N + 1) + 2 * P * (N + 1) + 3 * Q * LQ +
         10 * Q + NT + 8;
}

// ---------------------------------------------------------------------
// Forward.  Replaces repro/kernels/ssd.py::_ssd_kernel.
// Grid (head, batch); the block walks the chunks in order with the state,
// from zero, in the registers of the threads that own its (p, n).  Writes
// y in x's dtype, the final state and the state entering each chunk
// (cstates, the backward's residual).
// ---------------------------------------------------------------------
template <typename T, int P, int N>
__global__ void __launch_bounds__(NT) ssd_fwd_kernel(const SsdArgs a) {
  constexpr int LP = P + 1, LN = N + 1;
  constexpr int TP = P / 16, TN = N / 16;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [Q][LP]
  float* Bm = xs + Q * LP;                       // [Q][LN]
  float* Cm = Bm + Q * LN;                       // [Q][LN]
  float* st = Cm + Q * LN;                       // [P][LN]: state copy
  float* Wm = st + P * LN;                       // [Q][LQ]
  float* dtv = Wm + Q * LQ;                      // [Q]
  float* cum = dtv + Q;
  float* ecum = cum + Q;
  float* el = ecum + Q;
  float* wl = el + Q;
  float* sc = wl + Q;                            // [4]: e^cum_Q
  const int h = blockIdx.x, bi = blockIdx.y;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int S = a.S, H = a.H;
  const float A = a.A[h];
  const T* x = static_cast<const T*>(a.x) + bi * a.xs.b + h * a.xs.h;
  const T* B = static_cast<const T*>(a.B) + bi * a.Bs.b + h * a.Bs.h;
  const T* C = static_cast<const T*>(a.C) + bi * a.Cs.b + h * a.Cs.h;
  const float* dt = a.dt + bi * a.dts.b + h * a.dts.h;
  const long long bh = (long long)bi * H + h;

  float acc[TP][TN];
  zero(acc);                                     // the state, owned (p, n)
  for (int c = 0; c < a.nc; ++c) {
    const int row0 = c * Q;
    __syncthreads();              // the previous chunk is done with the tiles
#pragma unroll
    for (int i = 0; i < TP; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        st[(ty + 16 * i) * LN + tx + 16 * j] = acc[i][j];
    load_rows<T, P>(xs, LP, x, a.xs.s, row0, S);
    load_rows<T, N>(Bm, LN, B, a.Bs.s, row0, S);
    load_rows<T, N>(Cm, LN, C, a.Cs.s, row0, S);
    load_dt(dtv, dt, a.dts.s, row0, S);
    float* cs = a.cstates + (bh * a.nc + c) * P * N;
#pragma unroll
    for (int i = 0; i < TP; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        cs[(ty + 16 * i) * N + tx + 16 * j] = acc[i][j];
    __syncthreads();
    chunk_decay(dtv, A, cum, ecum, el, wl, sc);
    __syncthreads();
    {  // W = tri(C.B^T * e^(cum_i - cum_j)) * dt_j
      float cb[4][4];
      zero(cb);
      tile_product<4, 4, N>(cb, [&](int i, int n) { return Cm[i * LN + n]; },
                            [&](int n, int j) { return Bm[j * LN + n]; });
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int i = ty + 16 * ii, j = tx + 16 * jj;
          Wm[i * LQ + j] =
              i >= j ? cb[ii][jj] * expf(cum[i] - cum[j]) * dtv[j] : 0.f;
        }
    }
    __syncthreads();
    {  // y = W.x + e^cum * (C.S^T)
      float yi[4][TP], ys[4][TP];
      zero(yi);
      zero(ys);
      tile_product<4, TP, Q>(yi, [&](int i, int j) { return Wm[i * LQ + j]; },
                             [&](int j, int p) { return xs[j * LP + p]; });
      tile_product<4, TP, N>(ys, [&](int i, int n) { return Cm[i * LN + n]; },
                             [&](int n, int p) { return st[p * LN + n]; });
      T* y = static_cast<T*>(a.y);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = ty + 16 * ii, row = row0 + i;
        if (row >= S) continue;
        T* yrow = y + (((long long)bi * S + row) * H + h) * P;
#pragma unroll
        for (int pp = 0; pp < TP; ++pp)
          yrow[tx + 16 * pp] = from_f<T>(yi[ii][pp] + ecum[i] * ys[ii][pp]);
      }
    }
    // S <- S * e^cum_Q + (x * w_last)^T.B, on the thread's own (p, n)
    const float eQ = sc[0];
#pragma unroll
    for (int i = 0; i < TP; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] *= eQ;
    tile_product<TP, TN, Q>(
        acc, [&](int p, int j) { return xs[j * LP + p] * wl[j]; },
        [&](int j, int n) { return Bm[j * LN + n]; });
  }
  float* state = a.state + bh * P * N;
#pragma unroll
  for (int i = 0; i < TP; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      state[(ty + 16 * i) * N + tx + 16 * j] = acc[i][j];
}

// ---------------------------------------------------------------------
// Backward.  Replaces repro/kernels/ssd.py::_ssd_bwd_kernel.
// Grid (head, batch); the block walks the chunks in reverse, carrying dS
// (from gstate) in shared memory.  Per chunk: dx, ddt, dB and dC for its
// rows, and one dA partial (the wrapper sums them in a fixed order).
// ---------------------------------------------------------------------
template <typename T, int P, int N>
__global__ void __launch_bounds__(NT) ssd_bwd_kernel(const SsdArgs a) {
  constexpr int LP = P + 1, LN = N + 1;
  constexpr int TP = P / 16, TN = N / 16;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [Q][LP]
  float* Gs = xs + Q * LP;                       // [Q][LP]: gy
  float* Bm = Gs + Q * LP;                       // [Q][LN]
  float* Cm = Bm + Q * LN;                       // [Q][LN]
  float* S0 = Cm + Q * LN;                       // [P][LN]: entering state
  float* dS = S0 + P * LN;                       // [P][LN]: dS carry
  float* Wm = dS + P * LN;                       // [Q][LQ]: W
  float* Dm = Wm + Q * LQ;                       // [Q][LQ]: d(C.B^T)
  float* Xm = Dm + Q * LQ;                       // [Q][LQ]: tri(dW e^..) C.B^T
  float* dtv = Xm + Q * LQ;                      // [Q] vectors
  float* cum = dtv + Q;
  float* ecum = cum + Q;
  float* el = ecum + Q;
  float* wl = el + Q;
  float* rsg = wl + Q;                           // rowsum(GS0 * C e^cum)
  float* dwv = rsg + Q;                          // d(w_last)
  float* rX = dwv + Q;                           // sum_j Xm[i][j] dt_j
  float* cX = rX + Q;                            // sum_i Xm[i][j]
  float* part = cX + Q;                          // [NT]: sum(dS * S0) partials
  float* sc = part + NT;                         // [8]: e^cum_Q, sum(dS*S0)
  const int h = blockIdx.x, bi = blockIdx.y;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int S = a.S, H = a.H;
  const float A = a.A[h];
  const T* x = static_cast<const T*>(a.x) + bi * a.xs.b + h * a.xs.h;
  const T* B = static_cast<const T*>(a.B) + bi * a.Bs.b + h * a.Bs.h;
  const T* C = static_cast<const T*>(a.C) + bi * a.Cs.b + h * a.Cs.h;
  const T* gy = static_cast<const T*>(a.gy) + bi * a.gs.b + h * a.gs.h;
  const float* dt = a.dt + bi * a.dts.b + h * a.dts.h;
  const long long bh = (long long)bi * H + h;
  for (int idx = threadIdx.x; idx < P * N; idx += NT)
    dS[(idx / N) * LN + idx % N] = a.gstate[bh * P * N + idx];

  for (int c = a.nc - 1; c >= 0; --c) {
    const int row0 = c * Q;
    __syncthreads();              // the previous chunk is done with the tiles
    load_rows<T, P>(xs, LP, x, a.xs.s, row0, S);
    load_rows<T, P>(Gs, LP, gy, a.gs.s, row0, S);
    load_rows<T, N>(Bm, LN, B, a.Bs.s, row0, S);
    load_rows<T, N>(Cm, LN, C, a.Cs.s, row0, S);
    load_dt(dtv, dt, a.dts.s, row0, S);
    const float* s0 = a.cstates_in + (bh * a.nc + c) * P * N;
    for (int idx = threadIdx.x; idx < P * N; idx += NT)
      S0[(idx / N) * LN + idx % N] = s0[idx];
    __syncthreads();
    chunk_decay(dtv, A, cum, ecum, el, wl, sc);
    __syncthreads();
    {  // C.B^T and dW = gy.x^T; from them W, d(C.B^T) and Xm
      float cb[4][4], dW[4][4];
      zero(cb);
      zero(dW);
      tile_product<4, 4, N>(cb, [&](int i, int n) { return Cm[i * LN + n]; },
                            [&](int n, int j) { return Bm[j * LN + n]; });
      tile_product<4, 4, P>(dW, [&](int i, int p) { return Gs[i * LP + p]; },
                            [&](int p, int j) { return xs[j * LP + p]; });
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int i = ty + 16 * ii, j = tx + 16 * jj;
          float w = 0.f, d = 0.f, xm = 0.f;
          if (i >= j) {           // the decay overflows above the diagonal
            const float decay = expf(cum[i] - cum[j]);
            const float dwd = dW[ii][jj] * decay;
            w = cb[ii][jj] * decay * dtv[j];
            d = dwd * dtv[j];
            xm = dwd * cb[ii][jj];
          }
          Wm[i * LQ + j] = w;
          Dm[i * LQ + j] = d;
          Xm[i * LQ + j] = xm;
        }
    }
    __syncthreads();
    {  // dx = W^T.gy + w_last * (B.dS^T)
      float g1[4][TP], g2[4][TP];
      zero(g1);
      zero(g2);
      tile_product<4, TP, Q>(g1, [&](int j, int i) { return Wm[i * LQ + j]; },
                             [&](int i, int p) { return Gs[i * LP + p]; });
      tile_product<4, TP, N>(g2, [&](int j, int n) { return Bm[j * LN + n]; },
                             [&](int n, int p) { return dS[p * LN + n]; });
      T* dx = static_cast<T*>(a.dx);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = ty + 16 * jj, row = row0 + j;
        if (row >= S) continue;
        T* r = dx + (((long long)bi * S + row) * H + h) * P;
#pragma unroll
        for (int pp = 0; pp < TP; ++pp)
          r[tx + 16 * pp] = from_f<T>(g1[jj][pp] + g2[jj][pp] * wl[j]);
      }
    }
    {  // dC = d(C.B^T).B + e^cum * (gy.S0); rowsum(gy.S0 * C e^cum)
      float g1[4][TN], g2[4][TN];
      zero(g1);
      zero(g2);
      tile_product<4, TN, Q>(g1, [&](int i, int j) { return Dm[i * LQ + j]; },
                             [&](int j, int n) { return Bm[j * LN + n]; });
      tile_product<4, TN, P>(g2, [&](int i, int p) { return Gs[i * LP + p]; },
                             [&](int p, int n) { return S0[p * LN + n]; });
      T* dC = static_cast<T*>(a.dC);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = ty + 16 * ii, row = row0 + i;
        float r = 0.f;
#pragma unroll
        for (int nn = 0; nn < TN; ++nn)
          r += g2[ii][nn] * Cm[i * LN + tx + 16 * nn];
        r = row_sum16(r);
        if (tx == 0) rsg[i] = r * ecum[i];
        if (row >= S) continue;
        T* out = dC + (((long long)bi * S + row) * H + h) * N;
#pragma unroll
        for (int nn = 0; nn < TN; ++nn)
          out[tx + 16 * nn] = from_f<T>(g1[ii][nn] + g2[ii][nn] * ecum[i]);
      }
    }
    {  // dB = d(C.B^T)^T.C + w_last * (x.dS); d(w_last) = rowsum(x.dS * B)
      float g1[4][TN], g2[4][TN];
      zero(g1);
      zero(g2);
      tile_product<4, TN, Q>(g1, [&](int j, int i) { return Dm[i * LQ + j]; },
                             [&](int i, int n) { return Cm[i * LN + n]; });
      tile_product<4, TN, P>(g2, [&](int j, int p) { return xs[j * LP + p]; },
                             [&](int p, int n) { return dS[p * LN + n]; });
      T* dB = static_cast<T*>(a.dB);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = ty + 16 * jj, row = row0 + j;
        float r = 0.f;
#pragma unroll
        for (int nn = 0; nn < TN; ++nn)
          r += g2[jj][nn] * Bm[j * LN + tx + 16 * nn];
        r = row_sum16(r);
        if (tx == 0) dwv[j] = r;
        if (row >= S) continue;
        T* out = dB + (((long long)bi * S + row) * H + h) * N;
#pragma unroll
        for (int nn = 0; nn < TN; ++nn)
          out[tx + 16 * nn] = from_f<T>(g1[jj][nn] + g2[jj][nn] * wl[j]);
      }
    }
    // dS for the preceding chunk: e^cum_Q * dS + gy^T.(C e^cum), held in
    // registers until every read of this chunk's dS is done
    float nd[TP][TN];
    zero(nd);
    tile_product<TP, TN, Q>(
        nd, [&](int p, int i) { return Gs[i * LP + p]; },
        [&](int i, int n) { return Cm[i * LN + n] * ecum[i]; });
    {
      const float eQ = sc[0];
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < TP; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int o = (ty + 16 * i) * LN + tx + 16 * j;
          s += dS[o] * S0[o];
          nd[i][j] += eQ * dS[o];
        }
      part[threadIdx.x] = s;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TP; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        dS[(ty + 16 * i) * LN + tx + 16 * j] = nd[i][j];
    if (threadIdx.x < Q) {        // row sums of Xm, weighted by dt_j
      const int i = threadIdx.x;
      float s = 0.f;
      for (int j = 0; j < Q; ++j) s += Xm[i * LQ + j] * dtv[j];
      rX[i] = s;
    } else if (threadIdx.x < 2 * Q) {   // column sums of Xm
      const int j = threadIdx.x - Q;
      float s = 0.f;
      for (int i = 0; i < Q; ++i) s += Xm[i * LQ + j];
      cX[j] = s;
    } else if (threadIdx.x < 2 * Q + 32) {  // sum(dS * S0) over the block
      const int l = threadIdx.x - 2 * Q;
      float s = 0.f;
      for (int k = 0; k < NT / 32; ++k) s += part[l * (NT / 32) + k];
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
      if (l == 0) sc[1] = s;
    }
    __syncthreads();
    if (threadIdx.x < 32) {       // the cum cotangent, ddt and dA (warp 0)
      const int l = threadIdx.x;
      float dc[2], v[2], vs = 0.f;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = 2 * l + k;
        v[k] = dwv[i] * wl[i];
        dc[k] = rX[i] - dtv[i] * cX[i] + rsg[i] - v[k];
        vs += v[k];
      }
      for (int o = 16; o > 0; o >>= 1) vs += __shfl_xor_sync(FULL, vs, o);
      if (l == 31) dc[1] += sc[1] * sc[0] + vs;   // cum_Q's own terms
      // da_i = sum_{i' >= i} dcum_i': a suffix scan over the lanes
      float s = dc[0] + dc[1];
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_down_sync(FULL, s, o);
        if (l + o < 32) s += t;
      }
      float after = __shfl_down_sync(FULL, s, 1);
      if (l == 31) after = 0.f;
      float da[2];
      da[1] = after + dc[1];
      da[0] = da[1] + dc[0];
      float dap = 0.f;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = 2 * l + k, row = row0 + i;
        dap += da[k] * dtv[i];
        if (row < S)
          a.ddt[((long long)bi * S + row) * H + h] =
              cX[i] + dwv[i] * el[i] + da[k] * A;
      }
      for (int o = 16; o > 0; o >>= 1) dap += __shfl_xor_sync(FULL, dap, o);
      if (l == 0) a.dA_part[bh * a.nc + c] = dap;
    }
  }
}

// Raise the kernel's dynamic shared-memory limit (above 48 KB a launch
// is refused without it), then launch.
template <typename Kernel>
int launch(Kernel kernel, int smem_floats, const SsdArgs& a,
           cudaStream_t stream) {
  const int smem = smem_floats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(a.H, a.b), NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int P, int N>
int launch_pn(bool bwd, const SsdArgs& a, cudaStream_t stream) {
  if (bwd)
    return launch(ssd_bwd_kernel<T, P, N>, bwd_smem_floats<P, N>(), a, stream);
  return launch(ssd_fwd_kernel<T, P, N>, fwd_smem_floats<P, N>(), a, stream);
}

// (P, N) instances: mamba2-780m (64, 128), hymba-1.5b (64, 16), the
// reduced test configs (16, 16).
template <typename T>
int launch_t(bool bwd, int P, int N, const SsdArgs& a, cudaStream_t stream) {
  if (P == 64 && N == 128) return launch_pn<T, 64, 128>(bwd, a, stream);
  if (P == 64 && N == 16) return launch_pn<T, 64, 16>(bwd, a, stream);
  if (P == 16 && N == 16) return launch_pn<T, 16, 16>(bwd, a, stream);
  return (int)cudaErrorInvalidValue;
}

// ``chunk`` is the caller's idea of Q, which sizes cstates and the dA
// partials: a launch that disagrees is refused.
int dispatch(bool bwd, int P, int N, int chunk, int dtype, const SsdArgs& a,
             void* stream) {
  if (chunk != Q || a.b <= 0 || a.S <= 0 || a.H <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32) return launch_t<float>(bwd, P, N, a, s);
  if (dtype == kBF16) return launch_t<__nv_bfloat16>(bwd, P, N, a, s);
  return (int)cudaErrorInvalidValue;
}

SsdArgs make_args(const void* x, const void* dt, const void* A, const void* B,
                  const void* C, int b, int S, int H, int x_sb, int x_ss,
                  int x_sh, int dt_sb, int dt_ss, int dt_sh, int B_sb,
                  int B_ss, int B_sh, int C_sb, int C_ss, int C_sh) {
  SsdArgs a = {};
  a.x = x;
  a.dt = (const float*)dt;
  a.A = (const float*)A;
  a.B = B;
  a.C = C;
  a.b = b;
  a.S = S;
  a.H = H;
  a.nc = (S + Q - 1) / Q;
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
  SsdArgs a = make_args(x, dt, A, B, C, b, S, H, x_sb, x_ss, x_sh, dt_sb,
                        dt_ss, dt_sh, B_sb, B_ss, B_sh, C_sb, C_ss, C_sh);
  a.y = y;
  a.state = (float*)state;
  a.cstates = (float*)cstates;
  return dispatch(false, P, N, chunk, dtype, a, stream);
}

int ssd_bwd(const void* x, const void* dt, const void* A, const void* B,
            const void* C, const void* cstates, const void* gy,
            const void* gstate, void* dx, void* ddt, void* dB, void* dC,
            void* dA_part, int b, int S, int H, int P, int N, int chunk,
            int x_sb, int x_ss, int x_sh, int dt_sb, int dt_ss, int dt_sh,
            int B_sb, int B_ss, int B_sh, int C_sb, int C_ss, int C_sh,
            int g_sb, int g_ss, int g_sh, int dtype, void* stream) {
  SsdArgs a = make_args(x, dt, A, B, C, b, S, H, x_sb, x_ss, x_sh, dt_sb,
                        dt_ss, dt_sh, B_sb, B_ss, B_sh, C_sb, C_ss, C_sh);
  a.cstates_in = (const float*)cstates;
  a.gy = gy;
  a.gs = {g_sb, g_ss, g_sh};
  a.gstate = (const float*)gstate;
  a.dx = dx;
  a.ddt = (float*)ddt;
  a.dB = dB;
  a.dC = dC;
  a.dA_part = (float*)dA_part;
  return dispatch(true, P, N, chunk, dtype, a, stream);
}

}  // extern "C"
