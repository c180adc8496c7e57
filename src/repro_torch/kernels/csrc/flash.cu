// Causal GQA flash attention for Hopper (sm_90a): the forward, the dq
// backward, and one fused dk/dv backward.
//
// Layouts are the JAX package's public ones: q, o, g (= dO) and dq are
// [B, S, H, D]; k, v, dk and dv are [B, S, KV, D]; lse and delta are
// [B, H, S] fp32.  q, k, v and g are read in place through their
// (batch, seq, head) strides, with the head dim dense: no transpose or
// pad copies.  Query head h reads kv head h / G, G = H / KV.  Outputs are
// written contiguous.  Scores are scaled by 1/sqrt(D) and every product
// is accumulated in fp32; the forward and dq convert bf16 inputs to fp32
// when a tile is loaded, dk/dv feeds them to the tensor cores as bf16.
//
// Bound on the H100: operations.  At the flash path's shape (B 2, S
// 2048, H 16, D 64) a 64x64 score tile costs 2*64*64*64 flops per
// product for 2*64*64*4 bytes of tile, and the causal mask halves the
// work, so the tiles come from L2 and the kernels are limited by the
// arithmetic rate.  The forward and dq (simple first version): 64-row q
// and kv tiles in shared memory, 256 threads as a 16x16 grid, each
// thread holding a 4x4 patch of the score tile and 4 rows x D/16
// columns of its fp32 accumulators in registers; operands of products
// that reduce over D are stored transposed ([D][64], padded), so a
// thread reads its 4 rows and 4 columns as two float4 loads per step;
// CUDA cores only.  The dk/dv kernel runs its four products on the
// tensor cores (tensor_core.cuh: 3xTF32 for fp32, bf16 m16n8k16), fed
// by a cp.async ring; see its own note below.  mma.sync and not wgmma:
// wgmma's .tf32 operands must be K-major in shared memory, and the
// products here read Q and dO both ways; a wgmma/TMA design would
// transpose them in shared memory first.
//
// Plain C interface (extern "C"), loaded with ctypes by kernels/build.py.
// Every launcher takes the stream it must launch on, allocates nothing,
// does not synchronise, and returns cudaGetLastError() (or the error of
// raising the kernel's shared-memory limit).  dtype codes: 0 = float32,
// 1 = bfloat16.  No kernel uses atomics and every loop runs in a fixed
// order: the same inputs give bitwise-equal outputs.
#include <cstdint>

#include "tensor_core.cuh"

namespace {

constexpr int BQ = 64;          // rows of a q tile
constexpr int BK = 64;          // rows of a kv tile (== BQ: the diagonal
                                // q block is the last kv block it reads)
constexpr int TP = BQ + 4;      // row of a transposed tile, float4-aligned
constexpr int NT = 256;         // threads per block, a 16 x 16 grid
constexpr float NEG_INF = -1e30f;  // the reference's mask value, not -inf

struct Strides {
  long long b, s, h;            // elements; the head dim has stride 1
};

// One argument block for all three kernels (unused pointers are null).
struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  const float* lse_in;          // backward: the forward's lse
  const float* delta;           // backward: rowsum(dO * O)
  void* o;
  float* lse;
  void* dq;
  void* dk;
  void* dv;
  int B, S, H, KV, window;
  float scale;
  Strides qs, ks, vs, gs;
  bool vec;                     // dk/dv: rows 16-byte aligned (cp.async 16)
};

// (q position, k position) takes part: causal, inside the sequence, and
// inside the sliding window when window > 0.
__device__ __forceinline__ bool visible(int qpos, int kpos, int S, int window) {
  return kpos <= qpos && qpos < S && (window <= 0 || kpos > qpos - window);
}

// Max / sum over the 16 threads that share a score row (one half warp),
// in a fixed butterfly order.
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [row0, row0 + 64) of one head, transposed into dst[d * TP + r] in
// fp32; rows at or past S read as 0.  Reads are coalesced along d.
template <typename T, int D>
__device__ void load_t(float* dst, const T* src, long long row_stride, int row0,
                       int S) {
  for (int idx = threadIdx.x; idx < BQ * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int row = row0 + r;
    dst[d * TP + r] = row < S ? to_f(src[row * row_stride + d]) : 0.f;
  }
}

// The same rows kept row-major: dst[r * D + d].
template <typename T, int D>
__device__ void load_rows(float* dst, const T* src, long long row_stride,
                          int row0, int S) {
  for (int idx = threadIdx.x; idx < BK * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int row = row0 + r;
    dst[r * D + d] = row < S ? to_f(src[row * row_stride + d]) : 0.f;
  }
}

// acc[i][j] = sum_d At[d][ty*4+i] * Bt[d][tx*4+j] over two transposed
// tiles: the thread's 4x4 patch of A.B^T.
template <int D>
__device__ __forceinline__ void dot_t(const float* At, const float* Bt,
                                      float acc[4][4], int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float4 a4 = *reinterpret_cast<const float4*>(At + d * TP + ty * 4);
    const float4 b4 = *reinterpret_cast<const float4*>(Bt + d * TP + tx * 4);
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
    const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
  }
}

// Store the thread's 4x4 patch transposed: dst[(tx*4+j) * TP + ty*4+i].
__device__ __forceinline__ void store_patch_t(float* dst, const float x[4][4],
                                              int ty, int tx) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(dst + (tx * 4 + j) * TP + ty * 4) =
        make_float4(x[0][j], x[1][j], x[2][j], x[3][j]);
}

template <int D> constexpr int fwd_smem_bytes() {
  return (2 * D * TP + BK * D + BK * TP) * (int)sizeof(float);
}
template <int D> constexpr int dq_smem_bytes() {
  return (4 * D * TP + BK * TP) * (int)sizeof(float);
}

// ---------------------------------------------------------------------
// Forward.  Replaces repro/kernels/flash_attention.py::_flash_kernel.
// Grid (q block, head, batch).  The block loops over the kv blocks
// [lo, hi) of the reference's _kv_bounds with an online softmax (m, l,
// acc) in fp32, writes O in the input dtype and lse = m + log(l) for the
// rows below S.
// ---------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(const FlashArgs a) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);   // [D][TP]
  float* Kt = Qt + D * TP;                       // [D][TP]
  float* Vs = Kt + D * TP;                       // [BK][D]
  float* Pt = Vs + BK * D;                       // [BK][TP]: p transposed
  constexpr int NC = D / 16;                     // output columns a thread owns
  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int S = a.S, q0 = iq * BQ;
  const int nk = (S + BK - 1) / BK;
  const int lo = a.window > 0 ? max((q0 - a.window + 1) / BK, 0) : 0;
  const int hi = min(iq + 1, nk);
  const T* q = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* k = static_cast<const T*>(a.k) + b * a.ks.b + kvh * a.ks.h;
  const T* v = static_cast<const T*>(a.v) + b * a.vs.b + kvh * a.vs.h;
  load_t<T, D>(Qt, q, a.qs.s, q0, S);

  float acc[4][NC], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  for (int ik = lo; ik < hi; ++ik) {
    const int k0 = ik * BK;
    __syncthreads();              // the previous block is done with Kt, Vs, Pt
    load_t<T, D>(Kt, k, a.ks.s, k0, S);
    load_rows<T, D>(Vs, v, a.vs.s, k0, S);
    __syncthreads();
    float s[4][4];
    dot_t<D>(Qt, Kt, s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = visible(qpos, k0 + tx * 4 + j, S, a.window);
        s[i][j] = ok ? s[i][j] * a.scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = visible(qpos, k0 + tx * 4 + j, S, a.window);
        s[i][j] = ok ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    store_patch_t(Pt, s, ty, tx);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p4 = *reinterpret_cast<const float4*>(Pt + kk * TP + ty * 4);
      const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = Vs[kk * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += p[i] * vv;
      }
    }
  }
  T* o = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= S) continue;
    const float li = fmaxf(l[i], 1e-20f);
    T* orow = o + (((long long)b * S + qpos) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[tx + 16 * c] = from_f<T>(acc[i][c] / li);
    if (tx == 0) a.lse[((long long)b * a.H + h) * S + qpos] = m[i] + logf(li);
  }
}

// ---------------------------------------------------------------------
// dq.  Replaces repro/kernels/flash_attention.py::_flash_bwd_dq_kernel.
// Grid (q block, head, batch), looping over the same kv blocks as the
// forward: p = exp(s - lse) rebuilt from the saved lse, dp = dO.V^T,
// ds = p * (dp - delta) * scale, dq += ds.K.
// ---------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(const FlashArgs a) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);   // [D][TP]
  float* Gt = Qt + D * TP;                       // [D][TP]
  float* Kt = Gt + D * TP;                       // [D][TP]
  float* Vt = Kt + D * TP;                       // [D][TP]
  float* Dst = Vt + D * TP;                      // [BK][TP]: ds transposed
  constexpr int NC = D / 16;
  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int S = a.S, q0 = iq * BQ;
  const int nk = (S + BK - 1) / BK;
  const int lo = a.window > 0 ? max((q0 - a.window + 1) / BK, 0) : 0;
  const int hi = min(iq + 1, nk);
  const T* q = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* g = static_cast<const T*>(a.g) + b * a.gs.b + h * a.gs.h;
  const T* k = static_cast<const T*>(a.k) + b * a.ks.b + kvh * a.ks.h;
  const T* v = static_cast<const T*>(a.v) + b * a.vs.b + kvh * a.vs.h;
  load_t<T, D>(Qt, q, a.qs.s, q0, S);
  load_t<T, D>(Gt, g, a.gs.s, q0, S);
  const long long row_base = ((long long)b * a.H + h) * S;
  float lse[4], delta[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    lse[i] = qpos < S ? a.lse_in[row_base + qpos] : 0.f;
    delta[i] = qpos < S ? a.delta[row_base + qpos] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  for (int ik = lo; ik < hi; ++ik) {
    const int k0 = ik * BK;
    __syncthreads();
    load_t<T, D>(Kt, k, a.ks.s, k0, S);
    load_t<T, D>(Vt, v, a.vs.s, k0, S);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_t<D>(Qt, Kt, s, ty, tx);
    dot_t<D>(Gt, Vt, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = visible(qpos, k0 + tx * 4 + j, S, a.window);
        const float p = ok ? expf(s[i][j] * a.scale - lse[i]) : 0.f;
        s[i][j] = p * (dp[i][j] - delta[i]) * a.scale;
      }
    }
    store_patch_t(Dst, s, ty, tx);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 d4 = *reinterpret_cast<const float4*>(Dst + kk * TP + ty * 4);
      const float ds[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv = Kt[(tx + 16 * c) * TP + kk];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += ds[i] * kv;
      }
    }
  }
  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= S) continue;
    T* row = dq + (((long long)b * S + qpos) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) row[tx + 16 * c] = from_f<T>(acc[i][c]);
  }
}

// ---------------------------------------------------------------------
// dk and dv in one kernel.  Replaces both
// repro/kernels/flash_attention.py::_flash_bwd_dk_kernel and
// ::_flash_bwd_dv_kernel, which share p and ds.
// Grid (KV head, batch, kv block).  The block loops, in a fixed order,
// over the G query heads of its kv head and, for each, over the q blocks
// of the reference's _q_bounds; it accumulates dk = sum ds^T.q and
// dv = sum p^T.dO in fp32 registers and writes both once, at kv-head
// resolution: no [B, H, S, D] per-query-head buffers, no reshape-sum, no
// atomics (one writer per output element).
// Design: tensor cores (tensor_core.cuh), a warp per 16 kv rows of the
// 64-row tile.  Per q block a warp computes its rows of S^T = K.Q^T and
// dP^T = V.dO^T
// over D, forms P^T = exp(S^T.scale - lse) and dS^T = P^T (dP^T -
// delta).scale on the accumulator fragments, and feeds them straight
// back as the A operand of dV += P^T.dO and dK += dS^T.Q: a C fragment
// holds q columns (2t, 2t+1) where an A fragment wants (t, t + 4), so
// the q index inside each k-step of 8 is permuted (slot t <-> 2t, slot
// t + 4 <-> 2t + 1) on both operands, which leaves the sum unchanged
// and needs neither a shuffle nor a trip through shared memory (bf16:
// the m16n8k16 A layout matches two C fragments as they are).  fp32
// takes the 3xTF32 split; each q block's dk and dv contributions are
// summed by the tensor cores into a 4-register block sum per 8 columns
// and promoted into the fp32 dk and dv registers once per q block.
// K and V stay in shared memory (their fragments would not fit in
// registers beside dk and dv); the next q block's Q and dO tiles, lse
// and delta are fetched by cp.async into the second buffer of a 2-stage
// ring while the current one computes.  A warp owns 16 kv rows and at
// most 64 columns of dk and dv: at D = 128 two warps share each 16 rows
// (8 warps), each repeating the rows' S^T and dP^T products, since 128
// columns of dk and dv beside them would spill registers.  A warp skips
// a q block none of whose pairs with its rows is visible and tests
// visible() per element only where some are not.  Under the causal mask
// the first kv blocks have the most q blocks, so the kv block is the
// grid's slowest dimension: those blocks are dispatched first, and the
// short ones fill the last wave (in launch order the long ones ran last,
// and the run took ~35 % longer on the H100).
// ---------------------------------------------------------------------
template <typename T, int D>
struct DkdvGeom {
  static constexpr int cols = D > 64 ? 64 : D;     // dk, dv columns a warp owns
  static constexpr int threads = 4 * 32 * (D / cols);
  // fp32 rows of D + 4 and bf16 rows of D + 8 keep rows 16-byte aligned
  // and every fragment read of the kernel on 32 distinct banks
  static constexpr int pitch = D + (sizeof(T) == 4 ? 4 : 8);
  static constexpr int tile = BK * pitch;      // elements of a 64-row tile
  // K, V, two (Q, dO) buffers, two (lse, delta) buffers
  static constexpr int bytes =
      6 * tile * (int)sizeof(T) + 4 * BQ * (int)sizeof(float);
};

// Rows [row0, row0 + 64) of one head (row stride `rs`, head dim dense)
// into a tile of pitch P, rows at or past S as 0.  vec: 16-byte
// cp.async (rows and base 16-byte aligned); else one element per copy.
template <typename T, int D>
__device__ __forceinline__ void fetch_rows(T* dst, const T* src, long long rs,
                                           int row0, int S, bool vec) {
  constexpr int P = DkdvGeom<T, D>::pitch, NT = DkdvGeom<T, D>::threads;
  if (vec) {
    constexpr int W = 16 / (int)sizeof(T), CPR = D / W;
    static_assert(BK * CPR % NT == 0, "chunks must split evenly");
#pragma unroll
    for (int i = 0; i < BK * CPR / NT; ++i) {
      const int c = threadIdx.x + i * NT;
      const int r = c / CPR, col = (c % CPR) * W, row = row0 + r;
      const bool ok = row < S;
      cp_async16(dst + r * P + col, ok ? src + row * rs + col : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < BK * D; e += NT) {
      const int r = e / D, col = e % D, row = row0 + r;
      const bool ok = row < S;
      if constexpr (sizeof(T) == 4)
        cp_async4(dst + r * P + col, ok ? src + row * rs + col : src,
                  ok ? 4 : 0);
      else
        dst[r * P + col] = ok ? src[row * rs + col] : from_f<T>(0.f);
    }
  }
}

// acc[j] += the warp's 16 x 64 tile of A.B^T over D: A = 16 rows at `a`,
// B = 64 rows at `b` (j: columns 8j..8j+7), both of pitch P.
template <int D, int P>
__device__ __forceinline__ void rows_dot(const float* a, const float* b,
                                         float acc[8][4], int g, int t) {
#pragma unroll
  for (int kk = 0; kk < D; kk += 8) {
    uint32_t ab[4], as[4], bb[8][2], bs[8][2];
    split_tf32(a[g * P + kk + t], ab[0], as[0]);
    split_tf32(a[(g + 8) * P + kk + t], ab[1], as[1]);
    split_tf32(a[g * P + kk + t + 4], ab[2], as[2]);
    split_tf32(a[(g + 8) * P + kk + t + 4], ab[3], as[3]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      split_tf32(b[(8 * j + g) * P + kk + t], bb[j][0], bs[j][0]);
      split_tf32(b[(8 * j + g) * P + kk + t + 4], bb[j][1], bs[j][1]);
    }
    mma_3xtf32<8>(acc, ab, as, bb, bs);
  }
}

template <int D, int P>
__device__ __forceinline__ void rows_dot(const __nv_bfloat16* a,
                                         const __nv_bfloat16* b,
                                         float acc[8][4], int g, int t) {
  auto pair = [](const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  };
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    const uint32_t af[4] = {pair(a + g * P + kk + 2 * t),
                            pair(a + (g + 8) * P + kk + 2 * t),
                            pair(a + g * P + kk + 2 * t + 8),
                            pair(a + (g + 8) * P + kk + 2 * t + 8)};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const __nv_bfloat16* row = b + (8 * j + g) * P + kk + 2 * t;
      const uint32_t bf[2] = {pair(row), pair(row + 8)};
      mma_bf16(acc[j], af, bf);
    }
  }
}

// out += x.B over the block's 64 q positions: x = the warp's 16 x 64
// accumulator fragments (P^T or dS^T), B = 64 rows of pitch P (dO or
// Q).  The tensor cores sum the q block into `blk`, NB column tiles of
// 8 at a time (NB independent accumulators keep the dependent mma
// chains short), which is then added into `out` (the promotion).
template <int D, int P>
__device__ __forceinline__ void rows_acc(const float x[8][4], const float* b,
                                         float out[D / 8][4], int g, int t) {
  constexpr int NB = D / 8 < 8 ? D / 8 : 8;   // column tiles per chunk
#pragma unroll
  for (int n0 = 0; n0 < D / 8; n0 += NB) {
    float blk[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) blk[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // k slot t <-> q column 8j + 2t, slot t + 4 <-> 8j + 2t + 1
      uint32_t ab[4], as[4];
      split_tf32(x[j][0], ab[0], as[0]);
      split_tf32(x[j][2], ab[1], as[1]);
      split_tf32(x[j][1], ab[2], as[2]);
      split_tf32(x[j][3], ab[3], as[3]);
      const float* row = b + (8 * j + 2 * t) * P + g;
      uint32_t bb[NB][2], bs[NB][2];
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        split_tf32(row[(n0 + n) * 8], bb[n][0], bs[n][0]);
        split_tf32(row[P + (n0 + n) * 8], bb[n][1], bs[n][1]);
      }
      mma_3xtf32<NB>(blk, ab, as, bb, bs);
    }
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[n0 + n][e] += blk[n][e];
  }
}

// bf16: Q and dO are exact in bf16 but P^T and dS^T are fp32 sums, and
// rounding them to bf16 alone misses the fp32-computed plain version by
// up to 2e-3 of an output's cond where few terms cancel (a CPU
// emulation at S 130 failed the bf16 tolerance of 1e-3 of cond); so x
// is split as hi + lo, both bf16, and the lo.B and hi.B products are
// issued in that order (x's representation error is then below 2^-16).
template <int D, int P>
__device__ __forceinline__ void rows_acc(const float x[8][4],
                                         const __nv_bfloat16* b,
                                         float out[D / 8][4], int g, int t) {
  constexpr int NB = D / 8 < 8 ? D / 8 : 8;   // column tiles per chunk
  // k-step j2 covers q columns 16 j2 .. 16 j2 + 15: two C fragments
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int j2 = 0; j2 < 4; ++j2)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float* c = x[2 * j2 + (r >> 1)] + 2 * (r & 1);
      const __nv_bfloat16 h0 = __float2bfloat16(c[0]);
      const __nv_bfloat16 h1 = __float2bfloat16(c[1]);
      hi[j2][r] = pack_bf16(h0, h1);
      lo[j2][r] = pack_bf16(c[0] - __bfloat162float(h0),
                            c[1] - __bfloat162float(h1));
    }
#pragma unroll
  for (int n0 = 0; n0 < D / 8; n0 += NB) {
    float blk[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) blk[n][e] = 0.f;
#pragma unroll
    for (int j2 = 0; j2 < 4; ++j2) {
      const __nv_bfloat16* row = b + (16 * j2 + 2 * t) * P + g;
      uint32_t bf[NB][2];
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const __nv_bfloat16* col = row + (n0 + n) * 8;
        bf[n][0] = pack_bf16(col[0], col[P]);
        bf[n][1] = pack_bf16(col[8 * P], col[9 * P]);
      }
#pragma unroll
      for (int n = 0; n < NB; ++n) mma_bf16(blk[n], lo[j2], bf[n]);
#pragma unroll
      for (int n = 0; n < NB; ++n) mma_bf16(blk[n], hi[j2], bf[n]);
    }
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[n0 + n][e] += blk[n][e];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(DkdvGeom<T, D>::threads)
flash_bwd_dkdv_kernel(const FlashArgs a) {
  using Geo = DkdvGeom<T, D>;
  constexpr int P = Geo::pitch, C = Geo::cols, NC = C / 8;
  extern __shared__ float4 smem4[];
  T* Ks = reinterpret_cast<T*>(smem4);           // [BK][P]
  T* Vs = Ks + Geo::tile;                        // [BK][P]
  T* Qs = Vs + Geo::tile;                        // [2][BQ][P]
  T* Gs = Qs + 2 * Geo::tile;                    // [2][BQ][P]
  float* lse_s = reinterpret_cast<float*>(Gs + 2 * Geo::tile);  // [2][BQ]
  float* dlt_s = lse_s + 2 * BQ;                                // [2][BQ]
  // kv blocks are the grid's slowest dimension, so the blocks with the
  // most q blocks (the first kv blocks) are dispatched first
  const int kvh = blockIdx.x, b = blockIdx.y, ik = blockIdx.z;
  const int G = a.H / a.KV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int S = a.S, k0 = ik * BK;
  // the warp's share: kv rows [kr, kr + 16) of the tile, columns
  // [col0, col0 + C) of dk and dv
  const int kr = (D > 64 ? warp % 4 : warp) * 16;
  const int col0 = D > 64 ? (warp / 4) * C : 0;
  const int nq = (S + BQ - 1) / BQ;
  const int qlo = ik;
  const int qhi = a.window > 0 ? min((k0 + BK + a.window - 2) / BQ + 1, nq) : nq;
  const int nqb = qhi - qlo, items = G * nqb;   // (query head, q block) pairs

  fetch_rows<T, D>(Ks, static_cast<const T*>(a.k) + b * a.ks.b + kvh * a.ks.h,
                   a.ks.s, k0, S, a.vec);
  fetch_rows<T, D>(Vs, static_cast<const T*>(a.v) + b * a.vs.b + kvh * a.vs.h,
                   a.vs.s, k0, S, a.vec);
  // Item it = (query head kvh*G + it / nqb, q block qlo + it % nqb) into
  // ring buffer it & 1.
  auto fetch = [&](int it) {
    const int h = kvh * G + it / nqb, q0 = (qlo + it % nqb) * BQ;
    const int buf = it & 1;
    fetch_rows<T, D>(Qs + buf * Geo::tile,
                     static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h,
                     a.qs.s, q0, S, a.vec);
    fetch_rows<T, D>(Gs + buf * Geo::tile,
                     static_cast<const T*>(a.g) + b * a.gs.b + h * a.gs.h,
                     a.gs.s, q0, S, a.vec);
    if (threadIdx.x < 2 * BQ) {
      const int c = threadIdx.x & (BQ - 1), qpos = q0 + c;
      const float* row = (threadIdx.x < BQ ? a.lse_in : a.delta) +
                         ((long long)b * a.H + h) * S;
      float* dst = (threadIdx.x < BQ ? lse_s : dlt_s) + buf * BQ + c;
      cp_async4(dst, qpos < S ? row + qpos : row, qpos < S ? 4 : 0);
    }
  };
  fetch(0);
  cp_async_commit();

  float dk[NC][4], dv[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[c][e] = dv[c][e] = 0.f;

  for (int it = 0; it < items; ++it) {
    cp_async_wait<0>();
    __syncthreads();      // item it is in for every thread; item it-1's buffer is free
    if (it + 1 < items) fetch(it + 1);
    cp_async_commit();
    const int buf = it & 1, q0 = (qlo + it % nqb) * BQ;
    const T* qs = Qs + buf * Geo::tile;
    const T* gs = Gs + buf * Geo::tile;
    const float* lse = lse_s + buf * BQ;
    const float* delta = dlt_s + buf * BQ;
    // The warp's kv rows [kmin, kmin + 16) against q columns [q0, q0 + 64):
    // skip the pair where no (q, k) is visible, test each element only
    // where some are not.
    const int kmin = k0 + kr, qmax = q0 + BQ - 1;
    const bool none = qmax < kmin || (a.window > 0 && q0 - (kmin + 15) >= a.window);
    const bool all = q0 >= kmin + 15 && qmax < S &&
                     (a.window <= 0 || qmax - kmin < a.window);
    if (!none) {
      // rows of the transposed score tile: kv rows, q columns
      float s[8][4], dp[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      rows_dot<D, P>(Ks + kr * P, qs, s, g, t);
      rows_dot<D, P>(Vs + kr * P, gs, dp, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);
          const bool ok =
              all || visible(q0 + c, kmin + g + 8 * (e >> 1), S, a.window);
          s[j][e] = ok ? expf(s[j][e] * a.scale - lse[c]) : 0.f;   // p
        }
      rows_acc<C, P>(s, gs + col0, dv, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);
          dp[j][e] = s[j][e] * (dp[j][e] - delta[c]) * a.scale;   // ds
        }
      rows_acc<C, P>(dp, qs + col0, dk, g, t);
    }
  }
  cp_async_wait<0>();

  T* dkp = static_cast<T*>(a.dk);
  T* dvp = static_cast<T*>(a.dv);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kpos = k0 + kr + g + 8 * h;
    if (kpos >= S) continue;
    const long long off = (((long long)b * S + kpos) * a.KV + kvh) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + c * 8 + 2 * t + e;
        dkp[off + col] = from_f<T>(dk[c][2 * h + e]);
        dvp[off + col] = from_f<T>(dv[c][2 * h + e]);
      }
  }
}

// Raise the kernel's dynamic shared-memory limit (above 48 KB a launch
// is refused without it), then launch.
template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int threads, int smem,
           const FlashArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

enum Kind { kFwd, kDq, kDkdv };

template <typename T, int D>
int launch_kind(Kind kind, const FlashArgs& a, cudaStream_t stream) {
  const int nq = (a.S + BQ - 1) / BQ;
  switch (kind) {
    case kFwd:
      return launch(flash_fwd_kernel<T, D>, dim3(nq, a.H, a.B), NT,
                    fwd_smem_bytes<D>(), a, stream);
    case kDq:
      return launch(flash_bwd_dq_kernel<T, D>, dim3(nq, a.H, a.B), NT,
                    dq_smem_bytes<D>(), a, stream);
    default:
      return launch(flash_bwd_dkdv_kernel<T, D>, dim3(a.KV, a.B, nq),
                    DkdvGeom<T, D>::threads, DkdvGeom<T, D>::bytes, a,
                    stream);
  }
}

template <typename T>
int launch_d(Kind kind, int D, const FlashArgs& a, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_kind<T, 32>(kind, a, stream);
    case 64: return launch_kind<T, 64>(kind, a, stream);
    case 128: return launch_kind<T, 128>(kind, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch(Kind kind, int D, int dtype, const FlashArgs& a, void* stream) {
  if (a.B <= 0 || a.S <= 0 || a.H <= 0 || a.KV <= 0 || a.H % a.KV != 0 ||
      a.window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32) return launch_d<float>(kind, D, a, s);
  if (dtype == kBF16) return launch_d<__nv_bfloat16>(kind, D, a, s);
  return (int)cudaErrorInvalidValue;
}

FlashArgs make_args(const void* q, const void* k, const void* v, int B, int S,
                    int H, int KV, int window, float scale, int q_sb,
                    int q_ss, int q_sh, int k_sb, int k_ss, int k_sh,
                    int v_sb, int v_ss, int v_sh) {
  FlashArgs a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.B = B;
  a.S = S;
  a.H = H;
  a.KV = KV;
  a.window = window;
  a.scale = scale;
  a.qs = {q_sb, q_ss, q_sh};
  a.ks = {k_sb, k_ss, k_sh};
  a.vs = {v_sb, v_ss, v_sh};
  return a;
}

}  // namespace

extern "C" {

int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
              int B, int S, int H, int KV, int D, int window, float scale,
              int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh,
              int v_sb, int v_ss, int v_sh, int dtype, void* stream) {
  FlashArgs a = make_args(q, k, v, B, S, H, KV, window, scale, q_sb, q_ss,
                          q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh);
  a.o = o;
  a.lse = (float*)lse;
  return dispatch(kFwd, D, dtype, a, stream);
}

int flash_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                 const void* lse, const void* delta, void* dq, int B, int S,
                 int H, int KV, int D, int window, float scale, int q_sb,
                 int q_ss, int q_sh, int k_sb, int k_ss, int k_sh, int v_sb,
                 int v_ss, int v_sh, int g_sb, int g_ss, int g_sh, int dtype,
                 void* stream) {
  FlashArgs a = make_args(q, k, v, B, S, H, KV, window, scale, q_sb, q_ss,
                          q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh);
  a.g = g;
  a.gs = {g_sb, g_ss, g_sh};
  a.lse_in = (const float*)lse;
  a.delta = (const float*)delta;
  a.dq = dq;
  return dispatch(kDq, D, dtype, a, stream);
}

int flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* g,
                   const void* lse, const void* delta, void* dk, void* dv,
                   int B, int S, int H, int KV, int D, int window, float scale,
                   int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh,
                   int v_sb, int v_ss, int v_sh, int g_sb, int g_ss, int g_sh,
                   int dtype, void* stream) {
  FlashArgs a = make_args(q, k, v, B, S, H, KV, window, scale, q_sb, q_ss,
                          q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh);
  a.g = g;
  a.gs = {g_sb, g_ss, g_sh};
  a.lse_in = (const float*)lse;
  a.delta = (const float*)delta;
  a.dk = dk;
  a.dv = dv;
  const int w = dtype == kBF16 ? 8 : 4;   // elements per 16 bytes
  auto rows16 = [w](const void* p, const Strides& st) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % w == 0 &&
           st.s % w == 0 && st.h % w == 0;
  };
  a.vec = rows16(q, a.qs) && rows16(k, a.ks) && rows16(v, a.vs) &&
          rows16(g, a.gs);
  return dispatch(kDkdv, D, dtype, a, stream);
}

}  // extern "C"
