// Causal GQA flash attention for Hopper (sm_90a): the forward, the dq
// backward, and one fused dk/dv backward.
//
// Layouts are the JAX package's public ones: q, o, g (= dO) and dq are
// [B, Sq, H, D]; k, v, dk and dv are [B, Sk, KV, D]; lse and delta are
// [B, H, Sq] fp32.  Sq <= Sk: the queries are the last Sq of the Sk
// positions, query row i at key position i + Sk - Sq (a sequence shard's
// queries against the keys up to the shard's end; Sq == Sk is the whole
// sequence).  Every mask and block bound is taken in key positions, so
// at Sq == Sk the arithmetic is that of the plain causal kernels.  q,
// k, v and g are read in place through their (batch, seq, head)
// strides, with the head dim dense: no transpose or pad copies.  Query
// head h reads kv head h / G, G = H / KV.  Outputs are written
// contiguous.  Scores are scaled by 1/sqrt(D) and every product is
// accumulated in fp32.
//
// Bound on the H100: operations.  At the flash path's shape (B 2, S
// 2048, H 16, D 64) a 64x64 score tile costs 2*64*64*64 flops per
// product for 2*64*64*4 bytes of tile, and the causal mask halves the
// work, so the tiles come from L2 and the kernels are limited by the
// arithmetic rate: 67 TFLOP/s of fp32 on the CUDA cores, or 495 TFLOP/s
// of TF32 on the tensor cores, which run three TF32 products for each
// fp32 one (3xTF32).  Each kernel's note gives its numbers.
//
// Design, shared by the three kernels: every product runs on the tensor
// cores (tensor_core.cuh: 3xTF32 mma.sync for fp32, m16n8k16 for bf16),
// a warp per 16 rows of the block's tile against 64 rows of the other
// operand (the warp's 16 x 64 score tile).  Shared tiles keep the global
// row-major layout at TileGeom's pitch and are filled by cp.async
// (fetch_rows), so every operand is read row-major, never transposed:
// rows_dot forms a warp's 16 x 64 tile of A.B^T over D (S = Q.K^T, dP =
// dO.V^T, or their transposes in dk/dv), and rows_acc adds x.B where x
// is such a tile still in the mma's C fragments (P or dS, or their
// transposes), fed straight back as the A operand.  A C fragment holds
// columns (2t, 2t+1) where an A fragment wants (t, t + 4), so the index
// inside each k-step of 8 is permuted (slot t <-> 2t, slot t + 4 <-> 2t
// + 1) on both operands, which leaves the sum unchanged and needs
// neither a shuffle nor a trip through shared memory (bf16: the m16n8k16
// A layout matches two C fragments as they are).  The tensor core's own
// additions round toward zero, so rows_acc sums one 64-wide block into a
// zeroed accumulator and promotes it into fp32 registers once per block.
// The softmax, p and ds are formed on the C fragments in registers; a
// row's max and sum are reduced over the 4 lanes that hold it, in a
// fixed order.  mma.sync and not wgmma for fp32: wgmma's .tf32 operands
// must be K-major in shared memory, and these products read Q, dO, K and
// V both ways; a wgmma/TMA design would transpose them in shared memory
// first.  bf16 operands wgmma reads in either order: the bf16 forward at
// head dims 64 and 128 runs flash_wgmma.cu's warp-specialised wgmma + TMA
// instance wherever TMA reads q, k and v (kernels/flash.py); the
// backward kernels are next.
//
// Plain C interface (extern "C"), loaded with ctypes by kernels/build.py.
// Every launcher takes the stream it must launch on, allocates nothing,
// does not synchronise, and returns cudaGetLastError() (or the error of
// raising the kernel's shared-memory limit).  dtype codes: 0 = float32,
// 1 = bfloat16.  No kernel uses atomics and every loop runs in a fixed
// order: the same inputs give bitwise-equal outputs.
//
// Tiles.  The forward and dq walk a grid of q blocks of BQ rows against
// kv blocks of 64; dk/dv walks kv blocks of BK rows against q blocks of
// 64.  BQ (BK) is a template parameter, 64 or 128: the block runs BQ / 16
// (BK / 16) warps of rows, each warp's arithmetic and order of sums is
// the same whatever the tile, and a warp skips the blocks none of whose
// pairs with its rows is visible, so every tile gives bitwise-equal
// outputs.  kernels/autotune.py picks the tile per (sequence bucket, head
// dim, dtype); kernels/flash.py lists the built instances.
//
// This header holds the kernels as templates; flash.cu holds the C entry
// points and each flash_<kernel>_<dtype>.cu one launcher's instances.
#pragma once
#include <cstdint>

#include "tensor_core.cuh"

// The argument block and the per-(kernel, dtype) launchers are shared
// across translation units; the kernels themselves stay internal.
namespace flash_impl {


constexpr int TW = 64;          // rows of the other operand's tile: the
                                // width of a warp's 16 x 64 score tile
constexpr int SMEM_MAX = 232448;   // opt-in shared memory a block (227 KB)
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
  int B, Sq, Sk, H, KV, window;
  float scale;
  Strides qs, ks, vs, gs;
  bool vec;                     // rows 16-byte aligned (cp.async 16)
};

enum Kind { kFwd, kDq, kDkdv };

// One launcher per (kernel, dtype), each defined in its own source
// (flash_<kernel>_<dtype>.cu) so that nvcc compiles the instances side
// by side; (D, tile) picks the instance, tile being BQ for the forward
// and dq and BK for dk/dv; an unbuilt pair is refused.
using Launcher = int (*)(int D, int tile, const FlashArgs& a,
                         cudaStream_t stream);
int launch_fwd_f32(int D, int tile, const FlashArgs& a, cudaStream_t stream);
int launch_fwd_bf16(int D, int tile, const FlashArgs& a, cudaStream_t stream);
int launch_dq_f32(int D, int tile, const FlashArgs& a, cudaStream_t stream);
int launch_dq_bf16(int D, int tile, const FlashArgs& a, cudaStream_t stream);
int launch_dkdv_f32(int D, int tile, const FlashArgs& a, cudaStream_t stream);
int launch_dkdv_bf16(int D, int tile, const FlashArgs& a, cudaStream_t stream);

// The 128-row tile is built at head dims 64 and 128 (gpt3-medium and
// granite-moe, qwen3), where it fits the opt-in shared memory: the
// forward in both dtypes, dq and dk/dv at D 128 in bf16 only (fp32 would
// need 270,336 bytes).  kernels/flash.py::built mirrors this.
template <Kind K, typename T>
constexpr bool wide_built(int D) {
  return D == 64 || (D == 128 && (K == kFwd || sizeof(T) == 2));
}

}  // namespace flash_impl

namespace {

using namespace flash_impl;

// (q position, k position), both key positions, takes part: causal,
// inside the sequence of Sk keys (the query row is below Sq), and inside
// the sliding window when window > 0.
__device__ __forceinline__ bool visible(int qpos, int kpos, int Sk,
                                        int window) {
  return kpos <= qpos && qpos < Sk && (window <= 0 || kpos > qpos - window);
}

// Max / sum over the 4 lanes that hold one row of a C fragment (lanes
// 4g .. 4g + 3), in a fixed butterfly order.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A warp owns 16 rows of the block's ROWS-row tile and at most 64
// columns of the fp32 output: above D 64 two warps share each 16 rows,
// each taking half the columns (D 80: 40, D 96: 48, D 128: 64) and
// repeating the rows' score products, since more output columns beside
// the score fragments spill registers (forward and dq: 24-32 bytes at D
// 128 with 4 warps; dk/dv, two outputs: 756).  A 64-row tile runs 4 or 8
// warps, a 128-row tile 8 or 16.
template <typename T, int D, int ROWS>
struct WarpGeom {
  static_assert(D % 16 == 0, "m16n8k16 steps over D");
  static_assert(ROWS % 16 == 0, "a warp per 16 rows");
  static constexpr int row_warps = ROWS / 16;
  static constexpr int cols = D > 64 ? D / 2 : D;
  static constexpr int threads = row_warps * 32 * (D / cols);
};

// Shared tiles: fp32 rows of D + 4 and bf16 rows of D + 8 keep rows
// 16-byte aligned and every fragment read of the kernels on 32 distinct
// banks.
template <typename T, int D>
struct TileGeom {
  static constexpr int pitch = D + (sizeof(T) == 4 ? 4 : 8);
  static constexpr int bytes(int rows) { return rows * pitch * (int)sizeof(T); }
};

// Rows [row0, row0 + ROWS) of one head (row stride `rs`, head dim dense)
// into a tile of TileGeom's pitch, rows at or past S as 0, by the block's
// NT threads.  vec: 16-byte cp.async (rows and base 16-byte aligned);
// else one element per copy.
template <typename T, int D, int NT, int ROWS>
__device__ __forceinline__ void fetch_rows(T* dst, const T* src, long long rs,
                                           int row0, int S, bool vec) {
  constexpr int P = TileGeom<T, D>::pitch;
  if (vec) {
    constexpr int W = 16 / (int)sizeof(T), CPR = D / W;
    constexpr int CHUNKS = ROWS * CPR;   // 16-byte copies of the tile
#pragma unroll
    for (int i = 0; i < (CHUNKS + NT - 1) / NT; ++i) {
      const int c = threadIdx.x + i * NT;
      if (CHUNKS % NT != 0 && c >= CHUNKS) break;
      const int r = c / CPR, col = (c % CPR) * W, row = row0 + r;
      const bool ok = row < S;
      cp_async16(dst + r * P + col, ok ? src + row * rs + col : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * D; e += NT) {
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

// out += x.B over one block's 64 positions: x = the warp's 16 x 64
// accumulator fragments (P, dS or their transposes), B = 64 rows of
// pitch P (V, K, dO or Q).  The tensor cores sum the block into `blk`,
// NB column tiles of 8 at a time (NB independent accumulators keep the
// dependent mma chains short), which is then added into `out` (the
// promotion).
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
      // k slot t <-> position 8j + 2t, slot t + 4 <-> 8j + 2t + 1
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

// bf16: the B rows are exact in bf16 but P and dS are fp32 sums, and
// rounding them to bf16 alone misses the fp32-computed plain version by
// up to 2e-3 of an output's cond where few terms cancel (a CPU
// emulation of dk/dv at S 130 failed the bf16 tolerance of 1e-3 of
// cond); so x is split as hi + lo, both bf16, and the lo.B and hi.B
// products are issued in that order (x's representation error is then
// below 2^-16).
template <int D, int P>
__device__ __forceinline__ void rows_acc(const float x[8][4],
                                         const __nv_bfloat16* b,
                                         float out[D / 8][4], int g, int t) {
  constexpr int NB = D / 8 < 8 ? D / 8 : 8;   // column tiles per chunk
  // k-step j2 covers positions 16 j2 .. 16 j2 + 15: two C fragments
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

// ---------------------------------------------------------------------
// The forward and dq share their walk: one block per (q block of BQ
// rows, head, batch), warp w owning q rows [16 (w % R), 16 (w % R) + 16)
// of the tile, R = BQ / 16, and output columns [C (w / R), C (w / R) + C)
// (WarpGeom), over the kv blocks of 64, [lo, hi) of the reference's
// _kv_bounds taken at the block's key positions, in order.
// The q-side tiles (Q, and dO in dq) are fetched once and stay in shared
// memory (their split fragments would not fit in registers beside the
// fp32 output); K and V go through a 2-stage cp.async ring, the next kv
// block loading while this one computes.  A warp skips a kv block none
// of whose pairs with its rows is visible (such a block leaves its rows
// unchanged), and tests visible() per element only where some are not.
// Under the causal mask the last q blocks read the most kv blocks, so
// the q block is the grid's slowest dimension, taken from the last: the
// longest blocks are dispatched first and the short ones fill the last
// wave (in launch order the forward took 18 % and dq 14 % longer on the
// H100).  The launch bounds ask for one block an SM: without the minimum
// ptxas held both kernels at D 64 to ~166 registers, and the forward ran
// 13 % and dq 5 % slower; shared memory allows two 64-row blocks an SM at
// D 64 either way.
// ---------------------------------------------------------------------
template <int BQ>
struct QWalk {
  static constexpr int BK = TW;
  // q0: the block's first query row; qr: the warp's first query row as a
  // key position (row + Sk - Sq), the position every mask test takes
  int h, b, kvh, rows, col0, g, t, Sq, Sk, q0, qr, lo, hi;

  __device__ QWalk(const FlashArgs& a, int cols) {
    constexpr int R = BQ / 16;                    // warps of rows
    h = blockIdx.x;
    b = blockIdx.y;
    const int iq = (int)(gridDim.z - 1 - blockIdx.z);  // the longest first
    kvh = h / (a.H / a.KV);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    rows = 16 * (warp % R);                       // the warp's rows of the tile
    col0 = cols * (warp / R);                     // and its first output column
    g = lane >> 2;
    t = lane & 3;
    Sq = a.Sq;
    Sk = a.Sk;
    q0 = iq * BQ;
    const int p0 = q0 + Sk - Sq;                  // the block's first q pos.
    qr = p0 + rows;                               // the warp's first q pos.
    lo = a.window > 0 ? max((p0 - a.window + 1) / BK, 0) : 0;
    hi = min((p0 + BQ - 1) / BK + 1, (Sk + BK - 1) / BK);
  }
  // Of the warp's rows [qr, qr + 16) against kv [k0, k0 + 64): no pair
  // visible, or every pair visible.
  __device__ bool none(int k0, int window) const {
    return qr >= Sk || qr + 15 < k0 ||
           (window > 0 && qr - (k0 + BK - 1) >= window);
  }
  __device__ bool all(int k0, int window) const {
    return k0 + BK - 1 <= qr && qr + 15 < Sk &&
           (window <= 0 || qr + 15 - k0 < window);
  }
  // The query row of key position qpos
  __device__ int row(int qpos) const { return qpos - (Sk - Sq); }
  // (q, k) positions of C-fragment element e of column tile j, at kv
  // block k0
  __device__ int qpos(int e) const { return qr + g + 8 * (e >> 1); }
  __device__ int kpos(int k0, int j, int e) const {
    return k0 + 8 * j + 2 * t + (e & 1);
  }
};

// ---------------------------------------------------------------------
// Forward.  Replaces repro/kernels/flash_attention.py::_flash_kernel.
// Online softmax (m, l, O) in fp32; writes O in the input dtype and lse
// = m + log(max(l, 1e-20)) for the rows below S.
// Bound at the flash path's shape: 2 products over the 2.1 M causal
// (q, k) pairs of each of the 32 (batch, head): 17.2 GFLOP, 0.257 ms at
// the CUDA cores' fp32 rate, 0.104 ms as 3xTF32 on the tensor cores (its
// 67 MB of operands: 0.020 ms).
// Design: per kv block a warp forms its 16 x 64 tile of S = Q.K^T
// (rows_dot), masks and scales it, takes the row max over the tile and
// the running m, p = exp(s.scale - m_new) and the row sum on the C
// fragments, scales its O registers by corr = exp(m - m_new), and adds
// P.V (rows_acc), promoted once per block.
// ---------------------------------------------------------------------
template <typename T, int D, int BQ>
__global__ void __launch_bounds__(WarpGeom<T, D, BQ>::threads, 1)
flash_fwd_kernel(const FlashArgs a) {
  constexpr int BK = TW;
  constexpr int P = TileGeom<T, D>::pitch, TILE = BK * P;
  constexpr int C = WarpGeom<T, D, BQ>::cols, NT = WarpGeom<T, D, BQ>::threads;
  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);           // [BQ][P]
  T* Ks = Qs + BQ * P;                           // [2][BK][P]
  T* Vs = Ks + 2 * TILE;                         // [2][BK][P]
  const QWalk<BQ> w(a, C);
  const T* k = static_cast<const T*>(a.k) + w.b * a.ks.b + w.kvh * a.ks.h;
  const T* v = static_cast<const T*>(a.v) + w.b * a.vs.b + w.kvh * a.vs.h;
  fetch_rows<T, D, NT, BQ>(Qs, static_cast<const T*>(a.q) + w.b * a.qs.b +
                                   w.h * a.qs.h,
                           a.qs.s, w.q0, w.Sq, a.vec);
  // kv block ik into ring buffer (ik - lo) & 1
  auto fetch = [&](int ik) {
    const int buf = (ik - w.lo) & 1;
    fetch_rows<T, D, NT, BK>(Ks + buf * TILE, k, a.ks.s, ik * BK, w.Sk, a.vec);
    fetch_rows<T, D, NT, BK>(Vs + buf * TILE, v, a.vs.s, ik * BK, w.Sk, a.vec);
  };
  fetch(w.lo);
  cp_async_commit();

  float o[C / 8][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < C / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int ik = w.lo; ik < w.hi; ++ik) {
    cp_async_wait<0>();
    __syncthreads();      // block ik is in for every thread; ik-1's buffer is free
    if (ik + 1 < w.hi) fetch(ik + 1);
    cp_async_commit();
    const int k0 = ik * BK, buf = (ik - w.lo) & 1;
    if (w.none(k0, a.window)) continue;
    const bool all = w.all(k0, a.window);
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    rows_dot<D, P>(Qs + w.rows * P, Ks + buf * TILE, s, w.g, w.t);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok =
            all || visible(w.qpos(e), w.kpos(k0, j, e), w.Sk, a.window);
        s[j][e] = ok ? s[j][e] * a.scale : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok =
            all || visible(w.qpos(e), w.kpos(k0, j, e), w.Sk, a.window);
        s[j][e] = ok ? expf(s[j][e] - mx[e >> 1]) : 0.f;       // p
        sum[e >> 1] += s[j][e];
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      corr[r] = expf(m[r] - mx[r]);
      l[r] = l[r] * corr[r] + quad_sum(sum[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < C / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];
    rows_acc<C, P>(s, Vs + buf * TILE + w.col0, o, w.g, w.t);
  }
  cp_async_wait<0>();

  T* out = static_cast<T*>(a.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = w.qpos(2 * r);
    if (qpos >= w.Sk) continue;
    const int qi = w.row(qpos);
    const float li = fmaxf(l[r], 1e-20f);
    T* row = out + (((long long)w.b * w.Sq + qi) * a.H + w.h) * D + w.col0;
#pragma unroll
    for (int n = 0; n < C / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        row[8 * n + 2 * w.t + e] = from_f<T>(o[n][2 * r + e] / li);
    if (w.t == 0 && w.col0 == 0)
      a.lse[((long long)w.b * a.H + w.h) * w.Sq + qi] = m[r] + logf(li);
  }
}

// ---------------------------------------------------------------------
// dq.  Replaces repro/kernels/flash_attention.py::_flash_bwd_dq_kernel.
// Over the same kv blocks as the forward: p = exp(s.scale - lse) rebuilt
// from the saved lse, dp = dO.V^T, ds = p (dp - delta) scale, dq +=
// ds.K.
// Bound at the flash path's shape: 3 products over the causal pairs:
// 25.8 GFLOP, 0.385 ms at the CUDA cores' fp32 rate, 0.156 ms as 3xTF32
// on the tensor cores (its 84 MB of operands: 0.025 ms).
// Design: per kv block a warp forms its 16 x 64 tiles of S = Q.K^T and
// dP = dO.V^T (rows_dot), then p and ds on the C fragments, and adds
// dS.K (rows_acc) into its fp32 dq registers, promoted once per block.
// ---------------------------------------------------------------------
template <typename T, int D, int BQ>
__global__ void __launch_bounds__(WarpGeom<T, D, BQ>::threads, 1)
flash_bwd_dq_kernel(const FlashArgs a) {
  constexpr int BK = TW;
  constexpr int P = TileGeom<T, D>::pitch, TILE = BK * P;
  constexpr int C = WarpGeom<T, D, BQ>::cols, NT = WarpGeom<T, D, BQ>::threads;
  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);           // [BQ][P]
  T* Gs = Qs + BQ * P;                           // [BQ][P]
  T* Ks = Gs + BQ * P;                           // [2][BK][P]
  T* Vs = Ks + 2 * TILE;                         // [2][BK][P]
  const QWalk<BQ> w(a, C);
  const T* k = static_cast<const T*>(a.k) + w.b * a.ks.b + w.kvh * a.ks.h;
  const T* v = static_cast<const T*>(a.v) + w.b * a.vs.b + w.kvh * a.vs.h;
  fetch_rows<T, D, NT, BQ>(Qs, static_cast<const T*>(a.q) + w.b * a.qs.b +
                                   w.h * a.qs.h,
                           a.qs.s, w.q0, w.Sq, a.vec);
  fetch_rows<T, D, NT, BQ>(Gs, static_cast<const T*>(a.g) + w.b * a.gs.b +
                                   w.h * a.gs.h,
                           a.gs.s, w.q0, w.Sq, a.vec);
  auto fetch = [&](int ik) {
    const int buf = (ik - w.lo) & 1;
    fetch_rows<T, D, NT, BK>(Ks + buf * TILE, k, a.ks.s, ik * BK, w.Sk, a.vec);
    fetch_rows<T, D, NT, BK>(Vs + buf * TILE, v, a.vs.s, ik * BK, w.Sk, a.vec);
  };
  fetch(w.lo);
  cp_async_commit();

  const long long row_base = ((long long)w.b * a.H + w.h) * w.Sq;
  float lse[2], delta[2], dq[C / 8][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = w.qpos(2 * r);
    lse[r] = qpos < w.Sk ? a.lse_in[row_base + w.row(qpos)] : 0.f;
    delta[r] = qpos < w.Sk ? a.delta[row_base + w.row(qpos)] : 0.f;
  }
#pragma unroll
  for (int n = 0; n < C / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int ik = w.lo; ik < w.hi; ++ik) {
    cp_async_wait<0>();
    __syncthreads();      // block ik is in for every thread; ik-1's buffer is free
    if (ik + 1 < w.hi) fetch(ik + 1);
    cp_async_commit();
    const int k0 = ik * BK, buf = (ik - w.lo) & 1;
    if (w.none(k0, a.window)) continue;
    const bool all = w.all(k0, a.window);
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    rows_dot<D, P>(Qs + w.rows * P, Ks + buf * TILE, s, w.g, w.t);
    rows_dot<D, P>(Gs + w.rows * P, Vs + buf * TILE, dp, w.g, w.t);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool ok =
            all || visible(w.qpos(e), w.kpos(k0, j, e), w.Sk, a.window);
        const float p = ok ? expf(s[j][e] * a.scale - lse[r]) : 0.f;
        s[j][e] = p * (dp[j][e] - delta[r]) * a.scale;              // ds
      }
    rows_acc<C, P>(s, Ks + buf * TILE + w.col0, dq, w.g, w.t);
  }
  cp_async_wait<0>();

  T* out = static_cast<T*>(a.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = w.qpos(2 * r);
    if (qpos >= w.Sk) continue;
    T* row = out + (((long long)w.b * w.Sq + w.row(qpos)) * a.H + w.h) * D +
             w.col0;
#pragma unroll
    for (int n = 0; n < C / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        row[8 * n + 2 * w.t + e] = from_f<T>(dq[n][2 * r + e]);
  }
}

// ---------------------------------------------------------------------
// dk and dv in one kernel.  Replaces both
// repro/kernels/flash_attention.py::_flash_bwd_dk_kernel and
// ::_flash_bwd_dv_kernel, which share p and ds.
// Grid (KV head, batch, kv block).  The block loops, in a fixed order,
// over the G query heads of its kv head and, for each, over the q blocks
// of the reference's _q_bounds taken at key positions (the first q block
// holding the query at the block's first key, and under a window the
// last one a key of the block is inside the window of; with Sq < Sk a kv
// block that no query sees has none, and writes zeros); it accumulates
// dk = sum ds^T.q and
// dv = sum p^T.dO in fp32 registers and writes both once, at kv-head
// resolution: no [B, H, S, D] per-query-head buffers, no reshape-sum, no
// atomics (one writer per output element).
// Bound at the flash path's shape: 4 products over the causal pairs:
// 34.4 GFLOP, 0.513 ms at the CUDA cores' fp32 rate, 0.208 ms as 3xTF32.
// Design: a warp per 16 kv rows of the BK-row tile.  Per q block a warp
// computes its rows of S^T = K.Q^T and dP^T = V.dO^T over D (rows_dot),
// forms P^T = exp(S^T.scale - lse) and dS^T = P^T (dP^T - delta).scale
// on the accumulator fragments, and adds dV += P^T.dO and dK += dS^T.Q
// (rows_acc), promoted once per q block.  K and V stay in shared memory
// (their fragments would not fit in registers beside dk and dv); the
// next q block's Q and dO tiles, lse and delta are fetched by cp.async
// into the second buffer of a 2-stage ring while the current one
// computes.  A warp owns 16 kv rows and at most 64 columns of dk and dv:
// above D 64 two warps share each 16 rows (8 warps), each repeating the
// rows' S^T and dP^T products (WarpGeom).  A warp skips a q block none of whose
// pairs with its rows is visible and tests visible() per element only
// where some are not.  Under the causal mask the first kv blocks have
// the most q blocks, so the kv block is the grid's slowest dimension:
// those blocks are dispatched first, and the short ones fill the last
// wave (in launch order the long ones ran last, and the run took ~35 %
// longer on the H100).
// ---------------------------------------------------------------------
template <typename T, int D, int BK>
struct DkdvGeom : WarpGeom<T, D, BK> {
  static constexpr int BQ = TW;
  static constexpr int pitch = TileGeom<T, D>::pitch;
  // K, V, two (Q, dO) buffers, two (lse, delta) buffers
  static constexpr int bytes = TileGeom<T, D>::bytes(2 * BK + 4 * BQ) +
                               4 * BQ * (int)sizeof(float);
};

template <typename T, int D, int BK>
__global__ void __launch_bounds__(DkdvGeom<T, D, BK>::threads)
flash_bwd_dkdv_kernel(const FlashArgs a) {
  using Geo = DkdvGeom<T, D, BK>;
  constexpr int BQ = Geo::BQ, R = Geo::row_warps;
  constexpr int P = Geo::pitch, C = Geo::cols, NC = C / 8, NT = Geo::threads;
  constexpr int QT = BQ * P;                     // elements of a q-side tile
  extern __shared__ float4 smem4[];
  T* Ks = reinterpret_cast<T*>(smem4);           // [BK][P]
  T* Vs = Ks + BK * P;                           // [BK][P]
  T* Qs = Vs + BK * P;                           // [2][BQ][P]
  T* Gs = Qs + 2 * QT;                           // [2][BQ][P]
  float* lse_s = reinterpret_cast<float*>(Gs + 2 * QT);  // [2][BQ]
  float* dlt_s = lse_s + 2 * BQ;                         // [2][BQ]
  // kv blocks are the grid's slowest dimension, so the blocks with the
  // most q blocks (the first kv blocks) are dispatched first
  const int kvh = blockIdx.x, b = blockIdx.y, ik = blockIdx.z;
  const int G = a.H / a.KV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int Sq = a.Sq, Sk = a.Sk, off = Sk - Sq, k0 = ik * BK;
  // the warp's share: kv rows [kr, kr + 16) of the tile, columns
  // [col0, col0 + C) of dk and dv
  const int kr = (warp % R) * 16;
  const int col0 = (warp / R) * C;
  const int nq = (Sq + BQ - 1) / BQ;
  const int qlo = max(k0 - off, 0) / BQ;
  // under a window, the query row of the last position that sees the block
  const int last = k0 + BK + a.window - 2 - off;
  const int qhi = a.window > 0 ? (last < 0 ? 0 : min(last / BQ + 1, nq)) : nq;
  // (query head, q block) pairs
  const int nqb = max(qhi - qlo, 0), items = G * nqb;

  fetch_rows<T, D, NT, BK>(Ks, static_cast<const T*>(a.k) + b * a.ks.b +
                                   kvh * a.ks.h,
                           a.ks.s, k0, Sk, a.vec);
  fetch_rows<T, D, NT, BK>(Vs, static_cast<const T*>(a.v) + b * a.vs.b +
                                   kvh * a.vs.h,
                           a.vs.s, k0, Sk, a.vec);
  // Item it = (query head kvh*G + it / nqb, q block qlo + it % nqb) into
  // ring buffer it & 1.
  auto fetch = [&](int it) {
    const int h = kvh * G + it / nqb, q0 = (qlo + it % nqb) * BQ;
    const int buf = it & 1;
    fetch_rows<T, D, NT, BQ>(Qs + buf * QT,
                             static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h,
                             a.qs.s, q0, Sq, a.vec);
    fetch_rows<T, D, NT, BQ>(Gs + buf * QT,
                             static_cast<const T*>(a.g) + b * a.gs.b + h * a.gs.h,
                             a.gs.s, q0, Sq, a.vec);
    if (threadIdx.x < 2 * BQ) {
      const int c = threadIdx.x & (BQ - 1), qi = q0 + c;
      const float* row = (threadIdx.x < BQ ? a.lse_in : a.delta) +
                         ((long long)b * a.H + h) * Sq;
      float* dst = (threadIdx.x < BQ ? lse_s : dlt_s) + buf * BQ + c;
      cp_async4(dst, qi < Sq ? row + qi : row, qi < Sq ? 4 : 0);
    }
  };
  if (items > 0) fetch(0);
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
    const T* qs = Qs + buf * QT;
    const T* gs = Gs + buf * QT;
    const float* lse = lse_s + buf * BQ;
    const float* delta = dlt_s + buf * BQ;
    // The warp's kv rows [kmin, kmin + 16) against q columns at key
    // positions [p0, p0 + 64): skip the pair where no (q, k) is visible,
    // test each element only where some are not.
    const int kmin = k0 + kr, p0 = q0 + off, pmax = p0 + BQ - 1;
    const bool none =
        pmax < kmin || (a.window > 0 && p0 - (kmin + 15) >= a.window);
    const bool all = p0 >= kmin + 15 && pmax < Sk &&
                     (a.window <= 0 || pmax - kmin < a.window);
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
              all || visible(p0 + c, kmin + g + 8 * (e >> 1), Sk, a.window);
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
    if (kpos >= Sk) continue;
    const long long at = (((long long)b * Sk + kpos) * a.KV + kvh) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + c * 8 + 2 * t + e;
        dkp[at + col] = from_f<T>(dk[c][2 * h + e]);
        dvp[at + col] = from_f<T>(dv[c][2 * h + e]);
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

// One kernel's launch at tile ROWS (BQ of the forward and dq, BK of
// dk/dv); K is a template argument so that a source of instances
// compiles its own kernel only.
template <Kind K, typename T, int D, int ROWS>
int launch_kind(const FlashArgs& a, cudaStream_t stream) {
  // blocks of the tile's rows: over the queries, or the keys for dk/dv
  const int nb = ((K == kDkdv ? a.Sk : a.Sq) + ROWS - 1) / ROWS;
  constexpr int threads = WarpGeom<T, D, ROWS>::threads;
  if constexpr (K == kFwd) {    // Q, two K and two V buffers
    constexpr int smem = TileGeom<T, D>::bytes(ROWS + 4 * TW);
    static_assert(smem <= SMEM_MAX, "forward tile exceeds shared memory");
    return launch(flash_fwd_kernel<T, D, ROWS>, dim3(a.H, a.B, nb), threads,
                  smem, a, stream);
  } else if constexpr (K == kDq) {  // Q, dO, two K and two V buffers
    constexpr int smem = TileGeom<T, D>::bytes(2 * ROWS + 4 * TW);
    static_assert(smem <= SMEM_MAX, "dq tile exceeds shared memory");
    return launch(flash_bwd_dq_kernel<T, D, ROWS>, dim3(a.H, a.B, nb),
                  threads, smem, a, stream);
  } else {
    constexpr int smem = DkdvGeom<T, D, ROWS>::bytes;
    static_assert(smem <= SMEM_MAX, "dk/dv tile exceeds shared memory");
    return launch(flash_bwd_dkdv_kernel<T, D, ROWS>, dim3(a.KV, a.B, nb),
                  threads, smem, a, stream);
  }
}

// The 128-row tile where wide_built says it is built, else a refusal.
template <Kind K, typename T, int D>
int launch_wide(const FlashArgs& a, cudaStream_t stream) {
  if constexpr (wide_built<K, T>(D))
    return launch_kind<K, T, D, 128>(a, stream);
  else
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// Defines flash_impl::launch_<K>_<TN>, one source's instances: the 64-row
// tile at head dims 16 (the reduced configs at d_model 64), 32, 64
// (gpt3-medium), 80 (GPT-3 2.7B), 96 (phi3-vision) and 128 (qwen2.5-3b),
// the 128-row tile where wide_built says.
#define FLASH_LAUNCHER(K, TN, KIND, T)                                     \
  int flash_impl::launch_##K##_##TN(int D, int tile, const FlashArgs& a,   \
                                    cudaStream_t stream) {                 \
    if (tile == 128) {                                                     \
      if (D == 64) return launch_wide<KIND, T, 64>(a, stream);             \
      if (D == 128) return launch_wide<KIND, T, 128>(a, stream);           \
      return (int)cudaErrorInvalidValue;                                   \
    }                                                                      \
    if (tile != 64) return (int)cudaErrorInvalidValue;                     \
    switch (D) {                                                           \
      case 16: return launch_kind<KIND, T, 16, 64>(a, stream);             \
      case 32: return launch_kind<KIND, T, 32, 64>(a, stream);             \
      case 64: return launch_kind<KIND, T, 64, 64>(a, stream);             \
      case 80: return launch_kind<KIND, T, 80, 64>(a, stream);             \
      case 96: return launch_kind<KIND, T, 96, 64>(a, stream);             \
      case 128: return launch_kind<KIND, T, 128, 64>(a, stream);           \
      default: return (int)cudaErrorInvalidValue;                          \
    }                                                                      \
  }
