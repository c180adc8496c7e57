// Fused stage epilogues for Hopper (sm_90a): residual-add + RMSNorm
// forward and backward, and the tiled GEMM with a bias epilogue that
// carries the fused QKV projection and both of its backward products.
//
// Plain C interface (extern "C"), loaded with ctypes by
// kernels/build.py.  Every launcher takes the stream it must launch on,
// allocates nothing, does not synchronise, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused
// launch.  dtype codes: 0 = float32, 1 = bfloat16.  No kernel uses
// atomics: the same inputs give bitwise-equal outputs.
#include <cstdint>

#include "tensor_core.cuh"

namespace {

// Sum of one float per thread over the whole block, in a fixed order
// (warp butterfly, then warp 0 over the per-warp sums), returned to
// every thread.  blockDim.x must be a multiple of 32; `shm` holds 32.
__device__ float block_sum(float v, float* shm) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  __syncthreads();  // every thread has read the previous result
  if (lane == 0) shm[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < nwarps ? shm[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) shm[0] = t;
  }
  __syncthreads();
  return shm[0];
}

// ---------------------------------------------------------------------
// Kernel 1: residual-add + RMSNorm forward.
// Replaces repro/kernels/fused.py::_add_norm_fwd_kernel.
// Bound on the H100: device memory.  Per row it reads x, r and w and
// writes res and h (about 16 bytes per element in fp32) for a handful
// of operations per element, far below the card's ~20 fp32 operations
// per byte.  Design: one block per row, so the row's sum of squares is
// one block reduction held on chip and res never makes a round trip
// through device memory between the add and the norm; threads stride
// the row so neighbouring threads touch neighbouring addresses.  The
// second pass re-reads x and r, which are still in L2.
// ---------------------------------------------------------------------
template <typename T>
__global__ void add_rmsnorm_fwd_kernel(const T* __restrict__ x,
                                       const T* __restrict__ r,
                                       const T* __restrict__ w,
                                       T* __restrict__ res, T* __restrict__ h,
                                       int d, float eps) {
  __shared__ float shm[32];
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  const T* rr = r + row * d;
  T* resr = res + row * d;
  T* hr = h + row * d;
  float sq = 0.f;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    const T s = from_f<T>(to_f(xr[j]) + to_f(rr[j]));  // res in the input dtype
    resr[j] = s;
    const float s32 = to_f(s);
    sq += s32 * s32;
  }
  const float var = block_sum(sq, shm) / (float)d;
  const float rs = 1.f / sqrtf(var + eps);
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    const float s32 = to_f(from_f<T>(to_f(xr[j]) + to_f(rr[j])));
    const T n = from_f<T>(s32 * rs);  // the reference's rounding point
    hr[j] = from_f<T>(to_f(n) * to_f(w[j]));
  }
}

// ---------------------------------------------------------------------
// Kernel 2: residual-add + RMSNorm backward.
// Replaces repro/kernels/fused.py::_add_norm_bwd_kernel.
// Bound on the H100: device memory.  Per element it reads res, gres and
// gh and writes dres (16 bytes in fp32) for about a dozen operations.
// Design: one pass over device memory, each row held in registers.  A
// row belongs to G warps, G = d / 256 rounded up (4 at d 1024), each
// thread holding 8 of its elements, or where that takes more than 16
// warps (d > 4096), G = d / 512 rounded up at 16 elements a thread
// (where single-element copies cannot hold them, the looped variant):
// CH chunks of E (16-byte loads, E = 16 / sizeof(T), where the width
// and the addresses allow it, else E = 1) of res, gh and gres, each
// read once and all loaded together, so a row waits on device memory
// once.
// Few elements a thread make many short rows in flight at few
// registers: that beat a warp a row holding 32 elements a thread (168
// registers, three 4-warp blocks an SM) at the flash path's shape
// (PERF.md §6; tools/norm_sweep.py times other partitions).  The row's two sums, sum res^2 and sum
// (gh.w).res, come from the same registers and are reduced together:
// warp shuffles, then a shared exchange between the row's G warps (one
// barrier).  dres is formed from the registers.  A block runs R rows
// side by side (R.G warps, R = 4 / G where G < 4) and walks its
// `rows_per_block` rows in rounds of R; w is read once per block into
// shared memory.  The weight gradient gh.n sums in fp32 registers over
// each thread's rows (a column of a row slot belongs to one thread),
// the block's R slots are folded through shared memory in slot order,
// and the block writes its partial row once; add_rmsnorm_bwd_dw_kernel
// then sums the partial rows per column in a fixed order.  No atomics:
// the same inputs give the same bits.  Rows too wide for 16 warps'
// registers (d > 8192) take the looped variant (LOOPED): one block of
// G warps a row, the row read twice in strides of the block, the
// block's partial row summed in device memory, each of its columns by
// one thread.
// kernels/fused.py::norm_bwd_config picks E, CH, G, R and the rows of a
// block from (M, d), the dtype and the addresses.
// ---------------------------------------------------------------------
constexpr int kNormMaxWarps = 16;  // warps of a block (R.G) at most
constexpr int kNormElems = 16;     // elements of a row a thread holds at most

struct NormBwdArgs {
  const void* res;
  const void* w;
  const void* gres;
  const void* gh;
  void* dres;
  float* partial;              // [blocks, d] fp32: a block's dw partial row
  int M, d, rows_per_block, warps_per_row;
  float eps;
};

// E elements at p (16-byte aligned when E > 1) to fp32, and back
// (rounded to nearest even for bf16).
template <typename T, int E>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[E]) {
  static_assert(E == 1 || E * sizeof(T) == 16, "one element or 16 bytes");
  if constexpr (E == 1) {
    v[0] = to_f(*p);
  } else if constexpr (sizeof(T) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // element 2i in the low half
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
}

template <typename T, int E>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[E]) {
  if constexpr (E == 1) {
    *p = from_f<T>(v[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      u[i] = (uint32_t)__bfloat16_as_ushort(from_f<T>(v[2 * i])) |
             ((uint32_t)__bfloat16_as_ushort(from_f<T>(v[2 * i + 1])) << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  }
}

// The row sums (a, b) over the G warps of the calling thread's row, in a
// fixed order (warp butterfly, then the row's warps in order), returned
// to every thread of the row.  Every thread of the block calls it once a
// round: for G > 1 it holds one barrier, and `xch` alternates between
// two halves by round, so a round's writes never meet the previous
// round's reads.
__device__ __forceinline__ float2 row_sums(float a, float b, int G,
                                           int round,
                                           float (*xch)[kNormMaxWarps][2]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if (G == 1) return make_float2(a, b);
  const int warp = threadIdx.x >> 5, first = warp - warp % G;
  float(*x)[2] = xch[round & 1];
  if ((threadIdx.x & 31) == 0) x[warp][0] = a, x[warp][1] = b;
  __syncthreads();
  a = x[first][0], b = x[first][1];
  for (int g = 1; g < G; ++g) a += x[first + g][0], b += x[first + g][1];
  return make_float2(a, b);
}

// E fp32 values at p in shared memory (16-byte aligned when E > 1).
template <int E>
__device__ __forceinline__ void load_shared(const float* p, float (&v)[E]) {
#pragma unroll
  for (int i = 0; i < E; i += 4) {
    if constexpr (E == 1) {
      v[0] = p[0];
    } else {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x, v[i + 1] = q.y, v[i + 2] = q.z, v[i + 3] = q.w;
    }
  }
}

// The register-resident rows: thread t of a row slot holds the vectors
// v = k.(32 G) + t, k < CH, of res, gh and gres of each of its rows, all
// loaded before the row's reduction, so a round waits on device memory
// once.  w sits in shared memory as fp32 (`wsh`, d floats), which then
// holds the fold of the slots' dw sums.
template <typename T, int E, int CH>
__device__ __forceinline__ void norm_bwd_resident(
    const NormBwdArgs& p, float (*xch)[kNormMaxWarps][2], float* wsh) {
  const T* res = static_cast<const T*>(p.res);
  const T* gh = static_cast<const T*>(p.gh);
  const T* gres = static_cast<const T*>(p.gres);
  T* dres = static_cast<T*>(p.dres);
  const int d = p.d, tpr = 32 * p.warps_per_row, nvec = d / E;
  const int slot = threadIdx.x / tpr, t = threadIdx.x - slot * tpr;
  const int R = blockDim.x / tpr;
  const int row0 = blockIdx.x * p.rows_per_block;
  const int row1 = min(row0 + p.rows_per_block, p.M);
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    float wv[E];
    load_vec<T, E>(static_cast<const T*>(p.w) + v * E, wv);
#pragma unroll
    for (int e = 0; e < E; ++e) wsh[v * E + e] = wv[e];
  }
  __syncthreads();
  float dw[CH][E];
#pragma unroll
  for (int k = 0; k < CH; ++k) {
#pragma unroll
    for (int e = 0; e < E; ++e) dw[k][e] = 0.f;
  }
  for (int round = 0; row0 + round * R < row1; ++round) {  // block-uniform
    const int row = row0 + round * R + slot;
    const bool live = row < row1;
    const long long off = (long long)row * d;
    float s[CH][E], g[CH][E], gr[CH][E];
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int v = k * tpr + t;
      if (live && v < nvec) {
        load_vec<T, E>(res + off + v * E, s[k]);
        load_vec<T, E>(gh + off + v * E, g[k]);
        load_vec<T, E>(gres + off + v * E, gr[k]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) s[k][e] = g[k][e] = gr[k][e] = 0.f;
      }
    }
    float sq = 0.f, dot = 0.f;
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int v = k * tpr + t;
      float wv[E];
      load_shared<E>(wsh + min(v, nvec - 1) * E, wv);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        sq += s[k][e] * s[k][e];
        dot += g[k][e] * wv[e] * s[k][e];
      }
    }
    const float2 sums = row_sums(sq, dot, p.warps_per_row, round, xch);
    if (!live) continue;
    const float var = sums.x / (float)d;
    const float rs = 1.f / sqrtf(var + p.eps);
    const float proj = sums.y / ((float)d * (var + p.eps));
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int v = k * tpr + t;
      if (v >= nvec) continue;
      float wv[E], out[E];
      load_shared<E>(wsh + v * E, wv);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float n = to_f(from_f<T>(s[k][e] * rs));  // the forward's rounded n
        dw[k][e] += g[k][e] * n;
        out[e] = rs * (g[k][e] * wv[e] - s[k][e] * proj) + gr[k][e];
      }
      store_vec<T, E>(dres + off + v * E, out);
    }
  }
  // The block's partial row: its R slots' sums added in slot order, in
  // wsh once every slot is done with w.
  float* part = p.partial + (long long)blockIdx.x * d;
  if (R > 1) __syncthreads();
  for (int q = 0; q < R; ++q) {
    if (slot == q) {
#pragma unroll
      for (int k = 0; k < CH; ++k) {
        const int v = k * tpr + t;
        if (v >= nvec) continue;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int col = v * E + e;
          const float acc = q == 0 ? dw[k][e] : wsh[col] + dw[k][e];
          if (q == R - 1) part[col] = acc; else wsh[col] = acc;
        }
      }
    }
    if (q < R - 1) __syncthreads();
  }
}

// The looped variant for rows wider than the registers hold: one row
// slot (R = 1) of G warps, the row read in strides of the block, twice.
template <typename T, int E>
__device__ __forceinline__ void norm_bwd_looped(
    const NormBwdArgs& p, float (*xch)[kNormMaxWarps][2]) {
  const T* res = static_cast<const T*>(p.res);
  const T* w = static_cast<const T*>(p.w);
  const T* gh = static_cast<const T*>(p.gh);
  const T* gres = static_cast<const T*>(p.gres);
  T* dres = static_cast<T*>(p.dres);
  const int d = p.d, tpr = blockDim.x, nvec = d / E;
  const int row0 = blockIdx.x * p.rows_per_block;
  const int row1 = min(row0 + p.rows_per_block, p.M);
  float* part = p.partial + (long long)blockIdx.x * d;
  for (int v = threadIdx.x; v < nvec; v += tpr) {
#pragma unroll
    for (int e = 0; e < E; ++e) part[v * E + e] = 0.f;
  }
  for (int row = row0; row < row1; ++row) {
    const long long off = (long long)row * d;
    float sq = 0.f, dot = 0.f;
    for (int v = threadIdx.x; v < nvec; v += tpr) {
      float s[E], g[E], wv[E];
      load_vec<T, E>(res + off + v * E, s);
      load_vec<T, E>(gh + off + v * E, g);
      load_vec<T, E>(w + v * E, wv);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        sq += s[e] * s[e];
        dot += g[e] * wv[e] * s[e];
      }
    }
    const float2 sums = row_sums(sq, dot, p.warps_per_row, row - row0, xch);
    const float var = sums.x / (float)d;
    const float rs = 1.f / sqrtf(var + p.eps);
    const float proj = sums.y / ((float)d * (var + p.eps));
    for (int v = threadIdx.x; v < nvec; v += tpr) {
      float s[E], g[E], wv[E], out[E];
      load_vec<T, E>(res + off + v * E, s);
      load_vec<T, E>(gh + off + v * E, g);
      load_vec<T, E>(w + v * E, wv);
      load_vec<T, E>(gres + off + v * E, out);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        part[v * E + e] += g[e] * to_f(from_f<T>(s[e] * rs));
        out[e] += rs * (g[e] * wv[e] - s[e] * proj);
      }
      store_vec<T, E>(dres + off + v * E, out);
    }
  }
}

template <typename T, int E, int CH, bool LOOPED>
__global__ void __launch_bounds__(32 * kNormMaxWarps)
add_rmsnorm_bwd_kernel(NormBwdArgs p) {
  __shared__ float xch[2][kNormMaxWarps][2];
  extern __shared__ float4 wsh[];   // d floats (resident variant)
  if constexpr (LOOPED)
    norm_bwd_looped<T, E>(p, xch);
  else
    norm_bwd_resident<T, E, CH>(p, xch, reinterpret_cast<float*>(wsh));
}

// Kernel 2b: dw[j] = the sum of column j over the P partial rows, in a
// fixed order, cast to w's dtype.  A block takes 32 columns; each of its
// 32 warps sums a contiguous 32nd of the partial rows in row order (so
// each warp has its few loads in flight at once), and warp 0 adds the
// 32 warp sums in warp order.
template <typename T>
__global__ void __launch_bounds__(1024)
add_rmsnorm_bwd_dw_kernel(const float* __restrict__ partial,
                          T* __restrict__ dw, int P, int d) {
  __shared__ float sums[32][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  const int per = (P + 31) / 32, p0 = warp * per, p1 = min(P, p0 + per);
  float s = 0.f;
  if (col < d) {
#pragma unroll 8
    for (int q = p0; q < p1; ++q) s += partial[(long long)q * d + col];
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < d) {
    float t = sums[0][lane];
    for (int i = 1; i < 32; ++i) t += sums[i][lane];
    dw[col] = from_f<T>(t);
  }
}

// ---------------------------------------------------------------------
// Kernel 3: GEMM with a bias epilogue, C = A.B + bias, fp32 accumulate.
// Replaces repro/kernels/fused.py::_matmul_kernel (the fused QKV
// forward over the concatenated weight, and the custom backward's
// dx = g.W^T and dW = x^T.g).
// Bound on the H100: operations.  At the flash path's shapes (M 4096,
// K and N 1024 or 3072; the dW product M 1024, K 4096) each element is
// read once for hundreds of multiply-adds: 2MNK = 25.8 GFLOP, 0.385 ms
// at the CUDA cores' 67 TFLOP/s, a rate cuBLAS's fp32 product already
// reaches 75 % of.  Design: the tensor cores (tensor_core.cuh).  fp32
// inputs take the 3xTF32 split, three m16n8k8 TF32 products per step
// (0.156 ms at 495 TFLOP/s), each exact, the dropped small.small term
// below 2^-22 of the product.  The mma accumulator truncates its
// additions (tools/mma_rounding.py), so after every BK = 32 slice of K
// it is added into a second, ordinary fp32 register sum and zeroed (the
// promotion): in a CPU emulation of truncating accumulation over K =
// 4096 the fp32 tolerance fails without it and holds at 3 % of it with
// it (tests/test_torch_gemm_tiles.py).  bf16 inputs take one m16n8k16
// product per step, with the same promotion.
// A block computes a 128 x 128 tile with 8 warps (64 x 32 each) or a
// 64 x 64 tile with 4 warps (32 x 32 each).  A and B stream through a
// 4-stage ring of BK-slices in dynamic shared memory, filled by
// 16-byte cp.async copies that stay in flight while earlier slices
// compute (4-byte copies, or plain loads for bf16, where a row is not
// 16-byte aligned, as at the ragged shapes; bf16 is built with those
// plain loads alone, see below).  A shared tile keeps the
// global stride-1 dimension, so the four layouts (A K- or M-major, B
// K- or N-major; the forward, dx and dW use three) are template
// instances whose padded pitches put every fragment read on 32 banks;
// no operand is transposed in memory.  A split over K (grid z) writes
// fp32 partials that a second kernel sums in a fixed order with the
// bias: no atomics, bitwise-equal reruns.  kernels/fused.py::gemm_config
// picks the tile, the split and the copy width.
// Why mma.sync here: wgmma takes .tf32 operands only K-major in shared
// memory, and the forward's W and the dW product's x are MN-major, so an
// fp32 wgmma design would transpose them in shared memory first.  bf16
// operands wgmma takes in either major order, so every bf16 call whose
// rows allow 16-byte copies runs gemm_wgmma.cu's warp-specialised
// wgmma + TMA instance (TMA reads exactly such rows); this kernel keeps
// fp32 and the bf16 calls with element copies (rows not 16-byte
// aligned), and its bf16 entry refuses 16-byte copies.
// ---------------------------------------------------------------------
constexpr int GBK = 32;        // K slice per ring stage = promotion interval
constexpr int GSTAGES = 4;     // ring depth

struct GemmArgs {
  const void* A;
  const void* B;
  const void* bias;            // null: no bias
  void* C;                     // [M, N] contiguous
  float* ws;                   // [splits, M, N] fp32 partials when split
  int M, N, K, kchunk;         // split z sums k in [z*kchunk, (z+1)*kchunk)
  long long sam, sak, sbk, sbn;
};

// Shared-memory geometry of one operand's ring stage.  kmaj: the
// stride-1 dim is K (A row-major, B column-major); the stage then holds
// `mn` rows of GBK elements, else GBK rows of `mn`.  The pad keeps rows
// 16-byte aligned and puts the 32 lanes of a fragment read on 32 banks.
template <typename T, bool kmaj, int mn>
struct TileGeom {
  static constexpr int rows = kmaj ? mn : GBK;
  static constexpr int cols = kmaj ? GBK : mn;
  static constexpr int pitch = kmaj ? GBK + (sizeof(T) == 4 ? 4 : 8) : mn + 8;
  static constexpr int size = rows * pitch;      // elements
};

// Element (r, k) of an operand stage (r indexes M for A, N for B).
template <typename T, bool kmaj, int mn>
__device__ __forceinline__ T tile_at(const T* s, int r, int k) {
  using G = TileGeom<T, kmaj, mn>;
  return kmaj ? s[r * G::pitch + k] : s[k * G::pitch + r];
}

// Elements (r, k) and (r, k + 1), k even, as one bf16x2 register.
template <bool kmaj, int mn>
__device__ __forceinline__ uint32_t tile_pair(const __nv_bfloat16* s, int r,
                                              int k) {
  using G = TileGeom<__nv_bfloat16, kmaj, mn>;
  if constexpr (kmaj)
    return *reinterpret_cast<const uint32_t*>(s + r * G::pitch + k);
  else
    return pack_bf16(s[k * G::pitch + r], s[(k + 1) * G::pitch + r]);
}

// Copy rows [r0, r0 + mn) x k in [k0, k0 + GBK) of an operand X, element
// (r, k) at X[r * s_r + k * s_k], into one ring stage; elements with
// r >= R or k >= kend read as 0.  VEC: 16-byte cp.async along the
// stride-1 dim (which must be 1, with the other stride and X 16-byte
// aligned); else one element per copy through both strides.
template <typename T, bool kmaj, int mn, bool VEC, int NT>
__device__ __forceinline__ void load_tile(T* dst, const T* X, long long s_r,
                                          long long s_k, int r0, int R,
                                          int k0, int kend) {
  using G = TileGeom<T, kmaj, mn>;
  if constexpr (VEC) {
    constexpr int W = 16 / (int)sizeof(T);
    constexpr int CPR = G::cols / W;             // 16-byte chunks per row
    static_assert(G::rows * CPR % NT == 0, "chunks must split evenly");
#pragma unroll
    for (int i = 0; i < G::rows * CPR / NT; ++i) {
      const int c = threadIdx.x + i * NT;
      const int row = c / CPR, col = (c % CPR) * W;
      int r, k, valid;
      if constexpr (kmaj) {
        r = r0 + row;
        k = k0 + col;
        valid = r < R ? min(max(kend - k, 0), W) : 0;
      } else {
        k = k0 + row;
        r = r0 + col;
        valid = k < kend ? min(max(R - r, 0), W) : 0;
      }
      const T* src = valid > 0 ? X + r * s_r + k * s_k : X;
      cp_async16(dst + row * G::pitch + col, src, valid * (int)sizeof(T));
    }
  } else {
    static_assert(G::rows * G::cols % NT == 0, "elements must split evenly");
#pragma unroll 4
    for (int i = 0; i < G::rows * G::cols / NT; ++i) {
      const int e = threadIdx.x + i * NT;
      const int row = e / G::cols, col = e % G::cols;
      const int r = r0 + (kmaj ? row : col), k = k0 + (kmaj ? col : row);
      const bool ok = r < R && k < kend;
      const T* src = ok ? X + r * s_r + k * s_k : X;
      if constexpr (sizeof(T) == 4)
        cp_async4(dst + row * G::pitch + col, src, ok ? 4 : 0);
      else
        dst[row * G::pitch + col] = ok ? *src : from_f<T>(0.f);
    }
  }
}

// AK: A is K-major (row-major); BKM: B is K-major (column-major).
// Grid (N tiles, M tiles, K splits); WM x WN warps.
template <typename T, int BM, int BN, int WM, int WN, bool AK, bool BKM,
          bool VEC>
__global__ void __launch_bounds__(WM * WN * 32, 1)
gemm_bias_kernel(const GemmArgs p) {
  constexpr int NT = WM * WN * 32;
  constexpr int MI = BM / WM / 16, NI = BN / WN / 8;   // m16 / n8 per warp
  using GA = TileGeom<T, AK, BM>;
  using GB = TileGeom<T, BKM, BN>;
  extern __shared__ float4 smem4[];
  T* As = reinterpret_cast<T*>(smem4);                 // [GSTAGES][GA::size]
  T* Bs = As + GSTAGES * GA::size;                     // [GSTAGES][GB::size]
  const T* A = static_cast<const T*>(p.A);
  const T* B = static_cast<const T*>(p.B);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / WN) * (BM / WM), wn = (warp % WN) * (BN / WN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * p.kchunk;
  const int kend = min(p.K, kbeg + p.kchunk);
  const int KT = kend > kbeg ? (kend - kbeg + GBK - 1) / GBK : 0;

  auto load = [&](int kt) {
    const int st = kt % GSTAGES, k0 = kbeg + kt * GBK;
    load_tile<T, AK, BM, VEC, NT>(As + st * GA::size, A, p.sam, p.sak, m0,
                                  p.M, k0, kend);
    load_tile<T, BKM, BN, VEC, NT>(Bs + st * GB::size, B, p.sbn, p.sbk, n0,
                                   p.N, k0, kend);
  };

  float acc[MI][NI][4];        // the promoted sum (ordinary fp32 adds)
  float part[MI][NI][4];       // the tensor cores' sum over one slice
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < GSTAGES - 1; ++s) {
    if (s < KT) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<GSTAGES - 2>();   // slice kt has landed (this thread's copies)
    __syncthreads();                // ... every thread's; slice kt-1's stage is free
    if (kt + GSTAGES - 1 < KT) load(kt + GSTAGES - 1);
    cp_async_commit();
    const T* as = As + (kt % GSTAGES) * GA::size;
    const T* bs = Bs + (kt % GSTAGES) * GB::size;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int kk = 0; kk < GBK; kk += 8) {
        uint32_t bb[NI][2], bsm[NI][2];
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int n = wn + j * 8 + g;
          split_tf32(tile_at<T, BKM, BN>(bs, n, kk + t), bb[j][0], bsm[j][0]);
          split_tf32(tile_at<T, BKM, BN>(bs, n, kk + t + 4), bb[j][1],
                     bsm[j][1]);
        }
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const int r = wm + i * 16 + g;
          uint32_t ab[4], asm_[4];
          split_tf32(tile_at<T, AK, BM>(as, r, kk + t), ab[0], asm_[0]);
          split_tf32(tile_at<T, AK, BM>(as, r + 8, kk + t), ab[1], asm_[1]);
          split_tf32(tile_at<T, AK, BM>(as, r, kk + t + 4), ab[2], asm_[2]);
          split_tf32(tile_at<T, AK, BM>(as, r + 8, kk + t + 4), ab[3],
                     asm_[3]);
          mma_3xtf32<NI>(part[i], ab, asm_, bb, bsm);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < GBK; kk += 16) {
        uint32_t bf[NI][2];
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int n = wn + j * 8 + g;
          bf[j][0] = tile_pair<BKM, BN>(bs, n, kk + 2 * t);
          bf[j][1] = tile_pair<BKM, BN>(bs, n, kk + 2 * t + 8);
        }
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const int r = wm + i * 16 + g;
          const uint32_t af[4] = {tile_pair<AK, BM>(as, r, kk + 2 * t),
                                  tile_pair<AK, BM>(as, r + 8, kk + 2 * t),
                                  tile_pair<AK, BM>(as, r, kk + 2 * t + 8),
                                  tile_pair<AK, BM>(as, r + 8, kk + 2 * t + 8)};
#pragma unroll
          for (int j = 0; j < NI; ++j) mma_bf16(part[i][j], af, bf[j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  cp_async_wait<0>();

  // Epilogue: acc[i][j][2h + e] is C(wm + 16i + g + 8h, wn + 8j + 2t + e).
  const T* bias = static_cast<const T*>(p.bias);
  T* C = static_cast<T*>(p.C);
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + i * 16 + g + 8 * h;
      if (m >= p.M) continue;
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + j * 8 + 2 * t + e;
          if (n >= p.N) continue;
          float v = acc[i][j][2 * h + e];
          const long long off = (long long)m * p.N + n;
          if (split) {
            p.ws[(long long)blockIdx.z * p.M * p.N + off] = v;
          } else {
            if (bias != nullptr) v += to_f(bias[n]);
            C[off] = from_f<T>(v);
          }
        }
    }
}

// Second pass of a split over K: C = sum_z ws[z] + bias, z in order.
template <typename T>
__global__ void __launch_bounds__(256)
gemm_bias_kernel_reduce(const GemmArgs p, int splits) {
  const long long mn = (long long)p.M * p.N;
  const T* bias = static_cast<const T*>(p.bias);
  T* C = static_cast<T*>(p.C);
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < mn;
       i += (long long)gridDim.x * 256) {
    float v = 0.f;
    for (int z = 0; z < splits; ++z) v += p.ws[z * mn + i];
    if (bias != nullptr) v += to_f(bias[i % p.N]);
    C[i] = from_f<T>(v);
  }
}

template <typename T, int BM, int BN, int WM, int WN, bool AK, bool BKM,
          bool VEC>
int launch_gemm(const GemmArgs& p, int splits, cudaStream_t s) {
  constexpr int smem = GSTAGES *
                       (TileGeom<T, AK, BM>::size + TileGeom<T, BKM, BN>::size) *
                       (int)sizeof(T);
  auto kernel = gemm_bias_kernel<T, BM, BN, WM, WN, AK, BKM, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, splits);
  kernel<<<grid, WM * WN * 32, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long want = ((long long)p.M * p.N + 255) / 256;
  const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);
  gemm_bias_kernel_reduce<T><<<blocks, 256, 0, s>>>(p, splits);
  return (int)cudaGetLastError();
}

// The built tiles: 64 x 64 for every built type and copy width, 128 x 128
// for fp32 with 16-byte copies (kernels/fused.py::MMA_TILES).
template <typename T, bool AK, bool BKM, bool VEC>
int gemm_tile(int bm, int bn, const GemmArgs& p, int splits,
              cudaStream_t s) {
  if (bm == 64 && bn == 64)
    return launch_gemm<T, 64, 64, 2, 2, AK, BKM, VEC>(p, splits, s);
  if constexpr (VEC && sizeof(T) == 4) {
    if (bm == 128 && bn == 128)
      return launch_gemm<T, 128, 128, 2, 4, AK, BKM, VEC>(p, splits, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, bool VEC>
int gemm_layout(bool ak, bool bkm, int bm, int bn, const GemmArgs& p,
                int splits, cudaStream_t s) {
  if (ak)
    return bkm ? gemm_tile<T, true, true, VEC>(bm, bn, p, splits, s)
               : gemm_tile<T, true, false, VEC>(bm, bn, p, splits, s);
  return bkm ? gemm_tile<T, false, true, VEC>(bm, bn, p, splits, s)
             : gemm_tile<T, false, false, VEC>(bm, bn, p, splits, s);
}

// 16-byte copies need the stride-1 dim to have stride 1, the other
// stride a multiple of 16 bytes and the base 16-byte aligned.
bool rows_aligned(const void* ptr, long long unit, long long lead, int size) {
  return unit == 1 && lead % (16 / size) == 0 &&
         reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

int norm_threads(int d) {
  // enough threads to cover a row in a few strides, a multiple of 32
  int t = 32;
  while (t < d && t < 256) t *= 2;
  return t;
}

// One backward norm call: the row kernel, then the dw kernel over its
// partial rows; the first error.
template <typename T, int E, int CH, bool LOOPED>
int launch_norm_bwd(const NormBwdArgs& a, void* dw, int R, cudaStream_t s) {
  const int blocks = (a.M + a.rows_per_block - 1) / a.rows_per_block;
  const size_t wsh = LOOPED ? 0 : (size_t)a.d * sizeof(float);
  add_rmsnorm_bwd_kernel<T, E, CH, LOOPED>
      <<<blocks, R * a.warps_per_row * 32, wsh, s>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  add_rmsnorm_bwd_dw_kernel<T><<<(a.d + 31) / 32, 1024, 0, s>>>(
      a.partial, (T*)dw, blocks, a.d);
  return (int)cudaGetLastError();
}

// The register-resident instances with CH chunks of E elements, CH =
// kNormElems / E (16-byte chunks) or kNormElems / 2 (single elements,
// each with an address of its own: 16 of them spill) down to 1 by
// halves.
template <typename T, int E, int CH = E == 1 ? kNormElems / 2 : kNormElems / E>
int norm_bwd_chunks(const NormBwdArgs& a, void* dw, int R, int chunks,
                    cudaStream_t s) {
  if (chunks == CH) return launch_norm_bwd<T, E, CH, false>(a, dw, R, s);
  if constexpr (CH > 1)
    return norm_bwd_chunks<T, E, CH / 2>(a, dw, R, chunks, s);
  return (int)cudaErrorInvalidValue;
}

// The built instances: E = 16 / sizeof(T) (vec) or 1, CH chunks of E up
// to kNormElems elements a thread; chunks = 0 is the looped variant (R =
// 1).
template <typename T>
int norm_bwd(const NormBwdArgs& a, void* dw, int R, int chunks, int vec,
             cudaStream_t s) {
  constexpr int EV = 16 / sizeof(T);
  const int G = a.warps_per_row;
  if (a.M <= 0 || a.d <= 0 || a.rows_per_block <= 0 || G <= 0 || R <= 0 ||
      R * G > kNormMaxWarps)
    return (int)cudaErrorInvalidValue;
  if (vec && (a.d % EV != 0 ||
              !rows_aligned(a.res, 1, a.d, sizeof(T)) ||
              !rows_aligned(a.w, 1, 0, sizeof(T)) ||
              !rows_aligned(a.gres, 1, a.d, sizeof(T)) ||
              !rows_aligned(a.gh, 1, a.d, sizeof(T)) ||
              !rows_aligned(a.dres, 1, a.d, sizeof(T))))
    return (int)cudaErrorInvalidValue;
  if (chunks == 0) {
    if (R != 1) return (int)cudaErrorInvalidValue;
    return vec ? launch_norm_bwd<T, EV, 1, true>(a, dw, R, s)
               : launch_norm_bwd<T, 1, 1, true>(a, dw, R, s);
  }
  if (a.d > 32 * G * chunks * (vec ? EV : 1)) return (int)cudaErrorInvalidValue;
  return vec ? norm_bwd_chunks<T, EV>(a, dw, R, chunks, s)
             : norm_bwd_chunks<T, 1>(a, dw, R, chunks, s);
}

}  // namespace

extern "C" {

int add_rmsnorm_fwd(const void* x, const void* r, const void* w, void* res,
                    void* h, int M, int d, float eps, int dtype,
                    void* stream) {
  if (M <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = norm_threads(d);
  if (dtype == kF32) {
    add_rmsnorm_fwd_kernel<float><<<M, threads, 0, s>>>(
        (const float*)x, (const float*)r, (const float*)w, (float*)res,
        (float*)h, d, eps);
  } else if (dtype == kBF16) {
    add_rmsnorm_fwd_kernel<__nv_bfloat16><<<M, threads, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)r,
        (const __nv_bfloat16*)w, (__nv_bfloat16*)res, (__nv_bfloat16*)h, d,
        eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int add_rmsnorm_bwd(const void* res, const void* w, const void* gres,
                    const void* gh, void* dres, void* dw, void* partial, int M,
                    int d, int rows_per_block, int rows_per_round,
                    int warps_per_row, int chunks, int vec, float eps,
                    int dtype, void* stream) {
  NormBwdArgs a{res, w, gres, gh, dres, (float*)partial, M, d,
                rows_per_block, warps_per_row, eps};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32) return norm_bwd<float>(a, dw, rows_per_round, chunks, vec, s);
  if (dtype == kBF16)
    return norm_bwd<__nv_bfloat16>(a, dw, rows_per_round, chunks, vec, s);
  return (int)cudaErrorInvalidValue;
}

int gemm_bias(const void* A, const void* B, const void* bias, void* C,
              void* ws, int M, int N, int K, int sam, int sak, int sbk,
              int sbn, int bm, int bn, int splits, int kchunk, int a_kmajor,
              int b_kmajor, int vec, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits <= 0 || kchunk <= 0 ||
      kchunk % GBK != 0 || (long long)kchunk * splits < K ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const int size = dtype == kF32 ? 4 : 2;
  const bool a_ok = a_kmajor ? rows_aligned(A, sak, sam, size)
                            : rows_aligned(A, sam, sak, size);
  const bool b_ok = b_kmajor ? rows_aligned(B, sbk, sbn, size)
                            : rows_aligned(B, sbn, sbk, size);
  if (vec && !(a_ok && b_ok)) return (int)cudaErrorMisalignedAddress;
  GemmArgs p = {A, B, bias, C, (float*)ws, M, N, K, kchunk,
                sam, sak, sbk, sbn};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return vec ? gemm_layout<float, true>(a_kmajor, b_kmajor, bm, bn, p,
                                          splits, s)
               : gemm_layout<float, false>(a_kmajor, b_kmajor, bm, bn, p,
                                           splits, s);
  // bf16 with 16-byte copies is gemm_bias_wgmma's (gemm_wgmma.cu)
  if (dtype == kBF16 && !vec)
    return gemm_layout<__nv_bfloat16, false>(a_kmajor, b_kmajor, bm, bn, p,
                                             splits, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
