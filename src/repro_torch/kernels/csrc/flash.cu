// Causal GQA flash attention for Hopper (sm_90a): the forward, the dq
// backward, and one fused dk/dv backward.
//
// Layouts are the JAX package's public ones: q, o, g (= dO) and dq are
// [B, S, H, D]; k, v, dk and dv are [B, S, KV, D]; lse and delta are
// [B, H, S] fp32.  q, k, v and g are read in place through their
// (batch, seq, head) strides, with the head dim dense: no transpose or
// pad copies.  Query head h reads kv head h / G, G = H / KV.  Outputs are
// written contiguous.  Scores are scaled by 1/sqrt(D) and every product
// is accumulated in fp32; bf16 inputs are converted when a tile is
// loaded.
//
// Bound on the H100: operations.  At the main path's shape (B 2, S 2048,
// H 16, D 64) a 64x64 score tile costs 2*64*64*64 flops per product for
// 2*64*64*4 bytes of tile, and the causal mask halves the work, so the
// tiles come from L2 and the kernels are limited by the fp32 rate.
// Design (simple first version): 64-row q and kv tiles in shared memory,
// 256 threads as a 16x16 grid, each thread holding a 4x4 patch of the
// score tile and 4 rows x D/16 columns of its fp32 accumulators in
// registers.  Operands of products that reduce over D are stored
// transposed ([D][64], padded), so a thread reads its 4 rows and 4
// columns as two float4 loads per step.  CUDA cores only: wgmma, TMA and
// mma.sync are later work.
//
// Plain C interface (extern "C"), loaded with ctypes by kernels/build.py.
// Every launcher takes the stream it must launch on, allocates nothing,
// does not synchronise, and returns cudaGetLastError() (or the error of
// raising the kernel's shared-memory limit).  dtype codes: 0 = float32,
// 1 = bfloat16.  No kernel uses atomics and every loop runs in a fixed
// order: the same inputs give bitwise-equal outputs.
#include "common.cuh"

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
template <int D> constexpr int dkdv_smem_bytes() {
  return (4 * D * TP + 2 * BQ * TP + 2 * BQ) * (int)sizeof(float);
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
// Grid (kv block, KV head, batch).  The block loops, in a fixed order,
// over the G query heads of its kv head and, for each, over the q blocks
// of the reference's _q_bounds; it accumulates dk = sum ds^T.q and
// dv = sum p^T.dO in fp32 registers and writes both once, at kv-head
// resolution: no [B, H, S, D] per-query-head buffers, no reshape-sum, no
// atomics (one writer per output element).
// ---------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_kernel(const FlashArgs a) {
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);   // [D][TP]
  float* Vt = Kt + D * TP;                       // [D][TP]
  float* Qt = Vt + D * TP;                       // [D][TP]
  float* Gt = Qt + D * TP;                       // [D][TP]
  float* Pq = Gt + D * TP;                       // [BQ][TP]: p, q-major
  float* Dq = Pq + BQ * TP;                      // [BQ][TP]: ds, q-major
  float* lse = Dq + BQ * TP;                     // [BQ]
  float* delta = lse + BQ;                       // [BQ]
  constexpr int NC = D / 16;
  const int ik = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int S = a.S, k0 = ik * BK;
  const int nq = (S + BQ - 1) / BQ;
  const int qlo = ik;
  const int qhi = a.window > 0 ? min((k0 + BK + a.window - 2) / BQ + 1, nq) : nq;
  load_t<T, D>(Kt, static_cast<const T*>(a.k) + b * a.ks.b + kvh * a.ks.h,
               a.ks.s, k0, S);
  load_t<T, D>(Vt, static_cast<const T*>(a.v) + b * a.vs.b + kvh * a.vs.h,
               a.vs.s, k0, S);
  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const T* q = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
    const T* g = static_cast<const T*>(a.g) + b * a.gs.b + h * a.gs.h;
    const long long row_base = ((long long)b * a.H + h) * S;
    for (int iq = qlo; iq < qhi; ++iq) {
      const int q0 = iq * BQ;
      __syncthreads();            // the previous q block is done with the tiles
      load_t<T, D>(Qt, q, a.qs.s, q0, S);
      load_t<T, D>(Gt, g, a.gs.s, q0, S);
      if (threadIdx.x < BQ) {
        const int qpos = q0 + threadIdx.x;
        lse[threadIdx.x] = qpos < S ? a.lse_in[row_base + qpos] : 0.f;
        delta[threadIdx.x] = qpos < S ? a.delta[row_base + qpos] : 0.f;
      }
      __syncthreads();
      // the transposed score tile: rows are kv positions, columns q positions
      float s[4][4], dp[4][4];
      dot_t<D>(Kt, Qt, s, ty, tx);
      dot_t<D>(Vt, Gt, dp, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx * 4 + j;
          const bool ok = visible(q0 + c, kpos, S, a.window);
          const float p = ok ? expf(s[i][j] * a.scale - lse[c]) : 0.f;
          s[i][j] = p;
          dp[i][j] = p * (dp[i][j] - delta[c]) * a.scale;
        }
      }
      store_patch_t(Pq, s, ty, tx);
      store_patch_t(Dq, dp, ty, tx);
      __syncthreads();
#pragma unroll 4
      for (int cc = 0; cc < BQ; ++cc) {
        const float4 p4 = *reinterpret_cast<const float4*>(Pq + cc * TP + ty * 4);
        const float4 d4 = *reinterpret_cast<const float4*>(Dq + cc * TP + ty * 4);
        const float p[4] = {p4.x, p4.y, p4.z, p4.w};
        const float ds[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float gv = Gt[(tx + 16 * c) * TP + cc];
          const float qv = Qt[(tx + 16 * c) * TP + cc];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][c] += p[i] * gv;
            dk[i][c] += ds[i] * qv;
          }
        }
      }
    }
  }
  T* dkp = static_cast<T*>(a.dk);
  T* dvp = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty * 4 + i;
    if (kpos >= S) continue;
    const long long off = (((long long)b * S + kpos) * a.KV + kvh) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dkp[off + tx + 16 * c] = from_f<T>(dk[i][c]);
      dvp[off + tx + 16 * c] = from_f<T>(dv[i][c]);
    }
  }
}

// Raise the kernel's dynamic shared-memory limit (above 48 KB a launch
// is refused without it), then launch.
template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int smem, const FlashArgs& a,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

enum Kind { kFwd, kDq, kDkdv };

template <typename T, int D>
int launch_kind(Kind kind, const FlashArgs& a, cudaStream_t stream) {
  const int nq = (a.S + BQ - 1) / BQ;
  switch (kind) {
    case kFwd:
      return launch(flash_fwd_kernel<T, D>, dim3(nq, a.H, a.B),
                    fwd_smem_bytes<D>(), a, stream);
    case kDq:
      return launch(flash_bwd_dq_kernel<T, D>, dim3(nq, a.H, a.B),
                    dq_smem_bytes<D>(), a, stream);
    default:
      return launch(flash_bwd_dkdv_kernel<T, D>, dim3(nq, a.KV, a.B),
                    dkdv_smem_bytes<D>(), a, stream);
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
  return dispatch(kDkdv, D, dtype, a, stream);
}

}  // extern "C"
