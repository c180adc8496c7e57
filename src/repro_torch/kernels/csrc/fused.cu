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
#include "common.cuh"

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
// Bound on the H100: device memory (reads res, gres, gh, writes dres:
// about 16 bytes per element in fp32).  Design: one block per
// `rows_per_block` rows; each row's two reductions (sum res^2 and
// sum dn*res) are block reductions on chip.  The weight gradient is
// summed over the block's rows into the block's OWN fp32 partial row
// (each column owned by one thread, so no atomics), and the wrapper
// sums the partials, as the reference does outside its kernel.
// ---------------------------------------------------------------------
template <typename T>
__global__ void add_rmsnorm_bwd_kernel(const T* __restrict__ res,
                                       const T* __restrict__ w,
                                       const T* __restrict__ gres,
                                       const T* __restrict__ gh,
                                       T* __restrict__ dres,
                                       float* __restrict__ dw_partial,
                                       int M, int d, int rows_per_block,
                                       float eps) {
  __shared__ float shm[32];
  float* dwp = dw_partial + (long long)blockIdx.x * d;
  const int row0 = blockIdx.x * rows_per_block;
  const int row1 = min(row0 + rows_per_block, M);
  for (int j = threadIdx.x; j < d; j += blockDim.x) dwp[j] = 0.f;
  for (int row = row0; row < row1; ++row) {
    const long long off = (long long)row * d;
    float sq = 0.f;
    for (int j = threadIdx.x; j < d; j += blockDim.x) {
      const float s = to_f(res[off + j]);
      sq += s * s;
    }
    const float var = block_sum(sq, shm) / (float)d;
    const float rs = 1.f / sqrtf(var + eps);
    float dot = 0.f;
    for (int j = threadIdx.x; j < d; j += blockDim.x) {
      const float s = to_f(res[off + j]);
      const float n = to_f(from_f<T>(s * rs));  // the forward's rounded n
      const float g = to_f(gh[off + j]);
      dwp[j] += g * n;
      dot += g * to_f(w[j]) * s;
    }
    const float proj = block_sum(dot, shm) / ((float)d * (var + eps));
    for (int j = threadIdx.x; j < d; j += blockDim.x) {
      const float s = to_f(res[off + j]);
      const float dn = to_f(gh[off + j]) * to_f(w[j]);
      dres[off + j] = from_f<T>(rs * (dn - s * proj) + to_f(gres[off + j]));
    }
  }
}

// ---------------------------------------------------------------------
// Kernel 3: tiled GEMM with a bias epilogue, C = A.B + bias.
// Replaces repro/kernels/fused.py::_matmul_kernel (the fused QKV
// forward over the concatenated weight, and the custom backward's
// dx = g.W^T and dW = x^T.g).
// Bound on the H100: operations.  At the main path's shapes (M = 1024
// rows, K = 1024 or 3072, N = 1024 or 3072) each element read is used
// hundreds of times.  Design: 64x64 output tiles per 256-thread block,
// each thread holding a 4x4 fp32 accumulator in registers; A and B
// stream through shared memory in K-steps of 16, converted to fp32 on
// load.  A and B are read through explicit strides, so the transposed
// operands of the backward need no copy; the load mapping follows
// whichever stride is 1, so the reads stay coalesced in all three
// layouts.  Ragged M, N and K are masked (K = M is small in the dW
// product).  CUDA cores, no tensor cores yet: this is the simple first
// version, and wgmma/TMA are the next step.
// ---------------------------------------------------------------------
constexpr int BM = 64, BN = 64, BK = 16, PAD = 4;

template <typename T>
__global__ void __launch_bounds__(256)
gemm_bias_kernel(const T* __restrict__ A, const T* __restrict__ B,
                 const T* __restrict__ bias, T* __restrict__ C,
                 int M, int N, int K, long long sam, long long sak,
                 long long sbk, long long sbn) {
  __shared__ float As[BK][BM + PAD];
  __shared__ float Bs[BK][BN + PAD];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: BM x BK = 1024 elements, 4 per thread.
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = tid + e * 256;
      int mm, kk;
      if (sak == 1) { kk = idx % BK; mm = idx / BK; }   // row-major A
      else          { mm = idx % BM; kk = idx / BM; }   // column-major A
      const int m = m0 + mm, k = k0 + kk;
      As[kk][mm] = (m < M && k < K) ? to_f(A[m * sam + k * sak]) : 0.f;
    }
    // B tile: BK x BN = 1024 elements, 4 per thread.
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = tid + e * 256;
      int kk, nn;
      if (sbn == 1) { nn = idx % BN; kk = idx / BN; }   // row-major B
      else          { kk = idx % BK; nn = idx / BK; }   // column-major B
      const int k = k0 + kk, n = n0 + nn;
      Bs[kk][nn] = (k < K && n < N) ? to_f(B[k * sbk + n * sbn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += to_f(bias[n]);
      C[(long long)m * N + n] = from_f<T>(v);
    }
  }
}

int norm_threads(int d) {
  // enough threads to cover a row in a few strides, a multiple of 32
  int t = 32;
  while (t < d && t < 256) t *= 2;
  return t;
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
                    const void* gh, void* dres, void* dw_partial, int M,
                    int d, int rows_per_block, float eps, int dtype,
                    void* stream) {
  if (M <= 0 || d <= 0 || rows_per_block <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (M + rows_per_block - 1) / rows_per_block;
  const int threads = norm_threads(d);
  if (dtype == kF32) {
    add_rmsnorm_bwd_kernel<float><<<blocks, threads, 0, s>>>(
        (const float*)res, (const float*)w, (const float*)gres,
        (const float*)gh, (float*)dres, (float*)dw_partial, M, d,
        rows_per_block, eps);
  } else if (dtype == kBF16) {
    add_rmsnorm_bwd_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)res, (const __nv_bfloat16*)w,
        (const __nv_bfloat16*)gres, (const __nv_bfloat16*)gh,
        (__nv_bfloat16*)dres, (float*)dw_partial, M, d, rows_per_block, eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int gemm_bias(const void* A, const void* B, const void* bias, void* C, int M,
              int N, int K, int sam, int sak, int sbk, int sbn, int dtype,
              void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (dtype == kF32) {
    gemm_bias_kernel<float><<<grid, 256, 0, s>>>(
        (const float*)A, (const float*)B, (const float*)bias, (float*)C, M, N,
        K, sam, sak, sbk, sbn);
  } else if (dtype == kBF16) {
    gemm_bias_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        (const __nv_bfloat16*)A, (const __nv_bfloat16*)B,
        (const __nv_bfloat16*)bias, (__nv_bfloat16*)C, M, N, K, sam, sak, sbk,
        sbn);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
