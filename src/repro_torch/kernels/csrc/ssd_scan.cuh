// The Mamba2 SSD's decays and chunk scans, shared by both SSD sources
// (csrc/ssd.cu's mma.sync instances and csrc/ssd_wgmma.cu's wgmma ones),
// so that both run one recurrence in one order.
//
// cum over a chunk of Q rows is a warp scan (chunk_cum): every phase of
// either source takes cum from here, so all agree bitwise.  The scan
// phase of each direction runs per (batch, head) and 1024 of the P.N
// state elements (4 a thread), in the reference's order:
//   forward   S_0 = 0, S_c+1 = S_c e^cum_Q,c + L_c in place in cstates
//             chunk by chunk (cstates[c + 1] holds L_c on entry, the
//             final state L_nc-1), and the final state S_nc;
//   backward  dS1_nc-1 = gstate, dS1_c-1 = e^cum_Q,c dS1_c + L'_c, the
//             scratch's chunk c turning from L'_c into dS1_c.
#pragma once
#include <cstdint>

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SCAN_THREADS = 256;   // the scans' threads a block: 8 warps

// cum over one chunk as a warp scan: lane l holds a[k] = dt_i A for its
// RL rows i = RL l + k (RL = Q / 32); returns their cum in c and (every
// lane) cum_Q.
template <int RL>
__device__ __forceinline__ float chunk_cum(const float (&a)[RL],
                                           float (&c)[RL]) {
  const int l = threadIdx.x & 31;
  float s = a[0];
#pragma unroll
  for (int k = 1; k < RL; ++k) s += a[k];
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(FULL, s, o);
    if (l >= o) s += t;
  }
  float excl = __shfl_up_sync(FULL, s, 1);
  if (l == 0) excl = 0.f;
  c[0] = excl + a[0];
#pragma unroll
  for (int k = 1; k < RL; ++k) c[k] = c[k - 1] + a[k];
  return __shfl_sync(FULL, c[RL - 1], 31);
}

// Per-chunk decay terms, by warp 0 (lane l owns rows RL l .. RL l + RL -
// 1): cum, e^cum, e^(cum_Q - cum) and w_last = e^(cum_Q - cum) * dt;
// sc[0] = e^cum_Q.
template <int Q>
__device__ void chunk_decay(const float* dtv, float A, float* cum, float* ecum,
                            float* el, float* wl, float* sc) {
  constexpr int RL = Q / 32;
  if (threadIdx.x >= 32) return;
  const int l = threadIdx.x;
  float a[RL], c[RL];
#pragma unroll
  for (int k = 0; k < RL; ++k) a[k] = dtv[RL * l + k] * A;
  const float last = chunk_cum<RL>(a, c);
#pragma unroll
  for (int k = 0; k < RL; ++k) {
    const int i = RL * l + k;
    cum[i] = c[k];
    ecum[i] = expf(c[k]);
    el[i] = expf(last - c[k]);
    wl[i] = el[i] * dtv[i];
  }
  if (l == 31) sc[0] = expf(last);
}

// The scans' arguments: dt's strides in elements, the [b, H, nc, P, N]
// chunk states (cstates forward, the scratch backward), the forward's
// final state and the backward's gstate [b, H, P, N].
struct ScanArgs {
  const float* dt;
  const float* A;
  float* chunks;
  float* state;
  const float* gstate;
  long long dt_b, dt_s, dt_h;
  int S, H, nc;
};

// e^cum_Q of every chunk of the block's (batch, head) into eq[nc], warp
// w taking chunks w, w + 8, ...
template <int Q>
__device__ void chunk_decays(float* eq, const ScanArgs& a, int bi, int h) {
  constexpr int RL = Q / 32;
  const float* dt = a.dt + bi * a.dt_b + h * a.dt_h;
  const float A = a.A[h];
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  for (int c = warp; c < a.nc; c += SCAN_THREADS / 32) {
    const int r0 = c * Q + RL * l;
    float v[RL], cum[RL];
#pragma unroll
    for (int k = 0; k < RL; ++k)
      v[k] = (r0 + k < a.S ? dt[(r0 + k) * a.dt_s] : 0.f) * A;
    const float last = chunk_cum<RL>(v, cum);
    if (l == 0) eq[c] = expf(last);
  }
}

template <int P, int N, int Q>
__global__ void __launch_bounds__(SCAN_THREADS)
ssd_fwd_scan_kernel(const ScanArgs a) {
  extern __shared__ float4 scan_smem[];
  float* eq = reinterpret_cast<float*>(scan_smem);   // [nc]
  const int h = blockIdx.y, bi = blockIdx.z;
  const long long bh = (long long)bi * a.H + h;
  chunk_decays<Q>(eq, a, bi, h);
  __syncthreads();
  const int e = (blockIdx.x * SCAN_THREADS + threadIdx.x) * 4;
  if (e >= P * N) return;
  float4* cs = reinterpret_cast<float4*>(a.chunks + bh * a.nc * P * N + e);
  float4* fin = reinterpret_cast<float4*>(a.state + bh * P * N + e);
  constexpr int STEP = P * N / 4;                // float4s between chunks
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  cs[0] = s;
  constexpr int AHEAD = 8;                       // loads in flight
  for (int c0 = 0; c0 < a.nc; c0 += AHEAD) {
    float4 L[AHEAD];
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
      const int c = c0 + i;
      if (c + 1 < a.nc) L[i] = cs[(c + 1) * STEP];
      else if (c + 1 == a.nc) L[i] = *fin;
    }
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
      const int c = c0 + i;
      if (c >= a.nc) break;
      const float d = eq[c];
      s = make_float4(fmaf(s.x, d, L[i].x), fmaf(s.y, d, L[i].y),
                      fmaf(s.z, d, L[i].z), fmaf(s.w, d, L[i].w));
      if (c + 1 < a.nc) cs[(c + 1) * STEP] = s;
      else *fin = s;
    }
  }
}

template <int P, int N, int Q>
__global__ void __launch_bounds__(SCAN_THREADS)
ssd_bwd_scan_kernel(const ScanArgs a) {
  extern __shared__ float4 scan_smem[];
  float* eq = reinterpret_cast<float*>(scan_smem);   // [nc]
  const int h = blockIdx.y, bi = blockIdx.z;
  const long long bh = (long long)bi * a.H + h;
  chunk_decays<Q>(eq, a, bi, h);
  __syncthreads();
  const int e = (blockIdx.x * SCAN_THREADS + threadIdx.x) * 4;
  if (e >= P * N) return;
  float4* sc = reinterpret_cast<float4*>(a.chunks + bh * a.nc * P * N + e);
  constexpr int STEP = P * N / 4;
  float4 s = *reinterpret_cast<const float4*>(a.gstate + bh * P * N + e);
  constexpr int AHEAD = 8;
  for (int c0 = a.nc - 1; c0 >= 0; c0 -= AHEAD) {
    float4 L[AHEAD];
#pragma unroll
    for (int i = 0; i < AHEAD; ++i)
      if (c0 - i >= 1) L[i] = sc[(c0 - i) * STEP];
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
      const int c = c0 - i;
      if (c < 0) break;
      sc[c * STEP] = s;
      if (c == 0) break;                         // dS1_-1 is not needed
      const float d = eq[c];
      s = make_float4(fmaf(d, s.x, L[i].x), fmaf(d, s.y, L[i].y),
                      fmaf(d, s.z, L[i].z), fmaf(d, s.w, L[i].w));
    }
  }
}

// The scan phase of one direction for b batches, on the stream; 0 or the
// launch's CUDA error.
template <int P, int N, int Q>
int launch_scan(bool bwd, const ScanArgs& a, int b, cudaStream_t stream) {
  auto kernel = bwd ? ssd_bwd_scan_kernel<P, N, Q> : ssd_fwd_scan_kernel<P, N, Q>;
  const int smem = a.nc * (int)sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P * N + 4 * SCAN_THREADS - 1) / (4 * SCAN_THREADS), a.H, b);
  kernel<<<grid, SCAN_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
