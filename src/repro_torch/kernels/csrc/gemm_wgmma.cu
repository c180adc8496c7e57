// The bf16 GEMM with a bias epilogue, C = A.B + bias, redesigned for
// Hopper: TMA, an mbarrier ring and wgmma, warp-specialised.
// Replaces repro/kernels/fused.py::_matmul_kernel in bf16 (the fused QKV
// forward x.W + b, and the custom backward's dx = g.W^T and dW = x^T.g)
// wherever TMA can read both operands: each has a stride-1 dim, its other
// stride and its base 16-byte aligned (kernels/fused.py::gemm_config;
// elsewhere fused.cu's mma.sync instance runs).  fp32 stays on fused.cu.
//
// Bound on the H100: operations.  At phase 20's shapes (qwen3-1.7b: M
// 8192, K 2048, N 4096, and the dx and dW products) each element is read
// once for hundreds of multiply-adds: 2MNK = 137 GFLOP, 0.139 ms at the
// dense bf16 rate of 989 TFLOP/s; its 117 MB of operands and output take
// 0.035 ms at 3.35 TB/s.
//
// Design.  A block computes a 128 x 256 tile of C with three warpgroups:
// warpgroup 0 is the producer, of which one thread issues the TMA copies
// (cp.async.bulk.tensor, 128-byte swizzle) of each 64-wide K slice of A
// and B into a WSTAGES-deep ring of shared stages, each stage guarded by
// a full and an empty mbarrier; warpgroups 1 and 2 are the consumers,
// each running wgmma on its 64 rows of the tile against the stage's B
// (m64n256k16, both operands from shared memory), keeping one slice's
// products in flight while it releases the stage before.  setmaxnreg moves
// registers from the producer (40) to the consumers (232).  The three
// layouts of the QKV products differ only in the major order of A and B,
// which wgmma takes from its transpose bits (hopper.cuh): the forward
// reads W N-major, dx reads W^T K-major, dW reads x^T M-major and g
// N-major, each through a tensor map over the operand as it lies in
// memory: no operand is copied or transposed.  Rows, columns and K past
// the ends read as 0 (TMA's bounds), and the epilogue writes only inside
// C.  The whole K range accumulates in the wgmma accumulator: its
// additions round toward zero (tools/mma_rounding.py), and a CPU
// emulation of that order at phase 20's K = 8192 holds the bf16
// tolerance without promoting it into a second fp32 sum
// (tests/test_torch_gemm_tiles.py), which would cost a wait on every
// slice's products and 128 more registers a thread (a 128 x 256 tile's
// accumulator is 128).
// A split over K (grid z, whole slices) writes fp32 partials that a
// second kernel sums in a fixed order with the bias: no atomics,
// bitwise-equal reruns.
#include "hopper.cuh"

namespace {

constexpr int WBM = 128;       // rows of a block's tile: two consumers of 64
constexpr int WBN = 256;       // columns of a block's tile
constexpr int WBK = 64;        // K slice of a stage: one 128-byte swizzle row
constexpr int WSTAGES = 4;     // ring depth
constexpr int A_BYTES = WBM * WBK * 2;
constexpr int B_BYTES = WBN * WBK * 2;
constexpr int STAGE = A_BYTES + B_BYTES;
constexpr int BOX = 64 * WBK * 2;          // one 64 x 64 box, 8 KB
constexpr int SMEM = WSTAGES * STAGE + 2 * WSTAGES * 8 + 1024;

struct WgArgs {
  const __nv_bfloat16* bias;   // null: no bias
  __nv_bfloat16* C;            // [M, N] contiguous
  float* ws;                   // [splits, M, N] fp32 partials when split
  int M, N, K, kchunk;         // split z sums k in [z*kchunk, (z+1)*kchunk)
};

// AK: A is K-major (row-major A); BKM: B is K-major (B^T row-major).
template <bool AK, bool BKM>
__global__ void __launch_bounds__(384, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                  const __grid_constant__ CUtensorMap tb, const WgArgs p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + WSTAGES * STAGE);
  uint64_t* empty = full + WSTAGES;
  const int m0 = blockIdx.y * WBM, n0 = blockIdx.x * WBN;
  const int kbeg = blockIdx.z * p.kchunk;
  const int kend = min(p.K, kbeg + p.kchunk);
  const int KT = kend > kbeg ? (kend - kbeg + WBK - 1) / WBK : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WSTAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);    // every consumer thread arrives
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ----
    regs_dec<40>();
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < KT; ++kt) {
        const int st = kt % WSTAGES;
        if (kt >= WSTAGES) mbar_wait(&empty[st], ((kt / WSTAGES) & 1) ^ 1);
        uint8_t* a = smem + st * STAGE;
        uint8_t* b = a + A_BYTES;
        const int k0 = kbeg + kt * WBK;
        mbar_expect_tx(&full[st], STAGE);
        if (AK) {       // box {64 k, 128 m}: 128 rows of 128 bytes
          tma_load_2d(a, &ta, &full[st], k0, m0);
        } else {        // two boxes {64 m, 64 k}, one per consumer
          tma_load_2d(a, &ta, &full[st], m0, k0);
          tma_load_2d(a + BOX, &ta, &full[st], m0 + 64, k0);
        }
        if (BKM) {      // box {64 k, 256 n}
          tma_load_2d(b, &tb, &full[st], k0, n0);
        } else {        // four boxes {64 n, 64 k}
          for (int i = 0; i < WBN / 64; ++i)
            tma_load_2d(b + i * BOX, &tb, &full[st], n0 + 64 * i, k0);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup c owns rows [64c, 64c + 64) of the tile ----
    regs_inc<232>();
    const int c = threadIdx.x / 128 - 1;
    float acc[WBN / 2];
    for (int kt = 0; kt < KT; ++kt) {
      const int st = kt % WSTAGES;
      mbar_wait(&full[st], (kt / WSTAGES) & 1);
      const uint8_t* a = smem + st * STAGE + (AK ? c * 64 * 128 : c * BOX);
      const uint8_t* b = smem + st * STAGE + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WBK / 16; ++kk) {
        const uint64_t da = AK ? sw128_desc(a + 32 * kk, 16, 1024)
                               : sw128_desc(a + 2048 * kk, BOX, 1024);
        const uint64_t db = BKM ? sw128_desc(b + 32 * kk, 16, 1024)
                                : sw128_desc(b + 2048 * kk, BOX, 1024);
        wgmma_ss<AK ? 0 : 1, BKM ? 0 : 1>(acc, da, db, kt > 0 || kk > 0,
                                          Wn<WBN>());
      }
      wgmma_commit();
      // slice kt - 1's products are done: release its stage
      wgmma_wait<1>();
      if (kt > 0) mbar_arrive(&empty[(kt - 1) % WSTAGES]);
    }
    wgmma_wait<0>();
    reg_fence(acc);
    if (KT == 0) {
#pragma unroll
      for (int i = 0; i < WBN / 2; ++i) acc[i] = 0.f;
    }

    // Epilogue: acc[4j + 2h + e] is C(m0 + 64c + 16w + g + 8h, n0 + 8j + 2t + e)
    const int tid = threadIdx.x & 127, w = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const bool split = gridDim.z > 1;
    const bool pairs = (p.N & 1) == 0;      // 4-byte aligned column pairs
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 64 * c + 16 * w + g + 8 * h;
      if (m >= p.M) continue;
#pragma unroll
      for (int j = 0; j < WBN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * t;
        if (n >= p.N) continue;
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        const long long off = (long long)m * p.N + n;
        if (split) {
          float* ws = p.ws + (long long)blockIdx.z * p.M * p.N + off;
          ws[0] = v0;
          if (n + 1 < p.N) ws[1] = v1;
          continue;
        }
        if (p.bias != nullptr) {
          v0 += __bfloat162float(p.bias[n]);
          if (n + 1 < p.N) v1 += __bfloat162float(p.bias[n + 1]);
        }
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(p.C + off) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          p.C[off] = __float2bfloat16(v0);
          if (n + 1 < p.N) p.C[off + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// Second pass of a split over K: C = sum_z ws[z] + bias, z in order.
__global__ void __launch_bounds__(256)
gemm_wgmma_reduce(const WgArgs p, int splits) {
  const long long mn = (long long)p.M * p.N;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < mn;
       i += (long long)gridDim.x * 256) {
    float v = 0.f;
    for (int z = 0; z < splits; ++z) v += p.ws[z * mn + i];
    if (p.bias != nullptr) v += __bfloat162float(p.bias[i % p.N]);
    p.C[i] = __float2bfloat16(v);
  }
}

template <bool AK, bool BKM>
int launch_wgmma(const CUtensorMap& ta, const CUtensorMap& tb,
                 const WgArgs& p, int splits, cudaStream_t s) {
  auto kernel = gemm_wgmma_kernel<AK, BKM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.N + WBN - 1) / WBN, (p.M + WBM - 1) / WBM, splits);
  kernel<<<grid, 384, SMEM, s>>>(ta, tb, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long want = ((long long)p.M * p.N + 255) / 256;
  const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);
  gemm_wgmma_reduce<<<blocks, 256, 0, s>>>(p, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// A [M, K], B [K, N] bf16 through the tensor maps a_map and b_map
// (kernels/tma.py::gemm_maps: 2 dims, 1 stride, 2 box dims each); the
// tile is 128 x 256, K split into `splits` ranges of kchunk (a multiple
// of 64).
int gemm_bias_wgmma(const void* A, const void* B, const void* bias, void* C,
                    void* ws, int M, int N, int K, int splits, int kchunk,
                    int a_kmajor, int b_kmajor, const long long* a_map,
                    const long long* b_map, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits <= 0 || kchunk <= 0 ||
      kchunk % WBK != 0 || (long long)kchunk * splits < K ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  int err = encode_map(&ta, A, 2, a_map);
  if (err == 0) err = encode_map(&tb, B, 2, b_map);
  if (err != 0) return err;
  WgArgs p = {(const __nv_bfloat16*)bias, (__nv_bfloat16*)C, (float*)ws,
              M, N, K, kchunk};
  cudaStream_t s = (cudaStream_t)stream;
  if (a_kmajor)
    return b_kmajor ? launch_wgmma<true, true>(ta, tb, p, splits, s)
                    : launch_wgmma<true, false>(ta, tb, p, splits, s);
  return b_kmajor ? launch_wgmma<false, true>(ta, tb, p, splits, s)
                  : launch_wgmma<false, false>(ta, tb, p, splits, s);
}

}  // extern "C"
