// The bf16 flash-attention forward redesigned for Hopper: TMA, an
// mbarrier ring and wgmma, warp-specialised.
// Replaces repro/kernels/flash_attention.py::_flash_kernel in bf16 at
// head dims 64 and 128 wherever TMA can read q, k and v in place (bases
// and (batch, seq, head) strides 16-byte aligned: kernels/flash.py picks
// this instance then, else flash.cuh's mma.sync instance).  The layouts,
// masks and outputs are flash.cuh's: q [B, Sq, H, D], k and v [B, Sk, KV,
// D] read through their strides (the fused QKV views), queries the last
// Sq of the Sk positions, query head h reading kv head h / G, the
// reference's NEG_INF = -1e30, the sliding window; O [B, Sq, H, D] bf16
// and lse = m + log(max(l, 1e-20)) [B, H, Sq] fp32.
//
// Bound on the H100: operations.  At phase 20's qwen3-1.7b shape (B 4,
// S 2048, 16 heads of 128) the two products over the 2.1 M causal pairs
// of each (batch, head) are 68.7 GFLOP, 0.0695 ms at 989 TFLOP/s; this
// design issues P.V twice (below), so its tensor work is 1.5x that.
//
// Design.  A block owns BQ = 64 NC query rows of one (head, batch) and
// runs NC + 1 warpgroups.  Warpgroup 0 is the producer: one thread loads
// the Q tile once and then K and V kv block by kv block (BK rows) into a
// STAGES-deep ring, each a 4-d TMA box per 64 columns of the head dim
// (cp.async.bulk.tensor, 128-byte swizzle) completing a full mbarrier;
// consumers release a stage through its empty mbarrier.  Each consumer
// warpgroup owns 64 query rows and, per kv block its rows see:
//   * S = Q.K^T with wgmma (m64nBKk16, both operands K-major in shared
//     memory), summed over D in one zeroed accumulator;
//   * the online softmax on the accumulator registers, all fp32: the
//     scores masked per element only on blocks that cross the diagonal,
//     the window's edge or the sequence's end (to the reference's
//     NEG_INF, their p then 0), the row max over the 4 lanes of a row,
//     p = 2^(s.c - m_new.c) with c = log2(e)/sqrt(D) (one FFMA and the
//     multi-function unit's ex2 an element: the scalar work an element
//     is what the tensor cores' rate leaves room for), corr = 2^((m -
//     m_new).c), l = l.corr + rowsum(p), lse = m.scale + log(l);
//   * O = O.corr + P.V: P is split as hi + lo, both bf16 (p's
//     representation error then below 2^-16; one bf16 P misses the plain
//     version's fp32 P.V by up to 2^-9 of a row's terms), and the
//     accumulator layout of S is the register-A layout of a k16 step, so
//     lo.V then hi.V run as wgmma with A from registers and V from shared
//     memory, MN-major through the transpose bit, accumulating into the
//     fp32 O registers.  The tensor cores' additions round toward zero
//     (tools/mma_rounding.py); a CPU emulation of this order at phase
//     20's S 2048 holds the bf16 tolerance without promoting each block
//     into a second sum (tests/test_torch_flash_tiles.py), which would
//     cost D / 2 registers a thread and a wait.
// The visible blocks are pipelined: a warpgroup issues block j's Q.K^T
// and block j - 1's P.V together and takes block j's softmax while that
// P.V runs.  A warpgroup skips (only releases) the kv
// blocks none of whose pairs with its rows is visible; such a block
// would leave its rows' bits unchanged (p = 0, corr = 1), so each row's
// sums run in the same order whatever the block's NC, and the tiles 64
// and 128 give bitwise-equal outputs.  No
// atomics; the kv blocks run in a fixed order: reruns are bitwise equal.
// Under the causal mask the last q blocks read the most kv blocks, so the
// q block is the grid's slowest dimension, taken from the last.
#include "flash.cuh"
#include "hopper.cuh"

namespace {

template <int D, int NC>
struct FwGeom {
  static constexpr int BQ = 64 * NC;           // query rows of a block
  static constexpr int BK = D == 64 ? 128 : 64;   // kv rows of a stage
  static constexpr int STAGES = 3;
  static constexpr int DB = D / 64;            // 64-wide boxes of the head dim
  static constexpr int Q_BOX = BQ * 128;       // bytes of one Q box
  static constexpr int KV_BOX = BK * 128;      // bytes of one K or V box
  static constexpr int Q_BYTES = DB * Q_BOX;
  static constexpr int STAGE = 2 * DB * KV_BOX;   // K, then V
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int SMEM =
      Q_BYTES + STAGES * STAGE + (1 + 2 * STAGES) * 8 + 1024;
};

template <int D, int NC>
__global__ void __launch_bounds__(FwGeom<D, NC>::THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const FlashArgs a) {
  using G = FwGeom<D, NC>;
  constexpr int BQ = G::BQ, BK = G::BK, S = G::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Qs = smem;
  uint8_t* ring = smem + G::Q_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + S * G::STAGE);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S;

  const int h = blockIdx.x, b = blockIdx.y;
  const int iq = (int)(gridDim.z - 1 - blockIdx.z);   // the longest first
  const int kvh = h / (a.H / a.KV);
  const int q0 = iq * BQ, p0 = q0 + a.Sk - a.Sq;      // p0: a key position
  const int lo = a.window > 0 ? max((p0 - a.window + 1) / BK, 0) : 0;
  const int hi = min((p0 + BQ - 1) / BK + 1, (a.Sk + BK - 1) / BK);
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC * 128);   // every consumer thread arrives
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ----
    if constexpr (NC == 2) regs_dec<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, G::Q_BYTES);
      for (int i = 0; i < G::DB; ++i)
        tma_load_4d(Qs + i * G::Q_BOX, &tq, q_full, 64 * i, h, q0, b);
      for (int ik = lo; ik < hi; ++ik) {
        const int it = ik - lo, st = it % S;
        if (it >= S) mbar_wait(&empty[st], ((it / S) & 1) ^ 1);
        uint8_t* ks = ring + st * G::STAGE;
        uint8_t* vs = ks + G::DB * G::KV_BOX;
        mbar_expect_tx(&full[st], G::STAGE);
        for (int i = 0; i < G::DB; ++i) {
          tma_load_4d(ks + i * G::KV_BOX, &tk, &full[st], 64 * i, kvh,
                      ik * BK, b);
          tma_load_4d(vs + i * G::KV_BOX, &tv, &full[st], 64 * i, kvh,
                      ik * BK, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup c owns query rows [q0 + 64c, q0 + 64c + 64)
    if constexpr (NC == 2) regs_inc<232>();
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x & 127, w = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int qr = p0 + 64 * c;          // the warpgroup's first row (key pos.)
    const int row0 = qr + 16 * w + g;    // this thread's rows: row0, row0 + 8
    const int Sk = a.Sk, window = a.window;
    const float c2 = a.scale * 1.4426950408889634f;   // scale . log2(e)
    // [vlo, vhi): the kv blocks some pair of the warpgroup's rows sees (a
    // sub-range of the block's [lo, hi)); the others it only releases
    const int vhi = qr >= Sk ? lo : min((qr + 63) / BK + 1, hi);
    const int vlo = qr >= Sk ? lo
                    : max(window > 0 ? max((qr - window + 1) / BK, 0) : 0, lo);
    auto stage = [&](int ik) { return ring + ((ik - lo) % S) * G::STAGE; };
    auto wait_full = [&](int ik) {
      mbar_wait(&full[(ik - lo) % S], ((ik - lo) / S) & 1);
    };
    auto release = [&](int ik) { mbar_arrive(&empty[(ik - lo) % S]); };
    for (int ik = lo; ik < min(vlo, vhi); ++ik) {
      wait_full(ik);
      release(ik);
    }

    float o[D / 2], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    mbar_wait(q_full, 0);
    const uint8_t* qs = Qs + c * 64 * 128;
    float s[BK / 2], corr_prev[2] = {1.f, 1.f};
    uint32_t phi[BK / 16][4], plo[BK / 16][4];   // the previous block's P

    // S = Q.K^T of kv block ik over D into s (issued, not awaited)
    auto issue_qk = [&](int ik) {
      const uint8_t* ks = stage(ik);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int box = kk / 4, col = 32 * (kk % 4);
        wgmma_ss<0, 0>(s, sw128_desc(qs + box * G::Q_BOX + col, 16, 1024),
                       sw128_desc(ks + box * G::KV_BOX + col, 16, 1024),
                       kk > 0, Wn<BK>());
      }
      wgmma_commit();
    };
    // o += P.V of kv block ik, lo.V then hi.V a k16 step (issued)
    auto issue_pv = [&](int ik) {
      const uint8_t* vs = stage(ik) + G::DB * G::KV_BOX;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = sw128_desc(vs + 2048 * kk, G::KV_BOX, 1024);
        wgmma_rs<1>(o, plo[kk], dv, 1, Wn<D>());
        wgmma_rs<1>(o, phi[kk], dv, 1, Wn<D>());
      }
      wgmma_commit();
    };
    // The online softmax of kv block ik on s: element 4j + e is (row row0 +
    // 8(e >> 1), key k0 + 8j + 2t + (e & 1)).  m is kept in unscaled score
    // units and p = 2^(s.c - m.c), c = scale.log2(e): one FFMA and one ex2
    // an element.  Leaves p in s, returns corr in cr.
    auto softmax = [&](int ik, float (&cr)[2]) {
      const int k0 = ik * BK;
      const bool all = k0 + BK - 1 <= qr && qr + 63 < Sk &&
                       (window <= 0 || qr + 63 - k0 < window);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!all && !visible(row0 + 8 * (e >> 1),
                               k0 + 8 * j + 2 * t + (e & 1), Sk, window))
            s[4 * j + e] = NEG_INF;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
        }
      mx[0] = quad_max(mx[0]);
      mx[1] = quad_max(mx[1]);
      const float mc[2] = {mx[0] * c2, mx[1] * c2};
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(s[4 * j + e], c2, -mc[e >> 1]));
          if (!all && s[4 * j + e] == NEG_INF) p = 0.f;   // masked
          s[4 * j + e] = p;
          sum[e >> 1] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        cr[r] = ex2((m[r] - mx[r]) * c2);
        l[r] = l[r] * cr[r] + quad_sum(sum[r]);
        m[r] = mx[r];
      }
    };
    // P as hi + lo register-A fragments: k16 step kk covers keys 16kk ..
    // 16kk + 15, the accumulator's column tiles 2kk and 2kk + 1
    auto split_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float* x = s + 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
          const __nv_bfloat162 h2 = __floats2bfloat162_rn(x[0], x[1]);
          const float2 hf = __bfloat1622float2(h2);
          phi[kk][r] = *reinterpret_cast<const uint32_t*>(&h2);
          plo[kk][r] = pack_bf16(x[0] - hf.x, x[1] - hf.y);
        }
    };
    // O = O.corr before the block's P.V accumulates into it
    auto rescale = [&](const float (&cr)[2]) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= cr[(i >> 1) & 1];
    };

    // Pipelined over the visible blocks: block ik's scores are formed
    // while block ik - 1's P.V runs on the tensor cores, and its softmax
    // while that P.V completes.
    if (vlo < vhi) {
      wait_full(vlo);
      wgmma_fence();
      issue_qk(vlo);
      wgmma_wait<0>();
      reg_fence(s);
      softmax(vlo, corr_prev);
      split_p();
    }
    for (int ik = vlo + 1; ik < vhi; ++ik) {
      wait_full(ik);
      rescale(corr_prev);
      wgmma_fence();
      issue_qk(ik);
      issue_pv(ik - 1);
      wgmma_wait<1>();                // block ik's scores are in s
      reg_fence(s);
      float cr[2];
      softmax(ik, cr);
      wgmma_wait<0>();                // block ik - 1's P.V is in o
      reg_fence(o);
      release(ik - 1);
      split_p();
      corr_prev[0] = cr[0];
      corr_prev[1] = cr[1];
    }
    if (vlo < vhi) {
      rescale(corr_prev);
      wgmma_fence();
      issue_pv(vhi - 1);
      wgmma_wait<0>();
      reg_fence(o);
      release(vhi - 1);
    }
    for (int ik = max(vhi, vlo); ik < hi; ++ik) {
      wait_full(ik);
      release(ik);
    }

    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row0 + 8 * r;
      if (qpos >= Sk) continue;
      const int qi = qpos - (Sk - a.Sq);
      const float li = fmaxf(l[r], 1e-20f);
      __nv_bfloat16* row = out + (((long long)b * a.Sq + qi) * a.H + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * t) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] / li,
                                  o[4 * j + 2 * r + 1] / li);
      if (t == 0)
        a.lse[((long long)b * a.H + h) * a.Sq + qi] =
            m[r] * a.scale + logf(li);
    }
  }
}

template <int D, int NC>
int launch_fwd_wgmma(const CUtensorMap* maps, const FlashArgs& a,
                     cudaStream_t stream) {
  using G = FwGeom<D, NC>;
  static_assert(G::SMEM <= SMEM_MAX, "tiles exceed shared memory");
  auto kernel = flash_fwd_wgmma_kernel<D, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.H, a.B, (a.Sq + G::BQ - 1) / G::BQ);
  kernel<<<grid, G::THREADS, G::SMEM, stream>>>(maps[0], maps[1], maps[2], a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v through the tensor maps of `maps` (kernels/tma.py::flash_maps:
// three rank-4 specs of 11 numbers: dims, strides, box); tile = BQ, the
// query rows of a block (64 or 128); head dims 64 and 128.
int flash_fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                    void* lse, int B, int Sq, int Sk, int H, int KV, int D,
                    int window, float scale, const long long* maps, int tile,
                    void* stream) {
  if (B <= 0 || Sq <= 0 || Sk < Sq || H <= 0 || KV <= 0 || H % KV != 0 ||
      window < 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap m[3];
  const void* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int err = encode_map(&m[i], bases[i], 4, maps + 11 * i);
    if (err != 0) return err;
  }
  FlashArgs a = {};
  a.o = o;
  a.lse = (float*)lse;
  a.B = B;
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.KV = KV;
  a.window = window;
  a.scale = scale;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64 && tile == 64) return launch_fwd_wgmma<64, 1>(m, a, s);
  if (D == 64 && tile == 128) return launch_fwd_wgmma<64, 2>(m, a, s);
  if (D == 128 && tile == 64) return launch_fwd_wgmma<128, 1>(m, a, s);
  if (D == 128 && tile == 128) return launch_fwd_wgmma<128, 2>(m, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
