// The bf16 flash-attention backward redesigned for Hopper: dq, and dk
// with dv, each on TMA, an mbarrier ring and wgmma, warp-specialised.
// Replaces repro/kernels/flash_attention.py::_flash_bwd_dq_kernel and
// ::_flash_bwd_dk_kernel / ::_flash_bwd_dv_kernel in bf16 at head dims 64
// and 128 wherever TMA can read q, k, v and dO in place (bases and
// (batch, seq, head) strides 16-byte aligned: kernels/flash.py picks
// these instances then, else flash.cuh's mma.sync ones).  Layouts, masks
// and outputs are flash.cuh's: q, dO and dq [B, Sq, H, D], k, v, dk and
// dv [B, Sk, KV, D], q, k, v and dO read through their strides (the fused
// QKV views), the queries the last Sq of the Sk positions, query head h
// reading kv head h / G, the sliding window; lse and delta [B, H, Sq]
// fp32 (delta = rowsum(dO * O), computed outside, kernels/ref.py).  dk
// and dv are summed over the G query heads and written once, at kv-head
// resolution, zero on the rows no query sees.  No atomics; every sum runs
// in a fixed order: reruns are bitwise equal.
//
// Bound on the H100: operations.  At phase 20's qwen3-1.7b shape (B 4, S
// 2048, 16 heads of 128) dq's three products over the 2.1 M causal pairs
// of each (batch, head) are 103 GFLOP, 0.104 ms at 989 TFLOP/s; dk/dv's
// four 137 GFLOP, 0.139 ms.  This design issues each product whose A
// operand is formed in registers twice (below): dq's tensor work is 4/3
// of that, dk/dv's 3/2.
//
// Shared arithmetic.  Every product is a wgmma with an fp32 accumulator.
// A score tile (S = Q.K^T, dP = dO.V^T, or their transposes S^T = K.Q^T,
// dP^T = V.dO^T) reads both operands K-major from shared memory, summed
// over D in one zeroed accumulator.  p = 2^(s.c - lse.log2(e)), c =
// log2(e)/sqrt(D) (one FFMA and the multi-function unit's ex2 an
// element), 0 where a pair is not visible (tested per element only on
// tiles that cross the diagonal, the window's edge or the sequence's
// end), and ds = (p.(dp - delta)).scale, all on the accumulator
// registers.  The products that take p or ds as A (dq += dS.K, dV +=
// P^T.dO, dK += dS^T.Q) read it from registers, the accumulator layout of
// a score tile being the register-A layout of a k16 step, and B (K, dO,
// Q) MN-major through the transpose bit, as flash_wgmma.cu issues P.V: no
// operand is copied or transposed.
// Decisions (tests/test_torch_flash_tiles.py emulates this order on the
// CPU at phase 20's S 2048, with the tensor cores' additions rounding
// toward zero, tools/mma_rounding.py):
//   * p and ds are split as hi + lo, both bf16, and lo.B then hi.B run a
//     k16 step.  One bf16 dS misses the bf16 tolerance in dq at every
//     case (2.7x the limit at D 128) and in dk under a window (1.2x);
//     one bf16 P^T holds dv at 0.64-0.91 of the limit at phase 20's
//     shapes but misses at S 512 (1.06x), so P^T is split too;
//   * no promotion: dk/dv's accumulators take G x Sq query rows (20c:
//     8 x 2048) and hold the tolerance at 0.26 of it without adding each
//     (head, q block) into a second fp32 sum, which would cost D
//     registers a thread beside the two accumulators.
//
// dq.  One block per (q block of BQ = 64 NC rows, head, batch), the q
// block the grid's slowest dimension taken from the last (the longest
// first).  Warpgroup 0 is the producer: one thread loads the Q and dO
// tiles once, then K and V kv block by kv block (BK rows: 128 at head
// dim 64, 64 at 128, as the forward) into a STAGES-deep ring (4-d TMA
// boxes of 64 columns, 128-byte swizzle) completing a full mbarrier; the
// consumers release a stage through its empty mbarrier.  Each consumer
// warpgroup owns 64 query rows and walks only the kv blocks its rows
// see: per block S and dP (m64nBKk16), then p and ds, then dq += dS.K
// (m64nDk16, lo then hi) into its fp32 dq registers (D / 2 a thread).
// Two consumers (the 128-row tile) take 232 registers a thread through
// setmaxnreg, the producer 40, as in the forward.  A skipped block
// leaves a row's sums unchanged (the k16 steps group the same 16 keys at
// any BK), so the tiles 64 and 128 give bitwise-equal outputs.
//
// dk/dv.  One block per (kv block of BK = 64 NC rows, kv head, batch), the
// kv block the grid's slowest dimension (under the causal mask the first
// kv blocks see the most q blocks: they are dispatched first).  K and V
// stay resident.  The producer streams, for each of the G query heads in
// turn and each q block (64 rows) of the reference's _q_bounds taken at
// key positions, the Q and dO tiles (TMA, one thread) and the q block's
// lse.log2(e) and delta rows (plain loads by the producer's first warp,
// into the stage beside the tiles, each lane arriving on the full
// mbarrier after its stores).  Each consumer warpgroup owns 64 kv rows
// and, per (head, q block) its rows see: S^T and dP^T (m64n64k16, K and V
// as A), p^T and ds^T with lse and delta varying along the columns (read
// from shared memory), then dV += P^T.dO and dK += dS^T.Q (m64nDk16).
// Registers: dK and dV are D / 2 fp32 each a thread, S^T and dP^T 32
// each, their split fragments 32 each.  One consumer warpgroup (256
// threads, up to 255 a thread) takes 248 at D 128 and spills nothing;
// two (384 threads, 168 a thread at launch) take 240 through setmaxnreg,
// the producer keeping 24: ptxas allocates the consumers' code to the
// setmaxnreg count, not to the launch's 168 (at 232 it spilled 64
// bytes, at 240 it spills 4).  A 64-row kv tile gives 20c's grid (B 4, 2
// kv heads, S 2048) 256 blocks of at most 8 x 32 q blocks each, the
// longest equal to the mean per SM; a 128-row tile halves the blocks
// below the 132 SMs and doubles the longest (kernels/autotune.py picks
// per key).  The walk's sums do not depend on the block's other
// consumer: the tiles give bitwise-equal outputs.
#include "flash.cuh"
#include "hopper.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------
// Pieces shared by the two kernels
// ---------------------------------------------------------------------
// A score tile's 64 rows x N columns over D: wgmma m64nNk16 steps, A
// and B K-major in their 64-column boxes (a_box / b_box bytes apart),
// accumulating into a zeroed s.  Issued and committed, not awaited.
template <int D, int N>
__device__ __forceinline__ void issue_scores(float (&s)[N / 2],
                                             const uint8_t* a, int a_box,
                                             const uint8_t* b, int b_box) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = kk / 4, col = 32 * (kk % 4);
    wgmma_ss<0, 0>(s, sw128_desc(a + box * a_box + col, 16, 1024),
                   sw128_desc(b + box * b_box + col, 16, 1024), kk > 0,
                   Wn<N>());
  }
  wgmma_commit();
}

// x (a 64 x N accumulator tile) as hi + lo register-A fragments of its
// N / 16 k16 steps: step kk covers columns 16kk .. 16kk + 15, the
// accumulator's column tiles 2kk and 2kk + 1.
template <int N>
__device__ __forceinline__ void split_frags(const float (&x)[N / 2],
                                            uint32_t (&hi)[N / 16][4],
                                            uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float* v = x + 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(v[0], v[1]);
      const float2 hf = __bfloat1622float2(h2);
      hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h2);
      lo[kk][r] = pack_bf16(v[0] - hf.x, v[1] - hf.y);
    }
}

// acc += x.B over N positions, x = hi + lo fragments, B = N rows of D
// columns at b, MN-major (the transpose bit; b_box bytes between the
// 64-wide column boxes): lo.B then hi.B a k16 step.  Issued and
// committed, not awaited.
template <int D, int N>
__device__ __forceinline__ void issue_acc(float (&acc)[D / 2],
                                          const uint32_t (&hi)[N / 16][4],
                                          const uint32_t (&lo)[N / 16][4],
                                          const uint8_t* b, int b_box) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint64_t db = sw128_desc(b + 2048 * kk, b_box, 1024);
    wgmma_rs<1>(acc, lo[kk], db, 1, Wn<D>());
    wgmma_rs<1>(acc, hi[kk], db, 1, Wn<D>());
  }
  wgmma_commit();
}

// A 64-row accumulator [64, D] of a warpgroup as bf16 rows of a
// [.., rows, heads, D] output: element 4j + 2r + e of a thread (warp w,
// lane 4g + t) is row first + 16w + g + 8r, column 8j + 2t + e; rows at
// or past `end` are not written.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           long long row_stride,
                                           const float (&acc)[D / 2],
                                           int first, int end, int w, int g,
                                           int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = first + 16 * w + g + 8 * r;
    if (row >= end) continue;
    __nv_bfloat16* dst = out + (long long)row * row_stride;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// ---------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------
template <int D, int NC>
struct DqGeom {
  static constexpr int BQ = 64 * NC;           // query rows of a block
  static constexpr int BK = D == 64 ? 128 : 64;   // kv rows of a stage
  static constexpr int STAGES = 3;
  static constexpr int DB = D / 64;            // 64-wide boxes of the head dim
  static constexpr int Q_BOX = BQ * 128;       // bytes of one Q or dO box
  static constexpr int KV_BOX = BK * 128;      // bytes of one K or V box
  static constexpr int Q_BYTES = 2 * DB * Q_BOX;   // Q, then dO
  static constexpr int STAGE = 2 * DB * KV_BOX;    // K, then V
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int SMEM =
      Q_BYTES + STAGES * STAGE + (1 + 2 * STAGES) * 8 + 1024;
};

template <int D, int NC>
__global__ void __launch_bounds__(DqGeom<D, NC>::THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tg,
                          const FlashArgs a) {
  using G = DqGeom<D, NC>;
  constexpr int BQ = G::BQ, BK = G::BK, S = G::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Qs = smem;
  uint8_t* Gs = smem + G::DB * G::Q_BOX;
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
      for (int i = 0; i < G::DB; ++i) {
        tma_load_4d(Qs + i * G::Q_BOX, &tq, q_full, 64 * i, h, q0, b);
        tma_load_4d(Gs + i * G::Q_BOX, &tg, q_full, 64 * i, h, q0, b);
      }
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
    const int Sk = a.Sk, window = a.window, off = Sk - a.Sq;
    const float c2 = a.scale * LOG2E;    // scale . log2(e)
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

    // lse.log2(e) and delta of the thread's two rows
    float l2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
    const long long rows = ((long long)b * a.H + h) * a.Sq;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row0 + 8 * r < Sk) {
        l2[r] = a.lse_in[rows + row0 + 8 * r - off] * LOG2E;
        dl[r] = a.delta[rows + row0 + 8 * r - off];
      }

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    for (int ik = lo; ik < min(vlo, vhi); ++ik) {
      wait_full(ik);
      release(ik);
    }
    mbar_wait(q_full, 0);
    const uint8_t* qs = Qs + c * 64 * 128;
    const uint8_t* gs = Gs + c * 64 * 128;
    for (int ik = vlo; ik < vhi; ++ik) {
      wait_full(ik);
      const uint8_t* ks = stage(ik);
      const uint8_t* vs = ks + G::DB * G::KV_BOX;
      float s[BK / 2], dp[BK / 2];
      wgmma_fence();
      issue_scores<D, BK>(s, qs, G::Q_BOX, ks, G::KV_BOX);    // S = Q.K^T
      issue_scores<D, BK>(dp, gs, G::Q_BOX, vs, G::KV_BOX);   // dP = dO.V^T
      // element 4j + e: row row0 + 8(e >> 1), key k0 + 8j + 2t + (e & 1)
      const int k0 = ik * BK;
      const bool all = k0 + BK - 1 <= qr && qr + 63 < Sk &&
                       (window <= 0 || qr + 63 - k0 < window);
      wgmma_wait<1>();                // S is in s; dP runs on
      reg_fence(s);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(s[4 * j + e], c2, -l2[e >> 1]));
          s[4 * j + e] = all || visible(row0 + 8 * (e >> 1),
                                        k0 + 8 * j + 2 * t + (e & 1), Sk,
                                        window)
                             ? p : 0.f;
        }
      wgmma_wait<0>();
      reg_fence(dp);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        dp[i] = (s[i] * (dp[i] - dl[(i >> 1) & 1])) * a.scale;      // ds
      uint32_t dhi[BK / 16][4], dlo[BK / 16][4];
      split_frags<BK>(dp, dhi, dlo);
      wgmma_fence();
      issue_acc<D, BK>(dq, dhi, dlo, ks, G::KV_BOX);      // dq += dS.K
      wgmma_wait<0>();
      reg_fence(dq);
      release(ik);
    }
    for (int ik = max(vhi, vlo); ik < hi; ++ik) {
      wait_full(ik);
      release(ik);
    }
    // query rows qr - off + ..: the key positions' rows of dq
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.dq) +
                         ((long long)b * a.Sq * a.H + h) * D;
    store_rows<D>(out, (long long)a.H * D, dq, qr - off, a.Sq, w, g, t);
  }
}

// ---------------------------------------------------------------------
// dk and dv
// ---------------------------------------------------------------------
template <int D, int NC>
struct DkvGeom {
  static constexpr int BK = 64 * NC;           // kv rows of a block
  static constexpr int BQ = 64;                // query rows of a stage
  static constexpr int STAGES = 3;
  static constexpr int DB = D / 64;
  static constexpr int KV_BOX = BK * 128;      // bytes of one K or V box
  static constexpr int Q_BOX = BQ * 128;       // bytes of one Q or dO box
  static constexpr int KV_BYTES = 2 * DB * KV_BOX;   // K, then V
  static constexpr int STAGE = 2 * DB * Q_BOX;       // Q, then dO
  static constexpr int ROWS = 2 * BQ * 4;            // lse.log2(e), delta
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int SMEM = KV_BYTES + STAGES * (STAGE + ROWS) +
                              (1 + 2 * STAGES) * 8 + 1024;
};

template <int D, int NC>
__global__ void __launch_bounds__(DkvGeom<D, NC>::THREADS, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tg,
                            const FlashArgs a) {
  using G = DkvGeom<D, NC>;
  constexpr int BQ = G::BQ, BK = G::BK, S = G::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Ks = smem;
  uint8_t* Vs = smem + G::DB * G::KV_BOX;
  uint8_t* ring = smem + G::KV_BYTES;
  float* rows_s = reinterpret_cast<float*>(ring + S * G::STAGE);  // [S][2][BQ]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(rows_s + S * 2 * BQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + S;

  // kv blocks are the grid's slowest dimension: the blocks with the most
  // q blocks (the first kv blocks) are dispatched first
  const int kvh = blockIdx.x, b = blockIdx.y, ik = blockIdx.z;
  const int Gh = a.H / a.KV;
  const int Sq = a.Sq, Sk = a.Sk, off = Sk - Sq, k0 = ik * BK;
  const int nq = (Sq + BQ - 1) / BQ;
  const int qlo = max(k0 - off, 0) / BQ;
  // under a window, the query row of the last position that sees the block
  const int last = k0 + BK + a.window - 2 - off;
  const int qhi = a.window > 0 ? (last < 0 ? 0 : min(last / BQ + 1, nq)) : nq;
  const int nqb = max(qhi - qlo, 0), items = Gh * nqb;   // (head, q block)
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 32);          // the producer's first warp
      mbar_init(&empty[s], NC * 128);   // every consumer thread arrives
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ----
    if constexpr (NC == 2) regs_dec<24>();
    const int lane = threadIdx.x;
    if (lane < 32) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, G::KV_BYTES);
        for (int i = 0; i < G::DB; ++i) {
          tma_load_4d(Ks + i * G::KV_BOX, &tk, kv_full, 64 * i, kvh, k0, b);
          tma_load_4d(Vs + i * G::KV_BOX, &tv, kv_full, 64 * i, kvh, k0, b);
        }
      }
      for (int it = 0; it < items; ++it) {
        const int st = it % S;
        if (it >= S) mbar_wait(&empty[st], ((it / S) & 1) ^ 1);
        const int hq = kvh * Gh + it / nqb, q0 = (qlo + it % nqb) * BQ;
        const long long base = ((long long)b * a.H + hq) * Sq;
        float* rs = rows_s + st * 2 * BQ;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int cq = lane + 32 * i, qi = q0 + cq;
          rs[cq] = qi < Sq ? a.lse_in[base + qi] * LOG2E : 0.f;
          rs[BQ + cq] = qi < Sq ? a.delta[base + qi] : 0.f;
        }
        if (lane == 0) {
          uint8_t* qs = ring + st * G::STAGE;
          uint8_t* gs = qs + G::DB * G::Q_BOX;
          mbar_expect_tx(&full[st], G::STAGE);
          for (int i = 0; i < G::DB; ++i) {
            tma_load_4d(qs + i * G::Q_BOX, &tq, &full[st], 64 * i, hq, q0, b);
            tma_load_4d(gs + i * G::Q_BOX, &tg, &full[st], 64 * i, hq, q0, b);
          }
        } else {
          mbar_arrive(&full[st]);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup c owns kv rows [k0 + 64c, k0 + 64c + 64)
    if constexpr (NC == 2) regs_inc<240>();
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x & 127, w = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int kmin = k0 + 64 * c;        // the warpgroup's first kv row
    const int krow = kmin + 16 * w + g;  // this thread's rows: krow, krow + 8
    const int window = a.window;
    const float c2 = a.scale * LOG2E;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(kv_full, 0);
    const uint8_t* ks = Ks + c * 64 * 128;
    const uint8_t* vs = Vs + c * 64 * 128;
    for (int it = 0; it < items; ++it) {
      const int st = it % S;
      mbar_wait(&full[st], (it / S) & 1);
      // kv rows [kmin, kmin + 64) against q columns at key positions
      // [p0, p0 + 64): skip the item where no pair is visible, test each
      // element only where some are not
      const int p0 = (qlo + it % nqb) * BQ + off, pmax = p0 + BQ - 1;
      const bool none = kmin >= Sk || pmax < kmin ||
                        (window > 0 && p0 - (kmin + 63) >= window);
      if (!none) {
        const bool all = p0 >= kmin + 63 && pmax < Sk &&
                         (window <= 0 || pmax - kmin < window);
        const uint8_t* qs = ring + st * G::STAGE;
        const uint8_t* gs = qs + G::DB * G::Q_BOX;
        const float* l2 = rows_s + st * 2 * BQ;
        const float* dl = l2 + BQ;
        float s[BQ / 2], dp[BQ / 2];
        wgmma_fence();
        issue_scores<D, BQ>(s, ks, G::KV_BOX, qs, G::Q_BOX);   // S^T = K.Q^T
        issue_scores<D, BQ>(dp, vs, G::KV_BOX, gs, G::Q_BOX);  // V.dO^T
        // element 4j + e: kv row krow + 8(e >> 1), query column 8j + 2t +
        // (e & 1)
        wgmma_wait<1>();
        reg_fence(s);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 lj =
              *reinterpret_cast<const float2*>(l2 + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p =
                ex2(fmaf(s[4 * j + e], c2, -((e & 1) ? lj.y : lj.x)));
            s[4 * j + e] = all || visible(p0 + 8 * j + 2 * t + (e & 1),
                                          krow + 8 * (e >> 1), Sk, window)
                               ? p : 0.f;
          }
        }
        wgmma_wait<0>();
        reg_fence(dp);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 dj =
              *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;                              // ds
            dp[i] = (s[i] * (dp[i] - ((e & 1) ? dj.y : dj.x))) * a.scale;
          }
        }
        uint32_t phi[BQ / 16][4], plo[BQ / 16][4], dhi[BQ / 16][4],
            dlo[BQ / 16][4];
        split_frags<BQ>(s, phi, plo);
        split_frags<BQ>(dp, dhi, dlo);
        wgmma_fence();
        issue_acc<D, BQ>(dv, phi, plo, gs, G::Q_BOX);   // dV += P^T.dO
        issue_acc<D, BQ>(dk, dhi, dlo, qs, G::Q_BOX);   // dK += dS^T.Q
        wgmma_wait<0>();
        reg_fence(dv);
        reg_fence(dk);
      }
      mbar_arrive(&empty[st]);
    }
    const long long stride = (long long)a.KV * D;
    const long long at = (long long)b * Sk * stride + (long long)kvh * D;
    store_rows<D>(static_cast<__nv_bfloat16*>(a.dk) + at, stride, dk, kmin, Sk,
                  w, g, t);
    store_rows<D>(static_cast<__nv_bfloat16*>(a.dv) + at, stride, dv, kmin, Sk,
                  w, g, t);
  }
}

template <typename Kernel>
int launch_bwd(Kernel kernel, dim3 grid, int threads, int smem,
               const CUtensorMap* m, const FlashArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(m[0], m[1], m[2], m[3], a);
  return (int)cudaGetLastError();
}

template <int D, int NC>
int launch_dq_wgmma(const CUtensorMap* m, const FlashArgs& a,
                    cudaStream_t stream) {
  using G = DqGeom<D, NC>;
  static_assert(G::SMEM <= SMEM_MAX, "dq tiles exceed shared memory");
  return launch_bwd(flash_bwd_dq_wgmma_kernel<D, NC>,
                    dim3(a.H, a.B, (a.Sq + G::BQ - 1) / G::BQ), G::THREADS,
                    G::SMEM, m, a, stream);
}

template <int D, int NC>
int launch_dkdv_wgmma(const CUtensorMap* m, const FlashArgs& a,
                      cudaStream_t stream) {
  using G = DkvGeom<D, NC>;
  static_assert(G::SMEM <= SMEM_MAX, "dk/dv tiles exceed shared memory");
  return launch_bwd(flash_bwd_dkdv_wgmma_kernel<D, NC>,
                    dim3(a.KV, a.B, (a.Sk + G::BK - 1) / G::BK), G::THREADS,
                    G::SMEM, m, a, stream);
}

// Validates the call and encodes the four maps (q, k, v, dO); 0 or an
// error.
int prepare(CUtensorMap (&m)[4], FlashArgs& a, const void* q, const void* k,
            const void* v, const void* g, const void* lse, const void* delta,
            int B, int Sq, int Sk, int H, int KV, int window, float scale,
            const long long* maps) {
  if (B <= 0 || Sq <= 0 || Sk < Sq || H <= 0 || KV <= 0 || H % KV != 0 ||
      window < 0)
    return (int)cudaErrorInvalidValue;
  const void* bases[4] = {q, k, v, g};
  for (int i = 0; i < 4; ++i) {
    const int err = encode_map(&m[i], bases[i], 4, maps + 11 * i);
    if (err != 0) return err;
  }
  a = FlashArgs{};
  a.lse_in = (const float*)lse;
  a.delta = (const float*)delta;
  a.B = B;
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.KV = KV;
  a.window = window;
  a.scale = scale;
  return 0;
}

}  // namespace

extern "C" {

// q, k, v and dO through the tensor maps of `maps` (kernels/tma.py::
// flash_bwd_maps: four rank-4 specs of 11 numbers: dims, strides, box);
// tile = the rows of the grid's blocks (dq: query rows; dk/dv: kv rows),
// 64 or 128; head dims 64 and 128.
int flash_bwd_dq_wgmma(const void* q, const void* k, const void* v,
                       const void* g, const void* lse, const void* delta,
                       void* dq, int B, int Sq, int Sk, int H, int KV, int D,
                       int window, float scale, const long long* maps,
                       int tile, void* stream) {
  CUtensorMap m[4];
  FlashArgs a;
  const int err = prepare(m, a, q, k, v, g, lse, delta, B, Sq, Sk, H, KV,
                          window, scale, maps);
  if (err != 0) return err;
  a.dq = dq;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64 && tile == 64) return launch_dq_wgmma<64, 1>(m, a, s);
  if (D == 64 && tile == 128) return launch_dq_wgmma<64, 2>(m, a, s);
  if (D == 128 && tile == 64) return launch_dq_wgmma<128, 1>(m, a, s);
  if (D == 128 && tile == 128) return launch_dq_wgmma<128, 2>(m, a, s);
  return (int)cudaErrorInvalidValue;
}

int flash_bwd_dkdv_wgmma(const void* q, const void* k, const void* v,
                         const void* g, const void* lse, const void* delta,
                         void* dk, void* dv, int B, int Sq, int Sk, int H,
                         int KV, int D, int window, float scale,
                         const long long* maps, int tile, void* stream) {
  CUtensorMap m[4];
  FlashArgs a;
  const int err = prepare(m, a, q, k, v, g, lse, delta, B, Sq, Sk, H, KV,
                          window, scale, maps);
  if (err != 0) return err;
  a.dk = dk;
  a.dv = dv;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64 && tile == 64) return launch_dkdv_wgmma<64, 1>(m, a, s);
  if (D == 64 && tile == 128) return launch_dkdv_wgmma<64, 2>(m, a, s);
  if (D == 128 && tile == 64) return launch_dkdv_wgmma<128, 1>(m, a, s);
  if (D == 128 && tile == 128) return launch_dkdv_wgmma<128, 2>(m, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
