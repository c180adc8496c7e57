// The Mamba2 SSD chunked scan redesigned for Hopper (sm_90a) in bf16:
// TMA, mbarriers and wgmma, warp-specialised, on persistent blocks.
// Replaces repro/kernels/ssd.py::_ssd_kernel and ::_ssd_bwd_kernel for
// bf16 calls at the (P, N) of the training paths, (64, 128) (mamba2-780m)
// and (64, 16) (hymba-1.5b), chunk 64, wherever TMA can read x, B, C (and
// gy) in place (kernels/tma.py::ssd_maps); every other call, fp32
// included, runs csrc/ssd.cu's mma.sync instance (kernels/ssd.py).
// The layouts, the three-phase recurrence and the outputs are ssd.cu's
// (see its header): the forward runs ssd_fwd_wgmma_states_kernel (L_c =
// (x * w_last)^T.B), ssd_fwd_scan_kernel (csrc/ssd_scan.cuh, ssd.cu's)
// and ssd_fwd_wgmma_out_kernel (y); the backward
// ssd_bwd_wgmma_states_kernel (L'_c = (gy * e^cum)^T.C),
// ssd_bwd_scan_kernel and ssd_bwd_wgmma_chunk_kernel (dx, dB, dC, ddt and
// the dA partials).
//
// Bound on the H100: bytes (ssd.cu's header; in bf16 x, B, C, gy and
// their gradients move half their fp32 bytes, the fp32 states as many).
//
// Design.  Each phase's blocks are persistent: a block walks the (chunk,
// head, batch) tiles t = blockIdx.x, blockIdx.x + gridDim.x, ... (heads
// fastest, so that the tiles in flight share their chunk's B and C in
// L2), one block or two an SM.  A producer warp runs ahead of two
// consumer warpgroups: one thread loads each tile's operands with TMA
// into a ring of two stages (one where a second stage would cost the
// SM its second block), each stage on a full and an empty
// mbarrier, so that the next tile's loads land while this tile's products
// run.  A stage holds x, gy [Q, P] and B, C [Q, N] in bf16 (4-d maps over
// [b, S, H, D]; B and C over their group view, head coordinate 0, when
// they are one group over the heads) and, in the forward's output phase,
// the fp32 [P, N] state S_c (a 2-d map over the contiguous cstates).  The
// backward's chunk phase reads two fp32 states, dS1_c and then S0 =
// cstates[c], through one buffer beside the ring: the producer loads S0
// once the consumers release dS1 and the next tile's dS1 once they
// release S0, and takes sum(dS1 * S0) in between.  Rows of 128 bytes
// land in 128-byte-swizzled boxes of 128 bytes; N 16's rows (32 or 64
// bytes) land dense.  Rows at or past S are zero-filled by TMA and never
// stored.  dt is a column at stride H: loaded with plain loads.
//
// Every product is D[64, W] (+)= A[64, K].Op[K, W] on one consumer
// warpgroup (wgmma m64nWk16, bf16 in, fp32 accumulator, W 64 or 16); the
// two warpgroups run the products in pairs and hand one accumulator over
// through shared memory.  A comes from registers: each thread reads its
// fragment elements from shared memory through a functor, exact for a
// bf16 input, split as hi + lo bf16 for an fp32 factor.  Op is written by
// the warpgroup into its own ring of one or two slots in wgmma's K-major
// layout (up to 64 of K in 128-byte rows under the 128-byte swizzle),
// split once as it is written, so an operand read transposed needs no
// second layout; with two slots a step fills one while the other's
// products run.  A product issues one wgmma a k step (two bf16 inputs),
// two (one fp32 factor: the decayed, dt-weighted scores W and D, the
// states S, dS1 and S0, x * w_last, gy * e^cum) or three (two).  Scales
// along the output's rows (w_last, e^cum) are applied in the epilogue.
// The intermediate Q x Q matrices (W, D) are kept in fp32 in shared
// memory.  No atomics: every sum runs in a fixed order, so two runs are
// bitwise equal.
//
// Plain C interface (extern "C"), loaded with ctypes by kernels/build.py.
// Every entry point takes the stream it must launch on, allocates
// nothing, does not synchronise, and returns the first CUDA error of its
// launches.  dtype code: 1 = bfloat16, the only one built.
#include <cstdint>

#include "hopper.cuh"
#include "ssd_scan.cuh"
#include "tensor_core.cuh"


namespace {

using bf16 = __nv_bfloat16;

constexpr int Q = 64;                 // chunk rows
constexpr int HP = 64;                // head dim P
constexpr int NCONS = 256;            // two consumer warpgroups
constexpr int THREADS = NCONS + 32;   // and the producer warp
constexpr int WPITCH = Q + 4;         // row pitch (floats) of W and D
constexpr int SMEM_LIMIT = 232448;

struct Strides {
  long long b, s, h;
};

struct WArgs {
  const float* dt;
  const float* A;
  const float* cstates_in;    // backward: the forward's cstates (S0)
  void* y;
  float* cstates;             // forward: the state entering each chunk
  float* state;
  float* scratch;             // backward: L'_c, then dS1_c
  void* dx;
  float* ddt;
  void* dB;
  void* dC;
  float* dA_part;
  int b, S, H, nc, tiles;     // tiles: nc H b
  Strides dts;
  int bc_head;                // B and C per head (1) or one group (0)
};

// Bytes of a [Q, D] tile of E as TMA lands it (128-byte boxes, or one
// dense box under 128 bytes a row); [P, N] states are such tiles, P = Q.
template <typename E, int D>
__host__ __device__ constexpr int tile_bytes() {
  return Q * D * (int)sizeof(E);
}
template <typename E, int D>
__host__ __device__ constexpr int box_elems() {
  return D * (int)sizeof(E) >= 128 ? 128 / (int)sizeof(E) : D;
}

// Element (r, c) of a TMA-landed [rows, D] tile of E, as fp32.
template <typename E, int D>
__device__ __forceinline__ float rd(const uint8_t* tile, int r, int c) {
  constexpr int SZ = (int)sizeof(E);
  if constexpr (D * SZ >= 128) {
    constexpr int IN = 128 / SZ;
    const int off = (c % IN) * SZ;
    return to_f(*reinterpret_cast<const E*>(
        tile + (c / IN) * (Q * 128) + r * 128 +
        ((((off >> 4) ^ (r & 7)) << 4) | (off & 15))));
  } else {
    return to_f(reinterpret_cast<const E*>(tile)[r * D + c]);
  }
}

// Elements (r, c..c+3) of such a tile (c a multiple of 4): one 16-byte
// (fp32) or 8-byte (bf16) load.
template <typename E, int D>
__device__ __forceinline__ float4 rd4(const uint8_t* tile, int r, int c) {
  constexpr int SZ = (int)sizeof(E);
  const uint8_t* p;
  if constexpr (D * SZ >= 128) {
    constexpr int IN = 128 / SZ;
    const int off = (c % IN) * SZ;
    p = tile + (c / IN) * (Q * 128) + r * 128 +
        ((((off >> 4) ^ (r & 7)) << 4) | (off & 15));
  } else {
    p = tile + (r * D + c) * SZ;
  }
  if constexpr (SZ == 4) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
}
// (r..r+3, c) of such a tile: the transposed read, four loads.
template <typename E, int D>
__device__ __forceinline__ float4 rd4t(const uint8_t* tile, int r, int c) {
  return make_float4(rd<E, D>(tile, r, c), rd<E, D>(tile, r + 1, c),
                     rd<E, D>(tile, r + 2, c), rd<E, D>(tile, r + 3, c));
}

// The consumers' barrier (named barrier 1): both warpgroups.
__device__ __forceinline__ void cbar() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
// This warpgroup's barrier (named barriers 2 and 3).
__device__ __forceinline__ void wgbar() {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + (int)(threadIdx.x >> 7))
               : "memory");
}
// Shared-memory writes of this thread visible to the async proxy (wgmma).
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- wgmma m64nWk16 bf16 with A in registers (W 64 or 16): the
// accumulator element 4j + e of a thread (warp w of the warpgroup, lane
// 4g + t) is (row 16w + g + 8(e >> 1), column 8j + 2t + (e & 1)).
__device__ __forceinline__ void wg_bf16(float (&d)[32], const uint32_t (&a)[4],
                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wg_bf16(float (&d)[8], const uint32_t (&a)[4],
                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// threadIdx.x, read anew at each call: the compiler cannot hoist what is
// computed from it out of a block's walk over tiles, so a step's fill and
// fragment addresses are computed where they are used, not held in
// registers from tile to tile (which spilled, PERF.md).
__device__ __forceinline__ int tidx() {
  int r;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(r));
  return r;
}

// x = hi + lo, both bf16 (lo the rounded remainder).
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}

// An op block's rows are 128 bytes (up to 64 of K); a slot holds the hi
// and lo parts of 64 rows.
constexpr int OPROW = 128;
constexpr int SLOT = 2 * 64 * OPROW;

// A warpgroup's op slots (SLOTS of them, filled in turn).
struct Ring {
  uint8_t* base;
  int step;
};
template <int SLOTS>
__device__ __forceinline__ Ring wg_ring(uint8_t* rings) {
  return Ring{rings + (threadIdx.x >> 7) * SLOTS * SLOT, 0};
}

// One step of a product on this warpgroup's op slots.  The op block [W x
// KB] (W output columns, KB of the reduction, K-major) is filled from
// fill(n, k) (the four elements (n, k..k+3) as a float4) by the
// warpgroup's 128 threads into its next slot, split as it is written
// when BS (an fp32 factor); then the warpgroup issues acc += A[:, 0 :
// KB].op, A's elements a(r, k) read in registers and split when AS.
// COLS: the fill's source is read down its columns (threads take
// consecutive n), else along its rows (consecutive k).  Issued, not
// awaited: the caller waits (wg_done) before reading acc.  With two slots
// a step fills one while the other's products run; with one it first
// waits for them.
template <int W, int KB, bool AS, bool BS, int SLOTS, bool COLS, typename FF,
          typename FA>
__device__ __forceinline__ void wg_step(Ring& ring, float (&acc)[W / 2],
                                        FF fill, FA a) {
  static_assert(KB * 2 <= OPROW && KB % 16 == 0 && (W == 64 || W == 16),
                "op block");
  const int tx = tidx();
  uint8_t* hi = ring.base + (SLOTS == 2 ? (ring.step & 1) * SLOT : 0);
  uint8_t* lo = hi + 64 * OPROW;
  ++ring.step;
  if constexpr (SLOTS == 1) wgmma_wait<0>();
  wgbar();   // no product of this warpgroup reads the slot any more
  constexpr int QK = KB / 4, QUADS = W * QK;
#pragma unroll
  for (int q0 = 0; q0 < QUADS; q0 += 128) {
    const int qd = q0 + (tx & 127);
    if (QUADS % 128 == 0 || qd < QUADS) {
      const int n = COLS ? qd % W : qd / QK, k = 4 * (COLS ? qd / W : qd % QK);
      const int kb = 2 * k;
      const int off = n * OPROW + ((((kb >> 4) ^ (n & 7))) << 4) + (kb & 15);
      const float4 v = fill(n, k);
      uint2 h, l;
      split_bf16(v.x, v.y, h.x, l.x);
      split_bf16(v.z, v.w, h.y, l.y);
      *reinterpret_cast<uint2*>(hi + off) = h;
      if constexpr (BS) *reinterpret_cast<uint2*>(lo + off) = l;
    }
  }
  fence_async();
  wgbar();
  if constexpr (SLOTS == 2) wgmma_wait<0>();   // the last step's products
  // are done: their A registers are free (a wgmma reads its registers
  // until it completes)
  const int wi = (tx >> 5) & 3;
  const int g = (tx & 31) >> 2, t = tx & 3;
  const int r0 = 16 * wi + g, r1 = r0 + 8;
  constexpr int STEPS = KB / 16;
  uint32_t ah[STEPS][4], al[STEPS][4];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int k = 16 * s + 2 * t;
    const float v[8] = {a(r0, k),     a(r0, k + 1), a(r1, k),     a(r1, k + 1),
                        a(r0, k + 8), a(r0, k + 9), a(r1, k + 8), a(r1, k + 9)};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (AS) {
        split_bf16(v[2 * q], v[2 * q + 1], ah[s][q], al[s][q]);
      } else {
        ah[s][q] = pack_bf16(v[2 * q], v[2 * q + 1]);
        al[s][q] = 0u;
      }
    }
  }
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const uint64_t dh = sw128_desc(hi + 32 * s, 16, 1024);
    const uint64_t dl = sw128_desc(lo + 32 * s, 16, 1024);
    if constexpr (AS) wg_bf16(acc, al[s], dh);
    if constexpr (BS) wg_bf16(acc, ah[s], dl);
    wg_bf16(acc, ah[s], dh);
  }
  wgmma_commit();
}

// Wait for this warpgroup's products, then read acc.
template <int R>
__device__ __forceinline__ void wg_done(float (&acc)[R]) {
  wgmma_wait<0>();
  reg_fence(acc);
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// The output row and column of accumulator element i of a warpgroup.
__device__ __forceinline__ int acc_row(int i) {
  return 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2) +
         8 * ((i & 3) >> 1);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// Store the warpgroup's accumulator (value(i, row, col) for element i) at
// dst[row * ld + col0 + col] in T, rows at or past `rows` skipped; two
// adjacent columns a store.
template <typename T, int R, typename F>
__device__ __forceinline__ void store_acc(T* dst, long long ld, int col0,
                                          int rows, F value) {
#pragma unroll
  for (int i = 0; i < R; i += 2) {
    const int r = acc_row(i), c = col0 + acc_col(i);
    if (r >= rows) continue;
    const float v0 = value(i, r, c - col0), v1 = value(i + 1, r, c + 1 - col0);
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float2*>(reinterpret_cast<float*>(dst) + r * ld + c) =
          make_float2(v0, v1);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(
          reinterpret_cast<__nv_bfloat16*>(dst) + r * ld + c) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

// The two warpgroups hand one accumulator over through the fp32 [Q,
// WPITCH] buffer X: warpgroup 1 writes value(i, row, col) of its
// accumulator, warpgroup 0 reads it back at its own elements (the same
// layout).  Both call it; the first barrier keeps warpgroup 1 from
// writing while warpgroup 0 still reads the previous hand-over.
template <int R, typename F>
__device__ __forceinline__ void hand_over(float* X, F value) {
  cbar();
  if (threadIdx.x >= 128) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = acc_row(i), c = acc_col(i);
      X[r * WPITCH + c] = value(i, r, c);
    }
  }
  cbar();
}

// Sums over the lanes of a fragment: a row's 4 lanes (t), a column's 8
// lanes (g), in a fixed butterfly order.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}
__device__ __forceinline__ float col_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 4);
  v += __shfl_xor_sync(FULL, v, 8);
  return v + __shfl_xor_sync(FULL, v, 16);
}

// Tile t of the walk (heads fastest, then chunks, then batches) and its
// rows.
struct Tile {
  int c, h, bi, row0;
  long long bh;
  __device__ Tile(const WArgs& a, int t) {
    h = t % a.H;
    const int r = t / a.H;
    c = r % a.nc;
    bi = r / a.nc;
    row0 = c * Q;
    bh = (long long)bi * a.H + h;
  }
};

// The TMA boxes of one [Q, D] bf16 operand (4-d map over [b, S, heads,
// D]) into dst, completing on bar.
template <int D>
__device__ __forceinline__ void load_rows(uint8_t* dst, const CUtensorMap* m,
                                          uint64_t* bar, int head, int row0,
                                          int bi) {
  constexpr int IN = box_elems<bf16, D>();
#pragma unroll
  for (int i = 0; i < D / IN; ++i)
    tma_load_4d(dst + i * Q * 128, m, bar, i * IN, head, row0, bi);
}
// The boxes of one fp32 [P, N] state (2-d map over [rows, N]).
template <int N>
__device__ __forceinline__ void load_state(uint8_t* dst, const CUtensorMap* m,
                                           uint64_t* bar, long long row) {
  constexpr int IN = box_elems<float, N>();
#pragma unroll
  for (int i = 0; i < N / IN; ++i)
    tma_load_2d(dst + i * HP * 128, m, bar, i * IN, (int)row);
}

// The tile's per-row vectors, by the consumers: a barrier first (the
// previous tile's reads of them are done), dt (plain loads), then
// chunk_decay's terms (csrc/ssd_scan.cuh) into cum, ecum, el, wl and
// sc[0].
__device__ __forceinline__ void tile_vectors(float* dtv, const WArgs& a,
                                             const Tile& k) {
  cbar();
  if (threadIdx.x < Q) {
    const int row = k.row0 + threadIdx.x;
    dtv[threadIdx.x] =
        row < a.S ? a.dt[k.bi * a.dts.b + row * a.dts.s + k.h * a.dts.h] : 0.f;
  }
  cbar();
  chunk_decay<Q>(dtv, a.A[k.h], dtv + Q, dtv + 2 * Q, dtv + 3 * Q,
                 dtv + 4 * Q, dtv + 5 * Q);
  cbar();
}

// Shared memory around the op slots: `base` bytes (1024-aligned) of
// stages, buffers, vectors and barriers, then each warpgroup's slots.  Two
// slots a warpgroup where two blocks still fit an SM (or where one block
// fits either way), else one; and the blocks an SM then runs (each block
// also holds 1 KB of the SM's 228 KB).
constexpr int TWO_BLOCKS = 233472 / 2 - 1024;
__host__ __device__ constexpr int with_slots(int base, int slots) {
  return base + 2 * slots * SLOT + 1024;
}
__host__ __device__ constexpr int fit_slots(int base) {
  return with_slots(base, 2) <= TWO_BLOCKS   ? 2
         : with_slots(base, 1) <= TWO_BLOCKS ? 1
         : with_slots(base, 2) <= SMEM_LIMIT ? 2
                                              : 1;
}
__host__ __device__ constexpr int align1k(int b) { return (b + 1023) / 1024 * 1024; }

// The ring's depth: two stages, or one where the second stage would
// cost the SM its second block (G<N, ST> a phase's layout at ST stages;
// at state 16 the backward's chunk phase took 0.53 ms with two stages at
// one block an SM, 0.32 with one stage at two, PERF.md).
template <template <int, int> class G, int N>
__host__ __device__ constexpr int ring_depth() {
  return G<N, 2>::BLOCKS >= G<N, 1>::BLOCKS ? 2 : 1;
}

// A ring of ST stages: its barriers full[ST] then empty[ST], at `at`.
// Tile i of a block's walk uses stage i % ST for the (i / ST)-th time.
template <int ST>
struct RingBars {
  uint64_t* full;
  __device__ explicit RingBars(uint8_t* at)
      : full(reinterpret_cast<uint64_t*>(at)) {}
  // `more` barriers after the ring's (extra(0..)), all of one arrival
  __device__ void init(int more) const {
    if (threadIdx.x == 0) {
      for (int i = 0; i < 2 * ST + more; ++i) mbar_init(&full[i], 1);
      mbar_fence_init();
    }
    __syncthreads();
  }
  __device__ uint64_t* filled(int i) const { return &full[i % ST]; }
  __device__ uint64_t* extra(int j) const { return &full[2 * ST + j]; }
  // the producer's wait for tile i's stage to be free (its previous
  // tile's consumers arrived on empty)
  __device__ void wait_free(int i) const {
    if (i >= ST) mbar_wait(&full[ST + i % ST], ((i / ST) & 1) ^ 1);
  }
  __device__ void wait_full(int i) const {
    mbar_wait(&full[i % ST], (i / ST) & 1);
  }
  __device__ void release(int i) const { mbar_arrive(&full[ST + i % ST]); }
};


// ---------------------------------------------------------------------
// States phase, either direction.  Forward (BWD false): L_c = (x *
// w_last)^T.B into cstates[c + 1], or into the final state for the last
// chunk.  Backward: L'_c = (gy * e^cum)^T.C into the scratch's chunk c.
// [P, N] over the chunk's Q rows: A = (X * w)^T (split: an fp32 factor),
// the op block B^T (or C^T) [N, Q].  At N 128 warpgroup w owns columns
// [64 w, 64 w + 64); at N 16 it sums rows [32 w, 32 w + 32) and warpgroup
// 0 adds warpgroup 1's sum.  A stage: X [Q, P], then B (or C) [Q, N].
// ---------------------------------------------------------------------
template <int N, int ST>
struct StatesGeom {
  static constexpr int STAGES = ST;
  static constexpr int XT = tile_bytes<bf16, HP>();
  static constexpr int STAGE = XT + tile_bytes<bf16, N>();
  static constexpr int XB = ST * STAGE;
  static constexpr int VEC = XB + (N < 64 ? Q * WPITCH * 4 : 0);
  static constexpr int BAR = VEC + (5 * Q + 4) * 4;
  static constexpr int RING = align1k(BAR + 2 * ST * 8);
  static constexpr int SLOTS = fit_slots(RING);
  static constexpr int SMEM = with_slots(RING, SLOTS);
  static constexpr int BLOCKS = SMEM <= TWO_BLOCKS ? 2 : 1;
};
template <int N>
using StatesG = StatesGeom<N, ring_depth<StatesGeom, N>()>;

// One tile of the consumers' walk (the i-th, tile t); returns the op
// slots' ring.
template <int N, bool BWD>
__device__ __forceinline__ Ring states_tile(const WArgs& a, uint8_t* smem,
                                         Ring ring, int t, int i) {
  using G = StatesG<N>;
  const RingBars<G::STAGES> bars(smem + G::BAR);
  float* Xb = reinterpret_cast<float*>(smem + G::XB);
  float* dtv = reinterpret_cast<float*>(smem + G::VEC);
  const float* wv = dtv + (BWD ? 2 : 4) * Q;   // e^cum or w_last
  const int w2 = threadIdx.x >> 7;
  const Tile k(a, t);
  const uint8_t* Xs = smem + (i % G::STAGES) * G::STAGE;
  const uint8_t* Ws = Xs + G::XT;
  tile_vectors(dtv, a, k);
  float* dst = BWD ? a.scratch + (k.bh * a.nc + k.c) * HP * N
               : k.c + 1 < a.nc ? a.cstates + (k.bh * a.nc + k.c + 1) * HP * N
                                : a.state + k.bh * HP * N;
  bars.wait_full(i);
  if constexpr (N >= 64) {
    const int n0 = 64 * w2;
    float acc[32];
    zero(acc);
    wg_step<64, 64, true, false, G::SLOTS, true>(
        ring, acc, [&](int n, int j) { return rd4t<bf16, N>(Ws, j, n0 + n); },
        [&](int p, int j) { return rd<bf16, HP>(Xs, j, p) * wv[j]; });
    wg_done(acc);
    cbar();   // both warpgroups' reads of the stage are done
    if (threadIdx.x == 0) bars.release(i);
    store_acc<float, 32>(dst, N, n0, HP, [&](int e, int, int) { return acc[e]; });
  } else {
    const int j0 = 32 * w2;
    float acc[8];
    zero(acc);
    wg_step<16, 32, true, false, G::SLOTS, true>(
        ring, acc, [&](int n, int j) { return rd4t<bf16, N>(Ws, j0 + j, n); },
        [&](int p, int j) { return rd<bf16, HP>(Xs, j0 + j, p) * wv[j0 + j]; });
    wg_done(acc);
    hand_over<8>(Xb, [&](int e, int, int) { return acc[e]; });
    if (threadIdx.x == 0) bars.release(i);
    if (w2 == 0)
      store_acc<float, 8>(dst, N, 0, HP, [&](int e, int r, int c) {
        return acc[e] + Xb[r * WPITCH + c];
      });
  }
  return ring;
}

template <int N, bool BWD>
__device__ __forceinline__ void states_phase(const CUtensorMap* tX,
                                             const CUtensorMap* tW,
                                             const WArgs& a) {
  using G = StatesG<N>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const RingBars<G::STAGES> bars(smem + G::BAR);
  bars.init(0);
  if (threadIdx.x >= NCONS) {   // the producer
    if (threadIdx.x == NCONS) {
      int i = 0;
      for (int t = blockIdx.x; t < a.tiles; t += gridDim.x, ++i) {
        const Tile k(a, t);
        uint8_t* st = smem + (i % G::STAGES) * G::STAGE;
        uint64_t* bar = bars.filled(i);
        bars.wait_free(i);
        mbar_expect_tx(bar, G::STAGE);
        load_rows<HP>(st, tX, bar, k.h, k.row0, k.bi);
        load_rows<N>(st + G::XT, tW, bar, a.bc_head ? k.h : 0, k.row0, k.bi);
      }
    }
    return;
  }
  Ring ring = wg_ring<G::SLOTS>(smem + G::RING);
  int i = 0;
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x, ++i)
    ring = states_tile<N, BWD>(a, smem, ring, t, i);
}

// The states phase of each direction, named apart so that a profile
// tells them apart.
template <int N>
__global__ void __launch_bounds__(THREADS, StatesG<N>::BLOCKS)
ssd_fwd_wgmma_states_kernel(const __grid_constant__ CUtensorMap tX,
                            const __grid_constant__ CUtensorMap tW,
                            const WArgs a) {
  states_phase<N, false>(&tX, &tW, a);
}
template <int N>
__global__ void __launch_bounds__(THREADS, StatesG<N>::BLOCKS)
ssd_bwd_wgmma_states_kernel(const __grid_constant__ CUtensorMap tX,
                            const __grid_constant__ CUtensorMap tW,
                            const WArgs a) {
  states_phase<N, true>(&tX, &tW, a);
}

// ---------------------------------------------------------------------
// Forward, output phase.  y = W.x + e^cum * (C.S_c^T), W = tri(C.B^T *
// e^(cum_i - cum_j)) * dt_j, S_c = cstates[c].  Warpgroup 0: C.B^T, W,
// then W.x (W an fp32 factor); warpgroup 1 meanwhile C.S^T (S an fp32
// factor), handed over scaled by e^cum.  A stage: x, B, C, then S.
// ---------------------------------------------------------------------
template <int N, int ST>
struct OutGeom {
  static constexpr int STAGES = ST;
  static constexpr int XT = tile_bytes<bf16, HP>();
  static constexpr int B = XT;
  static constexpr int C = B + tile_bytes<bf16, N>();
  static constexpr int SS = C + tile_bytes<bf16, N>();   // S_c
  static constexpr int STAGE = SS + tile_bytes<float, N>();
  static constexpr int W = ST * STAGE;
  static constexpr int XB = W;   // W is spent when C.S^T is handed over
  static constexpr int VEC = W + Q * WPITCH * 4;
  static constexpr int BAR = VEC + (5 * Q + 4) * 4;
  static constexpr int RING = align1k(BAR + 2 * ST * 8);
  static constexpr int SLOTS = fit_slots(RING);
  static constexpr int SMEM = with_slots(RING, SLOTS);
  static constexpr int BLOCKS = SMEM <= TWO_BLOCKS ? 2 : 1;
};
template <int N>
using OutG = OutGeom<N, ring_depth<OutGeom, N>()>;

template <int N>
__device__ __forceinline__ Ring out_tile(const WArgs& a, uint8_t* smem, Ring ring,
                                      int t, int i) {
  using G = OutG<N>;
  constexpr int KN = N < 64 ? N : 64, SL = G::SLOTS;
  const RingBars<G::STAGES> bars(smem + G::BAR);
  float* Wm = reinterpret_cast<float*>(smem + G::W);
  float* Xb = reinterpret_cast<float*>(smem + G::XB);
  float* dtv = reinterpret_cast<float*>(smem + G::VEC);
  const float* cum = dtv + Q;
  const float* ecum = dtv + 2 * Q;
  const int grp = threadIdx.x >> 7;
  const Tile k(a, t);
  const uint8_t* xs = smem + (i % G::STAGES) * G::STAGE;
  const uint8_t* Bs = xs + G::B;
  const uint8_t* Cs = xs + G::C;
  const uint8_t* Ss = xs + G::SS;
  tile_vectors(dtv, a, k);
  float y[32];
  zero(y);
  bars.wait_full(i);
  if (grp == 0) {
    float cb[32];   // C.B^T: two bf16 inputs, one product
    zero(cb);
#pragma unroll
    for (int n0 = 0; n0 < N; n0 += KN)
      wg_step<Q, KN, false, false, SL, false>(
          ring, cb, [&](int j, int n) { return rd4<bf16, N>(Bs, j, n0 + n); },
          [&](int r, int n) { return rd<bf16, N>(Cs, r, n0 + n); });
    wg_done(cb);
#pragma unroll
    for (int e = 0; e < 32; ++e) {   // W, zero above the diagonal
      const int r = acc_row(e), j = acc_col(e);
      Wm[r * WPITCH + j] = r >= j ? cb[e] * expf(cum[r] - cum[j]) * dtv[j] : 0.f;
    }
    wgbar();   // W is in for the warpgroup
    wg_step<HP, Q, true, false, SL, true>(
        ring, y, [&](int p, int j) { return rd4t<bf16, HP>(xs, j, p); },
        [&](int r, int j) { return Wm[r * WPITCH + j]; });
  } else {
#pragma unroll
    for (int n0 = 0; n0 < N; n0 += KN)
      wg_step<HP, KN, false, true, SL, false>(
          ring, y, [&](int p, int n) { return rd4<float, N>(Ss, p, n0 + n); },
          [&](int r, int n) { return rd<bf16, N>(Cs, r, n0 + n); });
  }
  wg_done(y);
  hand_over<32>(Xb, [&](int e, int r, int) { return ecum[r] * y[e]; });
  if (threadIdx.x == 0) bars.release(i);
  if (grp == 0) {
    bf16* out = static_cast<bf16*>(a.y) +
                (((long long)k.bi * a.S + k.row0) * a.H + k.h) * HP;
    store_acc<bf16, 32>(out, (long long)a.H * HP, 0, a.S - k.row0,
                        [&](int e, int r, int p) {
                          return y[e] + Xb[r * WPITCH + p];
                        });
  }
  return ring;
}

template <int N>
__global__ void __launch_bounds__(THREADS, OutG<N>::BLOCKS)
ssd_fwd_wgmma_out_kernel(const __grid_constant__ CUtensorMap tx,
                         const __grid_constant__ CUtensorMap tB,
                         const __grid_constant__ CUtensorMap tC,
                         const __grid_constant__ CUtensorMap tS,
                         const WArgs a) {
  using G = OutG<N>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const RingBars<G::STAGES> bars(smem + G::BAR);
  bars.init(0);
  if (threadIdx.x >= NCONS) {   // the producer
    if (threadIdx.x == NCONS) {
      int i = 0;
      for (int t = blockIdx.x; t < a.tiles; t += gridDim.x, ++i) {
        const Tile k(a, t);
        const int hb = a.bc_head ? k.h : 0;
        uint8_t* st = smem + (i % G::STAGES) * G::STAGE;
        uint64_t* bar = bars.filled(i);
        bars.wait_free(i);
        mbar_expect_tx(bar, G::STAGE);
        load_rows<N>(st + G::C, &tC, bar, hb, k.row0, k.bi);
        load_rows<N>(st + G::B, &tB, bar, hb, k.row0, k.bi);
        load_state<N>(st + G::SS, &tS, bar, (k.bh * a.nc + k.c) * HP);
        load_rows<HP>(st, &tx, bar, k.h, k.row0, k.bi);
      }
    }
    return;
  }
  Ring ring = wg_ring<G::SLOTS>(smem + G::RING);
  int i = 0;
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x, ++i)
    ring = out_tile<N>(a, smem, ring, t, i);
}

// ---------------------------------------------------------------------
// Backward, chunk phase.  Per chunk, from dS1_c (the scratch) and S0 =
// cstates[c], the reference's products (ssd.cu's ssd_bwd_chunk_kernel):
//   cb = C.B^T, dW = gy.x^T; W = tri(cb e^..) dt_j, D = tri(dW e^..) dt_j,
//   X = tri(dW e^..) cb (kept only as its row and column sums);
//   dx = W^T.gy + w_last (B.dS1^T);  dB = D^T.C + w_last (x.dS1);
//   dC = D.B + e^cum (gy.S0);
// then cum's cotangent, ddt and the chunk's dA partial (warp 0).  The two
// warpgroups run the products in pairs: warpgroup 0 dW, W^T.gy, D^T.C and
// D.B (W, D fp32 factors); warpgroup 1 C.B^T, B.dS1^T, x.dS1 and gy.S0
// (dS1, S0 fp32 factors) with the row sums of the last two against B and
// C, each handed over (scaled by w_last or e^cum) for warpgroup 0 to add
// and store.  A stage: x, gy, B, C; the states' buffer beside the ring
// (dS1, then S0); the producer warp's sum(dS1 * S0) in sums[i & 1].
// ---------------------------------------------------------------------
template <int N, int ST>
struct BwdGeom {
  static constexpr int STAGES = ST;
  static constexpr int XT = tile_bytes<bf16, HP>();
  static constexpr int GY = XT;
  static constexpr int B = 2 * XT;
  static constexpr int C = B + tile_bytes<bf16, N>();
  static constexpr int STAGE = C + tile_bytes<bf16, N>();
  static constexpr int STATE = ST * STAGE;
  static constexpr int W = STATE + tile_bytes<float, N>();
  static constexpr int D = W + Q * WPITCH * 4;
  // the hand-overs go through W's buffer: cb's becomes W in place, the
  // later ones come after W^T.gy
  static constexpr int XB = W;
  static constexpr int VEC = D + Q * WPITCH * 4;
  // dtv cum ecum el wl rX cX dwv rsg rXp dwp rsgp; cXp[4][Q]; sc[4]
  static constexpr int BAR = VEC + (16 * Q + 4) * 4;
  // the ring's, then ds_full, s0_full, ds_free, s0_free
  static constexpr int RING = align1k(BAR + (2 * ST + 4) * 8);
  static constexpr int SLOTS = fit_slots(RING);
  static constexpr int SMEM = with_slots(RING, SLOTS);
  static constexpr int BLOCKS = SMEM <= TWO_BLOCKS ? 2 : 1;
};
template <int N>
using BwdG = BwdGeom<N, ring_depth<BwdGeom, N>()>;

template <int N>
__device__ __forceinline__ Ring bwd_tile(const WArgs& a, uint8_t* smem, Ring ring,
                                      int t, int i) {
  using G = BwdG<N>;
  constexpr int KN = N < 64 ? N : 64, SL = G::SLOTS;
  constexpr int NB = N < 64 ? N : 64, RB = NB / 2;   // dB / dC column blocks
  const RingBars<G::STAGES> bars(smem + G::BAR);
  uint8_t* Ss = smem + G::STATE;
  float* Wm = reinterpret_cast<float*>(smem + G::W);
  float* Dm = reinterpret_cast<float*>(smem + G::D);
  float* Xb = reinterpret_cast<float*>(smem + G::XB);
  float* dtv = reinterpret_cast<float*>(smem + G::VEC);
  float* cum = dtv + Q;
  float* ecum = cum + Q;
  float* el = ecum + Q;
  float* wl = el + Q;
  float* sc = wl + Q;       // [4]: e^cum_Q; sums[2] of the producer's
  float* sums = sc + 2;
  float* rX = sc + 4;       // sum_j X[i][j] dt_j
  float* cX = rX + Q;       // sum_i X[i][j]
  float* dwv = cX + Q;      // d(w_last)
  float* rsg = dwv + Q;     // rowsum(gy.S0 * C) e^cum
  float* rXp = rsg + Q;     // a warp's row sums (before the store)
  float* dwp = rXp + Q;
  float* rsgp = dwp + Q;
  float* cXp = rsgp + Q;    // [4][Q]: a warp's share of a column sum
  uint64_t *ds_full = bars.extra(0), *s0_full = bars.extra(1),
           *ds_free = bars.extra(2), *s0_free = bars.extra(3);
  const int S = a.S, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = tid >> 7;
  const Tile k(a, t);
  const uint8_t* xs = smem + (i % G::STAGES) * G::STAGE;
  const uint8_t* gs = xs + G::GY;
  const uint8_t* Bs = xs + G::B;
  const uint8_t* Cs = xs + G::C;
  tile_vectors(dtv, a, k);
  const float A = a.A[k.h];
  const long long row_off = ((long long)k.bi * S + k.row0) * a.H + k.h;
  const int rows = S - k.row0;
  bars.wait_full(i);
  // dW = gy.x^T (warpgroup 0) and cb = C.B^T (warpgroup 1), [Q, Q]
  float q[32];
  zero(q);
  if (grp == 0) {
    wg_step<Q, HP, false, false, SL, false>(
        ring, q, [&](int j, int p) { return rd4<bf16, HP>(xs, j, p); },
        [&](int r, int p) { return rd<bf16, HP>(gs, r, p); });
  } else {
#pragma unroll
    for (int n0 = 0; n0 < N; n0 += KN)
      wg_step<Q, KN, false, false, SL, false>(
          ring, q, [&](int j, int n) { return rd4<bf16, N>(Bs, j, n0 + n); },
          [&](int r, int n) { return rd<bf16, N>(Cs, r, n0 + n); });
  }
  wg_done(q);
  hand_over<32>(Xb, [&](int e, int, int) { return q[e]; });
  float acc[32];
  zero(acc);
  if (grp == 0) {
    {  // W, D and X's row and column sums (the decay overflows above
       // the diagonal)
      float rs[2] = {0.f, 0.f}, cs[16];
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = acc_row(e), j = acc_col(e);
        const float cb = Xb[r * WPITCH + j];
        float w = 0.f, d = 0.f, xm = 0.f;
        if (r >= j) {
          const float decay = expf(cum[r] - cum[j]);
          const float dwd = q[e] * decay;
          w = cb * decay * dtv[j];
          d = dwd * dtv[j];
          xm = dwd * cb;
        }
        Wm[r * WPITCH + j] = w;
        Dm[r * WPITCH + j] = d;
        rs[(e & 3) >> 1] += xm * dtv[j];
        const int ci = (e >> 2) * 2 + (e & 1);
        cs[ci] = (e & 2) ? cs[ci] + xm : xm;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float r = quad_sum(rs[h]);
        if ((lane & 3) == 0) rXp[acc_row(2 * h)] = r;
      }
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float v = col_sum(cs[c]);
        if (lane < 4) cXp[(warp & 3) * Q + acc_col((c >> 1) * 4 + (c & 1))] = v;
      }
    }
    wgbar();   // W and D are in for the warpgroup
    // dx: W^T.gy
    wg_step<HP, Q, true, false, SL, true>(
        ring, acc, [&](int p, int r) { return rd4t<bf16, HP>(gs, r, p); },
        [&](int j, int r) { return Wm[r * WPITCH + j]; });
  } else {
    // dx: B.dS1^T
    mbar_wait(ds_full, i & 1);
#pragma unroll
    for (int n0 = 0; n0 < N; n0 += KN)
      wg_step<HP, KN, false, true, SL, false>(
          ring, acc, [&](int p, int n) { return rd4<float, N>(Ss, p, n0 + n); },
          [&](int j, int n) { return rd<bf16, N>(Bs, j, n0 + n); });
  }
  wg_done(acc);
  hand_over<32>(Xb, [&](int e, int j, int) { return acc[e] * wl[j]; });
  if (grp == 0)
    store_acc<bf16, 32>(static_cast<bf16*>(a.dx) + row_off * HP,
                        (long long)a.H * HP, 0, rows, [&](int e, int j, int p) {
                          return acc[e] + Xb[j * WPITCH + p];
                        });
  // dB = D^T.C + w_last (x.dS1); d(w_last) = rowsum(x.dS1 * B)
  float rsum[2] = {0.f, 0.f};
#pragma unroll 1
  for (int n0 = 0; n0 < N; n0 += NB) {
    float d[RB];
    zero(d);
    if (grp == 0) {
      wg_step<NB, Q, true, false, SL, true>(
          ring, d, [&](int n, int r) { return rd4t<bf16, N>(Cs, r, n0 + n); },
          [&](int j, int r) { return Dm[r * WPITCH + j]; });
    } else {
      wg_step<NB, HP, false, true, SL, true>(
          ring, d, [&](int n, int p) { return rd4t<float, N>(Ss, p, n0 + n); },
          [&](int j, int p) { return rd<bf16, HP>(xs, j, p); });
    }
    wg_done(d);
    if (grp == 1) {
#pragma unroll
      for (int e = 0; e < RB; ++e)
        rsum[(e & 3) >> 1] += d[e] * rd<bf16, N>(Bs, acc_row(e), n0 + acc_col(e));
    }
    hand_over<RB>(Xb, [&](int e, int j, int) { return d[e] * wl[j]; });
    if (grp == 0)
      store_acc<bf16, RB>(static_cast<bf16*>(a.dB) + row_off * N,
                          (long long)a.H * N, n0, rows,
                          [&](int e, int j, int n) {
                            return d[e] + Xb[j * WPITCH + n];
                          });
  }
  if (grp == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float r = quad_sum(rsum[h]);
      if ((lane & 3) == 0) dwp[acc_row(2 * h)] = r;
    }
  }
  cbar();   // every read of dS1 is done: S0 replaces it
  if (tid == 0) mbar_arrive(ds_free);
  // dC = D.B + e^cum (gy.S0); rowsum(gy.S0 * C)
  rsum[0] = rsum[1] = 0.f;
#pragma unroll 1
  for (int n0 = 0; n0 < N; n0 += NB) {
    float d[RB];
    zero(d);
    if (grp == 0) {
      wg_step<NB, Q, true, false, SL, true>(
          ring, d, [&](int n, int j) { return rd4t<bf16, N>(Bs, j, n0 + n); },
          [&](int r, int j) { return Dm[r * WPITCH + j]; });
    } else {
      mbar_wait(s0_full, i & 1);
      wg_step<NB, HP, false, true, SL, true>(
          ring, d, [&](int n, int p) { return rd4t<float, N>(Ss, p, n0 + n); },
          [&](int r, int p) { return rd<bf16, HP>(gs, r, p); });
    }
    wg_done(d);
    if (grp == 1) {
#pragma unroll
      for (int e = 0; e < RB; ++e)
        rsum[(e & 3) >> 1] += d[e] * rd<bf16, N>(Cs, acc_row(e), n0 + acc_col(e));
    }
    hand_over<RB>(Xb, [&](int e, int r, int) { return d[e] * ecum[r]; });
    if (grp == 0)
      store_acc<bf16, RB>(static_cast<bf16*>(a.dC) + row_off * N,
                          (long long)a.H * N, n0, rows,
                          [&](int e, int r, int n) {
                            return d[e] + Xb[r * WPITCH + n];
                          });
  }
  if (grp == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float r = quad_sum(rsum[h]);
      if ((lane & 3) == 0) rsgp[acc_row(2 * h)] = r;
    }
  }
  cbar();   // every read of the stage and of S0 is done
  if (tid == 0) {
    mbar_arrive(s0_free);
    bars.release(i);
  }
  if (tid < Q) {                 // the partial sums, in a fixed order
    rX[tid] = rXp[tid];
    dwv[tid] = dwp[tid];
    rsg[tid] = rsgp[tid] * ecum[tid];
  } else if (tid < 2 * Q) {
    const int j = tid - Q;
    cX[j] = ((cXp[j] + cXp[Q + j]) + cXp[2 * Q + j]) + cXp[3 * Q + j];
  }
  cbar();
  if (tid < 32) {                // the cum cotangent, ddt and dA (warp 0)
    const int l = tid;           // rows 2l, 2l + 1
    float dc[2], v[2], vs = 0.f;
#pragma unroll
    for (int q2 = 0; q2 < 2; ++q2) {
      const int r = 2 * l + q2;
      v[q2] = dwv[r] * wl[r];
      dc[q2] = rX[r] - dtv[r] * cX[r] + rsg[r] - v[q2];
      vs += v[q2];
    }
    for (int o = 16; o > 0; o >>= 1) vs += __shfl_xor_sync(FULL, vs, o);
    if (l == 31) dc[1] += sums[i & 1] * sc[0] + vs;   // cum_Q's own terms
    // da_r = sum_{r' >= r} dcum_r': a suffix scan over the lanes
    float s = dc[0] + dc[1];
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_down_sync(FULL, s, o);
      if (l + o < 32) s += u;
    }
    float after = __shfl_down_sync(FULL, s, 1);
    if (l == 31) after = 0.f;
    float da[2];
    da[1] = after + dc[1];
    da[0] = da[1] + dc[0];
    float dap = 0.f;
#pragma unroll
    for (int q2 = 0; q2 < 2; ++q2) {
      const int r = 2 * l + q2, row = k.row0 + r;
      dap += da[q2] * dtv[r];
      if (row < S)
        a.ddt[((long long)k.bi * S + row) * a.H + k.h] =
            cX[r] + dwv[r] * el[r] + da[q2] * A;
    }
    for (int o = 16; o > 0; o >>= 1) dap += __shfl_xor_sync(FULL, dap, o);
    if (l == 0) a.dA_part[k.bh * a.nc + k.c] = dap;
  }
  return ring;
}

template <int N>
__global__ void __launch_bounds__(THREADS, BwdG<N>::BLOCKS)
ssd_bwd_wgmma_chunk_kernel(const __grid_constant__ CUtensorMap tx,
                           const __grid_constant__ CUtensorMap tg,
                           const __grid_constant__ CUtensorMap tB,
                           const __grid_constant__ CUtensorMap tC,
                           const __grid_constant__ CUtensorMap tdS,
                           const __grid_constant__ CUtensorMap tS0,
                           const WArgs a) {
  using G = BwdG<N>;
  constexpr int ST = G::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Ss = smem + G::STATE;
  float* sums = reinterpret_cast<float*>(smem + G::VEC) + 5 * Q + 2;
  const RingBars<ST> bars(smem + G::BAR);
  uint64_t *ds_full = bars.extra(0), *s0_full = bars.extra(1),
           *ds_free = bars.extra(2), *s0_free = bars.extra(3);
  bars.init(4);
  if (threadIdx.x >= NCONS) {   // the producer warp
    const int pl = threadIdx.x - NCONS;
    const CUtensorMap *px = &tx, *pg = &tg, *pB = &tB, *pC = &tC;
    auto issue = [&](int j, int tt) {   // tile tt, the walk's j-th
      const Tile k(a, tt);
      const int hb = a.bc_head ? k.h : 0;
      uint8_t* st = smem + (j % ST) * G::STAGE;
      uint64_t* bar = bars.filled(j);
      bars.wait_free(j);
      mbar_expect_tx(bar, G::STAGE);
      load_rows<HP>(st + G::GY, pg, bar, k.h, k.row0, k.bi);
      load_rows<HP>(st, px, bar, k.h, k.row0, k.bi);
      load_rows<N>(st + G::C, pC, bar, hb, k.row0, k.bi);
      load_rows<N>(st + G::B, pB, bar, hb, k.row0, k.bi);
    };
    // the ring runs ST - 1 tiles ahead of the states' buffer
    for (int j = 0; j + 1 < ST; ++j)
      if (pl == 0 && (int)(blockIdx.x + j * gridDim.x) < a.tiles)
        issue(j, blockIdx.x + j * gridDim.x);
    int i = 0;
    for (int t = blockIdx.x; t < a.tiles; t += gridDim.x, ++i) {
      const int ahead = t + (ST - 1) * (int)gridDim.x;
      if (pl == 0 && ahead < a.tiles) issue(i + ST - 1, ahead);
      const Tile k(a, t);
      const long long srow = (k.bh * a.nc + k.c) * HP;   // the states' row
      if (pl == 0) {
        if (i > 0) mbar_wait(s0_free, (i - 1) & 1);   // the last S0 is spent
        mbar_expect_tx(ds_full, tile_bytes<float, N>());
        load_state<N>(Ss, &tdS, ds_full, srow);
      }
      // sum(dS1 * S0) while the consumers run: dS1 in shared memory, S0
      // from global memory, in a fixed order
      mbar_wait(ds_full, i & 1);
      const float* s0 = a.cstates_in + srow * N;
      float part = 0.f;
#pragma unroll 4
      for (int e = 4 * pl; e < HP * N; e += 128) {
        const float4 d = rd4<float, N>(Ss, e / N, e % N);
        const float4 v = *reinterpret_cast<const float4*>(s0 + e);
        part += (d.x * v.x + d.y * v.y) + (d.z * v.z + d.w * v.w);
      }
      for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(FULL, part, o);
      if (pl == 0) {
        sums[i & 1] = part;
        mbar_wait(ds_free, i & 1);     // the consumers are done with dS1
        mbar_expect_tx(s0_full, tile_bytes<float, N>());
        load_state<N>(Ss, &tS0, s0_full, srow);
      }
    }
    return;
  }
  Ring ring = wg_ring<G::SLOTS>(smem + G::RING);
  int i = 0;
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x, ++i)
    ring = bwd_tile<N>(a, smem, ring, t, i);
}

// ---- host ----
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int grid, int smem, cudaStream_t stream,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// The persistent grid: every tile, at most `per_sm` blocks an SM.
int grid_of(int tiles, int per_sm) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms <= 0)
    return tiles;
  return tiles < sms * per_sm ? tiles : sms * per_sm;
}

// The tensor map of a bf16 operand (spec from kernels/tma.py::ssd_maps,
// rank 4): the 128-byte swizzle where its box is 128 bytes wide.
inline int encode_operand(CUtensorMap* m, const void* base,
                          const long long* spec) {
  return encode_map(m, base, 4, spec, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    spec[7] * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                       : CU_TENSOR_MAP_SWIZZLE_NONE);
}

// The tensor map of a contiguous fp32 state tensor [b, H, nc, P, N] as
// [b H nc P, N] rows: boxes of 32 columns (128-byte swizzle) at N 128,
// one dense box of 16 at N 16; P rows a box.
inline int encode_states(CUtensorMap* m, const void* base, long long rows,
                         int N) {
  const long long box = N * 4 >= 128 ? 32 : N;
  const long long spec[5] = {N, rows, (long long)N * 4, box, HP};
  return encode_map(m, base, 2, spec, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                    box * 4 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                   : CU_TENSOR_MAP_SWIZZLE_NONE);
}

// The scan phase's arguments (csrc/ssd_scan.cuh) over `chunks`.
ScanArgs scan_args(const WArgs& a, float* chunks, const void* gstate) {
  return ScanArgs{a.dt,        a.A,       chunks,   a.state,
                  (const float*)gstate, a.dts.b, a.dts.s, a.dts.h,
                  a.S,         a.H,       a.nc};
}

template <int N>
int fwd_n(const CUtensorMap* m, const CUtensorMap& ts, const WArgs& a,
          cudaStream_t s) {
  using SG = StatesG<N>;
  using OG = OutG<N>;
  static_assert(SG::SMEM <= SMEM_LIMIT && OG::SMEM <= SMEM_LIMIT,
                "tiles exceed shared memory");
  int err = launch(ssd_fwd_wgmma_states_kernel<N>, grid_of(a.tiles, SG::BLOCKS),
                   SG::SMEM, s, m[0], m[1], a);
  if (err) return err;
  if ((err = launch_scan<HP, N, Q>(false, scan_args(a, a.cstates, nullptr),
                                   a.b, s)))
    return err;
  return launch(ssd_fwd_wgmma_out_kernel<N>, grid_of(a.tiles, OG::BLOCKS),
                OG::SMEM, s, m[0], m[1], m[2], ts, a);
}

template <int N>
int bwd_n(const CUtensorMap* m, const CUtensorMap& tds, const CUtensorMap& ts0,
          const WArgs& a, const void* gstate, cudaStream_t s) {
  using SG = StatesG<N>;
  using BG = BwdG<N>;
  static_assert(SG::SMEM <= SMEM_LIMIT && BG::SMEM <= SMEM_LIMIT,
                "tiles exceed shared memory");
  // m: x, B, C, gy
  int err = launch(ssd_bwd_wgmma_states_kernel<N>, grid_of(a.tiles, SG::BLOCKS),
                   SG::SMEM, s, m[3], m[2], a);
  if (err) return err;
  if ((err = launch_scan<HP, N, Q>(true, scan_args(a, a.scratch, gstate), a.b,
                                   s)))
    return err;
  return launch(ssd_bwd_wgmma_chunk_kernel<N>, grid_of(a.tiles, BG::BLOCKS),
                BG::SMEM, s, m[0], m[3], m[1], m[2], tds, ts0, a);
}

WArgs make_args(const void* dt, const void* A, int b, int S, int H,
                int dt_sb, int dt_ss, int dt_sh, int bc_head) {
  WArgs a = {};
  a.dt = (const float*)dt;
  a.A = (const float*)A;
  a.b = b;
  a.S = S;
  a.H = H;
  a.nc = (S + Q - 1) / Q;
  a.tiles = a.nc * H * b;
  a.dts = {dt_sb, dt_ss, dt_sh};
  a.bc_head = bc_head;
  return a;
}

// The operands' maps: `count` rank-4 specs of 11 numbers.
int encode_all(CUtensorMap* m, const void* const* bases, int count,
               const long long* maps) {
  for (int i = 0; i < count; ++i) {
    const int err = encode_operand(&m[i], bases[i], maps + 11 * i);
    if (err) return err;
  }
  return 0;
}

}  // namespace

extern "C" {

// x, B and C through the tensor maps of `maps` (kernels/tma.py::ssd_maps:
// three rank-4 specs of 11 numbers); bf16, P 64, chunk 64, N 16 or 128;
// bc_head 0 when B and C are one group over the heads (their maps then
// cover the group view and every head reads head coordinate 0).
int ssd_fwd_wgmma(const void* x, const void* dt, const void* A, const void* B,
                  const void* C, void* y, void* state, void* cstates, int b,
                  int S, int H, int N, int dt_sb, int dt_ss, int dt_sh,
                  int bc_head, const long long* maps, int dtype, void* stream) {
  if (b <= 0 || S <= 0 || H <= 0 || dtype != kBF16 || (N != 128 && N != 16))
    return (int)cudaErrorInvalidValue;
  WArgs a = make_args(dt, A, b, S, H, dt_sb, dt_ss, dt_sh, bc_head);
  a.y = y;
  a.state = (float*)state;
  a.cstates = (float*)cstates;
  CUtensorMap m[3], ts;
  const void* bases[3] = {x, B, C};
  int err = encode_all(m, bases, 3, maps);
  if (err) return err;
  if ((err = encode_states(&ts, cstates, (long long)b * H * a.nc * HP, N)))
    return err;
  cudaStream_t s = (cudaStream_t)stream;
  return N == 128 ? fwd_n<128>(m, ts, a, s) : fwd_n<16>(m, ts, a, s);
}

// x, B, C and gy through `maps` (four rank-4 specs); scratch: fp32 [b, H,
// nc, P, N], the wrapper's (dS1 per chunk on return).
int ssd_bwd_wgmma(const void* x, const void* dt, const void* A, const void* B,
                  const void* C, const void* cstates, const void* gy,
                  const void* gstate, void* dx, void* ddt, void* dB, void* dC,
                  void* dA_part, void* scratch, int b, int S, int H, int N,
                  int dt_sb, int dt_ss, int dt_sh, int bc_head,
                  const long long* maps, int dtype, void* stream) {
  if (b <= 0 || S <= 0 || H <= 0 || dtype != kBF16 || (N != 128 && N != 16))
    return (int)cudaErrorInvalidValue;
  WArgs a = make_args(dt, A, b, S, H, dt_sb, dt_ss, dt_sh, bc_head);
  a.cstates_in = (const float*)cstates;
  a.scratch = (float*)scratch;
  a.dx = dx;
  a.ddt = (float*)ddt;
  a.dB = dB;
  a.dC = dC;
  a.dA_part = (float*)dA_part;
  CUtensorMap m[4], tds, ts0;
  const void* bases[4] = {x, B, C, gy};
  int err = encode_all(m, bases, 4, maps);
  if (err) return err;
  const long long rows = (long long)b * H * a.nc * HP;
  if ((err = encode_states(&tds, scratch, rows, N))) return err;
  if ((err = encode_states(&ts0, cstates, rows, N))) return err;
  cudaStream_t s = (cudaStream_t)stream;
  return N == 128 ? bwd_n<128>(m, tds, ts0, a, gstate, s)
                  : bwd_n<16>(m, tds, ts0, a, gstate, s);
}

}  // extern "C"
