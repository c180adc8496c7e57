// Causal GQA flash attention: the C entry points (see flash.cuh for the
// kernels' design).  q has Sq rows and k, v Sk >= Sq, the queries the
// last Sq of the Sk positions.  Each validates its arguments, picks the
// 16-byte copies where every operand's rows allow them, and calls the
// launcher of its kernel and dtype with the caller's tile (the rows of
// the block of the kernel's grid: BQ of the forward and dq, BK of
// dk/dv); an unbuilt (head dim, tile) is refused.
#include "flash.cuh"

namespace {

using namespace flash_impl;

// The rows of one operand are 16-byte aligned: its base and its (batch,
// seq, head) strides.
bool rows16(const void* p, const Strides& st, int dtype) {
  const int w = dtype == kBF16 ? 8 : 4;   // elements per 16 bytes
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % w == 0 &&
         st.s % w == 0 && st.h % w == 0;
}

int dispatch(Kind kind, int D, int tile, int dtype, FlashArgs& a,
             void* stream) {
  if (a.B <= 0 || a.Sq <= 0 || a.Sk < a.Sq || a.H <= 0 || a.KV <= 0 ||
      a.H % a.KV != 0 || a.window < 0)
    return (int)cudaErrorInvalidValue;
  a.vec = rows16(a.q, a.qs, dtype) && rows16(a.k, a.ks, dtype) &&
          rows16(a.v, a.vs, dtype) && (a.g == nullptr || rows16(a.g, a.gs, dtype));
  cudaStream_t s = (cudaStream_t)stream;
  const bool f32 = dtype == kF32;
  if (!f32 && dtype != kBF16) return (int)cudaErrorInvalidValue;
  static const Launcher launchers[3][2] = {   // [kind][dtype]
      {launch_fwd_f32, launch_fwd_bf16},
      {launch_dq_f32, launch_dq_bf16},
      {launch_dkdv_f32, launch_dkdv_bf16}};
  return launchers[kind][f32 ? 0 : 1](D, tile, a, s);
}

FlashArgs make_args(const void* q, const void* k, const void* v, int B, int Sq,
                    int Sk, int H, int KV, int window, float scale, int q_sb,
                    int q_ss, int q_sh, int k_sb, int k_ss, int k_sh,
                    int v_sb, int v_ss, int v_sh) {
  FlashArgs a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.B = B;
  a.Sq = Sq;
  a.Sk = Sk;
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
              int B, int Sq, int Sk, int H, int KV, int D, int window,
              float scale, int q_sb, int q_ss, int q_sh, int k_sb, int k_ss,
              int k_sh, int v_sb, int v_ss, int v_sh, int tile, int dtype,
              void* stream) {
  FlashArgs a = make_args(q, k, v, B, Sq, Sk, H, KV, window, scale, q_sb,
                          q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh);
  a.o = o;
  a.lse = (float*)lse;
  return dispatch(kFwd, D, tile, dtype, a, stream);
}

int flash_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                 const void* lse, const void* delta, void* dq, int B, int Sq,
                 int Sk, int H, int KV, int D, int window, float scale,
                 int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh,
                 int v_sb, int v_ss, int v_sh, int g_sb, int g_ss, int g_sh,
                 int tile, int dtype, void* stream) {
  FlashArgs a = make_args(q, k, v, B, Sq, Sk, H, KV, window, scale, q_sb,
                          q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh);
  a.g = g;
  a.gs = {g_sb, g_ss, g_sh};
  a.lse_in = (const float*)lse;
  a.delta = (const float*)delta;
  a.dq = dq;
  return dispatch(kDq, D, tile, dtype, a, stream);
}

int flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* g,
                   const void* lse, const void* delta, void* dk, void* dv,
                   int B, int Sq, int Sk, int H, int KV, int D, int window,
                   float scale, int q_sb, int q_ss, int q_sh, int k_sb,
                   int k_ss, int k_sh, int v_sb, int v_ss, int v_sh, int g_sb,
                   int g_ss, int g_sh, int tile, int dtype, void* stream) {
  FlashArgs a = make_args(q, k, v, B, Sq, Sk, H, KV, window, scale, q_sb,
                          q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh);
  a.g = g;
  a.gs = {g_sb, g_ss, g_sh};
  a.lse_in = (const float*)lse;
  a.delta = (const float*)delta;
  a.dk = dk;
  a.dv = dv;
  return dispatch(kDkdv, D, tile, dtype, a, stream);
}

}  // extern "C"
