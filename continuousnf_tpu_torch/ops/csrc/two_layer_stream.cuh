// The 2-layer tanh net of streamed K3 and K5: an MLP dz + nc -> H -> dz
// with dz <= kStreamMaxDz and any hidden width, in the streamed layout of
// chain_stream.cuh (n = 2, its weights left in global memory and streamed
// through the chunk buffer), evaluated by a block for a tile of T samples.
// nc = 0 but in the COND instances of streamed K3, streamed K5 and the
// streamed K4 adjoint (K8: W1's ys rows enter the pre-activation of h).
// Besides the weights: M[i, h] = W1[i, h] W2[h, i] (dz, H) row-major over
// W1's z rows, the closed-form trace's constant (fused_solve.py::
// _stage_test :484-503), built once per launch into a global scratch by the
// whole grid and then streamed like a weight (22,188 floats, 88.8 KB, at
// 86 -> 258 -> 86: L2-resident beside the weights).
// Precision: f32 FMA on the CUDA cores, no TF32 and no tensor cores.

#pragma once

#include "chain_stream.cuh"

namespace cnf {

// Whether the layout is a 2-layer chain of tanh layers (acts: bit i set where
// layer i is tanh).
inline bool stream_two_layer_tanh(const StreamLayout& L, int acts) { return L.n == 2 && (acts & 3) == 3; }

// m[i * H + h] = W1[i, h] W2[h, i] from the flat params, the grid's threads
// over the entries, then a grid barrier: every block reads all of M after it
// (stream_mm<true>, through the L2).  Every thread of the grid must call it.
// The entries i < dz read W1's z rows alone, its first dz rows: a COND
// layout's ys rows, after them, get no M (fused_solve.py::_stage_test's
// W1z).
__device__ inline void build_stream_m(const StreamLayout& L, const float* params, float* m) {
  const int dz = L.dz, H = L.width[1];
  const float* w1 = layer_w(L, params, 0);
  const float* w2 = layer_w(L, params, 1);
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < dz * H; idx += gridDim.x * blockDim.x) {
    const int i = idx / H, h = idx % H;
    m[idx] = __ldg(w1 + idx) * __ldg(w2 + (size_t)h * dz + i);
  }
  cg::this_grid().sync();
}

// The forward pass of a tile (fused_solve.py::_chain_fwd at N = 2): Z
// (T, zp) in; HS (T, hp) = h = tanh(Z W1 + b1) and DH = 1 - h^2, Y (T, zp) =
// y = tanh(h W2 + b2) and DY = 1 - y^2.  COND (fused_solve.py::_zin): the
// pre-activation of h adds W1's ys rows times YS (T, nc), after the z rows'
// sum, as stream_forward<true>.  Ends with a block barrier.
template <bool COND = false>
__device__ inline void stream_two_layer_forward(const StreamLayout& L, const float* params, const float* Z, int T,
                                                float* HS, float* DH, float* Y, float* DY, float* wc,
                                                [[maybe_unused]] const float* YS = nullptr) {
  const int hp = L.hp[1], zp = L.zp, H = L.width[1], dz = L.dz;
  stream_mm(Z, zp, dz, layer_w(L, params, 0), layer_b(L, params, 0), H, T, wc, [&](int t, int o, float a) {
    if constexpr (COND) {
      const int nc = stream_nc(L);
      const float* wy = layer_w(L, params, 0) + (size_t)dz * H;
      for (int c = 0; c < nc; ++c) a = fmaf(YS[t * nc + c], __ldg(wy + (size_t)c * H + o), a);
    }
    const float h = tanhf(a);
    HS[t * hp + o] = h;
    DH[t * hp + o] = 1.f - h * h;
  });
  stream_mm(HS, hp, H, layer_w(L, params, 1), layer_b(L, params, 1), dz, T, wc, [&](int t, int k, float a) {
    const float y = tanhf(a);
    Y[t * zp + k] = y;
    DY[t * zp + k] = 1.f - y * y;
  });
}

// MDH (T, zp) = DH M^T: (M dh)_i per row, the closed-form trace's vector.
// Ends with a block barrier.
__device__ inline void stream_m_dh(const StreamLayout& L, const float* m, const float* DH, int T, float* MDH,
                                   float* wc) {
  const int zp = L.zp;
  stream_mm_t<true>(DH, L.hp[1], L.width[1], m, L.dz, T, wc, [&](int t, int i, float a) { MDH[t * zp + i] = a; });
}

}  // namespace cnf
