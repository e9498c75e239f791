// The 2-layer tanh net of the wide 2-layer kernels (wide K3, wide K5 and the
// wide K4 adjoint): an MLP dz + nc -> H -> dz with dz <= kWideMaxDz and
// H <= kWideMaxWidth, in the wide chain layout of chain_wide.cuh (n = 2,
// its weights in shared memory at odd pitches), evaluated by a block for a
// tile of T samples through chain_wide.cuh's tile products.  nc = 0 but in
// the COND instances of wide K3, wide K5 and the wide K4 adjoint (K8: W1's
// ys rows enter the pre-activation).  Besides the weights:
// M[i, h] = W1[i, h] W2[h, i] (dz, pitch H | 1) over W1's z rows, the
// closed-form trace's constant (fused_solve.py::_stage_test :484-503), built
// once per launch beside them.
// Precision: f32 FMA on the CUDA cores, no TF32 and no tensor cores.

#pragma once

#include "chain_wide.cuh"

namespace cnf {

// Whether the layout is a 2-layer chain of tanh layers (acts: bit i set where
// layer i is tanh).
inline bool two_layer_tanh(const WideLayout& L, int acts) { return L.n == 2 && (acts & 3) == 3; }

// Floats of M in shared memory (dz rows at the pitch of W1), rounded up to 4.
__host__ __device__ inline int m_floats(const WideLayout& L) { return round_up(L.dz * L.pitch[0], 4); }

// M[i * pitch0 + h] = W1[i, h] W2[h, i] from the shared weights w (0 in the
// pad column).
__device__ inline void build_m(const WideLayout& L, const float* w, float* m) {
  const int dz = L.dz, H = L.width[1], p0 = L.pitch[0], p1 = L.pitch[1];
  const float* w1 = w + L.wofs[0];
  const float* w2 = w + L.wofs[1];
  for (int idx = threadIdx.x; idx < dz * p0; idx += blockDim.x) {
    const int i = idx / p0, h = idx % p0;
    m[idx] = h < H ? w1[i * p0 + h] * w2[h * p1 + i] : 0.f;
  }
}

// The forward pass of a tile (fused_solve.py::_chain_fwd at N = 2): Z
// (T, zp) in; HS (T, hp) = h = tanh(Z W1 + b1) and DH = 1 - h^2, Y (T, zp) =
// y = tanh(h W2 + b2) and DY = 1 - y^2.  Ends with a block barrier.
__device__ inline void two_layer_forward(const WideLayout& L, const float* w, const float* Z, int T, float* HS,
                                         float* DH, float* Y, float* DY) {
  const int hp = L.hp[1], zp = L.zp;
  tile_mm(Z, zp, L.dz, w + L.wofs[0], L.pitch[0], w + L.bofs[0], L.width[1], T, [&](int t, int o, float a) {
    const float h = tanhf(a);
    HS[t * hp + o] = h;
    DH[t * hp + o] = 1.f - h * h;
  });
  tile_mm(HS, hp, L.width[1], w + L.wofs[1], L.pitch[1], w + L.bofs[1], L.dz, T, [&](int t, int k, float a) {
    const float y = tanhf(a);
    Y[t * zp + k] = y;
    DY[t * zp + k] = 1.f - y * y;
  });
}

// two_layer_forward of a COND instance: the pre-activation of h adds W1's
// ys rows times YS (T, nc) (fused_solve.py::_zin).  Ends with a block
// barrier.
__device__ inline void two_layer_forward_cond(const WideLayout& L, const float* w, const float* Z, const float* YS,
                                              int T, float* HS, float* DH, float* Y, float* DY) {
  const int hp = L.hp[1], zp = L.zp, nc = wide_nc(L), p0 = L.pitch[0];
  const float* wy = wide_ys_rows(L, w);
  tile_mm(Z, zp, L.dz, w + L.wofs[0], p0, w + L.bofs[0], L.width[1], T, [&](int t, int o, float a) {
    for (int c = 0; c < nc; ++c) a = fmaf(YS[t * nc + c], wy[c * p0 + o], a);
    const float h = tanhf(a);
    HS[t * hp + o] = h;
    DH[t * hp + o] = 1.f - h * h;
  });
  tile_mm(HS, hp, L.width[1], w + L.wofs[1], L.pitch[1], w + L.bofs[1], L.dz, T, [&](int t, int k, float a) {
    const float y = tanhf(a);
    Y[t * zp + k] = y;
    DY[t * zp + k] = 1.f - y * y;
  });
}

// MDH (T, zp) = DH M^T: (M dh)_i per row, the closed-form trace's vector.
// Ends with a block barrier.
__device__ inline void m_dh(const WideLayout& L, const float* m, const float* DH, int T, float* MDH) {
  const int zp = L.zp;
  tile_mm_t(DH, L.hp[1], L.width[1], m, L.pitch[0], L.dz, T, [&](int t, int i, float a) { MDH[t * zp + i] = a; });
}

}  // namespace cnf
