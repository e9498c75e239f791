// The K2 chain form: the continuous-adjoint (backsolve) backward integration
// of a TRAIN-mode CNF whose field is a Dense chain of 2 to 4 tanh or identity
// layers with Hutchinson probes, the whole adaptive solve (any embedded
// explicit tableau, K9) from t_hi down to t_lo in one cooperative launch.
// Two instances: one reverse-mode probe (below), and the probe instance
// (K6, at the end) for K probes, reverse or forward mode.
//
// Replaces the TPU kernel built by continuousnf_tpu/ops/fused_solve.py::
// _make_adjoint_kernel (:1064-1343), launched by make_full_solve.adjoint_solve
// (pl.pallas_call at :1767), with the N-layer _stage_train_fwdbwd
// (:372-481) and, for a conditional net (K8), the ys rows of _zin (:265)
// and the ys-cotangent block of the adjoint kernel (:1110-1340).  The state
// is, per sample, z (dz), acc (3), a_z (dz), the constant a_acc (3) and, for
// a conditional net, a_ys (nc), plus the batch-summed parameter gradient g_p
// (P = sum_i in_i out_i + out_i floats; 4,998 at the tabular power6 width
// 6 -> 64 -> 64 -> 6).  Per sample and stage, the forward pass on
// h_0 = [z | ys], the probe pullback (keeping the cotangents u_l and the
// gated v_l; the probe has no ys rows), and the hand-derived VJP against
// (a_z, a_acc):
//   ascending the pullback chain, for layer i: ct_v = pu_i W_i,
//     pu_(i+1) = ct_v s'(h_(i+1)), ct_h(i+1) = -2 h_(i+1) (ct_v u_(i+1));
//   down the forward chain: ca_i = (ca_(i+1) W_(i+1)^T + ct_h(i+1)) (.) s',
//   with s' = 1 - h^2 for a tanh layer; an identity layer has s' = 1 and no
//   ct_h term (ChainLayout::act);
//     ct_z = ca_0 W_0z^T, and k_ays = -ct_ys = -ca_0 W_0y^T (the z and the
//     ys rows of W_0);
//   per-sample gradient of W_i: pu_i (x) v_i + h_i (x) ca_i, of b_i: ca_i;
//     the ys rows of W_0 get ys (x) ca_0 alone (pu_0 has no ys rows).
// The probes are Monte-Carlo constants: no eps cotangent is integrated.
// a_ys is a quadrature (its rate does not read it); its nc rows ride in
// adjoint_solve's (row, B) planes after a_z and enter the error norm.
//
// Controller: K2's (adjoint_solve of solve_common.cuh, shared with K2 and the
// K4 adjoint): one batch-global Hairer norm over B * (2 * (dz + 3) + nc) + P
// elements, g_p scaled by atol + rtol * max(|g_p|, |g_p_new|); per attempted
// step each block adds its samples' b- and btilde-weighted g_p rates into
// parity-indexed global partials, one grid.sync(), and every block sums all
// blocks' partials in block order.  The TPU package runs two batch tiles of
// 2048 at power6, B = 4096, each with its own controller; the port keeps the
// single-tile numerics, as for K2 and the K4 adjoint.
//
// Memory plan.  A sample's residuals (the activations, pu, v, u then ct_h,
// and ca of every level, and its ys: 4 DZ + 5 sum(hidden) + nc floats, 673
// at power6, 657 at the conditional recipe 2 -> 64 -> 64 -> 1) live in the
// thread's shared-memory slot; at 128 threads that is 345 KB, over the
// 227 KB a block may use, so the wrapper takes the largest of 128, 64 and 32
// threads that fits (64 at power6: 172 KB of slots and 37 KB of weights).
// g_p, its proposal and the block's FSAL and last-stage partials (4 P floats
// a block) live in block-owned global buffers (the K4 adjoint's layout:
// L2-resident), which leaves shared memory to the slots.
//
// What bounds it on the H100: latency.  A stage is about 29 k FMA per sample
// at power6 on one thread per sample (the forward pass, the pullback, its
// VJP and the forward chain's VJP: six passes of about 4.9 k), plus the
// block's outer-product pass (2 FMA per sample and gradient entry, 10 k per
// thread at 64 threads), plus one barrier and the all-blocks partials read
// (2 P G floats) per attempted step.
// Precision: f32 FMA on the CUDA cores, no TF32 and no tensor cores.
//
// The probe instance (K6): the N-layer _stage_train_fwdbwd with k_probes = K
// and jvp (the JVP branch :435-450).  K slot sets do not fit (673 floats a
// sample at power6 already force 64 threads a block), so the stage runs a
// sub-pass per probe with one slot set (adjoint_solve's PROBES form): after
// the forward pass, each probe's pass and its VJP leave that probe's
// vectors in the slot (for W_i: a_i (x) b_i) and the block adds their outer
// products, while the -2 h (.) gate terms are summed over the probes (in the
// block where ca was, and registers for the output layer); then the forward
// chain's VJP with ca over the v block (in_i (x) ca_i, the biases, ys (x)
// ca_0).  VJP: a_i = pu_i, b_i = v_i as above.  JVP, the pushforward
// t_1 = (eps W_0z) s'(h_1), t_(l+1) = (t_l W_l) s'(h_(l+1)), Je = (t W) s'(y),
// keeping u_l (pre-gate) and t_l (in the pu block), and its VJP down the
// chain: ct_u = ct_t s'(h) (the v block), ct_h += -2 h (ct_t u), ct_t of the
// level below = ct_u W^T: a_i = t_i (eps for i = 0), b_i = ct_u of level
// i + 1.  The slot keeps its size.  K and the direction are run-time values.

#include "chain_common.cuh"

namespace {

// The unroll factor of the solve loops over stored stages (solve_common.cuh),
// per instance the fastest of 1, 2, 4 and 8 on the H100 (PERF.md, PR 6).
template <bool COND>
constexpr int kStageUnroll = COND ? 2 : 4;

using cnf::axpy4;
using cnf::ChainLayout;
using cnf::ct_safe_norm;
using cnf::dot4;
using cnf::gate;
using cnf::kMaxBlock;
using cnf::kMaxLayers;
using cnf::kRedFloats;
using cnf::safe_norm_sq;

// Offsets in a thread's slot: four dz-vectors (z, pu_0, and v and ca of the
// last layer), then five hidden blocks (activations h, pullback cotangents
// pu, gated cotangents v, u then ct_h, and ca), then ys (nc floats), and for
// each layer where the gradient pass reads its four vectors.
// The probe instance's slot (`probes`) has the same size: the -2 h (.) sums
// (hc) where ca was, and ca over v.
struct Slot {
  int z, pu0, vl, cal, hs, pu, v, u, ca, hc, ys, size;
  int gin[kMaxLayers], gpu[kMaxLayers], gv[kMaxLayers], gca[kMaxLayers];
};

template <int DZ>
Slot make_slot(const ChainLayout& L, bool probes = false) {
  Slot m{};
  m.z = 0;
  m.pu0 = DZ;
  m.vl = 2 * DZ;
  m.cal = 3 * DZ;
  m.hs = 4 * DZ;
  m.pu = m.hs + L.hsum;
  m.v = m.pu + L.hsum;
  m.u = m.v + L.hsum;
  m.ca = m.u + L.hsum;
  m.ys = m.ca + L.hsum;
  m.size = (m.ys + L.nc) | 1;
  m.hc = m.ca;
  if (probes) m.ca = m.v;
  for (int i = 0; i < L.n; ++i) {
    m.gin[i] = i == 0 ? m.z : m.hs + L.hofs[i];
    m.gpu[i] = i == 0 ? m.pu0 : m.pu + L.hofs[i];
    m.gv[i] = i == L.n - 1 ? m.vl : m.v + L.hofs[i + 1];
    m.gca[i] = i == L.n - 1 ? m.cal : m.ca + L.hofs[i + 1];
  }
  return m;
}

struct AdjArgs {
  cnf::AdjState s;
  ChainLayout L;
  Slot m;
  const float* params;  // [W0 | b0 | W1 | b1 | ...]
  const float* eps;     // (B, dz) Hutchinson probe
  const float* ys;      // (B, nc) conditioning, null when nc = 0
  float* g;             // (P) the gradient, laid out as params
  float* gblk;          // [gridDim.x][4 P]: each block's g, g_new, FSAL and last-stage partials
  int norm_z, norm_j;
};

// One augmented stage of one sample (fused_solve.py::_stage_train_fwdbwd with
// ct_y = a_z, ct_r = a_acc): the field y and rates kr, k_az = -ct_z,
// k_ays = -ct_ys to kys[c * stride] (c < nc; the sample's ys already in the
// slot; a COND instance only), and the residuals of the outer-product pass
// left in the slot `sl`.
template <int DZ, bool COND>
__device__ void chain_adjoint_stage(const ChainLayout& L, const Slot& m, const float* w, float* sl, int norm_z,
                                    int norm_j, const float (&z)[DZ], const float (&az)[DZ],
                                    const float (&e)[DZ], const float (&aacc)[3], float (&kz)[DZ],
                                    float (&kr)[3], float (&kaz)[DZ], float* kys, size_t stride) {
  const int n = L.n;
  float* HS = sl + m.hs;
  float* PU = sl + m.pu;
  float* V = sl + m.v;
  float* U = sl + m.u;
  float* CA = sl + m.ca;
  const float* w0 = w + L.wofs[0];
  const float* wl = w + L.wofs[n - 1];
  const int hl = L.hofs[n - 1], wlast = L.width[n - 1];

  // Forward.  on_y: the output layer's activation; on_l: the last hidden
  // level's (layer n - 2).
  const int on_y = L.act[n - 1], on_l = L.act[n - 2];
  float y[DZ];
  cnf::chain_forward<DZ, COND>(L, w, z, sl + m.ys, HS, y);
  float vl[DZ], ysq = 0.f;
#pragma unroll
  for (int k = 0; k < DZ; ++k) {
    ysq = fmaf(y[k], y[k], ysq);
    vl[k] = e[k] * gate(y[k], on_y);
    sl[m.z + k] = z[k];
    sl[m.vl + k] = vl[k];
  }
  // The pullback, keeping u_l (U) and v_l (V) of every hidden level.
  for (int k = 0; k < wlast; ++k) {
    const float uk = dot4<DZ>(vl, wl + k * DZ), h = HS[hl + k];
    U[hl + k] = uk;
    V[hl + k] = uk * gate(h, on_l);
  }
  for (int i = n - 2; i >= 1; --i) {
    float* u = U + L.hofs[i];
    float* v = V + L.hofs[i];
    const float* h = HS + L.hofs[i];
    const int on = L.act[i - 1];
    cnf::mv_cols(V + L.hofs[i + 1], L.width[i + 1], w + L.tofs[i], L.tpitch[i], nullptr, L.width[i],
                 [&](int k, float a) {
                   u[k] = a;
                   v[k] = a * gate(h[k], on);
                 });
  }
  float eJ[DZ];
#pragma unroll
  for (int i = 0; i < DZ; ++i) eJ[i] = 0.f;
  for (int o = 0; o < L.width[1]; ++o) axpy4<DZ>(eJ, V[L.hofs[1] + o], w0 + o * DZ);
  float tr = 0.f, nsq = 0.f;
#pragma unroll
  for (int i = 0; i < DZ; ++i) {
    tr = fmaf(eJ[i], e[i], tr);
    nsq = fmaf(eJ[i], eJ[i], nsq);
  }
  const float e_rate = safe_norm_sq(ysq), n_rate = safe_norm_sq(nsq);
  kr[0] = -tr;
  kr[1] = norm_z ? e_rate : 0.f;
  kr[2] = norm_j ? n_rate : 0.f;

  // Backward.  Rates row 0 is -tr: ct_tr = -a_acc[0].
  const float ct_tr = -aacc[0];
  const float fz = norm_z ? ct_safe_norm(aacc[1], e_rate) : 0.f;
  const float fn = norm_j ? ct_safe_norm(aacc[2], n_rate) : 0.f;
  float cu[DZ];
#pragma unroll
  for (int i = 0; i < DZ; ++i) {
    cu[i] = fmaf(eJ[i], fn, e[i] * ct_tr);
    sl[m.pu0 + i] = cu[i];
  }
  // Up the pullback chain: ct_v = pu_i W_i, pu_(i+1) = ct_v s'(h) and
  // ct_h = -2 h (ct_v u) over u in place (0 for an identity layer).
  {
    float* pu = PU + L.hofs[1];
    float* u = U + L.hofs[1];
    const float* h = HS + L.hofs[1];
    const int on = L.act[0];
    for (int o = 0; o < L.width[1]; ++o) {
      const float cv = dot4<DZ>(cu, w0 + o * DZ), hh = h[o];
      pu[o] = cv * gate(hh, on);
      u[o] = on ? (-2.f * hh) * (cv * u[o]) : 0.f;
    }
  }
  for (int i = 1; i < n - 1; ++i) {
    float* pu = PU + L.hofs[i + 1];
    float* u = U + L.hofs[i + 1];
    const float* h = HS + L.hofs[i + 1];
    const int on = L.act[i];
    cnf::mv_cols(PU + L.hofs[i], L.width[i], w + L.wofs[i], L.pitch[i], nullptr, L.width[i + 1],
                 [&](int o, float cv) {
                   const float hh = h[o];
                   pu[o] = cv * gate(hh, on);
                   u[o] = on ? (-2.f * hh) * (cv * u[o]) : 0.f;
                 });
  }
  float cv[DZ];
#pragma unroll
  for (int k = 0; k < DZ; ++k) cv[k] = 0.f;
  for (int k = 0; k < wlast; ++k) axpy4<DZ>(cv, PU[hl + k], wl + k * DZ);
  // The output layer: ct_h = a_z + y fz - 2 y (ct_v eps) (tanh; a_z + y fz
  // for identity), ca = ct_h s'(y).
  float cal[DZ];
#pragma unroll
  for (int k = 0; k < DZ; ++k) {
    const float ct_h = on_y ? fmaf(y[k], fz, az[k]) + (-2.f * y[k]) * (cv[k] * e[k]) : fmaf(y[k], fz, az[k]);
    cal[k] = ct_h * gate(y[k], on_y);
    sl[m.cal + k] = cal[k];
    kz[k] = y[k];
  }
  // Down the forward chain: ca of the level below = (ca W^T + ct_h) s'(h).
  for (int k = 0; k < wlast; ++k) {
    const float h = HS[hl + k];
    CA[hl + k] = (dot4<DZ>(cal, wl + k * DZ) + U[hl + k]) * gate(h, on_l);
  }
  for (int i = n - 2; i >= 1; --i) {
    float* ca = CA + L.hofs[i];
    const float* u = U + L.hofs[i];
    const float* h = HS + L.hofs[i];
    const int on = L.act[i - 1];
    cnf::mv_cols(CA + L.hofs[i + 1], L.width[i + 1], w + L.tofs[i], L.tpitch[i], nullptr, L.width[i],
                 [&](int k, float a) { ca[k] = (a + u[k]) * gate(h[k], on); });
  }
  float cz[DZ];
#pragma unroll
  for (int i = 0; i < DZ; ++i) cz[i] = 0.f;
  for (int o = 0; o < L.width[1]; ++o) axpy4<DZ>(cz, CA[L.hofs[1] + o], w0 + o * DZ);
#pragma unroll
  for (int i = 0; i < DZ; ++i) kaz[i] = -cz[i];
  if constexpr (COND) {
    // The ys rows: k_ays = -ca_0 W_0y^T.
    const float* ca0 = CA + L.hofs[1];
    const float* wy = w + L.yofs;
    for (int c = 0; c < L.nc; ++c) {
      float a = 0.f;
      for (int o = 0; o < L.width[1]; ++o) a = fmaf(ca0[o], wy[o * L.nc + c], a);
      kys[c * stride] = -a;
    }
  }
}

// Which terms of a gradient entry the block sums: all of them (the
// one-probe instance), a probe's (pu (x) v) or the forward chain's
// (in (x) ca, the biases and the ys rows).
enum Part { kAll, kProbe, kFwd };

// The block's sum over its first `nvalid` samples (thread order) of the
// negated gradient rate of the stage just evaluated, entry q of the flat
// [W0 | b0 | W1 | b1 | ...].
template <bool COND, int PART = kAll>
__device__ __forceinline__ float block_grad_entry(const ChainLayout& L, const Slot& m, const float* slots, int q,
                                                  int nvalid) {
  int i = 0;
  while (i + 1 < L.n && q >= L.pofs[i + 1]) ++i;
  const int in = L.width[i], out = L.width[i + 1];
  const int r = q - L.pofs[i];
  float v = 0.f;
  if (r < in * out) {
    const int k = r / out, o = r % out;
    if (COND && i == 0 && k >= L.dz) {
      // A ys row of W_0: ys (x) ca_0 (the probe tangent has no ys rows).
      if constexpr (PART == kProbe) return 0.f;
      const int c = m.ys + (k - L.dz), d = m.gca[0] + o;
      for (int t = 0; t < nvalid; ++t) v = fmaf(slots[t * m.size + c], slots[t * m.size + d], v);
      return -v;
    }
    const int a = m.gpu[i] + k, b = m.gv[i] + o, c = m.gin[i] + k, d = m.gca[i] + o;
    for (int t = 0; t < nvalid; ++t) {
      const float* sl = slots + t * m.size;
      if constexpr (PART != kFwd) v = fmaf(sl[a], sl[b], v);
      if constexpr (PART != kProbe) v = fmaf(sl[c], sl[d], v);
    }
  } else {
    if constexpr (PART == kProbe) return 0.f;
    const int d = m.gca[i] + (r - in * out);
    for (int t = 0; t < nvalid; ++t) v += slots[t * m.size + d];
  }
  return -v;
}

// The probe instance's stage (K6) of sample s (nothing but the flushes when
// `valid` is false; the sample's ys already in the slot): the forward pass,
// then per probe its pass and that pass's VJP, leaving its vectors in the
// slot for `flush`, with the -2 h (.) terms summed over the probes in hc
// and the output layer's in cty; then the rates and the forward chain's VJP
// (ca over v), k_az = -ct_z and, COND, k_ays = -ct_ys to kys[c * stride].
template <int DZ, bool COND, class Flush>
__device__ void chain_probe_stage(const ChainLayout& L, const Slot& m, const float* w, float* sl, int norm_z,
                                  int norm_j, bool valid, int s, const float* eps, int B, int K, int jvp,
                                  const float (&z)[DZ], const float (&az)[DZ], const float (&aacc)[3],
                                  float (&kz)[DZ], float (&kr)[3], float (&kaz)[DZ], float* kys, size_t stride,
                                  const Flush& flush) {
  const int n = L.n;
  const int dz = L.dz;
  float* HS = sl + m.hs;
  float* PU = sl + m.pu;
  float* V = sl + m.v;
  float* U = sl + m.u;
  float* HC = sl + m.hc;
  float* CA = sl + m.ca;
  const float* w0 = w + L.wofs[0];
  const float* wl = w + L.wofs[n - 1];
  const int hl = L.hofs[n - 1], wlast = L.width[n - 1];
  const int on_y = L.act[n - 1], on_l = L.act[n - 2];
  float y[DZ], gy[DZ], cty[DZ], ysq = 0.f;
#pragma unroll
  for (int k = 0; k < DZ; ++k) {
    y[k] = 0.f;
    cty[k] = 0.f;
  }
  if (valid) {
    cnf::chain_forward<DZ, COND>(L, w, z, sl + m.ys, HS, y);
    for (int l = 0; l < L.hsum; ++l) HC[l] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < DZ; ++k) {
    ysq = fmaf(y[k], y[k], ysq);
    gy[k] = gate(y[k], on_y);
    if (valid) sl[m.z + k] = z[k];
  }
  // Rates row 0 is -tr averaged over the K probes: ct_tr = -a_acc[0] / K.
  const float inv_k = 1.f / K;
  const float ct_tr = -aacc[0] * inv_k, ct_n = aacc[2] * inv_k;
  float tr = 0.f, nsum = 0.f;
  for (int pk = 0; pk < K; ++pk) {
    if (valid) {
      const float* ek = eps + ((size_t)pk * B + s) * dz;
      float e[DZ], eJ[DZ], a[DZ];
#pragma unroll
      for (int k = 0; k < DZ; ++k) {
        e[k] = k < dz ? ek[k] : 0.f;
        eJ[k] = 0.f;
        a[k] = 0.f;
      }
      if (jvp) {
        // The pushforward, keeping u_l (U) and t_l (PU); a = t W_last.
        {
          const float* h = HS + L.hofs[1];
          float* u = U + L.hofs[1];
          float* t = PU + L.hofs[1];
          const int on = L.act[0];
          for (int o = 0; o < L.width[1]; ++o) {
            const float uo = dot4<DZ>(e, w0 + o * DZ);
            u[o] = uo;
            t[o] = uo * gate(h[o], on);
          }
        }
        for (int i = 1; i < n - 1; ++i) {
          const float* h = HS + L.hofs[i + 1];
          float* u = U + L.hofs[i + 1];
          float* t = PU + L.hofs[i + 1];
          const int on = L.act[i];
          cnf::mv_cols(PU + L.hofs[i], L.width[i], w + L.wofs[i], L.pitch[i], nullptr, L.width[i + 1],
                       [&](int o, float x) {
                         u[o] = x;
                         t[o] = x * gate(h[o], on);
                       });
        }
        for (int k = 0; k < wlast; ++k) axpy4<DZ>(a, PU[hl + k], wl + k * DZ);
#pragma unroll
        for (int k = 0; k < DZ; ++k) eJ[k] = a[k] * gy[k];
      } else {
        // The pullback, keeping u_l (U) and v_l (V); a = v at the output.
#pragma unroll
        for (int k = 0; k < DZ; ++k) {
          a[k] = e[k] * gy[k];
          sl[m.vl + k] = a[k];
        }
        for (int k = 0; k < wlast; ++k) {
          const float uk = dot4<DZ>(a, wl + k * DZ);
          U[hl + k] = uk;
          V[hl + k] = uk * gate(HS[hl + k], on_l);
        }
        for (int i = n - 2; i >= 1; --i) {
          float* u = U + L.hofs[i];
          float* v = V + L.hofs[i];
          const float* h = HS + L.hofs[i];
          const int on = L.act[i - 1];
          cnf::mv_cols(V + L.hofs[i + 1], L.width[i + 1], w + L.tofs[i], L.tpitch[i], nullptr, L.width[i],
                       [&](int k, float x) {
                         u[k] = x;
                         v[k] = x * gate(h[k], on);
                       });
        }
        for (int o = 0; o < L.width[1]; ++o) axpy4<DZ>(eJ, V[L.hofs[1] + o], w0 + o * DZ);
      }
      float trk = 0.f, nsq = 0.f;
#pragma unroll
      for (int i = 0; i < DZ; ++i) {
        trk = fmaf(eJ[i], e[i], trk);
        nsq = fmaf(eJ[i], eJ[i], nsq);
      }
      const float nk = safe_norm_sq(nsq);
      tr += trk;
      nsum += nk;
      const float fn = norm_j ? ct_safe_norm(ct_n, nk) : 0.f;
      if (jvp) {
        // Down the pushforward: ct_Je = eps ct_tr + Je fn, ct_u = ct_Je s'(y)
        // (vl), cty += -2 y (ct_Je a); each level's ct_t = ct_u W^T,
        // ct_u = ct_t s'(h) (V), hc += -2 h (ct_t u); pu0 = eps.
        float cu[DZ];
#pragma unroll
        for (int k = 0; k < DZ; ++k) {
          const float ct = fmaf(eJ[k], fn, e[k] * ct_tr);
          cu[k] = ct * gy[k];
          if (on_y) cty[k] += (-2.f * y[k]) * (ct * a[k]);
          sl[m.vl + k] = cu[k];
          sl[m.pu0 + k] = e[k];
        }
        for (int k = 0; k < wlast; ++k) {
          const float ct = dot4<DZ>(cu, wl + k * DZ), h = HS[hl + k];
          V[hl + k] = ct * gate(h, on_l);
          if (on_l) HC[hl + k] += (-2.f * h) * (ct * U[hl + k]);
        }
        for (int i = n - 2; i >= 1; --i) {
          float* v = V + L.hofs[i];
          float* hc = HC + L.hofs[i];
          const float* u = U + L.hofs[i];
          const float* h = HS + L.hofs[i];
          const int on = L.act[i - 1];
          cnf::mv_cols(V + L.hofs[i + 1], L.width[i + 1], w + L.tofs[i], L.tpitch[i], nullptr, L.width[i],
                       [&](int k, float ct) {
                         v[k] = ct * gate(h[k], on);
                         if (on) hc[k] += (-2.f * h[k]) * (ct * u[k]);
                       });
        }
      } else {
        // Up the pullback: cu = eps ct_tr + eJ fn (pu0); per layer
        // ct_v = pu W, pu of the level above = ct_v s'(h), hc += -2 h
        // (ct_v u); at the output cty += -2 y (ct_v eps).
        float cu[DZ];
#pragma unroll
        for (int i = 0; i < DZ; ++i) {
          cu[i] = fmaf(eJ[i], fn, e[i] * ct_tr);
          sl[m.pu0 + i] = cu[i];
        }
        {
          float* pu = PU + L.hofs[1];
          float* hc = HC + L.hofs[1];
          const float* u = U + L.hofs[1];
          const float* h = HS + L.hofs[1];
          const int on = L.act[0];
          for (int o = 0; o < L.width[1]; ++o) {
            const float cv = dot4<DZ>(cu, w0 + o * DZ), hh = h[o];
            pu[o] = cv * gate(hh, on);
            if (on) hc[o] += (-2.f * hh) * (cv * u[o]);
          }
        }
        for (int i = 1; i < n - 1; ++i) {
          float* pu = PU + L.hofs[i + 1];
          float* hc = HC + L.hofs[i + 1];
          const float* u = U + L.hofs[i + 1];
          const float* h = HS + L.hofs[i + 1];
          const int on = L.act[i];
          cnf::mv_cols(PU + L.hofs[i], L.width[i], w + L.wofs[i], L.pitch[i], nullptr, L.width[i + 1],
                       [&](int o, float cv) {
                         const float hh = h[o];
                         pu[o] = cv * gate(hh, on);
                         if (on) hc[o] += (-2.f * hh) * (cv * u[o]);
                       });
        }
        float cv[DZ];
#pragma unroll
        for (int k = 0; k < DZ; ++k) cv[k] = 0.f;
        for (int k = 0; k < wlast; ++k) axpy4<DZ>(cv, PU[hl + k], wl + k * DZ);
        if (on_y) {
#pragma unroll
          for (int k = 0; k < DZ; ++k) cty[k] += (-2.f * y[k]) * (cv[k] * e[k]);
        }
      }
    }
    flush();
  }
  if (!valid) return;
  const float e_rate = safe_norm_sq(ysq);
  kr[0] = -(tr / K);
  kr[1] = norm_z ? e_rate : 0.f;
  kr[2] = norm_j ? nsum / K : 0.f;
  // Down the forward chain: cal = (a_z + y fz + cty) s'(y); ca of the level
  // below = (ca W^T + hc) s'(h), over V.
  const float fz = norm_z ? ct_safe_norm(aacc[1], e_rate) : 0.f;
  float cal[DZ];
#pragma unroll
  for (int k = 0; k < DZ; ++k) {
    cal[k] = (fmaf(y[k], fz, az[k]) + cty[k]) * gy[k];
    sl[m.cal + k] = cal[k];
    kz[k] = y[k];
  }
  for (int k = 0; k < wlast; ++k) CA[hl + k] = (dot4<DZ>(cal, wl + k * DZ) + HC[hl + k]) * gate(HS[hl + k], on_l);
  for (int i = n - 2; i >= 1; --i) {
    float* ca = CA + L.hofs[i];
    const float* hc = HC + L.hofs[i];
    const float* h = HS + L.hofs[i];
    const int on = L.act[i - 1];
    cnf::mv_cols(CA + L.hofs[i + 1], L.width[i + 1], w + L.tofs[i], L.tpitch[i], nullptr, L.width[i],
                 [&](int k, float x) { ca[k] = (x + hc[k]) * gate(h[k], on); });
  }
  float cz[DZ];
#pragma unroll
  for (int i = 0; i < DZ; ++i) cz[i] = 0.f;
  for (int o = 0; o < L.width[1]; ++o) axpy4<DZ>(cz, CA[L.hofs[1] + o], w0 + o * DZ);
#pragma unroll
  for (int i = 0; i < DZ; ++i) kaz[i] = -cz[i];
  if constexpr (COND) {
    const float* ca0 = CA + L.hofs[1];
    const float* wy = w + L.yofs;
    for (int c = 0; c < L.nc; ++c) {
      float x = 0.f;
      for (int o = 0; o < L.width[1]; ++o) x = fmaf(ca0[o], wy[o * L.nc + c], x);
      kys[c * stride] = -x;
    }
  }
}

// The stage and gradient callbacks of cnf::adjoint_solve.
template <int DZ, bool COND>
struct ChainStage {
  const ChainLayout* L;
  const Slot* m;
  const float* w;
  const float* eps;  // (B, dz)
  const float* ys;   // (B, nc)
  float* sl;         // this thread's slot
  int B, dz, norm_z, norm_j;
  __device__ void operator()(int s, const float (&z)[DZ], const float (&az)[DZ], const float (&aacc)[3],
                             float (&kz)[DZ], float (&kr)[3], float (&kaz)[DZ], float* kys) const {
    float e[DZ];
#pragma unroll
    for (int i = 0; i < DZ; ++i) e[i] = i < dz ? eps[(size_t)s * dz + i] : 0.f;
    if constexpr (COND) cnf::load_cond(*L, ys, s, sl + m->ys);
    chain_adjoint_stage<DZ, COND>(*L, *m, w, sl, norm_z, norm_j, z, az, e, aacc, kz, kr, kaz, kys, (size_t)B);
  }
};

template <bool COND>
struct ChainGrad {
  const ChainLayout* L;
  const Slot* m;
  const float* slots;
  __device__ float operator()(int q, int, int nvalid) const {
    return block_grad_entry<COND>(*L, *m, slots, q, nvalid);
  }
};

// The probe instance's callbacks (K6) for adjoint_solve's PROBES form.
template <int DZ, bool COND>
struct ChainProbeStage {
  const ChainLayout* L;
  const Slot* m;
  const float* w;
  const float* eps;  // (K, B, dz)
  const float* ys;   // (B, nc)
  float* sl;         // this thread's slot
  int B, norm_z, norm_j, K, jvp;
  template <class Flush>
  __device__ void probes(bool valid, int s, const float (&z)[DZ], const float (&az)[DZ], const float (&aacc)[3],
                         float (&kz)[DZ], float (&kr)[3], float (&kaz)[DZ], float* kys, const Flush& flush) const {
    if constexpr (COND) {
      if (valid) cnf::load_cond(*L, ys, s, sl + m->ys);
    }
    chain_probe_stage<DZ, COND>(*L, *m, w, sl, norm_z, norm_j, valid, s, eps, B, K, jvp, z, az, aacc, kz, kr, kaz,
                                kys, (size_t)B, flush);
  }
};

template <bool COND>
struct ChainProbeGrad {
  const ChainLayout* L;
  const Slot* m;
  const float* slots;
  __device__ float probe(int q, int, int nvalid) const {
    return block_grad_entry<COND, kProbe>(*L, *m, slots, q, nvalid);
  }
  __device__ float fwd(int q, int, int nvalid) const { return block_grad_entry<COND, kFwd>(*L, *m, slots, q, nvalid); }
};

template <int DZ, bool COND>
__global__ void __launch_bounds__(kMaxBlock) k2_chain_adjoint(const AdjArgs p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ ChainLayout L;
  __shared__ Slot m;
  if (threadIdx.x == 0) m = p.m;
  cnf::share_layout(p.L, &L);
  const int P = L.P;
  float* w = smem;
  float* red = w + L.wfloats;
  float* slots = red + kRedFloats;
  cnf::load_chain_weights<DZ>(p.params, L, w);
  __syncthreads();
  // This block's g (the same in every block), proposed g, FSAL stage rate and
  // last-stage rate, in global memory.
  float* gp = p.gblk + (size_t)blockIdx.x * 4 * P;
  const ChainStage<DZ, COND> stage{&L, &m, w, p.eps, p.ys, slots + threadIdx.x * m.size, p.s.B, p.s.dz,
                                   p.norm_z, p.norm_j};
  const ChainGrad<COND> grad{&L, &m, slots};
  cnf::adjoint_solve<DZ, COND, kStageUnroll<COND>>(p.s, stage, grad, P, gp, gp + P, gp + 2 * P, gp + 3 * P, red);
  if (blockIdx.x == 0)
    for (int q = threadIdx.x; q < P; q += blockDim.x) p.g[q] = gp[q];
}

// The probe instance's kernel (K6).
struct ProbeArgs {
  AdjArgs a;
  int K, jvp;
};

template <int DZ, bool COND>
__global__ void __launch_bounds__(kMaxBlock) k2_chain_probe_adjoint(const ProbeArgs pa) {
  extern __shared__ __align__(16) float smem[];
  __shared__ ChainLayout L;
  __shared__ Slot m;
  const AdjArgs& p = pa.a;
  if (threadIdx.x == 0) m = p.m;
  cnf::share_layout(p.L, &L);
  const int P = L.P;
  float* w = smem;
  float* red = w + L.wfloats;
  float* slots = red + kRedFloats;
  cnf::load_chain_weights<DZ>(p.params, L, w);
  __syncthreads();
  float* gp = p.gblk + (size_t)blockIdx.x * 4 * P;
  const ChainProbeStage<DZ, COND> stage{&L, &m, w, p.eps, p.ys, slots + threadIdx.x * m.size, p.s.B,
                                        p.norm_z, p.norm_j, pa.K, pa.jvp};
  const ChainProbeGrad<COND> grad{&L, &m, slots};
  cnf::adjoint_solve<DZ, COND, kStageUnroll<COND>, true>(p.s, stage, grad, P, gp, gp + P, gp + 2 * P, gp + 3 * P,
                                                          red);
  if (blockIdx.x == 0)
    for (int q = threadIdx.x; q < P; q += blockDim.x) p.g[q] = gp[q];
}

size_t smem_bytes(const ChainLayout& L, const Slot& m, int block) {
  return sizeof(float) * ((size_t)L.wfloats + kRedFloats + (size_t)block * m.size);
}

template <int DZ>
bool layout(int n, const int* widths, ChainLayout* L, Slot* m, bool probes = false) {
  if (!cnf::make_chain_layout<DZ>(n, widths, L)) return false;
  *m = make_slot<DZ>(*L, probes);
  return true;
}

// The kernel instance's shared memory, co-resident grid and launch, for
// cnf::dispatch_chain.
struct SmemOf {
  int n;
  const int* widths;
  int block;
  template <int DZ, bool COND>
  long long operator()() const {
    ChainLayout L;
    Slot m;
    return layout<DZ>(n, widths, &L, &m) ? (long long)smem_bytes(L, m, block) : 0;
  }
};

struct MaxGrid {
  int n;
  const int* widths;
  int block;
  int* out;
  bool probes;
  template <int DZ, bool COND>
  int operator()() const {
    ChainLayout L;
    Slot m;
    *out = 0;
    if (!layout<DZ>(n, widths, &L, &m, probes)) return (int)cudaErrorInvalidValue;
    if (probes)
      return (int)cnf::coop_max_grid(k2_chain_probe_adjoint<DZ, COND>, smem_bytes(L, m, block), block, out);
    return (int)cnf::coop_max_grid(k2_chain_adjoint<DZ, COND>, smem_bytes(L, m, block), block, out);
  }
};

struct Launch {
  AdjArgs a;
  int n;
  const int* widths;
  int acts;
  int grid, block;
  cudaStream_t s;
  int K, jvp;  // K = 0: the one-probe instance
  template <int DZ, bool COND>
  int operator()() const {
    AdjArgs b = a;
    if (!layout<DZ>(n, widths, &b.L, &b.m, K > 0)) return (int)cudaErrorInvalidValue;
    cnf::set_chain_acts(&b.L, acts);
    if (K > 0)
      return (int)cnf::coop_launch(k2_chain_probe_adjoint<DZ, COND>, ProbeArgs{b, K, jvp}, grid, block,
                                   smem_bytes(b.L, b.m, block), s);
    return (int)cnf::coop_launch(k2_chain_adjoint<DZ, COND>, b, grid, block, smem_bytes(b.L, b.m, block), s);
  }
};

}  // namespace

// Dynamic shared memory of one block (bytes), 0 for a chain not covered.
extern "C" long long cnf_k2c_smem_bytes(int n, const int* widths, int block) {
  return cnf::dispatch_chain(n, widths, SmemOf{n, widths, block}, 0LL);
}

// Largest co-resident grid for a cooperative launch (0 if none).  widths:
// n + 1 level widths (host memory), the input width dz + nc first.
extern "C" int cnf_k2c_max_grid(int n, const int* widths, int block, int* out) {
  *out = 0;
  return cnf::dispatch_chain(n, widths, MaxGrid{n, widths, block, out, false}, (int)cudaErrorInvalidValue);
}

// The same for the probe instance (K6).
extern "C" int cnf_k2cp_max_grid(int n, const int* widths, int block, int* out) {
  *out = 0;
  return cnf::dispatch_chain(n, widths, MaxGrid{n, widths, block, out, true}, (int)cudaErrorInvalidValue);
}

// params/g: [W0 | b0 | ...] flat (device); eps, zT, azT, z0, az0: (B, dz);
// ys, ays0: (B, nc), null for an unconditional chain (nc = widths[0] -
// widths[n]); acts: bit i set where layer i is tanh (else identity);
// accT/aaccT/acc0: (3, B).  work: (S + 2) (2 dz + 3 + nc) B floats, gpart:
// 2 * grid * NG * P (NG = 3 for a tableau with btilde3, else 2), gblk:
// grid * 4 P.  tab: kTableauFloats floats (read_tableau).  Returns the
// launch's cudaError_t.
extern "C" int cnf_k2c_train_adjoint(const float* params, const float* eps, const float* ys, const float* zT,
                                     const float* accT, const float* azT, const float* aaccT, const float* ts,
                                     float* z0, float* acc0, float* az0, float* ays0, float* g, int* stats,
                                     float* work, float* partials, float* gpart, float* gblk, int B, int n,
                                     const int* widths, int acts, int max_steps, int norm_z, int norm_j, float rtol,
                                     float atol, float beta1, float beta2, float inv_order, const float* tab,
                                     int grid, int block, void* stream) {
  if (block < 32 || block > kMaxBlock || block % 32 != 0 || grid < 1 || n < 2 || n > kMaxLayers)
    return (int)cudaErrorInvalidValue;
  AdjArgs a = {};
  cnf::set_adj_state(&a.s, zT, accT, azT, aaccT, ts, z0, acc0, az0, stats, work, partials, gpart, B,
                     widths[n], max_steps, rtol, atol, beta1, beta2, inv_order, tab);
  a.s.nc = widths[0] - widths[n];
  a.s.ays0 = ays0;
  a.params = params;
  a.eps = eps;
  a.ys = ys;
  a.g = g;
  a.gblk = gblk;
  a.norm_z = norm_z;
  a.norm_j = norm_j;
  return cnf::dispatch_chain(n, widths, Launch{a, n, widths, acts, grid, block, (cudaStream_t)stream, 0, 0},
                             (int)cudaErrorInvalidValue);
}

// The probe instance (K6): as cnf_k2c_train_adjoint with eps (K, B, dz),
// K >= 1 probes, reverse mode or (jvp) forward mode.  Same shared memory as
// the one-probe instance.
extern "C" int cnf_k2c_probe_adjoint(const float* params, const float* eps, const float* ys, const float* zT,
                                     const float* accT, const float* azT, const float* aaccT, const float* ts,
                                     float* z0, float* acc0, float* az0, float* ays0, float* g, int* stats,
                                     float* work, float* partials, float* gpart, float* gblk, int B, int n,
                                     const int* widths, int acts, int max_steps, int norm_z, int norm_j, int K, int jvp, float rtol,
                                     float atol, float beta1, float beta2, float inv_order, const float* tab,
                                     int grid, int block, void* stream) {
  if (block < 32 || block > kMaxBlock || block % 32 != 0 || grid < 1 || n < 2 || n > kMaxLayers || K < 1)
    return (int)cudaErrorInvalidValue;
  AdjArgs a = {};
  cnf::set_adj_state(&a.s, zT, accT, azT, aaccT, ts, z0, acc0, az0, stats, work, partials, gpart, B,
                     widths[n], max_steps, rtol, atol, beta1, beta2, inv_order, tab);
  a.s.nc = widths[0] - widths[n];
  a.s.ays0 = ays0;
  a.params = params;
  a.eps = eps;
  a.ys = ys;
  a.g = g;
  a.gblk = gblk;
  a.norm_z = norm_z;
  a.norm_j = norm_j;
  return cnf::dispatch_chain(n, widths, Launch{a, n, widths, acts, grid, block, (cudaStream_t)stream, K, jvp},
                             (int)cudaErrorInvalidValue);
}
