// K2: the continuous-adjoint (backsolve) backward integration of a TRAIN-mode
// CNF whose field is a 2-layer tanh MLP with Hutchinson probes, the whole
// adaptive solve (any embedded explicit tableau, K9) from t_hi down to t_lo
// in one cooperative launch.  Two instances: one reverse-mode probe (below),
// and the probe instance (K6, at the end) for K probes, reverse or forward
// mode.
//
// Replaces the TPU kernel built by continuousnf_tpu/ops/fused_solve.py::
// _make_adjoint_kernel (:1064-1343), launched by make_full_solve.adjoint_solve
// (pl.pallas_call at :1767), with the _stage_train_fwdbwd stage (:372-481).
// The state is, per sample, z (dz), acc (3: dlogp, reg_e, reg_n), a_z (dz)
// and the constant a_acc (3), plus the batch-summed parameter gradient g_p
// (P = 2 dz H + H + dz floats).  Each stage runs the TRAIN field forward
// (h, y, the probe pullback eJ, the rates) and its hand-derived VJP against
// (a_z, a_acc): the rates of z and acc, k_az = -dz/dz^T a, and the per-sample
// parameter cotangents, rank-2 outer products that the block sums over its
// samples in a fixed order.  The probes are Monte-Carlo constants: no eps
// cotangent is integrated.
//
// The error norm is batch-global and covers g_p, as in the TPU kernel with
// one batch tile (its per-tile controllers are not ported: they change the
// numerics): the backsolve loop of solve_common.cuh (adjoint_solve), shared
// with the K4 adjoint, over n = B * 2 * (dz + 3) + P elements, with each
// block's partials of the b- and btilde-weighted g_p sums in parity-indexed
// global buffers, one grid.sync() per attempted step, and every block adding
// all blocks' partials in block order.  g_p, its proposal and the block's
// stage-1 and last-stage partials (4 P floats) live in shared memory.
//
// What bounds it on the H100: latency.  A stage is about 8 dz H FMA per
// sample plus 2 P FMA per sample for the outer products; the time goes to
// the dependent chains of one thread per sample, the block's outer-product
// pass, and one grid barrier (with a 2 P * G-float read, 3 P * G for
// dop853) per attempted step.
// Registers: one sample's residuals (h, u1, v0, the cotangents) are ~5 H +
// 4 dz floats; they live in a per-thread slot of shared memory (odd stride:
// conflict-free for the owning thread and for the outer-product pass, which
// reads one entry of every thread's slot), so the stage itself keeps only
// dz-sized vectors in registers.
// Precision: f32 FMA on the CUDA cores, no TF32 and no tensor cores.
//
// The probe instance (K6): _stage_train_fwdbwd with k_probes = K and jvp
// (:372-481; K :1706-1708, the JVP branch :435-450).  K slot sets do not fit
// in shared memory, so the stage runs a sub-pass per probe with one slot set
// (adjoint_solve's PROBES form): after the forward pass, each probe's pass
// and its VJP leave that probe's outer-product vectors in the slot and the
// block adds its terms (W1: a (x) b, W2: c (x) d with, VJP, a = ct_eJ,
// b = v0, c = ct_u1, d = v1; JVP, a = eps, b = ct_u0, c = t1, d = ct_u of
// the pushforward u0 = eps W1, t1 = u0 (1 - h^2), Je = (t1 W2) (1 - y^2)),
// while its -2 h (.) and -2 y (.) gate terms are summed over the probes (a
// slot vector and registers); then the forward chain's VJP and its terms
// (z (x) ca, h (x) ca1, the biases), with ca over b's vector.  The slot keeps
// its size.  K and the direction are run-time values: one instance runs
// every probe count and both directions, and the one-probe instance stays
// as it was.

#include "solve_common.cuh"

namespace {

// The unroll factor of the solve loops over stored stages (solve_common.cuh),
// the fastest of 1, 2, 4 and 8 for this kernel on the H100 (PERF.md, PR 6).
constexpr int kStageUnroll = 4;

using cnf::axpy4;
using cnf::ct_safe_norm;
using cnf::dot4;
using cnf::kMaxBlock;
using cnf::kRedFloats;
using cnf::safe_norm_sq;

struct AdjArgs {
  cnf::AdjState s;
  const float* w1;    // (dz, H)
  const float* b1;    // (H)
  const float* w2;    // (H, dz)
  const float* b2;    // (dz)
  const float* eps;   // (B, dz) Hutchinson probe
  float* gw1;         // (dz, H)
  float* gb1;         // (H)
  float* gw2;         // (H, dz)
  float* gb2;         // (dz)
  int H, norm_z, norm_j;
};

// Offsets in a thread's shared-memory slot: four dz-vectors, then five
// H-vectors (Hu holds u1 and then the -2 h (ct_v0 u1) term).
template <int DZ>
struct Slot {
  int cte, z, v1, ca1, h, u, v0, cu, ca, size;
  __device__ __host__ explicit Slot(int H) {
    cte = 0; z = DZ; v1 = 2 * DZ; ca1 = 3 * DZ;
    h = 4 * DZ; u = h + H; v0 = u + H; cu = v0 + H; ca = cu + H;
    size = (ca + H) | 1;
  }
};

struct Weights {
  const float* w1t;  // (H, DZ): w1t[j][i] = w1[i][j]
  const float* w2p;  // (H, DZ): w2p[j][k] = w2[j][k]
  const float* b1;   // (H)
  const float* b2p;  // (DZ)
  int H, dz, norm_z, norm_j;
};

// One augmented stage of one sample (fused_solve.py::_stage_train_fwdbwd with
// ct_y = a_z, ct_r = a_acc): the field y and rates kr, k_az = -ct_z, and the
// residuals the outer-product pass reads, left in the slot `sl`.
template <int DZ>
__device__ void adjoint_stage(const Weights& w, float* sl, const float (&z)[DZ],
                              const float (&az)[DZ], const float (&e)[DZ], const float (&aacc)[3],
                              float (&kz)[DZ], float (&kr)[3], float (&kaz)[DZ]) {
  const Slot<DZ> o(w.H);
  const int H = w.H;
  // Forward: h = tanh(z W1 + b1), y = tanh(h W2 + b2).
  float y[DZ];
#pragma unroll
  for (int k = 0; k < DZ; ++k) y[k] = w.b2p[k];
  for (int j = 0; j < H; ++j) {
    const float h = tanhf(dot4<DZ>(z, w.w1t + j * DZ) + w.b1[j]);
    sl[o.h + j] = h;
    axpy4<DZ>(y, h, w.w2p + j * DZ);
  }
  float v1[DZ], ysq = 0.f;
#pragma unroll
  for (int k = 0; k < DZ; ++k) {
    y[k] = tanhf(y[k]);
    ysq = fmaf(y[k], y[k], ysq);
    v1[k] = e[k] * (1.f - y[k] * y[k]);
    sl[o.z + k] = z[k];
    sl[o.v1 + k] = v1[k];
  }
  // The probe pullback: u1 = W2 v1, v0 = u1 (1 - h^2), eJ = W1 v0.
  float eJ[DZ];
#pragma unroll
  for (int i = 0; i < DZ; ++i) eJ[i] = 0.f;
  for (int j = 0; j < H; ++j) {
    const float u1 = dot4<DZ>(v1, w.w2p + j * DZ);
    const float h = sl[o.h + j];
    const float v0 = u1 * (1.f - h * h);
    sl[o.u + j] = u1;
    sl[o.v0 + j] = v0;
    axpy4<DZ>(eJ, v0, w.w1t + j * DZ);
  }
  float tr = 0.f, nsq = 0.f;
#pragma unroll
  for (int i = 0; i < DZ; ++i) {
    tr = fmaf(eJ[i], e[i], tr);
    nsq = fmaf(eJ[i], eJ[i], nsq);
  }
  const float e_rate = safe_norm_sq(ysq), n_rate = safe_norm_sq(nsq);
  kr[0] = -tr;
  kr[1] = w.norm_z ? e_rate : 0.f;
  kr[2] = w.norm_j ? n_rate : 0.f;

  // Backward.  Rates row 0 is -tr: ct_tr = -a_acc[0].
  const float ct_tr = -aacc[0];
  const float fz = w.norm_z ? ct_safe_norm(aacc[1], e_rate) : 0.f;
  const float fn = w.norm_j ? ct_safe_norm(aacc[2], n_rate) : 0.f;
  float cte[DZ];
#pragma unroll
  for (int i = 0; i < DZ; ++i) {
    cte[i] = fmaf(eJ[i], fn, e[i] * ct_tr);
    sl[o.cte + i] = cte[i];
  }
  // Up the pullback chain: ct_v0 = W1^T ct_eJ, ct_u1 = ct_v0 (1 - h^2),
  // ct_h1 += -2 h (ct_v0 u1); ct_v1 = W2^T ct_u1.
  float cv1[DZ];
#pragma unroll
  for (int k = 0; k < DZ; ++k) cv1[k] = 0.f;
  for (int j = 0; j < H; ++j) {
    const float h = sl[o.h + j];
    const float cv0 = dot4<DZ>(cte, w.w1t + j * DZ);
    const float cu = cv0 * (1.f - h * h);
    sl[o.cu + j] = cu;
    sl[o.u + j] = (-2.f * h) * (cv0 * sl[o.u + j]);
    axpy4<DZ>(cv1, cu, w.w2p + j * DZ);
  }
  // The output layer: ct_h = a_z + y fz - 2 y (ct_v1 eps), ct_a1 = ct_h (1 - y^2).
  float ca1[DZ];
#pragma unroll
  for (int k = 0; k < DZ; ++k) {
    const float ct_h = (fmaf(y[k], fz, az[k])) + (-2.f * y[k]) * (cv1[k] * e[k]);
    ca1[k] = ct_h * (1.f - y[k] * y[k]);
    sl[o.ca1 + k] = ca1[k];
    kz[k] = y[k];
  }
  // Down the forward chain: ct_h1 = W2 ct_a1 + (the pullback term),
  // ct_a0 = ct_h1 (1 - h^2), ct_z = W1 ct_a0.
  float cz[DZ];
#pragma unroll
  for (int i = 0; i < DZ; ++i) cz[i] = 0.f;
  for (int j = 0; j < H; ++j) {
    const float h = sl[o.h + j];
    const float ca = (dot4<DZ>(ca1, w.w2p + j * DZ) + sl[o.u + j]) * (1.f - h * h);
    sl[o.ca + j] = ca;
    axpy4<DZ>(cz, ca, w.w1t + j * DZ);
  }
#pragma unroll
  for (int i = 0; i < DZ; ++i) kaz[i] = -cz[i];
}

// Which terms of a gradient entry the block sums: all of them (the
// one-probe instance), a probe's (cte (x) v0, cu (x) v1) or the forward
// chain's (z (x) ca, h (x) ca1 and the biases; the probe instance keeps ca
// over v0).
enum Part { kAll, kProbe, kFwd };

// The block's sum over its first `nvalid` samples (thread order) of the
// negated parameter-gradient rate of the stage just evaluated, entry p of
// [W1 (dz, H) | b1 | W2 (H, dz) | b2].
template <int DZ, int PART = kAll>
__device__ __forceinline__ float block_grad_entry(const float* slots, int p, int dz, int H, int nvalid) {
  const Slot<DZ> o(H);
  const int ca = PART == kFwd ? o.v0 : o.ca;
  float v = 0.f;
  if (p < dz * H) {
    const int i = p / H, j = p % H;
    for (int t = 0; t < nvalid; ++t) {
      const float* sl = slots + t * o.size;
      if constexpr (PART != kFwd) v = fmaf(sl[o.cte + i], sl[o.v0 + j], v);
      if constexpr (PART != kProbe) v = fmaf(sl[o.z + i], sl[ca + j], v);
    }
  } else if (p < dz * H + H) {
    if constexpr (PART == kProbe) return 0.f;
    const int j = p - dz * H;
    for (int t = 0; t < nvalid; ++t) v += slots[t * o.size + ca + j];
  } else if (p < 2 * dz * H + H) {
    const int q = p - dz * H - H;
    const int j = q / dz, k = q % dz;
    for (int t = 0; t < nvalid; ++t) {
      const float* sl = slots + t * o.size;
      if constexpr (PART != kFwd) v = fmaf(sl[o.cu + j], sl[o.v1 + k], v);
      if constexpr (PART != kProbe) v = fmaf(sl[o.h + j], sl[o.ca1 + k], v);
    }
  } else {
    if constexpr (PART == kProbe) return 0.f;
    const int k = p - 2 * dz * H - H;
    for (int t = 0; t < nvalid; ++t) v += slots[t * o.size + o.ca1 + k];
  }
  return -v;
}

// The probe instance's stage (K6) of sample s (nothing but the flushes when
// `valid` is false): the forward pass, then per probe k its pass and that
// pass's VJP, whose outer-product vectors (cte, v0, cu, v1) stay in the slot
// for `flush`, with the -2 h (.) terms summed over the probes in the slot's
// ca vector and the -2 y (.) terms in cty; then the rates and the forward
// chain's VJP, ca over v0.
template <int DZ, class Flush>
__device__ void probe_stage(const Weights& w, float* sl, bool valid, int s, const float* eps, int B, int K,
                            int jvp, const float (&z)[DZ], const float (&az)[DZ], const float (&aacc)[3],
                            float (&kz)[DZ], float (&kr)[3], float (&kaz)[DZ], const Flush& flush) {
  const Slot<DZ> o(w.H);
  const int H = w.H, dz = w.dz;
  float y[DZ], gy[DZ], cty[DZ], ysq = 0.f;
#pragma unroll
  for (int k = 0; k < DZ; ++k) {
    y[k] = w.b2p[k];
    cty[k] = 0.f;
  }
  if (valid) {
    for (int j = 0; j < H; ++j) {
      const float h = tanhf(dot4<DZ>(z, w.w1t + j * DZ) + w.b1[j]);
      sl[o.h + j] = h;
      sl[o.ca + j] = 0.f;
      axpy4<DZ>(y, h, w.w2p + j * DZ);
    }
  }
#pragma unroll
  for (int k = 0; k < DZ; ++k) {
    y[k] = tanhf(y[k]);
    ysq = fmaf(y[k], y[k], ysq);
    gy[k] = 1.f - y[k] * y[k];
    if (valid) sl[o.z + k] = z[k];
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
        // Pushforward: u0 = eps W1 (u), t1 = u0 (1 - h^2) (cu), a = t1 W2.
        for (int j = 0; j < H; ++j) {
          const float h = sl[o.h + j];
          const float u0 = dot4<DZ>(e, w.w1t + j * DZ);
          const float t1 = u0 * (1.f - h * h);
          sl[o.u + j] = u0;
          sl[o.cu + j] = t1;
          axpy4<DZ>(a, t1, w.w2p + j * DZ);
        }
#pragma unroll
        for (int k = 0; k < DZ; ++k) eJ[k] = a[k] * gy[k];
      } else {
        // Pullback: v1 = eps (1 - y^2), u1 = W2 v1 (u), v0 = u1 (1 - h^2), eJ = W1 v0.
#pragma unroll
        for (int k = 0; k < DZ; ++k) {
          a[k] = e[k] * gy[k];
          sl[o.v1 + k] = a[k];
        }
        for (int j = 0; j < H; ++j) {
          const float h = sl[o.h + j];
          const float u1 = dot4<DZ>(a, w.w2p + j * DZ);
          const float v0 = u1 * (1.f - h * h);
          sl[o.u + j] = u1;
          sl[o.v0 + j] = v0;
          axpy4<DZ>(eJ, v0, w.w1t + j * DZ);
        }
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
      const float fn = w.norm_j ? ct_safe_norm(ct_n, nk) : 0.f;
      if (jvp) {
        // Down the pushforward: ct_Je = eps ct_tr + Je fn; ct_u = ct_Je (1 - y^2)
        // (v1), cty += -2 y (ct_Je a); ct_t1 = W2 ct_u, ct_u0 = ct_t1 (1 - h^2)
        // (v0), ct_h += -2 h (ct_t1 u0); W1's probe term eps (x) ct_u0.
        float cu[DZ];
#pragma unroll
        for (int k = 0; k < DZ; ++k) {
          const float ct = fmaf(eJ[k], fn, e[k] * ct_tr);
          cu[k] = ct * gy[k];
          cty[k] += (-2.f * y[k]) * (ct * a[k]);
          sl[o.v1 + k] = cu[k];
          sl[o.cte + k] = e[k];
        }
        for (int j = 0; j < H; ++j) {
          const float h = sl[o.h + j];
          const float ct1 = dot4<DZ>(cu, w.w2p + j * DZ);
          sl[o.v0 + j] = ct1 * (1.f - h * h);
          sl[o.ca + j] += (-2.f * h) * (ct1 * sl[o.u + j]);
        }
      } else {
        // Up the pullback: cte = eps ct_tr + eJ fn; ct_v0 = W1^T cte,
        // ct_u1 = ct_v0 (1 - h^2) (cu), ct_h += -2 h (ct_v0 u1);
        // ct_v1 = W2^T ct_u1, cty += -2 y (ct_v1 eps).
        float cte[DZ], cv1[DZ];
#pragma unroll
        for (int i = 0; i < DZ; ++i) {
          cte[i] = fmaf(eJ[i], fn, e[i] * ct_tr);
          sl[o.cte + i] = cte[i];
          cv1[i] = 0.f;
        }
        for (int j = 0; j < H; ++j) {
          const float h = sl[o.h + j];
          const float cv0 = dot4<DZ>(cte, w.w1t + j * DZ);
          const float cu = cv0 * (1.f - h * h);
          sl[o.cu + j] = cu;
          sl[o.ca + j] += (-2.f * h) * (cv0 * sl[o.u + j]);
          axpy4<DZ>(cv1, cu, w.w2p + j * DZ);
        }
#pragma unroll
        for (int k = 0; k < DZ; ++k) cty[k] += (-2.f * y[k]) * (cv1[k] * e[k]);
      }
    }
    flush();
  }
  if (!valid) return;
  const float e_rate = safe_norm_sq(ysq);
  kr[0] = -(tr / K);
  kr[1] = w.norm_z ? e_rate : 0.f;
  kr[2] = w.norm_j ? nsum / K : 0.f;
  // The forward chain: ca1 = (a_z + y fz + cty) (1 - y^2),
  // ca = (W2 ca1 + ct_h) (1 - h^2) over v0, ct_z = W1 ca.
  const float fz = w.norm_z ? ct_safe_norm(aacc[1], e_rate) : 0.f;
  float ca1[DZ], cz[DZ];
#pragma unroll
  for (int k = 0; k < DZ; ++k) {
    ca1[k] = (fmaf(y[k], fz, az[k]) + cty[k]) * gy[k];
    sl[o.ca1 + k] = ca1[k];
    kz[k] = y[k];
    cz[k] = 0.f;
  }
  for (int j = 0; j < H; ++j) {
    const float h = sl[o.h + j];
    const float ca = (dot4<DZ>(ca1, w.w2p + j * DZ) + sl[o.ca + j]) * (1.f - h * h);
    sl[o.v0 + j] = ca;
    axpy4<DZ>(cz, ca, w.w1t + j * DZ);
  }
#pragma unroll
  for (int i = 0; i < DZ; ++i) kaz[i] = -cz[i];
}

// The stage and gradient callbacks of cnf::adjoint_solve.
template <int DZ>
struct ProbeStage {
  Weights w;
  const float* eps;  // (B, dz)
  float* sl;         // this thread's slot
  __device__ void operator()(int s, const float (&z)[DZ], const float (&az)[DZ], const float (&aacc)[3],
                             float (&kz)[DZ], float (&kr)[3], float (&kaz)[DZ], float*) const {
    float e[DZ];
#pragma unroll
    for (int i = 0; i < DZ; ++i) e[i] = i < w.dz ? eps[(size_t)s * w.dz + i] : 0.f;
    adjoint_stage<DZ>(w, sl, z, az, e, aacc, kz, kr, kaz);
  }
};

template <int DZ>
struct ProbeGrad {
  const float* slots;
  int dz, H;
  __device__ float operator()(int q, int, int nvalid) const {
    return block_grad_entry<DZ>(slots, q, dz, H, nvalid);
  }
};

// The probe instance's callbacks (K6) for adjoint_solve's PROBES form.
template <int DZ>
struct ProbeLoopStage {
  Weights w;
  const float* eps;  // (K, B, dz)
  float* sl;         // this thread's slot
  int B, K, jvp;
  template <class Flush>
  __device__ void probes(bool valid, int s, const float (&z)[DZ], const float (&az)[DZ], const float (&aacc)[3],
                         float (&kz)[DZ], float (&kr)[3], float (&kaz)[DZ], float*, const Flush& flush) const {
    probe_stage<DZ>(w, sl, valid, s, eps, B, K, jvp, z, az, aacc, kz, kr, kaz, flush);
  }
};

template <int DZ>
struct ProbeLoopGrad {
  const float* slots;
  int dz, H;
  __device__ float probe(int q, int, int nvalid) const {
    return block_grad_entry<DZ, kProbe>(slots, q, dz, H, nvalid);
  }
  __device__ float fwd(int q, int, int nvalid) const { return block_grad_entry<DZ, kFwd>(slots, q, dz, H, nvalid); }
};

// The gradient's output from block 0's copy.
__device__ void store_grad(const float* gp, int dz, int H, float* gw1, float* gb1, float* gw2, float* gb2) {
  const int P = 2 * dz * H + H + dz;
  for (int q = threadIdx.x; q < P; q += blockDim.x) {
    const float g = gp[q];
    if (q < dz * H) {
      gw1[q] = g;
    } else if (q < dz * H + H) {
      gb1[q - dz * H] = g;
    } else if (q < 2 * dz * H + H) {
      gw2[q - dz * H - H] = g;
    } else {
      gb2[q - 2 * dz * H - H] = g;
    }
  }
}

template <int DZ>
__global__ void __launch_bounds__(kMaxBlock) k2_train_adjoint(const AdjArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int H = p.H, dz = p.s.dz;
  const int P = 2 * dz * H + H + dz;
  float* w1t = smem;               // (H, DZ)
  float* w2p = w1t + H * DZ;       // (H, DZ)
  float* b2p = w2p + H * DZ;       // (DZ)
  float* b1 = b2p + DZ;            // (H)
  float* red = b1 + H;             // kRedFloats
  float* gp = red + kRedFloats;    // (P) g_p, the same in every block
  float* gnew = gp + P;            // (P) the proposed g_p
  float* K1p = gnew + P;           // (P) this block's stage-1 rate
  float* K7p = K1p + P;            // (P) this block's last-stage rate
  float* slots = K7p + P;          // blockDim.x slots
  const Slot<DZ> o(H);
  cnf::load_weights<DZ>(p.w1, p.b1, p.w2, p.b2, dz, H, w1t, w2p, b2p, b1);
  const Weights w{w1t, w2p, b1, b2p, H, dz, p.norm_z, p.norm_j};
  const ProbeStage<DZ> stage{w, p.eps, slots + threadIdx.x * o.size};
  const ProbeGrad<DZ> grad{slots, dz, H};
  cnf::adjoint_solve<DZ, false, kStageUnroll>(p.s, stage, grad, P, gp, gnew, K1p, K7p, red);
  if (blockIdx.x == 0) store_grad(gp, dz, H, p.gw1, p.gb1, p.gw2, p.gb2);
}

// The probe instance's kernel (K6).
struct ProbeArgs {
  AdjArgs a;
  int K, jvp;
};

template <int DZ>
__global__ void __launch_bounds__(kMaxBlock) k2_probe_adjoint(const ProbeArgs pa) {
  extern __shared__ __align__(16) float smem[];
  const AdjArgs& p = pa.a;
  const int H = p.H, dz = p.s.dz;
  const int P = 2 * dz * H + H + dz;
  float* w1t = smem;               // (H, DZ)
  float* w2p = w1t + H * DZ;       // (H, DZ)
  float* b2p = w2p + H * DZ;       // (DZ)
  float* b1 = b2p + DZ;            // (H)
  float* red = b1 + H;             // kRedFloats
  float* gp = red + kRedFloats;    // (P) g_p, the same in every block
  float* gnew = gp + P;            // (P) the proposed g_p
  float* K1p = gnew + P;           // (P) this block's stage-1 rate
  float* K7p = K1p + P;            // (P) this block's last-stage rate
  float* slots = K7p + P;          // blockDim.x slots
  const Slot<DZ> o(H);
  cnf::load_weights<DZ>(p.w1, p.b1, p.w2, p.b2, dz, H, w1t, w2p, b2p, b1);
  const Weights w{w1t, w2p, b1, b2p, H, dz, p.norm_z, p.norm_j};
  const ProbeLoopStage<DZ> stage{w, p.eps, slots + threadIdx.x * o.size, p.s.B, pa.K, pa.jvp};
  const ProbeLoopGrad<DZ> grad{slots, dz, H};
  cnf::adjoint_solve<DZ, false, kStageUnroll, true>(p.s, stage, grad, P, gp, gnew, K1p, K7p, red);
  if (blockIdx.x == 0) store_grad(gp, dz, H, p.gw1, p.gb1, p.gw2, p.gb2);
}

template <int DZ>
size_t smem_bytes(int dz, int H, int block) {
  const size_t P = 2 * (size_t)dz * H + H + dz;
  return sizeof(float) * (cnf::weight_floats<DZ>(H) + kRedFloats + 4 * P +
                          (size_t)block * Slot<DZ>(H).size);
}

}  // namespace

// Dynamic shared memory of one block (bytes), 0 for an unsupported dz.
extern "C" long long cnf_k2_smem_bytes(int dz, int H, int block) {
  switch (cnf::padded_dz(dz)) {
    case 4: return (long long)smem_bytes<4>(dz, H, block);
    case 8: return (long long)smem_bytes<8>(dz, H, block);
    case 16: return (long long)smem_bytes<16>(dz, H, block);
    case 32: return (long long)smem_bytes<32>(dz, H, block);
    default: return 0;
  }
}

// Largest co-resident grid for a cooperative launch (0 if none).
extern "C" int cnf_k2_max_grid(int dz, int H, int block, int* out) {
  switch (cnf::padded_dz(dz)) {
    case 4: return (int)cnf::coop_max_grid(k2_train_adjoint<4>, smem_bytes<4>(dz, H, block), block, out);
    case 8: return (int)cnf::coop_max_grid(k2_train_adjoint<8>, smem_bytes<8>(dz, H, block), block, out);
    case 16: return (int)cnf::coop_max_grid(k2_train_adjoint<16>, smem_bytes<16>(dz, H, block), block, out);
    case 32: return (int)cnf::coop_max_grid(k2_train_adjoint<32>, smem_bytes<32>(dz, H, block), block, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// accT/aaccT/acc0: (3, B).  gpart: 2 * grid * NG * P (NG = 3 for a tableau
// with btilde3, else 2).  tab: kTableauFloats floats (read_tableau).
// Returns the launch's cudaError_t.
extern "C" int cnf_k2_train_adjoint(const float* w1, const float* b1, const float* w2,
                                    const float* b2, const float* eps, const float* zT,
                                    const float* accT, const float* azT, const float* aaccT,
                                    const float* ts, float* z0, float* acc0, float* az0,
                                    float* gw1, float* gb1, float* gw2, float* gb2, int* stats,
                                    float* work, float* partials, float* gpart, int B, int dz,
                                    int H, int max_steps, int norm_z, int norm_j, float rtol,
                                    float atol, float beta1, float beta2, float inv_order,
                                    const float* tab, int grid, int block, void* stream) {
  if (block < 32 || block > kMaxBlock || block % 32 != 0 || grid < 1)
    return (int)cudaErrorInvalidValue;
  AdjArgs a = {};
  cnf::set_adj_state(&a.s, zT, accT, azT, aaccT, ts, z0, acc0, az0, stats, work, partials, gpart, B,
                     dz, max_steps, rtol, atol, beta1, beta2, inv_order, tab);
  a.w1 = w1; a.b1 = b1; a.w2 = w2; a.b2 = b2; a.eps = eps;
  a.gw1 = gw1; a.gb1 = gb1; a.gw2 = gw2; a.gb2 = gb2;
  a.H = H; a.norm_z = norm_z; a.norm_j = norm_j;
  cudaStream_t s = (cudaStream_t)stream;
  switch (cnf::padded_dz(dz)) {
    case 4: return (int)cnf::coop_launch(k2_train_adjoint<4>, a, grid, block, smem_bytes<4>(dz, H, block), s);
    case 8: return (int)cnf::coop_launch(k2_train_adjoint<8>, a, grid, block, smem_bytes<8>(dz, H, block), s);
    case 16: return (int)cnf::coop_launch(k2_train_adjoint<16>, a, grid, block, smem_bytes<16>(dz, H, block), s);
    case 32: return (int)cnf::coop_launch(k2_train_adjoint<32>, a, grid, block, smem_bytes<32>(dz, H, block), s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The probe instance (K6): its largest co-resident grid, and the backsolve as
// cnf_k2_train_adjoint's with eps (K, B, dz), K >= 1 probes, reverse mode or
// (jvp) forward mode.  Same shared memory as the one-probe instance.
extern "C" int cnf_k2p_max_grid(int dz, int H, int block, int* out) {
  switch (cnf::padded_dz(dz)) {
    case 4: return (int)cnf::coop_max_grid(k2_probe_adjoint<4>, smem_bytes<4>(dz, H, block), block, out);
    case 8: return (int)cnf::coop_max_grid(k2_probe_adjoint<8>, smem_bytes<8>(dz, H, block), block, out);
    case 16: return (int)cnf::coop_max_grid(k2_probe_adjoint<16>, smem_bytes<16>(dz, H, block), block, out);
    case 32: return (int)cnf::coop_max_grid(k2_probe_adjoint<32>, smem_bytes<32>(dz, H, block), block, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int cnf_k2_probe_adjoint(const float* w1, const float* b1, const float* w2,
                                    const float* b2, const float* eps, const float* zT,
                                    const float* accT, const float* azT, const float* aaccT,
                                    const float* ts, float* z0, float* acc0, float* az0,
                                    float* gw1, float* gb1, float* gw2, float* gb2, int* stats,
                                    float* work, float* partials, float* gpart, int B, int dz,
                                    int H, int max_steps, int norm_z, int norm_j, int K, int jvp, float rtol,
                                    float atol, float beta1, float beta2, float inv_order,
                                    const float* tab, int grid, int block, void* stream) {
  if (block < 32 || block > kMaxBlock || block % 32 != 0 || grid < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  ProbeArgs pa = {};
  AdjArgs& a = pa.a;
  cnf::set_adj_state(&a.s, zT, accT, azT, aaccT, ts, z0, acc0, az0, stats, work, partials, gpart, B,
                     dz, max_steps, rtol, atol, beta1, beta2, inv_order, tab);
  a.w1 = w1; a.b1 = b1; a.w2 = w2; a.b2 = b2; a.eps = eps;
  a.gw1 = gw1; a.gb1 = gb1; a.gw2 = gw2; a.gb2 = gb2;
  a.H = H; a.norm_z = norm_z; a.norm_j = norm_j;
  pa.K = K;
  pa.jvp = jvp;
  cudaStream_t s = (cudaStream_t)stream;
  switch (cnf::padded_dz(dz)) {
    case 4: return (int)cnf::coop_launch(k2_probe_adjoint<4>, pa, grid, block, smem_bytes<4>(dz, H, block), s);
    case 8: return (int)cnf::coop_launch(k2_probe_adjoint<8>, pa, grid, block, smem_bytes<8>(dz, H, block), s);
    case 16: return (int)cnf::coop_launch(k2_probe_adjoint<16>, pa, grid, block, smem_bytes<16>(dz, H, block), s);
    case 32: return (int)cnf::coop_launch(k2_probe_adjoint<32>, pa, grid, block, smem_bytes<32>(dz, H, block), s);
    default: return (int)cudaErrorInvalidValue;
  }
}
