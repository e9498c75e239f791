// The wide K2 chain form: the continuous-adjoint (backsolve) backward
// integration of a TRAIN-mode CNF whose field is an unconditional Dense
// chain of 2 to 8 tanh or identity layers with state width up to 64 and
// hidden widths up to 128 (the tabular MINIBOONE model 43 -> 128 -> 128 ->
// 43), one Hutchinson probe (reverse mode), the whole adaptive solve (any
// embedded explicit tableau, K9) from t_hi down to t_lo in one cooperative
// launch.
//
// Replaces, at these widths, the TPU kernel built by continuousnf_tpu/ops/
// fused_solve.py::_make_adjoint_kernel (:1064-1343), launched by
// make_full_solve.adjoint_solve (pl.pallas_call at :1767), with the N-layer
// _stage_train_fwdbwd (:372-481).  The state is, per sample, z (dz), acc
// (3), a_z (dz) and the constant a_acc (3), plus the batch-summed parameter
// gradient g_p (P = sum_i in_i out_i + out_i floats; 27,691 at MINIBOONE).
// Per sample and stage, the math of the K2 chain form (k2_chain_adjoint.cu):
// the forward pass, the probe pullback keeping u_l and the gated v_l, and
// the hand-derived VJP against (a_z, a_acc):
//   ascending the pullback chain, for layer i: ct_v = pu_i W_i,
//     pu_(i+1) = ct_v s'(h_(i+1)), ct_h(i+1) = -2 h_(i+1) (ct_v u_(i+1));
//   down the forward chain: ca_i = (ca_(i+1) W_(i+1)^T + ct_h(i+1)) (.) s';
//     ct_z = ca_0 W_0^T;
//   per-sample gradient of W_i: pu_i (x) v_i + h_i (x) ca_i, of b_i: ca_i.
// The probes are Monte-Carlo constants: no eps cotangent is integrated.
//
// Controller: adjoint_solve_tiles of solve_common.cuh: one batch-global
// Hairer norm over B * 2 (dz + 3) + P elements, g_p scaled by atol + rtol *
// max(|g_p|, |g_p_new|).  Per attempted step each block adds its tiles'
// b- and btilde-weighted g_p rates into its own global vectors; after the
// grid barrier each block reduces one slice of g_p over all blocks in block
// order, and a second barrier shares the slices' error sums.  adjoint_solve's
// all-blocks read (every block summing every block's 2 P floats: 28 MB a
// block and 3.6 GB a step at MINIBOONE and 128 blocks) became that slice
// reduction (2 P floats a block, 28 MB a step).  The TPU package runs two
// batch tiles of 1024 at MINIBOONE, B = 2048, each with its own controller;
// the port keeps the single-tile numerics, as for the other adjoints.
//
// Memory plan.  A block evaluates each stage for a tile of T samples (16, or
// 8 or 4 where the shared memory asks for it) through the wide chain layer of
// chain_wide.cuh.  Shared memory: the weights (27,862 floats at MINIBOONE);
// per tile row the solver's z, a_z, k_z (= y), k_az (4 x 44) and rates (3),
// five dz-vectors (eps, the gated probe v_N, eJ, the pullback cotangent
// pu_0 and ca_N: 5 x 44), four hidden blocks (activations h, pu, v, and u,
// which becomes ct_h and then ca in place: 4 x 256) and four per-row
// scalars: 1,427 floats a row, 22,832 at T = 16; 203 KB in all.
// Global memory: each block's GB, GE (and GE3), stage-1 and last-stage
// partials ((NG + 2) P floats a block: 57 MB at 128 blocks under tsit5),
// g and its proposal (P each).
//
// What bounds it on the H100: a stage is about 164 k FMA per sample at
// MINIBOONE (the forward pass, the pullback, its VJP and the forward chain's
// VJP: six tile products of 27 k) plus the gradient pass (2 FMA per sample
// and gradient entry: 55 k), 0.90 GFLOP at B = 2048, 13 us at the card's f32
// rate.  The tile products and the gradient pass are bound by shared-memory
// issue; per attempted step come two grid barriers and the slice reduction.
// Precision: f32 FMA on the CUDA cores, no TF32 and no tensor cores.
//
// The probe instance (K6 in the wide forms): the N-layer _stage_train_fwdbwd
// with k_probes = K and jvp (:396-431, the JVP branch :435-450), as the K2
// chain form's probe instance runs it for one sample, on adjoint_solve_tiles'
// PROBES form: after the forward pass each probe's pass and its VJP leave
// that probe's vectors in the tile arrays (for W_i: a_i (x) b_i) and the
// block adds their outer products into its g vectors (a flush), while the
// -2 h (.) gate terms are summed over the probes in a fifth hidden block HC
// and the output layer's in a sixth dz-vector CTY; then the rates, divided by
// K, and the forward chain's VJP with ca over the v block (in_i (x) ca_i and
// the biases).  VJP: a_i = pu_i, b_i = v_i as above.  JVP, the pushforward
// t_(l+1) = (t_l W_l) s'(h_(l+1)) (t_0 = eps) keeping u_l (pre-gate, U) and
// t_l (PU), and its VJP down the chain: ct_u = ct_t s'(h) (V), ct_h += -2 h
// (ct_t u), ct_t of the level below = ct_u W^T: a_i = t_i (eps for i = 0),
// b_i = ct_u of level i + 1.  Every probe's ct_tr and probe-norm factor
// carries 1/K.  Shared memory: one more hidden block and one more dz-vector
// a row than the one-probe stage (1,727 floats a row: 222,376 bytes at
// T = 16).  K and the direction are run-time values; the one-probe instance
// above stays as it was.
//
// The COND instance (K8 in the wide forms): _stage_train_fwdbwd of a
// conditional chain, whose first layer reads [z | ys] (:372-481 with _zin
// :265), one VJP probe.  The forward adds layer 0's ys rows to the
// pre-activation (wide_forward_cond, from the tile's (T, nc) ys rows); the
// probe has no ys rows, so the pullback, its VJP and their outer products
// read layer 0's z rows alone (ct_u = [ct_eJ | 0]); the forward chain's VJP
// gives layer 0's ys rows the gradient ys (x) ca_1 and each sample the ys
// cotangent, whose a_ys integrates k_ays = -(ca_1 (layer 0's ys rows)^T)
// (wide_ys_cotangent) in the tile solve's COND form
// (adjoint_solve_tiles): from 0 at t_hi, combined like a_z, inside
// the one batch-global norm, a_ys0 (B, nc) returned.  The tile's ys rows
// (T, nc) and k_ays (T, nc) take 2 nc floats a row more.  Its launch shape and entry are cnf_k2wc_shape and
// cnf_k2w_cond_adjoint.
//
// The probe COND instance (K6 x K8): the probe instance's stage on a
// conditional chain (_stage_train_fwdbwd with k_probes = K or jvp, on
// _zin), on adjoint_solve_tiles' PROBES and COND forms together.  The
// forward reads the tile's ys rows (wide_forward_cond).  The probe
// sub-passes give layer 0's ys rows no term: in VJP the pullback ends at
// layer 0's z rows and its VJP pads ct_u with zero ys rows (:451-455), so
// the ascent reads layer 0's z rows alone; in JVP the tangent [eps | 0]
// has zero ys rows (wide_pushforward<true>).  The forward chain's gradient
// pass gives layer 0's ys rows ys (x) ca_1, as the COND instance does, and
// k_ays = -(ca_1 (layer 0's ys rows)^T) comes from the forward chain's
// VJP, whose ca already holds every probe's -2 h gate terms (HC): a_ys
// depends on K and the direction.  Its shared arrays are the probe
// instance's with k_ays (T, nc) after the solver's rates and the tile's ys
// rows (T, nc) last; its launch shape and entry are cnf_k2wpc_shape and
// cnf_k2w_probe_cond_adjoint.

#include "chain_wide.cuh"

namespace {

constexpr int kStageUnroll = 4;
constexpr int kTiles[] = {16, 8, 4};

using cnf::ct_safe_norm;
using cnf::gate;
using cnf::kRedFloats;
using cnf::kWideBlock;
using cnf::level;
using cnf::safe_norm_sq;
using cnf::WideLayout;

struct AdjArgs {
  cnf::AdjState s;
  WideLayout L;
  const float* params;  // [W0 | b0 | W1 | b1 | ...]
  const float* eps;     // (B, dz) Hutchinson probe
  float* g;             // (P) the gradient, laid out as params
  float* gnew;          // (P) its proposal
  float* gblk;          // [gridDim.x][(NG + 2) P]
  int norm_z, norm_j, T;
};

// The tile arrays of the stage beside the solver's: five dz-vectors, four
// hidden blocks and four scalars a row.
struct TileArrays {
  float *E, *VL, *EJ, *CU, *CAL;  // (T, zp)
  float *HS, *PU, *V, *U;         // hidden blocks; U holds u, then ct_h, then ca
  float* SC;                      // (T, 4): fz, fn, ct_tr
};

__host__ __device__ inline size_t stage_floats(const WideLayout& L, int T) {
  return (size_t)T * (5 * L.zp + 4 * L.hsum + 4);
}

__host__ __device__ inline size_t tile_floats(const WideLayout& L, int T) {
  return (size_t)T * (4 * L.zp + 3) + stage_floats(L, T);
}

__device__ inline TileArrays tile_arrays(const WideLayout& L, int T, float* base) {
  TileArrays a;
  const int v = T * L.zp, h = T * L.hsum;
  a.E = base;
  a.VL = a.E + v;
  a.EJ = a.VL + v;
  a.CU = a.EJ + v;
  a.CAL = a.CU + v;
  a.HS = a.CAL + v;
  a.PU = a.HS + h;
  a.V = a.PU + h;
  a.U = a.V + h;
  a.SC = a.U + h;
  return a;
}

// A COND stage's conditioning: ys (B, nc) in global memory and the tile's
// (T, nc) rows in shared memory; nothing in an unconditional stage.
template <bool COND>
struct CondRows {};
template <>
struct CondRows<true> {
  const float* ys;
  float* YS;
};

// One augmented stage of a tile (fused_solve.py::_stage_train_fwdbwd with
// ct_y = a_z, ct_r = a_acc): KZ = y, KR = the rates, KAZ = -ct_z (and,
// COND, KYS = k_ays), and the residuals of the gradient pass left in the
// tile arrays.
template <bool COND>
struct WideAdjStage : CondRows<COND> {
  const WideLayout* L;
  const float* w;      // the shared weight region
  const float* eps;    // (B, dz)
  const float* aaccT;  // (3, B)
  TileArrays a;
  int B, T, norm_z, norm_j;

  __device__ void operator()(int s0, int nv, const float* Z, const float* AZ, float* KZ, float* KR, float* KAZ,
                             [[maybe_unused]] float* KYS = nullptr) const {
    const WideLayout& c = *L;
    const int n = c.n, dz = c.dz, zp = c.zp;
    const int on_y = c.act[n - 1];
    float *E = a.E, *VL = a.VL, *EJ = a.EJ, *CU = a.CU, *CAL = a.CAL, *SC = a.SC;
    if constexpr (COND) {
      cnf::load_tile_cond(this->ys, cnf::wide_nc(c), s0, nv, T, this->YS);
      cnf::wide_forward_cond(c, w, Z, this->YS, T, a.HS, KZ);
    } else {
      cnf::wide_forward(c, w, Z, T, a.HS, KZ);
    }
    for (int idx = threadIdx.x; idx < T * dz; idx += blockDim.x) {
      const int t = idx / dz, k = idx % dz;
      const float e = t < nv ? eps[(size_t)s0 * dz + idx] : 0.f;
      E[t * zp + k] = e;
      VL[t * zp + k] = e * gate(KZ[t * zp + k], on_y);
    }
    __syncthreads();
    // The pullback, keeping u_l (U) and the gated v_l (V) of every hidden
    // level, and eJ.
    for (int i = n - 1; i >= 1; --i) {
      const float* src = i == n - 1 ? VL : level(c, a.V, T, i + 1);
      float* u = level(c, a.U, T, i);
      float* v = level(c, a.V, T, i);
      const float* h = level(c, a.HS, T, i);
      const int hp = c.hp[i], on = c.act[i - 1];
      cnf::tile_mm_t(src, c.hp[i + 1], c.width[i + 1], w + c.wofs[i], c.pitch[i], c.width[i], T,
                     [&](int t, int k, float x) {
                       u[t * hp + k] = x;
                       v[t * hp + k] = x * gate(h[t * hp + k], on);
                     });
    }
    cnf::tile_mm_t(level(c, a.V, T, 1), c.hp[1], c.width[1], w + c.wofs[0], c.pitch[0], dz, T,
                   [&](int t, int k, float x) { EJ[t * zp + k] = x; });
    // The rates and their cotangent factors.  Rates row 0 is -tr:
    // ct_tr = -a_acc[0].
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      float ysq = 0.f, tr = 0.f, nsq = 0.f;
      for (int k = 0; k < dz; ++k) {
        const float y = KZ[t * zp + k], ej = EJ[t * zp + k];
        ysq = fmaf(y, y, ysq);
        tr = fmaf(ej, E[t * zp + k], tr);
        nsq = fmaf(ej, ej, nsq);
      }
      const float e_rate = safe_norm_sq(ysq), n_rate = safe_norm_sq(nsq);
      KR[t * 3 + 0] = -tr;
      KR[t * 3 + 1] = norm_z ? e_rate : 0.f;
      KR[t * 3 + 2] = norm_j ? n_rate : 0.f;
      float aacc[3];
      for (int r = 0; r < 3; ++r) aacc[r] = t < nv ? aaccT[(size_t)r * B + s0 + t] : 0.f;
      SC[t * 4 + 0] = norm_z ? ct_safe_norm(aacc[1], e_rate) : 0.f;
      SC[t * 4 + 1] = norm_j ? ct_safe_norm(aacc[2], n_rate) : 0.f;
      SC[t * 4 + 2] = -aacc[0];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < T * dz; idx += blockDim.x) {
      const int t = idx / dz, k = idx % dz;
      CU[t * zp + k] = fmaf(EJ[t * zp + k], SC[t * 4 + 1], E[t * zp + k] * SC[t * 4 + 2]);
    }
    __syncthreads();
    // Up the pullback chain: ct_v = pu_i W_i, pu_(i+1) = ct_v s'(h) and
    // ct_h = -2 h (ct_v u) over u in place (0 for an identity layer).  pu_0
    // has no ys rows: layer 0's product reads its z rows.
    for (int i = 0; i < n - 1; ++i) {
      const float* src = i == 0 ? CU : level(c, a.PU, T, i);
      float* pu = level(c, a.PU, T, i + 1);
      float* u = level(c, a.U, T, i + 1);
      const float* h = level(c, a.HS, T, i + 1);
      const int hp = c.hp[i + 1], on = c.act[i];
      cnf::tile_mm(src, c.hp[i], COND && i == 0 ? dz : c.width[i], w + c.wofs[i], c.pitch[i], nullptr,
                   c.width[i + 1], T,
                   [&](int t, int o, float cv) {
                     const float hh = h[t * hp + o];
                     pu[t * hp + o] = cv * gate(hh, on);
                     u[t * hp + o] = on ? (-2.f * hh) * (cv * u[t * hp + o]) : 0.f;
                   });
    }
    // The output layer: ct_h = a_z + y fz - 2 y (ct_v eps) (tanh; a_z + y fz
    // for identity), ca = ct_h s'(y).
    cnf::tile_mm(level(c, a.PU, T, n - 1), c.hp[n - 1], c.width[n - 1], w + c.wofs[n - 1], c.pitch[n - 1], nullptr,
                 dz, T, [&](int t, int k, float cv) {
                   const float y = KZ[t * zp + k], az = AZ[t * zp + k], fz = SC[t * 4];
                   const float ct_h = on_y ? fmaf(y, fz, az) + (-2.f * y) * (cv * E[t * zp + k]) : fmaf(y, fz, az);
                   CAL[t * zp + k] = ct_h * gate(y, on_y);
                 });
    // Down the forward chain: ca of the level below = (ca W^T + ct_h) s'(h),
    // over ct_h in place.
    for (int i = n - 1; i >= 1; --i) {
      const float* src = i == n - 1 ? CAL : level(c, a.U, T, i + 1);
      float* ca = level(c, a.U, T, i);
      const float* h = level(c, a.HS, T, i);
      const int hp = c.hp[i], on = c.act[i - 1];
      cnf::tile_mm_t(src, c.hp[i + 1], c.width[i + 1], w + c.wofs[i], c.pitch[i], c.width[i], T,
                     [&](int t, int k, float x) { ca[t * hp + k] = (x + ca[t * hp + k]) * gate(h[t * hp + k], on); });
    }
    cnf::tile_mm_t(level(c, a.U, T, 1), c.hp[1], c.width[1], w + c.wofs[0], c.pitch[0], dz, T,
                   [&](int t, int k, float x) { KAZ[t * zp + k] = -x; });
    if constexpr (COND) cnf::wide_ys_cotangent(c, w, level(c, a.U, T, 1), T, KYS);
  }
};

// The tile's sum over its first nv rows of the negated gradient rate of the
// stage just evaluated, entry q of the flat [W0 | b0 | W1 | b1 | ...]
// (COND: layer 0's ys rows get ys (x) ca_1 alone).
template <bool COND>
struct WideGrad : CondRows<COND> {
  const WideLayout* L;
  const float* Z;  // the solver's stage input z
  TileArrays a;
  int T;

  __device__ float operator()(int q, int nv) const {
    const WideLayout& c = *L;
    const int n = c.n;
    int i = 0;
    while (i + 1 < n && q >= c.pofs[i + 1]) ++i;
    const int in = c.width[i], out = c.width[i + 1];
    const int r = q - c.pofs[i];
    // Layer i reads the input level i (pitch ip) and the pullback cotangent
    // pu_i; its output side is v_i and ca_i (pitch op).
    const int ip = c.hp[i], op = c.hp[i + 1];
    const float* pd = i == n - 1 ? a.CAL : level(c, a.U, T, i + 1);
    float v = 0.f;
    if (r < in * out) {
      const int k = r / out, o = r % out;
      if constexpr (COND) {
        if (i == 0 && k >= c.dz) {
          const int nc = in - c.dz;
          const float* py = this->YS + (k - c.dz);
          pd += o;
          for (int t = 0; t < nv; ++t) v = fmaf(py[t * nc], pd[t * op], v);
          return -v;
        }
      }
      const float* pa = (i == 0 ? a.CU : level(c, a.PU, T, i)) + k;
      const float* pc = (i == 0 ? Z : level(c, a.HS, T, i)) + k;
      const float* pb = (i == n - 1 ? a.VL : level(c, a.V, T, i + 1)) + o;
      pd += o;
      for (int t = 0; t < nv; ++t) {
        v = fmaf(pa[t * ip], pb[t * op], v);
        v = fmaf(pc[t * ip], pd[t * op], v);
      }
    } else {
      pd += r - in * out;
      for (int t = 0; t < nv; ++t) v += pd[t * op];
    }
    return -v;
  }
};

// One block an SM (its shared memory allows no second), so the compiler may
// give a thread up to 255 registers: capped at 128 it spilled 1.4 KB.
__global__ void __launch_bounds__(kWideBlock, 1) k2_wide_adjoint(const AdjArgs p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ WideLayout L;
  cnf::share_layout(p.L, &L);
  const int T = p.T;
  float* w = smem;
  float* red = w + L.wfloats;
  float* scratch = red + kRedFloats;  // the solver's Z, AZ, KZ, KAZ, KR
  const TileArrays arrays = tile_arrays(L, T, scratch + T * (4 * L.zp + 3));
  cnf::load_wide_weights(p.params, L, w);
  __syncthreads();
  const WideAdjStage<false> stage{{}, &L, w, p.eps, p.s.aaccT, arrays, p.s.B, T, p.norm_z, p.norm_j};
  const WideGrad<false> grad{{}, &L, scratch, arrays, T};
  cnf::adjoint_solve_tiles<kStageUnroll>(p.s, stage, grad, L.P, T, scratch, p.gblk, p.g, p.gnew, red);
}

size_t smem_bytes(const WideLayout& L, int T) {
  return sizeof(float) * ((size_t)L.wfloats + kRedFloats + tile_floats(L, T));
}

// The COND instance's arguments: the one-probe instance's and the
// conditioning ys (B, nc).
struct CondAdjArgs {
  AdjArgs a;
  const float* ys;
};

// The COND instance's shared arrays past the solver's Z, AZ, KZ, KAZ, KR:
// k_ays (T, nc), then the stage's tile arrays, then the tile's ys rows
// (T, nc).
__host__ __device__ inline size_t cond_tile_floats(const WideLayout& L, int T) {
  return tile_floats(L, T) + (size_t)2 * T * cnf::wide_nc(L);
}

__global__ void __launch_bounds__(kWideBlock, 1) k2_wide_cond_adjoint(const __grid_constant__ CondAdjArgs ca) {
  extern __shared__ __align__(16) float smem[];
  __shared__ WideLayout L;
  const AdjArgs& p = ca.a;
  cnf::share_layout(p.L, &L);
  const int T = p.T, nc = cnf::wide_nc(L);
  float* w = smem;
  float* red = w + L.wfloats;
  float* scratch = red + kRedFloats;  // the solver's Z, AZ, KZ, KAZ, KR and KYS
  const TileArrays arrays = tile_arrays(L, T, scratch + T * (4 * L.zp + 3 + nc));
  float* YS = arrays.SC + T * 4;
  cnf::load_wide_weights(p.params, L, w);
  __syncthreads();
  const WideAdjStage<true> stage{{ca.ys, YS}, &L, w, p.eps, p.s.aaccT, arrays, p.s.B, T, p.norm_z, p.norm_j};
  const WideGrad<true> grad{{ca.ys, YS}, &L, scratch, arrays, T};
  cnf::adjoint_solve_tiles<kStageUnroll, false, 3, true>(p.s, stage, grad, L.P, T, scratch, p.gblk, p.g, p.gnew,
                                                           red);
}

size_t cond_smem_bytes(const WideLayout& L, int T) {
  return sizeof(float) * ((size_t)L.wfloats + kRedFloats + cond_tile_floats(L, T));
}

// The probe instance's tile arrays beside the solver's: six dz-vectors, five
// hidden blocks and four scalars a row.
struct ProbeArrays {
  float *E, *VL, *EJ, *CU, *CAL, *CTY;  // (T, zp); CAL holds t W_last (JVP) until the probes end
  float *HS, *PU, *V, *U, *HC;          // hidden blocks; V holds ca after the probes
  float* SC;                            // (T, 4): fn, the trace and probe-norm sums, ct_tr then fz
};

__host__ __device__ inline size_t probe_tile_floats(const WideLayout& L, int T) {
  return (size_t)T * (4 * L.zp + 3) + (size_t)T * (6 * L.zp + 5 * L.hsum + 4);
}

__device__ inline ProbeArrays probe_arrays(const WideLayout& L, int T, float* base) {
  ProbeArrays a;
  const int v = T * L.zp, h = T * L.hsum;
  a.E = base;
  a.VL = a.E + v;
  a.EJ = a.VL + v;
  a.CU = a.EJ + v;
  a.CAL = a.CU + v;
  a.CTY = a.CAL + v;
  a.HS = a.CTY + v;
  a.PU = a.HS + h;
  a.V = a.PU + h;
  a.U = a.V + h;
  a.HC = a.U + h;
  a.SC = a.HC + h;
  return a;
}

// The probe instance's stage of a tile (K6): the forward pass, then per
// probe its pass and that pass's VJP, leaving the probe's vectors for
// `flush`; then the rates and the forward chain's VJP (COND: and KYS =
// k_ays).
template <bool COND>
struct WideProbeStage : CondRows<COND> {
  const WideLayout* L;
  const float* w;      // the shared weight region
  const float* eps;    // (K, B, dz)
  const float* aaccT;  // (3, B)
  ProbeArrays a;
  int B, T, K, jvp, norm_z, norm_j;

  template <class Flush>
  __device__ void probes(int s0, int nv, const float* Z, const float* AZ, float* KZ, float* KR, float* KAZ,
                         const Flush& flush, [[maybe_unused]] float* KYS = nullptr) const {
    const WideLayout& c = *L;
    const int n = c.n, dz = c.dz, zp = c.zp, hs = c.hsum;
    const int on_y = c.act[n - 1];
    float *E = a.E, *VL = a.VL, *EJ = a.EJ, *CU = a.CU, *CAL = a.CAL, *CTY = a.CTY, *SC = a.SC;
    const float inv_k = 1.f / K;
    if constexpr (COND) {
      cnf::load_tile_cond(this->ys, cnf::wide_nc(c), s0, nv, T, this->YS);
      cnf::wide_forward_cond(c, w, Z, this->YS, T, a.HS, KZ);
    } else {
      cnf::wide_forward(c, w, Z, T, a.HS, KZ);
    }
    for (int idx = threadIdx.x; idx < T * hs; idx += blockDim.x) a.HC[idx] = 0.f;
    for (int idx = threadIdx.x; idx < T * zp; idx += blockDim.x) CTY[idx] = 0.f;
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      SC[t * 4 + 1] = 0.f;
      SC[t * 4 + 2] = 0.f;
      SC[t * 4 + 3] = t < nv ? -aaccT[s0 + t] * inv_k : 0.f;  // ct_tr: rates row 0 is -tr over K probes
    }
    __syncthreads();
    for (int pk = 0; pk < K; ++pk) {
      const float* ek = eps + ((size_t)pk * B + s0) * dz;
      for (int idx = threadIdx.x; idx < T * dz; idx += blockDim.x) {
        const int t = idx / dz, k = idx % dz;
        const float e = t < nv ? ek[idx] : 0.f;
        E[t * zp + k] = e;
        if (!jvp) VL[t * zp + k] = e * gate(KZ[t * zp + k], on_y);
      }
      __syncthreads();
      if (jvp) {
        // The pushforward, keeping u_l (U) and t_l (PU); t W_last to CAL.
        cnf::wide_pushforward<COND>(c, w, E, T, a.HS, a.U, a.PU, CAL);
        for (int idx = threadIdx.x; idx < T * dz; idx += blockDim.x) {
          const int t = idx / dz, k = idx % dz;
          EJ[t * zp + k] = CAL[t * zp + k] * gate(KZ[t * zp + k], on_y);
        }
        __syncthreads();
      } else {
        // The pullback, keeping u_l (U) and the gated v_l (V), and eJ.
        for (int i = n - 1; i >= 1; --i) {
          const float* src = i == n - 1 ? VL : level(c, a.V, T, i + 1);
          float* u = level(c, a.U, T, i);
          float* v = level(c, a.V, T, i);
          const float* h = level(c, a.HS, T, i);
          const int hp = c.hp[i], on = c.act[i - 1];
          cnf::tile_mm_t(src, c.hp[i + 1], c.width[i + 1], w + c.wofs[i], c.pitch[i], c.width[i], T,
                         [&](int t, int k, float x) {
                           u[t * hp + k] = x;
                           v[t * hp + k] = x * gate(h[t * hp + k], on);
                         });
        }
        cnf::tile_mm_t(level(c, a.V, T, 1), c.hp[1], c.width[1], w + c.wofs[0], c.pitch[0], dz, T,
                       [&](int t, int k, float x) { EJ[t * zp + k] = x; });
      }
      // The probe's trace and norm terms, and its norm cotangent factor.
      for (int t = threadIdx.x; t < T; t += blockDim.x) {
        float tr = 0.f, nsq = 0.f;
        for (int k = 0; k < dz; ++k) {
          const float ej = EJ[t * zp + k];
          tr = fmaf(ej, E[t * zp + k], tr);
          nsq = fmaf(ej, ej, nsq);
        }
        const float nk = safe_norm_sq(nsq);
        SC[t * 4 + 1] += tr;
        SC[t * 4 + 2] += nk;
        const float ct_n = t < nv ? aaccT[(size_t)2 * B + s0 + t] * inv_k : 0.f;
        SC[t * 4 + 0] = norm_j ? ct_safe_norm(ct_n, nk) : 0.f;
      }
      __syncthreads();
      if (jvp) {
        // Down the pushforward: ct_Je = eps ct_tr + Je fn, ct_u = ct_Je s'(y)
        // (VL), cty += -2 y (ct_Je t W); each level's ct_t = ct_u W^T,
        // ct_u = ct_t s'(h) (V), hc += -2 h (ct_t u); a_0 = eps (CU).
        for (int idx = threadIdx.x; idx < T * dz; idx += blockDim.x) {
          const int t = idx / dz, k = idx % dz, o = t * zp + k;
          const float y = KZ[o], e = E[o];
          const float ct = fmaf(EJ[o], SC[t * 4 + 0], e * SC[t * 4 + 3]);
          VL[o] = ct * gate(y, on_y);
          if (on_y) CTY[o] += (-2.f * y) * (ct * CAL[o]);
          CU[o] = e;
        }
        __syncthreads();
        for (int i = n - 1; i >= 1; --i) {
          const float* src = i == n - 1 ? VL : level(c, a.V, T, i + 1);
          float* v = level(c, a.V, T, i);
          float* hc = level(c, a.HC, T, i);
          const float* u = level(c, a.U, T, i);
          const float* h = level(c, a.HS, T, i);
          const int hp = c.hp[i], on = c.act[i - 1];
          cnf::tile_mm_t(src, c.hp[i + 1], c.width[i + 1], w + c.wofs[i], c.pitch[i], c.width[i], T,
                         [&](int t, int k, float ct) {
                           const int o = t * hp + k;
                           const float hh = h[o];
                           v[o] = ct * gate(hh, on);
                           if (on) hc[o] += (-2.f * hh) * (ct * u[o]);
                         });
        }
      } else {
        // Up the pullback: cu = eps ct_tr + eJ fn (CU); per layer ct_v = pu W,
        // pu of the level above = ct_v s'(h), hc += -2 h (ct_v u); at the
        // output cty += -2 y (ct_v eps).  cu has no ys rows: layer 0's
        // product reads its z rows.
        for (int idx = threadIdx.x; idx < T * dz; idx += blockDim.x) {
          const int t = idx / dz, k = idx % dz, o = t * zp + k;
          CU[o] = fmaf(EJ[o], SC[t * 4 + 0], E[o] * SC[t * 4 + 3]);
        }
        __syncthreads();
        for (int i = 0; i < n - 1; ++i) {
          const float* src = i == 0 ? CU : level(c, a.PU, T, i);
          float* pu = level(c, a.PU, T, i + 1);
          float* hc = level(c, a.HC, T, i + 1);
          const float* u = level(c, a.U, T, i + 1);
          const float* h = level(c, a.HS, T, i + 1);
          const int hp = c.hp[i + 1], on = c.act[i];
          cnf::tile_mm(src, c.hp[i], COND && i == 0 ? dz : c.width[i], w + c.wofs[i], c.pitch[i], nullptr,
                       c.width[i + 1], T, [&](int t, int o, float cv) {
                         const int x = t * hp + o;
                         const float hh = h[x];
                         pu[x] = cv * gate(hh, on);
                         if (on) hc[x] += (-2.f * hh) * (cv * u[x]);
                       });
        }
        if (on_y)
          cnf::tile_mm(level(c, a.PU, T, n - 1), c.hp[n - 1], c.width[n - 1], w + c.wofs[n - 1], c.pitch[n - 1],
                       nullptr, dz, T, [&](int t, int k, float cv) {
                         const int o = t * zp + k;
                         CTY[o] += (-2.f * KZ[o]) * (cv * E[o]);
                       });
      }
      flush();
    }
    // The rates, averaged over the probes, and fz.
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      float ysq = 0.f;
      for (int k = 0; k < dz; ++k) ysq = fmaf(KZ[t * zp + k], KZ[t * zp + k], ysq);
      const float e_rate = safe_norm_sq(ysq);
      KR[t * 3 + 0] = -(SC[t * 4 + 1] / K);
      KR[t * 3 + 1] = norm_z ? e_rate : 0.f;
      KR[t * 3 + 2] = norm_j ? SC[t * 4 + 2] / K : 0.f;
      const float aacc1 = t < nv ? aaccT[(size_t)B + s0 + t] : 0.f;
      SC[t * 4 + 3] = norm_z ? ct_safe_norm(aacc1, e_rate) : 0.f;
    }
    __syncthreads();
    // Down the forward chain: cal = (a_z + y fz + cty) s'(y); ca of the level
    // below = (ca W^T + hc) s'(h), over V.
    for (int idx = threadIdx.x; idx < T * dz; idx += blockDim.x) {
      const int t = idx / dz, k = idx % dz, o = t * zp + k;
      const float y = KZ[o];
      CAL[o] = (fmaf(y, SC[t * 4 + 3], AZ[o]) + CTY[o]) * gate(y, on_y);
    }
    __syncthreads();
    for (int i = n - 1; i >= 1; --i) {
      const float* src = i == n - 1 ? CAL : level(c, a.V, T, i + 1);
      float* ca = level(c, a.V, T, i);
      const float* hc = level(c, a.HC, T, i);
      const float* h = level(c, a.HS, T, i);
      const int hp = c.hp[i], on = c.act[i - 1];
      cnf::tile_mm_t(src, c.hp[i + 1], c.width[i + 1], w + c.wofs[i], c.pitch[i], c.width[i], T,
                     [&](int t, int k, float x) { ca[t * hp + k] = (x + hc[t * hp + k]) * gate(h[t * hp + k], on); });
    }
    cnf::tile_mm_t(level(c, a.V, T, 1), c.hp[1], c.width[1], w + c.wofs[0], c.pitch[0], dz, T,
                   [&](int t, int k, float x) { KAZ[t * zp + k] = -x; });
    if constexpr (COND) cnf::wide_ys_cotangent(c, w, level(c, a.V, T, 1), T, KYS);
  }
};

// The probe instance's gradient terms (K6): the tile's sum over its first
// nv rows of the negated gradient rate entry q, a probe's part (a_i (x) b_i;
// nothing for a bias) or the forward chain's (in_i (x) ca_i, the biases).
// COND: layer 0's ys rows get no probe part and ys (x) ca_1 from the
// forward chain.
template <bool COND>
struct WideProbeGrad : CondRows<COND> {
  const WideLayout* L;
  const float* Z;  // the solver's stage input z
  ProbeArrays a;
  int T;

  template <bool PROBE>
  __device__ __forceinline__ float entry(int q, int nv) const {
    const WideLayout& c = *L;
    const int n = c.n;
    int i = 0;
    while (i + 1 < n && q >= c.pofs[i + 1]) ++i;
    const int in = c.width[i], out = c.width[i + 1];
    const int r = q - c.pofs[i];
    const int ip = c.hp[i], op = c.hp[i + 1];
    float v = 0.f;
    if (r < in * out) {
      const int k = r / out, o = r % out;
      if constexpr (COND) {
        if (i == 0 && k >= c.dz) {
          if (PROBE) return 0.f;
          const int nc = in - c.dz;
          const float* py = this->YS + (k - c.dz);
          const float* pd = level(c, a.V, T, 1) + o;
          for (int t = 0; t < nv; ++t) v = fmaf(py[t * nc], pd[t * op], v);
          return -v;
        }
      }
      const float* px = (PROBE ? (i == 0 ? a.CU : level(c, a.PU, T, i)) : (i == 0 ? Z : level(c, a.HS, T, i))) + k;
      const float* py = (PROBE ? (i == n - 1 ? a.VL : level(c, a.V, T, i + 1))
                               : (i == n - 1 ? a.CAL : level(c, a.V, T, i + 1))) + o;
      for (int t = 0; t < nv; ++t) v = fmaf(px[t * ip], py[t * op], v);
    } else {
      if (PROBE) return 0.f;
      const float* pd = (i == n - 1 ? a.CAL : level(c, a.V, T, i + 1)) + (r - in * out);
      for (int t = 0; t < nv; ++t) v += pd[t * op];
    }
    return -v;
  }
  __device__ float probe(int q, int nv) const { return entry<true>(q, nv); }
  __device__ float fwd(int q, int nv) const { return entry<false>(q, nv); }
};

struct ProbeArgs {
  AdjArgs a;
  int K, jvp;
};

__global__ void __launch_bounds__(kWideBlock, 1) k2_wide_probe_adjoint(const ProbeArgs pa) {
  extern __shared__ __align__(16) float smem[];
  __shared__ WideLayout L;
  const AdjArgs& p = pa.a;
  cnf::share_layout(p.L, &L);
  const int T = p.T;
  float* w = smem;
  float* red = w + L.wfloats;
  float* scratch = red + kRedFloats;  // the solver's Z, AZ, KZ, KAZ, KR
  const ProbeArrays arrays = probe_arrays(L, T, scratch + T * (4 * L.zp + 3));
  cnf::load_wide_weights(p.params, L, w);
  __syncthreads();
  const WideProbeStage<false> stage{{}, &L, w, p.eps, p.s.aaccT, arrays, p.s.B, T, pa.K, pa.jvp, p.norm_z, p.norm_j};
  const WideProbeGrad<false> grad{{}, &L, scratch, arrays, T};
  cnf::adjoint_solve_tiles<kStageUnroll, true>(p.s, stage, grad, L.P, T, scratch, p.gblk, p.g, p.gnew, red);
}

size_t probe_smem_bytes(const WideLayout& L, int T) {
  return sizeof(float) * ((size_t)L.wfloats + kRedFloats + probe_tile_floats(L, T));
}

// The probe COND instance's arguments (K6 x K8): the probe instance's and
// the conditioning ys (B, nc).
struct ProbeCondArgs {
  ProbeArgs pa;
  const float* ys;
};

// The probe COND instance's shared arrays past the solver's Z, AZ, KZ, KAZ,
// KR: k_ays (T, nc), then the probe instance's tile arrays, then the tile's
// ys rows (T, nc).
__host__ __device__ inline size_t probe_cond_tile_floats(const WideLayout& L, int T) {
  return probe_tile_floats(L, T) + (size_t)2 * T * cnf::wide_nc(L);
}

__global__ void __launch_bounds__(kWideBlock, 1)
    k2_wide_probe_cond_adjoint(const __grid_constant__ ProbeCondArgs pc) {
  extern __shared__ __align__(16) float smem[];
  __shared__ WideLayout L;
  const ProbeArgs& pa = pc.pa;
  const AdjArgs& p = pa.a;
  cnf::share_layout(p.L, &L);
  const int T = p.T, nc = cnf::wide_nc(L);
  float* w = smem;
  float* red = w + L.wfloats;
  float* scratch = red + kRedFloats;  // the solver's Z, AZ, KZ, KAZ, KR and KYS
  const ProbeArrays arrays = probe_arrays(L, T, scratch + T * (4 * L.zp + 3 + nc));
  float* YS = arrays.SC + T * 4;
  cnf::load_wide_weights(p.params, L, w);
  __syncthreads();
  const WideProbeStage<true> stage{
      {pc.ys, YS}, &L, w, p.eps, p.s.aaccT, arrays, p.s.B, T, pa.K, pa.jvp, p.norm_z, p.norm_j};
  const WideProbeGrad<true> grad{{pc.ys, YS}, &L, scratch, arrays, T};
  cnf::adjoint_solve_tiles<kStageUnroll, true, 3, true>(p.s, stage, grad, L.P, T, scratch, p.gblk, p.g, p.gnew,
                                                          red);
}

size_t probe_cond_smem_bytes(const WideLayout& L, int T) {
  return sizeof(float) * ((size_t)L.wfloats + kRedFloats + probe_cond_tile_floats(L, T));
}

}  // namespace

// The launch shape at batch B: out = {threads per block, blocks, samples a
// tile, dynamic shared memory bytes}, the largest tile whose shared memory
// leaves a co-resident grid.  widths: n + 1 level widths (host memory).
// Returns a cudaError_t (cudaErrorInvalidValue for a chain not covered).
extern "C" int cnf_k2w_shape(int n, const int* widths, int B, int* out) {
  WideLayout L;
  if (B < 1 || !cnf::make_wide_layout(n, widths, &L)) return (int)cudaErrorInvalidValue;
  size_t smem[3];
  for (int o = 0; o < 3; ++o) smem[o] = smem_bytes(L, kTiles[o]);
  return cnf::wide_shape(k2_wide_adjoint, smem, kTiles, kTiles, 3, B, out);
}

// params/g: [W0 | b0 | ...] flat (device); eps, zT, azT, z0, az0: (B, dz);
// acts: bit i set where layer i is tanh (else identity); accT/aaccT/acc0:
// (3, B).  work: (S + 2) (2 dz + 3) B floats; partials: 10 grid; gblk:
// grid (NG + 2) P (NG = 3 for a tableau with btilde3, else 2); gnew: P.
// tab: kTableauFloats floats (read_tableau).  T, grid, block: from
// cnf_k2w_shape.  Returns the launch's cudaError_t.
extern "C" int cnf_k2w_train_adjoint(const float* params, const float* eps, const float* zT, const float* accT,
                                     const float* azT, const float* aaccT, const float* ts, float* z0, float* acc0,
                                     float* az0, float* g, int* stats, float* work, float* partials, float* gblk,
                                     float* gnew, int B, int n, const int* widths, int acts, int max_steps,
                                     int norm_z, int norm_j, float rtol, float atol, float beta1, float beta2,
                                     float inv_order, const float* tab, int T, int grid, int block, void* stream) {
  AdjArgs a = {};
  if (block != kWideBlock || grid < 1 || T < cnf::kRows || T % cnf::kRows != 0 ||
      !cnf::make_wide_layout(n, widths, &a.L))
    return (int)cudaErrorInvalidValue;
  cnf::set_wide_acts(&a.L, acts);
  cnf::set_adj_state(&a.s, zT, accT, azT, aaccT, ts, z0, acc0, az0, stats, work, partials, nullptr, B, widths[n],
                     max_steps, rtol, atol, beta1, beta2, inv_order, tab);
  a.params = params;
  a.eps = eps;
  a.g = g;
  a.gnew = gnew;
  a.gblk = gblk;
  a.norm_z = norm_z;
  a.norm_j = norm_j;
  a.T = T;
  return (int)cnf::coop_launch(k2_wide_adjoint, a, grid, block, smem_bytes(a.L, T), (cudaStream_t)stream);
}

// The probe instance's launch shape (K6), as cnf_k2w_shape.
extern "C" int cnf_k2wp_shape(int n, const int* widths, int B, int* out) {
  WideLayout L;
  if (B < 1 || !cnf::make_wide_layout(n, widths, &L)) return (int)cudaErrorInvalidValue;
  size_t smem[3];
  for (int o = 0; o < 3; ++o) smem[o] = probe_smem_bytes(L, kTiles[o]);
  return cnf::wide_shape(k2_wide_probe_adjoint, smem, kTiles, kTiles, 3, B, out);
}

// The probe instance (K6): as cnf_k2w_train_adjoint with eps (K, B, dz),
// K >= 1 probes, reverse mode or (jvp) forward mode; T, grid, block from
// cnf_k2wp_shape.
extern "C" int cnf_k2w_probe_adjoint(const float* params, const float* eps, const float* zT, const float* accT,
                                     const float* azT, const float* aaccT, const float* ts, float* z0, float* acc0,
                                     float* az0, float* g, int* stats, float* work, float* partials, float* gblk,
                                     float* gnew, int B, int n, const int* widths, int acts, int max_steps,
                                     int norm_z, int norm_j, int K, int jvp, float rtol, float atol, float beta1,
                                     float beta2, float inv_order, const float* tab, int T, int grid, int block,
                                     void* stream) {
  ProbeArgs pa = {};
  AdjArgs& a = pa.a;
  if (block != kWideBlock || grid < 1 || T < cnf::kRows || T % cnf::kRows != 0 || K < 1 ||
      !cnf::make_wide_layout(n, widths, &a.L))
    return (int)cudaErrorInvalidValue;
  cnf::set_wide_acts(&a.L, acts);
  cnf::set_adj_state(&a.s, zT, accT, azT, aaccT, ts, z0, acc0, az0, stats, work, partials, nullptr, B, widths[n],
                     max_steps, rtol, atol, beta1, beta2, inv_order, tab);
  a.params = params;
  a.eps = eps;
  a.g = g;
  a.gnew = gnew;
  a.gblk = gblk;
  a.norm_z = norm_z;
  a.norm_j = norm_j;
  a.T = T;
  pa.K = K;
  pa.jvp = jvp;
  return (int)cnf::coop_launch(k2_wide_probe_adjoint, pa, grid, block, probe_smem_bytes(a.L, T),
                               (cudaStream_t)stream);
}

// The COND instance's launch shape (K8), as cnf_k2w_shape; widths[0] =
// dz + nc with nc >= 1.
extern "C" int cnf_k2wc_shape(int n, const int* widths, int B, int* out) {
  WideLayout L;
  if (B < 1 || !cnf::make_wide_layout(n, widths, &L, true)) return (int)cudaErrorInvalidValue;
  size_t smem[3];
  for (int o = 0; o < 3; ++o) smem[o] = cond_smem_bytes(L, kTiles[o]);
  return cnf::wide_shape(k2_wide_cond_adjoint, smem, kTiles, kTiles, 3, B, out);
}

// The COND instance (K8): as cnf_k2w_train_adjoint for a conditional chain,
// with ys (B, nc) (device) and ays0 (B, nc), nc = widths[0] - widths[n] >= 1,
// the cotangent of ys at t_lo; work: (S + 2) (2 dz + 3 + nc) B floats; T,
// grid, block from cnf_k2wc_shape.
extern "C" int cnf_k2w_cond_adjoint(const float* params, const float* eps, const float* ys, const float* zT,
                                    const float* accT, const float* azT, const float* aaccT, const float* ts,
                                    float* z0, float* acc0, float* az0, float* ays0, float* g, int* stats, float* work,
                                    float* partials, float* gblk, float* gnew, int B, int n, const int* widths,
                                    int acts, int max_steps, int norm_z, int norm_j, float rtol, float atol,
                                    float beta1, float beta2, float inv_order, const float* tab, int T, int grid,
                                    int block, void* stream) {
  CondAdjArgs ca = {};
  AdjArgs& a = ca.a;
  if (block != kWideBlock || grid < 1 || T < cnf::kRows || T % cnf::kRows != 0 || ys == nullptr ||
      ays0 == nullptr || !cnf::make_wide_layout(n, widths, &a.L, true))
    return (int)cudaErrorInvalidValue;
  cnf::set_wide_acts(&a.L, acts);
  cnf::set_adj_state(&a.s, zT, accT, azT, aaccT, ts, z0, acc0, az0, stats, work, partials, nullptr, B, widths[n],
                     max_steps, rtol, atol, beta1, beta2, inv_order, tab);
  a.s.nc = cnf::wide_nc(a.L);
  a.s.ays0 = ays0;
  a.params = params;
  a.eps = eps;
  a.g = g;
  a.gnew = gnew;
  a.gblk = gblk;
  a.norm_z = norm_z;
  a.norm_j = norm_j;
  a.T = T;
  ca.ys = ys;
  return (int)cnf::coop_launch(k2_wide_cond_adjoint, ca, grid, block, cond_smem_bytes(a.L, T),
                               (cudaStream_t)stream);
}

// The probe COND instance's launch shape (K6 x K8), as cnf_k2wc_shape.
extern "C" int cnf_k2wpc_shape(int n, const int* widths, int B, int* out) {
  WideLayout L;
  if (B < 1 || !cnf::make_wide_layout(n, widths, &L, true)) return (int)cudaErrorInvalidValue;
  size_t smem[3];
  for (int o = 0; o < 3; ++o) smem[o] = probe_cond_smem_bytes(L, kTiles[o]);
  return cnf::wide_shape(k2_wide_probe_cond_adjoint, smem, kTiles, kTiles, 3, B, out);
}

// The probe COND instance (K6 x K8): as cnf_k2w_cond_adjoint with eps
// (K, B, dz), K >= 1 probes, reverse mode or (jvp) forward mode; T, grid,
// block from cnf_k2wpc_shape.
extern "C" int cnf_k2w_probe_cond_adjoint(const float* params, const float* eps, const float* ys, const float* zT,
                                          const float* accT, const float* azT, const float* aaccT, const float* ts,
                                          float* z0, float* acc0, float* az0, float* ays0, float* g, int* stats,
                                          float* work, float* partials, float* gblk, float* gnew, int B, int n,
                                          const int* widths, int acts, int max_steps, int norm_z, int norm_j, int K,
                                          int jvp, float rtol, float atol, float beta1, float beta2, float inv_order,
                                          const float* tab, int T, int grid, int block, void* stream) {
  ProbeCondArgs pc = {};
  AdjArgs& a = pc.pa.a;
  if (block != kWideBlock || grid < 1 || T < cnf::kRows || T % cnf::kRows != 0 || K < 1 || ys == nullptr ||
      ays0 == nullptr || !cnf::make_wide_layout(n, widths, &a.L, true))
    return (int)cudaErrorInvalidValue;
  cnf::set_wide_acts(&a.L, acts);
  cnf::set_adj_state(&a.s, zT, accT, azT, aaccT, ts, z0, acc0, az0, stats, work, partials, nullptr, B, widths[n],
                     max_steps, rtol, atol, beta1, beta2, inv_order, tab);
  a.s.nc = cnf::wide_nc(a.L);
  a.s.ays0 = ays0;
  a.params = params;
  a.eps = eps;
  a.g = g;
  a.gnew = gnew;
  a.gblk = gblk;
  a.norm_z = norm_z;
  a.norm_j = norm_j;
  a.T = T;
  pc.pa.K = K;
  pc.pa.jvp = jvp;
  pc.ys = ys;
  return (int)cnf::coop_launch(k2_wide_probe_cond_adjoint, pc, grid, block, probe_cond_smem_bytes(a.L, T),
                               (cudaStream_t)stream);
}
