// The streamed K2 chain form: the continuous-adjoint (backsolve) backward
// integration of a TRAIN-mode CNF whose field is an unconditional Dense
// chain of 2 to 4 tanh or identity layers with state width up to 128 and
// hidden widths past what the wide forms keep in shared memory (FFJORD's
// tabular MINIBOONE model 43 -> 860 -> 860 -> 43), one Hutchinson probe
// (reverse mode), the whole adaptive solve (any embedded explicit tableau,
// K9) from t_hi down to t_lo in one cooperative launch.
//
// Replaces, at these widths, the TPU kernel built by continuousnf_tpu/ops/
// fused_solve.py::_make_adjoint_kernel (:1064-1343), launched by
// make_full_solve.adjoint_solve (pl.pallas_call at :1767), with the N-layer
// _stage_train_fwdbwd (:372-481).  The state is, per sample, z (dz), acc
// (3), a_z (dz) and the constant a_acc (3), plus the batch-summed parameter
// gradient g_p (P = sum_i in_i out_i + out_i floats; 815,323 at 860 wide).
// Per sample and stage, the math of the wide K2 chain form
// (k2_wide_adjoint.cu): the forward pass, the probe pullback keeping u_l and
// the gated v_l, and the hand-derived VJP against (a_z, a_acc):
//   ascending the pullback chain, for layer i: ct_v = pu_i W_i,
//     pu_(i+1) = ct_v s'(h_(i+1)), ct_h(i+1) = -2 h_(i+1) (ct_v u_(i+1));
//   down the forward chain: ca_i = (ca_(i+1) W_(i+1)^T + ct_h(i+1)) (.) s';
//     ct_z = ca_0 W_0^T;
//   per-sample gradient of W_i: pu_i (x) v_i + h_i (x) ca_i, of b_i: ca_i.
//
// Controller: adjoint_solve_tiles of solve_common.cuh, unchanged: one
// batch-global Hairer norm over B * 2 (dz + 3) + P elements, each block's
// b- and btilde-weighted g_p rates in its own global vectors, reduced one
// slice a block after the grid barrier and the slices' error sums shared
// after a second.  The JAX package runs four batch tiles of 256 at B = 1024;
// the port keeps the single-tile numerics, as for the other adjoints.
//
// Memory plan.  A block evaluates each stage for a tile of T samples (8, or
// 4 where the shared memory asks for it: 4 at 860 wide) through the
// streamed chain layer of chain_stream.cuh (the weights in global memory,
// L2-resident, through a 17 KB chunk buffer).  Per tile row the solver's z,
// a_z, k_z (= y), k_az (4 x 44) and rates (3), five dz-vectors (eps, the
// gated probe v_N, eJ, the pullback cotangent pu_0 and ca_N), four hidden
// blocks (activations h, pu, v, and u, which becomes ct_h and then ca in
// place: 4 x 1,720 at 860 wide) and four per-row scalars sit in shared
// memory (134 KB at T = 4 with the chunk buffer), or in a global scratch for
// wider nets.  Global memory: each block's GB, GE (and GE3), stage-1 and
// last-stage partials ((NG + 2) P floats a block: 1.7 GB at 132 blocks under
// tsit5), g and its proposal (P each).
//
// What bounds it on the H100: a stage is six passes over the weights per
// sample (the forward pass, the pullback, its VJP and the forward chain's
// VJP: 4.9 M FMA at 860 wide) plus the gradient pass (2 FMA per sample and
// gradient entry: 1.6 M), 13 GFLOP at B = 1024, 0.2 ms at the card's f32
// rate.  The gradient pass rewrites each block's (NG + 1) P-float vectors
// for every tile and stage (20 MB a block, 2.6 GB for 132 blocks): device
// memory bandwidth bounds it at this P (ROADMAP speed row (m) proposes the
// batch-wide reduction that removes it).
// Precision: f32 FMA on the CUDA cores, no TF32 and no tensor cores.
//
// The probe instance (K6 in the streamed forms): the N-layer
// _stage_train_fwdbwd with k_probes = K and jvp (:396-431, the JVP branch
// :435-450), as the wide K2 chain form's probe instance runs it
// (k2_wide_adjoint.cu), on adjoint_solve_tiles' PROBES form: after the
// forward pass each probe's pass and its VJP leave that probe's vectors in
// the tile arrays (for W_i: a_i (x) b_i) and the block adds their outer
// products into its g vectors (a flush), while the -2 h (.) gate terms are
// summed over the probes in a fifth hidden block HC and the output layer's
// in a sixth dz-vector CTY; then the rates, divided by K, and the forward
// chain's VJP with ca over the v block (in_i (x) ca_i and the biases).
// VJP: a_i = pu_i, b_i = v_(i+1) as above.  JVP: the pushforward
// t_(l+1) = (t_l W_l) s'(h_(l+1)) (t_0 = eps, stream_pushforward) keeping
// u_l (pre-gate, U) and t_l (PU), and its VJP down the chain: ct_u = ct_t
// s'(h) (V), ct_h += -2 h (ct_t u), ct_t of the level below = ct_u W^T:
// a_i = t_i (eps for i = 0), b_i = ct_u of level i + 1.  Every probe's ct_tr
// and probe-norm factor carries 1/K.  Tile arrays: one more hidden block
// and one more dz-vector a row than the one-probe stage (9,047 floats a row
// at 860 wide: T = 4, 162 KB with the chunk buffer).  The forward pass, a
// probe's pass with its VJP, and the forward chain's VJP are functions of
// their own, so the flush between them (P entries a block and probe) keeps
// its registers.  Design of the gradient: the flushes of the PROBES form,
// as in the wide probe instance: per tile, stage and probe each block
// reads and rewrites its g vectors, (K + 1) times a tile and stage.  On an
// NVIDIA H100 80GB HBM3 (700 W) at 860 wide each flush costs about a
// one-probe step (PERF.md): one block of 8 warps an SM hides little of the
// read-modify-write latency, so the flushes, not the chain passes, set the
// time; one contraction a stage for all probes, as k4_stream_adjoint.cu
// does for its gradient, would remove K of them.  K and the direction are
// run-time values; the one-probe instance above stays as it was.
//
// The COND instance (K8 in the streamed forms): _stage_train_fwdbwd of a
// conditional chain past the wide limits, whose first layer reads [z | ys]
// (:372-481 with _zin :265, one VJP probe: CondRNODE at the MINIBOONE
// width, 87 -> 258 -> 86, or MLP 44 -> 860 -> 860 -> 43 on [z | ys]), as
// the wide K2 chain form's COND instance runs it (k2_wide_adjoint.cu).  The
// forward adds layer 0's ys rows to the pre-activation (stream_forward
// <true>, from the tile's (T, nc) ys rows); the probe has no ys rows, so the
// pullback, its VJP and their outer products read and give layer 0's z rows
// alone (the pullback ascent pads ct_u with zero ys rows, :451-455).  The
// forward chain's gradient pass gives layer 0's ys rows ys (x) ca_1 summed
// over the batch, and each sample's ys cotangent, whose a_ys integrates
// k_ays = -(ca_1 (layer 0's ys rows)^T), comes from the same transposed
// product as k_az, run over W0's dz + nc rows (the z rows to KAZ, the ys
// rows to KYS): no pass of its own.  a_ys rides in the tile solve's COND
// form (adjoint_solve_tiles): from 0 at t_hi, combined like a_z, nc more
// plane rows inside the one batch-global norm (the single-tile numerics
// kept), a_ys0 (B, nc) returned.  The tile's ys rows (T, nc) and k_ays
// (T, nc) take 2 nc floats a row more.  Its stage runs behind a call of
// its own (StreamCondAdjStage): inlined into the tile solve, as the other
// instances' stages are, it left the kernel a 648-byte stack frame (the
// unconditional instance's: 104) at 255 registers and 18.9 % more time a
// step on the H100 (PERF.md); a call shrinks the frame, with results bit
// for bit the same.  Its launch shape and entry are cnf_k2sc_shape and
// cnf_k2s_cond_adjoint.
//
// The probe COND instance (K6 x K8): the probe instance's stage on a
// conditional chain past the wide limits (:396-455 with _zin), on
// adjoint_solve_tiles' PROBES and COND forms together, as the wide K2 chain
// form's probe COND instance runs it (k2_wide_adjoint.cu).  The forward
// reads the tile's ys rows (stream_forward<true>); each probe's pass and its
// VJP read and give layer 0's z rows alone (the tangent [eps | 0], ct_u
// padded with zero ys rows :451-455), so its flushes leave W0's ys rows
// alone; the forward chain's gradient pass gives them ys (x) ca_1, and
// k_ays = -(ca_1 (W0's ys rows)^T) comes from k_az's transposed product over
// W0's dz + nc rows after the last probe's flush, when ca_1 holds every
// probe's -2 h gate terms.  The three parts of its stage are the probe
// instance's bodies, force-inlined templates over COND, behind calls of
// their own, as the probe instance's are.  Its tile arrays are the probe
// instance's with k_ays and the ys rows (2 nc floats a row more); its
// launch shape and entry are cnf_k2spc_shape and cnf_k2s_probe_cond_adjoint.

#include "chain_stream.cuh"

namespace {

constexpr int kStageUnroll = 4;
constexpr int kTiles[] = {8, 4};

using cnf::ct_safe_norm;
using cnf::gate;
using cnf::kRedFloats;
using cnf::kStreamBlock;
using cnf::level;
using cnf::safe_norm_sq;
using cnf::StreamLayout;

struct AdjArgs {
  cnf::AdjState s;
  StreamLayout L;
  const float* params;  // [W0 | b0 | W1 | b1 | ...]
  const float* eps;     // (B, dz) Hutchinson probe
  float* g;             // (P) the gradient, laid out as params
  float* gnew;          // (P) its proposal
  float* gblk;          // [gridDim.x][(NG + 2) P]
  float* tiles;         // global scratch of the tile arrays (grid x region), null: shared memory
  int norm_z, norm_j, T;
};

// The tile arrays of the stage beside the solver's: five dz-vectors, four
// hidden blocks and four scalars a row.
struct TileArrays {
  float *E, *VL, *EJ, *CU, *CAL;  // (T, zp)
  float *HS, *PU, *V, *U;         // hidden blocks; U holds u, then ct_h, then ca
  float* SC;                      // (T, 4): fz, fn, ct_tr
};

// The tile arrays: the solver's Z, AZ, KZ, KAZ, KR and the stage's.
__host__ __device__ inline size_t region_floats(const StreamLayout& L, int T) {
  return (size_t)T * (4 * L.zp + 3) + (size_t)T * (5 * L.zp + 4 * (size_t)L.hsum + 4);
}

__device__ inline TileArrays tile_arrays(const StreamLayout& L, int T, float* base) {
  TileArrays a;
  const size_t v = (size_t)T * L.zp, h = (size_t)T * L.hsum;
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
// (T, nc) rows; nothing in an unconditional stage.
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
struct StreamAdjStage : CondRows<COND> {
  const StreamLayout* L;
  const float* params;
  const float* eps;    // (B, dz)
  const float* aaccT;  // (3, B)
  TileArrays a;
  float* wc;           // the chunk buffer
  int B, T, norm_z, norm_j;

  __device__ void operator()(int s0, int nv, const float* Z, const float* AZ, float* KZ, float* KR, float* KAZ,
                             [[maybe_unused]] float* KYS = nullptr) const {
    const StreamLayout& c = *L;
    const int n = c.n, dz = c.dz, zp = c.zp;
    const int on_y = c.act[n - 1];
    float *E = a.E, *VL = a.VL, *EJ = a.EJ, *CU = a.CU, *CAL = a.CAL, *SC = a.SC;
    if constexpr (COND) {
      cnf::load_tile_cond(this->ys, cnf::stream_nc(c), s0, nv, T, this->YS);
      cnf::stream_forward<true>(c, params, Z, T, a.HS, KZ, wc, this->YS);
    } else {
      cnf::stream_forward(c, params, Z, T, a.HS, KZ, wc);
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
      cnf::stream_mm_t(src, c.hp[i + 1], c.width[i + 1], cnf::layer_w(c, params, i), c.width[i], T, wc,
                       [&](int t, int k, float x) {
                         u[t * hp + k] = x;
                         v[t * hp + k] = x * gate(h[t * hp + k], on);
                       });
    }
    cnf::stream_mm_t(level(c, a.V, T, 1), c.hp[1], c.width[1], cnf::layer_w(c, params, 0), dz, T, wc,
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
      cnf::stream_mm(src, c.hp[i], COND && i == 0 ? dz : c.width[i], cnf::layer_w(c, params, i), nullptr,
                     c.width[i + 1], T, wc,
                     [&](int t, int o, float cv) {
                       const float hh = h[t * hp + o];
                       pu[t * hp + o] = cv * gate(hh, on);
                       u[t * hp + o] = on ? (-2.f * hh) * (cv * u[t * hp + o]) : 0.f;
                     });
    }
    // The output layer: ct_h = a_z + y fz - 2 y (ct_v eps) (tanh; a_z + y fz
    // for identity), ca = ct_h s'(y).
    cnf::stream_mm(level(c, a.PU, T, n - 1), c.hp[n - 1], c.width[n - 1], cnf::layer_w(c, params, n - 1), nullptr,
                   dz, T, wc, [&](int t, int k, float cv) {
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
      cnf::stream_mm_t(src, c.hp[i + 1], c.width[i + 1], cnf::layer_w(c, params, i), c.width[i], T, wc,
                       [&](int t, int k, float x) { ca[t * hp + k] = (x + ca[t * hp + k]) * gate(h[t * hp + k], on); });
    }
    if constexpr (COND) {
      // k_az and k_ays in one transposed product over W0's dz + nc rows.
      const int nc = cnf::stream_nc(c);
      cnf::stream_mm_t(level(c, a.U, T, 1), c.hp[1], c.width[1], cnf::layer_w(c, params, 0), dz + nc, T, wc,
                       [&](int t, int k, float x) {
                         if (k < dz)
                           KAZ[t * zp + k] = -x;
                         else
                           KYS[t * nc + k - dz] = -x;
                       });
    } else {
      cnf::stream_mm_t(level(c, a.U, T, 1), c.hp[1], c.width[1], cnf::layer_w(c, params, 0), dz, T, wc,
                       [&](int t, int k, float x) { KAZ[t * zp + k] = -x; });
    }
  }
};

// The tile's sum over its first nv rows of the negated gradient rate of the
// stage just evaluated, entry q of the flat [W0 | b0 | W1 | b1 | ...]
// (COND: layer 0's ys rows get ys (x) ca_1 alone).
template <bool COND>
struct StreamGrad : CondRows<COND> {
  const StreamLayout* L;
  const float* Z;  // the solver's stage input z
  TileArrays a;
  int T;

  __device__ float operator()(int q, int nv) const {
    const StreamLayout& c = *L;
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

// One block an SM at 860 wide (its shared memory allows no second), so the
// compiler may give a thread up to 255 registers.
__global__ void __launch_bounds__(kStreamBlock, 1) k2_stream_adjoint(const AdjArgs p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ StreamLayout L;
  cnf::share_layout(p.L, &L);
  const int T = p.T;
  float* wc = smem;
  float* red = wc + cnf::kChunkFloats;
  // The solver's Z, AZ, KZ, KAZ, KR, then the stage's arrays.
  float* scratch = p.tiles ? p.tiles + (size_t)blockIdx.x * region_floats(L, T) : red + kRedFloats;
  const TileArrays arrays = tile_arrays(L, T, scratch + T * (4 * L.zp + 3));
  const StreamAdjStage<false> stage{{}, &L, p.params, p.eps, p.s.aaccT, arrays, wc, p.s.B, T, p.norm_z, p.norm_j};
  const StreamGrad<false> grad{{}, &L, scratch, arrays, T};
  cnf::adjoint_solve_tiles<kStageUnroll>(p.s, stage, grad, L.P, T, scratch, p.gblk, p.g, p.gnew, red);
}

size_t smem_bytes(const StreamLayout& L, int T, bool global_tiles) {
  return sizeof(float) * ((size_t)cnf::kChunkFloats + kRedFloats + (global_tiles ? 0 : region_floats(L, T)));
}

// The COND instance's stage behind a call of its own (module comment).
struct StreamCondAdjStage : StreamAdjStage<true> {
  __device__ __noinline__ void operator()(int s0, int nv, const float* Z, const float* AZ, float* KZ, float* KR,
                                          float* KAZ, float* KYS) const {
    StreamAdjStage<true>::operator()(s0, nv, Z, AZ, KZ, KR, KAZ, KYS);
  }
};

// The COND instance's arguments: the one-probe instance's and the
// conditioning ys (B, nc).
struct CondAdjArgs {
  AdjArgs a;
  const float* ys;
};

// The COND instance's tile arrays: the solver's Z, AZ, KZ, KAZ, KR and
// k_ays (T, nc), then the stage's tile arrays, then the tile's ys rows
// (T, nc), in shared memory or in the block's slice of the global scratch
// alike.
__host__ __device__ inline size_t cond_region_floats(const StreamLayout& L, int T) {
  return region_floats(L, T) + (size_t)2 * T * cnf::stream_nc(L);
}

// One block an SM, as the one-probe instance.
__global__ void __launch_bounds__(kStreamBlock, 1) k2_stream_cond_adjoint(const __grid_constant__ CondAdjArgs ca) {
  extern __shared__ __align__(16) float smem[];
  __shared__ StreamLayout L;
  const AdjArgs& p = ca.a;
  cnf::share_layout(p.L, &L);
  const int T = p.T, nc = cnf::stream_nc(L);
  float* wc = smem;
  float* red = wc + cnf::kChunkFloats;
  // The solver's Z, AZ, KZ, KAZ, KR and KYS, then the stage's arrays, then
  // the ys rows.
  float* scratch = p.tiles ? p.tiles + (size_t)blockIdx.x * cond_region_floats(L, T) : red + kRedFloats;
  const TileArrays arrays = tile_arrays(L, T, scratch + T * (4 * L.zp + 3 + nc));
  float* YS = arrays.SC + T * 4;
  const StreamCondAdjStage stage{{{ca.ys, YS}, &L, p.params, p.eps, p.s.aaccT, arrays, wc, p.s.B, T, p.norm_z,
                                    p.norm_j}};
  const StreamGrad<true> grad{{ca.ys, YS}, &L, scratch, arrays, T};
  cnf::adjoint_solve_tiles<kStageUnroll, false, 3, true>(p.s, stage, grad, L.P, T, scratch, p.gblk, p.g, p.gnew,
                                                           red);
}

size_t cond_smem_bytes(const StreamLayout& L, int T, bool global_tiles) {
  return sizeof(float) * ((size_t)cnf::kChunkFloats + kRedFloats + (global_tiles ? 0 : cond_region_floats(L, T)));
}

// The probe instance's tile arrays beside the solver's: six dz-vectors, five
// hidden blocks and four scalars a row.
struct ProbeArrays {
  float *E, *VL, *EJ, *CU, *CAL, *CTY;  // (T, zp); CAL holds t W_last (JVP) until the probes end
  float *HS, *PU, *V, *U, *HC;          // hidden blocks; V holds ca after the probes
  float* SC;                            // (T, 4): fn, the trace and probe-norm sums, ct_tr then fz
};

__host__ __device__ inline size_t probe_region_floats(const StreamLayout& L, int T) {
  return (size_t)T * (4 * L.zp + 3) + (size_t)T * (6 * L.zp + 5 * (size_t)L.hsum + 4);
}

__device__ inline ProbeArrays probe_arrays(const StreamLayout& L, int T, float* base) {
  ProbeArrays a;
  const size_t v = (size_t)T * L.zp, h = (size_t)T * L.hsum;
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
// `flush`; then the rates and the forward chain's VJP.  The three parts'
// bodies are force-inlined templates over COND, so that the probe COND
// instance (StreamProbeCondStage) shares them while this stage's calls keep
// their names and machine code.
struct StreamProbeStage {
  const StreamLayout* L;
  const float* params;
  const float* eps;    // (K, B, dz)
  const float* aaccT;  // (3, B)
  ProbeArrays a;
  float* wc;           // the chunk buffer
  int B, T, K, jvp, norm_z, norm_j;

  // The forward pass (COND: from the tile's ys rows, loaded into YS); the
  // probe sums and ct_tr.
  template <bool COND>
  __device__ __forceinline__ void forward_body(int s0, int nv, const float* Z, float* KZ,
                                               [[maybe_unused]] const float* ys,
                                               [[maybe_unused]] float* YS) const {
    const StreamLayout& c = *L;
    const ProbeArrays a = this->a;
    const int zp = c.zp, hs = c.hsum;
    const float inv_k = 1.f / K;
    if constexpr (COND) {
      cnf::load_tile_cond(ys, cnf::stream_nc(c), s0, nv, T, YS);
      cnf::stream_forward<true>(c, params, Z, T, a.HS, KZ, wc, YS);
    } else {
      cnf::stream_forward(c, params, Z, T, a.HS, KZ, wc);
    }
    for (int idx = threadIdx.x; idx < T * hs; idx += blockDim.x) a.HC[idx] = 0.f;
    for (int idx = threadIdx.x; idx < T * zp; idx += blockDim.x) a.CTY[idx] = 0.f;
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      a.SC[t * 4 + 1] = 0.f;
      a.SC[t * 4 + 2] = 0.f;
      a.SC[t * 4 + 3] = t < nv ? -aaccT[s0 + t] * inv_k : 0.f;  // ct_tr: rates row 0 is -tr over K probes
    }
    __syncthreads();
  }

  // Probe pk's pass and its VJP: its trace and norm terms into SC, its -2 h
  // (.) gate terms into HC and CTY, its outer-product vectors left in CU /
  // PU and VL / V.  COND: the probe has no ys rows (the tangent [eps | 0],
  // ct_u padded with zeros :451-455), so layer 0's products read its z rows.
  template <bool COND>
  __device__ __forceinline__ void probe_body(int pk, int s0, int nv, const float* KZ) const {
    const StreamLayout& c = *L;
    const ProbeArrays a = this->a;
    const int n = c.n, dz = c.dz, zp = c.zp;
    const int on_y = c.act[n - 1];
    float *E = a.E, *VL = a.VL, *EJ = a.EJ, *CU = a.CU, *CAL = a.CAL, *CTY = a.CTY, *SC = a.SC;
    const float inv_k = 1.f / K;
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
      cnf::stream_pushforward<COND>(c, params, E, T, a.HS, a.U, a.PU, CAL, wc);
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
        cnf::stream_mm_t(src, c.hp[i + 1], c.width[i + 1], cnf::layer_w(c, params, i), c.width[i], T, wc,
                         [&](int t, int k, float x) {
                           u[t * hp + k] = x;
                           v[t * hp + k] = x * gate(h[t * hp + k], on);
                         });
      }
      cnf::stream_mm_t(level(c, a.V, T, 1), c.hp[1], c.width[1], cnf::layer_w(c, params, 0), dz, T, wc,
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
        cnf::stream_mm_t(src, c.hp[i + 1], c.width[i + 1], cnf::layer_w(c, params, i), c.width[i], T, wc,
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
      // output cty += -2 y (ct_v eps).
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
        cnf::stream_mm(src, c.hp[i], COND && i == 0 ? dz : c.width[i], cnf::layer_w(c, params, i), nullptr,
                       c.width[i + 1], T, wc, [&](int t, int o, float cv) {
                         const int x = t * hp + o;
                         const float hh = h[x];
                         pu[x] = cv * gate(hh, on);
                         if (on) hc[x] += (-2.f * hh) * (cv * u[x]);
                       });
      }
      if (on_y)
        cnf::stream_mm(level(c, a.PU, T, n - 1), c.hp[n - 1], c.width[n - 1], cnf::layer_w(c, params, n - 1),
                       nullptr, dz, T, wc, [&](int t, int k, float cv) {
                         const int o = t * zp + k;
                         CTY[o] += (-2.f * KZ[o]) * (cv * E[o]);
                       });
    }
  }

  // The rates, averaged over the probes, fz, and the forward chain's VJP
  // (COND: k_az and k_ays in one transposed product over W0's dz + nc rows,
  // from ca_1 after every probe's gate terms).
  template <bool COND>
  __device__ __forceinline__ void backward_body(int s0, int nv, const float* AZ, const float* KZ, float* KR,
                                                float* KAZ, [[maybe_unused]] float* KYS) const {
    const StreamLayout& c = *L;
    const ProbeArrays a = this->a;
    const int n = c.n, dz = c.dz, zp = c.zp;
    const int on_y = c.act[n - 1];
    float *CAL = a.CAL, *CTY = a.CTY, *SC = a.SC;
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
      cnf::stream_mm_t(src, c.hp[i + 1], c.width[i + 1], cnf::layer_w(c, params, i), c.width[i], T, wc,
                       [&](int t, int k, float x) { ca[t * hp + k] = (x + hc[t * hp + k]) * gate(h[t * hp + k], on); });
    }
    if constexpr (COND) {
      const int nc = cnf::stream_nc(c);
      cnf::stream_mm_t(level(c, a.V, T, 1), c.hp[1], c.width[1], cnf::layer_w(c, params, 0), dz + nc, T, wc,
                       [&](int t, int k, float x) {
                         if (k < dz)
                           KAZ[t * zp + k] = -x;
                         else
                           KYS[t * nc + k - dz] = -x;
                       });
    } else {
      cnf::stream_mm_t(level(c, a.V, T, 1), c.hp[1], c.width[1], cnf::layer_w(c, params, 0), dz, T, wc,
                       [&](int t, int k, float x) { KAZ[t * zp + k] = -x; });
    }
  }

  // The three parts.  Not inlined: the flushes between them keep their
  // registers.
  __device__ __noinline__ void forward(int s0, int nv, const float* Z, float* KZ) const {
    forward_body<false>(s0, nv, Z, KZ, nullptr, nullptr);
  }
  __device__ __noinline__ void probe(int pk, int s0, int nv, const float* KZ) const {
    probe_body<false>(pk, s0, nv, KZ);
  }
  __device__ __noinline__ void backward(int s0, int nv, const float* AZ, const float* KZ, float* KR,
                                        float* KAZ) const {
    backward_body<false>(s0, nv, AZ, KZ, KR, KAZ, nullptr);
  }

  template <class Flush>
  __device__ void probes(int s0, int nv, const float* Z, const float* AZ, float* KZ, float* KR, float* KAZ,
                         const Flush& flush) const {
    forward(s0, nv, Z, KZ);
    for (int pk = 0; pk < K; ++pk) {
      probe(pk, s0, nv, KZ);
      flush();
    }
    backward(s0, nv, AZ, KZ, KR, KAZ);
  }
};

// The probe COND instance's stage (K6 x K8): the probe stage's parts on a
// conditional chain, with ys (B, nc) in global memory and the tile's (T, nc)
// rows, and KYS = k_ays taken after the last probe's flush.
struct StreamProbeCondStage : StreamProbeStage {
  const float* ys;
  float* YS;

  __device__ __noinline__ void cond_forward(int s0, int nv, const float* Z, float* KZ) const {
    forward_body<true>(s0, nv, Z, KZ, ys, YS);
  }
  __device__ __noinline__ void cond_probe(int pk, int s0, int nv, const float* KZ) const {
    probe_body<true>(pk, s0, nv, KZ);
  }
  __device__ __noinline__ void cond_backward(int s0, int nv, const float* AZ, const float* KZ, float* KR, float* KAZ,
                                             float* KYS) const {
    backward_body<true>(s0, nv, AZ, KZ, KR, KAZ, KYS);
  }

  template <class Flush>
  __device__ void probes(int s0, int nv, const float* Z, const float* AZ, float* KZ, float* KR, float* KAZ,
                         const Flush& flush, float* KYS) const {
    cond_forward(s0, nv, Z, KZ);
    for (int pk = 0; pk < K; ++pk) {
      cond_probe(pk, s0, nv, KZ);
      flush();
    }
    cond_backward(s0, nv, AZ, KZ, KR, KAZ, KYS);
  }
};

// The probe instance's gradient terms (K6): the tile's sum over its first
// nv rows of the negated gradient rate entry q, a probe's part (a_i (x) b_i;
// nothing for a bias) or the forward chain's (in_i (x) ca_i, the biases).
// COND: layer 0's ys rows get no probe part and ys (x) ca_1 from the
// forward chain.
template <bool COND>
struct StreamProbeGrad : CondRows<COND> {
  const StreamLayout* L;
  const float* Z;  // the solver's stage input z
  ProbeArrays a;
  int T;

  template <bool PROBE>
  __device__ __forceinline__ float entry(int q, int nv) const {
    const StreamLayout& c = *L;
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

// One block an SM, as the one-probe instance.
__global__ void __launch_bounds__(kStreamBlock, 1) k2_stream_probe_adjoint(const ProbeArgs pa) {
  extern __shared__ __align__(16) float smem[];
  __shared__ StreamLayout L;
  const AdjArgs& p = pa.a;
  cnf::share_layout(p.L, &L);
  const int T = p.T;
  float* wc = smem;
  float* red = wc + cnf::kChunkFloats;
  // The solver's Z, AZ, KZ, KAZ, KR, then the stage's arrays.
  float* scratch = p.tiles ? p.tiles + (size_t)blockIdx.x * probe_region_floats(L, T) : red + kRedFloats;
  const ProbeArrays arrays = probe_arrays(L, T, scratch + T * (4 * L.zp + 3));
  const StreamProbeStage stage{&L, p.params, p.eps, p.s.aaccT, arrays, wc, p.s.B, T, pa.K, pa.jvp, p.norm_z,
                               p.norm_j};
  const StreamProbeGrad<false> grad{{}, &L, scratch, arrays, T};
  cnf::adjoint_solve_tiles<kStageUnroll, true>(p.s, stage, grad, L.P, T, scratch, p.gblk, p.g, p.gnew, red);
}

size_t probe_smem_bytes(const StreamLayout& L, int T, bool global_tiles) {
  return sizeof(float) * ((size_t)cnf::kChunkFloats + kRedFloats + (global_tiles ? 0 : probe_region_floats(L, T)));
}

// The probe COND instance's arguments (K6 x K8): the probe instance's and
// the conditioning ys (B, nc).
struct ProbeCondArgs {
  ProbeArgs pa;
  const float* ys;
};

// The probe COND instance's tile arrays: the solver's Z, AZ, KZ, KAZ, KR and
// k_ays (T, nc), then the probe instance's tile arrays, then the tile's ys
// rows (T, nc), in shared memory or in the block's slice of the global
// scratch alike.
__host__ __device__ inline size_t probe_cond_region_floats(const StreamLayout& L, int T) {
  return probe_region_floats(L, T) + (size_t)2 * T * cnf::stream_nc(L);
}

// One block an SM, as the one-probe instance.
__global__ void __launch_bounds__(kStreamBlock, 1)
    k2_stream_probe_cond_adjoint(const __grid_constant__ ProbeCondArgs pc) {
  extern __shared__ __align__(16) float smem[];
  __shared__ StreamLayout L;
  const ProbeArgs& pa = pc.pa;
  const AdjArgs& p = pa.a;
  cnf::share_layout(p.L, &L);
  const int T = p.T, nc = cnf::stream_nc(L);
  float* wc = smem;
  float* red = wc + cnf::kChunkFloats;
  // The solver's Z, AZ, KZ, KAZ, KR and KYS, then the stage's arrays, then
  // the ys rows.
  float* scratch = p.tiles ? p.tiles + (size_t)blockIdx.x * probe_cond_region_floats(L, T) : red + kRedFloats;
  const ProbeArrays arrays = probe_arrays(L, T, scratch + T * (4 * L.zp + 3 + nc));
  float* YS = arrays.SC + T * 4;
  const StreamProbeCondStage stage{
      {&L, p.params, p.eps, p.s.aaccT, arrays, wc, p.s.B, T, pa.K, pa.jvp, p.norm_z, p.norm_j}, pc.ys, YS};
  const StreamProbeGrad<true> grad{{pc.ys, YS}, &L, scratch, arrays, T};
  cnf::adjoint_solve_tiles<kStageUnroll, true, 3, true>(p.s, stage, grad, L.P, T, scratch, p.gblk, p.g, p.gnew,
                                                          red);
}

size_t probe_cond_smem_bytes(const StreamLayout& L, int T, bool global_tiles) {
  return sizeof(float) *
         ((size_t)cnf::kChunkFloats + kRedFloats + (global_tiles ? 0 : probe_cond_region_floats(L, T)));
}

}  // namespace

// The launch shape at batch B: out = {threads per block, blocks, samples a
// tile, dynamic shared memory bytes, floats of global tile scratch a block
// (0: the tile arrays are in shared memory)}.  widths: n + 1 level widths
// (host memory).  Returns a cudaError_t (cudaErrorInvalidValue for a chain
// not covered).
extern "C" int cnf_k2s_shape(int n, const int* widths, int B, int* out) {
  StreamLayout L;
  if (B < 1 || !cnf::make_stream_layout(n, widths, &L)) return (int)cudaErrorInvalidValue;
  size_t region[2];
  for (int o = 0; o < 2; ++o) region[o] = region_floats(L, kTiles[o]);
  return cnf::stream_shape(k2_stream_adjoint, region, kTiles, kTiles, 2, B, out);
}

// params/g: [W0 | b0 | ...] flat (device); eps, zT, azT, z0, az0: (B, dz);
// acts: bit i set where layer i is tanh (else identity); accT/aaccT/acc0:
// (3, B).  work: (S + 2) (2 dz + 3) B floats; partials: 10 grid; gblk:
// grid (NG + 2) P (NG = 3 for a tableau with btilde3, else 2); gnew: P;
// tiles: grid x out[4] floats of cnf_k2s_shape, or null when out[4] is 0.
// tab: kTableauFloats floats (read_tableau).  T, grid, block: from
// cnf_k2s_shape.  Returns the launch's cudaError_t.
extern "C" int cnf_k2s_train_adjoint(const float* params, const float* eps, const float* zT, const float* accT,
                                     const float* azT, const float* aaccT, const float* ts, float* z0, float* acc0,
                                     float* az0, float* g, int* stats, float* work, float* partials, float* gblk,
                                     float* gnew, float* tiles, int B, int n, const int* widths, int acts,
                                     int max_steps, int norm_z, int norm_j, float rtol, float atol, float beta1,
                                     float beta2, float inv_order, const float* tab, int T, int grid, int block,
                                     void* stream) {
  AdjArgs a = {};
  if (block != kStreamBlock || grid < 1 || T < 4 || T % 4 != 0 || !cnf::make_stream_layout(n, widths, &a.L))
    return (int)cudaErrorInvalidValue;
  cnf::set_stream_acts(&a.L, acts);
  cnf::set_adj_state(&a.s, zT, accT, azT, aaccT, ts, z0, acc0, az0, stats, work, partials, nullptr, B, widths[n],
                     max_steps, rtol, atol, beta1, beta2, inv_order, tab);
  a.params = params;
  a.eps = eps;
  a.g = g;
  a.gnew = gnew;
  a.gblk = gblk;
  a.tiles = tiles;
  a.norm_z = norm_z;
  a.norm_j = norm_j;
  a.T = T;
  return (int)cnf::coop_launch(k2_stream_adjoint, a, grid, block, smem_bytes(a.L, T, tiles != nullptr),
                               (cudaStream_t)stream);
}

// The probe instance's launch shape (K6), as cnf_k2s_shape.
extern "C" int cnf_k2sp_shape(int n, const int* widths, int B, int* out) {
  StreamLayout L;
  if (B < 1 || !cnf::make_stream_layout(n, widths, &L)) return (int)cudaErrorInvalidValue;
  size_t region[2];
  for (int o = 0; o < 2; ++o) region[o] = probe_region_floats(L, kTiles[o]);
  return cnf::stream_shape(k2_stream_probe_adjoint, region, kTiles, kTiles, 2, B, out);
}

// The probe instance (K6): as cnf_k2s_train_adjoint with eps (K, B, dz),
// K >= 1 probes, reverse mode or (jvp) forward mode; T, grid, block and the
// tile scratch from cnf_k2sp_shape.
extern "C" int cnf_k2s_probe_adjoint(const float* params, const float* eps, const float* zT, const float* accT,
                                     const float* azT, const float* aaccT, const float* ts, float* z0, float* acc0,
                                     float* az0, float* g, int* stats, float* work, float* partials, float* gblk,
                                     float* gnew, float* tiles, int B, int n, const int* widths, int acts,
                                     int max_steps, int norm_z, int norm_j, int K, int jvp, float rtol, float atol,
                                     float beta1, float beta2, float inv_order, const float* tab, int T, int grid,
                                     int block, void* stream) {
  ProbeArgs pa = {};
  AdjArgs& a = pa.a;
  if (block != kStreamBlock || grid < 1 || T < 4 || T % 4 != 0 || K < 1 || !cnf::make_stream_layout(n, widths, &a.L))
    return (int)cudaErrorInvalidValue;
  cnf::set_stream_acts(&a.L, acts);
  cnf::set_adj_state(&a.s, zT, accT, azT, aaccT, ts, z0, acc0, az0, stats, work, partials, nullptr, B, widths[n],
                     max_steps, rtol, atol, beta1, beta2, inv_order, tab);
  a.params = params;
  a.eps = eps;
  a.g = g;
  a.gnew = gnew;
  a.gblk = gblk;
  a.tiles = tiles;
  a.norm_z = norm_z;
  a.norm_j = norm_j;
  a.T = T;
  pa.K = K;
  pa.jvp = jvp;
  return (int)cnf::coop_launch(k2_stream_probe_adjoint, pa, grid, block, probe_smem_bytes(a.L, T, tiles != nullptr),
                               (cudaStream_t)stream);
}

// The COND instance's launch shape (K8), as cnf_k2s_shape; widths[0] =
// dz + nc with nc >= 1, out[4] counting the tile's ys rows and k_ays.
extern "C" int cnf_k2sc_shape(int n, const int* widths, int B, int* out) {
  StreamLayout L;
  if (B < 1 || !cnf::make_stream_layout(n, widths, &L, true)) return (int)cudaErrorInvalidValue;
  size_t region[2];
  for (int o = 0; o < 2; ++o) region[o] = cond_region_floats(L, kTiles[o]);
  return cnf::stream_shape(k2_stream_cond_adjoint, region, kTiles, kTiles, 2, B, out);
}

// The COND instance (K8): as cnf_k2s_train_adjoint for a conditional chain,
// with ys (B, nc) (device) and ays0 (B, nc), nc = widths[0] - widths[n] >= 1,
// the cotangent of ys at t_lo; work: (S + 2) (2 dz + 3 + nc) B floats; T,
// grid, block and the tile scratch from cnf_k2sc_shape.
extern "C" int cnf_k2s_cond_adjoint(const float* params, const float* eps, const float* ys, const float* zT,
                                    const float* accT, const float* azT, const float* aaccT, const float* ts,
                                    float* z0, float* acc0, float* az0, float* ays0, float* g, int* stats, float* work,
                                    float* partials, float* gblk, float* gnew, float* tiles, int B, int n,
                                    const int* widths, int acts, int max_steps, int norm_z, int norm_j, float rtol,
                                    float atol, float beta1, float beta2, float inv_order, const float* tab, int T,
                                    int grid, int block, void* stream) {
  CondAdjArgs ca = {};
  AdjArgs& a = ca.a;
  if (block != kStreamBlock || grid < 1 || T < 4 || T % 4 != 0 || ys == nullptr || ays0 == nullptr ||
      !cnf::make_stream_layout(n, widths, &a.L, true))
    return (int)cudaErrorInvalidValue;
  cnf::set_stream_acts(&a.L, acts);
  cnf::set_adj_state(&a.s, zT, accT, azT, aaccT, ts, z0, acc0, az0, stats, work, partials, nullptr, B, widths[n],
                     max_steps, rtol, atol, beta1, beta2, inv_order, tab);
  a.s.nc = cnf::stream_nc(a.L);
  a.s.ays0 = ays0;
  a.params = params;
  a.eps = eps;
  a.g = g;
  a.gnew = gnew;
  a.gblk = gblk;
  a.tiles = tiles;
  a.norm_z = norm_z;
  a.norm_j = norm_j;
  a.T = T;
  ca.ys = ys;
  return (int)cnf::coop_launch(k2_stream_cond_adjoint, ca, grid, block, cond_smem_bytes(a.L, T, tiles != nullptr),
                               (cudaStream_t)stream);
}

// The probe COND instance's launch shape (K6 x K8), as cnf_k2sc_shape.
extern "C" int cnf_k2spc_shape(int n, const int* widths, int B, int* out) {
  StreamLayout L;
  if (B < 1 || !cnf::make_stream_layout(n, widths, &L, true)) return (int)cudaErrorInvalidValue;
  size_t region[2];
  for (int o = 0; o < 2; ++o) region[o] = probe_cond_region_floats(L, kTiles[o]);
  return cnf::stream_shape(k2_stream_probe_cond_adjoint, region, kTiles, kTiles, 2, B, out);
}

// The probe COND instance (K6 x K8): as cnf_k2s_cond_adjoint with eps
// (K, B, dz), K >= 1 probes, reverse mode or (jvp) forward mode; T, grid,
// block and the tile scratch from cnf_k2spc_shape.
extern "C" int cnf_k2s_probe_cond_adjoint(const float* params, const float* eps, const float* ys, const float* zT,
                                          const float* accT, const float* azT, const float* aaccT, const float* ts,
                                          float* z0, float* acc0, float* az0, float* ays0, float* g, int* stats,
                                          float* work, float* partials, float* gblk, float* gnew, float* tiles, int B,
                                          int n, const int* widths, int acts, int max_steps, int norm_z, int norm_j,
                                          int K, int jvp, float rtol, float atol, float beta1, float beta2,
                                          float inv_order, const float* tab, int T, int grid, int block,
                                          void* stream) {
  ProbeCondArgs pc = {};
  ProbeArgs& pa = pc.pa;
  AdjArgs& a = pa.a;
  if (block != kStreamBlock || grid < 1 || T < 4 || T % 4 != 0 || K < 1 || ys == nullptr || ays0 == nullptr ||
      !cnf::make_stream_layout(n, widths, &a.L, true))
    return (int)cudaErrorInvalidValue;
  cnf::set_stream_acts(&a.L, acts);
  cnf::set_adj_state(&a.s, zT, accT, azT, aaccT, ts, z0, acc0, az0, stats, work, partials, nullptr, B, widths[n],
                     max_steps, rtol, atol, beta1, beta2, inv_order, tab);
  a.s.nc = cnf::stream_nc(a.L);
  a.s.ays0 = ays0;
  a.params = params;
  a.eps = eps;
  a.g = g;
  a.gnew = gnew;
  a.gblk = gblk;
  a.tiles = tiles;
  a.norm_z = norm_z;
  a.norm_j = norm_j;
  a.T = T;
  pa.K = K;
  pa.jvp = jvp;
  pc.ys = ys;
  return (int)cnf::coop_launch(k2_stream_probe_cond_adjoint, pc, grid, block,
                               probe_cond_smem_bytes(a.L, T, tiles != nullptr), (cudaStream_t)stream);
}
