// Wide K5: the continuous-adjoint (backsolve) backward integration of a
// TEST-mode CNF whose field is an unconditional 2-layer tanh MLP with state
// width up to 64 and hidden width up to 128 (the README net family at the
// HEPMASS width, 42 -> 126 -> 42), the whole adaptive solve (any embedded
// explicit tableau, K9) from t_hi down to t_lo in one cooperative launch.
//
// Replaces, at these widths, the TPU kernel built by continuousnf_tpu/ops/
// fused_solve.py::_make_adjoint_kernel (:1064-1343), launched by
// make_full_solve.adjoint_solve (pl.pallas_call at :1767), with the
// _stage_test_fwdbwd stage (:506-539).  The state is, per sample, z (dz),
// dlogp (1), a_z (dz) and the constant a_dlogp (1), plus the batch-summed
// gradient g = [W1 | b1 | W2 | b2] (P = 2 dz H + H + dz floats; 10,752 at
// HEPMASS).  K5 (k5_test_adjoint.cu) keeps a sample's state in a thread's
// registers at a padded width of at most 32; this is its tile form.
//
// Per sample and stage (fused_solve.py::_stage_test_fwdbwd, M[i, h] =
// W1[i, h] W2[h, i]):
//   forward:  h, dh = 1 - h^2, y, dy = 1 - y^2, mdh = M dh,
//             rate -tr, tr = sum_i dy_i mdh_i;
//   backward: ct_tr = -a_dlogp; ct_mdh = dy ct_tr; ct_dh = M^T ct_mdh;
//             ct_pre2 = (a_z - 2 y mdh ct_tr) dy;
//             ct_pre1 = (W2 ct_pre2 - 2 h ct_dh) dh; k_az = -W1 ct_pre1;
//   gradient: W1 gets z (x) ct_pre1 + ct_m (.) W2^T, W2 gets
//             h (x) ct_pre2 + (ct_m (.) W1)^T, with ct_m = ct_mdh (x) dh
//             folded in entry by entry (the port's choice of PR 9: the
//             TPU kernel integrates ct_m's fold the same way), the biases
//             ct_pre1 and ct_pre2.
// The error norm runs over g with the fold applied, as the TPU kernel
// integrates it.
//
// Controller: adjoint_solve_tiles of solve_common.cuh with NACC = 1: one
// batch-global Hairer norm over B * 2 (dz + 1) + P elements; per attempted
// step each block adds its tiles' b- and btilde-weighted g rates into its
// own global vectors, and after the grid barrier each block reduces one
// slice of g over all blocks in block order (a second barrier shares the
// slices' error sums).  The TPU package runs two batch tiles of 2048 at
// B = 4096, each with its own controller; the port keeps the single-tile
// numerics, as for the other adjoints.
//
// Memory plan: the weights and M in shared memory (16,256 floats at
// HEPMASS); per tile row the solver's z, a_z, k_z (= y), k_az (4 x 44) and
// rate (1), h, dh and ct_pre1 (3 x 128), dy, mdh then ct_pre2, ct_mdh
// (3 x 44) and one scalar: 694 floats, 22,208 at T = 32; 154 KB in all.
// Global: each block's GB, GE (and GE3), stage-1 and last-stage partials
// ((NG + 2) P floats a block), g and its proposal (P each).
// What bounds it on the H100: a stage is about 6 dz H + dz H = 37 k FMA a
// sample (the forward, M dh, M^T ct_mdh, the two VJPs) plus the gradient
// pass (2 FMA per sample and entry, 3 for the folded weights: 32 k), 0.57
// GFLOP at B = 4096, 8.5 us at the card's f32 rate; the products and the
// gradient pass are bound by shared-memory issue, and per attempted step
// come two grid barriers and the slice reduction.
// Precision: f32 FMA on the CUDA cores, no TF32 and no tensor cores.
//
// The COND instance (K8 in the wide forms): _stage_test_fwdbwd of a
// conditional 2-layer net, whose W1 reads [z | ys] (:506-539 with _zin;
// the ys rows :533-537).  The forward adds W1's ys rows to the
// pre-activation of h (two_layer_forward_cond); M, ct_m and its fold read
// W1's z rows only, so the ys rows of W1's gradient are ys (x) ct_pre1
// alone; and each sample's a_ys integrates k_ays = -(W1's ys rows ct_pre1)
// (wide_ys_cotangent) in the tile solve's COND form
// (adjoint_solve_tiles): from 0 at t_hi, combined like a_z, inside
// the one batch-global norm (the ct_m fold on g kept), a_ys0 (B, nc)
// returned.  The tile's ys rows (T, nc) and k_ays
// (T, nc) take 2 nc floats a row more.  Its launch shape and entry are
// cnf_k5wc_shape and cnf_k5w_cond_adjoint.

#include "two_layer_wide.cuh"

namespace {

constexpr int kStageUnroll = 4;
constexpr int kTiles[] = {32, 16, 8};

using cnf::kRedFloats;
using cnf::kWideBlock;
using cnf::WideLayout;

struct AdjArgs {
  cnf::AdjState s;
  WideLayout L;
  const float* params;  // [W1 | b1 | W2 | b2]
  float* g;             // (P) the gradient, laid out as params
  float* gnew;          // (P) its proposal
  float* gblk;          // [gridDim.x][(NG + 2) P]
  int T;
};

// The stage's tile arrays beside the solver's.
struct TileArrays {
  float *HS, *DH, *CP1;   // (T, hp): h, dh, ct_pre1
  float *DY, *CP2, *CMD;  // (T, zp): dy, mdh then ct_pre2, ct_mdh
  float* SC;              // (T): ct_tr
};

__host__ __device__ inline size_t tile_floats(const WideLayout& L, int T) {
  return (size_t)T * (4 * L.zp + 1) + (size_t)T * (3 * L.hp[1] + 3 * L.zp + 4);
}

__device__ inline TileArrays tile_arrays(const WideLayout& L, int T, float* base) {
  TileArrays a;
  const int v = T * L.zp, h = T * L.hp[1];
  a.HS = base;
  a.DH = a.HS + h;
  a.CP1 = a.DH + h;
  a.DY = a.CP1 + h;
  a.CP2 = a.DY + v;
  a.CMD = a.CP2 + v;
  a.SC = a.CMD + v;
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

// One augmented stage of a tile (fused_solve.py::_stage_test_fwdbwd with
// ct_y = a_z, ct_r = a_dlogp): KZ = y, KR = -tr, KAZ = -ct_z (and, COND,
// KYS = k_ays), and the residuals of the gradient pass left in the tile
// arrays.
template <bool COND>
struct WideTestAdjStage : CondRows<COND> {
  const WideLayout* L;
  const float* w;      // the shared weight region
  const float* m;      // M (dz, pitch H | 1)
  const float* aaccT;  // (1, B)
  TileArrays a;
  int T;

  __device__ void operator()(int s0, int nv, const float* Z, const float* AZ, float* KZ, float* KR, float* KAZ,
                             [[maybe_unused]] float* KYS = nullptr) const {
    const WideLayout& c = *L;
    const int dz = c.dz, zp = c.zp, H = c.width[1], hp = c.hp[1];
    if constexpr (COND) {
      cnf::load_tile_cond(this->ys, cnf::wide_nc(c), s0, nv, T, this->YS);
      cnf::two_layer_forward_cond(c, w, Z, this->YS, T, a.HS, a.DH, KZ, a.DY);
    } else {
      cnf::two_layer_forward(c, w, Z, T, a.HS, a.DH, KZ, a.DY);
    }
    cnf::m_dh(c, m, a.DH, T, a.CP2);
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      float tr = 0.f;
      for (int k = 0; k < dz; ++k) tr = fmaf(a.DY[t * zp + k], a.CP2[t * zp + k], tr);
      KR[t] = -tr;
      a.SC[t] = t < nv ? -aaccT[s0 + t] : 0.f;  // ct_tr: the rate is -tr
    }
    __syncthreads();
    // ct_mdh = dy ct_tr; ct_pre2 = (a_z - 2 y (mdh ct_tr)) dy over mdh.
    for (int idx = threadIdx.x; idx < T * dz; idx += blockDim.x) {
      const int t = idx / dz, k = idx % dz, o = t * zp + k;
      const float ct_tr = a.SC[t], dy = a.DY[o], y = KZ[o];
      a.CMD[o] = dy * ct_tr;
      a.CP2[o] = (AZ[o] + (-2.f * y) * (a.CP2[o] * ct_tr)) * dy;
    }
    __syncthreads();
    // ct_dh = M^T ct_mdh into CP1, then ct_pre1 = (W2 ct_pre2 - 2 h ct_dh) dh.
    cnf::tile_mm(a.CMD, zp, dz, m, c.pitch[0], nullptr, H, T, [&](int t, int o, float x) { a.CP1[t * hp + o] = x; });
    cnf::tile_mm_t(a.CP2, zp, dz, w + c.wofs[1], c.pitch[1], H, T, [&](int t, int o, float x) {
      const int i = t * hp + o;
      a.CP1[i] = (x + (-2.f * a.HS[i]) * a.CP1[i]) * a.DH[i];
    });
    cnf::tile_mm_t(a.CP1, hp, H, w + c.wofs[0], c.pitch[0], dz, T,
                   [&](int t, int k, float x) { KAZ[t * zp + k] = -x; });
    if constexpr (COND) cnf::wide_ys_cotangent(c, w, a.CP1, T, KYS);
  }
};

// The tile's sum over its first nv rows of the negated gradient rate of the
// stage just evaluated, entry q of [W1 (dz + nc, H) | b1 | W2 (H, dz) | b2],
// the ct_m fold included (W1's z rows only; its ys rows, COND, are
// ys (x) ct_pre1).
template <bool COND>
struct WideTestGrad : CondRows<COND> {
  const WideLayout* L;
  const float* w;  // the shared weight region
  const float* Z;  // the solver's stage input z
  TileArrays a;
  int T;

  __device__ float operator()(int q, int nv) const {
    const WideLayout& c = *L;
    const int dz = c.dz, H = c.width[1], zp = c.zp, hp = c.hp[1];
    const int o1 = c.pofs[1];
    float v = 0.f;
    if constexpr (COND) {
      if (q >= dz * H && q < c.width[0] * H) {
        const int nc = c.width[0] - dz, k = q / H - dz, o = q % H;
        for (int t = 0; t < nv; ++t) v = fmaf(this->YS[t * nc + k], a.CP1[t * hp + o], v);
        return -v;
      }
    }
    if (q < dz * H) {
      const int k = q / H, o = q % H;
      float cm = 0.f;
      for (int t = 0; t < nv; ++t) {
        v = fmaf(Z[t * zp + k], a.CP1[t * hp + o], v);
        cm = fmaf(a.CMD[t * zp + k], a.DH[t * hp + o], cm);
      }
      v = fmaf(cm, w[c.wofs[1] + o * c.pitch[1] + k], v);
    } else if (q < o1) {
      const int o = q - (COND ? c.width[0] : dz) * H;
      for (int t = 0; t < nv; ++t) v += a.CP1[t * hp + o];
    } else if (q < o1 + H * dz) {
      const int h = (q - o1) / dz, i = (q - o1) % dz;
      float cm = 0.f;
      for (int t = 0; t < nv; ++t) {
        v = fmaf(a.HS[t * hp + h], a.CP2[t * zp + i], v);
        cm = fmaf(a.CMD[t * zp + i], a.DH[t * hp + h], cm);
      }
      v = fmaf(cm, w[c.wofs[0] + i * c.pitch[0] + h], v);
    } else {
      const int i = q - o1 - H * dz;
      for (int t = 0; t < nv; ++t) v += a.CP2[t * zp + i];
    }
    return -v;
  }
};

// One block an SM (its shared memory allows no second).
__global__ void __launch_bounds__(kWideBlock, 1) k5_wide_adjoint(const AdjArgs p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ WideLayout L;
  cnf::share_layout(p.L, &L);
  const int T = p.T;
  float* w = smem;
  float* m = w + L.wfloats;
  float* red = m + cnf::m_floats(L);
  float* scratch = red + kRedFloats;  // the solver's Z, AZ, KZ, KAZ, KR
  const TileArrays arrays = tile_arrays(L, T, scratch + T * (4 * L.zp + 1));
  cnf::load_wide_weights(p.params, L, w);
  __syncthreads();
  cnf::build_m(L, w, m);
  __syncthreads();
  const WideTestAdjStage<false> stage{{}, &L, w, m, p.s.aaccT, arrays, T};
  const WideTestGrad<false> grad{{}, &L, w, scratch, arrays, T};
  cnf::adjoint_solve_tiles<kStageUnroll, false, 1>(p.s, stage, grad, L.P, T, scratch, p.gblk, p.g, p.gnew, red);
}

size_t smem_bytes(const WideLayout& L, int T) {
  return sizeof(float) * ((size_t)L.wfloats + cnf::m_floats(L) + kRedFloats + tile_floats(L, T));
}

// The COND instance's arguments: the unconditional instance's and the
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

__global__ void __launch_bounds__(kWideBlock, 1) k5_wide_cond_adjoint(const __grid_constant__ CondAdjArgs ca) {
  extern __shared__ __align__(16) float smem[];
  __shared__ WideLayout L;
  const AdjArgs& p = ca.a;
  cnf::share_layout(p.L, &L);
  const int T = p.T, nc = cnf::wide_nc(L);
  float* w = smem;
  float* m = w + L.wfloats;
  float* red = m + cnf::m_floats(L);
  float* scratch = red + kRedFloats;  // the solver's Z, AZ, KZ, KAZ, KR and KYS
  const TileArrays arrays = tile_arrays(L, T, scratch + T * (4 * L.zp + 1 + nc));
  float* YS = arrays.SC + T * 4;
  cnf::load_wide_weights(p.params, L, w);
  __syncthreads();
  cnf::build_m(L, w, m);
  __syncthreads();
  const WideTestAdjStage<true> stage{{ca.ys, YS}, &L, w, m, p.s.aaccT, arrays, T};
  const WideTestGrad<true> grad{{ca.ys, YS}, &L, w, scratch, arrays, T};
  cnf::adjoint_solve_tiles<kStageUnroll, false, 1, true>(p.s, stage, grad, L.P, T, scratch, p.gblk, p.g, p.gnew,
                                                           red);
}

size_t cond_smem_bytes(const WideLayout& L, int T) {
  return sizeof(float) * ((size_t)L.wfloats + cnf::m_floats(L) + kRedFloats + cond_tile_floats(L, T));
}

}  // namespace

// The launch shape at batch B: out = {threads per block, blocks, samples a
// tile, dynamic shared memory bytes}, the largest tile whose shared memory
// leaves a co-resident grid.  widths: the 3 level widths (host memory).
// Returns a cudaError_t (cudaErrorInvalidValue for a net not covered).
extern "C" int cnf_k5w_shape(int n, const int* widths, int B, int* out) {
  WideLayout L;
  if (B < 1 || n != 2 || !cnf::make_wide_layout(n, widths, &L)) return (int)cudaErrorInvalidValue;
  size_t smem[3];
  for (int o = 0; o < 3; ++o) smem[o] = smem_bytes(L, kTiles[o]);
  return cnf::wide_shape(k5_wide_adjoint, smem, kTiles, kTiles, 3, B, out);
}

// params/g: [W1 | b1 | W2 | b2] flat (device); acts: 3 (both layers tanh);
// zT, azT, z0, az0: (B, dz); accT/aaccT/acc0: (1, B).  work: (S + 2)
// (2 dz + 1) B floats; partials: 10 grid; gblk: grid (NG + 2) P (NG = 3 for
// a tableau with btilde3, else 2); gnew: P.  tab: kTableauFloats floats
// (read_tableau).  T, grid, block: from cnf_k5w_shape.  Returns the
// launch's cudaError_t.
extern "C" int cnf_k5w_test_adjoint(const float* params, const float* zT, const float* accT, const float* azT,
                                    const float* aaccT, const float* ts, float* z0, float* acc0, float* az0, float* g,
                                    int* stats, float* work, float* partials, float* gblk, float* gnew, int B, int n,
                                    const int* widths, int acts, int max_steps, float rtol, float atol, float beta1,
                                    float beta2, float inv_order, const float* tab, int T, int grid, int block,
                                    void* stream) {
  AdjArgs a = {};
  if (block != kWideBlock || grid < 1 || T < cnf::kRows || T % cnf::kRows != 0 ||
      !cnf::make_wide_layout(n, widths, &a.L) || !cnf::two_layer_tanh(a.L, acts))
    return (int)cudaErrorInvalidValue;
  cnf::set_adj_state(&a.s, zT, accT, azT, aaccT, ts, z0, acc0, az0, stats, work, partials, nullptr, B, widths[n],
                     max_steps, rtol, atol, beta1, beta2, inv_order, tab);
  a.params = params;
  a.g = g;
  a.gnew = gnew;
  a.gblk = gblk;
  a.T = T;
  return (int)cnf::coop_launch(k5_wide_adjoint, a, grid, block, smem_bytes(a.L, T), (cudaStream_t)stream);
}

// The COND instance's launch shape (K8), as cnf_k5w_shape; widths[0] =
// dz + nc with nc >= 1.
extern "C" int cnf_k5wc_shape(int n, const int* widths, int B, int* out) {
  WideLayout L;
  if (B < 1 || n != 2 || !cnf::make_wide_layout(n, widths, &L, true)) return (int)cudaErrorInvalidValue;
  size_t smem[3];
  for (int o = 0; o < 3; ++o) smem[o] = cond_smem_bytes(L, kTiles[o]);
  return cnf::wide_shape(k5_wide_cond_adjoint, smem, kTiles, kTiles, 3, B, out);
}

// The COND instance (K8): as cnf_k5w_test_adjoint for a conditional net,
// with ys (B, nc) (device) and ays0 (B, nc), nc = widths[0] - widths[2] >= 1,
// the cotangent of ys at t_lo; work: (S + 2) (2 dz + 1 + nc) B floats; T,
// grid, block from cnf_k5wc_shape.
extern "C" int cnf_k5w_cond_adjoint(const float* params, const float* ys, const float* zT, const float* accT,
                                    const float* azT, const float* aaccT, const float* ts, float* z0, float* acc0,
                                    float* az0, float* ays0, float* g, int* stats, float* work, float* partials,
                                    float* gblk, float* gnew, int B, int n, const int* widths, int acts,
                                    int max_steps, float rtol, float atol, float beta1, float beta2,
                                    float inv_order, const float* tab, int T, int grid, int block, void* stream) {
  CondAdjArgs ca = {};
  AdjArgs& a = ca.a;
  if (block != kWideBlock || grid < 1 || T < cnf::kRows || T % cnf::kRows != 0 || ys == nullptr ||
      ays0 == nullptr || !cnf::make_wide_layout(n, widths, &a.L, true) || !cnf::two_layer_tanh(a.L, acts))
    return (int)cudaErrorInvalidValue;
  cnf::set_adj_state(&a.s, zT, accT, azT, aaccT, ts, z0, acc0, az0, stats, work, partials, nullptr, B, widths[n],
                     max_steps, rtol, atol, beta1, beta2, inv_order, tab);
  a.s.nc = cnf::wide_nc(a.L);
  a.s.ays0 = ays0;
  a.params = params;
  a.g = g;
  a.gnew = gnew;
  a.gblk = gblk;
  a.T = T;
  ca.ys = ys;
  return (int)cnf::coop_launch(k5_wide_cond_adjoint, ca, grid, block, cond_smem_bytes(a.L, T),
                               (cudaStream_t)stream);
}
