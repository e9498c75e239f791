// Streamed K5: the continuous-adjoint (backsolve) backward integration of a
// TEST-mode CNF whose field is an unconditional 2-layer tanh MLP past the
// wide 2-layer kernels' limits (state width 33 to 128 with a hidden width
// past 128, or a state width past 64: the README net family at the
// MINIBOONE width, 86 -> 258 -> 86), the whole adaptive solve (any embedded
// explicit tableau, K9) from t_hi down to t_lo in one cooperative launch.
//
// Replaces, at these widths, the TPU kernel built by continuousnf_tpu/ops/
// fused_solve.py::_make_adjoint_kernel (:1064-1343), launched by
// make_full_solve.adjoint_solve (pl.pallas_call at :1767), with the
// _stage_test_fwdbwd stage (:506-539).  The state is, per sample, z (dz),
// dlogp (1), a_z (dz) and the constant a_dlogp (1), plus the batch-summed
// gradient g = [W1 | b1 | W2 | b2] (P = 2 dz H + H + dz floats; 44,720 at
// 86 -> 258 -> 86).  Wide K5 (k5_wide_adjoint.cu) keeps the weights and M
// in shared memory up to dz 64 and H 128; here they stay in global memory.
//
// Per sample and stage, the math of wide K5 (fused_solve.py::
// _stage_test_fwdbwd, M[i, h] = W1[i, h] W2[h, i]):
//   forward:  h, dh = 1 - h^2, y, dy = 1 - y^2, mdh = M dh,
//             rate -tr, tr = sum_i dy_i mdh_i;
//   backward: ct_tr = -a_dlogp; ct_mdh = dy ct_tr; ct_dh = M^T ct_mdh;
//             ct_pre2 = (a_z - 2 y mdh ct_tr) dy;
//             ct_pre1 = (W2 ct_pre2 - 2 h ct_dh) dh; k_az = -W1 ct_pre1;
//   gradient: W1 gets z (x) ct_pre1 + ct_m (.) W2^T, W2 gets
//             h (x) ct_pre2 + (ct_m (.) W1)^T, with ct_m = ct_mdh (x) dh
//             summed over the tile's samples first and multiplied by the
//             weight once per entry (K5's and wide K5's ct_m fold), the
//             biases ct_pre1 and ct_pre2.
// The error norm runs over g with the fold applied, as wide K5's.
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
// Memory plan.  First the grid builds M into a global scratch
// (two_layer_stream.cuh) and meets at a grid barrier.  A block evaluates
// each stage for a tile of T = 32 samples (16 or 8 where the shared memory
// asks for it) through chain_stream.cuh's chunk products (the weights and M
// L2-resident, streamed through a 17 KB chunk buffer).  Per tile row the
// solver's z, a_z, k_z (= y), k_az (4 x 88) and rate (1), h, dh and ct_pre1
// (3 x 260), dy, mdh then ct_pre2, ct_mdh (3 x 88) and four floats (ct_tr):
// 1,401 floats at 86 -> 258 -> 86, 44,832 at T = 32; 197 KB in all with the
// chunk buffer.  Past that the tile arrays go to a global scratch.
// Global: each block's GB, GE (and GE3), stage-1 and last-stage partials
// ((NG + 2) P floats a block), g and its proposal (P each).
// What bounds it on the H100: a stage is 6 dz H = 133 k FMA a sample (the
// forward, M dh, M^T ct_mdh, the two VJPs) plus the gradient pass (2 FMA per
// sample and entry, 3 for the folded weights: 111 k at 86 -> 258 -> 86),
// 2.0 GFLOP at B = 4096, 30 us at the card's f32 rate; the gradient pass is
// bound by shared-memory issue, and per attempted step come two grid
// barriers and the slice reduction.
// Precision: f32 FMA on the CUDA cores, no TF32 and no tensor cores.
//
// The COND instance (K8 in the streamed forms): _stage_test_fwdbwd of a
// conditional 2-layer net past the wide limits (:506-539 with _zin :265;
// CondRNODE at the MINIBOONE width, 87 -> 258 -> 86), as wide K5's COND
// instance runs it (k5_wide_adjoint.cu).  The forward adds W1's ys rows to
// the pre-activation of h (stream_two_layer_forward<true>, from the tile's
// (T, nc) ys rows); M, the ct_m fold and k_az read W1's z rows only, the
// fold's ys rows being zero (:533-537); the ys rows of W1's gradient are
// ys (x) ct_pre1, and each sample's ys cotangent, whose a_ys integrates
// k_ays = -(ct_pre1 (W1's ys rows)^T), comes from the same transposed
// product as k_az: it runs over the dz + nc rows of W1 (the z rows to KAZ,
// the ys rows to KYS).  a_ys rides in the tile solve's COND form
// (adjoint_solve_tiles): from 0 at t_hi, combined like a_z, inside the one
// batch-global norm (the ct_m fold on g kept), a_ys0 (B, nc) returned.  The
// tile's ys rows (T, nc) and k_ays (T, nc) take 2 nc floats a row more.
// Its launch shape and entry are cnf_k5sc_shape and cnf_k5s_cond_adjoint.

#include "two_layer_stream.cuh"

namespace {

constexpr int kStageUnroll = 4;
constexpr int kTiles[] = {32, 16, 8};

using cnf::kRedFloats;
using cnf::kStreamBlock;
using cnf::StreamLayout;

struct AdjArgs {
  cnf::AdjState s;
  StreamLayout L;
  const float* params;  // [W1 | b1 | W2 | b2]
  float* m;             // (dz, H): M, built by the launch
  float* g;             // (P) the gradient, laid out as params
  float* gnew;          // (P) its proposal
  float* gblk;          // [gridDim.x][(NG + 2) P]
  float* tiles;         // global scratch of the tile arrays (grid x region), null: shared memory
  int T;
};

// The stage's tile arrays beside the solver's.
struct TileArrays {
  float *HS, *DH, *CP1;   // (T, hp): h, dh, ct_pre1
  float *DY, *CP2, *CMD;  // (T, zp): dy, mdh then ct_pre2, ct_mdh
  float* SC;              // (T): ct_tr
};

// The tile arrays: the solver's Z, AZ, KZ, KAZ, KR and the stage's.
__host__ __device__ inline size_t region_floats(const StreamLayout& L, int T) {
  return (size_t)T * (4 * L.zp + 1) + (size_t)T * (3 * L.hp[1] + 3 * L.zp + 4);
}

__device__ inline TileArrays tile_arrays(const StreamLayout& L, int T, float* base) {
  TileArrays a;
  const size_t v = (size_t)T * L.zp, h = (size_t)T * L.hp[1];
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
// (T, nc) rows; nothing in an unconditional stage.
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
struct StreamTestAdjStage : CondRows<COND> {
  const StreamLayout* L;
  const float* params;
  const float* m;      // M (dz, H) in global memory
  const float* aaccT;  // (1, B)
  TileArrays a;
  float* wc;           // the chunk buffer
  int T;

  __device__ void operator()(int s0, int nv, const float* Z, const float* AZ, float* KZ, float* KR, float* KAZ,
                             [[maybe_unused]] float* KYS = nullptr) const {
    const StreamLayout& c = *L;
    const int dz = c.dz, zp = c.zp, H = c.width[1], hp = c.hp[1];
    if constexpr (COND) {
      cnf::load_tile_cond(this->ys, cnf::stream_nc(c), s0, nv, T, this->YS);
      cnf::stream_two_layer_forward<true>(c, params, Z, T, a.HS, a.DH, KZ, a.DY, wc, this->YS);
    } else {
      cnf::stream_two_layer_forward(c, params, Z, T, a.HS, a.DH, KZ, a.DY, wc);
    }
    cnf::stream_m_dh(c, m, a.DH, T, a.CP2, wc);
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
    cnf::stream_mm<true>(a.CMD, zp, dz, m, nullptr, H, T, wc, [&](int t, int o, float x) { a.CP1[t * hp + o] = x; });
    cnf::stream_mm_t(a.CP2, zp, dz, cnf::layer_w(c, params, 1), H, T, wc, [&](int t, int o, float x) {
      const int i = t * hp + o;
      a.CP1[i] = (x + (-2.f * a.HS[i]) * a.CP1[i]) * a.DH[i];
    });
    if constexpr (COND) {
      // k_az and k_ays in one transposed product over W1's dz + nc rows.
      const int nc = cnf::stream_nc(c);
      cnf::stream_mm_t(a.CP1, hp, H, cnf::layer_w(c, params, 0), dz + nc, T, wc, [&](int t, int k, float x) {
        if (k < dz)
          KAZ[t * zp + k] = -x;
        else
          KYS[t * nc + k - dz] = -x;
      });
    } else {
      cnf::stream_mm_t(a.CP1, hp, H, cnf::layer_w(c, params, 0), dz, T, wc,
                       [&](int t, int k, float x) { KAZ[t * zp + k] = -x; });
    }
  }
};

// The tile's sum over its first nv rows of the negated gradient rate of the
// stage just evaluated, entry q of [W1 (dz + nc, H) | b1 | W2 (H, dz) | b2],
// the ct_m fold included (the other weight from global memory; W1's z rows
// only: its ys rows, COND, are ys (x) ct_pre1).
template <bool COND>
struct StreamTestGrad : CondRows<COND> {
  const StreamLayout* L;
  const float* params;
  const float* Z;  // the solver's stage input z
  TileArrays a;
  int T;

  __device__ float operator()(int q, int nv) const {
    const StreamLayout& c = *L;
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
      v = fmaf(cm, __ldg(params + o1 + (size_t)o * dz + k), v);
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
      v = fmaf(cm, __ldg(params + (size_t)i * H + h), v);
    } else {
      const int i = q - o1 - H * dz;
      for (int t = 0; t < nv; ++t) v += a.CP2[t * zp + i];
    }
    return -v;
  }
};

// One block an SM at 86 -> 258 -> 86 (its shared memory allows no second).
__global__ void __launch_bounds__(kStreamBlock, 1) k5_stream_adjoint(const AdjArgs p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ StreamLayout L;
  cnf::share_layout(p.L, &L);
  cnf::build_stream_m(L, p.params, p.m);
  const int T = p.T;
  float* wc = smem;
  float* red = wc + cnf::kChunkFloats;
  // The solver's Z, AZ, KZ, KAZ, KR, then the stage's arrays.
  float* scratch = p.tiles ? p.tiles + (size_t)blockIdx.x * region_floats(L, T) : red + kRedFloats;
  const TileArrays arrays = tile_arrays(L, T, scratch + T * (4 * L.zp + 1));
  const StreamTestAdjStage<false> stage{{}, &L, p.params, p.m, p.s.aaccT, arrays, wc, T};
  const StreamTestGrad<false> grad{{}, &L, p.params, scratch, arrays, T};
  cnf::adjoint_solve_tiles<kStageUnroll, false, 1>(p.s, stage, grad, L.P, T, scratch, p.gblk, p.g, p.gnew, red);
}

size_t smem_bytes(const StreamLayout& L, int T, bool global_tiles) {
  return sizeof(float) * ((size_t)cnf::kChunkFloats + kRedFloats + (global_tiles ? 0 : region_floats(L, T)));
}

// The COND instance's arguments: the unconditional instance's and the
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

// One block an SM, as the unconditional instance.
__global__ void __launch_bounds__(kStreamBlock, 1) k5_stream_cond_adjoint(const __grid_constant__ CondAdjArgs ca) {
  extern __shared__ __align__(16) float smem[];
  __shared__ StreamLayout L;
  const AdjArgs& p = ca.a;
  cnf::share_layout(p.L, &L);
  cnf::build_stream_m(L, p.params, p.m);
  const int T = p.T, nc = cnf::stream_nc(L);
  float* wc = smem;
  float* red = wc + cnf::kChunkFloats;
  float* scratch = p.tiles ? p.tiles + (size_t)blockIdx.x * cond_region_floats(L, T) : red + kRedFloats;
  const TileArrays arrays = tile_arrays(L, T, scratch + T * (4 * L.zp + 1 + nc));
  float* YS = arrays.SC + T * 4;
  const StreamTestAdjStage<true> stage{{ca.ys, YS}, &L, p.params, p.m, p.s.aaccT, arrays, wc, T};
  const StreamTestGrad<true> grad{{ca.ys, YS}, &L, p.params, scratch, arrays, T};
  cnf::adjoint_solve_tiles<kStageUnroll, false, 1, true>(p.s, stage, grad, L.P, T, scratch, p.gblk, p.g, p.gnew,
                                                           red);
}

size_t cond_smem_bytes(const StreamLayout& L, int T, bool global_tiles) {
  return sizeof(float) * ((size_t)cnf::kChunkFloats + kRedFloats + (global_tiles ? 0 : cond_region_floats(L, T)));
}

}  // namespace

// The launch shape at batch B: out = {threads per block, blocks, samples a
// tile, dynamic shared memory bytes, floats of global tile scratch a block
// (0: the tile arrays are in shared memory)}.  widths: the 3 level widths
// (host memory).  Returns a cudaError_t (cudaErrorInvalidValue for a net not
// covered).
extern "C" int cnf_k5s_shape(int n, const int* widths, int B, int* out) {
  StreamLayout L;
  if (B < 1 || n != 2 || !cnf::make_stream_layout(n, widths, &L)) return (int)cudaErrorInvalidValue;
  size_t region[3];
  for (int o = 0; o < 3; ++o) region[o] = region_floats(L, kTiles[o]);
  return cnf::stream_shape(k5_stream_adjoint, region, kTiles, kTiles, 3, B, out);
}

// params/g: [W1 | b1 | W2 | b2] flat (device); acts: 3 (both layers tanh);
// zT, azT, z0, az0: (B, dz); accT/aaccT/acc0: (1, B).  work: (S + 2)
// (2 dz + 1) B floats; partials: 10 grid; gblk: grid (NG + 2) P (NG = 3 for
// a tableau with btilde3, else 2); gnew: P; m: dz H floats (M, written by
// the launch); tiles: grid x out[4] floats of cnf_k5s_shape, or null when
// out[4] is 0.  tab: kTableauFloats floats (read_tableau).  T, grid,
// block: from cnf_k5s_shape.  Returns the launch's cudaError_t.
extern "C" int cnf_k5s_test_adjoint(const float* params, const float* zT, const float* accT, const float* azT,
                                    const float* aaccT, const float* ts, float* z0, float* acc0, float* az0, float* g,
                                    int* stats, float* work, float* partials, float* gblk, float* gnew, float* m,
                                    float* tiles, int B, int n, const int* widths, int acts, int max_steps,
                                    float rtol, float atol, float beta1, float beta2, float inv_order,
                                    const float* tab, int T, int grid, int block, void* stream) {
  AdjArgs a = {};
  if (block != kStreamBlock || grid < 1 || T < 4 || T % 4 != 0 || !cnf::make_stream_layout(n, widths, &a.L) ||
      !cnf::stream_two_layer_tanh(a.L, acts) || m == nullptr)
    return (int)cudaErrorInvalidValue;
  cnf::set_stream_acts(&a.L, acts);
  cnf::set_adj_state(&a.s, zT, accT, azT, aaccT, ts, z0, acc0, az0, stats, work, partials, nullptr, B, widths[n],
                     max_steps, rtol, atol, beta1, beta2, inv_order, tab);
  a.params = params;
  a.m = m;
  a.g = g;
  a.gnew = gnew;
  a.gblk = gblk;
  a.tiles = tiles;
  a.T = T;
  return (int)cnf::coop_launch(k5_stream_adjoint, a, grid, block, smem_bytes(a.L, T, tiles != nullptr),
                               (cudaStream_t)stream);
}

// The COND instance's launch shape (K8), as cnf_k5s_shape; widths[0] =
// dz + nc with nc >= 1, out[4] counting the tile's ys rows and k_ays.
extern "C" int cnf_k5sc_shape(int n, const int* widths, int B, int* out) {
  StreamLayout L;
  if (B < 1 || n != 2 || !cnf::make_stream_layout(n, widths, &L, true)) return (int)cudaErrorInvalidValue;
  size_t region[3];
  for (int o = 0; o < 3; ++o) region[o] = cond_region_floats(L, kTiles[o]);
  return cnf::stream_shape(k5_stream_cond_adjoint, region, kTiles, kTiles, 3, B, out);
}

// The COND instance (K8): as cnf_k5s_test_adjoint for a conditional net,
// with ys (B, nc) (device) and ays0 (B, nc), nc = widths[0] - widths[2] >= 1,
// the cotangent of ys at t_lo; work: (S + 2) (2 dz + 1 + nc) B floats; T,
// grid, block and the tile scratch from cnf_k5sc_shape.
extern "C" int cnf_k5s_cond_adjoint(const float* params, const float* ys, const float* zT, const float* accT,
                                    const float* azT, const float* aaccT, const float* ts, float* z0, float* acc0,
                                    float* az0, float* ays0, float* g, int* stats, float* work, float* partials,
                                    float* gblk, float* gnew, float* m, float* tiles, int B, int n, const int* widths,
                                    int acts, int max_steps, float rtol, float atol, float beta1, float beta2,
                                    float inv_order, const float* tab, int T, int grid, int block, void* stream) {
  CondAdjArgs ca = {};
  AdjArgs& a = ca.a;
  if (block != kStreamBlock || grid < 1 || T < 4 || T % 4 != 0 || ys == nullptr || ays0 == nullptr ||
      !cnf::make_stream_layout(n, widths, &a.L, true) || !cnf::stream_two_layer_tanh(a.L, acts) || m == nullptr)
    return (int)cudaErrorInvalidValue;
  cnf::set_stream_acts(&a.L, acts);
  cnf::set_adj_state(&a.s, zT, accT, azT, aaccT, ts, z0, acc0, az0, stats, work, partials, nullptr, B, widths[n],
                     max_steps, rtol, atol, beta1, beta2, inv_order, tab);
  a.s.nc = cnf::stream_nc(a.L);
  a.s.ays0 = ays0;
  a.params = params;
  a.m = m;
  a.g = g;
  a.gnew = gnew;
  a.gblk = gblk;
  a.tiles = tiles;
  a.T = T;
  ca.ys = ys;
  return (int)cnf::coop_launch(k5_stream_cond_adjoint, ca, grid, block, cond_smem_bytes(a.L, T, tiles != nullptr),
                               (cudaStream_t)stream);
}
