// Wide K3: the TEST-mode forward solve of a CNF whose field is a 2-layer tanh
// MLP with state width up to 64 and hidden width up to 128 (the README net
// family MLP((n_in, 3 n_in, n_in)) at the HEPMASS width, 42 -> 126 -> 42),
// the whole adaptive solve (any embedded explicit tableau, K9) in one
// cooperative launch.
//
// Replaces, at these widths, the TPU kernel continuousnf_tpu/ops/fused_solve.py::
// _run_solve_kernel (pl.pallas_call at :1043) built by _make_solve_kernel
// (:773-942) with the _stage_test stage (:484-503): the state [z | dlogp],
// the field y = tanh(tanh(z W1 + b1) W2 + b2) and the dlogp rate
// -tr J = -sum_i dy_i (M dh)_i, M[i, h] = W1[i, h] W2[h, i].  K3
// (k3_test_solve.cu) keeps a sample's state in a thread's registers at a
// padded width of at most 32; past it the three products of the closed form
// run over a tile of samples in shared memory.  Wide K7's TEST entry would
// also compute this trace, by pushing dz basis columns through the net:
// dz^2 H = 222 k FMA a sample and evaluation at 42 -> 126 -> 42, against
// the closed form's 3 dz H = 15.9 k.
//
// Design: forward_solve_tiles of solve_common.cuh with NACC = 1.  A block
// evaluates each stage for a tile of T = 32 samples (16 or 8 where the
// shared memory asks for it): h and dh (a hidden row each), y and dy, and
// M dh as a transposed product against M, all through chain_wide.cuh's
// tile products.  Shared memory at 42 -> 126 -> 42: the weights (10,920
// floats), M (5,336), and per tile row the solver's z, y and rate (2 x 44 +
// 1) and h, dh, dy and M dh (2 x 128 + 2 x 44): 433 floats, 13,856 at
// T = 32; 120 KB in all.  B = 4096 gives 128 tiles for 132 SMs.
// What bounds it on the H100: a stage is 3 dz H = 15.9 k FMA a sample at
// HEPMASS, 0.13 GFLOP at B = 4096, 2 us at the card's f32 rate: the time
// goes to the products' shared-memory latency, the stage loop's barriers
// and the grid barrier of each attempted step.
// Precision: f32 FMA on the CUDA cores, no TF32 and no tensor cores.
//
// The COND instance (K8 in the wide forms): the closed-form _stage_test of
// a conditional 2-layer net (:484-503 with _zin :265): W1's ys rows enter
// the pre-activation of h (two_layer_forward_cond, from the tile's (T, nc)
// ys rows, read from global memory at each evaluation), while M and the
// trace read W1's z rows only.  At cond_hepmass42 (43 -> 126 -> 42, one ys
// column) that adds 126 FMA to the stage's 15,876 a sample.  Its launch
// shape and entry are cnf_k3wc_shape and cnf_k3w_cond_solve.

#include "two_layer_wide.cuh"

namespace {

constexpr int kStageUnroll = 1;
constexpr int kTiles[] = {32, 16, 8};

using cnf::kRedFloats;
using cnf::kWideBlock;
using cnf::WideLayout;

struct Args {
  cnf::FwdArgs f;
  WideLayout L;
  const float* params;  // [W1 | b1 | W2 | b2]
  int T;                // samples a tile
};

__host__ __device__ inline size_t tile_floats(const WideLayout& L, int T) {
  return (size_t)T * (2 * L.zp + 1) + (size_t)T * (2 * L.hp[1] + 2 * L.zp);
}

// A COND field's conditioning: ys (B, nc) in global memory and the tile's
// (T, nc) rows in shared memory; nothing in an unconditional field.
template <bool COND>
struct CondRows {};
template <>
struct CondRows<true> {
  const float* ys;
  float* YS;
};

// The TEST field of a tile: KY = y, KR = -tr per row.
template <bool COND>
struct WideTestField : CondRows<COND> {
  const WideLayout* L;
  const float* w;  // the shared weight region
  const float* m;  // M (dz, pitch H | 1)
  float *HS, *DH;  // (T, hp)
  float *DY, *MDH; // (T, zp)
  int T;

  __device__ void operator()([[maybe_unused]] int s0, [[maybe_unused]] int nv, const float* Z, float* KY,
                             float* KR) const {
    const WideLayout& c = *L;
    const int dz = c.dz, zp = c.zp;
    if constexpr (COND) {
      cnf::load_tile_cond(this->ys, cnf::wide_nc(c), s0, nv, T, this->YS);
      cnf::two_layer_forward_cond(c, w, Z, this->YS, T, HS, DH, KY, DY);
    } else {
      cnf::two_layer_forward(c, w, Z, T, HS, DH, KY, DY);
    }
    cnf::m_dh(c, m, DH, T, MDH);
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      float tr = 0.f;
      for (int k = 0; k < dz; ++k) tr = fmaf(DY[t * zp + k], MDH[t * zp + k], tr);
      KR[t] = -tr;
    }
    __syncthreads();
  }
};

__global__ void __launch_bounds__(kWideBlock) k3_wide_solve(const Args p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ WideLayout L;
  cnf::share_layout(p.L, &L);
  const int T = p.T;
  float* w = smem;
  float* m = w + L.wfloats;
  float* red = m + cnf::m_floats(L);
  float* scratch = red + kRedFloats;  // the solver's Z, KY, KR
  float* HS = scratch + T * (2 * L.zp + 1);
  float* DH = HS + T * L.hp[1];
  float* DY = DH + T * L.hp[1];
  float* MDH = DY + T * L.zp;
  cnf::load_wide_weights(p.params, L, w);
  __syncthreads();
  cnf::build_m(L, w, m);
  __syncthreads();
  const WideTestField<false> field{{}, &L, w, m, HS, DH, DY, MDH, T};
  cnf::forward_solve_tiles<1, kStageUnroll>(p.f, field, T, scratch, red);
}

size_t smem_bytes(const WideLayout& L, int T) {
  return sizeof(float) * ((size_t)L.wfloats + cnf::m_floats(L) + kRedFloats + tile_floats(L, T));
}

// The COND instance's arguments: the unconditional instance's and the
// conditioning ys (B, nc).
struct CondArgs {
  Args a;
  const float* ys;
};

// The COND instance's tile arrays: the unconditional instance's and the
// tile's ys rows (T, nc).
__host__ __device__ inline size_t cond_tile_floats(const WideLayout& L, int T) {
  return tile_floats(L, T) + (size_t)T * cnf::wide_nc(L);
}

__global__ void __launch_bounds__(kWideBlock) k3_wide_cond_solve(const __grid_constant__ CondArgs ca) {
  extern __shared__ __align__(16) float smem[];
  __shared__ WideLayout L;
  const Args& p = ca.a;
  cnf::share_layout(p.L, &L);
  const int T = p.T;
  float* w = smem;
  float* m = w + L.wfloats;
  float* red = m + cnf::m_floats(L);
  float* scratch = red + kRedFloats;  // the solver's Z, KY, KR
  float* HS = scratch + T * (2 * L.zp + 1);
  float* DH = HS + T * L.hp[1];
  float* DY = DH + T * L.hp[1];
  float* MDH = DY + T * L.zp;
  float* YS = MDH + T * L.zp;
  cnf::load_wide_weights(p.params, L, w);
  __syncthreads();
  cnf::build_m(L, w, m);
  __syncthreads();
  const WideTestField<true> field{{ca.ys, YS}, &L, w, m, HS, DH, DY, MDH, T};
  cnf::forward_solve_tiles<1, kStageUnroll>(p.f, field, T, scratch, red);
}

size_t cond_smem_bytes(const WideLayout& L, int T) {
  return sizeof(float) * ((size_t)L.wfloats + cnf::m_floats(L) + kRedFloats + cond_tile_floats(L, T));
}

}  // namespace

// The launch shape at batch B: out = {threads per block, blocks, samples a
// tile, dynamic shared memory bytes}, the largest tile whose shared memory
// leaves a co-resident grid.  widths: the 3 level widths (host memory).
// Returns a cudaError_t (cudaErrorInvalidValue for a net not covered).
extern "C" int cnf_k3w_shape(int n, const int* widths, int B, int* out) {
  WideLayout L;
  if (B < 1 || n != 2 || !cnf::make_wide_layout(n, widths, &L)) return (int)cudaErrorInvalidValue;
  size_t smem[3];
  for (int o = 0; o < 3; ++o) smem[o] = smem_bytes(L, kTiles[o]);
  return cnf::wide_shape(k3_wide_solve, smem, kTiles, kTiles, 3, B, out);
}

// params [W1 | b1 | W2 | b2] flat (device), acts: 3 (both layers tanh), z0
// (B, dz), dlogp0/dlogpT (B), dt_last (2): the next step size and the last
// step taken; work: (S + 2) (dz + 1) B floats; partials: 6 grid.  tab:
// kTableauFloats floats (read_tableau).  T, grid, block: from
// cnf_k3w_shape.  Returns the launch's cudaError_t.
extern "C" int cnf_k3w_test_solve(const float* params, const float* z0, const float* dlogp0, const float* ts,
                                  float* zT, float* dlogpT, int* stats, float* dt_last, float* work, float* partials,
                                  int B, int n, const int* widths, int acts, int max_steps, float rtol, float atol,
                                  float beta1, float beta2, float inv_order, const float* tab, int T, int grid,
                                  int block, void* stream) {
  Args a = {};
  if (block != kWideBlock || grid < 1 || T < cnf::kRows || T % cnf::kRows != 0 ||
      !cnf::make_wide_layout(n, widths, &a.L) || !cnf::two_layer_tanh(a.L, acts))
    return (int)cudaErrorInvalidValue;
  cnf::set_fwd_args(&a.f, nullptr, z0, dlogp0, ts, zT, dlogpT, stats, dt_last, work, partials, B, widths[n],
                    max_steps, 0, 0, rtol, atol, beta1, beta2, inv_order, tab);
  a.params = params;
  a.T = T;
  return (int)cnf::coop_launch(k3_wide_solve, a, grid, block, smem_bytes(a.L, T), (cudaStream_t)stream);
}

// The COND instance's launch shape (K8), as cnf_k3w_shape; widths[0] =
// dz + nc with nc >= 1.
extern "C" int cnf_k3wc_shape(int n, const int* widths, int B, int* out) {
  WideLayout L;
  if (B < 1 || n != 2 || !cnf::make_wide_layout(n, widths, &L, true)) return (int)cudaErrorInvalidValue;
  size_t smem[3];
  for (int o = 0; o < 3; ++o) smem[o] = cond_smem_bytes(L, kTiles[o]);
  return cnf::wide_shape(k3_wide_cond_solve, smem, kTiles, kTiles, 3, B, out);
}

// The COND instance (K8): as cnf_k3w_test_solve for a conditional net, with
// ys (B, nc) (device), nc = widths[0] - widths[2] >= 1; T, grid, block from
// cnf_k3wc_shape.
extern "C" int cnf_k3w_cond_solve(const float* params, const float* ys, const float* z0, const float* dlogp0,
                                  const float* ts, float* zT, float* dlogpT, int* stats, float* dt_last, float* work,
                                  float* partials, int B, int n, const int* widths, int acts, int max_steps,
                                  float rtol, float atol, float beta1, float beta2, float inv_order, const float* tab,
                                  int T, int grid, int block, void* stream) {
  CondArgs ca = {};
  Args& a = ca.a;
  if (block != kWideBlock || grid < 1 || T < cnf::kRows || T % cnf::kRows != 0 || ys == nullptr ||
      !cnf::make_wide_layout(n, widths, &a.L, true) || !cnf::two_layer_tanh(a.L, acts))
    return (int)cudaErrorInvalidValue;
  cnf::set_fwd_args(&a.f, nullptr, z0, dlogp0, ts, zT, dlogpT, stats, dt_last, work, partials, B, widths[n],
                    max_steps, 0, 0, rtol, atol, beta1, beta2, inv_order, tab);
  a.params = params;
  a.T = T;
  ca.ys = ys;
  return (int)cnf::coop_launch(k3_wide_cond_solve, ca, grid, block, cond_smem_bytes(a.L, T), (cudaStream_t)stream);
}
