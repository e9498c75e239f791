// K7: the forward solves of a CNF whose field is a Dense chain of 2 to 4 tanh
// or identity layers with the exact trace by basis propagation, the whole
// adaptive solve (any embedded explicit tableau, K9) in one cooperative
// launch.  Two entry points:
//   * TEST: the state [z | dlogp], rate -tr J (one accumulator row);
//   * exact TRAIN: [z | dlogp | reg_e | reg_n], rates -tr J, ||y|| (norm_z)
//     and ||J||_F (norm_j) (three rows).
//
// Replaces the TPU kernel continuousnf_tpu/ops/fused_solve.py::_run_solve_kernel
// (pl.pallas_call at :1043) built by _make_solve_kernel (:773-942) with
// _stage_test -> _stage_exact_chain (:484-493, :678-719; want_fro=False) and
// with _stage_train_exact_chain (:722-728), the conditional rows of _zin
// (:265, K8) included: the forward pass reads [z | ys], the basis push only
// the z rows of W_0 (:701).  As in the JAX package these are forward-only: a
// deep exact chain's gradient runs the plain BACKSOLVE.
//
// Per sample and field evaluation: the forward pass (chain_forward of
// chain_common.cuh), each hidden level's activation h replaced by its gate d
// (1 - h^2 for tanh, 1 for identity), then for each basis column j < dz one
// column of J pushed
// through the linearised layers:
//   t_1 = d_1 (.) W_0[j, :] (j < dz: a z row),  t_(l+1) = d_(l+1) (.) (t_l W_l),
//   t_N = dy (.) (t_(N-1) W_(N-1)),
// tr += t_N[j] and ||J||_F^2 += |t_N|^2.  TEST needs only t_N[j] but
// computes the whole row t_N all the same: as DZ independent FMA chains fed
// by float4 weight reads it runs faster here than the one dependent chain of
// H_(N-1) FMAs that column j alone is (with one warp per scheduler nothing
// hides that chain's latency; PERF.md, Findings).  The JAX kernel folds the
// basis next to the batch as an (out, dz, B) block; the sums are the same,
// taken in another order.  The accumulators are seeded from the input; the
// controller is forward_solve's (one Hairer norm over the whole state per
// attempted step, one grid barrier).
//
// What bounds it on the H100: latency.  At the tabular power6 width
// (6 -> 64 -> 64 -> 6) a field evaluation is the forward pass (4.9 k FMA)
// plus dz columns of 4.5 k FMA each, about 32 k FMA per sample on one
// thread per sample (TEST needs 30 k of them); a stage at B = 4096 is
// 0.26 GFLOP, about 4 us of the card's f32 rate.  The time goes to the
// per-thread chain of FMAs and shared-memory reads (mv_cols reads each t
// entry once per 8 outputs) and to the barrier.  The thread's slot holds the
// d vectors (one hidden block), two hidden-width columns for t and the
// sample's ys (nc floats): 256 floats a sample at power6.
// Precision: f32 FMA on the CUDA cores, no TF32 and no tensor cores.

#include "chain_common.cuh"

namespace {

// The unroll factor of the solve loops over stored stages (solve_common.cuh),
// per instance the fastest of 1, 2, 4 and 8 on the H100 (PERF.md, PR 6).
template <int NACC, bool COND>
constexpr int kStageUnroll = COND ? (NACC == 3 ? 4 : 2) : 1;

using cnf::ChainLayout;
using cnf::kMaxBlock;
using cnf::kRedFloats;
using cnf::safe_norm_sq;

struct Args {
  cnf::FwdArgs f;
  ChainLayout L;
  const float* params;  // [W0 | b0 | W1 | b1 | ...]
  const float* ys;      // (B, nc) conditioning, null when nc = 0
};

__host__ __device__ inline int slot_floats(const ChainLayout& L) { return (L.hsum + 2 * L.hmax + L.nc) | 1; }

// The exact field of one sample: ky = y; kr = [-tr] (NACC = 1) or
// [-tr, ||y||, ||J||_F] (NACC = 3).
template <int DZ, int NACC, bool COND>
struct ChainExactField {
  const ChainLayout* L;
  const float* w;   // the shared weight region
  const float* ys;  // (B, nc)
  float* sl;        // this thread's slot: d (a hidden block), then t columns, then ys
  int dz, norm_z, norm_j;

  __device__ __forceinline__ void operator()(int s, const float (&z)[DZ], float (&ky)[DZ],
                                             float (&kr)[NACC]) const {
    const ChainLayout& c = *L;
    const int n = c.n;
    float y[DZ];
    float* yc = sl + c.hsum + 2 * c.hmax;
    if constexpr (COND) cnf::load_cond(c, ys, s, yc);
    cnf::chain_forward<DZ, COND>(c, w, z, yc, sl, y);
    for (int l = 1; l < n; ++l) {
      float* d = sl + c.hofs[l];
      const int on = c.act[l - 1];
      for (int q = 0; q < c.width[l]; ++q) d[q] = cnf::gate(d[q], on);
    }
    float dy[DZ], ysq = 0.f;
    const int on = c.act[n - 1];
#pragma unroll
    for (int k = 0; k < DZ; ++k) {
      ky[k] = y[k];
      ysq = fmaf(y[k], y[k], ysq);
      dy[k] = cnf::gate(y[k], on);
    }
    float* ta = sl + c.hsum;
    float* tb = ta + c.hmax;
    const float* w0 = w + c.wofs[0];
    const float* wl = w + c.wofs[n - 1];
    const float* d1 = sl + c.hofs[1];
    float tr = 0.f, fro2 = 0.f;
#pragma unroll 1
    for (int j = 0; j < dz; ++j) {
      for (int o = 0; o < c.width[1]; ++o) ta[o] = d1[o] * w0[o * DZ + j];
      float* cur = ta;
      float* nxt = tb;
      for (int i = 1; i < n - 1; ++i) {
        const float* d = sl + c.hofs[i + 1];
        float* dst = nxt;
        cnf::mv_cols(cur, c.width[i], w + c.wofs[i], c.pitch[i], nullptr, c.width[i + 1],
                     [&](int o, float a) { dst[o] = a * d[o]; });
        nxt = cur;
        cur = dst;
      }
      float t[DZ];
#pragma unroll
      for (int i = 0; i < DZ; ++i) t[i] = 0.f;
      for (int k = 0; k < c.width[n - 1]; ++k) cnf::axpy4<DZ>(t, cur[k], wl + k * DZ);
#pragma unroll
      for (int i = 0; i < DZ; ++i) {
        const float ti = t[i] * dy[i];
        if (i == j) tr += ti;
        fro2 = fmaf(ti, ti, fro2);
      }
    }
    kr[0] = -tr;
    if constexpr (NACC == 3) {
      kr[1] = norm_z ? safe_norm_sq(ysq) : 0.f;
      kr[2] = norm_j ? safe_norm_sq(fro2) : 0.f;
    }
  }
};

template <int DZ, int NACC, bool COND>
__global__ void __launch_bounds__(kMaxBlock) k7_chain_solve(const Args p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ ChainLayout L;
  cnf::share_layout(p.L, &L);
  float* w = smem;
  float* red = w + L.wfloats;
  float* slots = red + kRedFloats;
  cnf::load_chain_weights<DZ>(p.params, L, w);
  __syncthreads();
  const ChainExactField<DZ, NACC, COND> field{&L, w, p.ys, slots + threadIdx.x * slot_floats(L), p.f.dz,
                                              p.f.norm_z, p.f.norm_j};
  cnf::forward_solve<DZ, NACC, kStageUnroll<NACC, COND>>(p.f, field, red);
}

size_t smem_bytes(const ChainLayout& L, int block) {
  return sizeof(float) * ((size_t)L.wfloats + kRedFloats + (size_t)block * slot_floats(L));
}

// The kernel instance's shared memory (either entry point), co-resident grid
// and launch, for cnf::dispatch_chain.
struct SmemOf {
  int n;
  const int* widths;
  int block;
  template <int DZ, bool COND>
  long long operator()() const {
    ChainLayout L;
    return cnf::make_chain_layout<DZ>(n, widths, &L) ? (long long)smem_bytes(L, block) : 0;
  }
};

template <int NACC>
struct MaxGrid {
  int n;
  const int* widths;
  int block;
  int* out;
  template <int DZ, bool COND>
  int operator()() const {
    ChainLayout L;
    *out = 0;
    if (!cnf::make_chain_layout<DZ>(n, widths, &L)) return (int)cudaErrorInvalidValue;
    return (int)cnf::coop_max_grid(k7_chain_solve<DZ, NACC, COND>, smem_bytes(L, block), block, out);
  }
};

template <int NACC>
struct Launch {
  Args a;
  int n;
  const int* widths;
  int acts;
  int grid, block;
  cudaStream_t s;
  template <int DZ, bool COND>
  int operator()() const {
    Args b = a;
    if (!cnf::make_chain_layout<DZ>(n, widths, &b.L)) return (int)cudaErrorInvalidValue;
    cnf::set_chain_acts(&b.L, acts);
    return (int)cnf::coop_launch(k7_chain_solve<DZ, NACC, COND>, b, grid, block, smem_bytes(b.L, block), s);
  }
};

template <int NACC>
int max_grid_any(int n, const int* widths, int block, int* out) {
  *out = 0;
  return cnf::dispatch_chain(n, widths, MaxGrid<NACC>{n, widths, block, out}, (int)cudaErrorInvalidValue);
}

template <int NACC>
int solve(const float* params, const float* ys, const float* z0, const float* acc0, const float* ts, float* zT,
          float* accT, int* stats, float* dt_last, float* work, float* partials, int B, int n, const int* widths,
          int acts, int max_steps, int norm_z, int norm_j, float rtol, float atol, float beta1, float beta2,
          float inv_order, const float* tab, int grid, int block, void* stream) {
  if (block < 32 || block > kMaxBlock || block % 32 != 0 || grid < 1 || n < 2 || n > cnf::kMaxLayers)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  cnf::set_fwd_args(&a.f, nullptr, z0, acc0, ts, zT, accT, stats, dt_last, work, partials, B, widths[n],
                    max_steps, norm_z, norm_j, rtol, atol, beta1, beta2, inv_order, tab);
  a.params = params;
  a.ys = ys;
  return cnf::dispatch_chain(n, widths, Launch<NACC>{a, n, widths, acts, grid, block, (cudaStream_t)stream},
                             (int)cudaErrorInvalidValue);
}

}  // namespace

// Dynamic shared memory of one block (bytes, either entry point), 0 for a
// chain not covered.
extern "C" long long cnf_k7_smem_bytes(int n, const int* widths, int block) {
  return cnf::dispatch_chain(n, widths, SmemOf{n, widths, block}, 0LL);
}

// Largest co-resident grid for a cooperative launch of the TEST or the exact
// TRAIN entry point (0 if none).  widths: n + 1 level widths (host memory),
// the input width dz + nc first.
extern "C" int cnf_k7_test_max_grid(int n, const int* widths, int block, int* out) {
  return max_grid_any<1>(n, widths, block, out);
}

extern "C" int cnf_k7_exact_max_grid(int n, const int* widths, int block, int* out) {
  return max_grid_any<3>(n, widths, block, out);
}

// TEST: params [W0 | b0 | ...] flat (device), ys (B, nc) or null for an
// unconditional chain (nc = widths[0] - widths[n]), acts: bit i set where
// layer i is tanh (else identity), z0 (B, dz), dlogp0/dlogpT (B), dt_last
// (2): the next step size and the last step taken.  tab: kTableauFloats
// floats (read_tableau).  Returns the launch's cudaError_t.
extern "C" int cnf_k7_test_solve(const float* params, const float* ys, const float* z0, const float* dlogp0,
                                 const float* ts, float* zT, float* dlogpT, int* stats, float* dt_last,
                                 float* work, float* partials, int B, int n, const int* widths, int acts,
                                 int max_steps, float rtol, float atol, float beta1, float beta2,
                                 float inv_order, const float* tab, int grid, int block, void* stream) {
  return solve<1>(params, ys, z0, dlogp0, ts, zT, dlogpT, stats, dt_last, work, partials, B, n, widths, acts,
                  max_steps, 0, 0, rtol, atol, beta1, beta2, inv_order, tab, grid, block, stream);
}

// Exact TRAIN: acc0/accT (3, B), rows [dlogp | reg_e | reg_n].  Returns the
// launch's cudaError_t.
extern "C" int cnf_k7_exact_solve(const float* params, const float* ys, const float* z0, const float* acc0,
                                  const float* ts, float* zT, float* accT, int* stats, float* dt_last,
                                  float* work, float* partials, int B, int n, const int* widths, int acts,
                                  int max_steps, int norm_z, int norm_j, float rtol, float atol, float beta1,
                                  float beta2, float inv_order, const float* tab, int grid, int block,
                                  void* stream) {
  return solve<3>(params, ys, z0, acc0, ts, zT, accT, stats, dt_last, work, partials, B, n, widths, acts,
                  max_steps, norm_z, norm_j, rtol, atol, beta1, beta2, inv_order, tab, grid, block, stream);
}
