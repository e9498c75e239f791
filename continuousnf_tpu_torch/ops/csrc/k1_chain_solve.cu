// The K1 chain form: the TRAIN-mode forward solve of a CNF whose field is a
// Dense chain of 1 to 8 tanh or identity layers with Hutchinson probes, the
// whole adaptive solve (any embedded explicit tableau, K9) in one
// cooperative launch.  Two instances: one reverse-mode probe (below), and
// the probe instance (K6, at the end) for K probes, reverse or forward mode.
//
// Replaces the TPU kernel continuousnf_tpu/ops/fused_solve.py::_run_solve_kernel
// (pl.pallas_call at :1043) built by _make_solve_kernel (:773-942) with the
// _stage_train stage (:333-369) over N layers: _chain_fwd (:272) on the rows
// of _zin (:265, K8: [z | ys] for a conditional net) and _probe_pullback
// (:291).  Per sample and field evaluation:
//   forward   h_1 = s_0([z | ys] W_0 + b_0), h_(l+1) = s_l(h_l W_l + b_l),
//             y = h_N, each s_l tanh or identity (ChainSpec.acts, :104-111);
//   pullback  v = eps s'(y), then up the layers u_l = v_l W_l^T,
//             v_(l-1) = u_l s'(h_l), eJ = v_0 W_0z^T (the z rows of W_0),
//             s' = 1 - h^2 for tanh and 1 for identity;
//   rates     -<eJ, eps>, ||y|| (norm_z), ||eJ|| (norm_j) (safe norms);
// then ONE Hairer norm over all B * (dz + 3) elements, the PI controller,
// FSAL or the non-FSAL refresh and the max_steps cap (forward_solve of
// solve_common.cuh, shared with K3, K1 and the K4 forward).  The
// accumulators are seeded from the input.
//
// What bounds it on the H100: latency.  One field evaluation is a forward
// pass and one pullback, about 9.7 k FMA per sample at the tabular power6
// width (6 -> 64 -> 64 -> 6), on one thread per sample; a stage at B = 4096
// is 0.08 GFLOP, about a microsecond of the card's f32 rate, so the time goes
// to each thread's chain of FMAs and shared-memory reads and to one grid
// barrier per attempted step.  A 1-layer net (the reference benchmark suite's
// Dense(16 => 16, tanh)) keeps its whole field in registers and its slot
// holds only ys.  The design is K1's with the chain layer of
// chain_common.cuh: weights in shared memory, the hidden activations in the
// thread's shared-memory slot (overwritten in place by the pullback's gated
// cotangents: 128 floats a sample at power6) and the sample's ys (nc floats,
// copied from global memory at each evaluation), dz-vectors in registers,
// the state and stage registers in the (row, B) global scratch.
// Precision: f32 FMA on the CUDA cores, no TF32 and no tensor cores.
//
// The probe instance (K6): _stage_train with k_probes = K and jvp
// (:333-369, the probe loop :350-364; _probe_pushforward :309-330): one
// forward pass, then per probe, from the (K, B, dz) probes, eps^T J by the
// pullback or J eps by the pushforward (tangents t_1 = (eps W_0z) s'(h_1),
// t_(l+1) = (t_l W_l) s'(h_(l+1)), Je = (t W_last) s'(y)), the trace and
// probe-norm terms summed and divided by K.  The activations stay in the
// slot's first hidden block and each probe's vectors go to a second one, so
// a slot holds 2 sum(hidden) + nc floats.  K and the direction are run-time
// values: one instance (per DZ and COND) runs every probe count and both
// directions, and the one-probe instance above stays as it was.

#include "chain_common.cuh"

namespace {

// The unroll factor of the solve loops over stored stages (solve_common.cuh),
// the fastest of 1, 2, 4 and 8 for this kernel on the H100 (PERF.md, PR 6).
constexpr int kStageUnroll = 4;

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

template <int DZ, bool COND>
struct ChainTrainField {
  const ChainLayout* L;
  const float* w;    // the shared weight region
  const float* eps;  // (B, dz)
  const float* ys;   // (B, nc)
  float* sl;         // this thread's slot: one hidden block, then ys
  int dz, norm_z, norm_j;

  __device__ __forceinline__ void operator()(int s, const float (&z)[DZ], float (&ky)[DZ],
                                             float (&kr)[3]) const {
    float y[DZ];
    float* yc = sl + L->hsum;
    if constexpr (COND) cnf::load_cond(*L, ys, s, yc);
    cnf::chain_forward<DZ, COND>(*L, w, z, yc, sl, y);
    float e[DZ], v[DZ], ysq = 0.f;
    const int on = L->act[L->n - 1];
#pragma unroll
    for (int k = 0; k < DZ; ++k) {
      ky[k] = y[k];
      ysq = fmaf(y[k], y[k], ysq);
      e[k] = k < dz ? eps[(size_t)s * dz + k] : 0.f;
      v[k] = e[k] * cnf::gate(y[k], on);
    }
    float eJ[DZ];
    cnf::chain_pullback<DZ>(*L, w, v, sl, eJ);
    float tr = 0.f, nsq = 0.f;
#pragma unroll
    for (int i = 0; i < DZ; ++i) {
      tr = fmaf(eJ[i], e[i], tr);
      nsq = fmaf(eJ[i], eJ[i], nsq);
    }
    kr[0] = -tr;
    kr[1] = norm_z ? safe_norm_sq(ysq) : 0.f;
    kr[2] = norm_j ? safe_norm_sq(nsq) : 0.f;
  }
};

// The probe instance's field (K6): K probes of sample s at eps[k][s],
// reverse (eps^T J) or, `jvp`, forward mode (J eps); the slot holds the
// activations, a probe's hidden vectors, then ys.
template <int DZ, bool COND>
struct ChainProbeField {
  const ChainLayout* L;
  const float* w;    // the shared weight region
  const float* eps;  // (K, B, dz)
  const float* ys;   // (B, nc)
  float* sl;         // this thread's slot: two hidden blocks, then ys
  int B, dz, K, jvp, norm_z, norm_j;

  __device__ __forceinline__ void operator()(int s, const float (&z)[DZ], float (&ky)[DZ],
                                             float (&kr)[3]) const {
    float y[DZ];
    float* yc = sl + 2 * L->hsum;
    if constexpr (COND) cnf::load_cond(*L, ys, s, yc);
    cnf::chain_forward<DZ, COND>(*L, w, z, yc, sl, y);
    float gy[DZ], ysq = 0.f;
    const int on = L->act[L->n - 1];
#pragma unroll
    for (int k = 0; k < DZ; ++k) {
      ky[k] = y[k];
      ysq = fmaf(y[k], y[k], ysq);
      gy[k] = cnf::gate(y[k], on);
    }
    float tr = 0.f, nsum = 0.f;
    for (int pk = 0; pk < K; ++pk) {
      const float* ek = eps + ((size_t)pk * B + s) * dz;
      float e[DZ], eJ[DZ];
#pragma unroll
      for (int k = 0; k < DZ; ++k) e[k] = k < dz ? ek[k] : 0.f;
      if (jvp) {
        cnf::chain_pushforward<DZ>(*L, w, e, sl, sl + L->hsum, eJ);
#pragma unroll
        for (int k = 0; k < DZ; ++k) eJ[k] *= gy[k];
      } else {
        float v[DZ];
#pragma unroll
        for (int k = 0; k < DZ; ++k) v[k] = e[k] * gy[k];
        cnf::chain_pullback_to<DZ>(*L, w, v, sl, sl + L->hsum, eJ);
      }
      float trk = 0.f, nsq = 0.f;
#pragma unroll
      for (int i = 0; i < DZ; ++i) {
        trk = fmaf(eJ[i], e[i], trk);
        nsq = fmaf(eJ[i], eJ[i], nsq);
      }
      tr += trk;
      nsum += safe_norm_sq(nsq);
    }
    kr[0] = -(tr / K);
    kr[1] = norm_z ? safe_norm_sq(ysq) : 0.f;
    kr[2] = norm_j ? nsum / K : 0.f;
  }
};

__host__ __device__ inline int slot_floats(const ChainLayout& L) { return (L.hsum + L.nc) | 1; }

// The probe instance's slot: the activations, a probe's hidden vectors, ys.
__host__ __device__ inline int probe_slot_floats(const ChainLayout& L) { return (2 * L.hsum + L.nc) | 1; }

template <int DZ, bool COND>
__global__ void __launch_bounds__(kMaxBlock) k1_chain_solve(const Args p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ ChainLayout L;
  cnf::share_layout(p.L, &L);
  float* w = smem;
  float* red = w + L.wfloats;
  float* slots = red + kRedFloats;
  cnf::load_chain_weights<DZ>(p.params, L, w);
  __syncthreads();
  const ChainTrainField<DZ, COND> field{&L, w, p.f.eps, p.ys, slots + threadIdx.x * slot_floats(L),
                                        p.f.dz, p.f.norm_z, p.f.norm_j};
  cnf::forward_solve<DZ, 3, kStageUnroll>(p.f, field, red);
}

// The probe instance's kernel (K6).
struct ProbeArgs {
  Args a;
  int K, jvp;
};

template <int DZ, bool COND>
__global__ void __launch_bounds__(kMaxBlock) k1_chain_probe_solve(const ProbeArgs p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ ChainLayout L;
  cnf::share_layout(p.a.L, &L);
  float* w = smem;
  float* red = w + L.wfloats;
  float* slots = red + kRedFloats;
  cnf::load_chain_weights<DZ>(p.a.params, L, w);
  __syncthreads();
  const ChainProbeField<DZ, COND> field{&L, w, p.a.f.eps, p.a.ys, slots + threadIdx.x * probe_slot_floats(L),
                                        p.a.f.B, p.a.f.dz, p.K, p.jvp, p.a.f.norm_z, p.a.f.norm_j};
  cnf::forward_solve<DZ, 3, kStageUnroll>(p.a.f, field, red);
}

size_t smem_bytes(const ChainLayout& L, int block, bool probes = false) {
  const int slot = probes ? probe_slot_floats(L) : slot_floats(L);
  return sizeof(float) * ((size_t)L.wfloats + kRedFloats + (size_t)block * slot);
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
    return cnf::make_chain_layout<DZ>(n, widths, &L) ? (long long)smem_bytes(L, block) : 0;
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
    *out = 0;
    if (!cnf::make_chain_layout<DZ>(n, widths, &L)) return (int)cudaErrorInvalidValue;
    if (probes)
      return (int)cnf::coop_max_grid(k1_chain_probe_solve<DZ, COND>, smem_bytes(L, block, true), block, out);
    return (int)cnf::coop_max_grid(k1_chain_solve<DZ, COND>, smem_bytes(L, block), block, out);
  }
};

struct Launch {
  Args a;
  int n;
  const int* widths;
  int acts;
  int grid, block;
  cudaStream_t s;
  int K, jvp;  // K = 0: the one-probe instance
  template <int DZ, bool COND>
  int operator()() const {
    Args b = a;
    if (!cnf::make_chain_layout<DZ>(n, widths, &b.L)) return (int)cudaErrorInvalidValue;
    cnf::set_chain_acts(&b.L, acts);
    if (K > 0)
      return (int)cnf::coop_launch(k1_chain_probe_solve<DZ, COND>, ProbeArgs{b, K, jvp}, grid, block,
                                   smem_bytes(b.L, block, true), s);
    return (int)cnf::coop_launch(k1_chain_solve<DZ, COND>, b, grid, block, smem_bytes(b.L, block), s);
  }
};

}  // namespace

// Dynamic shared memory of one block (bytes), 0 for a chain not covered.
extern "C" long long cnf_k1c_smem_bytes(int n, const int* widths, int block) {
  return cnf::dispatch_chain(n, widths, SmemOf{n, widths, block}, 0LL);
}

// Largest co-resident grid for a cooperative launch (0 if none).  widths:
// n + 1 level widths (host memory), the input width dz + nc first.
extern "C" int cnf_k1c_max_grid(int n, const int* widths, int block, int* out) {
  *out = 0;
  return cnf::dispatch_chain(n, widths, MaxGrid{n, widths, block, out, false}, (int)cudaErrorInvalidValue);
}

// The same for the probe instance (K6).
extern "C" int cnf_k1cp_max_grid(int n, const int* widths, int block, int* out) {
  *out = 0;
  return cnf::dispatch_chain(n, widths, MaxGrid{n, widths, block, out, true}, (int)cudaErrorInvalidValue);
}

// params: [W0 | b0 | ... ] flat (device); eps, z0: (B, dz); ys: (B, nc), null
// for an unconditional chain (nc = widths[0] - widths[n]); acts: bit i set
// where layer i is tanh (else identity); acc0/accT: (3, B), rows [dlogp |
// reg_e | reg_n]; dt_last: (2), the next step size and the last step taken.
// tab: kTableauFloats floats (read_tableau).  Returns the launch's
// cudaError_t.
extern "C" int cnf_k1c_train_solve(const float* params, const float* eps, const float* ys, const float* z0,
                                   const float* acc0, const float* ts, float* zT, float* accT,
                                   int* stats, float* dt_last, float* work, float* partials, int B,
                                   int n, const int* widths, int acts, int max_steps, int norm_z, int norm_j,
                                   float rtol, float atol, float beta1, float beta2, float inv_order,
                                   const float* tab, int grid, int block, void* stream) {
  if (block < 32 || block > kMaxBlock || block % 32 != 0 || grid < 1 || n < CNF_MIN_LAYERS || n > cnf::kMaxLayers)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  cnf::set_fwd_args(&a.f, eps, z0, acc0, ts, zT, accT, stats, dt_last, work, partials, B, widths[n],
                    max_steps, norm_z, norm_j, rtol, atol, beta1, beta2, inv_order, tab);
  a.params = params;
  a.ys = ys;
  return cnf::dispatch_chain(n, widths, Launch{a, n, widths, acts, grid, block, (cudaStream_t)stream, 0, 0},
                             (int)cudaErrorInvalidValue);
}

// The probe instance (K6): as cnf_k1c_train_solve with eps (K, B, dz), K >= 1
// probes, reverse mode or (jvp) forward mode.
extern "C" int cnf_k1c_probe_solve(const float* params, const float* eps, const float* ys, const float* z0,
                                   const float* acc0, const float* ts, float* zT, float* accT,
                                   int* stats, float* dt_last, float* work, float* partials, int B,
                                   int n, const int* widths, int acts, int max_steps, int norm_z, int norm_j,
                                   int K, int jvp, float rtol, float atol, float beta1, float beta2,
                                   float inv_order, const float* tab, int grid, int block, void* stream) {
  if (block < 32 || block > kMaxBlock || block % 32 != 0 || grid < 1 || n < CNF_MIN_LAYERS || n > cnf::kMaxLayers || K < 1)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  cnf::set_fwd_args(&a.f, eps, z0, acc0, ts, zT, accT, stats, dt_last, work, partials, B, widths[n],
                    max_steps, norm_z, norm_j, rtol, atol, beta1, beta2, inv_order, tab);
  a.params = params;
  a.ys = ys;
  return cnf::dispatch_chain(n, widths, Launch{a, n, widths, acts, grid, block, (cudaStream_t)stream, K, jvp},
                             (int)cudaErrorInvalidValue);
}
