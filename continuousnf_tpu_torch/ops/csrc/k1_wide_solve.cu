// The wide K1 chain form: the TRAIN-mode forward solve of a CNF whose field
// is an unconditional Dense chain of 2 to 4 tanh or identity layers with
// state width up to 64 and hidden widths up to 128 (the tabular MINIBOONE
// model 43 -> 128 -> 128 -> 43), one Hutchinson probe (reverse mode), the
// whole adaptive solve (any embedded explicit tableau, K9) in one
// cooperative launch.
//
// Replaces, at these widths, the TPU kernel continuousnf_tpu/ops/fused_solve.py::
// _run_solve_kernel (pl.pallas_call at :1043) built by _make_solve_kernel
// (:773-942) with the N-layer _stage_train stage (:333-369): _chain_fwd
// (:272) and _probe_pullback (:291).  Per sample and field evaluation:
//   forward   h_1 = s_0(z W_0 + b_0), h_(l+1) = s_l(h_l W_l + b_l), y = h_N;
//   pullback  v = eps s'(y), then up the layers u_l = v_l W_l^T,
//             v_(l-1) = u_l s'(h_l), eJ = v_0 W_0^T;
//   rates     -<eJ, eps>, ||y|| (norm_z), ||eJ|| (norm_j) (safe norms);
// then ONE Hairer norm over all B * (dz + 3) elements per attempted step, the
// PI controller, FSAL or the non-FSAL refresh and the max_steps cap
// (forward_solve_tiles of solve_common.cuh, shared with wide K7).
//
// Design: a block evaluates each stage for a tile of T samples (16, or 8
// or 4 where the shared memory asks for it) through the wide chain layer of
// chain_wide.cuh: all weights in shared memory (27,862 floats at
// MINIBOONE), and per tile row the stage input and output and the probe
// pieces (z, y, eps, v, eJ: 5 x 44), the hidden block (activations, then
// the pullback's gated cotangents in place: 256 floats) and 3 rates; at
// T = 16 that is 7,664 floats, 143 KB of shared memory in all, with the
// weights.  B = 2048 gives 128 tiles for 132 SMs, one block each.
// What bounds it on the H100: one field evaluation is a forward pass and one
// pullback, 2 x 27,392 FMA per sample at MINIBOONE; a stage at B = 2048 is
// 0.22 GFLOP, about 3.4 us at the card's f32 rate.  The tile products read
// 8 weights and 8 float4 input broadcasts per 64 FMA from shared memory, so
// shared-memory issue and latency, and one grid barrier per attempted step,
// bound it.
// Precision: f32 FMA on the CUDA cores, no TF32 and no tensor cores.
//
// The probe instance (K6 in the wide forms): _stage_train with k_probes = K
// and jvp (the probe loop :350-364, _probe_pushforward :309-330), as the K1
// chain form's probe instance runs it for one sample: per stage one forward
// pass, then per probe, from the (K, B, dz) probes, eps^T J by the pullback
// (wide_pullback_to) or J eps by the pushforward (wide_pushforward), and the
// trace and probe-norm terms summed over the probes and divided by K.  The
// pullback can no longer overwrite the activations, so a tile row gets a
// second hidden block for a probe's vectors (256 floats at MINIBOONE: 11,760
// tile floats at T = 16, 159 KB with the weights).  K and the direction are
// run-time values; the one-probe instance above stays as it was.
//
// The COND instance (K8 in the wide forms): the same solve of a conditional
// chain, whose first layer reads [z | ys] (_stage_train with _zin :265, one
// VJP probe).  The ys values (B, nc) are constant over the solve: at each
// evaluation the block reads its tile's rows into a (T, nc) array, and the
// forward adds layer 0's ys rows (kept after its z rows) to the
// pre-activation (wide_forward_cond); the pullback reads the z rows alone,
// as the one-probe instance does.  At cond_hepmass42 (43 -> 126 -> 42, one
// ys column) that is 126 more FMA a sample and evaluation beside the
// forward's 5,292 and the pullback's 5,292.  Its launch shape and entry are
// cnf_k1wc_shape and cnf_k1w_cond_solve.
//
// The probe COND instance (K6 x K8): the probe instance's field on a
// conditional chain (_stage_train with k_probes = K or jvp, on _zin): the
// forward by wide_forward_cond from the tile's ys rows, then each probe's
// pullback ending at layer 0's z rows (eJ = us[0][:dz], _probe_pullback
// :305) or pushforward from the tangent [eps | 0] (_probe_pushforward
// :318-321), as in the probe instance.  Its tile arrays are the probe
// instance's and the tile's ys rows (T, nc); its launch shape and entry are
// cnf_k1wpc_shape and cnf_k1w_probe_cond_solve.

#include "chain_wide.cuh"

namespace {

constexpr int kStageUnroll = 4;
constexpr int kTiles[] = {16, 8, 4};

using cnf::kRedFloats;
using cnf::kWideBlock;
using cnf::safe_norm_sq;
using cnf::WideLayout;

struct Args {
  cnf::FwdArgs f;
  WideLayout L;
  const float* params;  // [W0 | b0 | W1 | b1 | ...]
  int T;                // samples a tile
};

// A COND field's conditioning: ys (B, nc) in global memory and the tile's
// (T, nc) rows in shared memory; nothing in an unconditional field.
template <bool COND>
struct CondRows {};
template <>
struct CondRows<true> {
  const float* ys;
  float* YS;
};

// The TRAIN field of a tile: KY = y, KR = [-tr, ||y||, ||eJ||] per row.
template <bool COND>
struct WideTrainField : CondRows<COND> {
  const WideLayout* L;
  const float* w;    // the shared weight region
  const float* eps;  // (B, dz)
  float* HB;         // the tile's hidden block
  float* E;          // (T, zp) each: eps, the gated probe, eJ
  float* V;
  float* EJ;
  int T, norm_z, norm_j;

  __device__ void operator()(int s0, int nv, const float* Z, float* KY, float* KR) const {
    const WideLayout& c = *L;
    const int dz = c.dz, zp = c.zp, on = c.act[c.n - 1];
    if constexpr (COND) {
      cnf::load_tile_cond(this->ys, cnf::wide_nc(c), s0, nv, T, this->YS);
      cnf::wide_forward_cond(c, w, Z, this->YS, T, HB, KY);
    } else {
      cnf::wide_forward(c, w, Z, T, HB, KY);
    }
    for (int idx = threadIdx.x; idx < T * dz; idx += blockDim.x) {
      const int t = idx / dz, k = idx % dz;
      const float e = t < nv ? eps[(size_t)s0 * dz + idx] : 0.f;
      E[t * zp + k] = e;
      V[t * zp + k] = e * cnf::gate(KY[t * zp + k], on);
    }
    __syncthreads();
    cnf::wide_pullback(c, w, V, T, HB, EJ);
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      float ysq = 0.f, tr = 0.f, nsq = 0.f;
      for (int k = 0; k < dz; ++k) {
        const float y = KY[t * zp + k], ej = EJ[t * zp + k];
        ysq = fmaf(y, y, ysq);
        tr = fmaf(ej, E[t * zp + k], tr);
        nsq = fmaf(ej, ej, nsq);
      }
      KR[t * 3 + 0] = -tr;
      KR[t * 3 + 1] = norm_z ? safe_norm_sq(ysq) : 0.f;
      KR[t * 3 + 2] = norm_j ? safe_norm_sq(nsq) : 0.f;
    }
    __syncthreads();
  }
};

__host__ __device__ inline size_t tile_floats(const WideLayout& L, int T) {
  return (size_t)T * (2 * L.zp + 3) + (size_t)T * (L.hsum + 3 * L.zp);
}

__global__ void __launch_bounds__(kWideBlock) k1_wide_solve(const Args p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ WideLayout L;
  cnf::share_layout(p.L, &L);
  const int T = p.T;
  float* w = smem;
  float* red = w + L.wfloats;
  float* scratch = red + kRedFloats;  // the solver's Z, KY, KR
  float* HB = scratch + T * (2 * L.zp + 3);
  float* E = HB + T * L.hsum;
  float* V = E + T * L.zp;
  float* EJ = V + T * L.zp;
  cnf::load_wide_weights(p.params, L, w);
  __syncthreads();
  const WideTrainField<false> field{{}, &L, w, p.f.eps, HB, E, V, EJ, T, p.f.norm_z, p.f.norm_j};
  cnf::forward_solve_tiles<3, kStageUnroll>(p.f, field, T, scratch, red);
}

size_t smem_bytes(const WideLayout& L, int T) {
  return sizeof(float) * ((size_t)L.wfloats + kRedFloats + tile_floats(L, T));
}

// The COND instance's arguments: the one-probe instance's and the
// conditioning ys (B, nc).
struct CondArgs {
  Args a;
  const float* ys;
};

// The COND instance's tile arrays: the one-probe instance's and the tile's
// ys rows (T, nc).
__host__ __device__ inline size_t cond_tile_floats(const WideLayout& L, int T) {
  return tile_floats(L, T) + (size_t)T * cnf::wide_nc(L);
}

__global__ void __launch_bounds__(kWideBlock) k1_wide_cond_solve(const __grid_constant__ CondArgs ca) {
  extern __shared__ __align__(16) float smem[];
  __shared__ WideLayout L;
  const Args& p = ca.a;
  cnf::share_layout(p.L, &L);
  const int T = p.T;
  float* w = smem;
  float* red = w + L.wfloats;
  float* scratch = red + kRedFloats;  // the solver's Z, KY, KR
  float* HB = scratch + T * (2 * L.zp + 3);
  float* E = HB + T * L.hsum;
  float* V = E + T * L.zp;
  float* EJ = V + T * L.zp;
  float* YS = EJ + T * L.zp;
  cnf::load_wide_weights(p.params, L, w);
  __syncthreads();
  const WideTrainField<true> field{{ca.ys, YS}, &L, w, p.f.eps, HB, E, V, EJ, T, p.f.norm_z, p.f.norm_j};
  cnf::forward_solve_tiles<3, kStageUnroll>(p.f, field, T, scratch, red);
}

size_t cond_smem_bytes(const WideLayout& L, int T) {
  return sizeof(float) * ((size_t)L.wfloats + kRedFloats + cond_tile_floats(L, T));
}

// The probe instance's field (K6): K probes a row at eps[k][s], reverse
// (eps^T J) or, `jvp`, forward mode (J eps); HB keeps the activations and a
// probe's hidden vectors go to TB.  COND: the forward reads the tile's ys
// rows, the probe passes layer 0's z rows alone.
template <bool COND>
struct WideProbeField : CondRows<COND> {
  const WideLayout* L;
  const float* w;    // the shared weight region
  const float* eps;  // (K, B, dz)
  float* HB;         // the tile's hidden blocks: activations, a probe's vectors
  float* TB;
  float* E;          // (T, zp) each: eps, the gated probe (VJP) or t W (JVP), eJ
  float* V;
  float* EJ;
  int B, T, K, jvp, norm_z, norm_j;

  __device__ void operator()(int s0, int nv, const float* Z, float* KY, float* KR) const {
    const WideLayout& c = *L;
    const int dz = c.dz, zp = c.zp, on = c.act[c.n - 1];
    if constexpr (COND) {
      cnf::load_tile_cond(this->ys, cnf::wide_nc(c), s0, nv, T, this->YS);
      cnf::wide_forward_cond(c, w, Z, this->YS, T, HB, KY);
    } else {
      cnf::wide_forward(c, w, Z, T, HB, KY);
    }
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      KR[t * 3 + 0] = 0.f;
      KR[t * 3 + 2] = 0.f;
    }
    for (int pk = 0; pk < K; ++pk) {
      const float* ek = eps + ((size_t)pk * B + s0) * dz;
      for (int idx = threadIdx.x; idx < T * dz; idx += blockDim.x) {
        const int t = idx / dz, k = idx % dz;
        const float e = t < nv ? ek[idx] : 0.f;
        E[t * zp + k] = e;
        if (!jvp) V[t * zp + k] = e * cnf::gate(KY[t * zp + k], on);
      }
      __syncthreads();
      if (jvp) {
        cnf::wide_pushforward<COND>(c, w, E, T, HB, nullptr, TB, V);
        for (int idx = threadIdx.x; idx < T * dz; idx += blockDim.x) {
          const int t = idx / dz, k = idx % dz;
          EJ[t * zp + k] = V[t * zp + k] * cnf::gate(KY[t * zp + k], on);
        }
        __syncthreads();
      } else {
        cnf::wide_pullback_to(c, w, V, T, HB, TB, EJ);
      }
      for (int t = threadIdx.x; t < T; t += blockDim.x) {
        float tr = 0.f, nsq = 0.f;
        for (int k = 0; k < dz; ++k) {
          const float ej = EJ[t * zp + k];
          tr = fmaf(ej, E[t * zp + k], tr);
          nsq = fmaf(ej, ej, nsq);
        }
        KR[t * 3 + 0] += tr;
        KR[t * 3 + 2] += safe_norm_sq(nsq);
      }
      __syncthreads();
    }
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      float ysq = 0.f;
      for (int k = 0; k < dz; ++k) ysq = fmaf(KY[t * zp + k], KY[t * zp + k], ysq);
      KR[t * 3 + 0] = -(KR[t * 3 + 0] / K);
      KR[t * 3 + 1] = norm_z ? safe_norm_sq(ysq) : 0.f;
      KR[t * 3 + 2] = norm_j ? KR[t * 3 + 2] / K : 0.f;
    }
    __syncthreads();
  }
};

// The probe instance's tile arrays: the solver's, two hidden blocks and the
// probe pieces (eps, V, eJ).
__host__ __device__ inline size_t probe_tile_floats(const WideLayout& L, int T) {
  return (size_t)T * (2 * L.zp + 3) + (size_t)T * (2 * L.hsum + 3 * L.zp);
}

struct ProbeArgs {
  Args a;
  int K, jvp;
};

__global__ void __launch_bounds__(kWideBlock) k1_wide_probe_solve(const ProbeArgs pa) {
  extern __shared__ __align__(16) float smem[];
  __shared__ WideLayout L;
  const Args& p = pa.a;
  cnf::share_layout(p.L, &L);
  const int T = p.T;
  float* w = smem;
  float* red = w + L.wfloats;
  float* scratch = red + kRedFloats;  // the solver's Z, KY, KR
  float* HB = scratch + T * (2 * L.zp + 3);
  float* TB = HB + T * L.hsum;
  float* E = TB + T * L.hsum;
  float* V = E + T * L.zp;
  float* EJ = V + T * L.zp;
  cnf::load_wide_weights(p.params, L, w);
  __syncthreads();
  const WideProbeField<false> field{
      {}, &L, w, p.f.eps, HB, TB, E, V, EJ, p.f.B, T, pa.K, pa.jvp, p.f.norm_z, p.f.norm_j};
  cnf::forward_solve_tiles<3, kStageUnroll>(p.f, field, T, scratch, red);
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

// The probe COND instance's tile arrays: the probe instance's and the
// tile's ys rows (T, nc).
__host__ __device__ inline size_t probe_cond_tile_floats(const WideLayout& L, int T) {
  return probe_tile_floats(L, T) + (size_t)T * cnf::wide_nc(L);
}

__global__ void __launch_bounds__(kWideBlock) k1_wide_probe_cond_solve(const __grid_constant__ ProbeCondArgs pc) {
  extern __shared__ __align__(16) float smem[];
  __shared__ WideLayout L;
  const ProbeArgs& pa = pc.pa;
  const Args& p = pa.a;
  cnf::share_layout(p.L, &L);
  const int T = p.T;
  float* w = smem;
  float* red = w + L.wfloats;
  float* scratch = red + kRedFloats;  // the solver's Z, KY, KR
  float* HB = scratch + T * (2 * L.zp + 3);
  float* TB = HB + T * L.hsum;
  float* E = TB + T * L.hsum;
  float* V = E + T * L.zp;
  float* EJ = V + T * L.zp;
  float* YS = EJ + T * L.zp;
  cnf::load_wide_weights(p.params, L, w);
  __syncthreads();
  const WideProbeField<true> field{
      {pc.ys, YS}, &L, w, p.f.eps, HB, TB, E, V, EJ, p.f.B, T, pa.K, pa.jvp, p.f.norm_z, p.f.norm_j};
  cnf::forward_solve_tiles<3, kStageUnroll>(p.f, field, T, scratch, red);
}

size_t probe_cond_smem_bytes(const WideLayout& L, int T) {
  return sizeof(float) * ((size_t)L.wfloats + kRedFloats + probe_cond_tile_floats(L, T));
}

}  // namespace

// The launch shape at batch B: out = {threads per block, blocks, samples a
// tile, dynamic shared memory bytes}, the largest tile whose shared memory
// leaves a co-resident grid.  widths: n + 1 level widths (host memory).
// Returns a cudaError_t (cudaErrorInvalidValue for a chain not covered).
extern "C" int cnf_k1w_shape(int n, const int* widths, int B, int* out) {
  WideLayout L;
  if (B < 1 || !cnf::make_wide_layout(n, widths, &L)) return (int)cudaErrorInvalidValue;
  size_t smem[3];
  for (int o = 0; o < 3; ++o) smem[o] = smem_bytes(L, kTiles[o]);
  return cnf::wide_shape(k1_wide_solve, smem, kTiles, kTiles, 3, B, out);
}

// params: [W0 | b0 | ...] flat (device); eps, z0: (B, dz); acts: bit i set
// where layer i is tanh (else identity); acc0/accT: (3, B), rows [dlogp |
// reg_e | reg_n]; dt_last: (2), the next step size and the last step taken;
// work: (S + 2) (dz + 3) B floats; partials: 6 grid.  tab: kTableauFloats
// floats (read_tableau).  T, grid, block: from cnf_k1w_shape.  Returns the
// launch's cudaError_t.
extern "C" int cnf_k1w_train_solve(const float* params, const float* eps, const float* z0, const float* acc0,
                                   const float* ts, float* zT, float* accT, int* stats, float* dt_last, float* work,
                                   float* partials, int B, int n, const int* widths, int acts, int max_steps,
                                   int norm_z, int norm_j, float rtol, float atol, float beta1, float beta2,
                                   float inv_order, const float* tab, int T, int grid, int block, void* stream) {
  Args a = {};
  if (block != kWideBlock || grid < 1 || T < cnf::kRows || T % cnf::kRows != 0 ||
      !cnf::make_wide_layout(n, widths, &a.L))
    return (int)cudaErrorInvalidValue;
  cnf::set_wide_acts(&a.L, acts);
  cnf::set_fwd_args(&a.f, eps, z0, acc0, ts, zT, accT, stats, dt_last, work, partials, B, widths[n], max_steps,
                    norm_z, norm_j, rtol, atol, beta1, beta2, inv_order, tab);
  a.params = params;
  a.T = T;
  return (int)cnf::coop_launch(k1_wide_solve, a, grid, block, smem_bytes(a.L, T), (cudaStream_t)stream);
}

// The probe instance's launch shape (K6), as cnf_k1w_shape.
extern "C" int cnf_k1wp_shape(int n, const int* widths, int B, int* out) {
  WideLayout L;
  if (B < 1 || !cnf::make_wide_layout(n, widths, &L)) return (int)cudaErrorInvalidValue;
  size_t smem[3];
  for (int o = 0; o < 3; ++o) smem[o] = probe_smem_bytes(L, kTiles[o]);
  return cnf::wide_shape(k1_wide_probe_solve, smem, kTiles, kTiles, 3, B, out);
}

// The probe instance (K6): as cnf_k1w_train_solve with eps (K, B, dz), K >= 1
// probes, reverse mode or (jvp) forward mode; T, grid, block from
// cnf_k1wp_shape.
extern "C" int cnf_k1w_probe_solve(const float* params, const float* eps, const float* z0, const float* acc0,
                                   const float* ts, float* zT, float* accT, int* stats, float* dt_last, float* work,
                                   float* partials, int B, int n, const int* widths, int acts, int max_steps,
                                   int norm_z, int norm_j, int K, int jvp, float rtol, float atol, float beta1,
                                   float beta2, float inv_order, const float* tab, int T, int grid, int block,
                                   void* stream) {
  ProbeArgs pa = {};
  if (block != kWideBlock || grid < 1 || T < cnf::kRows || T % cnf::kRows != 0 || K < 1 ||
      !cnf::make_wide_layout(n, widths, &pa.a.L))
    return (int)cudaErrorInvalidValue;
  cnf::set_wide_acts(&pa.a.L, acts);
  cnf::set_fwd_args(&pa.a.f, eps, z0, acc0, ts, zT, accT, stats, dt_last, work, partials, B, widths[n], max_steps,
                    norm_z, norm_j, rtol, atol, beta1, beta2, inv_order, tab);
  pa.a.params = params;
  pa.a.T = T;
  pa.K = K;
  pa.jvp = jvp;
  return (int)cnf::coop_launch(k1_wide_probe_solve, pa, grid, block, probe_smem_bytes(pa.a.L, T),
                               (cudaStream_t)stream);
}

// The COND instance's launch shape (K8), as cnf_k1w_shape; widths[0] =
// dz + nc with nc >= 1.
extern "C" int cnf_k1wc_shape(int n, const int* widths, int B, int* out) {
  WideLayout L;
  if (B < 1 || !cnf::make_wide_layout(n, widths, &L, true)) return (int)cudaErrorInvalidValue;
  size_t smem[3];
  for (int o = 0; o < 3; ++o) smem[o] = cond_smem_bytes(L, kTiles[o]);
  return cnf::wide_shape(k1_wide_cond_solve, smem, kTiles, kTiles, 3, B, out);
}

// The COND instance (K8): as cnf_k1w_train_solve for a conditional chain,
// with ys (B, nc) (device), nc = widths[0] - widths[n] >= 1; T, grid, block
// from cnf_k1wc_shape.
extern "C" int cnf_k1w_cond_solve(const float* params, const float* eps, const float* ys, const float* z0,
                                  const float* acc0, const float* ts, float* zT, float* accT, int* stats,
                                  float* dt_last, float* work, float* partials, int B, int n, const int* widths,
                                  int acts, int max_steps, int norm_z, int norm_j, float rtol, float atol,
                                  float beta1, float beta2, float inv_order, const float* tab, int T, int grid,
                                  int block, void* stream) {
  CondArgs ca = {};
  Args& a = ca.a;
  if (block != kWideBlock || grid < 1 || T < cnf::kRows || T % cnf::kRows != 0 || ys == nullptr ||
      !cnf::make_wide_layout(n, widths, &a.L, true))
    return (int)cudaErrorInvalidValue;
  cnf::set_wide_acts(&a.L, acts);
  cnf::set_fwd_args(&a.f, eps, z0, acc0, ts, zT, accT, stats, dt_last, work, partials, B, widths[n], max_steps,
                    norm_z, norm_j, rtol, atol, beta1, beta2, inv_order, tab);
  a.params = params;
  a.T = T;
  ca.ys = ys;
  return (int)cnf::coop_launch(k1_wide_cond_solve, ca, grid, block, cond_smem_bytes(a.L, T), (cudaStream_t)stream);
}

// The probe COND instance's launch shape (K6 x K8), as cnf_k1wc_shape.
extern "C" int cnf_k1wpc_shape(int n, const int* widths, int B, int* out) {
  WideLayout L;
  if (B < 1 || !cnf::make_wide_layout(n, widths, &L, true)) return (int)cudaErrorInvalidValue;
  size_t smem[3];
  for (int o = 0; o < 3; ++o) smem[o] = probe_cond_smem_bytes(L, kTiles[o]);
  return cnf::wide_shape(k1_wide_probe_cond_solve, smem, kTiles, kTiles, 3, B, out);
}

// The probe COND instance (K6 x K8): as cnf_k1w_probe_solve for a
// conditional chain, with ys (B, nc) (device) after eps (K, B, dz),
// nc = widths[0] - widths[n] >= 1; T, grid, block from cnf_k1wpc_shape.
extern "C" int cnf_k1w_probe_cond_solve(const float* params, const float* eps, const float* ys, const float* z0,
                                        const float* acc0, const float* ts, float* zT, float* accT, int* stats,
                                        float* dt_last, float* work, float* partials, int B, int n,
                                        const int* widths, int acts, int max_steps, int norm_z, int norm_j, int K,
                                        int jvp, float rtol, float atol, float beta1, float beta2, float inv_order,
                                        const float* tab, int T, int grid, int block, void* stream) {
  ProbeCondArgs pc = {};
  ProbeArgs& pa = pc.pa;
  if (block != kWideBlock || grid < 1 || T < cnf::kRows || T % cnf::kRows != 0 || K < 1 || ys == nullptr ||
      !cnf::make_wide_layout(n, widths, &pa.a.L, true))
    return (int)cudaErrorInvalidValue;
  cnf::set_wide_acts(&pa.a.L, acts);
  cnf::set_fwd_args(&pa.a.f, eps, z0, acc0, ts, zT, accT, stats, dt_last, work, partials, B, widths[n], max_steps,
                    norm_z, norm_j, rtol, atol, beta1, beta2, inv_order, tab);
  pa.a.params = params;
  pa.a.T = T;
  pa.K = K;
  pa.jvp = jvp;
  pc.ys = ys;
  return (int)cnf::coop_launch(k1_wide_probe_cond_solve, pc, grid, block, probe_cond_smem_bytes(pa.a.L, T),
                               (cudaStream_t)stream);
}
