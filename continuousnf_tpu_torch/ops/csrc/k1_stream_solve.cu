// The streamed K1 chain form: the TRAIN-mode forward solve of a CNF whose
// field is an unconditional Dense chain of 2 to 4 tanh or identity layers
// with state width up to 128 and hidden widths past what the wide forms keep
// in shared memory (FFJORD's tabular MINIBOONE model 43 -> 860 -> 860 ->
// 43), one Hutchinson probe (reverse mode), the whole adaptive solve (any
// embedded explicit tableau, K9) in one cooperative launch.
//
// Replaces, at these widths, the TPU kernel continuousnf_tpu/ops/fused_solve.py::
// _run_solve_kernel (pl.pallas_call at :1043) built by _make_solve_kernel
// (:773-942) with the N-layer _stage_train stage (:333-369): _chain_fwd
// (:272) and _probe_pullback (:291).  Per sample and field evaluation, as the
// wide K1 chain form (k1_wide_solve.cu):
//   forward   h_1 = s_0(z W_0 + b_0), h_(l+1) = s_l(h_l W_l + b_l), y = h_N;
//   pullback  v = eps s'(y), then up the layers u_l = v_l W_l^T,
//             v_(l-1) = u_l s'(h_l), eJ = v_0 W_0^T;
//   rates     -<eJ, eps>, ||y|| (norm_z), ||eJ|| (norm_j) (safe norms);
// then ONE Hairer norm over all B * (dz + 3) elements per attempted step
// (forward_solve_tiles of solve_common.cuh).
//
// Design: a block evaluates each stage for a tile of T = 8 samples (4 where
// the shared memory asks for it) through the streamed chain layer of
// chain_stream.cuh: the weights stay in global memory (3.25 MB at 860 wide,
// L2-resident) and stream through a 17 KB chunk buffer; per tile row the
// stage input and output and the probe pieces (z, y, eps, v, eJ: 5 x 44),
// the hidden block (activations, then the pullback's gated cotangents in
// place: 1,720 floats at 860 wide) and 3 rates sit in shared memory (79 KB
// at T = 8 with the chunk buffer), or in a global scratch for wider nets.
// B = 1024 gives 128 tiles for 132 SMs, one block each.
// What bounds it on the H100: one field evaluation is a forward pass and one
// pullback, 2 x 813,560 FMA per sample at 860 wide: 3.3 GFLOP a stage at
// B = 1024, 50 us at the card's f32 rate.  Each weight read from the L2
// serves the tile's 8 rows, so every block reads 6.5 MB of weights a stage
// (0.83 GB for 128 blocks).  Measured, the chunks' L2 latency bounds it: the
// layer loads the next chunk while computing on the current one (PERF.md).
// Precision: f32 FMA on the CUDA cores, no TF32 and no tensor cores.
//
// The probe instance (K6 in the streamed forms): _stage_train with
// k_probes = K and jvp (the probe loop :350-364, _probe_pushforward
// :309-330), as the wide K1 chain form's probe instance runs it: per stage
// one stream_forward pass, then per probe eps_k = eps[k] of the (K, B, dz)
// probes, eps^T J by stream_pullback_to (VJP) or J eps by
// stream_pushforward (JVP), and the trace and probe-norm terms summed over
// the probes in probe order and divided by K.  The pullback can no longer
// overwrite the activations, so a tile row gets a second hidden block for a
// probe's vectors (1,720 floats at 860 wide: 3,663 tile floats a row,
// 134 KB at T = 8 with the chunk buffer).  K and the direction are run-time
// values; the one-probe instance above stays as it was.  A field evaluation
// is S (1 + K) FMA a sample (S = 813,560 at 860 wide): 8.3 GFLOP at K = 4
// and B = 1024, 0.12 ms at the card's f32 rate.
//
// The COND instance (K8 in the streamed forms): the same solve of a
// conditional chain past the wide limits, whose first layer reads [z | ys]
// (_stage_train with _zin :265, one VJP probe: CondRNODE at the MINIBOONE
// width, 87 -> 258 -> 86, or MLP 44 -> 860 -> 860 -> 43 on [z | ys]).  The
// ys values (B, nc) are constant over the solve: at each evaluation the
// block loads its tile's (T, nc) rows and the forward adds layer 0's ys
// rows (kept after its z rows) to the pre-activation (stream_forward
// <true>); the pullback reads the z rows alone, as the one-probe instance
// does.  At cond_miniboone86 that is 258 more FMA a sample and evaluation
// beside 2 x 44,376.  Its tile arrays are the one-probe instance's and the
// ys rows (T, nc), which the global-scratch form counts in each block's
// slice; its launch shape and entry are cnf_k1sc_shape and
// cnf_k1s_cond_solve.
//
// The probe COND instance (K6 x K8): the probe instance's field on a
// conditional chain past the wide limits (_stage_train with k_probes = K or
// jvp, on _zin): per stage one stream_forward<true> from the tile's (T, nc)
// ys rows, then per probe its pullback ending on layer 0's z rows
// (stream_pullback_to) or its pushforward from the tangent [eps | 0]
// (stream_pushforward<true>, :318-321), the trace and probe-norm terms
// summed in probe order and divided by K, as in the probe instance.  Its
// tile arrays are the probe instance's and the tile's ys rows (T, nc),
// counted in each block's slice of the global scratch too; its launch
// shape and entry are cnf_k1spc_shape and cnf_k1s_probe_cond_solve.

#include "chain_stream.cuh"

namespace {

constexpr int kStageUnroll = 4;
constexpr int kTiles[] = {8, 4};

using cnf::kRedFloats;
using cnf::kStreamBlock;
using cnf::safe_norm_sq;
using cnf::StreamLayout;

struct Args {
  cnf::FwdArgs f;
  StreamLayout L;
  const float* params;  // [W0 | b0 | W1 | b1 | ...]
  float* tiles;         // global scratch of the tile arrays (grid x region), null: shared memory
  int T;                // samples a tile
};

// A COND field's conditioning: ys (B, nc) in global memory and the tile's
// (T, nc) rows; nothing in an unconditional field.
template <bool COND>
struct CondRows {};
template <>
struct CondRows<true> {
  const float* ys;
  float* YS;
};

// The TRAIN field of a tile: KY = y, KR = [-tr, ||y||, ||eJ||] per row.
template <bool COND>
struct StreamTrainField : CondRows<COND> {
  const StreamLayout* L;
  const float* params;
  const float* eps;  // (B, dz)
  float* HB;         // the tile's hidden block
  float* E;          // (T, zp) each: eps, the gated probe, eJ
  float* V;
  float* EJ;
  float* wc;         // the chunk buffer
  int T, norm_z, norm_j;

  __device__ void operator()(int s0, int nv, const float* Z, float* KY, float* KR) const {
    const StreamLayout& c = *L;
    const int dz = c.dz, zp = c.zp, on = c.act[c.n - 1];
    if constexpr (COND) {
      cnf::load_tile_cond(this->ys, cnf::stream_nc(c), s0, nv, T, this->YS);
      cnf::stream_forward<true>(c, params, Z, T, HB, KY, wc, this->YS);
    } else {
      cnf::stream_forward(c, params, Z, T, HB, KY, wc);
    }
    for (int idx = threadIdx.x; idx < T * dz; idx += blockDim.x) {
      const int t = idx / dz, k = idx % dz;
      const float e = t < nv ? eps[(size_t)s0 * dz + idx] : 0.f;
      E[t * zp + k] = e;
      V[t * zp + k] = e * cnf::gate(KY[t * zp + k], on);
    }
    __syncthreads();
    cnf::stream_pullback(c, params, V, T, HB, EJ, wc);
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

// The tile arrays: the solver's Z, KY, KR, the hidden block and eps, V, eJ.
__host__ __device__ inline size_t region_floats(const StreamLayout& L, int T) {
  return (size_t)T * (2 * L.zp + 3) + (size_t)T * (L.hsum + 3 * L.zp);
}

__global__ void __launch_bounds__(kStreamBlock) k1_stream_solve(const Args p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ StreamLayout L;
  cnf::share_layout(p.L, &L);
  const int T = p.T;
  float* wc = smem;
  float* red = wc + cnf::kChunkFloats;
  float* scratch = p.tiles ? p.tiles + (size_t)blockIdx.x * region_floats(L, T) : red + kRedFloats;  // Z, KY, KR
  float* HB = scratch + T * (2 * L.zp + 3);
  float* E = HB + (size_t)T * L.hsum;
  float* V = E + T * L.zp;
  float* EJ = V + T * L.zp;
  const StreamTrainField<false> field{{}, &L, p.params, p.f.eps, HB, E, V, EJ, wc, T, p.f.norm_z, p.f.norm_j};
  cnf::forward_solve_tiles<3, kStageUnroll>(p.f, field, T, scratch, red);
}

size_t smem_bytes(const StreamLayout& L, int T, bool global_tiles) {
  return sizeof(float) * ((size_t)cnf::kChunkFloats + kRedFloats + (global_tiles ? 0 : region_floats(L, T)));
}

// The COND instance's arguments: the one-probe instance's and the
// conditioning ys (B, nc).
struct CondArgs {
  Args a;
  const float* ys;
};

// The COND instance's tile arrays: the one-probe instance's and the tile's
// ys rows (T, nc), in shared memory or in the block's slice of the global
// scratch alike.
__host__ __device__ inline size_t cond_region_floats(const StreamLayout& L, int T) {
  return region_floats(L, T) + (size_t)T * cnf::stream_nc(L);
}

__global__ void __launch_bounds__(kStreamBlock) k1_stream_cond_solve(const __grid_constant__ CondArgs ca) {
  extern __shared__ __align__(16) float smem[];
  __shared__ StreamLayout L;
  const Args& p = ca.a;
  cnf::share_layout(p.L, &L);
  const int T = p.T;
  float* wc = smem;
  float* red = wc + cnf::kChunkFloats;
  float* scratch = p.tiles ? p.tiles + (size_t)blockIdx.x * cond_region_floats(L, T) : red + kRedFloats;
  float* HB = scratch + T * (2 * L.zp + 3);
  float* E = HB + (size_t)T * L.hsum;
  float* V = E + T * L.zp;
  float* EJ = V + T * L.zp;
  float* YS = EJ + T * L.zp;
  const StreamTrainField<true> field{{ca.ys, YS}, &L, p.params, p.f.eps, HB, E, V, EJ, wc, T, p.f.norm_z,
                                     p.f.norm_j};
  cnf::forward_solve_tiles<3, kStageUnroll>(p.f, field, T, scratch, red);
}

size_t cond_smem_bytes(const StreamLayout& L, int T, bool global_tiles) {
  return sizeof(float) * ((size_t)cnf::kChunkFloats + kRedFloats + (global_tiles ? 0 : cond_region_floats(L, T)));
}

// The probe instance's field (K6): K probes a row at eps[k][s], reverse
// (eps^T J) or, `jvp`, forward mode (J eps); HB keeps the activations and a
// probe's hidden vectors go to TB.  COND: the forward reads the tile's ys
// rows, the probe passes layer 0's z rows alone.
template <bool COND>
struct StreamProbeField : CondRows<COND> {
  const StreamLayout* L;
  const float* params;
  const float* eps;  // (K, B, dz)
  float* HB;         // the tile's hidden blocks: activations, a probe's vectors
  float* TB;
  float* E;          // (T, zp) each: eps, the gated probe (VJP) or t W (JVP), eJ
  float* V;
  float* EJ;
  float* wc;         // the chunk buffer
  int B, T, K, jvp, norm_z, norm_j;

  __device__ void operator()(int s0, int nv, const float* Z, float* KY, float* KR) const {
    const StreamLayout& c = *L;
    const int dz = c.dz, zp = c.zp, on = c.act[c.n - 1];
    if constexpr (COND) {
      cnf::load_tile_cond(this->ys, cnf::stream_nc(c), s0, nv, T, this->YS);
      cnf::stream_forward<true>(c, params, Z, T, HB, KY, wc, this->YS);
    } else {
      cnf::stream_forward(c, params, Z, T, HB, KY, wc);
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
        cnf::stream_pushforward<COND>(c, params, E, T, HB, nullptr, TB, V, wc);
        for (int idx = threadIdx.x; idx < T * dz; idx += blockDim.x) {
          const int t = idx / dz, k = idx % dz;
          EJ[t * zp + k] = V[t * zp + k] * cnf::gate(KY[t * zp + k], on);
        }
        __syncthreads();
      } else {
        cnf::stream_pullback_to(c, params, V, T, HB, TB, EJ, wc);
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
__host__ __device__ inline size_t probe_region_floats(const StreamLayout& L, int T) {
  return (size_t)T * (2 * L.zp + 3) + (size_t)T * (2 * (size_t)L.hsum + 3 * L.zp);
}

struct ProbeArgs {
  Args a;
  int K, jvp;
};

__global__ void __launch_bounds__(kStreamBlock) k1_stream_probe_solve(const ProbeArgs pa) {
  extern __shared__ __align__(16) float smem[];
  __shared__ StreamLayout L;
  const Args& p = pa.a;
  cnf::share_layout(p.L, &L);
  const int T = p.T;
  float* wc = smem;
  float* red = wc + cnf::kChunkFloats;
  float* scratch = p.tiles ? p.tiles + (size_t)blockIdx.x * probe_region_floats(L, T) : red + kRedFloats;
  float* HB = scratch + T * (2 * L.zp + 3);  // after the solver's Z, KY, KR
  float* TB = HB + (size_t)T * L.hsum;
  float* E = TB + (size_t)T * L.hsum;
  float* V = E + T * L.zp;
  float* EJ = V + T * L.zp;
  const StreamProbeField<false> field{{}, &L, p.params, p.f.eps, HB, TB, E, V, EJ, wc, p.f.B, T, pa.K, pa.jvp,
                                      p.f.norm_z, p.f.norm_j};
  cnf::forward_solve_tiles<3, kStageUnroll>(p.f, field, T, scratch, red);
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

// The probe COND instance's tile arrays: the probe instance's and the
// tile's ys rows (T, nc), in shared memory or in the block's slice of the
// global scratch alike.
__host__ __device__ inline size_t probe_cond_region_floats(const StreamLayout& L, int T) {
  return probe_region_floats(L, T) + (size_t)T * cnf::stream_nc(L);
}

__global__ void __launch_bounds__(kStreamBlock) k1_stream_probe_cond_solve(const __grid_constant__ ProbeCondArgs pc) {
  extern __shared__ __align__(16) float smem[];
  __shared__ StreamLayout L;
  const ProbeArgs& pa = pc.pa;
  const Args& p = pa.a;
  cnf::share_layout(p.L, &L);
  const int T = p.T;
  float* wc = smem;
  float* red = wc + cnf::kChunkFloats;
  float* scratch = p.tiles ? p.tiles + (size_t)blockIdx.x * probe_cond_region_floats(L, T) : red + kRedFloats;
  float* HB = scratch + T * (2 * L.zp + 3);  // after the solver's Z, KY, KR
  float* TB = HB + (size_t)T * L.hsum;
  float* E = TB + (size_t)T * L.hsum;
  float* V = E + T * L.zp;
  float* EJ = V + T * L.zp;
  float* YS = EJ + T * L.zp;
  const StreamProbeField<true> field{{pc.ys, YS}, &L, p.params, p.f.eps, HB, TB, E, V, EJ, wc, p.f.B, T, pa.K,
                                     pa.jvp, p.f.norm_z, p.f.norm_j};
  cnf::forward_solve_tiles<3, kStageUnroll>(p.f, field, T, scratch, red);
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
extern "C" int cnf_k1s_shape(int n, const int* widths, int B, int* out) {
  StreamLayout L;
  if (B < 1 || !cnf::make_stream_layout(n, widths, &L)) return (int)cudaErrorInvalidValue;
  size_t region[2];
  for (int o = 0; o < 2; ++o) region[o] = region_floats(L, kTiles[o]);
  return cnf::stream_shape(k1_stream_solve, region, kTiles, kTiles, 2, B, out);
}

// params: [W0 | b0 | ...] flat (device); eps, z0: (B, dz); acts: bit i set
// where layer i is tanh (else identity); acc0/accT: (3, B), rows [dlogp |
// reg_e | reg_n]; dt_last: (2), the next step size and the last step taken;
// work: (S + 2) (dz + 3) B floats; partials: 6 grid; tiles: grid x out[4]
// floats of cnf_k1s_shape, or null when out[4] is 0.  tab: kTableauFloats
// floats (read_tableau).  T, grid, block: from cnf_k1s_shape.  Returns the
// launch's cudaError_t.
extern "C" int cnf_k1s_train_solve(const float* params, const float* eps, const float* z0, const float* acc0,
                                   const float* ts, float* zT, float* accT, int* stats, float* dt_last, float* work,
                                   float* partials, float* tiles, int B, int n, const int* widths, int acts,
                                   int max_steps, int norm_z, int norm_j, float rtol, float atol, float beta1,
                                   float beta2, float inv_order, const float* tab, int T, int grid, int block,
                                   void* stream) {
  Args a = {};
  if (block != kStreamBlock || grid < 1 || T < 4 || T % 4 != 0 || !cnf::make_stream_layout(n, widths, &a.L))
    return (int)cudaErrorInvalidValue;
  cnf::set_stream_acts(&a.L, acts);
  cnf::set_fwd_args(&a.f, eps, z0, acc0, ts, zT, accT, stats, dt_last, work, partials, B, widths[n], max_steps,
                    norm_z, norm_j, rtol, atol, beta1, beta2, inv_order, tab);
  a.params = params;
  a.tiles = tiles;
  a.T = T;
  return (int)cnf::coop_launch(k1_stream_solve, a, grid, block, smem_bytes(a.L, T, tiles != nullptr),
                               (cudaStream_t)stream);
}

// The probe instance's launch shape (K6), as cnf_k1s_shape.
extern "C" int cnf_k1sp_shape(int n, const int* widths, int B, int* out) {
  StreamLayout L;
  if (B < 1 || !cnf::make_stream_layout(n, widths, &L)) return (int)cudaErrorInvalidValue;
  size_t region[2];
  for (int o = 0; o < 2; ++o) region[o] = probe_region_floats(L, kTiles[o]);
  return cnf::stream_shape(k1_stream_probe_solve, region, kTiles, kTiles, 2, B, out);
}

// The probe instance (K6): as cnf_k1s_train_solve with eps (K, B, dz), K >= 1
// probes, reverse mode or (jvp) forward mode; T, grid, block and the tile
// scratch from cnf_k1sp_shape.
extern "C" int cnf_k1s_probe_solve(const float* params, const float* eps, const float* z0, const float* acc0,
                                   const float* ts, float* zT, float* accT, int* stats, float* dt_last, float* work,
                                   float* partials, float* tiles, int B, int n, const int* widths, int acts,
                                   int max_steps, int norm_z, int norm_j, int K, int jvp, float rtol, float atol,
                                   float beta1, float beta2, float inv_order, const float* tab, int T, int grid,
                                   int block, void* stream) {
  ProbeArgs pa = {};
  Args& a = pa.a;
  if (block != kStreamBlock || grid < 1 || T < 4 || T % 4 != 0 || K < 1 || !cnf::make_stream_layout(n, widths, &a.L))
    return (int)cudaErrorInvalidValue;
  cnf::set_stream_acts(&a.L, acts);
  cnf::set_fwd_args(&a.f, eps, z0, acc0, ts, zT, accT, stats, dt_last, work, partials, B, widths[n], max_steps,
                    norm_z, norm_j, rtol, atol, beta1, beta2, inv_order, tab);
  a.params = params;
  a.tiles = tiles;
  a.T = T;
  pa.K = K;
  pa.jvp = jvp;
  return (int)cnf::coop_launch(k1_stream_probe_solve, pa, grid, block, probe_smem_bytes(a.L, T, tiles != nullptr),
                               (cudaStream_t)stream);
}

// The COND instance's launch shape (K8), as cnf_k1s_shape; widths[0] =
// dz + nc with nc >= 1, out[4] counting the tile's ys rows.
extern "C" int cnf_k1sc_shape(int n, const int* widths, int B, int* out) {
  StreamLayout L;
  if (B < 1 || !cnf::make_stream_layout(n, widths, &L, true)) return (int)cudaErrorInvalidValue;
  size_t region[2];
  for (int o = 0; o < 2; ++o) region[o] = cond_region_floats(L, kTiles[o]);
  return cnf::stream_shape(k1_stream_cond_solve, region, kTiles, kTiles, 2, B, out);
}

// The COND instance (K8): as cnf_k1s_train_solve for a conditional chain,
// with ys (B, nc) (device) after eps, nc = widths[0] - widths[n] >= 1; T,
// grid, block and the tile scratch from cnf_k1sc_shape.
extern "C" int cnf_k1s_cond_solve(const float* params, const float* eps, const float* ys, const float* z0,
                                  const float* acc0, const float* ts, float* zT, float* accT, int* stats,
                                  float* dt_last, float* work, float* partials, float* tiles, int B, int n,
                                  const int* widths, int acts, int max_steps, int norm_z, int norm_j, float rtol,
                                  float atol, float beta1, float beta2, float inv_order, const float* tab, int T,
                                  int grid, int block, void* stream) {
  CondArgs ca = {};
  Args& a = ca.a;
  if (block != kStreamBlock || grid < 1 || T < 4 || T % 4 != 0 || ys == nullptr ||
      !cnf::make_stream_layout(n, widths, &a.L, true))
    return (int)cudaErrorInvalidValue;
  cnf::set_stream_acts(&a.L, acts);
  cnf::set_fwd_args(&a.f, eps, z0, acc0, ts, zT, accT, stats, dt_last, work, partials, B, widths[n], max_steps,
                    norm_z, norm_j, rtol, atol, beta1, beta2, inv_order, tab);
  a.params = params;
  a.tiles = tiles;
  a.T = T;
  ca.ys = ys;
  return (int)cnf::coop_launch(k1_stream_cond_solve, ca, grid, block, cond_smem_bytes(a.L, T, tiles != nullptr),
                               (cudaStream_t)stream);
}

// The probe COND instance's launch shape (K6 x K8), as cnf_k1sc_shape.
extern "C" int cnf_k1spc_shape(int n, const int* widths, int B, int* out) {
  StreamLayout L;
  if (B < 1 || !cnf::make_stream_layout(n, widths, &L, true)) return (int)cudaErrorInvalidValue;
  size_t region[2];
  for (int o = 0; o < 2; ++o) region[o] = probe_cond_region_floats(L, kTiles[o]);
  return cnf::stream_shape(k1_stream_probe_cond_solve, region, kTiles, kTiles, 2, B, out);
}

// The probe COND instance (K6 x K8): as cnf_k1s_probe_solve for a
// conditional chain, with ys (B, nc) (device) after eps (K, B, dz),
// nc = widths[0] - widths[n] >= 1; T, grid, block and the tile scratch from
// cnf_k1spc_shape.
extern "C" int cnf_k1s_probe_cond_solve(const float* params, const float* eps, const float* ys, const float* z0,
                                        const float* acc0, const float* ts, float* zT, float* accT, int* stats,
                                        float* dt_last, float* work, float* partials, float* tiles, int B, int n,
                                        const int* widths, int acts, int max_steps, int norm_z, int norm_j, int K,
                                        int jvp, float rtol, float atol, float beta1, float beta2, float inv_order,
                                        const float* tab, int T, int grid, int block, void* stream) {
  ProbeCondArgs pc = {};
  ProbeArgs& pa = pc.pa;
  Args& a = pa.a;
  if (block != kStreamBlock || grid < 1 || T < 4 || T % 4 != 0 || K < 1 || ys == nullptr ||
      !cnf::make_stream_layout(n, widths, &a.L, true))
    return (int)cudaErrorInvalidValue;
  cnf::set_stream_acts(&a.L, acts);
  cnf::set_fwd_args(&a.f, eps, z0, acc0, ts, zT, accT, stats, dt_last, work, partials, B, widths[n], max_steps,
                    norm_z, norm_j, rtol, atol, beta1, beta2, inv_order, tab);
  a.params = params;
  a.tiles = tiles;
  a.T = T;
  pa.K = K;
  pa.jvp = jvp;
  pc.ys = ys;
  return (int)cnf::coop_launch(k1_stream_probe_cond_solve, pc, grid, block,
                               probe_cond_smem_bytes(a.L, T, tiles != nullptr), (cudaStream_t)stream);
}
