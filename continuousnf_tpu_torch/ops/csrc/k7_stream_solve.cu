// Streamed K7: the forward solves of a CNF whose field is an unconditional
// Dense chain of 2 to 8 tanh or identity layers with state width up to 128
// and hidden widths past what the wide forms keep in shared memory (FFJORD's
// tabular MINIBOONE model 43 -> 860 -> 860 -> 43), the exact trace by basis
// propagation, the whole adaptive solve (any embedded explicit tableau, K9)
// in one cooperative launch.  Two entries:
//   * TEST: the state [z | dlogp], rate -tr J (one accumulator row);
//   * exact TRAIN: [z | dlogp | reg_e | reg_n], rates -tr J, ||y|| (norm_z)
//     and ||J||_F (norm_j).
//
// Replaces, at these widths, the TPU kernel continuousnf_tpu/ops/fused_solve.py::
// _run_solve_kernel (pl.pallas_call at :1043) built by _make_solve_kernel
// (:773-942) with _stage_test -> _stage_exact_chain (:484-493, :678-719;
// want_fro=False) and with _stage_train_exact_chain (:722-728).  As in the
// JAX package these are forward-only: a deep exact chain's gradient runs the
// plain BACKSOLVE.  2-layer nets past the wide forms' widths run them too
// (the trace and ||J||_F of the 2-layer closed forms, by the same push).
//
// Per sample and field evaluation, as wide K7 (k7_wide_solve.cu): the
// forward pass, each hidden level's activation h replaced by its gate d,
// then for each basis column j < dz one column of J pushed through the
// linearised layers:
//   t_1 = d_1 (.) W_0[j, :],  t_(l+1) = d_(l+1) (.) (t_l W_l),
//   t_N = dy (.) (t_(N-1) W_(N-1)),
// tr += t_N[j] and, exact, ||J||_F^2 += |t_N|^2.
//
// Design: a tile of T = 4 samples has T dz basis rows (t, j) (172 at dz 43).
// One sample's basis block at a hidden level is dz x 860 floats (148 KB), so
// the push goes through the chain in chunks of R basis rows (R = 64, or 32,
// 16, 8 where the shared memory asks for it: 16 at 860 wide): each chunk
// goes through all layers, as (R x H) . (H x H) products of the streamed
// chain layer (chain_stream.cuh: the weights in global memory, L2-resident,
// through a 17 KB chunk buffer), before the next starts, and a sample's
// trace and Frobenius sums add up over the chunks in row order.  The last
// layer's product is taken whole in both entries (TEST keeps its diagonal
// entry: 1/45 of the push at 860 wide).  Shared memory at 860 wide and
// R = 16: the chunk buffer; per tile row the solver's z, y and rates, dy,
// the gates (a hidden block, 1,720) and 3 sums; two basis chunks R x 868 and
// two R-float row sums: 142 KB in all.  Past that the tile arrays go to a
// global scratch at R = 64.
// What bounds it on the H100: operations.  A TEST evaluation is about 44
// passes over the weights per sample (dz columns of the push and the
// forward pass, 35.8 M FMA at 860 wide): 73 GFLOP a stage at B = 1024,
// 1.1 ms at the card's f32 rate.  Each weight read from the L2 serves the
// chunk's R rows; measured, the chunk loads' latency and the block barriers
// bound it (PERF.md).
// Precision: f32 FMA on the CUDA cores, no TF32 and no tensor cores.
//
// The COND instances (K8 in the streamed forms: k7_stream_cond_solve<1>
// and <3>): the TEST and exact solves of a conditional chain whose first
// layer reads [z | ys], ys (B, nc) constant over the solve (a conditional
// FFJORD-MINIBOONE chain 44 -> 860 -> 860 -> 43; CondRNODE at the
// MINIBOONE width 87 -> 258 -> 86 under exact trace), the JAX package's
// _stage_exact_chain and _stage_train_exact_chain on _zin (:265-269).  At
// each evaluation the block loads its tile's (T, nc) ys rows and the
// forward adds layer 0's ys rows (kept after its z rows) to the
// pre-activation (stream_forward<true>); the basis push reads W0's rows
// j < dz alone, as the unconditional one does (the JAX package's :701: the
// trace is over z).  The ys rows (T, nc) join the tile arrays, in shared
// memory or in the block's slice of the global scratch alike; the launch
// shapes and entries are cnf_k7sc_test_shape / cnf_k7sc_exact_shape and
// cnf_k7s_cond_test_solve / cnf_k7s_cond_exact_solve.

#include "chain_stream.cuh"

namespace {

constexpr int kStageUnroll = 1;
constexpr int kTileSamples = 4;
constexpr int kChunks[] = {64, 32, 16, 8};
constexpr int kSamples[] = {kTileSamples, kTileSamples, kTileSamples, kTileSamples};

using cnf::kRedFloats;
using cnf::kStreamBlock;
using cnf::safe_norm_sq;
using cnf::StreamLayout;

struct Args {
  cnf::FwdArgs f;
  StreamLayout L;
  const float* params;  // [W0 | b0 | W1 | b1 | ...]
  float* tiles;         // global scratch of the tile arrays (grid x region), null: shared memory
  int R;                // basis rows a chunk
};

// The basis rows' pitch: the widest level rounded up to 4, plus 4.
__host__ __device__ inline int basis_pitch(const StreamLayout& L) {
  return cnf::round_up(L.hmax > L.dz ? L.hmax : L.dz, 4) + 4;
}

template <int NACC>
__host__ __device__ inline size_t region_floats(const StreamLayout& L, int R) {
  const int T = kTileSamples;
  return (size_t)T * (2 * L.zp + NACC) + (size_t)T * (L.hsum + L.zp + 3) + 2 * (size_t)R * basis_pitch(L) + 2 * R;
}

// A COND field's conditioning: ys (B, nc) in global memory and the tile's
// (T, nc) rows; nothing in an unconditional field.
template <bool COND>
struct CondRows {};
template <>
struct CondRows<true> {
  const float* ys;
  float* YS;
};

// The exact field of a tile: KY = y; KR = [-tr] (NACC = 1) or
// [-tr, ||y||, ||J||_F] (NACC = 3) per row.
template <int NACC, bool COND>
struct StreamExactField : CondRows<COND> {
  const StreamLayout* L;
  const float* params;
  float* HB;     // the tile's hidden block: activations, then gates
  float* DY;     // (T, zp): the output gate
  float* acc;    // (T, 3): ysq, tr, fro2
  float* ta;     // (R, bp) basis chunks
  float* tb;
  float* rowtr;  // (R): a chunk row's diagonal entry
  float* rowf2;  // (R): its squared norm
  float* wc;     // the chunk buffer
  int R, norm_z, norm_j;

  __device__ void operator()([[maybe_unused]] int s0, [[maybe_unused]] int nv, const float* Z, float* KY,
                             float* KR) const {
    const StreamLayout& c = *L;
    const int n = c.n, dz = c.dz, zp = c.zp, T = kTileSamples, bp = basis_pitch(c);
    if constexpr (COND) {
      cnf::load_tile_cond(this->ys, cnf::stream_nc(c), s0, nv, T, this->YS);
      cnf::stream_forward<true>(c, params, Z, T, HB, KY, wc, this->YS);
    } else {
      cnf::stream_forward(c, params, Z, T, HB, KY, wc);
    }
    for (int l = 1; l < n; ++l) {
      float* d = cnf::level(c, HB, T, l);
      const int wl = c.width[l], hp = c.hp[l], on = c.act[l - 1];
      for (int idx = threadIdx.x; idx < T * wl; idx += blockDim.x) {
        const int t = idx / wl, o = idx % wl;
        d[t * hp + o] = cnf::gate(d[t * hp + o], on);
      }
    }
    for (int idx = threadIdx.x; idx < T * dz; idx += blockDim.x) {
      const int t = idx / dz, k = idx % dz;
      DY[t * zp + k] = cnf::gate(KY[t * zp + k], c.act[n - 1]);
    }
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      float ysq = 0.f;
      for (int k = 0; k < dz; ++k) ysq = fmaf(KY[t * zp + k], KY[t * zp + k], ysq);
      acc[t * 3 + 0] = ysq;
      acc[t * 3 + 1] = 0.f;
      acc[t * 3 + 2] = 0.f;
    }
    __syncthreads();

    const float* d1 = cnf::level(c, HB, T, 1);
    const float* w0 = cnf::layer_w(c, params, 0);  // (dz + nc, H1) row-major: the z rows first
    const float* wl = cnf::layer_w(c, params, n - 1);
    const int h1 = c.width[1], hp1 = c.hp[1], wlast = c.width[n - 1];
    const int rows = T * dz;
    for (int r0 = 0; r0 < rows; r0 += R) {
      // Row r of the chunk: basis row gr = r0 + r, sample t = gr / dz,
      // column j = gr % dz (rows past the tile's are zero).
      for (int idx = threadIdx.x; idx < R * h1; idx += blockDim.x) {
        const int r = idx / h1, o = idx % h1, gr = r0 + r;
        ta[r * bp + o] = gr < rows ? d1[(gr / dz) * hp1 + o] * __ldg(w0 + (size_t)(gr % dz) * h1 + o) : 0.f;
      }
      __syncthreads();
      float* cur = ta;
      float* nxt = tb;
      for (int i = 1; i < n - 1; ++i) {
        const float* d = cnf::level(c, HB, T, i + 1);
        const int hp = c.hp[i + 1];
        float* dst = nxt;
        cnf::stream_mm(cur, bp, c.width[i], cnf::layer_w(c, params, i), nullptr, c.width[i + 1], R, wc,
                       [&](int r, int o, float a) {
                         const int t = min((r0 + r) / dz, T - 1);
                         dst[r * bp + o] = a * d[t * hp + o];
                       });
        nxt = cur;
        cur = dst;
      }
      float* dst = nxt;
      if constexpr (NACC == 1) {
        // TEST: the diagonal entry alone is kept.
        cnf::stream_mm(cur, bp, wlast, wl, nullptr, dz, R, wc, [&](int r, int o, float a) {
          if (o == (r0 + r) % dz) rowtr[r] = a * DY[min((r0 + r) / dz, T - 1) * zp + o];
        });
      } else {
        cnf::stream_mm(cur, bp, wlast, wl, nullptr, dz, R, wc, [&](int r, int o, float a) {
          const int t = min((r0 + r) / dz, T - 1);
          dst[r * bp + o] = a * DY[t * zp + o];
        });
        for (int r = threadIdx.x; r < R; r += blockDim.x) {
          float f = 0.f;
          for (int o = 0; o < dz; ++o) f = fmaf(dst[r * bp + o], dst[r * bp + o], f);
          rowtr[r] = dst[r * bp + (r0 + r) % dz];
          rowf2[r] = f;
        }
      }
      __syncthreads();
      // Each sample's rows of the chunk, in row order.
      for (int t = threadIdx.x; t < T; t += blockDim.x) {
        const int lo = max(r0, t * dz), hi = min(r0 + R, (t + 1) * dz);
        for (int gr = lo; gr < hi; ++gr) {
          acc[t * 3 + 1] += rowtr[gr - r0];
          if (NACC == 3) acc[t * 3 + 2] += rowf2[gr - r0];
        }
      }
      __syncthreads();
    }
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      KR[t * NACC] = -acc[t * 3 + 1];
      if constexpr (NACC == 3) {
        KR[t * 3 + 1] = norm_z ? safe_norm_sq(acc[t * 3]) : 0.f;
        KR[t * 3 + 2] = norm_j ? safe_norm_sq(acc[t * 3 + 2]) : 0.f;
      }
    }
    __syncthreads();
  }
};

template <int NACC>
__global__ void __launch_bounds__(kStreamBlock) k7_stream_solve(const Args p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ StreamLayout L;
  cnf::share_layout(p.L, &L);
  const int T = kTileSamples, R = p.R, bp = basis_pitch(L);
  float* wc = smem;
  float* red = wc + cnf::kChunkFloats;
  float* scratch = p.tiles ? p.tiles + (size_t)blockIdx.x * region_floats<NACC>(L, R) : red + kRedFloats;
  float* HB = scratch + T * (2 * L.zp + NACC);  // after the solver's Z, KY, KR
  float* DY = HB + (size_t)T * L.hsum;
  float* acc = DY + T * L.zp;
  float* ta = acc + 3 * T;
  float* tb = ta + (size_t)R * bp;
  float* rowtr = tb + (size_t)R * bp;
  float* rowf2 = rowtr + R;
  const StreamExactField<NACC, false> field{{}, &L, p.params, HB, DY, acc, ta, tb, rowtr, rowf2, wc, R, p.f.norm_z,
                                            p.f.norm_j};
  cnf::forward_solve_tiles<NACC, kStageUnroll>(p.f, field, T, scratch, red);
}

// The COND instances' arguments: the unconditional instances' and the
// conditioning ys (B, nc).
struct CondArgs {
  Args a;
  const float* ys;
};

// The COND instances' tile arrays: the unconditional instances' and the
// tile's ys rows (T, nc), in shared memory or in the block's slice of the
// global scratch alike.
template <int NACC, bool COND>
__host__ __device__ inline size_t tile_region_floats(const StreamLayout& L, int R) {
  return region_floats<NACC>(L, R) + (COND ? (size_t)kTileSamples * cnf::stream_nc(L) : 0);
}

template <int NACC>
__global__ void __launch_bounds__(kStreamBlock) k7_stream_cond_solve(const __grid_constant__ CondArgs ca) {
  extern __shared__ __align__(16) float smem[];
  __shared__ StreamLayout L;
  const Args& p = ca.a;
  cnf::share_layout(p.L, &L);
  const int T = kTileSamples, R = p.R, bp = basis_pitch(L);
  float* wc = smem;
  float* red = wc + cnf::kChunkFloats;
  float* scratch =
      p.tiles ? p.tiles + (size_t)blockIdx.x * tile_region_floats<NACC, true>(L, R) : red + kRedFloats;
  float* HB = scratch + T * (2 * L.zp + NACC);  // after the solver's Z, KY, KR
  float* DY = HB + (size_t)T * L.hsum;
  float* acc = DY + T * L.zp;
  float* ta = acc + 3 * T;
  float* tb = ta + (size_t)R * bp;
  float* rowtr = tb + (size_t)R * bp;
  float* rowf2 = rowtr + R;
  float* YS = rowf2 + R;  // the tile's ys rows (T, nc)
  const StreamExactField<NACC, true> field{{ca.ys, YS}, &L, p.params, HB, DY, acc, ta, tb, rowtr, rowf2, wc, R,
                                           p.f.norm_z, p.f.norm_j};
  cnf::forward_solve_tiles<NACC, kStageUnroll>(p.f, field, T, scratch, red);
}

template <int NACC, bool COND>
size_t smem_bytes(const StreamLayout& L, int R, bool global_tiles) {
  return sizeof(float) *
         ((size_t)cnf::kChunkFloats + kRedFloats + (global_tiles ? 0 : tile_region_floats<NACC, COND>(L, R)));
}

// The launch shape of an entry (the COND instance's with `COND`).
template <int NACC, bool COND>
int shape(int n, const int* widths, int B, int* out) {
  StreamLayout L;
  if (B < 1 || !cnf::make_stream_layout(n, widths, &L, COND)) return (int)cudaErrorInvalidValue;
  size_t region[4];
  for (int o = 0; o < 4; ++o) region[o] = tile_region_floats<NACC, COND>(L, kChunks[o]);
  if constexpr (COND) return cnf::stream_shape(k7_stream_cond_solve<NACC>, region, kSamples, kChunks, 4, B, out);
  return cnf::stream_shape(k7_stream_solve<NACC>, region, kSamples, kChunks, 4, B, out);
}

// Launch an entry (the COND instance with `COND`, which takes ys).
template <int NACC, bool COND>
int solve(const float* params, const float* ys, const float* z0, const float* acc0, const float* ts, float* zT,
          float* accT, int* stats, float* dt_last, float* work, float* partials, float* tiles, int B, int n,
          const int* widths, int acts, int max_steps, int norm_z, int norm_j, float rtol, float atol, float beta1,
          float beta2, float inv_order, const float* tab, int R, int grid, int block, void* stream) {
  CondArgs ca = {};
  Args& a = ca.a;
  if (block != kStreamBlock || grid < 1 || R < 4 || R % 4 != 0 || (COND && ys == nullptr) ||
      !cnf::make_stream_layout(n, widths, &a.L, COND))
    return (int)cudaErrorInvalidValue;
  cnf::set_stream_acts(&a.L, acts);
  cnf::set_fwd_args(&a.f, nullptr, z0, acc0, ts, zT, accT, stats, dt_last, work, partials, B, widths[n], max_steps,
                    norm_z, norm_j, rtol, atol, beta1, beta2, inv_order, tab);
  a.params = params;
  a.tiles = tiles;
  a.R = R;
  ca.ys = ys;
  const size_t smem = smem_bytes<NACC, COND>(a.L, R, tiles != nullptr);
  if constexpr (COND)
    return (int)cnf::coop_launch(k7_stream_cond_solve<NACC>, ca, grid, block, smem, (cudaStream_t)stream);
  return (int)cnf::coop_launch(k7_stream_solve<NACC>, a, grid, block, smem, (cudaStream_t)stream);
}

}  // namespace

// The launch shape of the TEST or the exact entry at batch B: out =
// {threads per block, blocks, basis rows a chunk, dynamic shared memory
// bytes, floats of global tile scratch a block (0: shared memory)} (tiles
// of 4 samples).  widths: n + 1 level widths (host memory).  Returns a
// cudaError_t (cudaErrorInvalidValue for a chain not covered).
extern "C" int cnf_k7s_test_shape(int n, const int* widths, int B, int* out) {
  return shape<1, false>(n, widths, B, out);
}

extern "C" int cnf_k7s_exact_shape(int n, const int* widths, int B, int* out) {
  return shape<3, false>(n, widths, B, out);
}

// TEST: params [W0 | b0 | ...] flat (device), acts: bit i set where layer i
// is tanh (else identity), z0 (B, dz), dlogp0/dlogpT (B), dt_last (2): the
// next step size and the last step taken; work: (S + 2) (dz + 1) B floats;
// partials: 6 grid; tiles: grid x out[4] floats of the shape entry, or null
// when out[4] is 0.  tab: kTableauFloats floats (read_tableau).  R, grid,
// block: from cnf_k7s_test_shape.  Returns the launch's cudaError_t.
extern "C" int cnf_k7s_test_solve(const float* params, const float* z0, const float* dlogp0, const float* ts,
                                  float* zT, float* dlogpT, int* stats, float* dt_last, float* work, float* partials,
                                  float* tiles, int B, int n, const int* widths, int acts, int max_steps, float rtol,
                                  float atol, float beta1, float beta2, float inv_order, const float* tab, int R,
                                  int grid, int block, void* stream) {
  return solve<1, false>(params, nullptr, z0, dlogp0, ts, zT, dlogpT, stats, dt_last, work, partials, tiles, B, n,
                         widths, acts, max_steps, 0, 0, rtol, atol, beta1, beta2, inv_order, tab, R, grid, block,
                         stream);
}

// Exact TRAIN: acc0/accT (3, B), rows [dlogp | reg_e | reg_n]; work:
// (S + 2) (dz + 3) B floats.  Returns the launch's cudaError_t.
extern "C" int cnf_k7s_exact_solve(const float* params, const float* z0, const float* acc0, const float* ts,
                                   float* zT, float* accT, int* stats, float* dt_last, float* work, float* partials,
                                   float* tiles, int B, int n, const int* widths, int acts, int max_steps, int norm_z,
                                   int norm_j, float rtol, float atol, float beta1, float beta2, float inv_order,
                                   const float* tab, int R, int grid, int block, void* stream) {
  return solve<3, false>(params, nullptr, z0, acc0, ts, zT, accT, stats, dt_last, work, partials, tiles, B, n, widths,
                         acts, max_steps, norm_z, norm_j, rtol, atol, beta1, beta2, inv_order, tab, R, grid, block,
                         stream);
}

// The COND instances' launch shapes (K8), as cnf_k7s_test_shape and
// cnf_k7s_exact_shape; widths[0] = dz + nc with nc >= 1, out[4] counting
// the tile's ys rows.
extern "C" int cnf_k7sc_test_shape(int n, const int* widths, int B, int* out) {
  return shape<1, true>(n, widths, B, out);
}

extern "C" int cnf_k7sc_exact_shape(int n, const int* widths, int B, int* out) {
  return shape<3, true>(n, widths, B, out);
}

// The COND instances (K8): as cnf_k7s_test_solve and cnf_k7s_exact_solve for
// a conditional chain, with ys (B, nc) (device) after params, nc =
// widths[0] - widths[n] >= 1; R, grid, block and the tile scratch from
// cnf_k7sc_test_shape or cnf_k7sc_exact_shape.
extern "C" int cnf_k7s_cond_test_solve(const float* params, const float* ys, const float* z0, const float* dlogp0,
                                       const float* ts, float* zT, float* dlogpT, int* stats, float* dt_last,
                                       float* work, float* partials, float* tiles, int B, int n, const int* widths,
                                       int acts, int max_steps, float rtol, float atol, float beta1, float beta2,
                                       float inv_order, const float* tab, int R, int grid, int block, void* stream) {
  return solve<1, true>(params, ys, z0, dlogp0, ts, zT, dlogpT, stats, dt_last, work, partials, tiles, B, n, widths,
                        acts, max_steps, 0, 0, rtol, atol, beta1, beta2, inv_order, tab, R, grid, block, stream);
}

extern "C" int cnf_k7s_cond_exact_solve(const float* params, const float* ys, const float* z0, const float* acc0,
                                        const float* ts, float* zT, float* accT, int* stats, float* dt_last,
                                        float* work, float* partials, float* tiles, int B, int n, const int* widths,
                                        int acts, int max_steps, int norm_z, int norm_j, float rtol, float atol,
                                        float beta1, float beta2, float inv_order, const float* tab, int R, int grid,
                                        int block, void* stream) {
  return solve<3, true>(params, ys, z0, acc0, ts, zT, accT, stats, dt_last, work, partials, tiles, B, n, widths, acts,
                        max_steps, norm_z, norm_j, rtol, atol, beta1, beta2, inv_order, tab, R, grid, block, stream);
}
