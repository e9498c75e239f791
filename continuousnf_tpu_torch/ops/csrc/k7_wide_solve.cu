// Wide K7: the forward solves of a CNF whose field is an unconditional Dense
// chain of 2 to 8 tanh or identity layers with state width up to 64 and
// hidden widths up to 128 (the tabular MINIBOONE model 43 -> 128 -> 128 ->
// 43), the exact trace by basis propagation, the whole adaptive solve (any
// embedded explicit tableau, K9) in one cooperative launch.  Two entries:
//   * TEST: the state [z | dlogp], rate -tr J (one accumulator row);
//   * exact TRAIN: [z | dlogp | reg_e | reg_n], rates -tr J, ||y|| (norm_z)
//     and ||J||_F (norm_j).
//
// Replaces, at these widths, the TPU kernel continuousnf_tpu/ops/fused_solve.py::
// _run_solve_kernel (pl.pallas_call at :1043) built by _make_solve_kernel
// (:773-942) with _stage_test -> _stage_exact_chain (:484-493, :678-719;
// want_fro=False) and with _stage_train_exact_chain (:722-728).  As in the
// JAX package these are forward-only: a deep exact chain's gradient runs the
// plain BACKSOLVE.
//
// Per sample and field evaluation: the forward pass, each hidden level's
// activation h replaced by its gate d (1 - h^2 for tanh, 1 for identity),
// then for each basis column j < dz one column of J pushed through the
// linearised layers:
//   t_1 = d_1 (.) W_0[j, :],  t_(l+1) = d_(l+1) (.) (t_l W_l),
//   t_N = dy (.) (t_(N-1) W_(N-1)),
// tr += t_N[j] and, exact, ||J||_F^2 += |t_N|^2.  TEST computes only the
// diagonal entry t_N[j] of the last product; exact the whole row.
//
// Design: the basis block of one sample is dz rows of the widest hidden
// width (43 x 128 at MINIBOONE, 22 KB); a tile of T = 4 samples has
// T dz = 172 basis rows (t, j), pushed in chunks of R = 64 rows (or 32, 16, 8
// where the shared memory asks for it) through the tile products of
// chain_wide.cuh, the middle layers as (R x H) . (H x H) products.  Taking a
// few samples a tile and a chunk of their basis rows, and not one sample a
// tile or the basis block in global memory, keeps the whole push in shared
// memory with every product R rows deep (8 rows a thread), and leaves the
// forward pass (1/27 of the work) T rows deep.  Shared memory at
// MINIBOONE: the weights 27,862 floats; per tile row the solver's z, y (2 x
// 44) and rates, dy (44), the gates (a hidden block, 256) and 3 sums; two
// basis chunks R x 132 and two R-float row sums: 17,024 floats at R = 64;
// 186 KB in all.  B = 2048 gives 512 tiles for 132 blocks.
// What bounds it on the H100: operations.  A TEST evaluation is about 0.74 M
// FMA per sample at MINIBOONE, an exact one 0.97 M (the dz columns of the
// push); a stage at B = 2048 is 3.0 (4.0) GFLOP, 45 (59) us at the card's f32
// rate.  The tile products read 8 weights and 8 float4 input broadcasts per
// 64 FMA from shared memory: shared-memory issue and latency bound them.
// Precision: f32 FMA on the CUDA cores, no TF32 and no tensor cores.
//
// The COND instances (K8 in wide K7): the TEST and exact entries for a
// conditional chain, whose first layer reads [z | ys] (_stage_exact_chain
// and _stage_train_exact_chain with _zin :265; the basis push reads W0's z
// rows only, :701).  The ys values (B, nc) are constant over the solve: at
// each evaluation the block reads its tile's rows into a (T, nc) array and
// the forward adds layer 0's ys rows (kept after its z rows) to the
// pre-activation (wide_forward_cond); the basis push is the unconditional
// one, the Jacobian being in z.  At cond_hepmass42 (43 -> 126 -> 42, one ys
// column) that is 126 more FMA a sample and evaluation beside the exact
// push's 222 k; at the 3-layer chain 44 -> 128 -> 128 -> 43, 128 beside
// TEST's 0.74 M.  Their launch shapes and entries are cnf_k7wc_test_shape,
// cnf_k7wc_exact_shape, cnf_k7w_cond_test_solve and cnf_k7w_cond_exact_solve.

#include "chain_wide.cuh"

namespace {

constexpr int kStageUnroll = 1;
constexpr int kTileSamples = 4;
constexpr int kChunks[] = {64, 32, 16, 8};
constexpr int kSamples[] = {kTileSamples, kTileSamples, kTileSamples, kTileSamples};

using cnf::kRedFloats;
using cnf::kWideBlock;
using cnf::safe_norm_sq;
using cnf::WideLayout;

struct Args {
  cnf::FwdArgs f;
  WideLayout L;
  const float* params;  // [W0 | b0 | W1 | b1 | ...]
  int R;                // basis rows a chunk
};

// The basis rows' pitch: the widest level rounded up to 4, plus 4, so that
// TEST's diagonal loop (a thread per row) spreads its rows over 8 banks.
__host__ __device__ inline int basis_pitch(const WideLayout& L) {
  return cnf::round_up(L.hmax > L.dz ? L.hmax : L.dz, 4) + 4;
}

template <int NACC>
__host__ __device__ inline size_t tile_floats(const WideLayout& L, int R) {
  const int T = kTileSamples;
  return (size_t)T * (2 * L.zp + NACC) + (size_t)T * (L.hsum + L.zp + 3) + 2 * (size_t)R * basis_pitch(L) + 2 * R;
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

// The exact field of a tile: KY = y; KR = [-tr] (NACC = 1) or
// [-tr, ||y||, ||J||_F] (NACC = 3) per row.
template <int NACC, bool COND>
struct WideExactField : CondRows<COND> {
  const WideLayout* L;
  const float* w;  // the shared weight region
  float* HB;       // the tile's hidden block: activations, then gates
  float* DY;       // (T, zp): the output gate
  float* acc;      // (T, 3): ysq, tr, fro2
  float* ta;       // (R, bp) basis chunks
  float* tb;
  float* rowtr;    // (R): a chunk row's diagonal entry
  float* rowf2;    // (R): its squared norm
  int R, norm_z, norm_j;

  __device__ void operator()([[maybe_unused]] int s0, [[maybe_unused]] int nv, const float* Z, float* KY,
                             float* KR) const {
    const WideLayout& c = *L;
    const int n = c.n, dz = c.dz, zp = c.zp, T = kTileSamples, bp = basis_pitch(c);
    if constexpr (COND) {
      cnf::load_tile_cond(this->ys, cnf::wide_nc(c), s0, nv, T, this->YS);
      cnf::wide_forward_cond(c, w, Z, this->YS, T, HB, KY);
    } else {
      cnf::wide_forward(c, w, Z, T, HB, KY);
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
    const float* w0 = w + c.wofs[0];
    const float* wl = w + c.wofs[n - 1];
    const int h1 = c.width[1], hp1 = c.hp[1], p0 = c.pitch[0], pl = c.pitch[n - 1], wlast = c.width[n - 1];
    const int rows = T * dz;
    for (int r0 = 0; r0 < rows; r0 += R) {
      // Row r of the chunk: basis row gr = r0 + r, sample t = gr / dz,
      // column j = gr % dz (rows past the tile's are zero).
      for (int idx = threadIdx.x; idx < R * h1; idx += blockDim.x) {
        const int r = idx / h1, o = idx % h1, gr = r0 + r;
        ta[r * bp + o] = gr < rows ? d1[(gr / dz) * hp1 + o] * w0[(gr % dz) * p0 + o] : 0.f;
      }
      __syncthreads();
      float* cur = ta;
      float* nxt = tb;
      for (int i = 1; i < n - 1; ++i) {
        const float* d = cnf::level(c, HB, T, i + 1);
        const int hp = c.hp[i + 1];
        float* dst = nxt;
        cnf::tile_mm(cur, bp, c.width[i], w + c.wofs[i], c.pitch[i], nullptr, c.width[i + 1], R,
                     [&](int r, int o, float a) {
                       const int t = min((r0 + r) / dz, T - 1);
                       dst[r * bp + o] = a * d[t * hp + o];
                     });
        nxt = cur;
        cur = dst;
      }
      if constexpr (NACC == 1) {
        // TEST: the diagonal entry alone.
        for (int r = threadIdx.x; r < R; r += blockDim.x) {
          const int gr = r0 + r;
          if (gr >= rows) continue;
          const int t = gr / dz, j = gr % dz;
          float a = 0.f;
          for (int k = 0; k < wlast; ++k) a = fmaf(cur[r * bp + k], wl[k * pl + j], a);
          rowtr[r] = a * DY[t * zp + j];
        }
      } else {
        float* dst = nxt;
        cnf::tile_mm(cur, bp, wlast, wl, pl, nullptr, dz, R, [&](int r, int o, float a) {
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
__global__ void __launch_bounds__(kWideBlock) k7_wide_solve(const Args p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ WideLayout L;
  cnf::share_layout(p.L, &L);
  const int T = kTileSamples, R = p.R, bp = basis_pitch(L);
  float* w = smem;
  float* red = w + L.wfloats;
  float* scratch = red + kRedFloats;  // the solver's Z, KY, KR
  float* HB = scratch + T * (2 * L.zp + NACC);
  float* DY = HB + T * L.hsum;
  float* acc = DY + T * L.zp;
  float* ta = acc + 3 * T;
  float* tb = ta + R * bp;
  float* rowtr = tb + R * bp;
  float* rowf2 = rowtr + R;
  cnf::load_wide_weights(p.params, L, w);
  __syncthreads();
  const WideExactField<NACC, false> field{{}, &L, w, HB, DY, acc, ta, tb, rowtr, rowf2, R, p.f.norm_z, p.f.norm_j};
  cnf::forward_solve_tiles<NACC, kStageUnroll>(p.f, field, T, scratch, red);
}

// Dynamic shared memory: the weights, the reduction slots, the tile arrays
// and, in a COND instance, the tile's ys rows (T, nc).
template <int NACC>
size_t smem_bytes(const WideLayout& L, int R) {
  return sizeof(float) * ((size_t)L.wfloats + kRedFloats + tile_floats<NACC>(L, R) + kTileSamples * cnf::wide_nc(L));
}

// The COND instances' arguments: the unconditional instances' and the
// conditioning ys (B, nc).
struct CondArgs {
  Args a;
  const float* ys;
};

template <int NACC>
__global__ void __launch_bounds__(kWideBlock) k7_wide_cond_solve(const __grid_constant__ CondArgs ca) {
  extern __shared__ __align__(16) float smem[];
  __shared__ WideLayout L;
  const Args& p = ca.a;
  cnf::share_layout(p.L, &L);
  const int T = kTileSamples, R = p.R, bp = basis_pitch(L);
  float* w = smem;
  float* red = w + L.wfloats;
  float* scratch = red + kRedFloats;  // the solver's Z, KY, KR
  float* HB = scratch + T * (2 * L.zp + NACC);
  float* DY = HB + T * L.hsum;
  float* acc = DY + T * L.zp;
  float* ta = acc + 3 * T;
  float* tb = ta + R * bp;
  float* rowtr = tb + R * bp;
  float* rowf2 = rowtr + R;
  float* YS = rowf2 + R;  // the tile's ys rows (T, nc)
  cnf::load_wide_weights(p.params, L, w);
  __syncthreads();
  const WideExactField<NACC, true> field{{ca.ys, YS}, &L, w, HB, DY, acc, ta, tb, rowtr, rowf2, R, p.f.norm_z,
                                         p.f.norm_j};
  cnf::forward_solve_tiles<NACC, kStageUnroll>(p.f, field, T, scratch, red);
}

// The launch shape of an entry (the COND instance's with `COND`).
template <int NACC, bool COND>
int shape(int n, const int* widths, int B, int* out) {
  WideLayout L;
  if (B < 1 || !cnf::make_wide_layout(n, widths, &L, COND)) return (int)cudaErrorInvalidValue;
  size_t smem[4];
  for (int o = 0; o < 4; ++o) smem[o] = smem_bytes<NACC>(L, kChunks[o]);
  if constexpr (COND) return cnf::wide_shape(k7_wide_cond_solve<NACC>, smem, kSamples, kChunks, 4, B, out);
  return cnf::wide_shape(k7_wide_solve<NACC>, smem, kSamples, kChunks, 4, B, out);
}

// Launch an entry (the COND instance with `COND`, which takes ys).
template <int NACC, bool COND>
int solve(const float* params, const float* ys, const float* z0, const float* acc0, const float* ts, float* zT,
          float* accT, int* stats, float* dt_last, float* work, float* partials, int B, int n, const int* widths,
          int acts, int max_steps, int norm_z, int norm_j, float rtol, float atol, float beta1, float beta2,
          float inv_order, const float* tab, int R, int grid, int block, void* stream) {
  CondArgs ca = {};
  Args& a = ca.a;
  if (block != kWideBlock || grid < 1 || R < cnf::kRows || R % cnf::kRows != 0 || (COND && ys == nullptr) ||
      !cnf::make_wide_layout(n, widths, &a.L, COND))
    return (int)cudaErrorInvalidValue;
  cnf::set_wide_acts(&a.L, acts);
  cnf::set_fwd_args(&a.f, nullptr, z0, acc0, ts, zT, accT, stats, dt_last, work, partials, B, widths[n], max_steps,
                    norm_z, norm_j, rtol, atol, beta1, beta2, inv_order, tab);
  a.params = params;
  a.R = R;
  ca.ys = ys;
  if constexpr (COND)
    return (int)cnf::coop_launch(k7_wide_cond_solve<NACC>, ca, grid, block, smem_bytes<NACC>(a.L, R),
                                 (cudaStream_t)stream);
  return (int)cnf::coop_launch(k7_wide_solve<NACC>, a, grid, block, smem_bytes<NACC>(a.L, R), (cudaStream_t)stream);
}

}  // namespace

// The launch shape of the TEST or the exact entry at batch B: out =
// {threads per block, blocks, basis rows a chunk, dynamic shared memory
// bytes} (tiles of 4 samples).  widths: n + 1 level widths (host memory).
// Returns a cudaError_t (cudaErrorInvalidValue for a chain not covered).
extern "C" int cnf_k7w_test_shape(int n, const int* widths, int B, int* out) {
  return shape<1, false>(n, widths, B, out);
}

extern "C" int cnf_k7w_exact_shape(int n, const int* widths, int B, int* out) {
  return shape<3, false>(n, widths, B, out);
}

// TEST: params [W0 | b0 | ...] flat (device), acts: bit i set where layer i
// is tanh (else identity), z0 (B, dz), dlogp0/dlogpT (B), dt_last (2): the
// next step size and the last step taken; work: (S + 2) (dz + 1) B floats;
// partials: 6 grid.  tab: kTableauFloats floats (read_tableau).  R, grid,
// block: from cnf_k7w_test_shape.  Returns the launch's cudaError_t.
extern "C" int cnf_k7w_test_solve(const float* params, const float* z0, const float* dlogp0, const float* ts,
                                  float* zT, float* dlogpT, int* stats, float* dt_last, float* work, float* partials,
                                  int B, int n, const int* widths, int acts, int max_steps, float rtol, float atol,
                                  float beta1, float beta2, float inv_order, const float* tab, int R, int grid,
                                  int block, void* stream) {
  return solve<1, false>(params, nullptr, z0, dlogp0, ts, zT, dlogpT, stats, dt_last, work, partials, B, n, widths,
                         acts, max_steps, 0, 0, rtol, atol, beta1, beta2, inv_order, tab, R, grid, block, stream);
}

// Exact TRAIN: acc0/accT (3, B), rows [dlogp | reg_e | reg_n]; work:
// (S + 2) (dz + 3) B floats.  Returns the launch's cudaError_t.
extern "C" int cnf_k7w_exact_solve(const float* params, const float* z0, const float* acc0, const float* ts,
                                   float* zT, float* accT, int* stats, float* dt_last, float* work, float* partials,
                                   int B, int n, const int* widths, int acts, int max_steps, int norm_z, int norm_j,
                                   float rtol, float atol, float beta1, float beta2, float inv_order,
                                   const float* tab, int R, int grid, int block, void* stream) {
  return solve<3, false>(params, nullptr, z0, acc0, ts, zT, accT, stats, dt_last, work, partials, B, n, widths, acts,
                         max_steps, norm_z, norm_j, rtol, atol, beta1, beta2, inv_order, tab, R, grid, block, stream);
}

// The COND instances' launch shapes (K8), as cnf_k7w_test_shape and
// cnf_k7w_exact_shape; widths[0] = dz + nc with nc >= 1.
extern "C" int cnf_k7wc_test_shape(int n, const int* widths, int B, int* out) {
  return shape<1, true>(n, widths, B, out);
}

extern "C" int cnf_k7wc_exact_shape(int n, const int* widths, int B, int* out) {
  return shape<3, true>(n, widths, B, out);
}

// The COND instances (K8): as cnf_k7w_test_solve and cnf_k7w_exact_solve for
// a conditional chain, with ys (B, nc) (device), nc = widths[0] - widths[n]
// >= 1; R, grid, block from cnf_k7wc_test_shape or cnf_k7wc_exact_shape.
extern "C" int cnf_k7w_cond_test_solve(const float* params, const float* ys, const float* z0, const float* dlogp0,
                                       const float* ts, float* zT, float* dlogpT, int* stats, float* dt_last,
                                       float* work, float* partials, int B, int n, const int* widths, int acts,
                                       int max_steps, float rtol, float atol, float beta1, float beta2,
                                       float inv_order, const float* tab, int R, int grid, int block, void* stream) {
  return solve<1, true>(params, ys, z0, dlogp0, ts, zT, dlogpT, stats, dt_last, work, partials, B, n, widths, acts,
                        max_steps, 0, 0, rtol, atol, beta1, beta2, inv_order, tab, R, grid, block, stream);
}

extern "C" int cnf_k7w_cond_exact_solve(const float* params, const float* ys, const float* z0, const float* acc0,
                                        const float* ts, float* zT, float* accT, int* stats, float* dt_last,
                                        float* work, float* partials, int B, int n, const int* widths, int acts,
                                        int max_steps, int norm_z, int norm_j, float rtol, float atol, float beta1,
                                        float beta2, float inv_order, const float* tab, int R, int grid, int block,
                                        void* stream) {
  return solve<3, true>(params, ys, z0, acc0, ts, zT, accT, stats, dt_last, work, partials, B, n, widths, acts,
                        max_steps, norm_z, norm_j, rtol, atol, beta1, beta2, inv_order, tab, R, grid, block, stream);
}
