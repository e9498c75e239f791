// The wide K4 adjoint: the continuous-adjoint (backsolve) backward
// integration of an exact-trace TRAIN-mode CNF whose field is an
// unconditional 2-layer tanh MLP with state width up to 64 and hidden width
// up to 128 (the README net family at the HEPMASS width, 42 -> 126 -> 42),
// the whole adaptive solve (any embedded explicit tableau, K9) from t_hi
// down to t_lo in one cooperative launch.
//
// Replaces, at these widths, the TPU kernel built by continuousnf_tpu/ops/
// fused_solve.py::_make_adjoint_kernel (:1064-1343), launched by
// make_full_solve.adjoint_solve (pl.pallas_call at :1767), with the
// _stage_train_exact_fwdbwd stage (:618-675) and the pm chaining of
// :1787-1799.  The state is, per sample, z (dz), acc (3: dlogp, reg_e,
// reg_n), a_z (dz) and the constant a_acc (3), plus the batch-summed
// gradient g = [W1 (dz, H) | b1 | W2 (H, dz) | b2 | g_pm (dz^2, H)] of
// P_total = P + dz^2 H floats (233,184 at HEPMASS).  g_pm is the cotangent of
// pm[(j, i), h] = W1[j, h] W2[h, i] (j-major rows); the wrapper chains it
// back into g_W1 and g_W2 after the solve, as the TPU path does.  g_pm stays
// in the state and in the error norm: the single-tile numerics of the K4
// adjoint (k4_exact_adjoint.cu), whose thread-per-sample form keeps a
// sample's state in registers at a padded width of at most 32.
//
// Per sample and stage (_stage_train_exact_fwdbwd for one sample):
//   forward:  h, dh = 1 - h^2, y, dy = 1 - y^2; the rows of
//             m[j, i] = sum_h W1[j, h] dh_h W2[h, i] (dz rows of a basis
//             push: (dh (.) W1[j, :]) W2); d_i = m[i, i], s_i = sum_j m[j, i]^2,
//             tr = sum_i dy_i d_i, fro^2 = sum_i dy_i^2 s_i;
//   backward: ct_tr = -a_acc[0], ct_fro2 = a_acc[2] / (2 n); ct_m[j, i] =
//             [i = j] dy_i ct_tr + 2 dy_i^2 ct_fro2 m[j, i]; ct_dh[h] =
//             sum_j W1[j, h] sum_i W2[h, i] ct_m[j, i]; ct_dy = d ct_tr +
//             2 dy s ct_fro2; ct_pre2 = (a_z - 2 y ct_dy + y fz) dy;
//             ct_pre1 = (W2 ct_pre2 - 2 h ct_dh) dh; k_az = -W1 ct_pre1;
//   gradient: W1 gets z (x) ct_pre1, W2 h (x) ct_pre2, the biases ct_pre1
//             and ct_pre2, g_pm ct_m[j, i] dh_h.
//
// Controller: adjoint_solve_tiles of solve_common.cuh.  The K4 adjoint's
// every-block read of all blocks' partials after the barrier would be
// G NG P_total floats a block per attempted step (59.7 MB at 32 blocks,
// 7.6 GB a step across 128 blocks), far past the 50 MB L2.  The tile
// solve's slice reduction scales instead: after the first grid barrier
// block b sums its 1/G slice of every block's vectors in block order into
// the global g, a second barrier shares the slices' error sums, and every
// entry is still summed once in one fixed order, so every block takes
// bitwise the same decisions; a block reads NG P_total floats a step.
//
// Memory plan.  Shared memory: the weights (10,920 floats at HEPMASS); per
// tile row the solver's z, a_z, k_z (= y), k_az (4 x 44) and rates (3),
// h, dh and ct_dh then ct_pre1 (3 x 128), dy, ct_pre2, d then ct_d, s then
// ct_s (4 x 44) and four scalars: 743 floats, 23,776 at T = 32; two chunks
// of R basis rows (R = 64: 16,384 floats); 204,720 bytes in all.  Global:
// m and then ct_m of the block's tile (T dz^2 floats a block: (dz^2, B),
// 28.9 MB at B = 4096, as the K4 adjoint keeps it), each block's GB, GE
// (and GE3), stage-1 and last-stage partials ((NG + 2) P_total floats a
// block: 477 MB at 128 blocks under tsit5), g and its proposal.
//
// What bounds it on the H100: a stage is about 3 dz^2 H + 6 dz H FMA a
// sample (the m rows, the ct_m push, the g_pm product: 699 k at HEPMASS),
// 5.7 GFLOP at B = 4096, 85 us at the card's f32 rate.  Per tile and stage
// the block rereads and rewrites its GB and GE vectors (2 P_total floats
// each way, 3.7 MB): 2.9 GB an attempted step at B = 4096.  Measured by
// parts (utils/wide_k4_parts.py, PERF.md), the g_pm gradient sums, the two
// basis-row passes and that rewrite take comparable shares of a step that
// runs at 20x the FMA bound.
// Precision: f32 FMA on the CUDA cores, no TF32 and no tensor cores.
//
// The COND instance (K8 in the wide K4 adjoint): _stage_train_exact_fwdbwd
// of a conditional 2-layer net, whose W1 reads [z | ys] (:618-675 with
// _zin :265).  The forward adds W1's ys rows to the pre-activation of h
// (two_layer_forward_cond, from the tile's (T, nc) ys rows, read from global
// memory at each evaluation); the m rows, ct_m and g_pm read W1's z rows
// only (pm is built from them), so the ys rows of W1's gradient are
// ys (x) ct_pre1 alone, and after the solve g_pm chains into W1's z rows
// (its ys rows get zeros, :1787-1799).  Each sample's a_ys integrates
// k_ays = -(W1's ys rows ct_pre1) (wide_ys_cotangent) in the tile solve's
// COND form (adjoint_solve_tiles): from 0 at t_hi, combined like a_z,
// inside the one batch-global norm, a_ys0 (B, nc) returned.  At
// cond_hepmass42 (43 -> 126 -> 42, one ys column) that is 3 x 126 FMA a
// sample and evaluation beside the stage's 699 k; the tile's ys rows and
// k_ays take 2 nc floats a row more (205,488 bytes of shared memory at
// T = 32, R = 64).  Its launch shape and entry are cnf_k4wc_shape and
// cnf_k4w_cond_exact_adjoint.

#include "two_layer_wide.cuh"

namespace {

constexpr int kStageUnroll = 4;
// (samples a tile, basis rows a chunk), largest first.
constexpr int kOptions = 5;
constexpr int kTiles[kOptions] = {32, 32, 16, 8, 4};
constexpr int kChunks[kOptions] = {64, 32, 32, 16, 8};

using cnf::ct_safe_norm;
using cnf::kRedFloats;
using cnf::kWideBlock;
using cnf::safe_norm_sq;
using cnf::WideLayout;

struct AdjArgs {
  cnf::AdjState s;
  WideLayout L;
  const float* params;  // [W1 | b1 | W2 | b2]
  float* g;             // (P_total) the gradient [W1 | b1 | W2 | b2 | g_pm]
  float* gnew;          // (P_total) its proposal
  float* gblk;          // [gridDim.x][(NG + 2) P_total]
  float* mbuf;          // [gridDim.x][T dz^2]: m, then ct_m, of the block's tile
  int norm_z, norm_j, T, R;
};

// The pitch of a chunk's rows: the wider level, rounded up to 4.
__host__ __device__ inline int chunk_pitch(const WideLayout& L) {
  return cnf::round_up(L.width[1] > L.dz ? L.width[1] : L.dz, 4);
}

struct TileArrays {
  float *HS, *DH, *CA;     // (T, hp): h, dh, ct_dh then ct_pre1
  float *DY, *CP2, *D, *S; // (T, zp): dy, ct_pre2, d then ct_d, s then ct_s
  float* SC;               // (T, 4): ct_tr, ct_fro2, fz
  float *TA, *TB;          // (R, chunk_pitch): basis chunks
};

__host__ __device__ inline size_t tile_floats(const WideLayout& L, int T, int R) {
  return (size_t)T * (4 * L.zp + 3) + (size_t)T * (3 * L.hp[1] + 4 * L.zp + 4) + 2 * (size_t)R * chunk_pitch(L);
}

__device__ inline TileArrays tile_arrays(const WideLayout& L, int T, int R, float* base) {
  TileArrays a;
  const int v = T * L.zp, h = T * L.hp[1];
  a.HS = base;
  a.DH = a.HS + h;
  a.CA = a.DH + h;
  a.DY = a.CA + h;
  a.CP2 = a.DY + v;
  a.D = a.CP2 + v;
  a.S = a.D + v;
  a.SC = a.S + v;
  a.TA = a.SC + 4 * T;
  a.TB = a.TA + R * chunk_pitch(L);
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

// One augmented stage of a tile (fused_solve.py::_stage_train_exact_fwdbwd
// with ct_y = a_z, ct_r = a_acc): KZ = y, KR = the rates, KAZ = -ct_z (and,
// COND, KYS = k_ays); the residuals of the gradient pass left in the tile
// arrays and ct_m in mb.
template <bool COND>
struct WideExactAdjStage : CondRows<COND> {
  const WideLayout* L;
  const float* w;      // the shared weight region
  const float* aaccT;  // (3, B)
  float* mb;           // this block's (T dz, dz) rows of m, then ct_m
  TileArrays a;
  int B, T, R, norm_z, norm_j;

  __device__ void operator()(int s0, int nv, const float* Z, const float* AZ, float* KZ, float* KR, float* KAZ,
                             [[maybe_unused]] float* KYS = nullptr) const {
    const WideLayout& c = *L;
    const int dz = c.dz, zp = c.zp, H = c.width[1], hp = c.hp[1], bp = chunk_pitch(c);
    const int p0 = c.pitch[0], p1 = c.pitch[1];
    const float* w1 = w + c.wofs[0];
    const float* w2 = w + c.wofs[1];
    const int rows = T * dz;
    if constexpr (COND) {
      cnf::load_tile_cond(this->ys, cnf::wide_nc(c), s0, nv, T, this->YS);
      cnf::two_layer_forward_cond(c, w, Z, this->YS, T, a.HS, a.DH, KZ, a.DY);
    } else {
      cnf::two_layer_forward(c, w, Z, T, a.HS, a.DH, KZ, a.DY);
    }
    for (int idx = threadIdx.x; idx < T * dz; idx += blockDim.x) {
      const int t = idx / dz, i = idx % dz;
      a.S[t * zp + i] = 0.f;
    }
    __syncthreads();
    // The rows of m, R basis rows (t, j) a chunk: TA = dh (.) W1[j, :], then
    // (TA W2) to TB and mb; each (t, i) adds its rows' m[j, i]^2 in j order.
    for (int r0 = 0; r0 < rows; r0 += R) {
      for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
        const int r = idx / H, o = idx % H, gr = r0 + r;
        a.TA[r * bp + o] = gr < rows ? a.DH[(gr / dz) * hp + o] * w1[(gr % dz) * p0 + o] : 0.f;
      }
      __syncthreads();
      cnf::tile_mm(a.TA, bp, H, w2, p1, nullptr, dz, R, [&](int r, int i, float x) {
        a.TB[r * bp + i] = x;
        if (r0 + r < rows) mb[(size_t)(r0 + r) * dz + i] = x;
      });
      for (int idx = threadIdx.x; idx < T * dz; idx += blockDim.x) {
        const int t = idx / dz, i = idx % dz;
        const int lo = max(r0, t * dz), hi = min(r0 + R, (t + 1) * dz);
        float s = a.S[t * zp + i];
        for (int gr = lo; gr < hi; ++gr) {
          const float x = a.TB[(gr - r0) * bp + i];
          s = fmaf(x, x, s);
          if (gr - t * dz == i) a.D[t * zp + i] = x;
        }
        a.S[t * zp + i] = s;
      }
      __syncthreads();
    }
    // The rates and their cotangent factors.
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      float ysq = 0.f, tr = 0.f, fro2 = 0.f;
      for (int k = 0; k < dz; ++k) {
        const int o = t * zp + k;
        const float y = KZ[o], dy = a.DY[o];
        ysq = fmaf(y, y, ysq);
        tr = fmaf(dy, a.D[o], tr);
        fro2 = fmaf(dy * dy, a.S[o], fro2);
      }
      const float e_rate = safe_norm_sq(ysq), n_rate = safe_norm_sq(fro2);
      KR[t * 3 + 0] = -tr;
      KR[t * 3 + 1] = norm_z ? e_rate : 0.f;
      KR[t * 3 + 2] = norm_j ? n_rate : 0.f;
      float aacc[3];
      for (int r = 0; r < 3; ++r) aacc[r] = t < nv ? aaccT[(size_t)r * B + s0 + t] : 0.f;
      a.SC[t * 4 + 0] = -aacc[0];  // ct_tr: the rate is -tr
      a.SC[t * 4 + 1] = norm_j ? 0.5f * ct_safe_norm(aacc[2], n_rate) : 0.f;  // n = sqrt(fro^2)
      a.SC[t * 4 + 2] = norm_z ? ct_safe_norm(aacc[1], e_rate) : 0.f;
    }
    __syncthreads();
    // ct_d, ct_s over d, s; ct_pre2 = (a_z - 2 y ct_dy + y fz) dy.
    for (int idx = threadIdx.x; idx < T * dz; idx += blockDim.x) {
      const int t = idx / dz, k = idx % dz, o = t * zp + k;
      const float ct_tr = a.SC[t * 4], ct_fro2 = a.SC[t * 4 + 1], fz = a.SC[t * 4 + 2];
      const float dy = a.DY[o], y = KZ[o];
      float ct_dy = a.D[o] * ct_tr;
      if (norm_j) ct_dy = ct_dy + 2.f * dy * a.S[o] * ct_fro2;
      float ct_y = AZ[o] + (-2.f * y) * ct_dy;
      if (norm_z) ct_y = ct_y + y * fz;
      a.CP2[o] = ct_y * dy;
      a.D[o] = dy * ct_tr;
      a.S[o] = (dy * dy) * ct_fro2;
    }
    for (int idx = threadIdx.x; idx < T * H; idx += blockDim.x) {
      const int t = idx / H, o = idx % H;
      a.CA[t * hp + o] = 0.f;
    }
    __syncthreads();
    // ct_m over m in mb, R rows a chunk into TA; (TA W2^T) (.) W1[j, :] to
    // TB, each (t, h) adding its rows in j order: ct_dh.
    for (int r0 = 0; r0 < rows; r0 += R) {
      for (int idx = threadIdx.x; idx < R * dz; idx += blockDim.x) {
        const int r = idx / dz, i = idx % dz, gr = r0 + r;
        float x = 0.f;
        if (gr < rows) {
          const int t = gr / dz, j = gr % dz;
          float* mp = mb + (size_t)gr * dz + i;
          x = (i == j ? a.D[t * zp + i] : 0.f) + (2.f * a.S[t * zp + i]) * (*mp);
          *mp = x;
        }
        a.TA[r * bp + i] = x;
      }
      __syncthreads();
      cnf::tile_mm_t(a.TA, bp, dz, w2, p1, H, R, [&](int r, int h, float x) {
        a.TB[r * bp + h] = x * w1[((r0 + r) % dz) * p0 + h];
      });
      for (int idx = threadIdx.x; idx < T * H; idx += blockDim.x) {
        const int t = idx / H, h = idx % H;
        const int lo = max(r0, t * dz), hi = min(r0 + R, (t + 1) * dz);
        float v = a.CA[t * hp + h];
        for (int gr = lo; gr < hi; ++gr) v += a.TB[(gr - r0) * bp + h];
        a.CA[t * hp + h] = v;
      }
      __syncthreads();
    }
    // Down the forward chain: ct_pre1 = (W2 ct_pre2 - 2 h ct_dh) dh over
    // ct_dh, k_az = -W1 ct_pre1.
    cnf::tile_mm_t(a.CP2, zp, dz, w2, p1, H, T, [&](int t, int o, float x) {
      const int i = t * hp + o;
      a.CA[i] = (x + (-2.f * a.HS[i]) * a.CA[i]) * a.DH[i];
    });
    cnf::tile_mm_t(a.CA, hp, H, w1, p0, dz, T, [&](int t, int k, float x) { KAZ[t * zp + k] = -x; });
    if constexpr (COND) cnf::wide_ys_cotangent(c, w, a.CA, T, KYS);
  }
};

// The tile's sum over its first nv rows of the negated gradient rate of the
// stage just evaluated, entry q of [W1 (dz + nc, H) | b1 | W2 (H, dz) | b2 |
// pm (dz^2, H)] (W1's ys rows, COND, ys (x) ct_pre1).
template <bool COND>
struct WideExactGrad : CondRows<COND> {
  const WideLayout* L;
  const float* Z;   // the solver's stage input z
  const float* mb;  // this block's ct_m rows
  TileArrays a;

  __device__ float operator()(int q, int nv) const {
    const WideLayout& c = *L;
    const int dz = c.dz, H = c.width[1], zp = c.zp, hp = c.hp[1];
    const int o1 = c.pofs[1], P = c.P;
    float v = 0.f;
    if constexpr (COND) {
      if (q >= dz * H && q < c.width[0] * H) {
        const int nc = c.width[0] - dz, k = q / H - dz, o = q % H;
        for (int t = 0; t < nv; ++t) v = fmaf(this->YS[t * nc + k], a.CA[t * hp + o], v);
        return -v;
      }
    }
    if (q < dz * H) {
      const int k = q / H, o = q % H;
      for (int t = 0; t < nv; ++t) v = fmaf(Z[t * zp + k], a.CA[t * hp + o], v);
    } else if (q < o1) {
      const int o = q - (COND ? c.width[0] : dz) * H;
      for (int t = 0; t < nv; ++t) v += a.CA[t * hp + o];
    } else if (q < o1 + H * dz) {
      const int h = (q - o1) / dz, i = (q - o1) % dz;
      for (int t = 0; t < nv; ++t) v = fmaf(a.HS[t * hp + h], a.CP2[t * zp + i], v);
    } else if (q < P) {
      const int i = q - o1 - H * dz;
      for (int t = 0; t < nv; ++t) v += a.CP2[t * zp + i];
    } else {
      const int ji = (q - P) / H, h = (q - P) % H;
      const float* mp = mb + ji;
      const size_t stride = (size_t)dz * dz;
      for (int t = 0; t < nv; ++t) v = fmaf(mp[t * stride], a.DH[t * hp + h], v);
    }
    return -v;
  }
};

// One block an SM (its shared memory allows no second).
__global__ void __launch_bounds__(kWideBlock, 1) k4_wide_adjoint(const AdjArgs p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ WideLayout L;
  cnf::share_layout(p.L, &L);
  const int T = p.T, R = p.R;
  float* w = smem;
  float* red = w + L.wfloats;
  float* scratch = red + kRedFloats;  // the solver's Z, AZ, KZ, KAZ, KR
  const TileArrays arrays = tile_arrays(L, T, R, scratch + T * (4 * L.zp + 3));
  float* mb = p.mbuf + (size_t)blockIdx.x * T * L.dz * L.dz;
  cnf::load_wide_weights(p.params, L, w);
  __syncthreads();
  const WideExactAdjStage<false> stage{{}, &L, w, p.s.aaccT, mb, arrays, p.s.B, T, R, p.norm_z, p.norm_j};
  const WideExactGrad<false> grad{{}, &L, scratch, mb, arrays};
  const int Pt = L.P + L.dz * L.dz * L.width[1];
  cnf::adjoint_solve_tiles<kStageUnroll>(p.s, stage, grad, Pt, T, scratch, p.gblk, p.g, p.gnew, red);
}

// Dynamic shared memory: the weights, the reduction slots, the tile arrays
// and, in the COND instance, k_ays and the tile's ys rows (2 T nc).
size_t smem_bytes(const WideLayout& L, int T, int R) {
  return sizeof(float) * ((size_t)L.wfloats + kRedFloats + tile_floats(L, T, R) + (size_t)2 * T * cnf::wide_nc(L));
}

// The COND instance's arguments: the unconditional instance's and the
// conditioning ys (B, nc).
struct CondAdjArgs {
  AdjArgs a;
  const float* ys;
};

// One block an SM, as the unconditional instance.
__global__ void __launch_bounds__(kWideBlock, 1) k4_wide_cond_adjoint(const __grid_constant__ CondAdjArgs ca) {
  extern __shared__ __align__(16) float smem[];
  __shared__ WideLayout L;
  const AdjArgs& p = ca.a;
  cnf::share_layout(p.L, &L);
  const int T = p.T, R = p.R, nc = cnf::wide_nc(L);
  float* w = smem;
  float* red = w + L.wfloats;
  float* scratch = red + kRedFloats;  // the solver's Z, AZ, KZ, KAZ, KR and KYS (T, nc)
  const TileArrays arrays = tile_arrays(L, T, R, scratch + T * (4 * L.zp + 3 + nc));
  float* YS = arrays.TB + R * chunk_pitch(L);  // the tile's ys rows (T, nc)
  float* mb = p.mbuf + (size_t)blockIdx.x * T * L.dz * L.dz;
  cnf::load_wide_weights(p.params, L, w);
  __syncthreads();
  const WideExactAdjStage<true> stage{{ca.ys, YS}, &L, w, p.s.aaccT, mb, arrays, p.s.B, T, R, p.norm_z, p.norm_j};
  const WideExactGrad<true> grad{{ca.ys, YS}, &L, scratch, mb, arrays};
  cnf::adjoint_solve_tiles<kStageUnroll, false, 3, true>(p.s, stage, grad, L.P + L.dz * L.dz * L.width[1], T,
                                                           scratch, p.gblk, p.g, p.gnew, red);
}

// The launch shape of `kernel` at batch B, as cnf_k4w_shape describes it.
template <class Kernel>
int adjoint_shape(Kernel kernel, const WideLayout& L, int B, int* out) {
  size_t smem[kOptions];
  int index[kOptions];
  for (int o = 0; o < kOptions; ++o) {
    smem[o] = smem_bytes(L, kTiles[o], kChunks[o]);
    index[o] = o;
  }
  int got[4];
  const int err = cnf::wide_shape(kernel, smem, kTiles, index, kOptions, B, got);
  if (err != (int)cudaSuccess) return err;
  out[0] = got[0];
  out[1] = got[1];
  out[2] = kTiles[got[2]];
  out[3] = kChunks[got[2]];
  out[4] = got[3];
  return err;
}

}  // namespace

// The launch shape at batch B: out = {threads per block, blocks, samples a
// tile T, basis rows a chunk R, dynamic shared memory bytes}, the first
// (T, R) option whose shared memory leaves a co-resident grid.  widths: the
// 3 level widths (host memory).  Returns a cudaError_t
// (cudaErrorInvalidValue for a net not covered).
extern "C" int cnf_k4w_shape(int n, const int* widths, int B, int* out) {
  WideLayout L;
  if (B < 1 || n != 2 || !cnf::make_wide_layout(n, widths, &L)) return (int)cudaErrorInvalidValue;
  return adjoint_shape(k4_wide_adjoint, L, B, out);
}

// params: [W1 | b1 | W2 | b2] flat (device); g: P_total = P + dz^2 H floats,
// [W1 | b1 | W2 | b2 | g_pm]; acts: 3 (both layers tanh); zT, azT, z0, az0:
// (B, dz); accT/aaccT/acc0: (3, B).  work: (S + 2) (2 dz + 3) B floats;
// partials: 10 grid; gblk: grid (NG + 2) P_total (NG = 3 for a tableau with
// btilde3, else 2); gnew: P_total; mbuf: grid T dz^2.  tab: kTableauFloats
// floats (read_tableau).  T, R, grid, block: from cnf_k4w_shape.  Returns
// the launch's cudaError_t.
extern "C" int cnf_k4w_exact_adjoint(const float* params, const float* zT, const float* accT, const float* azT,
                                     const float* aaccT, const float* ts, float* z0, float* acc0, float* az0,
                                     float* g, int* stats, float* work, float* partials, float* gblk, float* gnew,
                                     float* mbuf, int B, int n, const int* widths, int acts, int max_steps, int norm_z,
                                     int norm_j, float rtol, float atol, float beta1, float beta2, float inv_order,
                                     const float* tab, int T, int R, int grid, int block, void* stream) {
  AdjArgs a = {};
  if (block != kWideBlock || grid < 1 || T < cnf::kRows || T % cnf::kRows != 0 || R < cnf::kRows || R % cnf::kRows != 0 ||
      !cnf::make_wide_layout(n, widths, &a.L) || !cnf::two_layer_tanh(a.L, acts))
    return (int)cudaErrorInvalidValue;
  cnf::set_adj_state(&a.s, zT, accT, azT, aaccT, ts, z0, acc0, az0, stats, work, partials, nullptr, B, widths[n],
                     max_steps, rtol, atol, beta1, beta2, inv_order, tab);
  a.params = params;
  a.g = g;
  a.gnew = gnew;
  a.gblk = gblk;
  a.mbuf = mbuf;
  a.norm_z = norm_z;
  a.norm_j = norm_j;
  a.T = T;
  a.R = R;
  return (int)cnf::coop_launch(k4_wide_adjoint, a, grid, block, smem_bytes(a.L, T, R), (cudaStream_t)stream);
}

// The COND instance's launch shape (K8), as cnf_k4w_shape; widths[0] =
// dz + nc with nc >= 1.
extern "C" int cnf_k4wc_shape(int n, const int* widths, int B, int* out) {
  WideLayout L;
  if (B < 1 || n != 2 || !cnf::make_wide_layout(n, widths, &L, true)) return (int)cudaErrorInvalidValue;
  return adjoint_shape(k4_wide_cond_adjoint, L, B, out);
}

// The COND instance (K8): as cnf_k4w_exact_adjoint for a conditional net,
// with ys (B, nc) (device) and ays0 (B, nc), nc = widths[0] - widths[2] >= 1,
// the cotangent of ys at t_lo; params and g hold W1's ys rows after its z
// rows (g_pm: W1's z rows only); work: (S + 2) (2 dz + 3 + nc) B floats;
// T, R, grid, block from cnf_k4wc_shape.
extern "C" int cnf_k4w_cond_exact_adjoint(const float* params, const float* ys, const float* zT, const float* accT,
                                          const float* azT, const float* aaccT, const float* ts, float* z0,
                                          float* acc0, float* az0, float* ays0, float* g, int* stats, float* work,
                                          float* partials, float* gblk, float* gnew, float* mbuf, int B, int n,
                                          const int* widths, int acts, int max_steps, int norm_z, int norm_j,
                                          float rtol, float atol, float beta1, float beta2, float inv_order,
                                          const float* tab, int T, int R, int grid, int block, void* stream) {
  CondAdjArgs ca = {};
  AdjArgs& a = ca.a;
  if (block != kWideBlock || grid < 1 || T < cnf::kRows || T % cnf::kRows != 0 || R < cnf::kRows ||
      R % cnf::kRows != 0 || ys == nullptr || ays0 == nullptr || !cnf::make_wide_layout(n, widths, &a.L, true) ||
      !cnf::two_layer_tanh(a.L, acts))
    return (int)cudaErrorInvalidValue;
  cnf::set_adj_state(&a.s, zT, accT, azT, aaccT, ts, z0, acc0, az0, stats, work, partials, nullptr, B, widths[n],
                     max_steps, rtol, atol, beta1, beta2, inv_order, tab);
  a.s.nc = cnf::wide_nc(a.L);
  a.s.ays0 = ays0;
  a.params = params;
  a.g = g;
  a.gnew = gnew;
  a.gblk = gblk;
  a.mbuf = mbuf;
  a.norm_z = norm_z;
  a.norm_j = norm_j;
  a.T = T;
  a.R = R;
  ca.ys = ys;
  return (int)cnf::coop_launch(k4_wide_cond_adjoint, ca, grid, block, smem_bytes(a.L, T, R),
                               (cudaStream_t)stream);
}
