// K4 adjoint: the continuous-adjoint (backsolve) backward integration of an
// exact-trace TRAIN-mode CNF whose field is a 2-layer tanh MLP, the whole
// adaptive solve (any embedded explicit tableau, K9) from t_hi down to t_lo
// in one cooperative launch.
//
// Replaces the TPU kernel built by continuousnf_tpu/ops/fused_solve.py::
// _make_adjoint_kernel (:1064-1343), launched by make_full_solve.adjoint_solve
// (pl.pallas_call at :1767), with the _stage_train_exact_fwdbwd stage
// (:618-675).  The state is, per sample, z (dz), acc (3: dlogp, reg_e, reg_n),
// a_z (dz) and the constant a_acc (3), plus the batch-summed gradient
// g = [g_w1 (dz, H) | g_b1 | g_w2 (H, dz) | g_b2 | g_pm (dz^2, H)] of
// P_total = P + dz^2 H floats (P = 2 dz H + H + dz; 13,888 at dz = 16,
// H = 48).  g_pm is the cotangent of pm[(j, i), h] = W1[j, h] W2[h, i] (the
// TPU kernel's j-major exact_stage_consts); the wrapper chains it back into
// g_w1 and g_w2 after the solve (exact_pm_chain, :562-568), as the TPU path
// does at :1787-1799.  g_pm stays in the state and in the error norm: that is
// the TPU kernel's single-tile numerics, and its step counts follow from it.
//
// Controller: K2's, the backsolve loop of solve_common.cuh (adjoint_solve).
// One batch-global Hairer norm over n = B * 2 * (dz + 3) + P_total elements,
// the g entries scaled by atol + rtol * max(|g|, |g_new|) of the
// batch-summed values.  Per attempted step each block accumulates its
// partials of dt * sum_i b_i k_g,i and dt * sum_i btilde_i k_g,i in a
// parity-indexed global buffer, writes its per-sample sum of squares, one
// grid.sync(), and then every block adds all blocks' vectors in block order,
// so every block holds the same g and takes the same decision.  FSAL keeps
// each block's own partial of the last stage's g rate.  (The TPU package runs two batch tiles of 2048 at
// B = 4096, each with its own controller; one tile is its numerics at the
// sizes where it picks one.)
//
// Per sample and stage (_stage_train_exact_fwdbwd for one sample):
//   forward:  h, dh = 1 - h^2, y, dy = 1 - y^2; rows m[j, :] of
//             m[j, i] = sum_h W1[j, h] dh_h W2[h, i], written to a global
//             scratch as they come; tr = sum_i dy_i m[i, i] and
//             s_i = sum_j m[j, i]^2, fro^2 = sum_i dy_i^2 s_i;
//   backward: ct_d = dy ct_tr, ct_s = dy^2 ct_fro2, ct_dy = d ct_tr +
//             2 dy s ct_fro2; then, reading the rows of m back,
//             ct_m[j, i] = [i = j] ct_d_i + 2 ct_s_i m[j, i] (kept in the
//             scratch for the g_pm pass) and ct_dh[h] += W1[j, h] *
//             sum_i W2[h, i] ct_m[j, i]; the output and hidden layers' VJP
//             as in K2.
// The block's g_pm partial is sum over its samples of ct_m[j, i] dh_h: per
// stage a (dz^2, samples) x (samples, H) product.
//
// Memory plan.  K2's shared-memory layout does not fit: its five P-vectors
// become five P_total-vectors (278 KB at the flagship).  So:
//   * shared memory holds the weights and one slot per thread with the
//     residuals the outer products read (z, ct_pre2, h, dh, ct_pre1: 2 dz + 3 H
//     floats at an odd stride, conflict-free; 97 KB per 128-thread block at
//     the flagship);
//   * the g vectors live in global memory, each block owning its copies
//     (g, g_new, the FSAL partial and the last stage's partial: 4 P_total
//     floats per block) and its parity-indexed partials (2 P_total floats per
//     parity), 14 MB at 32 blocks: L2-resident;
//   * m and then ct_m go to a (dz^2, B) global scratch (4 MB at B = 4096)
//     rather than being recomputed: 2 dz^2 coalesced stores and loads per
//     sample instead of dz^2 H FMA.
// Every block reads all blocks' partials after the barrier: G * 2 * P_total
// floats per block per step (3.6 MB at G = 32), from L2.
//
// What bounds it on the H100: latency, as for K2.  A stage is about
// 2 dz^2 H + 6 dz H FMA per sample (30 k at the flagship) on one thread per
// sample, plus the block's outer-product pass (P_total * samples FMA, mostly
// the g_pm product), plus one grid barrier and the partials' read per step.
// Precision: f32 FMA on the CUDA cores, no TF32 and no tensor cores.
//
// The COND instance (K8 in the 2-layer kernels): the same backsolve of a
// conditional 2-layer net whose W1 reads [z | ys] (_zin, fused_solve.py:265),
// with the TPU kernel's a_ys block (:1110-1340).  The forward's hidden
// pre-activation adds ys . wy[h] (W1's ys rows, (H, nc) in shared memory
// after the slots; the sample's ys row in registers, two_layer_cond.cuh); m,
// pm and g_pm read W1's z rows only (:1790).  Per sample, a_ys (nc) starts
// at zero at t_hi (:1183) and integrates k_ays = -W1y^T ct_pre1 (:1167), riding in the
// (row, B) planes after a_z and in the one batch-global error norm, whose
// count gains B nc (:1694; adjoint_solve's COND form).  g holds W1's nc ys
// rows after its z rows, P_total = (dz + nc) H + H + H dz + dz + dz^2 H, and
// the block's pass adds ys (x) ct_pre1 to them; the wrapper chains g_pm into
// the z rows alone (:1787-1799) and returns a_ys0 last.  Its entries are
// cnf_k4ac_max_grid, cnf_k4ac_smem_bytes and cnf_k4_cond_adjoint.

#include "solve_common.cuh"
#include "two_layer_cond.cuh"

namespace {

// The unroll factor of the solve loops over stored stages (solve_common.cuh),
// the fastest of 1, 2, 4 and 8 for this kernel on the H100 (PERF.md, PR 6).
constexpr int kStageUnroll = 8;

using cnf::axpy4;
using cnf::CondRows;
using cnf::ct_safe_norm;
using cnf::dot4;
using cnf::kMaxBlock;
using cnf::kRedFloats;
using cnf::safe_norm_sq;

struct AdjArgs {
  cnf::AdjState s;
  const float* w1;    // (dz, H)
  const float* b1;    // (H)
  const float* w2;    // (H, dz)
  const float* b2;    // (dz)
  float* gw1;         // (dz, H)
  float* gb1;         // (H)
  float* gw2;         // (H, dz)
  float* gb2;         // (dz)
  float* gpm;         // (dz^2, H), rows (j, i) j-major
  float* gblk;        // [gridDim.x][4 P_total]: each block's g, g_new, FSAL and last-stage partials
  float* mbuf;        // (dz^2, B): m, then ct_m, of the current stage
  int H, norm_z, norm_j;
};

// Offsets in a thread's shared-memory slot: two dz-vectors, then three
// H-vectors (ca holds ct_dh during the stage and then ct_pre1).
template <int DZ>
struct Slot {
  int z, ca1, h, dh, ca, size;
  __device__ __host__ explicit Slot(int H) {
    z = 0; ca1 = DZ; h = 2 * DZ; dh = h + H; ca = dh + H;
    size = (ca + H) | 1;
  }
};

struct Weights {
  const float* w1t;  // (H, DZ): w1t[h][j] = w1[j][h]
  const float* w2p;  // (H, DZ): w2p[h][i] = w2[h][i]
  const float* b1;   // (H)
  const float* b2p;  // (DZ)
  int H, dz, B, norm_z, norm_j;
};

// One augmented stage of one sample (fused_solve.py::_stage_train_exact_fwdbwd
// with ct_y = a_z, ct_r = a_acc): the field y and rates kr, k_az = -ct_z, and
// the residuals the outer-product pass reads, left in the slot `sl` and in
// column `ms` of the (dz^2, B) scratch.  COND: sample smp's ys enters the
// hidden pre-activation, and k_ays = -W1y^T ct_pre1 goes to kys[c * B].
template <int DZ, bool COND>
__device__ void exact_adjoint_stage(const Weights& w, const CondRows<COND>& cr, [[maybe_unused]] int smp, float* sl,
                                    float* ms, const float (&z)[DZ], const float (&az)[DZ], const float (&aacc)[3],
                                    float (&kz)[DZ], float (&kr)[3], float (&kaz)[DZ], [[maybe_unused]] float* kys) {
  const Slot<DZ> o(w.H);
  const int H = w.H, dz = w.dz;
  const size_t B = (size_t)w.B;
  // Forward: h = tanh(z W1 + b1), y = tanh(h W2 + b2).
  float y[DZ];
#pragma unroll
  for (int k = 0; k < DZ; ++k) y[k] = w.b2p[k];
  [[maybe_unused]] cnf::CondRegs<COND> yv;
  if constexpr (COND) cr.load(smp, yv);
  for (int h = 0; h < H; ++h) {
    float pre = dot4<DZ>(z, w.w1t + h * DZ) + w.b1[h];
    if constexpr (COND) pre = cr.add(pre, h, yv, smp);
    const float a = tanhf(pre);
    sl[o.h + h] = a;
    sl[o.dh + h] = 1.f - a * a;
    axpy4<DZ>(y, a, w.w2p + h * DZ);
  }
  float dy[DZ], ysq = 0.f;
#pragma unroll
  for (int k = 0; k < DZ; ++k) {
    y[k] = tanhf(y[k]);
    ysq = fmaf(y[k], y[k], ysq);
    dy[k] = 1.f - y[k] * y[k];
    sl[o.z + k] = z[k];
  }
  // The rows of m: d[j] = m[j, j] (by a select, so the j loop need not be
  // unrolled), s[i] = sum_j m[j, i]^2; each row to ms.
  float d[DZ], s[DZ];
#pragma unroll
  for (int i = 0; i < DZ; ++i) {
    d[i] = 0.f;
    s[i] = 0.f;
  }
#pragma unroll 1
  for (int j = 0; j < dz; ++j) {
    float m[DZ];
#pragma unroll
    for (int i = 0; i < DZ; ++i) m[i] = 0.f;
    for (int h = 0; h < H; ++h) axpy4<DZ>(m, w.w1t[h * DZ + j] * sl[o.dh + h], w.w2p + h * DZ);
#pragma unroll
    for (int i = 0; i < DZ; ++i) {
      if (i == j) d[i] = m[i];
      s[i] = fmaf(m[i], m[i], s[i]);
      if (i < dz) ms[(size_t)(j * dz + i) * B] = m[i];
    }
  }
  float tr = 0.f, fro2 = 0.f;
#pragma unroll
  for (int i = 0; i < DZ; ++i) {
    tr = fmaf(dy[i], d[i], tr);
    fro2 = fmaf(dy[i] * dy[i], s[i], fro2);
  }
  const float e_rate = safe_norm_sq(ysq), n_rate = safe_norm_sq(fro2);
  kr[0] = -tr;
  kr[1] = w.norm_z ? e_rate : 0.f;
  kr[2] = w.norm_j ? n_rate : 0.f;

  // Backward.  Rates row 0 is -tr: ct_tr = -a_acc[0]; n = sqrt(fro^2), so
  // d n / d fro^2 = 1 / (2 n).
  const float ct_tr = -aacc[0];
  const float ct_fro2 = w.norm_j ? 0.5f * ct_safe_norm(aacc[2], n_rate) : 0.f;
  float ct_d[DZ], ct_s[DZ], cdy[DZ];
#pragma unroll
  for (int i = 0; i < DZ; ++i) {
    ct_d[i] = dy[i] * ct_tr;
    cdy[i] = d[i] * ct_tr;
    ct_s[i] = (dy[i] * dy[i]) * ct_fro2;
    if (w.norm_j) cdy[i] = cdy[i] + 2.f * dy[i] * s[i] * ct_fro2;
  }
  // ct_m[j, i] = [i = j] ct_d_i + 2 ct_s_i m[j, i] over ms in place, and
  // ct_dh[h] = sum_j W1[j, h] sum_i W2[h, i] ct_m[j, i] into the ca slot.
  for (int h = 0; h < H; ++h) sl[o.ca + h] = 0.f;
#pragma unroll 1
  for (int j = 0; j < dz; ++j) {
    float r[DZ];
#pragma unroll
    for (int i = 0; i < DZ; ++i) {
      if (i < dz) {
        float* mp = ms + (size_t)(j * dz + i) * B;
        r[i] = (i == j ? ct_d[i] : 0.f) + (2.f * ct_s[i]) * (*mp);
        *mp = r[i];
      } else {
        r[i] = 0.f;
      }
    }
    for (int h = 0; h < H; ++h) sl[o.ca + h] = fmaf(w.w1t[h * DZ + j], dot4<DZ>(r, w.w2p + h * DZ), sl[o.ca + h]);
  }
  // The output layer: ct_y = a_z - 2 y ct_dy (+ y fz), ct_pre2 = ct_y dy.
  const float fz = w.norm_z ? ct_safe_norm(aacc[1], e_rate) : 0.f;
  float ca1[DZ];
#pragma unroll
  for (int k = 0; k < DZ; ++k) {
    float ct_y = az[k] + (-2.f * y[k]) * cdy[k];
    if (w.norm_z) ct_y = ct_y + y[k] * fz;
    ca1[k] = ct_y * dy[k];
    sl[o.ca1 + k] = ca1[k];
    kz[k] = y[k];
  }
  // Down the forward chain: ct_h = W2 ct_pre2 - 2 h ct_dh, ct_pre1 = ct_h dh,
  // ct_z = W1 ct_pre1.
  float cz[DZ];
#pragma unroll
  for (int i = 0; i < DZ; ++i) cz[i] = 0.f;
  for (int h = 0; h < H; ++h) {
    const float ca = (dot4<DZ>(ca1, w.w2p + h * DZ) + (-2.f * sl[o.h + h]) * sl[o.ca + h]) * sl[o.dh + h];
    sl[o.ca + h] = ca;
    axpy4<DZ>(cz, ca, w.w1t + h * DZ);
  }
#pragma unroll
  for (int i = 0; i < DZ; ++i) kaz[i] = -cz[i];
  if constexpr (COND) {
    // The ys rows: k_ays = -ct_pre1 W1y^T.
    for (int c = 0; c < cr.nc; ++c) {
      float a = 0.f;
      for (int h = 0; h < H; ++h) a = fmaf(sl[o.ca + h], cr.wy[h * cr.nc + c], a);
      kys[(size_t)c * B] = -a;
    }
  }
}

// The block's sum over its first `nvalid` samples (thread order) of the
// negated gradient rate of the stage just evaluated, entry q of
// [W1 (dz, H) | b1 | W2 (H, dz) | b2 | pm (dz^2, H)].  `mb` points at the
// block's first sample in the (dz^2, B) scratch.  COND: W1 has its nc ys
// rows after the z rows, [W1 (dz + nc, H) | b1 | ...], each entry the sum of
// ys (x) ct_pre1 over the block's samples base .. base + nvalid - 1.
template <int DZ, bool COND>
__device__ __forceinline__ float block_grad_entry(const float* slots, const float* mb, int q, int dz,
                                                  int H, int B, int nvalid, [[maybe_unused]] const CondRows<COND>& cr,
                                                  [[maybe_unused]] int base) {
  const Slot<DZ> o(H);
  if constexpr (COND) {
    if (q >= dz * H && q < (dz + cr.nc) * H) {
      const int c = q / H - dz, h = q % H;
      float v = 0.f;
      for (int t = 0; t < nvalid; ++t)
        v = fmaf(cr.ys[(size_t)(base + t) * cr.nc + c], slots[t * o.size + o.ca + h], v);
      return -v;
    }
    if (q >= dz * H) q -= cr.nc * H;
  }
  const int P = 2 * dz * H + H + dz;
  float v = 0.f;
  if (q < dz * H) {
    const int i = q / H, h = q % H;
    for (int t = 0; t < nvalid; ++t) {
      const float* sl = slots + t * o.size;
      v = fmaf(sl[o.z + i], sl[o.ca + h], v);
    }
  } else if (q < dz * H + H) {
    const int h = q - dz * H;
    for (int t = 0; t < nvalid; ++t) v += slots[t * o.size + o.ca + h];
  } else if (q < 2 * dz * H + H) {
    const int r = q - dz * H - H;
    const int h = r / dz, k = r % dz;
    for (int t = 0; t < nvalid; ++t) {
      const float* sl = slots + t * o.size;
      v = fmaf(sl[o.h + h], sl[o.ca1 + k], v);
    }
  } else if (q < P) {
    const int k = q - 2 * dz * H - H;
    for (int t = 0; t < nvalid; ++t) v += slots[t * o.size + o.ca1 + k];
  } else {
    const int r = q - P;
    const int ji = r / H, h = r % H;
    const float* mrow = mb + (size_t)ji * B;
    for (int t = 0; t < nvalid; ++t) v = fmaf(mrow[t], slots[t * o.size + o.dh + h], v);
  }
  return -v;
}

// The stage and gradient callbacks of cnf::adjoint_solve.
template <int DZ, bool COND>
struct ExactStage {
  Weights w;
  CondRows<COND> cr;
  float* mbuf;  // (dz^2, B)
  float* sl;    // this thread's slot
  __device__ void operator()(int s, const float (&z)[DZ], const float (&az)[DZ], const float (&aacc)[3],
                             float (&kz)[DZ], float (&kr)[3], float (&kaz)[DZ], float* kys) const {
    exact_adjoint_stage<DZ, COND>(w, cr, s, sl, mbuf + s, z, az, aacc, kz, kr, kaz, kys);
  }
};

template <int DZ, bool COND>
struct ExactGrad {
  const float* slots;
  const float* mbuf;
  CondRows<COND> cr;
  int dz, H, B;
  __device__ float operator()(int q, int base, int nvalid) const {
    return block_grad_entry<DZ, COND>(slots, mbuf + base, q, dz, H, B, nvalid, cr, base);
  }
};

template <int DZ>
__global__ void __launch_bounds__(kMaxBlock) k4_exact_adjoint(const AdjArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int H = p.H, dz = p.s.dz, B = p.s.B;
  const int P = 2 * dz * H + H + dz;
  const int Pt = P + dz * dz * H;
  float* w1t = smem;               // (H, DZ)
  float* w2p = w1t + H * DZ;       // (H, DZ)
  float* b2p = w2p + H * DZ;       // (DZ)
  float* b1 = b2p + DZ;            // (H)
  float* red = b1 + H;             // kRedFloats
  float* slots = red + kRedFloats; // blockDim.x slots
  const Slot<DZ> o(H);
  // This block's g (the same in every block), proposed g, FSAL stage rate
  // and last-stage rate, in global memory.
  float* gp = p.gblk + (size_t)blockIdx.x * 4 * Pt;
  cnf::load_weights<DZ>(p.w1, p.b1, p.w2, p.b2, dz, H, w1t, w2p, b2p, b1);
  const Weights w{w1t, w2p, b1, b2p, H, dz, B, p.norm_z, p.norm_j};
  const ExactStage<DZ, false> stage{w, {}, p.mbuf, slots + threadIdx.x * o.size};
  const ExactGrad<DZ, false> grad{slots, p.mbuf, {}, dz, H, B};
  cnf::adjoint_solve<DZ, false, kStageUnroll>(p.s, stage, grad, Pt, gp, gp + Pt, gp + 2 * Pt, gp + 3 * Pt, red);

  if (blockIdx.x == 0) {
    for (int q = threadIdx.x; q < Pt; q += blockDim.x) {
      const float g = gp[q];
      if (q < dz * H) {
        p.gw1[q] = g;
      } else if (q < dz * H + H) {
        p.gb1[q - dz * H] = g;
      } else if (q < 2 * dz * H + H) {
        p.gw2[q - dz * H - H] = g;
      } else if (q < P) {
        p.gb2[q - 2 * dz * H - H] = g;
      } else {
        p.gpm[q - P] = g;
      }
    }
  }
}

// The shared memory of an instance with nc ys rows (0: unconditional).
template <int DZ>
size_t smem_bytes(int H, int block, int nc = 0) {
  return sizeof(float) * (cnf::weight_floats<DZ>(H) + kRedFloats + (size_t)block * Slot<DZ>(H).size +
                          (size_t)H * nc);
}

// The COND instance's arguments: the unconditional instance's (a.s.nc and
// a.s.ays0 set) and the conditioning ys (B, nc), nc >= 1.
struct CondArgs {
  AdjArgs a;
  const float* ys;
};

// The COND instance: k4_exact_adjoint's layout with wy (H, nc) after the
// slots, and g = [W1 (dz + nc, H) | b1 | W2 | b2 | pm].
template <int DZ>
__global__ void __launch_bounds__(kMaxBlock) k4_exact_cond_adjoint(const __grid_constant__ CondArgs ca) {
  extern __shared__ __align__(16) float smem[];
  const AdjArgs& p = ca.a;
  const int H = p.H, dz = p.s.dz, B = p.s.B, nc = p.s.nc;
  const int din = dz + nc;
  const int P = din * H + H + H * dz + dz;
  const int Pt = P + dz * dz * H;
  float* w1t = smem;               // (H, DZ)
  float* w2p = w1t + H * DZ;       // (H, DZ)
  float* b2p = w2p + H * DZ;       // (DZ)
  float* b1 = b2p + DZ;            // (H)
  float* red = b1 + H;             // kRedFloats
  float* slots = red + kRedFloats; // blockDim.x slots
  const Slot<DZ> o(H);
  float* wy = slots + blockDim.x * o.size;  // (H, nc)
  float* gp = p.gblk + (size_t)blockIdx.x * 4 * Pt;
  cnf::load_weights<DZ>(p.w1, p.b1, p.w2, p.b2, dz, H, w1t, w2p, b2p, b1);
  for (int idx = threadIdx.x; idx < H * nc; idx += blockDim.x) {
    const int h = idx / nc, c = idx % nc;
    wy[idx] = p.w1[(size_t)(dz + c) * H + h];
  }
  __syncthreads();
  const Weights w{w1t, w2p, b1, b2p, H, dz, B, p.norm_z, p.norm_j};
  const CondRows<true> cr{ca.ys, wy, nc};
  const ExactStage<DZ, true> stage{w, cr, p.mbuf, slots + threadIdx.x * o.size};
  const ExactGrad<DZ, true> grad{slots, p.mbuf, cr, dz, H, B};
  cnf::adjoint_solve<DZ, true, kStageUnroll>(p.s, stage, grad, Pt, gp, gp + Pt, gp + 2 * Pt, gp + 3 * Pt, red);

  if (blockIdx.x == 0) {
    for (int q = threadIdx.x; q < Pt; q += blockDim.x) {
      const float g = gp[q];
      if (q < din * H) {
        p.gw1[q] = g;
      } else if (q < din * H + H) {
        p.gb1[q - din * H] = g;
      } else if (q < din * H + H + H * dz) {
        p.gw2[q - din * H - H] = g;
      } else if (q < P) {
        p.gb2[q - din * H - H - H * dz] = g;
      } else {
        p.gpm[q - P] = g;
      }
    }
  }
}

}  // namespace

// Dynamic shared memory of one block (bytes), 0 for an unsupported dz.
extern "C" long long cnf_k4a_smem_bytes(int dz, int H, int block) {
  switch (cnf::padded_dz(dz)) {
    case 4: return (long long)smem_bytes<4>(H, block);
    case 8: return (long long)smem_bytes<8>(H, block);
    case 16: return (long long)smem_bytes<16>(H, block);
    case 32: return (long long)smem_bytes<32>(H, block);
    default: return 0;
  }
}

// Largest co-resident grid for a cooperative launch (0 if none).
extern "C" int cnf_k4a_max_grid(int dz, int H, int block, int* out) {
  switch (cnf::padded_dz(dz)) {
    case 4: return (int)cnf::coop_max_grid(k4_exact_adjoint<4>, smem_bytes<4>(H, block), block, out);
    case 8: return (int)cnf::coop_max_grid(k4_exact_adjoint<8>, smem_bytes<8>(H, block), block, out);
    case 16: return (int)cnf::coop_max_grid(k4_exact_adjoint<16>, smem_bytes<16>(H, block), block, out);
    case 32: return (int)cnf::coop_max_grid(k4_exact_adjoint<32>, smem_bytes<32>(H, block), block, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// accT/aaccT/acc0: (3, B).  gpart: 2 * grid * NG * P_total floats (NG = 3
// for a tableau with btilde3, else 2), gblk: grid * 4 * P_total, mbuf:
// dz^2 * B.  tab: kTableauFloats floats (read_tableau).  Returns the
// launch's cudaError_t.
extern "C" int cnf_k4_exact_adjoint(const float* w1, const float* b1, const float* w2,
                                    const float* b2, const float* zT, const float* accT,
                                    const float* azT, const float* aaccT, const float* ts,
                                    float* z0, float* acc0, float* az0, float* gw1, float* gb1,
                                    float* gw2, float* gb2, float* gpm, int* stats, float* work,
                                    float* partials, float* gpart, float* gblk, float* mbuf, int B,
                                    int dz, int H, int max_steps, int norm_z, int norm_j,
                                    float rtol, float atol, float beta1, float beta2,
                                    float inv_order, const float* tab, int grid, int block,
                                    void* stream) {
  if (block < 32 || block > kMaxBlock || block % 32 != 0 || grid < 1)
    return (int)cudaErrorInvalidValue;
  AdjArgs a = {};
  cnf::set_adj_state(&a.s, zT, accT, azT, aaccT, ts, z0, acc0, az0, stats, work, partials, gpart, B,
                     dz, max_steps, rtol, atol, beta1, beta2, inv_order, tab);
  a.w1 = w1; a.b1 = b1; a.w2 = w2; a.b2 = b2;
  a.gw1 = gw1; a.gb1 = gb1; a.gw2 = gw2; a.gb2 = gb2; a.gpm = gpm;
  a.gblk = gblk; a.mbuf = mbuf;
  a.H = H; a.norm_z = norm_z; a.norm_j = norm_j;
  cudaStream_t s = (cudaStream_t)stream;
  switch (cnf::padded_dz(dz)) {
    case 4: return (int)cnf::coop_launch(k4_exact_adjoint<4>, a, grid, block, smem_bytes<4>(H, block), s);
    case 8: return (int)cnf::coop_launch(k4_exact_adjoint<8>, a, grid, block, smem_bytes<8>(H, block), s);
    case 16: return (int)cnf::coop_launch(k4_exact_adjoint<16>, a, grid, block, smem_bytes<16>(H, block), s);
    case 32: return (int)cnf::coop_launch(k4_exact_adjoint<32>, a, grid, block, smem_bytes<32>(H, block), s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The COND instance (K8): dynamic shared memory of one block with nc ys
// rows (bytes), 0 for an unsupported dz.
extern "C" long long cnf_k4ac_smem_bytes(int dz, int H, int nc, int block) {
  switch (cnf::padded_dz(dz)) {
    case 4: return (long long)smem_bytes<4>(H, block, nc);
    case 8: return (long long)smem_bytes<8>(H, block, nc);
    case 16: return (long long)smem_bytes<16>(H, block, nc);
    case 32: return (long long)smem_bytes<32>(H, block, nc);
    default: return 0;
  }
}

// The COND instance (K8): largest co-resident grid with nc ys rows.
extern "C" int cnf_k4ac_max_grid(int dz, int H, int nc, int block, int* out) {
  switch (cnf::padded_dz(dz)) {
    case 4: return (int)cnf::coop_max_grid(k4_exact_cond_adjoint<4>, smem_bytes<4>(H, block, nc), block, out);
    case 8: return (int)cnf::coop_max_grid(k4_exact_cond_adjoint<8>, smem_bytes<8>(H, block, nc), block, out);
    case 16: return (int)cnf::coop_max_grid(k4_exact_cond_adjoint<16>, smem_bytes<16>(H, block, nc), block, out);
    case 32: return (int)cnf::coop_max_grid(k4_exact_cond_adjoint<32>, smem_bytes<32>(H, block, nc), block, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The COND instance (K8): as cnf_k4_exact_adjoint for a conditional net,
// with w1/gw1 (dz + nc, H), ys and ays0 (B, nc) (device), nc >= 1; work
// (S + 2) (2 dz + 3 + nc) B floats, gpart and gblk sized by P_total =
// (dz + nc) H + H + H dz + dz + dz^2 H.
extern "C" int cnf_k4_cond_adjoint(const float* w1, const float* b1, const float* w2, const float* b2,
                                   const float* ys, const float* zT, const float* accT, const float* azT,
                                   const float* aaccT, const float* ts, float* z0, float* acc0, float* az0,
                                   float* ays0, float* gw1, float* gb1, float* gw2, float* gb2, float* gpm,
                                   int* stats, float* work, float* partials, float* gpart, float* gblk, float* mbuf,
                                   int B, int dz, int H, int nc, int max_steps, int norm_z, int norm_j, float rtol,
                                   float atol, float beta1, float beta2, float inv_order, const float* tab, int grid,
                                   int block, void* stream) {
  if (block < 32 || block > kMaxBlock || block % 32 != 0 || grid < 1 || nc < 1 || ys == nullptr ||
      ays0 == nullptr)
    return (int)cudaErrorInvalidValue;
  CondArgs ca = {};
  AdjArgs& a = ca.a;
  cnf::set_adj_state(&a.s, zT, accT, azT, aaccT, ts, z0, acc0, az0, stats, work, partials, gpart, B,
                     dz, max_steps, rtol, atol, beta1, beta2, inv_order, tab);
  a.s.nc = nc;
  a.s.ays0 = ays0;
  a.w1 = w1; a.b1 = b1; a.w2 = w2; a.b2 = b2;
  a.gw1 = gw1; a.gb1 = gb1; a.gw2 = gw2; a.gb2 = gb2; a.gpm = gpm;
  a.gblk = gblk; a.mbuf = mbuf;
  a.H = H; a.norm_z = norm_z; a.norm_j = norm_j;
  ca.ys = ys;
  cudaStream_t s = (cudaStream_t)stream;
  switch (cnf::padded_dz(dz)) {
    case 4: return (int)cnf::coop_launch(k4_exact_cond_adjoint<4>, ca, grid, block, smem_bytes<4>(H, block, nc), s);
    case 8: return (int)cnf::coop_launch(k4_exact_cond_adjoint<8>, ca, grid, block, smem_bytes<8>(H, block, nc), s);
    case 16: return (int)cnf::coop_launch(k4_exact_cond_adjoint<16>, ca, grid, block, smem_bytes<16>(H, block, nc), s);
    case 32: return (int)cnf::coop_launch(k4_exact_cond_adjoint<32>, ca, grid, block, smem_bytes<32>(H, block, nc), s);
    default: return (int)cudaErrorInvalidValue;
  }
}
