// K5: the continuous-adjoint (backsolve) backward integration of a TEST-mode
// CNF whose field is a 2-layer tanh MLP with the exact trace, the whole
// adaptive solve (any embedded explicit tableau, K9) from t_hi down to t_lo
// in one cooperative launch.  Two compile-time instances: an unconditional
// net, and a conditional one (COND: the first layer reads [z | ys], K8).
//
// Replaces the TPU kernel built by continuousnf_tpu/ops/fused_solve.py::
// _make_adjoint_kernel (:1064-1343), launched by make_full_solve.adjoint_solve
// (pl.pallas_call at :1767), with the _stage_test_fwdbwd stage (:506-539) and,
// for a conditional net, its ys rows (:533-537) and the a_ys block
// (:1131-1183).  It serves every gradient through a TEST solve of a 2-layer
// net: the exact-trace maximum-likelihood loss, the score of
// ICNFDist.logpdf and gradients through TEST `generate`.  The state is, per
// sample, z (dz), dlogp (1), a_z (dz), the constant a_dlogp (1) and, COND,
// a_ys (nc), plus the batch-summed parameter gradient g_p of
// [W1 ((dz + nc) x H) | b1 | W2 (H x dz) | b2].  Each stage runs the TEST
// field forward, h = tanh([z | ys] W1 + b1), y = tanh(h W2 + b2),
// tr = sum_i dy_i (m dh)_i with m[i, h] = W1[i, h] W2[h, i] over the z rows,
// and its hand-derived VJP against (a_z, a_dlogp): with ct_tr = -a_dlogp,
//   ct_mdh = dy ct_tr, ct_dy = (m dh) ct_tr, ct_dh = m^T ct_mdh,
//   ct_pre2 = (a_z - 2 y ct_dy) dy, ct_pre1 = (W2 ct_pre2 - 2 h ct_dh) dh,
//   k_az = -W1z ct_pre1, k_ays = -W1y ct_pre1 (COND),
// and the parameter cotangents: W1 gets zin (x) ct_pre1 plus the fold
// ct_m * W2^T on its z rows, W2 gets h (x) ct_pre2 plus (ct_m * W1z)^T,
// where ct_m = ct_mdh (x) dh.  The fold is linear in ct_m, so the block sums
// ct_m over its samples first and multiplies by the weight once per entry
// (dz H products a block instead of dz H a sample; only the rounding moves).
// The error norm covers g_p with the fold applied, as the TPU kernel
// integrates it.
//
// The solve loop is solve_common.cuh's adjoint_solve with one accumulator
// row (NACC = 1), shared with K2, the K4 adjoint and the K2 chain form: one
// batch-global Hairer norm over B * (2 * (dz + 1) + nc) + P elements, with
// each block's partials of the b- and btilde-weighted g_p sums in
// parity-indexed global buffers, one grid.sync() per attempted step, and
// every block adding all blocks' partials in block order.  g_p, its
// proposal and the block's stage-1 and last-stage partials (4 P floats) live
// in shared memory.
//
// What bounds it on the H100: latency.  A stage is about 6 dz H FMA per
// sample (the forward, m dh, m^T ct_mdh, W2 ct_pre2, W1 ct_pre1) plus the
// outer products of P + dz H entries (7.0 k FMA at dz = 16, H = 48); the
// time goes to the dependent chains of one thread per sample, the block's
// outer-product pass, and one grid barrier per attempted step.  m is built
// once per launch into shared memory beside W1 and W2 (each (H, DZ), read as
// float4 broadcasts); one sample's H-vectors (h and ct_pre1) and the dz
// vectors the outer-product pass reads live in a per-thread slot of shared
// memory (odd stride), so the stage keeps only dz-sized vectors in
// registers.
// Precision: f32 FMA on the CUDA cores, no TF32 and no tensor cores.

#include "solve_common.cuh"

namespace {

// The unroll factor of the solve loops over stored stages (solve_common.cuh),
// K2's, which shares this loop and the stage's shape.
constexpr int kStageUnroll = 4;

using cnf::axpy4;
using cnf::dot4;
using cnf::kMaxBlock;
using cnf::kRedFloats;

struct AdjArgs {
  cnf::AdjState s;
  const float* w1;    // (dz + nc, H)
  const float* b1;    // (H)
  const float* w2;    // (H, dz)
  const float* b2;    // (dz)
  const float* ys;    // (B, nc) conditioning, null when nc = 0
  float* gw1;         // (dz + nc, H)
  float* gb1;         // (H)
  float* gw2;         // (H, dz)
  float* gb2;         // (dz)
  int H;
};

// Offsets in a thread's shared-memory slot: three dz-vectors (z, ct_mdh,
// ct_pre2), then two H-vectors (h, ct_pre1).
template <int DZ>
struct Slot {
  int z, ctm, ca1, h, ca, size;
  __device__ __host__ explicit Slot(int H) {
    z = 0; ctm = DZ; ca1 = 2 * DZ; h = 3 * DZ; ca = h + H;
    size = (ca + H) | 1;
  }
};

struct Weights {
  const float* w1t;  // (H, DZ): w1t[j][i] = w1[i][j], the z rows
  const float* w2p;  // (H, DZ): w2p[j][k] = w2[j][k]
  const float* mt;   // (H, DZ): mt[j][i] = w1[i][j] w2[j][i]
  const float* b1;   // (H)
  const float* b2p;  // (DZ)
  const float* wy;   // (H, nc): wy[j][c] = w1[dz + c][j], the ys rows (COND)
  int H, dz, nc;
};

// One augmented stage of one sample (fused_solve.py::_stage_test_fwdbwd with
// ct_y = a_z, ct_r = a_dlogp): the field y and the rate -tr, k_az = -ct_z,
// COND k_ays = -ct_ys to kys[c * stride], and the vectors the gradient pass
// reads, left in the slot `sl`.  Columns i >= dz of the padded weights are
// zero, so the padded entries add nothing.
template <int DZ, bool COND>
__device__ void test_adjoint_stage(const Weights& w, float* sl, const float* ys, const float (&z)[DZ],
                                   const float (&az)[DZ], float aacc, float (&kz)[DZ], float& kr,
                                   float (&kaz)[DZ], float* kys, size_t stride) {
  const Slot<DZ> o(w.H);
  const int H = w.H;
  // Forward: h = tanh([z | ys] W1 + b1), y = tanh(h W2 + b2), m dh.
  float y[DZ], mdh[DZ];
#pragma unroll
  for (int k = 0; k < DZ; ++k) {
    y[k] = w.b2p[k];
    mdh[k] = 0.f;
  }
  for (int j = 0; j < H; ++j) {
    float pre = dot4<DZ>(z, w.w1t + j * DZ) + w.b1[j];
    if constexpr (COND) {
      for (int c = 0; c < w.nc; ++c) pre = fmaf(ys[c], w.wy[j * w.nc + c], pre);
    }
    const float h = tanhf(pre);
    sl[o.h + j] = h;
    axpy4<DZ>(y, h, w.w2p + j * DZ);
    axpy4<DZ>(mdh, 1.f - h * h, w.mt + j * DZ);
  }
  // tr = sum_i dy_i (m dh)_i; ct_tr = -a_dlogp (the rate is -tr).  Then
  // ct_mdh = dy ct_tr, ct_dy = (m dh) ct_tr, ct_pre2 = (a_z - 2 y ct_dy) dy.
  const float ct_tr = -aacc;
  float tr = 0.f, ctm[DZ], ca1[DZ];
#pragma unroll
  for (int k = 0; k < DZ; ++k) {
    y[k] = tanhf(y[k]);
    const float dy = 1.f - y[k] * y[k];
    tr = fmaf(dy, mdh[k], tr);
    ctm[k] = dy * ct_tr;
    ca1[k] = (az[k] + (-2.f * y[k]) * (mdh[k] * ct_tr)) * dy;
    sl[o.z + k] = z[k];
    sl[o.ctm + k] = ctm[k];
    sl[o.ca1 + k] = ca1[k];
    kz[k] = y[k];
  }
  kr = -tr;
  // ct_h = W2 ct_pre2 - 2 h (m^T ct_mdh), ct_pre1 = ct_h (1 - h^2), ct_z = W1z ct_pre1.
  float cz[DZ];
#pragma unroll
  for (int i = 0; i < DZ; ++i) cz[i] = 0.f;
  for (int j = 0; j < H; ++j) {
    const float h = sl[o.h + j];
    const float ct_h = dot4<DZ>(ca1, w.w2p + j * DZ) + (-2.f * h) * dot4<DZ>(ctm, w.mt + j * DZ);
    const float ca = ct_h * (1.f - h * h);
    sl[o.ca + j] = ca;
    axpy4<DZ>(cz, ca, w.w1t + j * DZ);
  }
#pragma unroll
  for (int i = 0; i < DZ; ++i) kaz[i] = -cz[i];
  if constexpr (COND) {
    // The ys rows: k_ays = -ct_pre1 W1y^T.
    for (int c = 0; c < w.nc; ++c) {
      float a = 0.f;
      for (int j = 0; j < H; ++j) a = fmaf(sl[o.ca + j], w.wy[j * w.nc + c], a);
      kys[c * stride] = -a;
    }
  }
}

// The block's sum over its first `nvalid` samples (thread order, samples
// base ..) of the negated parameter-gradient rate of the stage just
// evaluated, entry p of [W1 (dz + nc, H) | b1 | W2 (H, dz) | b2]: the outer
// products, and for the z rows of W1 and for W2 the fold of ct_m, summed
// over the block first.
template <int DZ>
__device__ __forceinline__ float block_grad_entry(const Weights& w, const float* slots, const float* ys, int p,
                                                  int base, int nvalid) {
  const int dz = w.dz, H = w.H, nc = w.nc;
  const Slot<DZ> o(H);
  const int din = dz + nc;
  float v = 0.f, cm = 0.f;
  if (p < din * H) {
    const int i = p / H, j = p % H;
    if (i >= dz) {
      // A ys row: ys (x) ct_pre1.
      for (int t = 0; t < nvalid; ++t) v = fmaf(ys[(size_t)(base + t) * nc + (i - dz)], slots[t * o.size + o.ca + j], v);
      return -v;
    }
    for (int t = 0; t < nvalid; ++t) {
      const float* sl = slots + t * o.size;
      const float h = sl[o.h + j];
      v = fmaf(sl[o.z + i], sl[o.ca + j], v);
      cm = fmaf(sl[o.ctm + i], 1.f - h * h, cm);
    }
    return -fmaf(w.w2p[j * DZ + i], cm, v);
  }
  if (p < din * H + H) {
    const int j = p - din * H;
    for (int t = 0; t < nvalid; ++t) v += slots[t * o.size + o.ca + j];
    return -v;
  }
  if (p < din * H + H + H * dz) {
    const int q = p - din * H - H;
    const int j = q / dz, k = q % dz;
    for (int t = 0; t < nvalid; ++t) {
      const float* sl = slots + t * o.size;
      const float h = sl[o.h + j];
      v = fmaf(h, sl[o.ca1 + k], v);
      cm = fmaf(sl[o.ctm + k], 1.f - h * h, cm);
    }
    return -fmaf(w.w1t[j * DZ + k], cm, v);
  }
  const int k = p - din * H - H - H * dz;
  for (int t = 0; t < nvalid; ++t) v += slots[t * o.size + o.ca1 + k];
  return -v;
}

// The stage and gradient callbacks of cnf::adjoint_solve.
template <int DZ, bool COND>
struct Stage {
  Weights w;
  const float* ys;  // (B, nc)
  float* sl;        // this thread's slot
  int B;
  __device__ void operator()(int s, const float (&z)[DZ], const float (&az)[DZ], const float (&aacc)[1],
                             float (&kz)[DZ], float (&kr)[1], float (&kaz)[DZ], float* kys) const {
    test_adjoint_stage<DZ, COND>(w, sl, COND ? ys + (size_t)s * w.nc : nullptr, z, az, aacc[0], kz, kr[0], kaz,
                                 kys, (size_t)B);
  }
};

template <int DZ>
struct Grad {
  Weights w;
  const float* slots;
  const float* ys;
  __device__ float operator()(int q, int base, int nvalid) const {
    return block_grad_entry<DZ>(w, slots, ys, q, base, nvalid);
  }
};

// The gradient's floats: [W1 (dz + nc, H) | b1 | W2 (H, dz) | b2].
__host__ __device__ inline int grad_floats(int dz, int H, int nc) { return (dz + nc) * H + H + H * dz + dz; }

// The gradient's output from block 0's copy.
__device__ void store_grad(const float* gp, int din, int dz, int H, float* gw1, float* gb1, float* gw2, float* gb2) {
  const int P = grad_floats(dz, H, din - dz);
  for (int q = threadIdx.x; q < P; q += blockDim.x) {
    const float g = gp[q];
    if (q < din * H) {
      gw1[q] = g;
    } else if (q < din * H + H) {
      gb1[q - din * H] = g;
    } else if (q < din * H + H + H * dz) {
      gw2[q - din * H - H] = g;
    } else {
      gb2[q - din * H - H - H * dz] = g;
    }
  }
}

template <int DZ, bool COND>
__global__ void __launch_bounds__(kMaxBlock) k5_test_adjoint(const AdjArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int H = p.H, dz = p.s.dz, nc = COND ? p.s.nc : 0;
  const int P = grad_floats(dz, H, nc);
  float* w1t = smem;               // (H, DZ)
  float* w2p = w1t + H * DZ;       // (H, DZ)
  float* mt = w2p + H * DZ;        // (H, DZ)
  float* b2p = mt + H * DZ;        // (DZ)
  float* b1 = b2p + DZ;            // (H)
  float* wy = b1 + H;              // (H, nc)
  float* red = wy + H * nc;        // kRedFloats
  float* gp = red + kRedFloats;    // (P) g_p, the same in every block
  float* gnew = gp + P;            // (P) the proposed g_p
  float* K1p = gnew + P;           // (P) this block's stage-1 rate
  float* K7p = K1p + P;            // (P) this block's last-stage rate
  float* slots = K7p + P;          // blockDim.x slots
  const Slot<DZ> o(H);
  cnf::load_weights<DZ>(p.w1, p.b1, p.w2, p.b2, dz, H, w1t, w2p, b2p, b1);
  // m, once per launch (each entry from the same thread that loaded it).
  for (int idx = threadIdx.x; idx < H * DZ; idx += blockDim.x) mt[idx] = w1t[idx] * w2p[idx];
  for (int idx = threadIdx.x; idx < H * nc; idx += blockDim.x) {
    const int j = idx / nc, c = idx % nc;
    wy[idx] = p.w1[(size_t)(dz + c) * H + j];
  }
  __syncthreads();
  const Weights w{w1t, w2p, mt, b1, b2p, wy, H, dz, nc};
  const Stage<DZ, COND> stage{w, p.ys, slots + threadIdx.x * o.size, p.s.B};
  const Grad<DZ> grad{w, slots, p.ys};
  cnf::adjoint_solve<DZ, COND, kStageUnroll, false, 1>(p.s, stage, grad, P, gp, gnew, K1p, K7p, red);
  if (blockIdx.x == 0) store_grad(gp, dz + nc, dz, H, p.gw1, p.gb1, p.gw2, p.gb2);
}

template <int DZ>
size_t smem_bytes(int dz, int H, int nc, int block) {
  return sizeof(float) * (3 * (size_t)H * DZ + DZ + H + (size_t)H * nc + kRedFloats +
                          4 * (size_t)grad_floats(dz, H, nc) + (size_t)block * Slot<DZ>(H).size);
}

// The instance for the padded width and conditioning: f<DZ, COND>() of a
// functor, `fail` for a width past 32.
template <class F, class R>
R dispatch(int dz, int nc, const F& f, R fail) {
  const bool cond = nc > 0;
  switch (cnf::padded_dz(dz)) {
    case 4: return cond ? f.template operator()<4, true>() : f.template operator()<4, false>();
    case 8: return cond ? f.template operator()<8, true>() : f.template operator()<8, false>();
    case 16: return cond ? f.template operator()<16, true>() : f.template operator()<16, false>();
    case 32: return cond ? f.template operator()<32, true>() : f.template operator()<32, false>();
    default: return fail;
  }
}

struct SmemOf {
  int dz, H, nc, block;
  template <int DZ, bool COND>
  long long operator()() const {
    return (long long)smem_bytes<DZ>(dz, H, nc, block);
  }
};

struct MaxGrid {
  int dz, H, nc, block;
  int* out;
  template <int DZ, bool COND>
  int operator()() const {
    return (int)cnf::coop_max_grid(k5_test_adjoint<DZ, COND>, smem_bytes<DZ>(dz, H, nc, block), block, out);
  }
};

struct Launch {
  AdjArgs a;
  int grid, block;
  cudaStream_t s;
  template <int DZ, bool COND>
  int operator()() const {
    return (int)cnf::coop_launch(k5_test_adjoint<DZ, COND>, a, grid, block,
                                 smem_bytes<DZ>(a.s.dz, a.H, a.s.nc, block), s);
  }
};

}  // namespace

// Dynamic shared memory of one block (bytes), 0 for an unsupported dz.
extern "C" long long cnf_k5_smem_bytes(int dz, int H, int nc, int block) {
  return dispatch(dz, nc, SmemOf{dz, H, nc, block}, 0LL);
}

// Largest co-resident grid for a cooperative launch (0 if none).
extern "C" int cnf_k5_max_grid(int dz, int H, int nc, int block, int* out) {
  *out = 0;
  return dispatch(dz, nc, MaxGrid{dz, H, nc, block, out}, (int)cudaErrorInvalidValue);
}

// w1/gw1: (dz + nc, H); ys, ays0: (B, nc), null when nc = 0; zT, azT, z0,
// az0: (B, dz); accT/aaccT/acc0: (1, B).  work: (S + 2) (2 dz + 1 + nc) B
// floats; gpart: 2 * grid * NG * P (NG = 3 for a tableau with btilde3, else
// 2).  tab: kTableauFloats floats (read_tableau).  Returns the launch's
// cudaError_t.
extern "C" int cnf_k5_test_adjoint(const float* w1, const float* b1, const float* w2, const float* b2,
                                   const float* ys, const float* zT, const float* accT, const float* azT,
                                   const float* aaccT, const float* ts, float* z0, float* acc0, float* az0,
                                   float* ays0, float* gw1, float* gb1, float* gw2, float* gb2, int* stats,
                                   float* work, float* partials, float* gpart, int B, int dz, int H, int nc,
                                   int max_steps, float rtol, float atol, float beta1, float beta2, float inv_order,
                                   const float* tab, int grid, int block, void* stream) {
  if (block < 32 || block > kMaxBlock || block % 32 != 0 || grid < 1 || nc < 0 || (nc > 0) != (ys != nullptr))
    return (int)cudaErrorInvalidValue;
  AdjArgs a = {};
  cnf::set_adj_state(&a.s, zT, accT, azT, aaccT, ts, z0, acc0, az0, stats, work, partials, gpart, B,
                     dz, max_steps, rtol, atol, beta1, beta2, inv_order, tab);
  a.s.nc = nc;
  a.s.ays0 = ays0;
  a.w1 = w1; a.b1 = b1; a.w2 = w2; a.b2 = b2; a.ys = ys;
  a.gw1 = gw1; a.gb1 = gb1; a.gw2 = gw2; a.gb2 = gb2;
  a.H = H;
  return dispatch(dz, nc, Launch{a, grid, block, (cudaStream_t)stream}, (int)cudaErrorInvalidValue);
}
