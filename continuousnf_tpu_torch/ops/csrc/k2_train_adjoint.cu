// K2: the continuous-adjoint (backsolve) backward integration of a TRAIN-mode
// CNF whose field is a 2-layer tanh MLP with one Hutchinson probe (reverse
// mode), the whole adaptive tsit5 solve from t_hi down to t_lo in one
// cooperative launch.
//
// Replaces the TPU kernel built by continuousnf_tpu/ops/fused_solve.py::
// _make_adjoint_kernel (:1064-1343), launched by make_full_solve.adjoint_solve
// (pl.pallas_call at :1767), with the _stage_train_fwdbwd stage (:372-481).
// The state is, per sample, z (dz), acc (3: dlogp, reg_e, reg_n), a_z (dz)
// and the constant a_acc (3), plus the batch-summed parameter gradient g_p
// (P = 2 dz H + H + dz floats).  Each stage runs the TRAIN field forward
// (h, y, the probe pullback eJ, the rates) and its hand-derived VJP against
// (a_z, a_acc): the rates of z and acc, k_az = -dz/dz^T a, and the per-sample
// parameter cotangents, rank-2 outer products that the block sums over its
// samples in a fixed order.  The probes are Monte-Carlo constants: no eps
// cotangent is integrated.
//
// The error norm is batch-global and covers g_p, as in the TPU kernel with
// one batch tile (its per-tile controllers are not ported: they change the
// numerics): sqrt(sum / n) over n = B * 2 * (dz + 3) + P elements, where the
// g_p entries are scaled by atol + rtol * max(|g_p|, |g_p_new|) of the
// batch-summed values.  So every attempted step needs, besides the per-sample
// sums of squares, the grid-wide sums of dt * sum_i b_i k_gp,i and
// dt * sum_i btilde_i k_gp,i (2 P floats per block).  Each block writes its
// two P-vectors and its partial sum into parity-indexed buffers, one
// grid.sync(), and then every block adds all blocks' vectors in block order
// and reduces the g_p error in one fixed thread order: every block holds the
// same g_p and takes the same decision.  FSAL carries each block's own
// partial of the last stage's g_p rate (the sum is linear in the samples).
//
// What bounds it on the H100: latency.  A stage is about 8 dz H FMA per
// sample plus 2 P FMA per sample for the outer products; the time goes to
// the dependent chains of one thread per sample, the block's outer-product
// pass, and one grid barrier (with a 2 P * G-float read) per attempted step.
// Registers: one sample's residuals (h, u1, v0, the cotangents) are ~5 H +
// 4 dz floats; they live in a per-thread slot of shared memory (odd stride:
// conflict-free for the owning thread and for the outer-product pass, which
// reads one entry of every thread's slot), so the stage itself keeps only
// dz-sized vectors in registers.
// Precision: f32 FMA on the CUDA cores, no TF32 and no tensor cores.

#include "solve_common.cuh"

namespace {

namespace cg = cooperative_groups;
using cnf::kMaxBlock;
using cnf::kRedFloats;
using cnf::kStages;
using cnf::Tableau;

struct AdjArgs {
  const float* w1;    // (dz, H)
  const float* b1;    // (H)
  const float* w2;    // (H, dz)
  const float* b2;    // (dz)
  const float* eps;   // (B, dz) Hutchinson probe
  const float* zT;    // (B, dz) state at t_hi
  const float* accT;  // (3, B)
  const float* azT;   // (B, dz) cotangent of z at t_hi
  const float* aaccT; // (3, B) cotangent of acc (constant)
  const float* ts;    // t_hi, t_lo, dt_init
  float* z0;          // (B, dz) state at t_lo
  float* acc0;        // (3, B)
  float* az0;         // (B, dz)
  float* gw1;         // (dz, H)
  float* gb1;         // (H)
  float* gw2;         // (H, dz)
  float* gb2;         // (dz)
  int* stats;         // attempted, accepted
  float* work;        // (kStages + 2) * (2 dz + 3) * B
  float* partials;    // [parity][sum | flag][gridDim.x]
  float* gpart;       // [parity][gridDim.x][2 P]
  int B, dz, H, max_steps, norm_z, norm_j;
  float rtol, atol, beta1, beta2, inv_order;
  Tableau tab;
};

// Offsets in a thread's shared-memory slot: four dz-vectors, then five
// H-vectors (Hu holds u1 and then the -2 h (ct_v0 u1) term).
template <int DZ>
struct Slot {
  int cte, z, v1, ca1, h, u, v0, cu, ca, size;
  __device__ __host__ explicit Slot(int H) {
    cte = 0; z = DZ; v1 = 2 * DZ; ca1 = 3 * DZ;
    h = 4 * DZ; u = h + H; v0 = u + H; cu = v0 + H; ca = cu + H;
    size = (ca + H) | 1;
  }
};

__device__ __forceinline__ float safe_norm_sq(float sq) { return sq > 0.f ? sqrtf(sq) : 0.f; }
__device__ __forceinline__ float ct_safe_norm(float ct, float norm) { return norm > 0.f ? ct / norm : 0.f; }

template <int DZ>
__device__ __forceinline__ float dot4(const float (&v)[DZ], const float* w) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
  for (int q = 0; q < DZ / 4; ++q) {
    const float4 x = w4[q];
    a0 = fmaf(v[4 * q + 0], x.x, a0);
    a1 = fmaf(v[4 * q + 1], x.y, a1);
    a2 = fmaf(v[4 * q + 2], x.z, a2);
    a3 = fmaf(v[4 * q + 3], x.w, a3);
  }
  return (a0 + a1) + (a2 + a3);
}

template <int DZ>
__device__ __forceinline__ void axpy4(float (&acc)[DZ], float c, const float* w) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int q = 0; q < DZ / 4; ++q) {
    const float4 x = w4[q];
    acc[4 * q + 0] = fmaf(x.x, c, acc[4 * q + 0]);
    acc[4 * q + 1] = fmaf(x.y, c, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(x.z, c, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(x.w, c, acc[4 * q + 3]);
  }
}

struct Weights {
  const float* w1t;  // (H, DZ): w1t[j][i] = w1[i][j]
  const float* w2p;  // (H, DZ): w2p[j][k] = w2[j][k]
  const float* b1;   // (H)
  const float* b2p;  // (DZ)
  int H, dz, norm_z, norm_j;
};

// One augmented stage of one sample (fused_solve.py::_stage_train_fwdbwd with
// ct_y = a_z, ct_r = a_acc): the field y and rates kr, k_az = -ct_z, and the
// residuals the outer-product pass reads, left in the slot `sl`.
template <int DZ>
__device__ void adjoint_stage(const Weights& w, float* sl, const float (&z)[DZ],
                              const float (&az)[DZ], const float (&e)[DZ], const float (&aacc)[3],
                              float (&kz)[DZ], float (&kr)[3], float (&kaz)[DZ]) {
  const Slot<DZ> o(w.H);
  const int H = w.H;
  // Forward: h = tanh(z W1 + b1), y = tanh(h W2 + b2).
  float y[DZ];
#pragma unroll
  for (int k = 0; k < DZ; ++k) y[k] = w.b2p[k];
  for (int j = 0; j < H; ++j) {
    const float h = tanhf(dot4<DZ>(z, w.w1t + j * DZ) + w.b1[j]);
    sl[o.h + j] = h;
    axpy4<DZ>(y, h, w.w2p + j * DZ);
  }
  float v1[DZ], ysq = 0.f;
#pragma unroll
  for (int k = 0; k < DZ; ++k) {
    y[k] = tanhf(y[k]);
    ysq = fmaf(y[k], y[k], ysq);
    v1[k] = e[k] * (1.f - y[k] * y[k]);
    sl[o.z + k] = z[k];
    sl[o.v1 + k] = v1[k];
  }
  // The probe pullback: u1 = W2 v1, v0 = u1 (1 - h^2), eJ = W1 v0.
  float eJ[DZ];
#pragma unroll
  for (int i = 0; i < DZ; ++i) eJ[i] = 0.f;
  for (int j = 0; j < H; ++j) {
    const float u1 = dot4<DZ>(v1, w.w2p + j * DZ);
    const float h = sl[o.h + j];
    const float v0 = u1 * (1.f - h * h);
    sl[o.u + j] = u1;
    sl[o.v0 + j] = v0;
    axpy4<DZ>(eJ, v0, w.w1t + j * DZ);
  }
  float tr = 0.f, nsq = 0.f;
#pragma unroll
  for (int i = 0; i < DZ; ++i) {
    tr = fmaf(eJ[i], e[i], tr);
    nsq = fmaf(eJ[i], eJ[i], nsq);
  }
  const float e_rate = safe_norm_sq(ysq), n_rate = safe_norm_sq(nsq);
  kr[0] = -tr;
  kr[1] = w.norm_z ? e_rate : 0.f;
  kr[2] = w.norm_j ? n_rate : 0.f;

  // Backward.  Rates row 0 is -tr: ct_tr = -a_acc[0].
  const float ct_tr = -aacc[0];
  const float fz = w.norm_z ? ct_safe_norm(aacc[1], e_rate) : 0.f;
  const float fn = w.norm_j ? ct_safe_norm(aacc[2], n_rate) : 0.f;
  float cte[DZ];
#pragma unroll
  for (int i = 0; i < DZ; ++i) {
    cte[i] = fmaf(eJ[i], fn, e[i] * ct_tr);
    sl[o.cte + i] = cte[i];
  }
  // Up the pullback chain: ct_v0 = W1^T ct_eJ, ct_u1 = ct_v0 (1 - h^2),
  // ct_h1 += -2 h (ct_v0 u1); ct_v1 = W2^T ct_u1.
  float cv1[DZ];
#pragma unroll
  for (int k = 0; k < DZ; ++k) cv1[k] = 0.f;
  for (int j = 0; j < H; ++j) {
    const float h = sl[o.h + j];
    const float cv0 = dot4<DZ>(cte, w.w1t + j * DZ);
    const float cu = cv0 * (1.f - h * h);
    sl[o.cu + j] = cu;
    sl[o.u + j] = (-2.f * h) * (cv0 * sl[o.u + j]);
    axpy4<DZ>(cv1, cu, w.w2p + j * DZ);
  }
  // The output layer: ct_h = a_z + y fz - 2 y (ct_v1 eps), ct_a1 = ct_h (1 - y^2).
  float ca1[DZ];
#pragma unroll
  for (int k = 0; k < DZ; ++k) {
    const float ct_h = (fmaf(y[k], fz, az[k])) + (-2.f * y[k]) * (cv1[k] * e[k]);
    ca1[k] = ct_h * (1.f - y[k] * y[k]);
    sl[o.ca1 + k] = ca1[k];
    kz[k] = y[k];
  }
  // Down the forward chain: ct_h1 = W2 ct_a1 + (the pullback term),
  // ct_a0 = ct_h1 (1 - h^2), ct_z = W1 ct_a0.
  float cz[DZ];
#pragma unroll
  for (int i = 0; i < DZ; ++i) cz[i] = 0.f;
  for (int j = 0; j < H; ++j) {
    const float h = sl[o.h + j];
    const float ca = (dot4<DZ>(ca1, w.w2p + j * DZ) + sl[o.u + j]) * (1.f - h * h);
    sl[o.ca + j] = ca;
    axpy4<DZ>(cz, ca, w.w1t + j * DZ);
  }
#pragma unroll
  for (int i = 0; i < DZ; ++i) kaz[i] = -cz[i];
}

// Zero a slot (a thread without a sample adds nothing to the outer products).
template <int DZ>
__device__ void clear_slot(float* sl, int H) {
  const Slot<DZ> o(H);
  for (int i = 0; i < o.size; ++i) sl[i] = 0.f;
}

// The block's sum over its samples of the (negated) parameter-gradient rate
// of the stage just evaluated, entry p of [W1 (dz, H) | b1 | W2 (H, dz) | b2];
// each thread takes entries p = threadIdx.x + k * blockDim.x, and sums over
// the block's slots in thread order.
template <int DZ>
__device__ __forceinline__ float block_grad_entry(const float* slots, int p, int dz, int H) {
  const Slot<DZ> o(H);
  const int nb = blockDim.x;
  float v = 0.f;
  if (p < dz * H) {
    const int i = p / H, j = p % H;
    for (int t = 0; t < nb; ++t) {
      const float* sl = slots + t * o.size;
      v = fmaf(sl[o.cte + i], sl[o.v0 + j], v);
      v = fmaf(sl[o.z + i], sl[o.ca + j], v);
    }
  } else if (p < dz * H + H) {
    const int j = p - dz * H;
    for (int t = 0; t < nb; ++t) v += slots[t * o.size + o.ca + j];
  } else if (p < 2 * dz * H + H) {
    const int q = p - dz * H - H;
    const int j = q / dz, k = q % dz;
    for (int t = 0; t < nb; ++t) {
      const float* sl = slots + t * o.size;
      v = fmaf(sl[o.cu + j], sl[o.v1 + k], v);
      v = fmaf(sl[o.h + j], sl[o.ca1 + k], v);
    }
  } else {
    const int k = p - 2 * dz * H - H;
    for (int t = 0; t < nb; ++t) v += slots[t * o.size + o.ca1 + k];
  }
  return -v;
}

template <int DZ>
__global__ void __launch_bounds__(kMaxBlock) k2_train_adjoint(const AdjArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int H = p.H, dz = p.dz, B = p.B;
  const int P = 2 * dz * H + H + dz;
  float* w1t = smem;               // (H, DZ)
  float* w2p = w1t + H * DZ;       // (H, DZ)
  float* b2p = w2p + H * DZ;       // (DZ)
  float* b1 = b2p + DZ;            // (H)
  float* red = b1 + H;             // kRedFloats
  float* gp = red + kRedFloats;    // (P) g_p, the same in every block
  float* GB = gp + P;              // (P) this block's dt sum_i b_i k_gp,i; then g_p_new
  float* GE = GB + P;              // (P) this block's dt sum_i btilde_i k_gp,i
  float* K1p = GE + P;             // (P) this block's FSAL stage rate
  float* K7p = K1p + P;            // (P) this block's last-stage rate
  float* slots = K7p + P;          // blockDim.x slots
  const Slot<DZ> o(H);
  float* sl = slots + threadIdx.x * o.size;

  for (int idx = threadIdx.x; idx < H * DZ; idx += blockDim.x) {
    const int j = idx / DZ, i = idx % DZ;
    w1t[idx] = i < dz ? p.w1[(size_t)i * H + j] : 0.f;
    w2p[idx] = i < dz ? p.w2[(size_t)j * dz + i] : 0.f;
  }
  for (int k = threadIdx.x; k < DZ; k += blockDim.x) b2p[k] = k < dz ? p.b2[k] : 0.f;
  for (int j = threadIdx.x; j < H; j += blockDim.x) b1[j] = p.b1[j];
  for (int q = threadIdx.x; q < P; q += blockDim.x) {
    gp[q] = 0.f;
    K1p[q] = 0.f;
  }
  __syncthreads();
  const Weights w{w1t, w2p, b1, b2p, H, dz, p.norm_z, p.norm_j};

  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x;
  const int nthr = G * blockDim.x;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int rounds = (B + nthr - 1) / nthr;
  const int R = 2 * dz + 3;         // rows: z, acc, a_z
  const size_t RB = (size_t)R * B;  // one (row, B) plane
  float* Y = p.work;
  float* Yn = Y + RB;
  float* K = Yn + RB;

  // One sample's stage inputs: the probe and the constant a_acc.
  auto load_consts = [&](int s, float (&e)[DZ], float (&aacc)[3]) {
#pragma unroll
    for (int i = 0; i < DZ; ++i) e[i] = i < dz ? p.eps[(size_t)s * dz + i] : 0.f;
#pragma unroll
    for (int r = 0; r < 3; ++r) aacc[r] = p.aaccT[(size_t)r * B + s];
  };
  auto store_stage = [&](float* kst, int s, const float (&kz)[DZ], const float (&kr)[3],
                         const float (&kaz)[DZ]) {
#pragma unroll
    for (int i = 0; i < DZ; ++i) {
      if (i < dz) {
        kst[(size_t)i * B + s] = kz[i];
        kst[(size_t)(dz + 3 + i) * B + s] = kaz[i];
      }
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) kst[(size_t)(dz + r) * B + s] = kr[r];
  };

  // Initial state and the first stage (its g_p rate partial into K1p).
  for (int rd = 0; rd < rounds; ++rd) {
    const int s = gtid + rd * nthr;
    if (s < B) {
      float z[DZ], az[DZ], e[DZ], aacc[3], kz[DZ], kr[3], kaz[DZ];
#pragma unroll
      for (int i = 0; i < DZ; ++i) {
        z[i] = i < dz ? p.zT[(size_t)s * dz + i] : 0.f;
        az[i] = i < dz ? p.azT[(size_t)s * dz + i] : 0.f;
      }
      load_consts(s, e, aacc);
      adjoint_stage<DZ>(w, sl, z, az, e, aacc, kz, kr, kaz);
      for (int i = 0; i < dz; ++i) {
        Y[(size_t)i * B + s] = z[i];
        Y[(size_t)(dz + 3 + i) * B + s] = az[i];
      }
      for (int r = 0; r < 3; ++r) Y[(size_t)(dz + r) * B + s] = p.accT[(size_t)r * B + s];
      store_stage(K, s, kz, kr, kaz);
    } else {
      clear_slot<DZ>(sl, H);
    }
    __syncthreads();
    for (int q = threadIdx.x; q < P; q += blockDim.x) K1p[q] += block_grad_entry<DZ>(slots, q, dz, H);
    __syncthreads();
  }

  cnf::Controller c;
  c.init(p.ts, p.beta1, p.beta2, p.inv_order);
  const float n_elems = (float)B * (float)(2 * (dz + 3)) + (float)P;

  while (c.running(p.max_steps)) {
    bool is_last;
    const float dt_use = c.plan(&is_last);
    const float cb0 = dt_use * p.tab.b[0], ce0 = dt_use * p.tab.btilde[0];
    for (int q = threadIdx.x; q < P; q += blockDim.x) {
      GB[q] = cb0 * K1p[q];
      GE[q] = ce0 * K1p[q];
      K7p[q] = 0.f;
    }

    for (int st = 1; st < kStages; ++st) {
      for (int rd = 0; rd < rounds; ++rd) {
        const int s = gtid + rd * nthr;
        if (s < B) {
          float z[DZ], az[DZ], e[DZ], aacc[3], kz[DZ], kr[3], kaz[DZ];
#pragma unroll
          for (int i = 0; i < DZ; ++i) {
            z[i] = i < dz ? Y[(size_t)i * B + s] : 0.f;
            az[i] = i < dz ? Y[(size_t)(dz + 3 + i) * B + s] : 0.f;
          }
          for (int j = 0; j < st; ++j) {
            if (p.tab.a[st][j] != 0.f) {
              const float cf = dt_use * p.tab.a[st][j];
              const float* kj = K + j * RB;
#pragma unroll
              for (int i = 0; i < DZ; ++i) {
                if (i < dz) {
                  z[i] = fmaf(cf, kj[(size_t)i * B + s], z[i]);
                  az[i] = fmaf(cf, kj[(size_t)(dz + 3 + i) * B + s], az[i]);
                }
              }
            }
          }
          load_consts(s, e, aacc);
          adjoint_stage<DZ>(w, sl, z, az, e, aacc, kz, kr, kaz);
          store_stage(K + st * RB, s, kz, kr, kaz);
        } else {
          clear_slot<DZ>(sl, H);
        }
        __syncthreads();
        const float cb = dt_use * p.tab.b[st], ce = dt_use * p.tab.btilde[st];
        const bool last = st == kStages - 1;
        for (int q = threadIdx.x; q < P; q += blockDim.x) {
          const float g = block_grad_entry<DZ>(slots, q, dz, H);
          if (p.tab.b[st] != 0.f) GB[q] = fmaf(cb, g, GB[q]);
          if (p.tab.btilde[st] != 0.f) GE[q] = fmaf(ce, g, GE[q]);
          if (last) K7p[q] += g;
        }
        __syncthreads();
      }
    }

    // Per-sample proposals and errors: z, acc and a_z rows (a_acc is
    // constant: zero error, but counted in n_elems).
    float sumsq = 0.f;
    bool finite = true;
    for (int s = gtid; s < B; s += nthr) {
      for (int r = 0; r < R; ++r) {
        const size_t off = (size_t)r * B + s;
        const float y = Y[off];
        float yn = y, err = 0.f;
#pragma unroll
        for (int st = 0; st < kStages; ++st) {
          const float k = K[st * RB + off];
          if (p.tab.b[st] != 0.f) yn = fmaf(dt_use * p.tab.b[st], k, yn);
          if (p.tab.btilde[st] != 0.f) err = fmaf(dt_use * p.tab.btilde[st], k, err);
        }
        Yn[off] = yn;
        const float qv = err / (p.atol + p.rtol * fmaxf(fabsf(y), fabsf(yn)));
        sumsq = fmaf(qv, qv, sumsq);
        if (r < dz || r >= dz + 3) finite = finite && isfinite(yn);
      }
    }

    const int par = c.steps & 1;
    float* gout = p.gpart + ((size_t)par * G + blockIdx.x) * 2 * P;
    for (int q = threadIdx.x; q < P; q += blockDim.x) {
      gout[q] = GB[q];
      gout[P + q] = GE[q];
    }
    cnf::write_block_partial(sumsq, finite, p.partials, par, red);
    grid.sync();
    float total;
    bool all_finite;
    cnf::read_grid_total(p.partials, par, red, &total, &all_finite);
    // The g_p block: all blocks' vectors summed in block order, the same in
    // every block; GB becomes the proposed g_p.
    float gsq = 0.f;
    for (int q = threadIdx.x; q < P; q += blockDim.x) {
      float gs = 0.f, es = 0.f;
      for (int g = 0; g < G; ++g) {
        const float* base = p.gpart + ((size_t)par * G + g) * 2 * P;
        gs += __ldcg(base + q);
        es += __ldcg(base + P + q);
      }
      const float gn = gp[q] + gs;
      GB[q] = gn;
      const float qv = es / (p.atol + p.rtol * fmaxf(fabsf(gp[q]), fabsf(gn)));
      gsq = fmaf(qv, qv, gsq);
    }
    gsq = cnf::block_sum(gsq, red);
    if (c.update(sqrtf((total + gsq) / n_elems), all_finite, dt_use, is_last)) {
      for (int s = gtid; s < B; s += nthr) {
        for (int r = 0; r < R; ++r) {
          const size_t off = (size_t)r * B + s;
          Y[off] = Yn[off];
          K[off] = K[(kStages - 1) * RB + off];
        }
      }
      for (int q = threadIdx.x; q < P; q += blockDim.x) {
        gp[q] = GB[q];
        K1p[q] = K7p[q];
      }
    }
    __syncthreads();
  }

  for (int s = gtid; s < B; s += nthr) {
    for (int i = 0; i < dz; ++i) {
      p.z0[(size_t)s * dz + i] = Y[(size_t)i * B + s];
      p.az0[(size_t)s * dz + i] = Y[(size_t)(dz + 3 + i) * B + s];
    }
    for (int r = 0; r < 3; ++r) p.acc0[(size_t)r * B + s] = Y[(size_t)(dz + r) * B + s];
  }
  if (blockIdx.x == 0) {
    for (int q = threadIdx.x; q < P; q += blockDim.x) {
      const float g = gp[q];
      if (q < dz * H) {
        p.gw1[q] = g;
      } else if (q < dz * H + H) {
        p.gb1[q - dz * H] = g;
      } else if (q < 2 * dz * H + H) {
        p.gw2[q - dz * H - H] = g;
      } else {
        p.gb2[q - 2 * dz * H - H] = g;
      }
    }
  }
  if (gtid == 0) {
    p.stats[0] = c.steps;
    p.stats[1] = c.accepted;
  }
}

template <int DZ>
size_t smem_bytes(int dz, int H, int block) {
  const size_t P = 2 * (size_t)dz * H + H + dz;
  return sizeof(float) * (2 * (size_t)H * DZ + DZ + H + kRedFloats + 5 * P +
                          (size_t)block * Slot<DZ>(H).size);
}

}  // namespace

// Dynamic shared memory of one block (bytes), 0 for an unsupported dz.
extern "C" long long cnf_k2_smem_bytes(int dz, int H, int block) {
  switch (cnf::padded_dz(dz)) {
    case 4: return (long long)smem_bytes<4>(dz, H, block);
    case 8: return (long long)smem_bytes<8>(dz, H, block);
    case 16: return (long long)smem_bytes<16>(dz, H, block);
    case 32: return (long long)smem_bytes<32>(dz, H, block);
    default: return 0;
  }
}

// Largest co-resident grid for a cooperative launch (0 if none).
extern "C" int cnf_k2_max_grid(int dz, int H, int block, int* out) {
  switch (cnf::padded_dz(dz)) {
    case 4: return (int)cnf::coop_max_grid(k2_train_adjoint<4>, smem_bytes<4>(dz, H, block), block, out);
    case 8: return (int)cnf::coop_max_grid(k2_train_adjoint<8>, smem_bytes<8>(dz, H, block), block, out);
    case 16: return (int)cnf::coop_max_grid(k2_train_adjoint<16>, smem_bytes<16>(dz, H, block), block, out);
    case 32: return (int)cnf::coop_max_grid(k2_train_adjoint<32>, smem_bytes<32>(dz, H, block), block, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// accT/aaccT/acc0: (3, B).  tab: a (kStages x kStages, row-major), b, btilde.
// Returns the launch's cudaError_t.
extern "C" int cnf_k2_train_adjoint(const float* w1, const float* b1, const float* w2,
                                    const float* b2, const float* eps, const float* zT,
                                    const float* accT, const float* azT, const float* aaccT,
                                    const float* ts, float* z0, float* acc0, float* az0,
                                    float* gw1, float* gb1, float* gw2, float* gb2, int* stats,
                                    float* work, float* partials, float* gpart, int B, int dz,
                                    int H, int max_steps, int norm_z, int norm_j, float rtol,
                                    float atol, float beta1, float beta2, float inv_order,
                                    const float* tab, int grid, int block, void* stream) {
  if (block < 32 || block > kMaxBlock || block % 32 != 0 || grid < 1)
    return (int)cudaErrorInvalidValue;
  AdjArgs a = {};
  a.w1 = w1; a.b1 = b1; a.w2 = w2; a.b2 = b2; a.eps = eps;
  a.zT = zT; a.accT = accT; a.azT = azT; a.aaccT = aaccT; a.ts = ts;
  a.z0 = z0; a.acc0 = acc0; a.az0 = az0;
  a.gw1 = gw1; a.gb1 = gb1; a.gw2 = gw2; a.gb2 = gb2; a.stats = stats;
  a.work = work; a.partials = partials; a.gpart = gpart;
  a.B = B; a.dz = dz; a.H = H; a.max_steps = max_steps; a.norm_z = norm_z; a.norm_j = norm_j;
  a.rtol = rtol; a.atol = atol; a.beta1 = beta1; a.beta2 = beta2; a.inv_order = inv_order;
  cnf::read_tableau(tab, &a.tab);
  cudaStream_t s = (cudaStream_t)stream;
  switch (cnf::padded_dz(dz)) {
    case 4: return (int)cnf::coop_launch(k2_train_adjoint<4>, a, grid, block, smem_bytes<4>(dz, H, block), s);
    case 8: return (int)cnf::coop_launch(k2_train_adjoint<8>, a, grid, block, smem_bytes<8>(dz, H, block), s);
    case 16: return (int)cnf::coop_launch(k2_train_adjoint<16>, a, grid, block, smem_bytes<16>(dz, H, block), s);
    case 32: return (int)cnf::coop_launch(k2_train_adjoint<32>, a, grid, block, smem_bytes<32>(dz, H, block), s);
    default: return (int)cudaErrorInvalidValue;
  }
}
